"""The port's audio tower and ``ClapImpl`` (``models/audio.py``,
``models/impls.py``), and the audio build path, against the JAX package's on
the same parameters and seeded inputs, on the CPU (B3's plain version
stands in for the kernel):

- ``encode_audio`` and ``ClapImpl.predict``: cosine ≥ 0.999 a row, max abs
  ≤ 2e-2 × max |ref| (bf16 activations; off the TPU the JAX attention is
  XLA's, the port's plain version rounds p as the kernel does);
- the HF ``ASTModel`` checkpoint mapping: trees equal array for array;
- a folder of six WAV files scanned and extracted by both packages'
  ``jobs/`` with ``whisper`` and ``clap`` at ``test-tiny`` (one checkpoint
  each, loaded by both registries), then the quant reconcile: tables equal,
  languages equal, language confidences within 2e-3, transcripts equal up
  to the first position whose JAX top-2 logit margin is below twice the
  observed max abs logit error (greedy tokens of two implementations may
  split at a near-tie; no seed is chosen to avoid one), confidences within
  2 % where the transcripts agree, embeddings at cosine ≥ 0.999, snapshots
  equal in rows, items and weights.

The JAX ``ClapImpl`` pads a call's clips as one batch, which raises past
the top bucket (ROADMAP §C): the port embeds them in slices."""

import dataclasses
import io
import types
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoptikon_tpu.db import store as ref_store
from panoptikon_tpu.db.connection import Database as RefDatabase
from panoptikon_tpu.db.writer import IndexWriter as RefWriter
from panoptikon_tpu.index.vector_index import VectorIndex as RefIndex
from panoptikon_tpu.jobs import extraction as ref_extraction
from panoptikon_tpu.jobs import reconcile as ref_reconcile
from panoptikon_tpu.jobs import scan as ref_scan
from panoptikon_tpu.models import audio as ref
from panoptikon_tpu.models import impls as ref_impls
from panoptikon_tpu.models import weights as ref_weights
from panoptikon_tpu.models import whisper as ref_whisper
from panoptikon_tpu.models.manager import ModelManager as RefManager
from panoptikon_tpu.models.registry import Registry as RefRegistry
from panoptikon_tpu_torch.db import store
from panoptikon_tpu_torch.db.connection import Database
from panoptikon_tpu_torch.db.writer import IndexWriter
from panoptikon_tpu_torch.index import VectorIndex
from panoptikon_tpu_torch.jobs import extraction, reconcile, scan
from panoptikon_tpu_torch.models import audio, convert, impls, whisper
from panoptikon_tpu_torch.models.base import PredictionInput, is_error_slot
from panoptikon_tpu_torch.models.manager import ModelManager
from panoptikon_tpu_torch.models.registry import Registry
from panoptikon_tpu_torch.utils import npy

COS_FLOOR = 0.999
PROB_ATOL = 2e-3
CONF_RTOL = 2e-2
_ref_embed = jax.jit(ref.encode_audio, static_argnums=1)


def cosines(a, b):
    return np.sum(a * b, axis=-1) / np.maximum(
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-30)


def close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32 and np.isfinite(got).all()
    assert cosines(got, want).min() >= COS_FLOOR
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def make_wav(seconds=1.0, rate=16000, freq=440.0, channels=1, noise=0.0, seed=0):
    t = np.linspace(0, seconds, int(rate * seconds), endpoint=False)
    sig = np.sin(2 * np.pi * freq * t) * 0.5 + noise * np.random.default_rng(seed).normal(size=t.size)
    pcm = (np.clip(sig, -1, 1) * 32767).astype("<i2")
    if channels == 2:
        pcm = np.stack([pcm, pcm[::-1]], axis=1).reshape(-1)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def configs(name):
    if name == "d64":  # test-tiny with clap-base's head dim of 64 (p rounds to bf16)
        fields = {**dataclasses.asdict(ref.CONFIGS["test-tiny"]), "width": 128, "heads": 2}
        return ref.AudioConfig(**fields), audio.AudioConfig(**fields)
    return ref.CONFIGS[name], audio.CONFIGS[name]


def port_tree(jparams):
    return convert.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


# ---------------------------------------------------------------------------
# The tower
# ---------------------------------------------------------------------------


def test_configs_and_prepare_mels_are_the_reference_s():
    for name, rcfg in ref.CONFIGS.items():
        assert dataclasses.asdict(audio.CONFIGS[name]) == dataclasses.asdict(rcfg)
        assert (audio.CONFIGS[name].grid, audio.CONFIGS[name].tokens) == (rcfg.grid, rcfg.tokens)
    rng = np.random.default_rng(2)
    for name in ("test-tiny", "clap-base"):
        # Shorter than the frame budget (padded), longer (center-cropped
        # within the content), past 30 s (whisper's window), and a sliver.
        for n in (8_000, 16_000 * 14, 16_000 * 40, 100):
            pcm = (rng.normal(size=n) * 0.1).astype(np.float32)
            got = audio.prepare_mels(pcm, audio.CONFIGS[name])
            np.testing.assert_array_equal(got, ref.prepare_mels(pcm, ref.CONFIGS[name]))
            assert got.shape == (audio.CONFIGS[name].n_mels, audio.CONFIGS[name].time_frames)


@pytest.mark.parametrize("name", ["test-tiny", "d64"])
def test_encode_audio_matches(name):
    rcfg, cfg = configs(name)
    jparams = ref.init_params(jax.random.key(3), rcfg)
    params = port_tree(jparams)
    rng = np.random.default_rng(4)
    mels = rng.normal(size=(3, cfg.n_mels, cfg.time_frames)).astype(np.float32)
    want = np.asarray(_ref_embed(jparams, rcfg, jnp.asarray(mels)))
    got = audio.embed_audio(params, cfg, torch.from_numpy(mels)).numpy()
    close(got, want)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    raw = audio.encode_audio(params, cfg, torch.from_numpy(mels), normalize=False)
    close(raw.detach().numpy(), np.asarray(ref.encode_audio(jparams, rcfg, mels, normalize=False)))


def clap_pair(seed=5, batch_cap=16):
    rcfg, _ = configs("test-tiny")
    jparams = ref.init_params(jax.random.key(seed), rcfg)
    ref_impl = ref_impls.ClapImpl("test-tiny", batch_cap=batch_cap)
    ref_impl.params = jparams
    port = impls.ClapImpl("test-tiny", batch_cap=batch_cap, device="cpu")
    port.params = port_tree(jparams)
    return ref_impl, port


def test_clap_impl_matches_the_jax_impl(monkeypatch):
    ref_impl, port = clap_pair()
    payloads = [make_wav(freq=440.0), make_wav(seconds=2.5, rate=44100, channels=2, freq=900.0),
                b"not a wav", None, make_wav(seconds=0.3, noise=0.4, seed=1)]
    inputs = [PredictionInput(file=p) if p is not None else PredictionInput(data={"x": 1})
              for p in payloads]
    got = port.predict(inputs)
    want = ref_impl.predict([ref_impls.PredictionInput(file=i.file, data=i.data) for i in inputs])
    for j in (2, 3):
        assert is_error_slot(got[j]) and got[j] == want[j]
    rows = np.stack([npy.parse_npy_embedding(got[j]) for j in (0, 1, 4)])
    close(rows, np.stack([npy.parse_npy_embedding(want[j]) for j in (0, 1, 4)]))
    np.testing.assert_allclose(np.linalg.norm(rows, axis=1), 1.0, rtol=1e-5)
    assert not np.allclose(rows[0], rows[1])
    # prepare() runs every bucket once, as the JAX class compiles them.
    seen = []
    embed = audio.embed_audio
    monkeypatch.setattr(audio, "embed_audio", lambda p, c, m: seen.append(tuple(m.shape)) or
                        embed(p, c, m))
    port.prepare()
    assert seen == [(b, 16, 64) for b in (1, 2, 4, 8, 16)]


def test_clap_embeds_past_the_top_bucket_in_slices(monkeypatch):
    # batch_cap 4: five clips. The JAX impl raises (a batch of 5 exceeds
    # bucket 4); the port embeds a slice of 4 and one of 1, each row equal
    # to the JAX impl's embedding of that clip alone.
    ref_impl, port = clap_pair(seed=6, batch_cap=4)
    payloads = [make_wav(seconds=0.4 + 0.2 * i, freq=300.0 * (i + 1)) for i in range(5)]
    with pytest.raises(ValueError, match="exceeds bucket"):
        ref_impl.predict([ref_impls.PredictionInput(file=p) for p in payloads])
    seen = []
    embed = audio.embed_audio
    monkeypatch.setattr(audio, "embed_audio", lambda p, c, m: seen.append(m.shape[0]) or
                        embed(p, c, m))
    got = port.predict([PredictionInput(file=p) for p in payloads])
    assert seen == [4, 1]
    for out, p in zip(got, payloads):
        close(npy.parse_npy_embedding(out)[None],
              npy.parse_npy_embedding(ref_impl.predict([ref_impls.PredictionInput(file=p)])[0])[None])


def _equal_trees(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _equal_trees(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(
            _equal_trees(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_ast_checkpoint_loads_the_reference_tree(tmp_path):
    rcfg, cfg = configs("test-tiny")
    tree = jax.tree.map(np.asarray, ref.init_params(jax.random.key(7), rcfg))
    rng = np.random.default_rng(8)
    # Every leaf perturbed but ln_pre, which the AST layout does not hold (the
    # loader makes it the identity, as the random init is).
    tree = {k: v if k == "ln_pre" else jax.tree.map(
        lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.01, v)
        for k, v in tree.items()}
    ref.save_ast_checkpoint(tree, rcfg, tmp_path / "model.safetensors")
    audio.save_ast_checkpoint(tree, cfg, tmp_path / "pytorch_model.bin")
    for name in ("model.safetensors", "pytorch_model.bin"):
        got = audio.load_ast_checkpoint(tmp_path / name, cfg)
        want = ref.load_ast_checkpoint(tmp_path / name, rcfg)
        assert _equal_trees(got, want) and _equal_trees(got, tree), name
    # The HF layout under its model prefix, without a projection: identity.
    sd = torch.load(tmp_path / "pytorch_model.bin", weights_only=True)
    hf = {f"audio_spectrogram_transformer.{k}": v for k, v in sd.items()
          if k != "audio_projection.weight"}
    torch.save(hf, tmp_path / "hf.bin")
    got = audio.load_ast_checkpoint(tmp_path / "hf.bin", cfg)
    assert _equal_trees(got, ref.load_ast_checkpoint(tmp_path / "hf.bin", rcfg))
    np.testing.assert_array_equal(got["proj"], np.eye(cfg.width, cfg.embed_dim, dtype=np.float32))
    loaded = impls.ClapImpl("test-tiny", checkpoint=str(tmp_path), device="cpu")
    direct = impls.ClapImpl("test-tiny", device="cpu")
    direct.params = convert.params_from_jax(tree, device="cpu")
    inputs = [PredictionInput(file=make_wav(freq=650.0))]
    assert loaded.predict(inputs) == direct.predict(inputs)


def test_manager_loads_clap_base_by_registry_id(monkeypatch):
    registry = Registry(None)
    rid = registry.resolve("clap", "clap-base")
    assert impls.IMPL_INDEX[rid.impl_class] is impls.ClapImpl
    assert registry.group_metadata("clap")["output_type"] == "clip"
    monkeypatch.setattr(rid, "config", {**rid.config, "device": "cpu"})
    manager = ModelManager(registry, impls.IMPL_INDEX)
    try:
        out = manager.predict("clap/clap-base", [PredictionInput(file=make_wav(seconds=0.5))])
        entry = manager._models["clap/clap-base"]
        assert isinstance(entry.model, impls.ClapImpl) and entry.default_batch == 8
        assert entry.model.cfg == audio.CONFIGS["clap-base"]
    finally:
        manager.shutdown()
    vec = npy.parse_npy_embedding(out[0])
    assert vec.shape == (512,) and abs(float(np.linalg.norm(vec)) - 1.0) < 1e-3


# ---------------------------------------------------------------------------
# The audio build path: scan → whisper and clap jobs → reconcile
# ---------------------------------------------------------------------------

REF = types.SimpleNamespace(
    name="ref", store=ref_store, Database=RefDatabase, Writer=RefWriter, Index=RefIndex,
    extraction=ref_extraction, reconcile=ref_reconcile, scan=ref_scan, Manager=RefManager,
    Registry=RefRegistry, impls=ref_impls, device="")
PORT = types.SimpleNamespace(
    name="port", store=store, Database=Database, Writer=IndexWriter, Index=VectorIndex,
    extraction=extraction, reconcile=reconcile, scan=scan, Manager=ModelManager,
    Registry=Registry, impls=impls, device='config.device = "cpu"')
REG_TOML = """
[group.whisper]
config.impl_class = "whisper"
config.model_arch = "test-tiny"
config.checkpoint = "{whisper}"
config.max_tokens = {max_tokens}
{device}
[group.whisper.metadata]
default_batch_size = 3
target_entities = ["items"]
output_type = "text"
input_mime_types = ["audio/"]
[group.whisper.metadata.input_spec]
handler = "audio_tracks"
[group.whisper.inference_ids.tiny]

[group.clap]
config.impl_class = "clap"
config.model_arch = "test-tiny"
config.checkpoint = "{clap}"
{device}
[group.clap.metadata]
default_batch_size = 3
target_entities = ["items"]
output_type = "clip"
input_mime_types = ["audio/"]
[group.clap.metadata.input_spec]
handler = "audio_tracks"
[group.clap.inference_ids.tiny]
"""
NOW = "2026-01-01T00:00:00+00:00"
MAX_TOKENS = 10


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    # Whisper by the reference's exporter (.safetensors), CLAP by the
    # port's (.bin); both registries load both.
    root = tmp_path_factory.mktemp("ckpt")
    wcfg = ref_whisper.CONFIGS["test-tiny"]
    ref_weights.save_whisper_checkpoint(
        jax.tree.map(np.asarray, ref_whisper.init_params(jax.random.key(11), wcfg)),
        root / "whisper.safetensors")
    acfg = audio.CONFIGS["test-tiny"]
    audio.save_ast_checkpoint(jax.tree.map(np.asarray, ref.init_params(jax.random.key(12),
                                                                        ref.CONFIGS["test-tiny"])),
                              acfg, root / "clap.bin")
    return {"whisper": str(root / "whisper.safetensors"), "clap": str(root / "clap.bin")}


@pytest.fixture
def folder(tmp_path):
    root = tmp_path / "audio"
    (root / "sub").mkdir(parents=True)
    clips = {"a.wav": make_wav(seconds=1.0, freq=220.0),
             "b.wav": make_wav(seconds=2.2, freq=880.0, noise=0.05),
             "sub/c.wav": make_wav(seconds=1.5, rate=44100, channels=2, freq=1300.0),
             "d.wav": make_wav(seconds=0.6, noise=0.5, seed=3),
             "e.wav": make_wav(seconds=3.0, freq=150.0),
             "f.wav": make_wav(seconds=1.2, freq=3100.0, noise=0.1, seed=4)}
    for name, payload in clips.items():
        (root / name).write_bytes(payload)
    (root / "notes.txt").write_text("not audio")
    return root


def build(side, root, folder, checkpoints, monkeypatch):
    """Scan ``folder``, run the whisper and clap jobs with the registry's
    arguments, then the quant reconcile; returns what was built."""
    monkeypatch.setattr(side.store, "now_iso", lambda: NOW)
    reg = root / f"registry-{side.name}"
    reg.mkdir(parents=True)
    (reg / "00.toml").write_text(REG_TOML.format(device=side.device, max_tokens=MAX_TOKENS,
                                                 **checkpoints))
    db = side.Database(root / f"data-{side.name}", "audio")
    writer, index = side.Writer(db), side.Index(chunk_rows=64)
    manager = side.Manager(side.Registry(reg), side.impls.IMPL_INDEX)
    try:
        writer.call(lambda c: side.store.add_folder(c, str(folder)))
        assert side.scan.rescan_folders(db, writer).new_files == 7
        reports = {}
        for group in ("whisper", "clap"):
            meta = manager.registry.group_metadata(group)
            reports[group] = side.extraction.run_extraction_job(
                db=db, writer=writer, index=index, manager=manager,
                inference_id=f"{group}/tiny", output_type=meta["output_type"],
                mime_prefixes=tuple(meta["input_mime_types"]),
                batch_size=int(meta["default_batch_size"]),
                input_handler=meta["input_spec"]["handler"])
        side.reconcile.run_reconcile(db, writer, index)
        conn = db.reader()
        tables = {t: conn.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall()
                  for t in ("items", "files", "item_data", "setters", "extraction_errors")}
        texts = conn.execute(
            """SELECT d.item_id, f.path, t.text, t.language, t.language_confidence, t.confidence
               FROM extracted_text t JOIN item_data d ON d.id = t.id
               JOIN files f ON f.item_id = d.item_id ORDER BY d.item_id""").fetchall()
        fts = {row[0] for row in conn.execute(
            "SELECT rowid FROM extracted_text_fts WHERE extracted_text_fts MATCH ?",
            (f'"{texts[0][2].split()[0]}"',))}  # a token "<id>" (trigram tokenizer)
        vectors = {r[0]: np.frombuffer(r[1], np.float32) for r in conn.execute(
            """SELECT d.item_id, e.embedding FROM embeddings e JOIN item_data d ON d.id = e.id
               ORDER BY d.item_id""")}
        return types.SimpleNamespace(reports=reports, tables=tables, texts=texts, fts=fts,
                                     vectors=vectors, snap=index.snapshot("clap/tiny"),
                                     coverage=side.reconcile.coverage_status(db))
    finally:
        manager.shutdown()
        writer.close()


def test_audio_build_matches_the_reference(tmp_path, folder, checkpoints, monkeypatch):
    built = {side.name: build(side, tmp_path, folder, checkpoints, monkeypatch)
             for side in (REF, PORT)}
    got, want = built["port"], built["ref"]
    for group in ("whisper", "clap"):
        report = got.reports[group]
        assert (report.processed, report.input_errors, report.transient_errors) == (6, 0, 0)
        w = want.reports[group]
        assert (w.processed, w.input_errors, w.transient_errors) == (6, 0, 0)
    for name in ("items", "files", "item_data", "setters", "extraction_errors"):
        assert got.tables[name] == want.tables[name], name
    assert len(got.texts) == len(want.texts) == 6 and got.fts and got.fts <= {
        r[0] for r in got.tables["item_data"]}
    # Languages and their confidences; transcripts by the free-running rule.
    wcfg, rcfg = whisper.CONFIGS["test-tiny"], ref_whisper.CONFIGS["test-tiny"]
    jparams = ref_weights.load_whisper_checkpoint(checkpoints["whisper"], rcfg)
    params = whisper.bf16_linears(convert.params_from_jax(jparams, device="cpu"))
    for g, w in zip(got.texts, want.texts):
        assert g[:2] == w[:2] and g[3] == w[3] and g[3] in whisper.LANGUAGES[: wcfg.n_langs]
        assert abs(g[4] - w[4]) <= PROB_ATOL and 0 < g[5] <= 1
    rows = {}
    for side, texts in (("port", got.texts), ("ref", want.texts)):
        rows[side] = np.full((6, MAX_TOKENS), wcfg.eot, np.int32)
        for j, (_, _, text, lang, _, _) in enumerate(texts):
            ids = [int(t.strip("<>")) for t in text.split()]
            rows[side][j, : 4 + len(ids)] = [wcfg.sot, wcfg.language_base + whisper.LANGUAGES.index(
                lang), wcfg.transcribe, wcfg.no_timestamps, *ids]
    mel = np.stack([ref_whisper.log_mel_spectrogram(
        ref_impls.decode_wav(Path(path).read_bytes()), rcfg.n_mels) for _, path, *_ in want.texts])
    want_logits = np.asarray(jax.jit(ref_whisper._decoder_logits, static_argnums=1)(
        jparams, rcfg, jnp.asarray(rows["ref"]),
        jax.jit(ref_whisper.encode_audio, static_argnums=1)(jparams, rcfg, jnp.asarray(mel)),
        None))[:, :-1]
    with torch.inference_mode():
        feats = whisper.encode_audio(params, wcfg, torch.from_numpy(mel))
        got_logits = whisper._decoder_logits(params, wcfg, torch.from_numpy(rows["ref"]),
                                             feats, None)[:, :-1].numpy()
    assert cosines(got_logits, want_logits).min() >= COS_FLOOR
    err = float(np.abs(got_logits - want_logits).max())
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    for j, (g_row, w_row) in enumerate(zip(rows["port"], rows["ref"])):
        low = np.flatnonzero(margin[j, 3:] <= 2 * err)
        first = 3 + (low[0] if low.size else MAX_TOKENS)
        np.testing.assert_array_equal(g_row[: first + 1], w_row[: first + 1])
        if np.array_equal(g_row, w_row):
            assert got.texts[j][2] == want.texts[j][2]
            np.testing.assert_allclose(got.texts[j][5], want.texts[j][5], rtol=CONF_RTOL)
    # Embeddings and the built space.
    assert got.vectors.keys() == want.vectors.keys() and len(got.vectors) == 6
    close(np.stack(list(got.vectors.values())), np.stack(list(want.vectors.values())))
    gs, ws = got.snap, want.snap
    n = gs.size
    assert (n, gs.num_groups) == (ws.size, ws.num_groups) == (6, 6)
    for field in ("row_ids", "group_ids", "weights"):
        np.testing.assert_array_equal(getattr(gs, field)[:n], getattr(ws, field)[:n])
    assert gs.quant_ready and (gs.weights[:n] == 1.0).all()
    assert got.coverage[0]["state"] == want.coverage[0]["state"] == "ready"
