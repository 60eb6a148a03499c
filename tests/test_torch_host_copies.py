"""The port's copies of the JAX package's host modules against their
originals, on the same seeded inputs: the host codec (its NumPy path and
the native C++ library, built here with g++), ``VectorIndex``,
``utils.npy``, ``models.batching`` and ``models.base``; and, by ``ast.dump``,
every host function of the copied ``pql/``, ``db/``, ``jobs/`` and
``models/`` modules (the registry, discovery, the manager, the checkpoint
mappings, the text chunking contract, the fixture impls, the host-only
impls (md5 lookup, the embedding and tag APIs), the tagger's mcut threshold,
the VLM tagger's caption parse, the WAV decoder, the audio towers'
configs, log-mel and mel preparation, and OCR's configs, segmentation,
strip preparation and decodes to text), the native
codec's bindings, the logging module (``utils/logging.py``, whose logger
tree is the port's), and the built-in registry TOML;
``csrc/host_codec.cpp`` text for text.
The port imports nothing of ``panoptikon_tpu``; only this test imports
both."""

import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest

from panoptikon_tpu.index.vector_index import VectorIndex as RefIndex
from panoptikon_tpu.models import base as ref_base
from panoptikon_tpu.models import batching as ref_batching
from panoptikon_tpu.ops import codec as ref_codec
from panoptikon_tpu.utils import npy as ref_npy
from panoptikon_tpu_torch.index import VectorIndex
from panoptikon_tpu_torch.models import base, batching
from panoptikon_tpu_torch.ops import codec
from panoptikon_tpu_torch.utils import npy


def _edge_rows(scale):
    edge = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                     126.5, 127.49, 127.5, 128.0, 1e9, -127.5, -128.0, -128.5, -129.0, -1e9],
                    dtype=np.float32) * np.float32(scale)
    return np.stack([edge, -edge, edge * 3])


@pytest.mark.parametrize("absmax", [0.0, -1.0, 1.0, 0.37, 3e-20, 1e30, np.inf, -np.inf, np.nan])
def test_scale_and_artifact_match(absmax):
    scale = codec.scale_from_absmax(absmax)
    assert scale == ref_codec.scale_from_absmax(absmax)
    blob = codec.scale_artifact(scale)
    assert blob == ref_codec.scale_artifact(scale)
    assert codec.artifact_scale(blob) == ref_codec.artifact_scale(blob) == scale


@pytest.mark.parametrize("blob", [b"", b"\x00\x00\x80", b"\x00\x00\x80\x7f", b"\x00\x00\xc0\x7f",
                                  b"\x00\x00\x80\xbf", b"\x00\x00\x00\x00", b"\x00" * 5])
def test_artifact_rejects_unusable_scales(blob):
    assert codec.artifact_scale(blob) is None
    assert ref_codec.artifact_scale(blob) is None


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_is_bit_identical(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(300, 96)).astype(np.float32)
    scale = codec.scale_from_absmax(codec.corpus_absmax(x))
    assert scale == ref_codec.scale_from_absmax(ref_codec.corpus_absmax(x))
    # Saturating queries and NaN / ±inf components beside ordinary rows.
    queries = np.concatenate([x[:5] * 4.0, np.pad(_edge_rows(scale), ((0, 0), (0, 96 - 21)))])
    for arr in (x, queries, _edge_rows(0.5), x[0]):
        got = codec.quantize_int8_host(arr, scale)
        np.testing.assert_array_equal(got, ref_codec.quantize_int8(arr, scale))
        np.testing.assert_array_equal(codec.compute_query_quant(arr, scale),
                                      ref_codec.compute_query_quant(arr, scale))
    # In place into a destination slab (the index build's chunked path).
    out = np.full(x.shape, 99, np.int8)
    assert codec.quantize_int8_host(x, scale, out=out) is out
    np.testing.assert_array_equal(out, ref_codec.quantize_int8(x, scale))
    with pytest.raises(ValueError):
        codec.quantize_int8_host(x, scale, out=np.zeros(x.shape, np.int16))
    codes = out
    np.testing.assert_array_equal(codec.dequantize_int8_host(codes, scale),
                                  ref_codec.dequantize_int8(codes, scale))


def test_corpus_absmax_matches_with_mask_nan_and_chunks():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(17_000, 512)).astype(np.float32)  # 35 MB: the chunked path
    x[3, 7] = np.nan
    x[16_999, 0] = -9.5
    valid = rng.random(17_000) > 0.3
    valid[16_999] = False
    assert codec.corpus_absmax(x) == ref_codec.corpus_absmax(x) == 9.5
    assert codec.corpus_absmax(x, valid) == ref_codec.corpus_absmax(x, valid) < 9.5
    assert codec.corpus_absmax(x[:10]) == ref_codec.corpus_absmax(x[:10])
    assert codec.corpus_absmax(np.zeros((0, 4), np.float32)) == 0.0


def _drive(index_cls, seed=3):
    """The same add / remove / build_quant / append / backfill / compact
    sequence; returns every snapshot and join along the way."""
    rng = np.random.default_rng(seed)
    idx = index_cls(chunk_rows=1024)
    seen = []

    def record(space):
        snap = idx.snapshot(space)
        seen.append((snap.generation, snap.size, snap.capacity, snap.num_groups, snap.scale,
                     snap.vectors[: snap.size].copy(), snap.row_valid.copy(),
                     snap.group_ids[: snap.size].copy(), snap.row_ids[: snap.size].copy(),
                     snap.weights[: snap.size].copy(),
                     None if snap.codes is None else snap.codes.copy()))

    idx.reserve("img", 3000, 32)
    items = np.repeat(np.arange(0, 2000, 2), 2)  # two rows per item
    idx.add("img", items, np.arange(2000), rng.normal(size=(2000, 32)).astype(np.float32))
    record("img")
    seen.append(idx.build_quant("img"))
    record("img")
    # Out-of-order items take the per-row slot loop.
    idx.add("img", [5001, 7, 5000], [2000, 2001, 2002],
            rng.normal(size=(3, 32)).astype(np.float32), weights=[0.5, 1.0, 2.0])
    record("img")  # not covered: the quant arm is hidden
    seen.append(idx.backfill_quant("img", idx.snapshot("img").scale or seen[1]))
    record("img")
    seen.append(idx.remove_items("img", [0, 10, 5001, 123456]))
    seen.append(idx.group_slots_for_items("img", np.array([[0, 2], [7, 999999]])))
    seen.append(idx.item_id_of_groups("img", np.array([-1, 0, 3, 10**6])))
    idx.compact("img")
    record("img")
    idx.add("txt", [1, 1, 2], [0, 1, 2], np.zeros((3, 8), np.float32))
    seen.append(idx.build_quant("txt"))  # a zero corpus: scale 1.0
    record("txt")
    idx.remove_items("txt", [1, 2])
    idx.compact("txt")  # every row tombstoned
    record("txt")
    idx.drop_quant("img")
    record("img")
    seen.append(idx.stats())
    seen.append(idx.space_names())
    return seen


def _equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[key], b[key]) for key in a)
    return a == b


def test_vector_index_sequence_gives_identical_snapshots():
    got, want = _drive(VectorIndex), _drive(RefIndex)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _equal(g, w), i


def test_npy_round_trip_matches():
    rng = np.random.default_rng(4)
    arrays = [rng.normal(size=(3, 5)).astype(np.float32), rng.normal(size=7),
              rng.integers(-9, 9, size=(2, 4), dtype=np.int16), np.array([True, False]),
              rng.normal(size=(4, 3)).astype(">f4"), np.asfortranarray(rng.normal(size=(3, 2)))]
    for arr in arrays:
        blob = npy.serialize_npy(arr)
        assert blob == ref_npy.serialize_npy(arr)
        assert _equal(npy.parse_npy(blob), ref_npy.parse_npy(blob))
        if arr.dtype.kind == "f":
            assert _equal(npy.parse_npy_embedding(blob), ref_npy.parse_npy_embedding(blob))
            assert _equal(npy.parse_npy_matrix(blob), ref_npy.parse_npy_matrix(blob))
    blob = _np_save(arrays[5])  # a Fortran-order payload as np.save writes it
    assert _equal(npy.parse_npy(blob), ref_npy.parse_npy(blob))
    vec = arrays[0][0]
    assert npy.f32_blob(vec) == ref_npy.f32_blob(vec)
    assert _equal(npy.blob_f32(npy.f32_blob(vec)), ref_npy.blob_f32(ref_npy.f32_blob(vec)))


def _np_save(arr):
    import io

    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


@pytest.mark.parametrize("blob", [
    b"", b"\x93NUMPY", b"NOTNUMPY\x01\x00", b"\x93NUMPY\x04\x00\x00\x00",
    b"\x93NUMPY\x01\x00\xff\x00{",
    b"\x93NUMPY\x01\x00\x10\x00[1, 2, 3]       ",
    b"\x93NUMPY\x01\x00\x20\x00{'descr': '<c8', 'fortran_order': False, 'shape': (1,)}",
    b"\x93NUMPY\x01\x00\x20\x00{'descr': '<f4', 'fortran_order': False, 'shape': (9,)}",
    b"\x93NUMPY\x01\x00\x20\x00{'descr': '<f4', 'shape': (1,)}                  ",
])
def test_npy_typed_errors_match(blob):
    with pytest.raises(ref_npy.NpyError) as want:
        ref_npy.parse_npy(blob)
    with pytest.raises(npy.NpyError) as got:
        npy.parse_npy(blob)
    assert isinstance(got.value, ValueError) and str(got.value) == str(want.value)
    with pytest.raises(npy.NpyError):
        npy.blob_f32(b"\x00\x00\x00")


def test_npy_embedding_shape_errors_match():
    for arr in (np.zeros((2, 2, 2), np.float32), np.zeros((0, 4), np.float32)):
        blob = npy.serialize_npy(arr)
        with pytest.raises(ref_npy.NpyError) as want:
            ref_npy.parse_npy_embedding(blob)
        with pytest.raises(npy.NpyError) as got:
            npy.parse_npy_embedding(blob)
        assert str(got.value) == str(want.value)


def test_batching_matches():
    for cap, b in ((1, 1), (64, 1), (100, 4), (256, 1)):
        ladder = batching.bucket_ladder(cap, b)
        assert ladder == ref_batching.bucket_ladder(cap, b)
        for n in (0, 1, 3, 64, 65, 300):
            assert batching.bucket_for(n, ladder) == ref_batching.bucket_for(n, ladder)
    rng = np.random.default_rng(5)
    batch = rng.normal(size=(5, 3, 2)).astype(np.float32)
    for bucket in (5, 8):
        assert _equal(batching.pad_batch(batch, bucket), ref_batching.pad_batch(batch, bucket))
    with pytest.raises(ValueError):
        batching.pad_batch(batch, 4)
    seqs = [[1, 2, 3], [4], list(range(9, 40))]
    for s in (seqs, []):
        assert _equal(batching.pad_token_batch(s, [8, 16], [1, 2, 4], pad_id=7),
                      ref_batching.pad_token_batch(s, [8, 16], [1, 2, 4], pad_id=7))


def test_error_slots_match():
    for cls, msg in (("input", "bad pixels"), ("transient", "")):
        slot = base.SlotError(cls, msg).to_slot()
        assert slot == ref_base.SlotError(cls, msg).to_slot()
        assert base.is_error_slot(slot) and ref_base.is_error_slot(slot)
        assert base.parse_error_slot(slot) == ref_base.parse_error_slot(slot) == (cls, msg)
    with pytest.raises(ValueError):
        base.SlotError("fatal", "x")
    for bad in ({"__error__": "x"}, {"__error__": {"class": "input", "message": 3}}):
        with pytest.raises(ValueError):
            base.parse_error_slot(bad)
        with pytest.raises(ValueError):
            ref_base.parse_error_slot(bad)
    assert not base.is_error_slot(b"npy") and not base.is_error_slot({"x": 1})
    inp = base.PredictionInput(data={"text": "a"})
    assert (inp.data, inp.file) == (ref_base.PredictionInput(data={"text": "a"}).data, None)


# ---------------------------------------------------------------------------
# The executor slice's host copies: pql/{executor,fused,model,preprocess}.py,
# db/{schema,connection,epochs,store,writer}.py and utils/splitmix.py.
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parent.parent

# Functions and methods of the copies that the port rewrote: the units that
# touch the device, ``packaged_builtin_dir``, which finds the port's own
# resources, the native codec's build and load, which find the port's own
# library (built from csrc/host_codec.cpp into build/torch_kernels/), and
# the extraction job's text work query, which the port repairs.
# ``ported`` are the reference's units the port rewrote or left out (of
# the executor's none is left out: its sharded program is ported);
# ``added`` the port's own. A module-level assignment is named ``<target>``.
DEVICE_UNITS = {
    "pql/executor.py": {
        "ported": {
            "_prefetch_host", "_invert_packed", "Executor.__init__", "Executor._device_arrays",
            "Executor._sharded_space", "Executor._deferred_surface",
            "Executor._deferred_candidates", "Executor._scan_surface_batched",
            "Executor._coalesced_candidates", "Executor._deferred_gather",
            "Executor._coalesced_gather", "Executor._rrf_item_index",
            "Executor._rrf_join_candidates", "Executor._coalesced_rrf_join",
            "Executor._space_scores",
        },
        "added": {"_HostCopy.<body>", "_collect_host", "_host_get", "_sharded",
                  "Executor._upload"},
    },
    "pql/fused.py": {"ported": {"_rrf_device_eligible"}, "added": set()},
    "models/registry.py": {"ported": {"packaged_builtin_dir"}, "added": set()},
    "native/__init__.py": {"ported": {"ensure_built", "_load", "<_DIR>", "<_LIB_PATH>"},
                           "added": {"<_NAME>"}},
    # The derived-data work query with its index hint (the reference's plan
    # is quadratic in a build: test_torch_jobs.py holds the rows equal).
    "jobs/extraction.py": {"ported": {"_unprocessed_text"}, "added": set()},
    # The server names its device: AppState carries it (a dataclass field)
    # and create() resolves it, raising without CUDA; its executors run on
    # it; the accelerator report reads torch.cuda and client_config's
    # multi_chip the port's mesh; main takes --device in place of the JAX
    # platform pin (a list of devices: the serving mesh), joins the port's
    # multi-process runtime and refuses a mesh of more than one shard across
    # processes through refuse_lockstep. serve_all is the reference's: it
    # mounts the reverse proxy for [upstreams].ui.
    "api/server.py": {
        "ported": {"AppState.<body>", "AppState.create", "AppState.executor",
                   "accelerator_report", "client_config", "main"},
        "added": {"refuse_lockstep"},
    },
    # The CLI's device report reads torch.cuda; the reference's table of TPU
    # generations (--env) has no counterpart on the card; serve takes
    # --device.
    "cli.py": {"ported": {"cmd_accelerator", "build_parser", "<TPU_ENV_MATRIX>"},
               "added": set()},
}
# Names the port gives otherwise: the port's NumPy quantizer is
# ``ops.codec.quantize_int8_host`` (its ``quantize_int8`` is the tensor one).
# The package's own name where no dot follows it (its version, its
# resources), and the transport: the port's handlers read
# ``from aiohttp import web`` as the port's ``api/web.py``.
_PACKAGE = {r"\bimport panoptikon_tpu\b(?!_)": "import panoptikon_tpu_torch",
            r"\bfrom panoptikon_tpu import\b": "from panoptikon_tpu_torch import",
            r'__import__\("panoptikon_tpu"\)': '__import__("panoptikon_tpu_torch")'}
_WEB = {r"\bfrom aiohttp import web\b": "from panoptikon_tpu_torch.api import web"}
# The reverse proxy's header mapping is the transport's CIMultiDict; the
# async client's session comes from the transport's client half
# (api/web_client.py, aiohttp's client names), imported where the reference
# imports aiohttp.
_PROXY = {r"\bfrom multidict import CIMultiDict\b":
          "from panoptikon_tpu_torch.api.web import CIMultiDict"}
_ACLIENT = {r"\bimport aiohttp\b": "from panoptikon_tpu_torch.api import web_client",
            r"\baiohttp\.": "web_client."}
RENAMED = {"native/__init__.py": {r"\bcodec\.quantize_int8\(": "codec.quantize_int8_host("},
           # The port's logging configures its own logger tree.
           "utils/logging.py": {r'getLogger\("panoptikon_tpu"\)': 'getLogger("panoptikon_tpu_torch")'},
           "api/server.py": {**_PACKAGE, **_WEB}, "api/policy.py": _WEB, "api/relay.py": _WEB,
           "api/proxy.py": _PROXY, "aclient.py": {**_PACKAGE, **_ACLIENT},
           "cli.py": _PACKAGE, "desktop.py": _PACKAGE}
JOBS = ("jobs/queue.py", "jobs/index_sync.py", "jobs/reconcile.py", "jobs/extraction.py",
        "jobs/input_handlers.py", "jobs/outro.py", "jobs/media.py", "jobs/scan.py")
# Serving (A.7) and the host modules it needs (A.16).
SERVING = ("utils/env_template.py", "utils/rootlock.py", "utils/schema_gen.py",
           "utils/version.py", "utils/toml_edit.py", "config.py", "db/config_file.py",
           "db/setup.py", "pql/build.py", "api/policy_token.py", "api/search_cache.py",
           "api/policy.py", "api/relay.py", "api/server.py", "jobs/cron.py",
           "jobs/continuous.py", "jobs/supervisor.py", "jobs/prewarm.py", "models/pool.py",
           "models/http_backend.py", "client.py", "cli.py", "desktop.py",
           # The reverse proxy and the async client (A.7b).
           "api/proxy.py", "aclient.py")
HOST_COPIES = ("pql/executor.py", "pql/fused.py", "pql/model.py", "pql/preprocess.py",
               "db/schema.py", "db/connection.py", "db/epochs.py", "db/store.py", "db/writer.py",
               "db/bulk.py", "utils/splitmix.py", "models/registry.py", "models/discovery.py",
               "models/manager.py", "resources/__init__.py", *JOBS, "native/__init__.py",
               *SERVING, "utils/logging.py")
# Modules of the port that copy some of a reference module's units beside
# device code of their own: the units named here must equal the
# reference's. ``weights.load_state_dict`` differs: it names the missing
# package when a .safetensors file cannot be read (test_torch_weights.py).
FIXTURE_IMPLS = ("EchoImpl", "BatchSizeImpl", "OomImpl", "FailBatchImpl", "ErrorSlotImpl",
                 "SlowImpl", "BrokenLoadImpl", "LoadCountImpl")
PARTIAL_COPIES = {
    "models/text_embed.py": ("split_tokens", "combine_chunks"),
    "models/weights.py": ("_ln", "_linear", "_hf_clip_block", "load_clip_checkpoint",
                          "save_clip_checkpoint", "load_timm_vit_checkpoint",
                          "load_text_encoder_checkpoint", "load_whisper_checkpoint",
                          "load_whisper_decoder_checkpoint"),
    # The host-only impls whole; of the tagger and the VLM tagger the host
    # units (the mcut threshold; the caption parse).
    "models/impls.py": (*FIXTURE_IMPLS, "decode_wav", "Md5LookupImpl", "ApiEmbedImpl",
                        "TagApiImpl", "TaggerImpl.name", "TaggerImpl.mcut_threshold",
                        "CaptionerImpl.name", "VlmTaggerImpl", "OcrImpl.name"),
    # OCR's host units: the charset, both configs, the projection-profile
    # segmentation, the strip preparation and the two decodes to text.
    "models/ocr.py": ("<Params>", "<DEFAULT_CHARSET>", "OcrConfig", "<CONFIGS>", "AttnOcrConfig",
                      "<ATTN_CONFIGS>", "ctc_collapse", "attn_collapse", "segment_lines",
                      "prepare_strip"),
    # The audio towers' host units: whisper's constants, config, languages
    # and log-mel; the audio tower's config, mel preparation and HF ASTModel
    # mapping.
    "models/whisper.py": ("<SAMPLE_RATE>", "<N_FFT>", "<HOP>", "<N_MELS>", "<CHUNK_SECONDS>",
                          "WhisperConfig", "<LANGUAGES>", "<CONFIGS>", "mel_filterbank",
                          "log_mel_spectrogram"),
    "models/audio.py": ("<Params>", "AudioConfig", "<CONFIGS>", "prepare_mels", "_bert_block",
                        "load_ast_checkpoint"),
    # The sharded index's and the mesh's host units (build_sharded's host
    # packing is held statement by statement below).
    "index/sharded.py": ("_round_up",),
    "parallel/mesh.py": ("<SHARD_AXIS>", "<REPLICA_AXIS>", "<DATA_AXIS>", "<MODEL_AXIS>",
                         "<_MULTIHOST_LAYOUT>", "set_multihost_layout"),
}


# Units of the partial copies that differ from the reference's by design,
# each with its reason (as ``_unprocessed_text`` is listed above).
PARTIAL_DIVERGENCES = {
    "models/impls.py": {
        # The JAX impl pads every line strip of a call as one batch and raises
        # past the top bucket (ROADMAP §C); the port's predict decodes, then
        # reads the strips in slices of at most the top bucket (read_arrays).
        "OcrImpl.predict": "slices the call's line strips",
    },
}


def _units(source: str) -> dict:
    """ast.dump of every function and method, of every class body's other
    statements, and of every module-level statement but imports and the
    docstring, by name."""
    units = {}
    for node in ast.parse(source).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            units[node.name] = ast.dump(node)
        elif isinstance(node, ast.ClassDef):
            rest = []
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    units[f"{node.name}.{sub.name}"] = ast.dump(sub)
                else:
                    rest.append(ast.dump(sub))
            units[f"{node.name}.<body>"] = "\n".join(rest + [ast.dump(d) for d in node.decorator_list])
        elif not isinstance(node, (ast.Import, ast.ImportFrom)) and not (
                isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)):
            targets = node.targets if isinstance(node, ast.Assign) else [getattr(node, "target", None)]
            key = f"<{ast.dump(node)[:80]}>"
            if isinstance(node, (ast.Assign, ast.AnnAssign)) and all(
                    isinstance(t, ast.Name) for t in targets):
                named = f"<{', '.join(t.id for t in targets)}>"
                key = key if named in units else named
            units[key] = ast.dump(node)
    return units


def _reference_units(rel: str) -> dict:
    """The reference's units with ``panoptikon_tpu.`` read as
    ``panoptikon_tpu_torch.`` and the port's renames applied."""
    src = re.sub(r"\bpanoptikon_tpu\.", "panoptikon_tpu_torch.",
                 (REPO / "panoptikon_tpu" / rel).read_text())
    for pattern, repl in RENAMED.get(rel, {}).items():
        src = re.sub(pattern, repl, src)
    return _units(src)


@pytest.mark.parametrize("rel", HOST_COPIES)
def test_host_code_is_the_reference_s(rel):
    # Every host function, method and module statement of a copy equals the
    # reference's once `panoptikon_tpu.` reads `panoptikon_tpu_torch.`; only
    # the device units listed above differ. A later edit to either side
    # shows here instead of drifting.
    want = _reference_units(rel)
    got = _units((REPO / "panoptikon_tpu_torch" / rel).read_text())
    device = DEVICE_UNITS.get(rel, {"ported": set(), "added": set()})
    assert device["ported"] <= want.keys() and not device["added"] & want.keys()
    if rel.startswith("pql/"):
        assert device["ported"] <= got.keys(), f"{rel}: a ported unit is missing"
    assert set(want) - device["ported"] == set(got) - device["added"] - device["ported"]
    for name in set(want) - device["ported"]:
        assert got[name] == want[name], f"{rel}: {name} differs from the reference"


@pytest.mark.parametrize("rel", list(PARTIAL_COPIES))
def test_copied_units_are_the_reference_s(rel):
    ref_src = (REPO / "panoptikon_tpu" / rel).read_text()
    want = _units(re.sub(r"\bpanoptikon_tpu\.", "panoptikon_tpu_torch.", ref_src))
    got = _units((REPO / "panoptikon_tpu_torch" / rel).read_text())
    # An entry names a unit, or a class with every unit of it.
    names = [n for n in want if n in PARTIAL_COPIES[rel] or n.split(".")[0] in PARTIAL_COPIES[rel]]
    assert len(names) >= len(PARTIAL_COPIES[rel])
    for name in names:
        assert got.get(name) == want[name], f"{rel}: {name} differs from the reference"


def test_build_sharded_packs_as_the_reference():
    # index/sharded.py's build_sharded is the reference's text up to the
    # packed row permutation; only the device ends that follow (one slab a
    # mesh entry in place of device_put over a NamedSharding) differ.
    def body(root):
        tree = ast.parse((REPO / root / "index/sharded.py").read_text())
        fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                  and n.name == "build_sharded")
        return [ast.dump(stmt) for stmt in fn.body]

    want, got = body("panoptikon_tpu"), body("panoptikon_tpu_torch")
    cut = next(i for i, stmt in enumerate(want) if "row_perm" in stmt and "reshape" in stmt
               and stmt.startswith("Assign"))
    assert len(want) > cut > 10 and got[:cut + 1] == want[:cut + 1]
    assert any("NamedSharding" in stmt for stmt in want[cut + 1:])


@pytest.mark.parametrize("rel", list(PARTIAL_DIVERGENCES))
def test_listed_divergences_differ_from_the_reference(rel):
    # A unit listed as differing by design exists on both sides and still
    # differs: one that comes back to the reference's leaves the table.
    want = _units(re.sub(r"\bpanoptikon_tpu\.", "panoptikon_tpu_torch.",
                         (REPO / "panoptikon_tpu" / rel).read_text()))
    got = _units((REPO / "panoptikon_tpu_torch" / rel).read_text())
    for name in PARTIAL_DIVERGENCES[rel]:
        assert name in want and name in got and got[name] != want[name], name


# The port's own inference ids, all in resources/config/inference/10_port.toml
# (models the JAX package does not run).
PORT_ONLY_IDS = {"vlm/kimi-vl-a3b"}


def test_builtin_registry_is_the_reference_s():
    # The port's copy of the built-in TOML parses to the reference's, and
    # both registries resolve every reference id alike, with the same group
    # metadata; the port's only other ids are those of its 10_port.toml.
    import tomllib

    from panoptikon_tpu.models.registry import Registry as RefRegistry
    from panoptikon_tpu_torch.models.registry import Registry

    rel = "resources/config/inference/00_builtin.toml"
    assert tomllib.loads((REPO / "panoptikon_tpu_torch" / rel).read_text()) == \
        tomllib.loads((REPO / "panoptikon_tpu" / rel).read_text())
    got, want = Registry(None), RefRegistry(None)
    assert got.builtin_dir == REPO / "panoptikon_tpu_torch/resources/config/inference"
    assert sorted(p.name for p in got.builtin_dir.glob("*.toml")) == ["00_builtin.toml",
                                                                       "10_port.toml"]
    port = tomllib.loads((got.builtin_dir / "10_port.toml").read_text())
    port_ids = {f"{g}/{i}" for g, doc in port["group"].items() for i in doc["inference_ids"]}
    assert port_ids == PORT_ONLY_IDS
    assert [i for i in got.all_ids() if i not in PORT_ONLY_IDS] == want.all_ids()
    meta, want_meta = got.metadata(), want.metadata()
    assert list(meta) == list(want_meta)
    for group, entry in meta.items():
        assert entry["group_metadata"] == want_meta[group]["group_metadata"]
        ids = {k: v for k, v in entry["inference_ids"].items()
               if f"{group}/{k}" not in PORT_ONLY_IDS}
        assert ids == want_meta[group]["inference_ids"]
    for full in want.all_ids():
        group, _, name = full.partition("/")
        assert got.resolve(group, name).config == want.resolve(group, name).config


@pytest.mark.parametrize("rel", ["api/ui.html", "resources/config/server/default.toml"])
def test_served_files_are_the_reference_s(rel):
    # The built-in UI the port's /ui serves, and the server TOML template
    # `cli setup` writes, are the reference's bytes.
    assert (REPO / "panoptikon_tpu_torch" / rel).read_bytes() == \
        (REPO / "panoptikon_tpu" / rel).read_bytes()

def test_user_impl_discovery_registers_under_the_port(tmp_path):
    # discovery.py's copy imports a user module under the port's namespace,
    # never the JAX package's.
    import sys

    from panoptikon_tpu_torch.models import discovery

    (tmp_path / "mine.py").write_text(
        "IMPL_CLASS = 'Mine'\n"
        "class Mine:\n"
        "    @classmethod\n"
        "    def name(cls):\n"
        "        return 'mine_impl'\n")
    (tmp_path / "bad.py").write_text("raise RuntimeError('broken user module')\n")
    cls = discovery.find([tmp_path], "mine_impl")
    assert cls.__name__ == "Mine" and discovery.find([tmp_path], "Mine") is cls
    assert cls.__module__ == f"panoptikon_tpu_torch._user_impls.{tmp_path.name}.mine"
    assert not [m for m in sys.modules if m.startswith("panoptikon_tpu._user_impls")]
    with pytest.raises(LookupError, match="broken user module"):
        discovery.find([tmp_path], "nothing_impl")


def test_bulk_ingest_gives_the_reference_s_tables(tmp_path):
    # e2e_server_bench's slab inserts under bulk_ingest through each
    # package's Database and writer: equal tables, FTS rebuilt, the global
    # change marker appended, triggers and indexes back.
    from panoptikon_tpu.db.bulk import bulk_ingest as ref_bulk
    from panoptikon_tpu.db.connection import Database as RefDatabase
    from panoptikon_tpu.db.writer import IndexWriter as RefWriter
    from panoptikon_tpu_torch.db.bulk import bulk_ingest
    from panoptikon_tpu_torch.db.connection import Database
    from panoptikon_tpu_torch.db.writer import IndexWriter

    def seed(database_cls, writer_cls, bulk, root):
        db = database_cls(root, "bulk")
        writer = writer_cls(db)

        def unit(conn):
            with bulk(conn):
                conn.executemany("INSERT INTO items (id, sha256, md5, type, size, time_added)"
                                 " VALUES (?,?,?,?,?,?)",
                                 [(i, f"{i:064x}", f"{i:032x}", "image/png", i, "2026-01-01")
                                  for i in range(1, 51)])
                sid = conn.execute("INSERT INTO setters (name) VALUES ('ocr/x')").lastrowid
                conn.executemany("INSERT INTO item_data (id, item_id, setter_id, data_type, idx,"
                                 " is_origin) VALUES (?,?,?,?,0,1)",
                                 [(i, i, sid, "text") for i in range(1, 51)])
                conn.executemany("INSERT INTO extracted_text (id, text, language,"
                                 " language_confidence, confidence, text_length)"
                                 " VALUES (?,?,?,?,?,?)",
                                 [(i, f"w{i % 3} tok{i % 7:04d}", "en", 0.9, 0.8, 12)
                                  for i in range(1, 51)])

        try:
            writer.call(unit)
        finally:
            writer.close()
        conn = db.reader()
        return {
            "schema": _schema_dump(conn),
            "fts": conn.execute("SELECT rowid FROM extracted_text_fts WHERE extracted_text_fts"
                                " MATCH '\"tok0003\"' ORDER BY rowid").fetchall(),
            "log": conn.execute("SELECT item_id FROM base_change_log").fetchall(),
            "items": conn.execute("SELECT * FROM items").fetchall(),
        }

    got = seed(Database, IndexWriter, bulk_ingest, tmp_path / "port")
    want = seed(RefDatabase, RefWriter, ref_bulk, tmp_path / "ref")
    assert got == want
    assert len(got["fts"]) == 7 and got["log"][-1] == (None,)


def test_port_executor_and_fused_touch_no_jax_or_mesh():
    # The sharded branches are ported (over the port's own mesh); the
    # sources name no JAX.
    for rel in ("pql/executor.py", "pql/fused.py"):
        src = (REPO / "panoptikon_tpu_torch" / rel).read_text()
        assert "jax" not in src


def test_splitmix_matches():
    from panoptikon_tpu.utils import splitmix as ref_mix
    from panoptikon_tpu_torch.utils import splitmix

    rng = np.random.default_rng(12)
    ids = np.concatenate([rng.integers(0, 2**40, size=500), [0, 1, 2**63 - 1]]).astype(np.int64)
    for seed in (0, 1, 424242, 2**40 + 3, -5):
        np.testing.assert_array_equal(splitmix.pk_mix_array(ids, seed),
                                      ref_mix.pk_mix_array(ids, seed))
        assert [splitmix.pk_mix(int(i), seed) for i in ids[:20]] == \
            [ref_mix.pk_mix(int(i), seed) for i in ids[:20]]
    assert splitmix.mix64(2**64 - 1) == ref_mix.mix64(2**64 - 1)


def _schema_dump(conn):
    return conn.execute("SELECT type, name, tbl_name, sql FROM sqlite_master ORDER BY name").fetchall()


def test_schema_of_fresh_databases_matches(tmp_path):
    from panoptikon_tpu.db.connection import Database as RefDatabase
    from panoptikon_tpu_torch.db.connection import Database

    ref_db, db = RefDatabase(tmp_path / "ref", "x"), Database(tmp_path / "port", "x")
    for user_data in (False, True):
        assert _schema_dump(db.reader(user_data)) == _schema_dump(ref_db.reader(user_data))
    assert len(_schema_dump(db.reader(False))) > 20


def _seed(store, database_cls, writer_cls, root, monkeypatch):
    """The same writes through one package's store and writer: items,
    files, setters, text with FTS, embeddings, tags, errors, config."""
    monkeypatch.setattr(store, "now_iso", lambda: "2026-01-01T00:00:00+00:00")
    db = database_cls(root, "seed")
    writer = writer_cls(db)
    rng = np.random.default_rng(13)

    def unit(conn):
        clip, ocr, tagger = (store.upsert_setter(conn, n) for n in ("clip/x", "ocr/x", "tags/x"))
        for i in range(40):
            sha = f"{i:04x}" * 16
            item = store.upsert_item(conn, sha, f"{i:04x}" * 8, "image/png", size=100 + i,
                                     width=10 + i, height=20 + i)
            store.upsert_file(conn, item, sha, f"/c/d{i % 3}/f{i}.png", f"2026-01-{1 + i % 28:02d}")
            did = store.insert_item_data(conn, item, clip, "clip")
            store.insert_embedding(conn, did, rng.normal(size=8).astype(np.float32))
            tdid = store.insert_item_data(conn, item, ocr, "text", idx=0)
            store.insert_extracted_text(conn, tdid, f"word{i % 5} token{i}", language="en",
                                        confidence=0.5 + i / 100, language_confidence=0.9)
            if i % 3 == 0:
                gdid = store.insert_item_data(conn, item, tagger, "tags")
                store.tag_item(conn, gdid, item, store.upsert_tag(conn, "general", f"t{i % 4}"),
                               0.5)
        store.record_extraction_error(conn, 3, "clip/x", stage="inference", error_class="input",
                                      message="m")
        store.set_config(conn, "k", {"a": 1})
        store.recount_tags(conn)
        return store.count_unprocessed(conn, "ocr/x", ["image/png"]) \
            if hasattr(store, "count_unprocessed") else None

    try:
        writer.call(unit)
    finally:
        writer.close()
    conn = db.reader()
    tables = [r[0] for r in conn.execute(
        "SELECT name FROM sqlite_master WHERE type='table' AND name NOT LIKE '%fts%' ORDER BY name")]
    dump = {t: conn.execute(f"SELECT * FROM {t}").fetchall() for t in tables}
    dump["fts"] = conn.execute(
        "SELECT rowid FROM extracted_text_fts WHERE extracted_text_fts MATCH 'word3' ORDER BY rowid"
    ).fetchall()
    return dump


def test_store_and_writer_give_equal_tables(tmp_path, monkeypatch):
    from panoptikon_tpu.db import store as ref_store
    from panoptikon_tpu.db.connection import Database as RefDatabase
    from panoptikon_tpu.db.writer import IndexWriter as RefWriter
    from panoptikon_tpu_torch.db import store
    from panoptikon_tpu_torch.db.connection import Database
    from panoptikon_tpu_torch.db.writer import IndexWriter

    got = _seed(store, Database, IndexWriter, tmp_path / "port", monkeypatch)
    want = _seed(ref_store, RefDatabase, RefWriter, tmp_path / "ref", monkeypatch)
    assert got.keys() == want.keys() and got == want
    assert len(got["fts"]) == 8 and len(got["items"]) == 40


@pytest.mark.parametrize("payload", [
    {"page_size": 3},
    {"query": {"and_": [{"match": {"gt": {"size": 5}}}, {"not_": {"match_tags": {"tags": ["a"]}}}]},
     "order_by": [{"order_by": "size", "order": "desc"}], "page": 2, "count": False},
    {"query": {"or_": [
        {"image_embeddings": {"query": "x", "model": "clip/x", "index": "quant"},
         "row_n": True, "priority": 5, "rrf": {"k": 60, "weight": 0.8}},
        {"text_embeddings": {"query": "y", "model": "st/x", "distance_aggregation": "AVG"},
         "select_as": "d"}]}, "partition_by": ["item_id"], "seed": 7},
    {"query": {"similar_to": {"target": "ab" * 32, "model": "clip/x",
                              "distance_function": "L2"}}, "entity": "text"},
])
def test_pql_model_parses_like_the_reference(payload):
    from panoptikon_tpu.pql import model as ref_pql
    from panoptikon_tpu_torch.pql import model as pql

    got, want = pql.PqlQuery.from_json(payload), ref_pql.PqlQuery.from_json(payload)
    assert repr(got) == repr(want)
    assert got.resolve_seed() == want.resolve_seed() or payload.get("seed") is None


def test_preprocess_resolves_vectors_like_the_reference():
    import base64

    from panoptikon_tpu.index.vector_index import VectorIndex as RefIndex
    from panoptikon_tpu.pql import model as ref_pql
    from panoptikon_tpu.pql import preprocess as ref_prep
    from panoptikon_tpu_torch.pql import model as pql
    from panoptikon_tpu_torch.pql import preprocess as prep

    rng = np.random.default_rng(14)
    vecs = rng.normal(size=(50, 16)).astype(np.float32)
    blob = base64.standard_b64encode(npy.serialize_npy(rng.normal(size=16).astype(np.float32)))
    leaf = {"query": blob.decode(), "model": "clip/x", "embed": None}
    payload = {"query": {"and_": [{"image_embeddings": {**leaf, "index": "quant"}},
                                  {"text_embeddings": {**leaf, "index": "exact"}}]}}
    resolved = []
    for index_cls, model, pre in ((VectorIndex, pql, prep), (RefIndex, ref_pql, ref_prep)):
        index = index_cls(chunk_rows=64)
        index.add("clip/x", np.arange(50), np.arange(50), vecs)
        index.build_quant("clip/x")
        query = model.PqlQuery.from_json(json.loads(json.dumps(payload)))
        pre.preprocess_query(query, manager=None, index=index)
        a, b = query.query.and_
        resolved.append([(x._embedding, x._quant, x._distance_func_override)
                         for x in (a.image_embeddings, b.text_embeddings)])
    for (ge, gq, gd), (we, wq, wd) in zip(*resolved):
        np.testing.assert_array_equal(ge, we)
        assert gd == wd and (gq is None) == (wq is None)
        if gq is not None:
            assert gq.scale == wq.scale
            np.testing.assert_array_equal(gq.query_quant, wq.query_quant)
    assert resolved[0][0][1] is not None and resolved[0][1][1] is None


# ---------------------------------------------------------------------------
# The native host codec: csrc/host_codec.cpp, built with the host compiler
# into build/torch_kernels/, against the NumPy path and the JAX package's
# native library (tests/test_native.py's inputs).
# ---------------------------------------------------------------------------


def test_host_codec_source_is_the_reference_s():
    assert (REPO / "panoptikon_tpu_torch/csrc/host_codec.cpp").read_text() == \
        (REPO / "panoptikon_tpu/native/codec.cpp").read_text()


@pytest.fixture(scope="module")
def natives():
    from panoptikon_tpu import native as ref_native
    from panoptikon_tpu_torch import _build
    from panoptikon_tpu_torch import native

    assert native.ensure_built() and native.available()
    assert _build.host_library_path("host_codec").parent == _build.BUILD_DIR
    assert ref_native.ensure_built()
    return native, ref_native


def _numpy_path(monkeypatch):
    monkeypatch.setattr(codec, "_native", lambda: None)


def test_native_absmax_matches_numpy_and_the_reference(natives, monkeypatch):
    native, ref_native = natives
    rng = np.random.default_rng(0)
    data = rng.normal(size=4096).astype(np.float32) * 7
    data[17] = np.nan
    edges = _edge_rows(0.5)
    for arr in (data, edges, edges[:, 1:], data[:0]):
        got = native.absmax(arr)
        assert got == ref_native.absmax(arr)
        before = dict(codec.native_calls)
        via_codec = codec.corpus_absmax(arr)
        streamed = arr.size > 0 and arr.flags["C_CONTIGUOUS"]  # else the NumPy path
        assert codec.native_calls["absmax"] == before["absmax"] + streamed
        with monkeypatch.context() as m:
            _numpy_path(m)
            assert codec.corpus_absmax(arr) == via_codec
        if np.isfinite(arr).all():
            assert got == via_codec == ref_codec.corpus_absmax(arr)
    assert native.absmax(data) == codec.corpus_absmax(data) == ref_codec.corpus_absmax(data)


@pytest.mark.parametrize("scale", [1.0, 0.01, 123.0, 0.5, 3e-20])
def test_native_quantize_matches_numpy_and_the_reference(natives, monkeypatch, scale):
    native, ref_native = natives
    rng = np.random.default_rng(1)
    data = rng.normal(size=(128, 64)).astype(np.float32) * 3
    data[0, :5] = [0.5, 1.5, -2.5, np.nan, 1e9]
    for arr in (data, _edge_rows(scale), _edge_rows(1.0)):
        got = native.quantize_int8(arr, scale)
        np.testing.assert_array_equal(got, ref_native.quantize_int8(arr, scale))
        before = codec.native_calls["quantize"]
        out = np.full(arr.shape, 99, np.int8)
        assert codec.quantize_int8_host(arr, scale, out=out) is out
        assert codec.native_calls["quantize"] == before + 1
        np.testing.assert_array_equal(out, got)
        with monkeypatch.context() as m:
            _numpy_path(m)
            np.testing.assert_array_equal(codec.quantize_int8_host(arr, scale), got)
        np.testing.assert_array_equal(ref_codec.quantize_int8(arr, scale), got)


def test_native_dequantize_sumsq_and_mix_match(natives):
    from panoptikon_tpu.utils import splitmix as ref_mix
    from panoptikon_tpu_torch.utils import splitmix

    native, ref_native = natives
    codes = np.random.default_rng(2).integers(-128, 128, size=(16, 32), dtype=np.int8)
    got = native.dequantize_int8(codes, 0.02)
    np.testing.assert_array_equal(got, ref_native.dequantize_int8(codes, 0.02))
    np.testing.assert_array_equal(got, codec.dequantize_int8_host(codes, 0.02))
    codes = np.random.default_rng(3).integers(-128, 128, size=(64, 96), dtype=np.int8)
    sums = native.row_sumsq_int8(codes)
    np.testing.assert_array_equal(sums, ref_native.row_sumsq_int8(codes))
    np.testing.assert_array_equal(sums, np.sum(codes.astype(np.int32) ** 2, axis=1))
    ids = np.array([0, 1, 42, 2**40, -1], dtype=np.int64)
    for seed in (0, 7, -3, 2**52):
        mixed = native.pk_mix_array(ids, seed)
        np.testing.assert_array_equal(mixed, ref_native.pk_mix_array(ids, seed))
        np.testing.assert_array_equal(mixed, splitmix.pk_mix_array(ids, seed))
        np.testing.assert_array_equal(mixed, ref_mix.pk_mix_array(ids, seed))


def test_native_build_is_keyed_and_falls_back_without_a_compiler(natives, monkeypatch):
    # The library's name carries a hash of the source, the flags and the
    # processor's target macros; without g++ nothing builds, the bindings
    # and the codec keep their NumPy paths.
    from panoptikon_tpu_torch import _build
    from panoptikon_tpu_torch import native

    path = _build.host_library_path("host_codec")
    assert path.exists() and path.name.startswith("host_codec-") and path.suffix == ".so"
    assert "-march=native" in _build.HOST_CXX_FLAGS and "-shared" in _build.HOST_CXX_FLAGS
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_host_target", lambda: b"another processor")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        _build.build_host("host_codec")
    monkeypatch.setattr(native, "_lib", None)
    assert not native.ensure_built() and not native.available()
    x = np.array([[0.5, -1.5, np.nan, 300.0]], np.float32)
    np.testing.assert_array_equal(native.quantize_int8(x, 1.0), [[0, -2, 0, 127]])
    assert native.absmax(x) == 300.0


def test_logging_copy_times_phases_and_configures_the_port_logger(monkeypatch):
    # The copy's PhaseTimer reports what the reference's does for the same
    # spans, and init_logging sets the port's logger tree (the level from
    # PANOPTIKON_LOG over the config's, one console handler however often
    # it is called).
    import logging
    import threading

    from panoptikon_tpu.utils import logging as ref_logging
    from panoptikon_tpu_torch.utils import logging as port_logging

    reports = []
    for mod in (ref_logging, port_logging):
        timer = mod.PhaseTimer()
        gate = threading.Barrier(3)

        def work(timer=timer, gate=gate):
            with timer.span("inference"):
                gate.wait()
        threads = [threading.Thread(target=work) for _ in range(2)]
        with timer.span("load"):
            for t in threads:
                t.start()
            gate.wait()
        for t in threads:
            t.join()
        reports.append(timer.report())
    assert [set(r) for r in reports] == [{"load", "inference"}] * 2
    for r in reports:
        assert r["inference"]["parallelism"] >= 1.0 and r["load"]["parallelism"] == 1.0
    logger = logging.getLogger("panoptikon_tpu_torch")
    saved = (logger.level, list(logger.handlers))
    try:
        logger.handlers.clear()
        monkeypatch.setenv("PANOPTIKON_LOG", "debug")
        port_logging.init_logging("error")
        port_logging.init_logging("error")
        assert logger.level == logging.DEBUG and len(logger.handlers) == 1
    finally:
        logger.setLevel(saved[0])
        logger.handlers[:] = saved[1]
