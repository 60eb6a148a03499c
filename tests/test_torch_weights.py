"""Checkpoint loading on the port (``models/weights.py``) against the JAX
package's, on checkpoints written to a temporary folder: the HF ``CLIPModel``
layout (written by the reference's ``save_clip_checkpoint``) and a BERT
layout (built as ``tests/test_weights.py`` builds it). The loaded trees must
equal the reference's array for array, and the impls built on them must
embed as the port's impls do on the same tree, and as the JAX impls do
within the text encoder's tolerance (min cosine ≥ 0.999, max abs ≤ 2e-2 ×
max |ref|)."""

import sys

import jax
import numpy as np
import pytest
import torch

from panoptikon_tpu.models import clip as ref_clip
from panoptikon_tpu.models import impls as ref_impls
from panoptikon_tpu.models import text_embed as ref_text
from panoptikon_tpu.models import weights as ref_weights
from panoptikon_tpu_torch.models import clip, convert, impls, text_embed, weights


def _equal_trees(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _equal_trees(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(
            _equal_trees(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.fixture(scope="module")
def clip_ckpt(tmp_path_factory):
    cfg = ref_clip.CONFIGS["test-tiny"]
    tree = jax.tree.map(np.asarray, ref_clip.init_params(jax.random.key(7), cfg))
    path = tmp_path_factory.mktemp("clip") / "pytorch_model.bin"
    ref_weights.save_clip_checkpoint(tree, cfg, path)
    return path


def test_clip_checkpoint_loads_the_reference_tree(clip_ckpt):
    got = weights.load_clip_checkpoint(clip_ckpt, clip.CONFIGS["test-tiny"])
    want = ref_weights.load_clip_checkpoint(clip_ckpt, ref_clip.CONFIGS["test-tiny"])
    assert _equal_trees(got, want)
    # A folder holding the checkpoint loads the same file.
    assert _equal_trees(weights.load_clip_checkpoint(clip_ckpt.parent, clip.CONFIGS["test-tiny"]),
                        want)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_clip_impl_loads_a_checkpoint(clip_ckpt, precision):
    loaded = impls.ClipImpl("test-tiny", checkpoint=str(clip_ckpt), precision=precision,
                            device="cpu")
    direct = impls.ClipImpl("test-tiny", precision=precision, device="cpu")
    tree = ref_weights.load_clip_checkpoint(clip_ckpt, ref_clip.CONFIGS["test-tiny"])
    direct.params = convert.params_from_jax(tree, device="cpu")
    if precision == "int8":
        direct.params = clip.quantize_block_weights(direct.params)
    rng = np.random.default_rng(8)
    size = loaded.cfg.image_size
    inputs = [impls.PredictionInput(data={"pixels": rng.normal(size=(size, size, 3))})
              for _ in range(3)]
    inputs += [impls.PredictionInput(data={"text": t}) for t in ("a red car", "two dogs")]
    got, want = loaded.predict(inputs), direct.predict(inputs)
    assert got == want
    assert all(np.isfinite(impls.npy.parse_npy(o)).all() for o in got)


def synth_bert(cfg, layers, seed=4):
    """A BERT-layout state dict (tests/test_weights.py's recipe) with random
    LayerNorm affines, so that every leaf of the mapping is exercised."""
    rng = np.random.default_rng(seed)
    w = cfg.width

    def ln(prefix):
        sd[f"{prefix}.weight"] = (1 + 0.1 * rng.normal(size=w)).astype(np.float32)
        sd[f"{prefix}.bias"] = (0.1 * rng.normal(size=w)).astype(np.float32)

    sd = {
        "embeddings.word_embeddings.weight": rng.normal(size=(cfg.vocab, w)).astype(np.float32) * 0.02,
        "embeddings.position_embeddings.weight": rng.normal(size=(cfg.ctx, w)).astype(np.float32) * 0.02,
        "embeddings.token_type_embeddings.weight": rng.normal(size=(2, w)).astype(np.float32) * 0.02,
    }
    ln("embeddings.LayerNorm")
    for i in range(layers):
        p = f"encoder.layer.{i}"
        for name, (ci, co) in {
            "attention.self.query": (w, w), "attention.self.key": (w, w),
            "attention.self.value": (w, w), "attention.output.dense": (w, w),
            "intermediate.dense": (w, 4 * w), "output.dense": (4 * w, w),
        }.items():
            sd[f"{p}.{name}.weight"] = rng.normal(size=(co, ci)).astype(np.float32) * ci**-0.5
            sd[f"{p}.{name}.bias"] = rng.normal(size=co).astype(np.float32) * 0.02
        ln(f"{p}.attention.output.LayerNorm")
        ln(f"{p}.output.LayerNorm")
    return sd


def save_bert(sd, path):
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    return path


@pytest.fixture(scope="module")
def bert_ckpt(tmp_path_factory):
    cfg = ref_text.CONFIGS["test-tiny"]
    return save_bert(synth_bert(cfg, cfg.layers), tmp_path_factory.mktemp("bert") / "model.bin")


def test_text_encoder_checkpoint_loads_the_reference_tree(bert_ckpt):
    got = weights.load_text_encoder_checkpoint(bert_ckpt, text_embed.CONFIGS["test-tiny"])
    want = ref_weights.load_text_encoder_checkpoint(bert_ckpt, ref_text.CONFIGS["test-tiny"])
    assert _equal_trees(got, want)
    assert len(got["blocks"]) == 2 and np.asarray(got["ln_emb"]["scale"]).std() > 0


def test_layer_count_mismatch_raises_in_both(tmp_path):
    cfg = ref_text.CONFIGS["test-tiny"]
    path = save_bert(synth_bert(cfg, 1), tmp_path / "one_layer.bin")
    with pytest.raises(ValueError, match="1 layers"):
        weights.load_text_encoder_checkpoint(path, text_embed.CONFIGS["test-tiny"])
    with pytest.raises(ValueError, match="1 layers"):
        ref_weights.load_text_encoder_checkpoint(path, cfg)


def test_text_impl_on_a_checkpoint_matches_the_jax_impl(bert_ckpt):
    texts = ["a photo of a red car", "w " * 70, "the quick brown fox jumps over the lazy dog " * 3]
    inputs = [impls.PredictionInput(data={"text": t}) for t in texts]
    got = impls.TextEmbedImpl("test-tiny", checkpoint=str(bert_ckpt), device="cpu").predict(inputs)
    want = ref_impls.TextEmbedImpl("test-tiny", checkpoint=str(bert_ckpt)).predict(inputs)
    for g, w in zip(got, want):
        g, w = impls.npy.parse_npy(g), impls.npy.parse_npy(w)
        assert g.shape == w.shape and np.isfinite(g).all()
        cos = np.sum(g * w, axis=1) / (np.linalg.norm(g, axis=1) * np.linalg.norm(w, axis=1))
        assert cos.min() >= 0.999
        assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max()


def test_safetensors_checkpoint_loads_as_the_reference_s(tmp_path, bert_ckpt):
    pytest.importorskip("safetensors")
    from safetensors.numpy import save_file

    path = tmp_path / "model.safetensors"
    save_file(weights.load_state_dict(bert_ckpt), str(path))
    assert _equal_trees(weights.load_state_dict(path), ref_weights.load_state_dict(path))
    assert _equal_trees(weights.load_state_dict(path), weights.load_state_dict(bert_ckpt))


def test_safetensors_without_the_package_says_what_is_missing(tmp_path, monkeypatch, bert_ckpt):
    # The card machine has no safetensors package: a .safetensors load
    # raises and names it, and a .bin still loads.
    (tmp_path / "model.safetensors").write_bytes(b"\x00" * 16)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    with pytest.raises(RuntimeError, match="safetensors package"):
        weights.load_state_dict(tmp_path / "model.safetensors")
    with pytest.raises(RuntimeError, match="safetensors package"):
        weights.load_text_encoder_checkpoint(tmp_path, text_embed.CONFIGS["test-tiny"])
    with pytest.raises(RuntimeError, match="safetensors package"):
        impls.TextEmbedImpl("test-tiny", checkpoint=str(tmp_path), device="cpu").load()
    assert len(weights.load_state_dict(bert_ckpt)) == 5 + 2 * 16


def test_missing_checkpoint_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        weights.load_state_dict(tmp_path)
