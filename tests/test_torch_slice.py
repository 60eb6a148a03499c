"""The whole slice at test-tiny, JAX package against port: CLIP embed ->
VectorIndex (int8 arm under a frozen scale) -> int8 scan + f32 rescore.
Each side embeds with its own towers from the same parameters and inputs
and builds its own index; the top-k ids must agree, tie-aware.

The two towers agree to cosine ≥ 0.999, which moves a distance by a few
1e-3 (hence the 5e-3 below); among random unit vectors neighbours sit
closer than that. So each
text query gets K planted neighbours at distances 0.025 apart (built around
the reference's text embedding, the same rows in both indexes), and the
random fill lies farther out: the ids are then decided by the slice, not by
the last bits of the towers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoptikon_tpu.index.vector_index import VectorIndex as RefIndex
from panoptikon_tpu.models import clip as ref_clip
from panoptikon_tpu.ops import codec as ref_codec
from panoptikon_tpu.ops import scoring as ref_scoring
from panoptikon_tpu_torch.index import VectorIndex
from panoptikon_tpu_torch.index.device_index import DeviceIndex
from panoptikon_tpu_torch.models import clip, convert
from panoptikon_tpu_torch.ops import exact, int8_scan

from test_torch_clip import tokens
from test_torch_int8_scan_v2 import _planted_batch

N_IMAGES, N_FILL, N_TEXT, K = 48, 2000, 8, 10


def _planted(anchors, rng):
    """K unit rows per anchor at cosine distance 0.01 + 0.025·j, j < K."""
    rows = []
    for u in anchors:
        for j in range(K):
            r = rng.normal(size=u.shape)
            r -= (r @ u) * u
            r /= np.linalg.norm(r)
            c = 1.0 - (0.01 + 0.025 * j)
            rows.append(c * u + np.sqrt(1.0 - c * c) * r)
    return np.asarray(rows, np.float32)


def _build(image_emb, fill, index_cls=VectorIndex):
    index = index_cls()
    n = len(image_emb) + len(fill)
    index.reserve("clip", n, image_emb.shape[1])
    index.add("clip", np.arange(len(image_emb)), np.arange(len(image_emb)), image_emb)
    index.add("clip", np.arange(len(image_emb), n), np.arange(len(image_emb), n), fill)
    index.build_quant("clip")
    return index


@pytest.fixture(scope="module")
def slice_inputs():
    cfg = clip.CONFIGS["test-tiny"]
    rng = np.random.default_rng(0)
    images = rng.normal(size=(N_IMAGES, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    ids = tokens(rng, N_TEXT, cfg.text_ctx, cfg.text_vocab)
    fill = rng.normal(size=(N_FILL, cfg.embed_dim)).astype(np.float32)
    fill /= np.linalg.norm(fill, axis=1, keepdims=True)
    jparams = ref_clip.init_params(jax.random.key(3), ref_clip.CONFIGS["test-tiny"])
    return cfg, images, ids, fill, jparams


def test_slice_matches_reference(slice_inputs):
    cfg, images, ids, fill, jparams = slice_inputs

    # Reference: JAX towers -> VectorIndex -> JAX int8_topk_rescored.
    j_img = np.asarray(ref_clip.embed_images_jit(jparams, cfg, jnp.asarray(images)))
    j_txt = np.asarray(ref_clip.embed_texts_jit(jparams, cfg, jnp.asarray(ids)))
    fill = np.concatenate([_planted(j_txt, np.random.default_rng(1)), fill])
    snap = _build(j_img, fill, RefIndex).snapshot("clip")
    q_codes = ref_codec.quantize_int8(j_txt, snap.scale)
    rv, ri, rok = ref_scoring.int8_topk_rescored(
        snap.codes, ref_scoring.row_sumsq(snap.codes), snap.row_valid, snap.vectors,
        q_codes, j_txt, k=K, oversample=8, distance="cosine", scale=snap.scale,
    )

    # Port: torch towers -> VectorIndex -> DeviceIndex on the CPU.
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    t_img = clip.embed_images(tparams, cfg, torch.from_numpy(images)).numpy()
    t_txt = clip.embed_texts(tparams, cfg, torch.from_numpy(ids))
    index = _build(t_img, fill)
    dev = DeviceIndex(index, "clip", torch.device("cpu"))
    gv, gi, gok = dev.search(t_txt, K)

    assert gok.all() and np.asarray(rok).all()
    assert exact.topk_agree(gv.numpy(), gi.numpy(), np.asarray(rv), np.asarray(ri), atol=5e-3)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    items = dev.item_ids(gi, gok)
    np.testing.assert_array_equal(items, gi.numpy())  # item id == row id here
    assert (gi.numpy() < dev.size).all()


def test_batched_search_matches_reference(monkeypatch):
    # The batch route: 520 queries (> V1_MAX_QUERIES) through each side's
    # VectorIndex and the port's DeviceIndex reach B2's plain version on the
    # CPU; each query's 10 planted neighbours sit in lanes of their own, so
    # the lane buckets lose none of them.
    corpus, queries, _, _, _, _, _ = _planted_batch()
    n = len(corpus)
    indexes = [_build(corpus, np.zeros((0, corpus.shape[1]), np.float32), cls)
               for cls in (RefIndex, VectorIndex)]
    ref_snap, snap = (index.snapshot("clip") for index in indexes)
    np.testing.assert_array_equal(snap.codes, ref_snap.codes)
    rv, ri, rok = ref_scoring.int8_topk_rescored(
        ref_snap.codes[:n], ref_scoring.row_sumsq(ref_snap.codes[:n]), ref_snap.row_valid[:n],
        ref_snap.vectors[:n], ref_codec.quantize_int8(queries, ref_snap.scale), queries, k=K,
        oversample=8, distance="cosine", scale=ref_snap.scale,
    )
    calls = []
    v2 = int8_scan.int8_topk_v2
    monkeypatch.setattr(int8_scan, "int8_topk_v2", lambda *a, **kw: calls.append(kw) or v2(*a, **kw))
    dev = DeviceIndex(indexes[1], "clip", torch.device("cpu"))
    gv, gi, gok = dev.search(torch.from_numpy(queries), K)
    assert len(calls) == 1 and calls[0]["k"] == 8 * K
    assert gok.all() and np.asarray(rok).all()
    assert exact.topk_agree(gv.numpy(), gi.numpy(), np.asarray(rv), np.asarray(ri), atol=1e-6)
    np.testing.assert_array_equal(dev.item_ids(gi, gok), gi.numpy())
