"""The port's ``TaggerImpl`` (``models/impls.py``), its trunk entry
``clip.embed_images_raw`` and the timm checkpoint mapping
(``models/weights.py``) against the JAX package's, at test-tiny on the CPU,
with the JAX impl's loaded weights carried over (``models.convert``).

Tolerances. Off the TPU both trunks are bf16 matmuls whose roundings differ
(XLA against PyTorch's CPU kernels), and the head applies to the raw,
unnormalized pooled features, so the sigmoid probabilities differ by up to
about 8e-3 in bf16 and 2e-2 in int8 (each side calibrates its own scales):

- raw features: cosine ≥ 0.999 a row;
- probabilities: within 1e-2 (bf16) and 3e-2 (int8); the reference's own
  int8-against-bf16 gate is 5e-2 (``tests/test_models.py``);
- mcut tag sets: equal wherever the largest gap of the sorted general
  probabilities beats the runner-up gap by more than twice the largest
  probability difference seen (with random weights the probabilities
  cluster, so a second gap may be almost as wide and the two sides may cut
  at different gaps); at least one image per case meets the rule.
"""

import io

import jax
import numpy as np
import pytest
import torch

from panoptikon_tpu.models import clip as ref_clip
from panoptikon_tpu.models import impls as ref
from panoptikon_tpu.models import weights as ref_weights
from panoptikon_tpu.models.base import PredictionInput as RefInput
from panoptikon_tpu_torch.models import clip, convert, impls, weights
from panoptikon_tpu_torch.models.base import PredictionInput

PROB_ATOL = {"bf16": 1e-2, "int8": 3e-2}
ALL_TAGS = {"threshold": 1e-9, "character_threshold": 0.0}  # every tag with its probability


def pngs(n, seed=0):
    """n seeded PNG images of several sizes (the decode resizes and crops)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        buf = io.BytesIO()
        h, w = 32 + 8 * (i % 3), 32 + 12 * (i % 4)
        Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)).save(buf, "PNG")
        out.append(buf.getvalue())
    return out


def carry(jimpl, timpl):
    """The JAX impl's loaded trunk and head into the port's impl."""
    timpl.params = convert.params_from_jax(jax.tree.map(np.asarray, jimpl.params), device="cpu")
    timpl.head = torch.from_numpy(np.asarray(jimpl.head, np.float32))
    timpl.head_bias = torch.from_numpy(np.asarray(jimpl.head_bias, np.float32))
    timpl.cfg, timpl.tag_vocab, timpl.character_tags = jimpl.cfg, jimpl.tag_vocab, jimpl.character_tags
    return timpl


def general(out):
    return dict(out["tags"])["general"]


def prob_diff(got, want, cats=("character", "general")):
    """The largest difference of the probabilities in two outputs holding
    every tag (``ALL_TAGS``)."""
    worst = 0.0
    for g, w in zip(got, want):
        for cat in cats:
            gd, wd = dict(g["tags"])[cat], dict(w["tags"])[cat]
            assert gd.keys() == wd.keys(), cat
            worst = max([worst, *(abs(gd[k] - wd[k]) for k in wd)])
    return worst


def ref_probs(jimpl, images):
    """The JAX impl's sigmoid probabilities of ``images``, as its predict
    computes them (one padded batch, its calibrated scales under int8)."""
    bucket = ref.batching.bucket_for(len(images), jimpl.batch_ladder)
    padded = ref.batching.pad_batch(images, bucket)[0]
    if jimpl.precision == "int8":
        feats = ref_clip.embed_images_raw_scaled_jit(jimpl.params, jimpl.cfg, padded,
                                                     jimpl._act_scales)
    else:
        feats = ref_clip.embed_images_raw_jit(jimpl.params, jimpl.cfg, padded)
    logits = np.asarray(feats)[: len(images)] @ jimpl.head + jimpl.head_bias
    return 1.0 / (1.0 + np.exp(-logits))


def same_ratings(got, want, probs, err):
    """The rating's probability within ``err``; its tag equal wherever the
    top-2 rating probabilities are more than twice ``err`` apart."""
    for g, w, p in zip(got, want, probs):
        (gk, gv), = dict(g["tags"])["rating"].items()
        (wk, wv), = dict(w["tags"])["rating"].items()
        assert abs(gv - wv) <= err
        top2 = np.sort(p[:5])[-2:]
        assert gk == wk or top2[1] - top2[0] <= 2 * err


def same_mcut_sets(got, want, every, err):
    """The margin rule: equal mcut tag sets wherever the chosen gap beats the
    runner-up by more than twice ``err``. Returns how many images it held."""
    held = 0
    for g, w, full in zip(got, want, every):
        probs = np.sort(np.array(list(general(full).values())))[::-1]
        gaps = np.sort(probs[:-1] - probs[1:])[::-1]
        if gaps[0] - gaps[1] > 2 * err:
            assert general(g).keys() == general(w).keys()
            assert abs(g["mcut"] - w["mcut"]) <= err
            held += 1
    return held


@pytest.fixture(scope="module", params=["bf16", "int8"])
def pair(request):
    jimpl = ref.TaggerImpl("test-tiny", precision=request.param)
    jimpl.load()
    return request.param, jimpl, carry(jimpl, impls.TaggerImpl("test-tiny", precision=request.param,
                                                               device="cpu"))


def test_predict_matches_the_jax_impl(pair):
    precision, jimpl, timpl = pair
    files = pngs(8)
    every_w = jimpl.predict([RefInput(file=f, data=ALL_TAGS) for f in files])
    every_g = timpl.predict([PredictionInput(file=f, data=ALL_TAGS) for f in files])
    assert [general(o).keys() for o in every_g] == [set(timpl.tag_vocab)] * 8
    images = np.stack([ref.decode_image(f, 32) for f in files])
    want_p = ref_probs(jimpl, images)
    err = float(np.abs(timpl.probabilities(images) - want_p).max())
    assert err <= PROB_ATOL[precision], err
    assert prob_diff(every_g, every_w) <= err
    same_ratings(every_g, every_w, want_p, err)
    for g, w in zip(every_g, every_w):
        assert {k: g[k] for k in g if k != "tags" and k != "mcut"} == \
            {k: w[k] for k in w if k != "tags" and k != "mcut"}
    got = timpl.predict([PredictionInput(file=f) for f in files])
    want = jimpl.predict([RefInput(file=f) for f in files])
    assert same_mcut_sets(got, want, every_w, err) >= 1


def test_raw_features_match(pair):
    precision, jimpl, timpl = pair
    images = np.stack([ref.decode_image(f, 32) for f in pngs(6, seed=1)])
    # Each side calibrates on this batch (padded to the bucket of 8).
    if precision == "int8":
        scales = ref_clip.calibrate_image_scales(jimpl.params, jimpl.cfg,
                                                 ref.batching.pad_batch(images, 8)[0])
        want = np.asarray(ref_clip.embed_images_raw_scaled_jit(jimpl.params, jimpl.cfg, images,
                                                               scales))
    else:
        want = np.asarray(ref_clip.embed_images_raw_jit(jimpl.params, jimpl.cfg, images))
    fresh = carry(jimpl, impls.TaggerImpl("test-tiny", precision=precision, device="cpu"))
    got = fresh.raw_features(images).numpy()
    cos = np.sum(got * want, -1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert got.shape == want.shape == (6, jimpl.cfg.embed_dim) and cos.min() >= 0.999, cos.min()
    if precision == "bf16":
        # embed_images_raw is the trunk's unnormalized output.
        normed = clip.embed_images(fresh.params, fresh.cfg, torch.from_numpy(images)).numpy()
        np.testing.assert_allclose(got / np.linalg.norm(got, axis=-1, keepdims=True), normed,
                                   atol=1e-6)


def test_the_reference_fault_shape_returns_every_row(pair):
    # ROADMAP §C: the JAX impl pads a call as one batch and raises past the
    # top bucket; the port embeds slices of at most the top bucket, each
    # padded to its bucket, the first calibrating under int8.
    precision, _, _ = pair
    files = pngs(5, seed=2)
    jimpl = ref.TaggerImpl("test-tiny", precision=precision, batch_cap=4)
    jimpl.load()
    with pytest.raises(ValueError, match="exceeds bucket 4"):
        jimpl.predict([RefInput(file=f) for f in files])
    timpl = carry(jimpl, impls.TaggerImpl("test-tiny", precision=precision, batch_cap=4,
                                          device="cpu"))
    got = timpl.predict([PredictionInput(file=f, data=ALL_TAGS) for f in files])
    want = [*jimpl.predict([RefInput(file=f, data=ALL_TAGS) for f in files[:4]]),
            *jimpl.predict([RefInput(file=f, data=ALL_TAGS) for f in files[4:]])]
    assert len(got) == 5 and prob_diff(got, want) <= PROB_ATOL[precision]
    if precision == "int8":
        np.testing.assert_allclose(timpl._act_scales.numpy(), np.asarray(jimpl._act_scales),
                                   rtol=2e-2)
    # One call of five is a call of four and a call of one: the same trunk
    # features bit for bit; the head's f32 product rounds by its row count.
    images = np.stack([ref.decode_image(f, 32) for f in files])
    np.testing.assert_array_equal(timpl.raw_features(images),
                                  torch.cat([timpl.raw_features(images[:4]),
                                             timpl.raw_features(images[4:])]))
    np.testing.assert_allclose(timpl.probabilities(images),
                               np.concatenate([timpl.probabilities(images[:4]),
                                               timpl.probabilities(images[4:])]), rtol=0, atol=1e-6)


def test_character_category_uses_fixed_threshold():
    # tests/test_models.py::TestTaggerCategories on the port.
    impl = impls.TaggerImpl(model_arch="test-tiny", tag_vocab=[f"g{i}" for i in range(8)],
                            character_tags=["alice", "bob"], character_threshold=0.0,
                            device="cpu")
    png = pngs(1, seed=3)[0]
    cats = dict(impl.predict([PredictionInput(file=png)])[0]["tags"])
    assert set(cats["character"]) == {"alice", "bob"}
    assert all(0.0 <= v <= 1.0 for v in cats["character"].values())
    out = impl.predict([PredictionInput(file=png, data={"character_threshold": 1.1})])
    assert dict(out[0]["tags"])["character"] == {}
    assert impl.head.shape == (impl.cfg.embed_dim, 5 + 8 + 2)


def test_inputs_without_an_image_and_undecodable_ones_get_error_slots():
    impl = impls.TaggerImpl("test-tiny", device="cpu")
    out = impl.predict([PredictionInput(data={"pixels": np.zeros((32, 32, 3))}),
                        PredictionInput(file=b"not an image"), PredictionInput(file=pngs(1)[0])])
    assert out[0]["__error__"] == {"class": "input", "message": "Tagger requires an image file"}
    assert out[1]["__error__"]["class"] == "input" and out[2]["namespace"] == "danbooru"


def test_prepare_keeps_no_calibration_and_load_is_seeded():
    a = impls.TaggerImpl("test-tiny", precision="int8", batch_cap=4, device="cpu")
    a.prepare()
    assert a._act_scales is None and a.params["visual"]["blocks"][0]["attn"]["qkv_w"]["q"].dtype \
        == torch.int8
    b = impls.TaggerImpl("test-tiny", precision="int8", batch_cap=4, device="cpu")
    b.load()
    assert torch.equal(a.head, b.head) and a.head.shape == (32, 69)
    a.unload()
    assert a.params is None and a.head is None


def _timm_tree(seed=11):
    """A test-tiny trunk with a patch bias, non-trivial LayerNorms and a head
    of 5 + 12 tags, in the reference's tree layout (NumPy)."""
    cfg = ref_clip.CONFIGS["test-tiny"]
    visual = jax.tree.map(np.asarray, ref_clip.init_params(jax.random.key(seed), cfg)["visual"])
    rng = np.random.default_rng(seed)
    width = cfg.vision_width
    visual["patch_b"] = rng.normal(size=width).astype(np.float32) * 0.1
    visual["ln_pre"] = {"scale": np.ones(width, np.float32), "bias": np.zeros(width, np.float32)}
    visual["ln_post"] = {"scale": 1 + 0.1 * rng.normal(size=width).astype(np.float32),
                         "bias": 0.1 * rng.normal(size=width).astype(np.float32)}
    visual["proj"] = np.eye(width, dtype=np.float32)
    head_w = rng.normal(size=(width, 17)).astype(np.float32) * width**-0.5
    head_b = rng.normal(size=17).astype(np.float32) * 0.1
    return cfg, visual, head_w, head_b


def same_trees(a, b):
    """Nested dicts, lists and tuples of arrays equal leaf for leaf."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            same_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same_trees(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_timm_checkpoint_round_trips_through_both_packages(tmp_path):
    # Each package's exporter read by the other's loader: equal trees, and
    # the two impls on the checkpoint give equal probabilities.
    cfg, visual, head_w, head_b = _timm_tree()
    tcfg = clip.CONFIGS["test-tiny"]
    ref_weights.save_timm_vit_checkpoint(visual, head_w, head_b, cfg, tmp_path / "ref.safetensors")
    weights.save_timm_vit_checkpoint(visual, head_w, head_b, tcfg, tmp_path / "port.bin")
    for got in (weights.load_timm_vit_checkpoint(tmp_path / "ref.safetensors", tcfg),
                ref_weights.load_timm_vit_checkpoint(tmp_path / "port.bin", cfg)):
        same_trees(got, (visual, head_w, head_b))
    files = pngs(4, seed=4)
    jimpl = ref.TaggerImpl("test-tiny", checkpoint=str(tmp_path / "port.bin"))
    timpl = impls.TaggerImpl("test-tiny", checkpoint=str(tmp_path / "ref.safetensors"),
                             device="cpu")
    want = jimpl.predict([RefInput(file=f, data=ALL_TAGS) for f in files])
    got = timpl.predict([PredictionInput(file=f, data=ALL_TAGS) for f in files])
    # The head's 17 outputs override the 64 synthetic tags: 5 ratings, 12 general.
    assert timpl.tag_vocab == jimpl.tag_vocab == [f"tag_{i}" for i in range(12)]
    assert timpl.cfg.embed_dim == timpl.cfg.vision_width
    assert torch.equal(timpl.params["visual"]["patch_b"], torch.from_numpy(visual["patch_b"]))
    assert prob_diff(got, want) <= PROB_ATOL["bf16"]
