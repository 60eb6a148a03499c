"""Training on the port (ROADMAP A.17) against the JAX package, on the CPU.

The same seeded NumPy inputs go through both packages; the JAX tree is
carried over by ``models.convert``, its leaves f32 in both. On the CPU the
port's B3 (``ops/vit_attention.mha``) takes its plain version forward and,
under grad, :func:`mha_backward_plain` backward, the kernel's arithmetic;
off the TPU the JAX ``attention`` is ``jax.nn.dot_product_attention``,
whose gradient XLA computes. Tolerances, each with its reason:

- B3's gradient: f32 within 2e-5 of the largest gradient element (the order
  of f32 sums); bf16 within 2e-2 of it. Both packages compute in f32 from
  the same bf16 inputs and round once at the end, but autograd of
  ``mha_plain`` and XLA round dP to bf16, and XLA rounds p to bf16 below
  D 32 too, where the port (as the reference's Pallas kernel) keeps it
  f32.
- the losses (value, and each leaf's gradient): the towers run in bf16 in
  both packages, which round at different points, so the values within
  1e-2 relative and each leaf's gradient at cosine ≥ 0.99 with its norm
  within 5 % (the card is held to the CPU by the same cosine in
  ``chip_smoke.py``'s phase 16).
- ``ctc_loss_per_sequence`` against ``optax.ctc_loss`` directly, in f32:
  values within 1e-5 relative and the logits' gradient within 1e-5 of its
  largest element; 1e-2 where a label is infeasible, whose log-probabilities
  sit near ``log_epsilon`` = −1e5, where an f32 ulp is 2^-7, so each
  package's exp of a difference there carries about 1 % of rounding.
- ten Adam steps from the same weights: each step's loss within 2e-2
  relative (the weights drift apart by the bf16 differences above).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from panoptikon_tpu.models import clip as ref_clip
from panoptikon_tpu.models import ocr as ref_ocr
from panoptikon_tpu_torch.models import clip, convert, ocr
from panoptikon_tpu_torch.ops import vit_attention

COS_FLOOR = 0.99
NORM_RTOL = 0.05
LOSS_RTOL = 1e-2
ADAM_STEPS, ADAM_LR, ADAM_RTOL = 10, 1e-4, 2e-2
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ATTN_CASES = {
    # name: (b, n_q, n_kv, h, d, causal, masked)
    "self": (2, 33, 33, 4, 64, False, False),
    "causal": (2, 17, 17, 2, 64, True, False),
    "cross": (2, 12, 40, 4, 32, False, False),
    "key_masked": (3, 21, 21, 4, 32, False, True),
    "head_dim_16": (2, 30, 30, 2, 16, False, False),
    "head_dim_384": (2, 19, 19, 2, 384, True, False),
}


# ---------------------------------------------------------------------------
# B3's gradient
# ---------------------------------------------------------------------------


def attention_inputs(case, seed=0):
    b, nq, nkv, h, d, causal, masked = ATTN_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for n in (nq, nkv, nkv))
    dout = rng.normal(size=(b, nq, h, d)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((b, nkv)) < 0.7
        mask[:, 0] = True
        mask[-1] = False  # a fully masked row: uniform p, never NaN
    return q, k, v, dout, causal, mask


def close_to_largest(got, want, tol):
    """Each array within ``tol`` × its reference's largest |element|."""
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape and np.isfinite(g).all()
        assert np.abs(g - w).max() <= tol * np.abs(w).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_mha_backward_plain_matches_autograd_and_jax(case, dtype):
    q, k, v, dout, causal, mask = attention_inputs(case)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    tdout = torch.from_numpy(dout).to(tdt)
    out = vit_attention.mha_plain(tq, tk, tv, causal=causal, key_mask=tmask)
    autograd = torch.autograd.grad(out, (tq, tk, tv), tdout)
    got = vit_attention.mha_backward_plain(tq.detach(), tk.detach(), tv.detach(), out.detach(),
                                           tdout, causal=causal, key_mask=tmask)
    assert all(g.dtype == tdt for g in got)
    got = [g.to(torch.float32).numpy() for g in got]
    close_to_largest(got, [g.to(torch.float32).numpy() for g in autograd], ATTN_TOL[dtype])

    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    bias = None if mask is None else jnp.where(jnp.asarray(mask), 0.0, -1e9)[:, None, None, :]

    def attend(q, k, v):
        if bias is None:
            return jax.nn.dot_product_attention(q, k, v, is_causal=causal)
        return jax.nn.dot_product_attention(q, k, v, bias=bias.astype(q.dtype))

    jq, jk, jv, jd = (jnp.asarray(a.astype(np_dt)) for a in (q, k, v, dout))
    _, vjp = jax.vjp(attend, jq, jk, jv)
    close_to_largest(got, vjp(jd), ATTN_TOL[dtype])


# ---------------------------------------------------------------------------
# Losses against the JAX package
# ---------------------------------------------------------------------------


def cosine(a, b):
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 and nb == 0:
        return 1.0
    return float(np.dot(a.ravel(), b.ravel()) / (na * nb))


def check_value_and_grads(port_loss, port_tree, ref_value, ref_grads):
    """The port's loss and each leaf's gradient against the JAX package's."""
    assert np.isfinite(port_loss.item())
    assert abs(port_loss.item() - float(ref_value)) <= LOSS_RTOL * abs(float(ref_value))
    port_loss.backward()
    got = convert.grads_numpy(port_tree)
    want = convert.named_leaves(jax.tree.map(np.asarray, ref_grads))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and np.isfinite(g).all(), path
        assert cosine(g, w) >= COS_FLOOR, (path, cosine(g, w))
        nw = np.linalg.norm(w)
        assert abs(np.linalg.norm(g) - nw) <= NORM_RTOL * nw, path


def port_params(jparams):
    tree = convert.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    convert.trainable(tree)
    return tree


def clip_batch(cfg, b, seed):
    """Seeded images and token rows (EOT, the largest id, at each row's end)."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(b, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    tokens = np.zeros((b, cfg.text_ctx), np.int32)
    for i, n in enumerate(rng.integers(2, cfg.text_ctx, size=b)):
        tokens[i, :n] = rng.integers(1, cfg.text_vocab - 1, size=n)
        tokens[i, n] = cfg.text_vocab - 1
    return images, tokens


@pytest.fixture(scope="module")
def clip_reference():
    """The JAX package's clip_loss value and gradients at test-tiny, and its
    losses over ten optax.adam steps, from one seeded tree."""
    rcfg = ref_clip.CONFIGS["test-tiny"]
    params = ref_clip.init_params(jax.random.key(0), rcfg)
    images, tokens = clip_batch(rcfg, 8, seed=1)
    value_and_grad = jax.jit(jax.value_and_grad(ref_clip.clip_loss), static_argnums=1)
    value, grads = value_and_grad(params, rcfg, images, tokens)
    tx = optax.adam(ADAM_LR)
    state, p, losses = tx.init(params), params, []
    for _ in range(ADAM_STEPS):
        loss, g = value_and_grad(p, rcfg, images, tokens)
        updates, state = tx.update(g, state)
        p = optax.apply_updates(p, updates)
        losses.append(float(loss))
    return params, images, tokens, value, grads, losses


def test_clip_loss_value_and_gradients_match_jax(clip_reference):
    params, images, tokens, value, grads, _ = clip_reference
    cfg = clip.CONFIGS["test-tiny"]
    tree = port_params(params)
    loss = clip.clip_loss(tree, cfg, torch.from_numpy(images), torch.from_numpy(tokens))
    check_value_and_grads(loss, tree, value, grads)


def test_clip_adam_steps_track_optax(clip_reference):
    params, images, tokens, _, _, want = clip_reference
    cfg = clip.CONFIGS["test-tiny"]
    tree = port_params(params)
    leaves = [t for t in convert.named_leaves(tree).values() if t.requires_grad]
    assert all(t.dtype == torch.float32 for t in leaves)  # f32 masters
    opt = torch.optim.Adam(leaves, lr=ADAM_LR)
    got = []
    for _ in range(ADAM_STEPS):
        opt.zero_grad()
        loss = clip.clip_loss(tree, cfg, torch.from_numpy(images), torch.from_numpy(tokens))
        loss.backward()
        opt.step()
        got.append(loss.item())
    assert all(t.dtype == torch.float32 for t in leaves)
    np.testing.assert_allclose(got, want, rtol=ADAM_RTOL)
    assert got[-1] < got[0]


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------


def ctc_case(n_tokens, labels, seed, classes=11):
    """Seeded logits (B, T, classes) and right-padded labels with paddings."""
    rng = np.random.default_rng(seed)
    width = max(len(lab) for lab in labels)
    lab = np.zeros((len(labels), width), np.int32)
    pad = np.ones((len(labels), width), np.float32)
    for i, row in enumerate(labels):
        lab[i, :len(row)] = row
        pad[i, :len(row)] = 0.0
    logits = rng.normal(size=(len(labels), n_tokens, classes)).astype(np.float32)
    return logits, lab, pad


CTC_LABELS = {
    # 1-based digits: "112358" and "777" (repeats need a blank between),
    # a short padded row, and a label longer than the 8 frames (infeasible).
    "padded_and_repeats": [[2, 2, 3, 4, 6, 9], [8, 8, 8], [5]],
    "infeasible": [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [3, 4]],
}
CTC_GRAD_TOL = {"padded_and_repeats": 1e-5, "infeasible": 1e-2}


@pytest.mark.parametrize("case", list(CTC_LABELS))
def test_ctc_loss_per_sequence_is_optax_s(case):
    logits, labels, label_pad = ctc_case(8, CTC_LABELS[case], seed=len(case))
    logit_pad = np.zeros(logits.shape[:2], np.float32)
    logit_pad[0, -1] = 1.0  # a padded frame

    def ref_loss(lg):
        return optax.ctc_loss(lg, logit_pad, labels, label_pad, blank_id=0)

    want = np.asarray(ref_loss(logits))
    want_grad = np.asarray(jax.grad(lambda lg: ref_loss(lg).sum())(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    got = ocr.ctc_loss_per_sequence(tl, torch.from_numpy(logit_pad), torch.from_numpy(labels),
                                    torch.from_numpy(label_pad))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    got.sum().backward()
    close_to_largest([tl.grad.numpy()], [want_grad], CTC_GRAD_TOL[case])
    if case == "infeasible":  # finite where F.ctc_loss gives inf
        assert np.isfinite(got.detach().numpy()).all() and got[0].item() > 1e4


def ocr_batch(cfg, texts, seed):
    """Seeded strips in [0, 1] and 1-based labels padded with 0."""
    rng = np.random.default_rng(seed)
    strips = rng.random((len(texts), cfg.height, cfg.max_width)).astype(np.float32)
    width = max(len(t) for t in texts)
    labels = np.zeros((len(texts), width), np.int32)
    for i, t in enumerate(texts):
        labels[i, :len(t)] = [cfg.charset.index(c) + 1 for c in t]
    lengths = np.array([len(t) for t in texts], np.int32)
    return strips, labels, lengths


# "112358" and "777" from tests/test_ocr.py, a short padded row; and a row
# longer than test-tiny's 32 frames (infeasible for CTC).
OCR_TEXTS = {
    "padded_and_repeats": ["112358", "777", "42", "0123"],
    "infeasible": ["0123456789" * 4, "31415"],
}


@pytest.fixture(scope="module")
def ocr_reference():
    """The JAX package's ctc_loss and attn_loss values and gradients at
    test-tiny, from seeded trees, for every batch of OCR_TEXTS."""
    cfg = ref_ocr.CONFIGS["test-tiny"]
    acfg = ref_ocr.ATTN_CONFIGS["test-tiny"]
    ctc_params = ref_ocr.init_params(jax.random.key(0), cfg)
    attn_params = ref_ocr.init_attn_params(jax.random.key(3), acfg)
    ctc = jax.jit(jax.value_and_grad(
        lambda p, x, y, n: ref_ocr.ctc_loss(p, cfg, x, y, n)))
    attn = jax.jit(jax.value_and_grad(
        lambda p, x, y, n: ref_ocr.attn_loss(p, acfg, x, y, n)))
    out = {}
    for name, texts in OCR_TEXTS.items():
        batch = ocr_batch(cfg, texts, seed=len(name))
        out[("ctc", name)] = (ctc_params, batch, *ctc(ctc_params, *batch))
        if name != "infeasible":  # attn takes at most max_chars - 2 characters
            out[("attn", name)] = (attn_params, batch, *attn(attn_params, *batch))
    return out


@pytest.mark.parametrize("case", list(OCR_TEXTS))
def test_ctc_loss_value_and_gradients_match_jax(ocr_reference, case):
    params, (strips, labels, lengths), value, grads = ocr_reference[("ctc", case)]
    cfg = ocr.CONFIGS["test-tiny"]
    tree = port_params(params)
    loss = ocr.ctc_loss(tree, cfg, torch.from_numpy(strips), torch.from_numpy(labels),
                        torch.from_numpy(lengths))
    check_value_and_grads(loss, tree, value, grads)


def test_attn_loss_value_and_gradients_match_jax(ocr_reference):
    params, (strips, labels, lengths), value, grads = ocr_reference[("attn",
                                                                      "padded_and_repeats")]
    acfg = ocr.ATTN_CONFIGS["test-tiny"]
    assert dataclasses.asdict(acfg) == dataclasses.asdict(ref_ocr.ATTN_CONFIGS["test-tiny"])
    tree = port_params(params)
    loss = ocr.attn_loss(tree, acfg, torch.from_numpy(strips), torch.from_numpy(labels),
                         torch.from_numpy(lengths))
    check_value_and_grads(loss, tree, value, grads)


def test_convert_names_leaves_and_reads_gradients():
    tree = {"a": torch.ones(2), "blocks": [{"w": torch.zeros(3, 2)}], "ids": torch.arange(3)}
    leaves = convert.trainable(tree)
    assert list(convert.named_leaves(tree)) == ["a", "blocks.0.w", "ids"]
    assert [t.requires_grad for t in (tree["a"], tree["blocks"][0]["w"], tree["ids"])] == \
        [True, True, False] and len(leaves) == 2
    (tree["a"].sum() * 3).backward()
    grads = convert.grads_numpy(tree)
    assert set(grads) == {"a", "blocks.0.w"}
    np.testing.assert_array_equal(grads["a"], [3.0, 3.0])
    np.testing.assert_array_equal(grads["blocks.0.w"], np.zeros((3, 2), np.float32))
