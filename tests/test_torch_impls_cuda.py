"""``ClipImpl``'s staged pixel upload on the card: the page-locked staging
buffer, its counter, embeddings bit-equal to a pageable upload of the same
stacked batch, and the event that keeps a second staging from overwriting
pixels still in flight.

These tests need an NVIDIA GPU and skip without one. The file imports no
JAX and nothing of the JAX package; run it on the card without the repo's
conftest, which imports JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_impls_cuda.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from panoptikon_tpu_torch import tracing
from panoptikon_tpu_torch.models import batching, impls
from panoptikon_tpu_torch.models.impls import PredictionInput
from panoptikon_tpu_torch.utils import npy

pytestmark = pytest.mark.cuda

CAP = 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the page-locked staging runs only on the card")
    return torch.device("cuda")


def _pixels(seed, n, size):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((size, size, 3), dtype=np.float32) for _ in range(n)]


def _pageable(impl, images):
    """The embeddings of ``images`` (one slice) through a pageable upload of
    the stacked, padded batch."""
    bucket = batching.bucket_for(len(images), impl.batch_ladder)
    padded = batching.pad_batch(np.stack(images), bucket)[0]
    return impl._embed_images(torch.from_numpy(padded).to(impl.device))[: len(images)]


def test_the_staging_buffer_is_page_locked_and_counted(cuda_device, monkeypatch):
    # Several chunks a slice, the last one short.
    monkeypatch.setattr(impls, "STAGE_CHUNK_BYTES", 5 * 224 * 224 * 3 * 4)
    impl = impls.ClipImpl(model_arch="ViT-B-32", batch_cap=CAP, device=cuda_device)
    impl.load()
    images = _pixels(1, CAP, impl.cfg.image_size)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        impl.predict([PredictionInput(data={"pixels": p}) for p in images])
    counted = tracing.counters()
    tracing.reset()
    assert impl._staging.is_pinned() and impl._staging.device.type == "cpu"
    assert impl._staged is not None and impl._staged.query()
    assert counted["impls.clip_staged_upload_bytes"] == counted["impls.clip_upload_bytes"] \
        == CAP * images[0].nbytes
    impl.unload()
    assert impl._staging is None and impl._staged is None


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_embeddings_are_those_of_a_pageable_upload(cuda_device, precision):
    # Two predict calls made back to back with different pixels, a full
    # slice and a partial one: each call's answers are bit-equal to its
    # pixels stacked and uploaded pageable (int8 calibrates on the first).
    impl = impls.ClipImpl(model_arch="ViT-B-32", precision=precision, batch_cap=CAP,
                          device=cuda_device)
    impl.load()
    size = impl.cfg.image_size
    first, second = _pixels(2, CAP, size), _pixels(3, 5, size)
    got_first = impl.predict([PredictionInput(data={"pixels": p}) for p in first])
    got_second = impl.predict([PredictionInput(data={"pixels": p}) for p in second])
    for got, images in ((got_first, first), (got_second, second)):
        want = _pageable(impl, images)
        np.testing.assert_array_equal(np.stack([npy.parse_npy(g) for g in got]), want)


def test_a_second_staging_waits_for_the_first_upload(cuda_device, monkeypatch):
    # The first slice's chunk copies are queued behind a kernel that spins
    # for about 0.1 s, so they have not run when the second staging starts
    # writing the same buffer: without the event it would overwrite pixels
    # still to be copied, and the first batch would hold the second's.
    monkeypatch.setattr(impls, "STAGE_CHUNK_BYTES", 3 * 224 * 224 * 3 * 4)
    impl = impls.ClipImpl(model_arch="ViT-B-32", batch_cap=CAP, device=cuda_device)
    size = impl.cfg.image_size
    first, second = _pixels(4, CAP, size), _pixels(5, CAP, size)
    impl._stage_images(second, CAP)  # the buffers are allocated before the spin
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    a = impl._stage_images(first, CAP)
    assert not impl._staged.query()
    b = impl._stage_images(second, CAP)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(a.cpu().numpy(), np.stack(first))
    np.testing.assert_array_equal(b.cpu().numpy(), np.stack(second))
