"""The port's PQL executor on the card against itself on the CPU, and the
pinned host copy it reads device results through.

These tests need an NVIDIA GPU and skip without one. The file imports no
JAX and nothing of the JAX package; run it on the card without the repo's
conftest, which imports JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_executor_cuda.py
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from panoptikon_tpu_torch.pql import executor as executor_mod
from panoptikon_tpu_torch.pql import model as pql
from panoptikon_tpu_torch.pql.executor import Executor

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's path has no CPU stand-in")
    return torch.device("cuda")


def test_collect_waits_for_the_pinned_copy(cuda_device):
    # The copy is queued behind a kernel that spins for about 0.1 s, so at
    # _prefetch_host's return its event has not fired and the pinned buffer
    # does not hold the values yet: a read that did not wait would be stale.
    x = torch.arange(1 << 22, dtype=torch.float32, device=cuda_device)
    torch.cuda._sleep(200_000_000)
    y = x * 2 + 1
    tok = executor_mod._prefetch_host((y, y > 100))
    assert tok.event is not None and not tok.event.query()
    assert all(h.is_pinned() for h in tok.host)
    vals, big = executor_mod._collect_host(tok)
    want = np.arange(1 << 22, dtype=np.float32) * 2 + 1
    np.testing.assert_array_equal(vals, want)
    np.testing.assert_array_equal(big, want > 100)
    # CPU tensors need no copy and no event.
    cpu = executor_mod._prefetch_host(torch.ones(3))
    assert cpu.event is None and executor_mod._collect_host(cpu)[0].tolist() == [1.0] * 3


def test_executor_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    db, writer, index = chip_smoke.seed_pql_db(tmp_path, 300, 5)
    try:
        card, cpu = Executor(db, index, device="cuda"), Executor(db, index, device="cpu")
        shapes = chip_smoke.pql_db_shapes(index)
        assert len(shapes) >= 12
        for name, payload in shapes.items():
            got = card.execute(pql.PqlQuery.from_json(json.loads(json.dumps(payload))))
            want = cpu.execute(pql.PqlQuery.from_json(json.loads(json.dumps(payload))))
            assert got.results, name
            assert chip_smoke.same_pages(got, want), name
        dev_arrays = next(iter(card._device_cache.values()))
        assert dev_arrays["corpus"].device.type == "cuda"
    finally:
        writer.close()
