"""The port's HTTP server against its own executor, on the CPU and on the
card: tools/e2e_server_bench.py's five payloads (``chip_smoke.serve_payloads``)
served by the port's transport give the pages ``Executor.execute`` gives in
process.

The card case needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The file imports no JAX and nothing of the JAX package; run it on the card
without the repo's conftest, which imports JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_api_cuda.py
"""

import asyncio
import threading

import pytest
import torch

import chip_smoke
from panoptikon_tpu_torch.api import web
from panoptikon_tpu_torch.api.server import AppState, build_app
from panoptikon_tpu_torch.client import PanoptikonClient
from panoptikon_tpu_torch.db.connection import Database
from panoptikon_tpu_torch.db.writer import IndexWriter
from panoptikon_tpu_torch.pql import model as pql

ROWS = 4000


@pytest.mark.parametrize("name", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_served_pages_equal_execute(name, tmp_path):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's path has no CPU stand-in")
    root = tmp_path / "data"
    db = Database(root / "databases", "default")
    writer = IndexWriter(db)
    writer.call(lambda conn: chip_smoke._bulk_seed(conn, ROWS))
    writer.close()
    state = AppState.create(root, device=name)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    runner = web.AppRunner(build_app(state))

    async def start():
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", 0).start()

    try:
        index = state.index("default")
        for space, dim, seed in chip_smoke.SERVE_SPACES:
            chip_smoke._make_space(index, space, ROWS, dim, seed)
        asyncio.run_coroutine_threadsafe(start(), loop).result(30)
        client = PanoptikonClient(f"http://127.0.0.1:{runner.addresses[0][1]}", timeout=300)
        acc = client.accelerator()
        assert acc["backend"] == ("cuda" if name == "cuda" else "cpu")
        assert acc["device_count"] == (torch.cuda.device_count() if name == "cuda" else 1)
        ex = state.executor("default")
        assert ex.device.type == name
        for kind, make in chip_smoke.serve_payloads(512, 768).items():
            for i in range(3):
                body = make(i)
                served = client.search.pql(body)
                got = ex.execute(pql.PqlQuery.from_json(body))
                assert got.results or kind == "hybrid_fts_rrf", (kind, i)
                assert chip_smoke.same_pages(got, chip_smoke._served_page(served)), (kind, i)
        client.close()
    finally:
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()
        state.shutdown()
