"""Two processes joined over gloo (``parallel.multihost.initialize``), each
with 4 logical CPU shards: the sharded index in both multi-process layouts
(``hosts_replica_mesh``, ``hosts_shard_mesh``) against an exact NumPy oracle
and the port's one-process result — the port's counterpart of
``tools/multihost_sim.py``.

Run as a test, it spawns both processes (``--proc``) and requires both to
exit 0 within 120 s."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
N_PROC, LOCAL_SHARDS = 2, 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(rank: int, coord: str, layout: str) -> dict:
    import torch
    import torch.distributed as dist

    from panoptikon_tpu_torch.index import sharded
    from panoptikon_tpu_torch.index.vector_index import VectorIndex
    from panoptikon_tpu_torch.ops import codec, int8_scan, scoring
    from panoptikon_tpu_torch.parallel import mesh as meshlib
    from panoptikon_tpu_torch.parallel import multihost

    assert multihost.initialize(coordinator=coord, num_processes=N_PROC, process_id=rank)
    assert multihost.process_count() == N_PROC and multihost.process_index() == rank
    meshlib.set_devices([torch.device("cpu")] * LOCAL_SHARDS)
    meshlib.set_multihost_layout(layout)
    mesh = meshlib.index_mesh()
    want_shape = ({"replica": N_PROC, "shard": LOCAL_SHARDS} if layout == "replica"
                  else {"shard": N_PROC * LOCAL_SHARDS})
    assert mesh.shape == want_shape, mesh.shape

    # The same corpus in every process (the multi-controller contract).
    rng = np.random.default_rng(7)
    n, d, q_n, k = 198, 32, 6, 5
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    queries = rng.standard_normal((q_n, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    checks = {}
    for rows_per_item in (1, 3):
        idx = VectorIndex(chunk_rows=8)
        idx.add("clip", np.arange(n) // rows_per_item + 1000, np.arange(n), vectors)
        idx.build_quant("clip")
        snap = idx.snapshot("clip")
        for arm in ("f32", "int8"):
            use_quant = arm == "int8"
            q = codec.compute_query_quant(queries, snap.scale) if use_quant else queries
            space = sharded.build_sharded(snap, mesh, use_quant=use_quant, chunk_rows=8)
            top_v, top_i, valid, grouped = sharded.sharded_search(space, q, k=k)
            assert tuple(top_v.shape) == (q_n, k) and bool(valid.all())
            slots = space.item_ids[top_i.numpy()]
            # The port's one-process result: ids exact, distances within 1e-6.
            corpus = torch.from_numpy(snap.codes if use_quant else snap.vectors)
            sumsq = scoring.row_sumsq_chunked(corpus)
            rv = torch.from_numpy(snap.row_valid)
            qt = torch.from_numpy(np.ascontiguousarray(q))
            scale = float(snap.scale) if use_quant else 1.0
            if grouped:
                one_v, one_slots, _ = scoring.streaming_grouped_topk(
                    corpus, sumsq, rv, torch.from_numpy(snap.group_ids), qt,
                    num_groups=snap.num_groups, k=k, scale=scale, chunk_rows=8)
                one_slots = one_slots.numpy()
            else:
                scan = int8_scan.int8_topk_plain if use_quant else scoring.streaming_topk
                kw = {"scale": scale} if use_quant else {"chunk_rows": 8}
                one_v, rows, _ = scan(corpus, sumsq, rv, qt, k=k, **kw)
                one_slots = snap.group_ids[rows.numpy()]
            assert np.array_equal(slots, one_slots), (arm, rows_per_item, slots, one_slots)
            assert np.allclose(top_v.numpy(), one_v.numpy(), atol=1e-6, rtol=0)
            # The exact NumPy oracle (f32): item membership and distances.
            dist_all = 1.0 - queries @ vectors.T
            per_item = dist_all.reshape(q_n, -1, rows_per_item).min(axis=2)
            want = np.argsort(per_item, axis=1, kind="stable")[:, :k]
            if use_quant:
                overlap = np.mean([len(set(a) & set(b)) / k for a, b in zip(slots, want)])
                assert overlap >= 0.8, overlap
            else:
                assert np.array_equal(np.sort(slots, axis=1), np.sort(want, axis=1))
                np.testing.assert_allclose(top_v.numpy(), np.take_along_axis(per_item, want, 1),
                                           rtol=2e-5, atol=2e-5)
            checks[f"{arm}_rows_per_item_{rows_per_item}"] = "ok"
        if rows_per_item == 3:
            dd, vv, _ = sharded.sharded_grouped_scores(space, q, aggregation="avg")
            assert tuple(dd.shape) == (q_n, space.num_shards * space.groups_per_shard)
            got = np.full((q_n, snap.num_groups), np.inf, np.float32)
            sel = space.item_ids >= 0
            got[:, space.item_ids[sel]] = dd.numpy()[:, sel]
            one, _, _ = scoring.grouped_scores(
                corpus, sumsq, rv, torch.from_numpy(snap.group_ids), qt,
                num_groups=snap.num_groups, aggregation="avg", scale=scale, chunk_rows=8)
            np.testing.assert_allclose(got, one.numpy(), atol=1e-6, rtol=0)
            checks["grouped_scores_avg"] = "ok"
    dist.destroy_process_group()
    return {"rank": rank, "layout": layout, "mesh": mesh.shape, **checks}


def launch(layout: str, timeout: float = 120.0) -> list:
    coord = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("MASTER_ADDR", None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--proc", str(i), "--coord", coord, "--layout", layout],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for i in range(N_PROC)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


@pytest.mark.parametrize("layout", ["replica", "shard"])
def test_two_processes_equal_the_oracle(layout):
    results = launch(layout)
    for rc, out in results:
        assert rc == 0, out[-4000:]
    for rank, (_, out) in enumerate(results):
        got = json.loads(out.strip().splitlines()[-1])
        assert got["rank"] == rank and got["layout"] == layout
        assert {k for k, v in got.items() if v == "ok"} == {
            "f32_rows_per_item_1", "int8_rows_per_item_1", "f32_rows_per_item_3",
            "int8_rows_per_item_3", "grouped_scores_avg"}


if __name__ == "__main__":
    args = sys.argv
    print(json.dumps(worker(int(args[args.index("--proc") + 1]), args[args.index("--coord") + 1],
                            args[args.index("--layout") + 1])), flush=True)
