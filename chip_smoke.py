"""Drive the PyTorch port's search core once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

1. env      the card (nvidia-smi name and power limit), torch, CUDA, nvcc;
2. build    both kernels compiled from panoptikon_tpu_torch/csrc/;
3. kernels  each kernel against its plain PyTorch version on the card, at
            the shapes the main path gives it (mha bf16 ≤ 2e-2; the int8
            scan with identical ids and distances within 1e-6), and timed;
4. main     the slice at the full width of CLIP ViT-B/32 with seeded random
            bf16 weights: embed 4,096 images, index them with seeded unit
            vectors to 1,048,576 × 512 in a host VectorIndex, build the int8
            arm, upload it (DeviceIndex), embed 64 text queries and search
            them top-10, and search 256 Gaussian unit queries;
5. check    launch counters of the main path, the scan kernel's k·oversample
            candidates at 1,048,576 rows against its plain version for both
            query sets (identical ids, distances within 1e-6), recall@10 of
            the 256 queries against the exact fp32 top-10 (≥ 0.99), the text
            queries' top-10 against the plain path, row validity, and the
            times.

Then a line with every kernel's record, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without CUDA the script exits 1 before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
N_IMAGES, IMAGE_BATCH = 4096, 256
N_ROWS, DIM = 1_048_576, 512
N_TEXT, N_GAUSS, K, OVERSAMPLE = 64, 256, 10, 8
EOT = 49407


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(torch, kernel, plain, reps: int = 20) -> tuple[float, float]:
    """Kernel and plain timed in turns (kernel, plain, plain, kernel)."""
    k1 = cuda_ms(torch, kernel, reps)
    p1 = cuda_ms(torch, plain, reps)
    p2 = cuda_ms(torch, plain, reps)
    k2 = cuda_ms(torch, kernel, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from panoptikon_tpu_torch import _build
    from panoptikon_tpu_torch.device import device
    from panoptikon_tpu_torch.index import VectorIndex
    from panoptikon_tpu_torch.index.device_index import DeviceIndex
    from panoptikon_tpu_torch.models import clip
    from panoptikon_tpu_torch.ops import codec, exact, int8_scan, scoring, vit_attention

    dev = device("cuda")

    # 1. Environment.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    emit({"phase": "env", "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc, "device_name": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count()})

    # 2. Build.
    build = {}
    for name in ("int8_scan", "attention"):
        t0 = time.perf_counter()
        _build.build(name)
        build[name] = {
            "seconds": time.perf_counter() - t0,
            "ptxas": [ln.strip() for ln in _build.ptxas_report(name).splitlines()
                      if "registers" in ln or "spill" in ln],
        }
    emit({"phase": "build", **build})

    # 3. Kernels against their plain versions.
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    attn_cases = {
        # name: (b, n_q, n_kv, h, d, causal, masked)
        "vit_b32_image": (256, 50, 50, 12, 64, False, False),
        "clip_text_causal": (64, 77, 77, 8, 64, True, False),
        "key_masked": (64, 77, 77, 8, 64, False, True),
        "cross": (8, 64, 300, 8, 64, False, False),
        "long_1500": (2, 1500, 1500, 8, 64, False, False),
    }
    attn_err = {}
    attn_inputs = {}
    for name, (b, nq, nkv, h, d, causal, masked) in attn_cases.items():
        q, k, v = randn(b, nq, h, d), randn(b, nkv, h, d), randn(b, nkv, h, d)
        mask = None
        if masked:
            mask = torch.rand((b, nkv), generator=gen, device=dev) < 0.7
            mask[0] = False  # a fully masked row
        got = vit_attention.mha(q, k, v, causal=causal, key_mask=mask)
        want = vit_attention.mha_plain(q, k, v, causal=causal, key_mask=mask)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        require(torch.isfinite(got.float()).all().item(), f"mha {name}: non-finite output")
        require(err <= 2e-2, f"mha {name}: max abs diff {err} > 2e-2")
        attn_err[name] = err
        attn_inputs[name] = (q, k, v, causal, mask)

    n_scan, q_scan, k_scan = 65_536, 64, OVERSAMPLE * K
    x = torch.randn((n_scan, DIM), generator=gen, device=dev)
    x[[777, 20_000, 60_000]] = x[5].clone()  # planted equal rows, in different tiles
    x = x / torch.linalg.norm(x, dim=1, keepdim=True)
    qv = torch.randn((q_scan, DIM), generator=gen, device=dev)
    qv[0] = x[5]
    qv = qv / torch.linalg.norm(qv, dim=1, keepdim=True)
    scale = codec.scale_from_absmax(x.abs().max().item())
    s_codes, s_q = codec.quantize_int8(x, scale), codec.quantize_int8(qv, scale)
    s_sumsq = scoring.row_sumsq(s_codes)
    s_valid = torch.rand(n_scan, generator=gen, device=dev) > 0.05
    s_valid[[5, 777, 20_000, 60_000]] = True
    scan_args = (s_codes, s_sumsq, s_valid, s_q)
    gv, gi, gok = int8_scan.int8_topk(*scan_args, k=k_scan)
    pv, pi, pok = int8_scan.int8_topk_plain(*scan_args, k=k_scan)
    torch.cuda.synchronize()
    scan_err = (gv - pv).abs().max().item()
    require(torch.equal(gi, pi) and torch.equal(gok, pok), "int8_topk: ids differ from plain")
    require(scan_err <= 1e-6, f"int8_topk: max abs dist diff {scan_err} > 1e-6")
    require(gi[0, :4].tolist() == [5, 777, 20_000, 60_000], "int8_topk: planted tie order")
    require(bool(s_valid[gi].all().item()), "int8_topk: an invalid row was returned")

    q, k, v, causal, mask = attn_inputs["vit_b32_image"]
    mha_ms, mha_plain_ms = paired_ms(
        torch, lambda: vit_attention.mha(q, k, v), lambda: vit_attention.mha_plain(q, k, v))
    qt, kt, vt, _, _ = attn_inputs["clip_text_causal"]
    text_mha_ms, text_mha_plain_ms = paired_ms(
        torch, lambda: vit_attention.mha(qt, kt, vt, causal=True),
        lambda: vit_attention.mha_plain(qt, kt, vt, causal=True))
    scan_ms, scan_plain_ms = paired_ms(
        torch, lambda: int8_scan.int8_topk(*scan_args, k=k_scan),
        lambda: int8_scan.int8_topk_plain(*scan_args, k=k_scan), reps=10)
    emit({"phase": "kernels", "card": smi, "mha_max_abs_err": attn_err,
          "int8_topk_max_abs_err": scan_err,
          "mha_vit_b32_image_ms": mha_ms, "mha_vit_b32_image_plain_ms": mha_plain_ms,
          "mha_clip_text_ms": text_mha_ms, "mha_clip_text_plain_ms": text_mha_plain_ms,
          "int8_topk_65536x512_q64_k80_ms": scan_ms,
          "int8_topk_65536x512_q64_k80_plain_ms": scan_plain_ms})
    del x, qv, scan_args, s_codes, attn_inputs, q, k, v, qt, kt, vt

    # 4. The main path, ViT-B/32 at full width. Counters start at zero here.
    cfg = clip.CONFIGS["ViT-B-32"]
    params = clip.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dtype=torch.bfloat16)
    int8_scan.int8_topk.launches = 0
    vit_attention.mha.launches = 0

    img_gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    embeds = []
    torch.cuda.synchronize()
    t_embed = 0.0
    for i in range(N_IMAGES // IMAGE_BATCH):
        images = torch.randn((IMAGE_BATCH, cfg.image_size, cfg.image_size, 3),
                             generator=img_gen, device=dev, dtype=torch.bfloat16)
        t0 = time.perf_counter()
        out = clip.embed_images(params, cfg, images)
        torch.cuda.synchronize()
        if i:  # the first batch pays for loading and warming up
            t_embed += time.perf_counter() - t0
        embeds.append(out)
    img_emb = torch.cat(embeds)
    require(tuple(img_emb.shape) == (N_IMAGES, cfg.embed_dim), "image embeddings shape")
    require(bool(torch.isfinite(img_emb).all().item()), "image embeddings finite")
    require(bool(((torch.linalg.norm(img_emb, dim=1) - 1).abs() < 1e-3).all().item()),
            "image embeddings unit norm")
    img_per_s = (N_IMAGES - IMAGE_BATCH) / t_embed

    t0 = time.perf_counter()
    index = VectorIndex()
    index.reserve("clip", N_ROWS, DIM)
    index.add("clip", np.arange(N_IMAGES), np.arange(N_IMAGES), img_emb.cpu().numpy())
    fill_gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    step = 131_072
    for lo in range(N_IMAGES, N_ROWS, step):
        hi = min(lo + step, N_ROWS)
        rows = torch.randn((hi - lo, DIM), generator=fill_gen, device=dev)
        rows = rows / torch.linalg.norm(rows, dim=1, keepdim=True)
        index.add("clip", np.arange(lo, hi), np.arange(lo, hi), rows.cpu().numpy())
    scale = index.build_quant("clip")
    host_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dindex = DeviceIndex(index, "clip", dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    require(dindex.size == N_ROWS, "index rows")

    rng = np.random.default_rng(SEED)
    ids = rng.integers(1, EOT, size=(N_TEXT, cfg.text_ctx))
    for r, e in enumerate(rng.integers(1, cfg.text_ctx, size=N_TEXT)):
        ids[r, e] = EOT
        ids[r, e + 1:] = 0
    token_ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
    txt_emb = clip.embed_texts(params, cfg, token_ids)
    require(bool(torch.isfinite(txt_emb).all().item()), "text embeddings finite")
    tv, ti, tok = dindex.search(txt_emb, K, oversample=OVERSAMPLE)

    gq = torch.randn((N_GAUSS, DIM), generator=torch.Generator(device=dev).manual_seed(SEED + 3),
                     device=dev)
    gq = gq / torch.linalg.norm(gq, dim=1, keepdim=True)
    sv, si, sok = dindex.search(gq, K, oversample=OVERSAMPLE)
    torch.cuda.synchronize()
    launches = {"int8_topk": int8_scan.int8_topk.launches, "mha": vit_attention.mha.launches}

    # 5. Checks and times.
    require(launches["int8_topk"] > 0 and launches["mha"] > 0, f"kernel launches {launches}")
    for name, (rows, ok) in {"text": (ti, tok), "gaussian": (si, sok)}.items():
        require(bool(ok.all().item()), f"{name}: every top-{K} entry valid")
        require(bool(((rows >= 0) & (rows < dindex.size)).all().item()), f"{name}: rows in range")
        require(bool(dindex.row_valid[rows].all().item()), f"{name}: rows are valid rows")
    require(len(dindex.item_ids(ti, tok)) == N_TEXT, "item ids of text results")

    # The scan kernel against its plain version at the main path's shapes:
    # all k·oversample candidates, for both query sets.
    plain_cand = {}
    scan_1m_err = 0.0
    for name, q_f32 in {"text": txt_emb, "gaussian": gq}.items():
        args = (dindex.codes, dindex.sumsq, dindex.row_valid, codec.quantize_int8(q_f32, scale))
        gv, gi, gok = int8_scan.int8_topk(*args, k=K * OVERSAMPLE)
        pv, pi, pok = int8_scan.int8_topk_plain(*args, k=K * OVERSAMPLE)
        torch.cuda.synchronize()
        err = (gv - pv).abs().max().item()
        require(torch.equal(gi, pi) and torch.equal(gok, pok),
                f"int8_topk at {N_ROWS} rows ({name}): ids differ from plain")
        require(err <= 1e-6, f"int8_topk at {N_ROWS} rows ({name}): max abs dist diff {err} > 1e-6")
        plain_cand[name] = (pv, pi)
        scan_1m_err = max(scan_1m_err, err)

    cv, ci = plain_cand["text"]
    pv, pi, _ = scoring.rescore_candidates(cv, ci, dindex.vectors, txt_emb, k=K)
    text_agree = exact.topk_agree(tv.cpu().numpy(), ti.cpu().numpy(), pv.cpu().numpy(),
                                  pi.cpu().numpy(), atol=1e-6)
    require(text_agree, "text queries: kernel path top-10 differs from the plain path")

    group_ids = torch.from_numpy(index.snapshot("clip").group_ids).to(dev)
    exact_ids = []
    for lo in range(0, N_GAUSS, 64):
        _, ei, _ = exact.exact_search(dindex.vectors, dindex.row_valid, group_ids, gq[lo:lo + 64],
                                      num_groups=N_ROWS, k=K)
        exact_ids.append(ei)
    exact_ids = torch.cat(exact_ids).cpu().numpy()
    got_ids = si.cpu().numpy()
    recall = float(np.mean([len(set(exact_ids[i]) & set(got_ids[i])) / K for i in range(N_GAUSS)]))
    require(recall >= 0.99, f"recall@10 {recall} < 0.99")

    text_ms = cuda_ms(torch, lambda: clip.embed_texts(params, cfg, token_ids), reps=10)
    search_ms = cuda_ms(torch, lambda: dindex.search(gq, K, oversample=OVERSAMPLE), reps=10)
    codes_1m = (dindex.codes, dindex.sumsq, dindex.row_valid, codec.quantize_int8(gq, scale))
    scan_1m_ms, scan_1m_plain_ms = paired_ms(
        torch, lambda: int8_scan.int8_topk(*codes_1m, k=K * OVERSAMPLE),
        lambda: int8_scan.int8_topk_plain(*codes_1m, k=K * OVERSAMPLE), reps=5)
    emit({"phase": "main", "card": smi, "config": "ViT-B-32 bf16, seeded random weights",
          "images": N_IMAGES, "rows": N_ROWS, "dim": DIM, "launches": launches,
          "recall_at_10": recall, "text_top10_equals_plain": text_agree,
          "int8_topk_1m_max_abs_err": scan_1m_err,
          "image_embed_img_per_s": img_per_s, "text_embed_ms_per_batch_of_64": text_ms,
          "search_qps_q256_k10": N_GAUSS / (search_ms / 1e3), "search_ms_q256": search_ms,
          "int8_topk_1m_q256_k80_ms": scan_1m_ms, "int8_topk_1m_q256_k80_plain_ms": scan_1m_plain_ms,
          "host_index_build_s": host_build_s, "upload_s": upload_s})

    emit({"kernels": [
        {"name": "int8_topk", "route": "cuda", "source": "panoptikon_tpu_torch/csrc/int8_scan.cu",
         "replaces": "panoptikon_tpu/ops/pallas_scan.py:138", "launches": launches["int8_topk"],
         "max_abs_err": max(scan_err, scan_1m_err), "ms": scan_ms, "plain_ms": scan_plain_ms},
        {"name": "mha", "route": "cuda", "source": "panoptikon_tpu_torch/csrc/attention.cu",
         "replaces": "panoptikon_tpu/ops/vit_attention.py:192", "launches": launches["mha"],
         "max_abs_err": max(attn_err.values()), "ms": mha_ms, "plain_ms": mha_plain_ms},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
