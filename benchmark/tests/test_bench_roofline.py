"""The yardstick's counts against hand counts at small shapes, and the metric
readers on a made-up trace."""

import json
from types import SimpleNamespace

import pytest

from benchmark import roofline
from benchmark.spec import ROOT, Spec
from benchmark.trace import DeviceOp, Slice

SPEC = Spec.load()


def test_scan_roofline_by_hand():
    # Q 2, N 4, D 8, k 3: 2·2·4·8 = 128 operations; codes 32 + sumsq 16 +
    # validity 4 + query codes 16 bytes read, 2·3·(4 + 8 + 1) = 78 written.
    got = roofline.scan_roofline(2, 4, 8, 3)
    want_ops, want_bytes = 128 / 1979e12, 146 / 3.35e12
    assert got["bound_s"] == pytest.approx(max(want_ops, want_bytes))
    assert got["bound_by"] == "bytes"


def test_scan_roofline_turns_to_operations_at_large_q():
    got = roofline.scan_roofline(4096, 1 << 20, 512, 80)
    assert got["bound_by"] == "operations"
    assert got["bound_s"] == pytest.approx(2 * 4096 * (1 << 20) * 512 / 1979e12)


def test_attention_roofline_by_hand():
    # B 1, N 2, H 1, D 4: QKᵀ and PV 4·2·2·4 = 64; causal keeps (2+1)/(2·2).
    assert roofline.attention_roofline(1, 2, 2, 1, 4)["bound_s"] == pytest.approx(
        max(64 / 989e12, (2 * 4 * 6 + 2 * 2 * 4) / 3.35e12))
    causal = roofline.attention_roofline(1, 2, 2, 1, 4, causal=True, out_bytes=1)
    assert causal["bound_s"] == pytest.approx(max(48 / 989e12, (2 * 4 * 6 + 8) / 3.35e12))


def test_vit_image_ops_by_hand():
    config = json.loads((ROOT / "benchmark/configs/clip-vit-l14-int8.json").read_text())
    w, n, patches, layers = 1024, 257, 256, 24
    per_block = 0
    for fan_in, fan_out in ((w, 3 * w), (w, w), (w, 4 * w), (4 * w, w)):
        per_block += 2 * n * fan_in * fan_out
    per_block += 2 * n * n * w * 2  # QKᵀ and PV
    want = 2 * patches * (14 * 14 * 3) * w + layers * per_block + 2 * w * 768
    assert roofline.vit_image_ops(config) == want
    assert 161e9 < want < 163e9


def test_union_counts_overlaps_once():
    assert roofline.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert roofline.union_seconds([]) == 0


def _reading(cell_name, ops, steps=2, wall=1.0, spans=None):
    cell = SPEC.cell(cell_name)
    s = Slice(steps=steps, wall_s=wall, ops=ops,
              busy_s=roofline.union_seconds((o.start_s, o.start_s + o.seconds) for o in ops))
    return SimpleNamespace(cell=cell, config=cell.config, traffic=cell.traffic, slice=s,
                           steps=steps, window_s=wall, spans=spans or {},
                           work={"queries": 256 * steps, "images": 256 * steps})


def _read(name, r):
    return SPEC.reader({"name": name}).read(r)


def test_search_readers_on_a_made_up_trace():
    ops = [DeviceOp("void (anonymous namespace)::int8_topk_kernel<false, false, 2, 2, 4>(x)", 0.0,
                    0.002),
           DeviceOp("void (anonymous namespace)::int8_topk_kernel<false, false, 2, 2, 4>(x)", 0.5,
                    0.002),
           DeviceOp("void at::native::vectorized_gather_kernel<16, long>(x)", 0.1, 0.0004),
           DeviceOp("Memcpy DtoH (Device -> Pageable)", 0.2, 0.001)]
    r = _reading("b32-similar-q256", ops, spans={"item_ids": 0.08})
    bound = roofline.scan_roofline(256, 1 << 20, 512, 80)["bound_s"]
    assert _read("b1_roofline_pct", r) == pytest.approx(100 * bound / 0.002)
    assert _read("b2_roofline_pct", r) is None  # no B2 in the trace: nothing to read
    assert _read("rescore_device_ms", r) == pytest.approx(0.2)
    assert _read("item_ids_ms", r) == pytest.approx(40)
    assert _read("device_idle_pct.search", r) == pytest.approx(100 * (1 - 0.0054))
    assert _read("rescore_device_ms.b2", r) == pytest.approx(0.2)
    assert _read("search_device_ms", r) == pytest.approx(2.7)  # the union 5.4 ms, 2 batches
    assert _read("slice_qps", r) == pytest.approx(512)
    mfu = 100 * (2 * 256 * (1 << 20) * 512 + 4 * 256 * 80 * 512) * 2 / 1979e12
    assert _read("search_mfu_pct.b2", r) == pytest.approx(mfu)
    assert _read("search_mfu_pct", r) == pytest.approx(mfu / 0.0054)
    idle = _reading("b32-similar-q256", [])  # nothing ran on a card: nothing to read
    assert _read("search_device_ms", idle) is None and _read("search_mfu_pct", idle) is None


def test_build_readers_on_a_made_up_trace():
    ops = [DeviceOp("void cutlass::Kernel2<cutlass_80_tensorop_i16832gemm_s8_128x64_128x3_tn>(x)",
                    0.0, 0.1),
           DeviceOp("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_256x128>(x)",
                    0.1, 0.01),
           DeviceOp("void (anonymous namespace)::mha_tc_kernel<64, 4, signed char>(x)", 0.2, 0.02),
           DeviceOp("void (anonymous namespace)::ln_quant_kernel<__nv_bfloat16, 4>(x)", 0.3, 0.01),
           DeviceOp("void at::native::elementwise_kernel<128, 2, add>(x)", 0.4, 0.3),
           DeviceOp("Memcpy HtoD (Pageable -> Device)", 0.8, 0.05)]
    r = _reading("l14-int8-build-b256", ops, spans={"index_add": 0.002})
    assert _read("int8_gemm_ms", r) == pytest.approx(50)
    assert _read("tower_elementwise_ms", r) == pytest.approx(150)
    assert _read("index_add_ms", r) == pytest.approx(1)
    bound = roofline.attention_roofline(256, 257, 257, 16, 64, out_bytes=1)["bound_s"]
    assert _read("attention_roofline_pct", r) == pytest.approx(100 * bound * 24 * 2 / 0.02)
    config = SPEC.cell("l14-int8-build-b256").config
    assert _read("embed_mfu_pct", r) == pytest.approx(
        100 * roofline.vit_image_ops(config) * 512 / 1979e12)
