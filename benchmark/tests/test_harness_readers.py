"""Each per-layer reader, on a recorded profiler event list and on module
spans, and silent where it finds nothing to read."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, roofline
from benchmark.tests import cells

CFG = cells.files("speech_serve_bulk")["config"]
ATTN = "void local_attention_fwd_mma_kernel<12>(bf16 const*, float*, int)"
BWD = "void local_attention_bwd_dq_mma_kernel<24>(bf16 const*, int)"


def _trace(**extra):
    # host ops (name, False, start us, end us) and device activity (True)
    events = [
        ("aten::conv2d", False, 0.0, 100.0),
        ("cudaLaunchKernel", False, 10.0, 12.0),
        ("aten::copy_", False, 300.0, 700.0),
        ("cudaMemcpyAsync", False, 350.0, 650.0),
        ("conv_kernel", True, 20.0, 120.0),
        (ATTN, True, 120.0, 220.0),
        (ATTN, True, 200.0, 300.0),      # overlaps the previous one
        ("Memcpy DtoH", True, 660.0, 700.0),
    ]
    trace = harness.reduce_trace(events, wall=700e-6)
    trace.update(spans={}, flops=0, flops_s=0, cfg=CFG, forwards=[],
                 steps=0, batch=16)
    trace.update(extra)
    return trace


def test_reduce_trace():
    t = _trace()
    assert t["busy_s"] == pytest.approx(320e-6)   # 20-300 and 660-700
    assert t["breakdown"]["device_ops"][0] == [ATTN, pytest.approx(200e-6)]
    longest = t["breakdown"]["idle_gaps"][0]
    assert longest == ["cudaMemcpyAsync", pytest.approx(360e-6)]
    # before the first kernel: the launch, inside the convolution's op
    assert t["breakdown"]["idle_gaps"][1] == ["cudaLaunchKernel",
                                             pytest.approx(20e-6)]


def test_idle_share_readers():
    for name in ("idle_share.serve", "idle_share.files", "idle_share.train"):
        reader = harness.load_reader(name)
        assert reader.UNIT == "%"
        assert reader.read(_trace()) == pytest.approx(100 * (1 - 320 / 700))
        assert reader.read(_trace(busy_s=0.0)) is None


def test_mfu_readers():
    for name in ("mfu.serve", "mfu.files", "mfu.train"):
        reader = harness.load_reader(name)
        got = reader.read(_trace(flops=989.4e12 * 0.5, flops_s=10.0))
        assert got == pytest.approx(5.0)
        assert reader.read(_trace()) is None


def test_attention_roofline_serve():
    reader = harness.load_reader("attn_roofline.serve")
    bound = roofline.attention_bound_s(CFG, 16, 40000, backward=False)
    got = reader.read(_trace(forwards=[(16, 40000)]))
    assert got == pytest.approx(100 * bound / 200e-6)
    no_kernel = _trace(forwards=[(16, 40000)])
    no_kernel["kernels"] = [k for k in no_kernel["kernels"] if k[0] != ATTN]
    assert reader.read(no_kernel) is None


def test_attention_roofline_train():
    reader = harness.load_reader("attn_roofline.train")
    trace = _trace(steps=2)
    trace["kernels"].append((BWD, 300e-6))
    bound = 2 * roofline.attention_bound_s(CFG, 16, 8000, backward=True)
    assert reader.read(trace) == pytest.approx(100 * bound / 500e-6)


def test_span_readers_sum_their_modules_per_forward():
    from benchmark import weights

    cfg = cells.files("speech_serve_bulk", tiny=True)["config"]
    ref = weights.seeded_reference(cfg, 1, "cpu")
    gen = harness.program_models(cfg, ref, "cpu", False)["generator"]
    readers = {n: harness.load_reader(n) for n in
               ("encoders_ms.serve", "decoders_ms.serve", "blstm_ms.serve")}
    assert len(readers["encoders_ms.serve"].modules(gen)) == 4
    assert len(readers["decoders_ms.serve"].modules(gen)) == 4
    assert len(readers["blstm_ms.serve"].modules(gen)) == 4  # enc2, enc3
    spans = harness.Spans({n: r.modules(gen) for n, r in readers.items()},
                          "cpu")
    with torch.inference_mode():
        for _ in range(2):
            gen(torch.zeros(1, 1, 4000))
            spans.end_unit()
    trace = _trace(spans=spans.close())
    values = {n: r.read(trace) for n, r in readers.items()}
    assert all(v > 0 for v in values.values())
    assert values["blstm_ms.serve"] < values["encoders_ms.serve"]
    assert readers["encoders_ms.serve"].read(_trace()) is None
