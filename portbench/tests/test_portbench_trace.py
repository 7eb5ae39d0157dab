"""The per-layer readers on a small recorded trace: a chrome trace with a
window, two steps of kernels under the names the card's libraries and the
program give them, a second stream, and host spans."""

import json

import pytest

from portbench import harness, yardstick
from portbench.tests import tiny


def write_trace(path):
    """Two train steps in a 100 ms window (times in µs)."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window",
           "ts": 1000.0, "dur": 100000.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
           "ts": 1000.0, "dur": 4000.0},
          {"ph": "X", "cat": "cpu_op", "name": "cudaGraphLaunch",
           "ts": 5000.0, "dur": 100.0}]
    kernels = [
        ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc", 10),
        ("void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16>", 2),
        ("ampere_bf16_s16816gemm_bf16_128x64_ldg8_f2f_nn", 6),
        ("void fused_block_fwd_tc<256>(Args)", 3),
        ("void fused_block_bwd_tc<256>(Args)", 4),
        ("void fused_block_wgrad_tc<256>(Args)", 2),
        ("void at::native::reduce_kernel<512, 1>(...)", 5),
        ("void at::native::vectorized_elementwise_kernel<4>(...)", 3),
        ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(...)", 5),
    ]
    t = 6000.0
    for _ in range(2):
        for name, ms in kernels:
            ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": t,
                       "dur": ms * 1000.0})
            t += ms * 1000.0
    # a copy on a second stream, inside a kernel's interval
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
               "ts": 6500.0, "dur": 1000.0})
    path.write_text(json.dumps({"traceEvents": ev}))


@pytest.fixture
def trace(tmp_path):
    write_trace(tmp_path / "t.json")
    tr = harness.read_chrome_trace(str(tmp_path / "t.json"))
    tr.steps = 2
    return tr


def test_window_busy_and_breakdown(trace):
    assert trace.window_s == pytest.approx(0.1)
    # 2 x 40 ms of kernels, the copy inside them counted once
    assert trace.busy_s() == pytest.approx(0.080)
    b = trace.breakdown()
    assert b["device_ops"][0][0].startswith("sm90_xmma_fprop")
    assert b["device_ops"][0][1] == pytest.approx(0.020)
    longest = b["idle_gaps"][0]
    assert longest[1] == pytest.approx(0.015)  # after the last kernel
    assert b["idle_gaps"][1] == ["aten::copy_", pytest.approx(0.005)]


def test_readers(trace):
    cell = tiny.cell("cifar32_fused.train_b16")
    cell.config["model"].update(tiny.TINY)
    ctx = {"cell": harness.load_cell("cifar32_fused.train_b16"),
           "steps_kind": "train", "images_per_step": 16,
           "host_s_per_step": 0.002, "chips": 1}
    real = ctx["cell"]
    got = {k: v["value"] for k, v in harness.read_metrics(
        real, trace, ctx).items()}
    assert got["host_ms_per_step.train"] == pytest.approx(2.0)
    assert got["conv_gemm_ms_per_step.train"] == pytest.approx(18.0)
    assert got["pointwise_ms_per_step.train"] == pytest.approx(8.5)
    assert got["device_idle_pct.train"] == pytest.approx(20.0)
    k5_ms = 9.0
    model = real.config["model"]
    from portbench import reference as ref
    least = sum(yardstick.k5_bound_s(k, 16, c, f, h, h, "bfloat16")
                for _, c, f, h in ref.fused_sites(model, 16)
                for k in ("fwd", "bwd"))
    assert got["k5_roofline.train"] == pytest.approx(
        100 * least / (k5_ms * 1e-3))
    flops = 3 * 2 * yardstick.forward_flops(model, 16)
    assert got["mfu.train"] == pytest.approx(100 * flops / (989e12 * 0.1))
    # only the cell's own metrics are read
    assert not any(k.endswith(".sample") for k in got)


def test_a_reader_that_finds_nothing_is_left_out(trace):
    """Without a fused block's kernel in the trace its roofline is left
    out of the line, not read as 0."""
    cell = harness.load_cell("cifar32_fused.train_b16")
    trace.device = [e for e in trace.device if "fused_block" not in e[0]]
    ctx = {"cell": cell, "steps_kind": "train", "images_per_step": 16,
           "chips": 1}
    got = harness.read_metrics(cell, trace, ctx)
    assert "k5_roofline.train" not in got
    assert "conv_gemm_ms_per_step.train" in got
