"""``trace_summary.py``: the device and host sums it reads from a
``torch.profiler`` Chrome trace."""

import trace_summary


def _ev(cat, name, ts, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize_sums_device_and_host_events():
    trace = {"traceEvents": [
        _ev("cpu_op", "aten::zeros", 0.0, 500.0),
        _ev("cpu_op", "aten::mm", 600.0, 100.0),
        _ev("cpu_op", "aten::mm", 800.0, 100.0),
        _ev("kernel", "mm_kernel", 650.0, 40.0),
        _ev("kernel", "mm_kernel", 850.0, 60.0),
        _ev("gpu_memcpy", "Memcpy HtoD", 520.0, 100.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 640.0, 5.0),
        _ev("kernel", "not complete", 0.0, 1e6, ph="i"),
        _ev("Trace", "PyTorch Profiler", 0.0, 1000.0),
    ]}
    lines = trace_summary.summarize(trace, top=2).splitlines()
    assert lines[0] == "trace span 1.000 ms"
    assert lines[1] == "device busy 0.200 ms = 20.000% of the span"
    assert "100.0 us  kernel  mm_kernel" in lines[2]
    assert "100.0 us  gpu_memcpy  Memcpy HtoD" in lines[3]
    assert "0.500 ms  aten::zeros" in lines[4]
    assert "0.200 ms  aten::mm" in lines[5]
    assert len(lines) == 6
