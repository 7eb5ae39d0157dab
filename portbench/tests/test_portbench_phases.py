"""The readers of the program's marks and spans (``phases.py``) on small
recorded traces: marks cycling over two steps with a second stream, a
mark count unlike the window's steps, a sampling call's capture spans
over the card's idle time, and a program without marks or spans."""

import json

import pytest

from portbench import harness, phases

US = 1e-3  # ms in a µs


def write(path, device, host=(), window=100000.0):
    """A Chrome trace of a ``window`` (100 ms) from 1000 µs: device events
    (name, start, duration[, category]) and host spans (name, start,
    duration), in µs."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window",
           "ts": 1000.0, "dur": window}]
    ev += [{"ph": "X", "cat": d[3] if len(d) > 3 else "kernel",
            "name": d[0], "ts": d[1], "dur": d[2]} for d in device]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a,
            "dur": d} for n, a, d in host]
    path.write_text(json.dumps({"traceEvents": ev}))
    return harness.read_chrome_trace(str(path))


def train_events():
    """Two steps: forward 10 ms, backward 15 ms and a 3 ms copy on a second
    stream, Adam 5 ms, each phase after its 2 µs mark; a kernel before the
    first mark."""
    ev = [("void at::native::copy_kernel", 2000.0, 1000.0)]
    for s in range(2):
        t = 5000.0 + 40000.0 * s
        ev += [("bla_mark_forward", t, 2.0),
               ("void at::native::elementwise_kernel", t + 10, 10000.0),
               ("bla_mark_backward", t + 10100, 2.0),
               ("void at::native::reduce_kernel", t + 10110, 15000.0),
               ("Memcpy DtoD (Device -> Device)", t + 20000, 3000.0,
                "gpu_memcpy"),
               ("bla_mark_adam", t + 25200, 2.0),
               ("void at::native::vectorized_elementwise_kernel",
                t + 25210, 5000.0)]
    return ev


def sample_events():
    """One call of two denoising steps: prepare, an eager step (forward,
    update), the capture (no device work), one replayed step."""
    device = [("void at::native::normal_kernel", 2500.0, 500.0),
              ("bla_mark_forward", 5000.0, 2.0),
              ("void fused_block_fwd_tc<256>(Args)", 5001.0, 5999.0),
              ("bla_mark_update", 12000.0, 2.0),
              ("void at::native::elementwise_kernel", 12001.0, 1999.0),
              ("bla_mark_forward", 56000.0, 2.0),
              ("void fused_block_fwd_tc<256>(Args)", 56001.0, 23999.0),
              ("bla_mark_update", 80000.0, 2.0),
              ("void at::native::elementwise_kernel", 80001.0, 9999.0)]
    host = [("bla.sample", 2000.0, 98000.0),
            ("bla.sample.prepare", 2000.0, 2000.0),
            ("bla.graph.warmup", 4000.0, 16000.0),
            ("bla.step.forward", 4990.0, 100.0),
            ("bla.graph.gc", 20000.0, 10000.0),
            ("bla.graph.capture", 30000.0, 20000.0),
            ("bla.graph.replay", 55000.0, 1000.0)]
    return device, host


def read(cell_name, trace, kind, images):
    cell = harness.load_cell(cell_name)
    ctx = {"cell": cell, "steps_kind": kind, "images_per_step": images,
           "chips": 1}
    return {k: v["value"] for k, v in harness.read_metrics(
        cell, trace, ctx).items()}


@pytest.mark.parametrize("window", [100000.0, 60000.0])
def test_train_phases_follow_the_latest_mark(tmp_path, window):
    """Also where the window's host end falls before the second step's
    Adam (the card's clock mapped onto the host's, running ahead)."""
    trace = write(tmp_path / "t.json", train_events(), window=window)
    trace.steps = 2
    got = read("cifar32_fused.train_b16", trace, "train", 16)
    mark = 2 * US
    assert got["forward_ms_per_step.train"] == pytest.approx(10 + mark)
    assert got["backward_ms_per_step.train"] == pytest.approx(18 + mark)
    assert got["adam_ms_per_step.train"] == pytest.approx(5 + mark)
    # the kernel before the first mark is in no phase; the copy on the
    # second stream is in its phase and in the busy time's overlap
    assert sum(phases.phase_s(trace).values()) == pytest.approx(
        2 * (33 + 3 * mark) / 1e3)


def test_a_mark_count_unlike_the_steps_reads_nothing(tmp_path):
    trace = write(tmp_path / "t.json", train_events())
    trace.steps = 3
    got = read("cifar32_fused.train_b16", trace, "train", 16)
    assert not any(k.startswith(("forward", "backward", "adam"))
                   for k in got)
    assert "pointwise_ms_per_step.train" in got


def test_sampling_update_and_capture(tmp_path):
    device, host = sample_events()
    trace = write(tmp_path / "t.json", device, host)
    trace.steps = 2
    got = read("cifar32_fused.sample_b32", trace, "sample", 32)
    assert got["update_ms_per_step.sample"] == pytest.approx(
        (2 * 2 * US + 1.999 + 9.999) / 2)
    # warm-up, gc and capture: 4000 to 50000 µs, one call
    assert got["capture_ms_per_call.sample"] == pytest.approx(46.0)
    # idle within prepare .. capture (2000 to 50000 µs): 2000-2500,
    # 3000-5000, 11000-12000, 14000-50000 µs, of a 100 ms window
    assert got["capture_idle_pct.sample"] == pytest.approx(39.5)
    assert not any(k.endswith(".train") for k in got)


def test_idle_under_spans_is_the_intersection():
    assert phases.overlap_s([(0, 2), (1, 3), (5, 6)],
                            [(2.5, 5.5), (5.8, 9)]) == pytest.approx(1.2)
    assert phases.merged([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]


def test_a_program_without_marks_or_spans_reads_nothing(tmp_path):
    device, _ = sample_events()
    unmarked = [d for d in device if not d[0].startswith("bla_mark_")]
    trace = write(tmp_path / "s.json", unmarked)
    trace.steps = 2
    got = read("cifar32_fused.sample_b32", trace, "sample", 32)
    assert not any(k.startswith(("update", "capture")) for k in got)
    assert "device_idle_pct.sample" in got
    trace = write(tmp_path / "t.json", [d for d in train_events()
                                        if not d[0].startswith("bla_")])
    trace.steps = 2
    got = read("cifar32_fused.train_b16", trace, "train", 16)
    assert not any(k.startswith(("forward", "backward", "adam"))
                   for k in got)
