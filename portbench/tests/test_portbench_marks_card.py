"""On the card: the program's phase marks and spans in a traced window of
each cell, as a ``--trace 1`` run reads them
(``python -m pytest portbench/tests -m card``)."""

import pytest

from portbench import harness, phases
from portbench.drivers import sample as sample_driver
from portbench.drivers import train as train_driver

SEED = 2 ** 31 + 29


def metrics(cell, trace, kind):
    ctx = {"cell": cell, "steps_kind": kind, "chips": 1,
           "images_per_step": cell.traffic["batch"]}
    return harness.read_metrics(cell, trace, ctx)


@pytest.mark.card
def test_a_sampling_call_marks_every_step_on_the_shared_clock(card):
    """A call's forward marks: the warm-up's eager steps, then every
    replayed step, each after the start of the host span of the replay
    that launched it (host spans and device events share a clock)."""
    cell = harness.load_cell("cifar32_fused.sample_b32")
    model = cell.config["model"]
    steps, unroll = model["timesteps"], model["scan_unroll"]
    prog = sample_driver.Program(cell, SEED, card)
    prog.warm()
    trace = harness.traced(lambda: (prog.call(), steps)[1], card)
    fwd = [a for a, p in phases.marks(trace) if p == "forward"]
    head = 1 + (steps - 1) % unroll
    replays = sorted(a for n, a, _ in trace.host if n == "bla.graph.replay")
    (warmup,) = [a for n, a, _ in trace.host if n == "bla.graph.warmup"]
    assert len(fwd) == steps == trace.steps
    assert len(replays) == (steps - head) // unroll
    assert all(a >= warmup for a in fwd[:head])
    assert all(a >= replays[n // unroll] for n, a in enumerate(fwd[head:]))
    got = metrics(cell, trace, "sample")
    for name in ("update_ms_per_step.sample", "capture_ms_per_call.sample",
                 "capture_idle_pct.sample"):
        assert got[name]["value"] > 0, name


@pytest.mark.card
def test_the_train_phases_cover_the_step(card):
    """A window of replays: a forward mark a step, and forward, backward
    and Adam summing to the busy time within 5%."""
    cell = harness.load_cell("cifar32_fused.train_b16")
    prog = train_driver.Program(cell, SEED, card)
    prog.warm()
    trace = harness.traced(prog.call, card)
    prog.release()
    fwd = [a for a, p in phases.marks(trace) if p == "forward"]
    assert len(fwd) == trace.steps == cell.traffic["steps_per_call"]
    got = metrics(cell, trace, "train")
    parts = sum(got[f"{p}_ms_per_step.train"]["value"]
                for p in ("forward", "backward", "adam"))
    busy_ms = 1e3 * trace.busy_s() / trace.steps
    assert parts == pytest.approx(busy_ms, rel=0.05)
