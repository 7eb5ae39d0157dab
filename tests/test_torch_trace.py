"""The port's spans and phase marks (``utils/trace.py``) on the CPU: which
``bla.*`` spans a train run and a sampling call open under a profiler and
how they nest, the dispatch spans of a capture and its replays (the
capture stood in for), nothing entered without a profiler, marks that do
nothing off the card, and runs bit-equal with and without spans."""

import contextlib
import dataclasses
import json

import pytest
import torch

from big_linear_algebra_tpu_torch.models import cifar_unet as cu
from big_linear_algebra_tpu_torch.nn.optim import adam_init, tree_leaves
from big_linear_algebra_tpu_torch.ops import cuda_utils
from big_linear_algebra_tpu_torch.utils import graphs, trace

CFG = dataclasses.replace(cu.TINY, timesteps=2)


def _profiled(body, path):
    """(what ``body()`` returns, [(name, start, end)] of its ``bla.*``
    spans) under a CPU profiler, read from its Chrome trace at ``path`` as
    a benchmark reads them (``user_annotation`` events)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = body()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith("bla.")),
                   key=lambda s: (s[1], -s[2]))
    return out, spans


def _parents(spans):
    """Each span's name and the name of the innermost span around it (None
    at the top), in order of start."""
    out = []
    for i, (name, a, b) in enumerate(spans):
        around = [s for j, s in enumerate(spans)
                  if j != i and s[1] <= a and b <= s[2]]
        inner = min(around, key=lambda s: s[2] - s[1], default=None)
        out.append((name, inner and inner[0]))
    return out


def _train_and_sample():
    params = cu.init_params(torch.Generator().manual_seed(0), CFG)
    data = torch.rand((4, 3, 32, 32),
                      generator=torch.Generator().manual_seed(3)) * 2 - 1
    steps = cu.TrainSteps(params, adam_init(params), data,
                          torch.Generator().manual_seed(1), CFG)
    losses = steps.run(torch.tensor([[0, 1]]))
    images = cu.sample(params, torch.Generator().manual_seed(2), CFG, 2)
    return losses, tree_leaves(steps.params), images


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    return _profiled(_train_and_sample, path), _train_and_sample()


def test_train_and_sample_spans_nest(runs):
    (_, spans), _ = runs
    fwd, bwd = ("bla.step.forward", "bla.graph.eager"), (
        "bla.step.backward", "bla.graph.eager")
    assert _parents(spans) == [
        ("bla.train.run", None),
        ("bla.train.buffers", "bla.train.run"),
        ("bla.graph.eager", "bla.train.run"),
        fwd, bwd, ("bla.step.adam", "bla.graph.eager"),
        ("bla.sample", None),
        ("bla.sample.prepare", "bla.sample"),
        ("bla.graph.eager", "bla.sample"),
        fwd, ("bla.step.update", "bla.graph.eager"),
        fwd, ("bla.step.update", "bla.graph.eager")]


def test_spans_change_nothing(runs):
    """The profiled run (spans entered) equals the plain one bit for bit."""
    ((losses, params, images), _), (want_losses, want_params,
                                    want_images) = runs
    assert torch.equal(losses, want_losses)
    assert torch.equal(images, want_images)
    assert all(torch.equal(a, b) for a, b in zip(params, want_params))


def test_graph_spans_with_the_capture_stood_in(monkeypatch, tmp_path):
    """``StepGraph``'s spans: the warm-up, ``gc.collect()``, the capture
    block and each replay; eager steps after the capture apart."""
    class FakeGraph:
        def register_generator_state(self, gen):
            pass

        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    g = graphs.StepGraph(4, torch.device("cpu"), graphed=False)
    g.graphed, g.stream = True, object()
    monkeypatch.setattr(g, "_on_capture_stream", contextlib.nullcontext)
    _, spans = _profiled(lambda: (g.run(6, lambda: None),
                                  g.run(5, lambda: None)),
                         tmp_path / "trace.json")
    assert [s[0] for s in spans] == [
        "bla.graph.warmup", "bla.graph.gc", "bla.graph.capture",
        "bla.graph.replay", "bla.graph.eager", "bla.graph.replay"]
    assert all(p is None for _, p in _parents(spans))


def test_no_span_without_a_profiler():
    assert trace.span("bla.x") is trace.NULL
    with trace.phase("forward", torch.zeros(1)):
        pass


def test_marks_do_nothing_on_the_cpu(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a CPU mark loaded {name}")

    monkeypatch.setattr(cuda_utils, "load_library", refuse)
    before = graphs.launch_counts()
    for name in trace.PHASES:
        assert trace.mark(name, torch.zeros(2)) is None
    assert graphs.launch_counts() == before
