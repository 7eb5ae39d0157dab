"""Steps replayed as CUDA graphs: the port's counterpart of ``jax.jit`` with
``lax.scan`` (or ``lax.fori_loop``) around a step, which the JAX package
dispatches once for many steps.

The JAX package's dispatch modes (a whole epoch as one scan, ``--scan-steps``
chunks, the sampler's loop) exist so that the host does not pay a dispatch per
step. The port's capability is the same, by another mechanism:
``StepGraph`` captures ``unroll`` calls of a step into one
``torch.cuda.CUDAGraph`` and replays it. A step is a function of no
arguments that reads and writes only static buffers (parameters, moments,
an index buffer, accumulators) and a device counter that it advances, so
that replay n+1 reads what replay n wrote, as a scan's carry.

- Warm-up outside capture: the first steps of a run are real steps, run
  eagerly on the capture stream before the capture. They load the kernels'
  libraries, run the ``static`` ``cudaFuncSetAttribute`` calls of
  ``csrc/*.cu`` and the plan caches of the wrappers, and set up cuBLAS and
  cuDNN on that stream, none of which may happen during capture.
- The draws: each generator a step draws from is registered with the graph
  (``CUDAGraph.register_generator_state``). A replay then draws from the
  generator's seed and offset at the time of the replay and advances the
  offset as far as the same steps run eagerly would: a replayed step is bit
  for bit the eager step on the same generator, and the generator's state
  afterwards (saved in a train state) is the same.
- Capture runs nothing: it does not move the device counter, the
  generators or the kernels' launch counters. Python's garbage collector
  is kept out of it: a collection could destroy another graph and free its
  memory, which a capture cannot hold (and a ``StepGraph`` keeps no
  reference to the object whose step it runs, so that no cycle waits for
  the collector to free a graph).
- The launch counters (``ops/matmul.py``, ``nn/attention.py`` with its
  calls by route,
  ``nn/conv_implicit.py``, ``nn/fused_block.py``) count each launch in the
  wrapper that makes it, and a replay calls no wrapper. So the counts a
  capture records are taken back, and added again at every replay: a run
  counts the same launches graphed or eager.
- The collectives of ``parallel/spmd.py`` (a DP or TP step's all-reduces
  and all-gathers) are captured with the step when the ranks run over
  NCCL, which enqueues them on the device; their counters
  (``collective_calls``, ``collective_bytes``) are kept as the launch
  counters are, so a graphed epoch counts the collectives and bytes of the
  eager one. Every group a step uses must have run a
  collective before the capture (NCCL makes a group's communicator at its
  first collective): the warm-up's eager steps do that. Gloo stages its
  collectives through host memory, which a graph cannot hold.
- A capture or replay that fails raises; nothing falls back to the eager
  steps. The eager steps run instead only where no graph is asked for
  (``eager_reason``): on the CPU (where they are the plain version), under
  the debug modes of ``utils/debug.py`` (which run op by op), in a gloo
  process group, inside ``eager()``, or with ``graphed=False``.
- Spans (``utils/trace.py``, under a profiler): ``bla.graph.warmup`` (the
  eager steps before a capture), ``bla.graph.gc``, ``bla.graph.capture``
  (the ``torch.cuda.graph`` block, its synchronize and cache release
  included), ``bla.graph.replay`` (one a replay) and ``bla.graph.eager``
  (eager steps after a capture, or all steps where none is captured).
"""

from __future__ import annotations

import contextlib
import gc
import importlib
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from big_linear_algebra_tpu_torch.utils import debug, trace

# The kernels' launch counters: module → its counter attributes (ints, or
# dicts of ints).
_COUNTERS = {
    "big_linear_algebra_tpu_torch.ops.matmul": (
        "launch_count", "variant_launch_counts"),
    "big_linear_algebra_tpu_torch.nn.attention": (
        "launch_count", "bwd_dq_launch_count", "bwd_dkv_launch_count",
        "bwd_fused_launch_count", "route_calls"),
    "big_linear_algebra_tpu_torch.nn.conv_implicit": (
        "implicit_launch_count", "packed_launch_count"),
    "big_linear_algebra_tpu_torch.nn.fused_block": (
        "launch_count", "bwd_launch_count", "wgrad_launch_count",
        "tc_launch_count", "bwd_tc_launch_count", "wgrad_tc_launch_count"),
    "big_linear_algebra_tpu_torch.nn.optim": ("adam_launch_count",),
    "big_linear_algebra_tpu_torch.parallel.spmd": (
        "collective_calls", "collective_bytes"),
}
Counts = Dict[Tuple[str, str, Optional[str]], int]


def launch_counts() -> Counts:
    """Every launch counter (and collective counter) now: (module,
    attribute, dict key or None) → count."""
    out: Counts = {}
    for name, attrs in _COUNTERS.items():
        module = importlib.import_module(name)
        for attr in attrs:
            value = getattr(module, attr)
            if isinstance(value, dict):
                out.update({(name, attr, k): v for k, v in value.items()})
            else:
                out[(name, attr, None)] = value
    return out


def _set_counts(counts: Counts, add: bool = False) -> None:
    """Set the counters in ``counts`` to its values (``add``: advance them
    by its values)."""
    for (name, attr, key), value in counts.items():
        module = importlib.import_module(name)
        if key is None:
            setattr(module, attr,
                    value + (getattr(module, attr) if add else 0))
        else:
            table = getattr(module, attr)
            table[key] = value + (table[key] if add else 0)


# Why a step runs eagerly where a CUDA graph could not hold it
# (``eager_reason``); the gloo reason is the line the CLIs print.
GLOO = "ranks share a card: gloo collectives cannot be captured"
_forced_eager = [0]


@contextlib.contextmanager
def eager():
    """Inside it no ``StepGraph`` made with the default ``graphed`` is
    graphed: the same steps run eagerly (the bit-equal reference a check
    holds a graphed run against)."""
    _forced_eager[0] += 1
    try:
        yield
    finally:
        _forced_eager[0] -= 1


def eager_reason(device: torch.device) -> Optional[str]:
    """None where steps on ``device`` may be captured, else why not: not a
    CUDA device; the debug modes (``utils/debug.py`` runs op by op, which a
    graph cannot); a process group on gloo (``GLOO``: NCCL refuses two
    ranks on one card, and gloo stages every collective through host
    memory); inside ``eager()``."""
    if torch.device(device).type != "cuda":
        return f"no CUDA graph on {torch.device(device).type}"
    if debug.active():
        return "the debug modes run op by op"
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_backend() != "nccl":
        return GLOO
    if _forced_eager[0]:
        return "graphs.eager()"
    return None


def graphs_allowed(device: torch.device) -> bool:
    """Whether steps on ``device`` may be captured: on a CUDA device,
    outside the debug modes and ``eager()``, and either outside a process
    group or in an NCCL one (``eager_reason``)."""
    return eager_reason(device) is None


def _eager(k: int, step: Callable[[], None]) -> None:
    with trace.span("bla.graph.eager"):
        for _ in range(k):
            step()


class StepGraph:
    """``unroll`` calls of a step as one CUDA graph. ``run(k, step)`` makes
    k calls of ``step`` (the same function at every call):

    - not graphed (``graphed`` false; default: ``graphs_allowed``): k eager
      calls;
    - before the first capture, k ≥ unroll: the first 1 + (k − 1) mod
      unroll calls run eagerly on the capture stream (the warm-up, real
      steps), then the capture, then (k − those) / unroll replays; k <
      unroll: k eager calls, no capture;
    - once captured: k mod unroll eager calls, then ⌊k / unroll⌋ replays.

    ``generators``: every generator the step draws from, registered with
    the graph. The graph's memory (its private pool: the steps'
    intermediates) lives as long as this object."""

    def __init__(self, unroll: int, device: torch.device,
                 generators: Iterable[torch.Generator] = (),
                 graphed: Optional[bool] = None):
        if unroll < 1:
            raise ValueError(f"unroll must be positive, got {unroll}")
        self.unroll = unroll
        self.device = torch.device(device)
        self.generators = tuple(g for g in generators if g is not None)
        self.graphed = (graphs_allowed(self.device) if graphed is None
                        else graphed)
        if graphed and self.device.type != "cuda":
            raise ValueError(f"no CUDA graph on {self.device}")
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.deltas: Counts = {}
        self.replays = 0  # replays so far

    def reset(self) -> None:
        """Drop the graph (a static buffer it reads was replaced); the next
        ``run`` warms up and captures again."""
        self.graph = None

    def run(self, k: int, step: Callable[[], None]) -> None:
        if not self.graphed or (self.graph is None and k < self.unroll):
            _eager(k, step)
            return
        if self.graph is None:
            head = 1 + (k - 1) % self.unroll
            with trace.span("bla.graph.warmup"), self._on_capture_stream():
                for _ in range(head):
                    step()
            self.capture(step)
        else:
            head = k % self.unroll
            _eager(head, step)
        for _ in range((k - head) // self.unroll):
            self.replay()

    @contextlib.contextmanager
    def _on_capture_stream(self):
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            yield
        current.wait_stream(self.stream)

    def capture(self, step: Callable[[], None]) -> None:
        """Capture ``unroll`` calls of ``step`` (after a warm-up: see
        ``run``). Raises if the capture fails or this PyTorch cannot
        register a generator with a graph."""
        graph = torch.cuda.CUDAGraph()
        if self.generators and not hasattr(graph, "register_generator_state"):
            raise RuntimeError(
                "this PyTorch cannot register a generator with a CUDA graph "
                "(CUDAGraph.register_generator_state): a replayed step "
                "would repeat its capture's draws")
        for gen in self.generators:
            graph.register_generator_state(gen)
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        before = launch_counts()
        # in a process group NCCL's watchdog thread queries the events of
        # earlier collectives while the capture runs, which a capture in
        # the global mode would count as an unsafe call against it
        import torch.distributed as dist

        mode = "thread_local" if dist.is_initialized() else "global"
        with trace.span("bla.graph.gc"):
            gc.collect()
        gc.disable()
        try:
            with trace.span("bla.graph.capture"), torch.cuda.graph(
                    graph, stream=self.stream, capture_error_mode=mode):
                for _ in range(self.unroll):
                    step()
        finally:
            gc.enable()
            after = launch_counts()
            _set_counts(before)
        self.deltas = {k: after[k] - v for k, v in before.items()
                       if after[k] != v}
        self.graph = graph

    def replay(self) -> None:
        """One replay: ``unroll`` steps; the launch and collective counters
        advance by what the capture recorded."""
        with trace.span("bla.graph.replay"):
            self.graph.replay()
        _set_counts(self.deltas, add=True)
        self.replays += 1
