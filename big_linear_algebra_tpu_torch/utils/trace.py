"""Where the port's time goes, in a ``torch.profiler`` trace: host spans at
its layer boundaries and device marks at the phases of a step.

- ``span(name)``: while a profiler records, ``record_function(name)`` (a
  ``user_annotation`` event on the clock of the device events); otherwise
  the shared ``NULL`` context, at the cost of one flag check. Spans are
  named ``bla.<layer>.<what>`` and nest on the calling thread: entry
  (``bla.train.run``, ``bla.sample``), dispatch (``bla.graph.*``,
  ``utils/graphs.py``), model step (``bla.step.*``) and kernel builds
  (``bla.kernels.build.<library>``).
- ``phase(name, like)``: the span ``bla.step.<name>`` and, at its start,
  the mark ``bla_mark_<name>``: an empty kernel of ``csrc/marks.cu``
  launched on the current stream of ``like``'s device. A mark is recorded
  in an eager step and captured into a CUDA graph, so every replay shows
  where each phase of each step begins, which the host cannot (a replay is
  one host call for many steps). Marks are always on: a graph is often
  captured before a profiler starts. They count no launch
  (``graphs._COUNTERS``). On the CPU a mark is nothing.
- ``mark("attention" | "attention_end", like)``: the marks that bound a
  multi-head attention block (``nn/attention.py``) in the forward and, by
  identity autograd functions at its output and input, in the backward.
  They are no phase: a reader of the phase marks passes over them.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.autograd.profiler as _profiler

NULL = contextlib.nullcontext()
PHASES = ("forward", "backward", "adam", "update")
MARKS = PHASES + ("attention", "attention_end")


def span(name: str):
    """``record_function(name)`` while a profiler records, else ``NULL``."""
    if not _profiler._is_profiler_enabled:
        return NULL
    return torch.profiler.record_function(name)


def mark(name: str, like: torch.Tensor) -> None:
    """Launch ``bla_mark_<name>`` on the current stream of ``like``'s
    device; nothing for a tensor off the card."""
    if not like.is_cuda:
        return
    # imported here: cuda_utils puts its builds under a span
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    lib = cuda_utils.load_library("marks")
    fn = lib.bla_mark
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(like.device):
        rc = fn(MARKS.index(name),
                torch.cuda.current_stream(like.device).cuda_stream)
    cuda_utils.check(lib, rc, f"bla_mark_{name} launch")


@contextlib.contextmanager
def phase(name: str, like: torch.Tensor):
    """The span ``bla.step.<name>`` with its mark launched at its start."""
    with span(f"bla.step.{name}"):
        mark(name, like)
        yield
