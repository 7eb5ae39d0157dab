"""Shared model-program scaffolding, the counterpart of
``big_linear_algebra_tpu/models/common.py``: CLI verbs, strict flags,
metrics logging, profiling, debugging.

≈ the reference's per-model ``main(argc, argv)`` dispatchers
(model/mnist_nn.c:512-536: verbs ``init | train <epochs> | run [n]``).
Flags every model understands:

- ``--device=cuda|cpu`` (default ``cuda``): the port's counterpart of the
  JAX package's backend choice; it never moves to the CPU on its own;
- ``--profile[=DIR]``: a ``torch.profiler`` trace of the verb;
- ``--debug-nans``: the verb runs under ``utils.debug_nans``. JAX's
  ``jax_debug_nans`` checks every primitive's output; here every ATen op's
  floating outputs and every hand-written kernel's outputs are checked,
  and the first NaN raises ``FloatingPointError`` naming its op;
- ``--disable-jit``: the verb runs under ``utils.no_jit``. The port has no
  jit; what ``jax_disable_jit`` gives, op-by-op execution so that a fault
  surfaces at its op, is a device synchronize after every ATen op and
  every kernel launch on a CUDA tensor.

The two debug flags only read: a run under them is bit-equal to one
without them. Under either, the steps a model would replay as a CUDA graph
run eagerly (``utils/debug.py``).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from big_linear_algebra_tpu_torch.utils import debug


def data_dir() -> Path:
    """Root data directory (reference uses relative ``data/``; override with
    BLA_DATA_DIR)."""
    return Path(os.environ.get("BLA_DATA_DIR", "data"))


class MetricsLogger:
    """Structured metrics: one stdout line per ``log`` call of
    tab-separated ``key: value`` pairs (floats to five places), and one
    JSON line, with a ``time`` stamp, appended to ``jsonl_path`` when
    given. A logger made with ``enabled=False`` (a rank other than 0 of a
    ``--dp`` run) writes nothing."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 enabled: bool = True):
        self._enabled = enabled
        self._file = open(jsonl_path, "a") if jsonl_path and enabled \
            else None

    def log(self, **metrics) -> None:
        if not self._enabled:
            return
        print("\t".join(f"{k}: {v:.5f}" if isinstance(v, float)
                        else f"{k}: {v}" for k, v in metrics.items()),
              flush=True)
        if self._file:
            metrics["time"] = time.time()
            self._file.write(json.dumps(metrics) + "\n")
            self._file.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()


@contextlib.contextmanager
def maybe_profile(enabled: bool, logdir: str = ""):
    """``torch.profiler`` trace of the verb, written as a Chrome/Perfetto
    trace to ``<logdir>/trace.json``. ``--profile`` uses a directory under
    the temporary directory; ``--profile=DIR`` overrides it."""
    if not enabled:
        yield
        return
    logdir = logdir or os.path.join(tempfile.gettempdir(), "bla_profile")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    print(f"profile written to {logdir}", flush=True)


def parse_flags(argv: List[str]):
    """Split ``--key[=value]`` flags from positional args."""
    pos, flags = [], {}
    for a in argv:
        if a.startswith("--"):
            k, _, v = a[2:].partition("=")
            flags[k] = v
        else:
            pos.append(a)
    return pos, flags


# Flags every model CLI understands; per-model extras via run_cli's
# ``extra_flags``. Unknown flags are a hard error — silently accepting a flag
# a model ignores is worse than rejecting it.
BASE_FLAGS = frozenset({"profile", "device", "debug-nans", "disable-jit"})

# The JAX package accepts --jsonl on every program and ignores it where no
# metrics are logged; the port rejects a flag it would ignore.
NO_METRICS_LOG = ("this program logs no metrics (the JAX package accepts "
                  "--jsonl here and ignores it)")


def print_cost_windows(costs, window: int) -> None:
    """The reference's rolling cost report: every ``window`` steps, the
    window's costs and their average (model/my_first_model.c:106-116,
    model/mnist.c:175-192). ``costs``: a 1-D numpy array."""
    for i in range(window - 1, len(costs), window):
        win = costs[i - window + 1:i + 1]
        print(f"Last {window} costs:")
        for j, c in enumerate(win):
            print(f"\tCost[{j}]: {c:.3f}")
        print(f"\tAvg: {win.mean():.3f}")


def positive_int_flag(flags, name: str) -> int:
    """Parse ``--name=N`` as a positive int; a bare ``--name`` (empty value)
    or a non-positive value is a hard error — same policy as unknown flags
    (silently falling back to a default would run another configuration
    than the one asked for)."""
    raw = flags.get(name, "")
    try:
        value = int(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"--{name} needs an integer value, e.g. --{name}=64 "
            f"(got {raw!r})") from None
    if value <= 0:
        raise ValueError(f"--{name} must be positive, got {value}")
    return value


def int_flag(flags, name: str, default: int, minimum: int) -> int:
    """Parse ``--name=N`` as an int ≥ ``minimum`` when present, else
    ``default``. A bare ``--name`` or an out-of-range value is a hard
    error, as in positive_int_flag."""
    if name not in flags:
        return default
    raw = flags.get(name, "")
    try:
        value = int(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"--{name} needs an integer value, e.g. --{name}={default or 1} "
            f"(got {raw!r})") from None
    if value < minimum:
        raise ValueError(f"--{name} must be >= {minimum}, got {value}")
    return value


def presence_flag(flags, name: str) -> bool:
    """A flag that is either absent or bare (``--name``). A value
    (``--name=false``) is a hard error — silently enabling it on
    ``--name=false`` would invert the user's intent."""
    if name not in flags:
        return False
    if flags[name] != "":
        raise ValueError(
            f"--{name} takes no value; pass a bare --{name} to enable it "
            f"(got --{name}={flags[name]!r})")
    return True


def launch_world(flags) -> int:
    """The ranks of the launch, the parallel modes' counterpart of the JAX
    package's "all local devices": under a launcher (``torchrun``, or the
    ranks ``run_cli`` spawns, one per visible card) the rank joins the
    process group on its own device (``--device``); 1 without one."""
    from big_linear_algebra_tpu_torch.parallel import mesh as pmesh

    pmesh.distributed_init(device=(flags or {}).get("device") or "cuda")
    return pmesh.world_size()


def launch_done(mesh=None) -> None:
    """The end of a verb in a launch: every rank of ``mesh`` (default: every
    rank of the launch) waits until rank 0 has written (a verb run next in
    the same group reads what it wrote). A rank the mesh leaves out returns
    at once: it took no part in the run, and a barrier it joined would
    wait out the whole run, past the process group's timeout."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return
    if mesh is None:
        dist.barrier()
    elif mesh.coords is not None:
        dist.barrier(group=mesh.whole)


def dp_mesh(flags, batch_size: Optional[int] = None):
    """``--dp``'s contract: under a launcher (``launch_world``) the mesh of
    every rank on a ``data`` axis, on this rank's device; with one rank it
    prints the JAX package's ``--dp: single device, running unsharded`` and
    returns None (the normal path runs). A ``batch_size`` that does not
    divide over the ranks raises. None without ``--dp``."""
    flags = flags or {}
    if not presence_flag(flags, "dp"):
        return None
    from big_linear_algebra_tpu_torch.parallel import mesh as pmesh

    if launch_world(flags) <= 1:
        print("--dp: single device, running unsharded")
        return None
    mesh = pmesh.default_mesh()
    n = mesh.size("data")
    if batch_size is not None and batch_size % n:
        raise SystemExit(f"--dp: batch size {batch_size} is not divisible "
                         f"by {n} devices")
    return mesh


def is_rank0() -> bool:
    """Whether this process prints and writes: rank 0 of a ``--dp`` run,
    or a run without one."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def say_eager_rule(flag: str, device) -> None:
    """The parallel modes' stated rule, printed once by rank 0: where the
    ranks share a card over gloo, ``--flag``'s steps run eagerly, since a
    CUDA graph cannot hold gloo's collectives (``utils/graphs.py``
    ``GLOO``). Over NCCL they replay a graph, and on the CPU nothing is
    said (every step there is eager)."""
    from big_linear_algebra_tpu_torch.utils import graphs

    if (torch.device(device).type == "cuda" and is_rank0()
            and graphs.eager_reason(device) == graphs.GLOO):
        print(f"--{flag}: eager steps ({graphs.GLOO})")


def rank0_first(fn: Callable[[], Any]) -> Any:
    """``fn()`` on rank 0 first, then on the other ranks (which find the
    files it made): data synthesis under ``--dp``."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return fn()
    if dist.get_rank() == 0:
        out = fn()
        dist.barrier()
        return out
    dist.barrier()
    return fn()


# The flags of the parallel modes and of the dispatch modes (the JAX
# package's XLA dispatch, replayed CUDA graphs here), which apply to train
# only.
_TRAIN_FLAGS = {"dp": "data parallelism", "tp": "tensor parallelism",
                "pp": "pipeline parallelism",
                "pp-micro": "pipeline parallelism",
                "pp-schedule": "pipeline parallelism",
                "scan-steps": "the train steps' dispatch",
                "scan-unroll": "the train steps' dispatch",
                "host-loop": "the train steps' dispatch"}


def _ranks_to_spawn(flags) -> int:
    """Ranks a parallel mode spawns when launched plainly on a node with
    several cards, one per card its mesh uses: every visible card for
    ``--dp`` and ``--tp``; 3 for ``--pp``, or 3·⌊n/3⌋ for ``--pp --dp`` on
    n ≥ 6, so that no rank is left out of the mesh. None under a launcher,
    on the CPU, on one card, or for ``--pp`` on two (the one process then
    runs unsharded)."""
    if any(v in os.environ for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return 0
    if (flags.get("device") or "cuda") != "cuda":
        return 0
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if "pp" in flags:
        if n < 3:
            return 0
        return 3 * (n // 3) if "dp" in flags and n >= 6 else 3
    return n if n > 1 else 0


def _cli_rank(prog: str, argv: List[str]) -> int:
    import importlib

    module = importlib.import_module(f"big_linear_algebra_tpu_torch.models."
                                     f"{prog}")
    return module.main(argv)


def device_flag(flags) -> torch.device:
    """``--device=cuda|cpu`` (default ``cuda``). ``cuda`` without a usable
    GPU raises: the program never falls back to the CPU on its own."""
    name = (flags or {}).get("device") or "cuda"
    if name not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device=cuda but no CUDA device is available; "
                           "pass --device=cpu to run on the CPU")
    return torch.device(name)


@contextlib.contextmanager
def debug_flags(flags):
    """``--debug-nans`` and ``--disable-jit`` around a verb (JAX's
    ``_apply_debug_flags``); each takes no value."""
    with contextlib.ExitStack() as stack:
        if presence_flag(flags, "debug-nans"):
            stack.enter_context(debug.debug_nans())
        if presence_flag(flags, "disable-jit"):
            stack.enter_context(debug.no_jit())
        yield


def run_cli(prog: str,
            init_fn: Callable[..., Optional[int]],
            train_fn: Callable[..., Optional[int]],
            run_fn: Callable[..., Optional[int]],
            argv: Optional[List[str]] = None,
            train_usage: str = "train <num epochs>",
            run_usage: str = "run [<num predictions>]",
            extra_flags=(),
            unsupported_flags: Optional[Dict[str, str]] = None) -> int:
    """Dispatch the reference CLI verbs. Flags are passed to the verb
    functions via the ``flags`` keyword. ``unsupported_flags`` maps a flag
    name, or ``name=VALUE`` for one value of an accepted flag (matched
    case-insensitively), to the reason it is rejected for this model. A verb
    may return a non-zero exit code."""
    argv = list(sys.argv[1:] if argv is None else argv)
    pos, flags = parse_flags(argv)
    usage = (f"Please supply an argument, options:\n\t{run_usage}\n\t"
             f"{train_usage}\n\tinit\n")
    if not pos:
        print(usage)
        return 1
    allowed = BASE_FLAGS | set(extra_flags)
    rejected = unsupported_flags or {}
    for k, v in flags.items():
        for spelled in (k, f"{k}={v.upper()}"):
            if spelled in rejected:
                print(f"--{spelled} is not supported by {prog}: "
                      f"{rejected[spelled]}")
                return 1
        if k not in allowed:
            print(f"Unrecognized flag --{k}; {prog} accepts: "
                  + " ".join(f"--{f}" for f in sorted(allowed)))
            return 1
    verb = pos[0]
    for f, what in _TRAIN_FLAGS.items():
        if f in flags and not verb.startswith("train"):
            # the JAX package ignores these outside train; the port rejects
            # a flag it would ignore
            print(f"--{f} is not supported by {prog} {verb}: {what} "
                  f"applies to train")
            return 1
    try:
        if verb.startswith("run"):
            n = int(pos[1]) if len(pos) > 1 else -1
            extra = [int(p) for p in pos[2:]]
            with maybe_profile("profile" in flags, flags.get("profile", "")), \
                    debug_flags(flags):
                rc = run_fn(n, *extra, flags=flags)
        elif verb.startswith("train"):
            if len(pos) < 2:
                print(f"Please supply a number of epochs, usage:\n\t{train_usage}\n")
                return 1
            n_ranks = (_ranks_to_spawn(flags)
                       if {"dp", "tp", "pp"} & set(flags) else 0)
            if n_ranks:  # a parallel mode on a node with several cards
                from big_linear_algebra_tpu_torch.parallel.mesh import (
                    spawn_ranks)

                spawn_ranks(_cli_rank, n_ranks, prog, argv)
                return 0
            with maybe_profile("profile" in flags, flags.get("profile", "")), \
                    debug_flags(flags):
                rc = train_fn(int(pos[1]), *pos[2:], flags=flags)
        elif verb.startswith("init"):
            with debug_flags(flags):
                rc = init_fn(flags=flags)
        else:
            print(f"Unrecognized argument, options:\n\t{run_usage}\n\t"
                  f"{train_usage}\n\tinit\n")
            return 1
    except BrokenPipeError:  # pragma: no cover
        return 0
    return rc or 0
