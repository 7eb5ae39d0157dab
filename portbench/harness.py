"""What every run shares: the manifest and the cell's files, the seeds, the
chip check, the window, the trace and its reduction, the import guard and
the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its files are
found by name: the configuration ``configs/<config>.json``, the traffic mix
``traffic/<traffic>.json`` (whose ``kind`` names the driver
``drivers/<kind>.py``), the cell's limits ``workloads/<cell>.json``, and
each per-layer metric's reader ``metrics/<metric>.py`` with its kernel-name
patterns ``metrics/<metric>.json``. Adding a cell, a configuration, a mix
or a metric adds files and entries; no file here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that may not be loaded in the process that prints
# a result: the JAX stack and the JAX package (the port's own name begins
# with the latter's, so names are compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "big_linear_algebra_tpu")


class NoResult(Exception):
    """The run cannot give a result (no card, a missing file): the message
    goes to standard error and the exit code is not 0."""


def process_start() -> float:
    """This process's start on the ``time.monotonic`` clock (from
    /proc/self/stat and /proc/uptime; the import time where those cannot be
    read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.monotonic()


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise NoResult(f"missing file {path}")
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A Python file of the benchmark, loaded by path."""
    if not path.is_file():
        raise NoResult(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def subseed(seed: int, *keys) -> int:
    """A 63-bit seed for one use of ``seed`` (weights, data, order, draws,
    the n-th call): SeedSequence over the seed and the use's keys."""
    import numpy as np

    words = [seed % 2 ** 64] + [
        k if isinstance(k, int) else int.from_bytes(k.encode(), "little")
        % 2 ** 64 for k in keys]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0]) >> 1


@dataclasses.dataclass
class Cell:
    """One cell and everything its files say."""
    name: str
    manifest: dict
    entry: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def end_to_end(self) -> List[dict]:
        return [m for m in self.manifest["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.manifest["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]


def load_cell(name: str, root: Path = ROOT, bench: Path = HERE) -> Cell:
    manifest = load_json(root / "BENCHMARK.json")
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if not entries:
        raise NoResult(f"BENCHMARK.json has no workload {name!r}")
    entry = entries[0]
    config = load_json(bench / "configs" / f"{entry['config']}.json")
    traffic = load_json(bench / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(bench / "workloads" / f"{name}.json")["limits"]
    return Cell(name, manifest, entry, config, traffic, limits)


def config_with_batch(cell: Cell) -> dict:
    """The configuration's model keys with the mix's batch."""
    cfg = dict(cell.config["model"])
    cfg["batch_size"] = cell.traffic["batch"]
    return cfg


# ---------------------------------------------------------------------------
# The chip
# ---------------------------------------------------------------------------


def cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's nvcc builds go to ``build/torch_kernels`` there)."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ.setdefault("USE_FLAX", "0")


def require_cards(n: int):
    """The run's devices, or ``NoResult`` without CUDA or with fewer cards
    than the cell asks for: a run never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoResult("torch.cuda.is_available() is False: this benchmark "
                       "runs on the card only")
    if torch.cuda.device_count() < n:
        raise NoResult(f"the cell needs {n} cards, "
                       f"{torch.cuda.device_count()} are visible")
    return [torch.device("cuda", i) for i in range(n)]


def device_info(devices) -> dict:
    import torch

    if devices[0].type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": len(devices),
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(devices[0]),
            "count": len(devices),
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in devices)}


def synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(call: Callable[[], int], seconds: float, device) -> Tuple[int,
                                                                      float]:
    """Calls ``call`` (which returns the work it enqueued) until
    ``seconds`` have passed since the first, then waits for the device:
    (work, seconds of the whole window)."""
    t0 = time.perf_counter()
    work = 0
    while True:
        work += call()
        if time.perf_counter() - t0 >= seconds:
            break
    synchronize(device)
    return work, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
WINDOW_SPAN = "portbench.window"


@dataclasses.dataclass
class Trace:
    """A traced window: device events (name, start, end) and host events
    (name, start, end), in seconds of the trace's clock; ``lo`` and ``hi``
    bound the window; ``steps`` is the driver's count of steps in it."""
    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    lo: float
    hi: float
    steps: int = 0

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_s(self) -> float:
        from portbench import yardstick

        return yardstick.union_s(self.clipped())

    def clipped(self) -> List[Tuple[float, float]]:
        return [(max(a, self.lo), min(b, self.hi)) for _, a, b in self.device
                if b > self.lo and a < self.hi]

    def device_s(self, include=(), exclude=()) -> float:
        """Summed device time of the events whose name matches a pattern
        of ``include`` (all, when empty) and none of ``exclude``."""
        inc = [re.compile(p, re.I) for p in include]
        exc = [re.compile(p, re.I) for p in exclude]
        total = 0.0
        for name, a, b in self.device:
            a, b = max(a, self.lo), min(b, self.hi)
            if b <= a:
                continue
            if inc and not any(p.search(name) for p in inc):
                continue
            if any(p.search(name) for p in exc):
                continue
            total += b - a
        return total

    def breakdown(self, top: int = 10) -> dict:
        from portbench import yardstick

        by_name: Dict[str, float] = {}
        for name, a, b in self.device:
            a, b = max(a, self.lo), min(b, self.hi)
            if b > a:
                by_name[name] = by_name.get(name, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(yardstick.gaps(self.clipped(), self.lo, self.hi),
                      key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[self.host_at((a + b) / 2), b - a]
                              for a, b in idle]}

    def host_at(self, t: float) -> str:
        """The innermost host event around time ``t``."""
        best = None
        for name, a, b in self.host:
            if a <= t <= b and (best is None or b - a < best[2] - best[1]):
                best = (name, a, b)
        return best[0][:160] if best else "no host event"


def read_chrome_trace(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, lo, hi = [], [], None, None
    for e in events:
        if e.get("ph") != "X":
            continue
        a = float(e["ts"]) * 1e-6
        b = a + float(e.get("dur", 0.0)) * 1e-6
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            device.append((e["name"], a, b))
        elif cat in HOST_CATS:
            host.append((e["name"], a, b))
            if e["name"] == WINDOW_SPAN:
                lo, hi = a, b
    if lo is None:
        raise NoResult(f"the trace has no {WINDOW_SPAN} span")
    return Trace(device, host, lo, hi)


def host_per_step(call: Callable[[], int], device) -> float:
    """The host's seconds a step in one ``call`` (which returns its
    steps), started on an idle device and not waiting for it: what the
    host spends dispatching, apart from the device's time."""
    synchronize(device)
    t0 = time.perf_counter()
    steps = call()
    return (time.perf_counter() - t0) / steps


def traced(body: Callable[[], int], device) -> Trace:
    """Runs ``body`` (which returns its steps) under ``torch.profiler``,
    inside a ``WINDOW_SPAN`` annotation that ends after the device is
    done."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    synchronize(device)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            steps = body()
            synchronize(device)
    with tempfile.TemporaryDirectory(prefix="portbench_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        trace = read_chrome_trace(path)
    del prof
    trace.steps = steps
    if device.type == "cuda" and not trace.device:
        raise NoResult("the profiler recorded no device event")
    return trace


def read_metrics(cell: Cell, trace: Trace, context: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell from its reader
    (``metrics/<name>.py``: ``read(trace, context, patterns)``); a reader
    that finds nothing returns None and its metric is left out."""
    out = {}
    for metric in cell.per_layer():
        name = metric["name"]
        reader = load_module(HERE / "metrics" / f"{name}.py",
                             f"portbench_metric_{len(out)}")
        pattern_file = HERE / "metrics" / f"{name}.json"
        patterns = load_json(pattern_file) if pattern_file.is_file() else {}
        value = reader.read(trace, context, patterns)
        if value is not None:
            out[name] = {"value": value, "unit": metric["unit"]}
    return out


# ---------------------------------------------------------------------------
# The comparison and the result
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Check:
    """The numbers compared, each beside its limit."""
    numbers: Dict[str, Tuple[float, float]]
    failed: int

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.numbers.values()) \
            and self.failed == 0

    def summary(self) -> Dict[str, dict]:
        return {k: {"value": v, "limit": lim}
                for k, (v, lim) in self.numbers.items()}


def result_line(check: Check, attempted: int, metrics: dict, device: dict,
                breakdown: Optional[dict] = None) -> str:
    out = {"correct": check.correct, "attempted": attempted,
           "failed": check.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = check.summary()
    return json.dumps(out)
