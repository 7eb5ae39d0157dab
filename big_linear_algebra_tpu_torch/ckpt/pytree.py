"""Train-state checkpoints, the counterpart of
``big_linear_algebra_tpu/ckpt/pytree.py``.

Training *is* resume in the reference — ``train`` loads existing weights,
updates, saves on exit (model/mnist_nn.c:165-170,371-376). As in the JAX
package, the whole train state is saved per step under
``<base_dir>/step_<n>/``, and a killed run restores the newest step and goes
on. The format is the port's own: ``torch.save`` of one dict (the JAX
package's orbax directories and these files cannot be read across packages;
the reference CSV tree is the interchange format).

- ``save_pytree``/``restore_pytree``/``latest_step``: one-shot save and
  restore. A save writes a temporary directory and renames it into place,
  so a crash mid-save never leaves a step that looks restorable.
- ``TrainCheckpointer``: keep-last-k retention, or the k steps of least
  metric (a loss) saved beside each step. Saves are synchronous.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path
from typing import Any, Optional

import torch

_STEP_RE = re.compile(r"^step_(\d+)$")
_STATE = "state.pt"
_METRICS = "metrics.json"


def _step_dir(base_dir, step: int) -> Path:
    return Path(base_dir) / f"step_{step}"


def all_steps(base_dir) -> list:
    """The complete steps under ``base_dir``, ascending. Partially written
    directories are skipped: only a finished save is renamed into place."""
    base = Path(base_dir)
    if not base.is_dir():
        return []
    return sorted(int(m.group(1)) for p in base.iterdir()
                  if (m := _STEP_RE.match(p.name)) and (p / _STATE).is_file())


def latest_step(base_dir) -> Optional[int]:
    steps = all_steps(base_dir)
    return steps[-1] if steps else None


def save_pytree(base_dir, step: int, tree: Any,
                metrics: Optional[dict] = None) -> None:
    """Save ``tree`` at ``base_dir/step_<step>`` (replacing one there),
    atomically."""
    path = _step_dir(base_dir, step)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    torch.save(tree, tmp / _STATE)
    if metrics is not None:
        (tmp / _METRICS).write_text(json.dumps(metrics))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)  # atomic within a filesystem


def restore_pytree(base_dir, step: Optional[int] = None,
                   map_location=None) -> Any:
    """The tree saved at ``step`` (default: the newest), its tensors on
    ``map_location``."""
    if step is None:
        step = latest_step(base_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {base_dir}")
    return torch.load(_step_dir(base_dir, step) / _STATE,
                      map_location=map_location, weights_only=True)


class TrainCheckpointer:
    """Retention over the steps under ``base_dir``.

    - ``max_to_keep``: retain at most k steps (None: all), the oldest
      dropped first;
    - ``best_metric``: when set (e.g. ``"loss"``), retention keeps the k
      steps of *least* metric instead, passed to ``save(..., metrics={...})``;
      steps saved without it are dropped.
    """

    def __init__(self, base_dir, max_to_keep: Optional[int] = 3,
                 best_metric: Optional[str] = None):
        self.base_dir = Path(base_dir)
        self.max_to_keep = max_to_keep
        self.best_metric = best_metric
        self.base_dir.mkdir(parents=True, exist_ok=True)

    def _metric(self, step: int) -> Optional[float]:
        f = _step_dir(self.base_dir, step) / _METRICS
        if not f.is_file():
            return None
        return json.loads(f.read_text()).get(self.best_metric)

    def save(self, step: int, tree: Any, metrics: Optional[dict] = None):
        save_pytree(self.base_dir, step, tree, metrics=metrics)
        steps = all_steps(self.base_dir)
        if self.best_metric is None:
            drop = steps[:-self.max_to_keep] if self.max_to_keep else []
        else:
            scored = [(self._metric(s), s) for s in steps]
            drop = [s for m, s in scored if m is None]
            ranked = sorted((m, s) for m, s in scored if m is not None)
            if self.max_to_keep:
                drop += [s for _, s in ranked[self.max_to_keep:]]
        for s in drop:
            shutil.rmtree(_step_dir(self.base_dir, s), ignore_errors=True)
