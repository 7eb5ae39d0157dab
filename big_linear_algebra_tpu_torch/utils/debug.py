"""Runtime-validation helpers, the counterpart of
``big_linear_algebra_tpu/utils/debug.py`` (≈ the reference's safety net,
SURVEY.md §5: AddressSanitizer, -Wall -Werror, printf-and-exit checks).

The JAX package wraps JAX's own switches (``jax_debug_nans``,
``jax.disable_jit``, ``checkify``). The port has neither a tracer nor a
jit, so it ports what they give, not how:

- ``debug_nans``: a ``TorchDispatchMode`` that checks the floating outputs
  of every ATen op for NaN and raises ``FloatingPointError`` naming the op.
  It sees the ops of autograd's backward too. The hand-written CUDA kernels
  are launched through ctypes, which no dispatch mode sees, so
  ``ops/cuda_utils.check`` hands each launch's outputs to
  ``check_launch``, which checks them under the same mode;
- ``no_jit``: op-by-op execution, so that a fault surfaces at the op that
  caused it: every ATen op and every kernel launch is followed by
  ``torch.cuda.synchronize()`` when it touched a CUDA tensor;
- ``checked(fn)``: ``fn`` under both;
- ``validate_finite``: a host-side check of a tree of tensors or arrays.

The checks only read: a run under them computes bit for bit what it
computes without them.

Under either mode the steps the models would replay as a CUDA graph
(``utils/graphs.py``) run eagerly instead (``active``): a check runs
between two ops, and a graph replays its ops with no Python between them,
so a graph would check nothing (and a capture cannot synchronize, read a
value to the host or raise at an op). JAX's ``disable_jit`` likewise turns
a ``lax.scan`` into a Python loop. Outputs of the ops that return uninitialized memory
(``empty`` and its kin, ``resize_``, ``set_``) are not checked, nor views,
which compute nothing: the tensor a view aliases was checked when it was
computed. An ``out=`` or in-place op is checked after it has run.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _disable_current_modes,
    _get_current_dispatch_mode_stack,
)
from torch.utils._pytree import tree_flatten

_aten = torch.ops.aten
# Ops whose outputs hold whatever the allocator returned.
_UNINITIALIZED = frozenset({
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten.resize_, _aten.set_})


class _CheckMode(TorchDispatchMode):
    """Runs each ATen op, then checks its floating outputs for NaN
    (``nans``) and synchronizes the device after it (``sync``). Inside
    ``__torch_dispatch__`` the mode is off, so its own checks do not
    recurse into it."""

    def __init__(self, nans: bool, sync: bool):
        super().__init__()
        self.nans, self.sync = nans, sync

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket in _UNINITIALIZED \
                or func is _aten._unsafe_view.default:
            return out
        self.after(str(func), _tensors(out),
                   _tensors((args, kwargs)) if self.sync else ())
        return out

    def after(self, what: str, outputs: Iterable[torch.Tensor],
              inputs: Iterable[torch.Tensor] = ()) -> None:
        outputs = list(outputs)
        if self.nans:
            for t in outputs:
                if (t.is_floating_point() and t.layout == torch.strided
                        and t.device.type != "meta"
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(
                        f"NaN in the output of {what} "
                        f"(shape {tuple(t.shape)}, {t.dtype}, {t.device})")
        if self.sync and any(t.is_cuda for t in (*outputs, *inputs)):
            torch.cuda.synchronize()


def _tensors(tree) -> Iterator[torch.Tensor]:
    return (x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor))


def _active() -> Iterator[_CheckMode]:
    return (m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, _CheckMode))


def active() -> bool:
    """Whether ``debug_nans`` or ``no_jit`` is on: the models then run
    their steps eagerly, not as a CUDA graph."""
    return next(_active(), None) is not None


def check_launch(what: str, outputs: Tuple[Optional[torch.Tensor], ...]
                 ) -> None:
    """Apply every active ``debug_nans``/``no_jit`` check to the outputs of
    a kernel launch (``ops/cuda_utils.check`` calls it after each launch);
    nothing happens outside them. ``None`` entries are skipped."""
    outputs = [t for t in outputs if t is not None]
    modes = list(_active())
    if not modes:
        return
    # the checks' own ops run with the modes off, as in __torch_dispatch__
    with _disable_current_modes():
        for mode in modes:
            mode.after(what, outputs)


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise ``FloatingPointError`` at the first ATen op or kernel launch
    whose floating output holds a NaN, naming it (``jax_debug_nans``).
    ``enable=False`` adds no check (it does not switch off an enclosing
    ``debug_nans``)."""
    if not enable:
        yield
        return
    with _CheckMode(nans=True, sync=False):
        yield


@contextlib.contextmanager
def no_jit():
    """Run op by op (``jax.disable_jit``): the device is synchronized after
    every ATen op and kernel launch on a CUDA tensor, so that an error is
    raised at the op that caused it."""
    with _CheckMode(nans=False, sync=True):
        yield


def checked(fn):
    """``fn`` run under ``debug_nans`` and ``no_jit``, returning its result
    (``checkify``'s wrapper). Usage::

        safe_step = checked(train_step)
        out = safe_step(model, x, onehot, mask)   # FloatingPointError on NaN
    """

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with debug_nans(), no_jit():
            return fn(*args, **kwargs)

    return wrapper


def _leaves(tree: Any, path: str = ""):
    """(path, leaf) in ``jax.tree_util``'s order (dict keys sorted), the
    path spelled as ``jax.tree_util.keystr`` spells it: ``['a'][0]``."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def validate_finite(tree: Any, name: str = "pytree") -> None:
    """Host-side: raise ``FloatingPointError`` naming the first leaf (in
    ``jax.tree_util``'s order) that holds a non-finite value. Leaves are
    tensors, numpy arrays or numbers."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            finite = bool(torch.isfinite(leaf.detach()).all())
        else:
            finite = bool(np.isfinite(np.asarray(leaf)).all())
        if not finite:
            raise FloatingPointError(
                f"{name}{path} contains non-finite values")
