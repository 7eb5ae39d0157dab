"""Optimizers as pure functions over nested dicts of tensors, the counterpart
of ``big_linear_algebra_tpu/nn/optim.py``.

The reference's optimizers are inline: plain SGD (model/mnist_nn.c:303-315)
and an *intended* Adam in cifar_unet — first/second-moment buffers are
allocated (``gm``/``gsm``, model/cifar_unet.c:1887-1888) but never used
(SURVEY.md §7.11). As in the JAX package, SGD and Adam (Kingma & Ba 2015
defaults) are (init, update) pairs that return new trees; only
``adam_update_at_`` updates in place.

- Moments live in at least f32 (``_acc_dtype``): bf16 stored parameters keep
  full-precision optimizer state, and f32/f64 parameters keep their own type.
- The bias corrections ``1 − b1**t`` and ``1 − b2**t`` are computed in f32
  from an f32 step, as the JAX package computes them even in f64 mode.
  (XLA's f32 ``pow`` on the CPU and torch's can differ by one ulp at some
  steps; they agree for the first 30.)
- ``adam_update_at`` is the same step for a CUDA graph
  (``utils/graphs.py``): the step is a device counter that indexes a table
  of the bias corrections of the steps ahead (``bias_corrections``), which
  the host computes exactly as ``adam_update`` does, so the two forms are
  bit-equal. (``adam_update`` copies its corrections from the host every
  step, which a capture cannot hold: the copy would be frozen into the
  graph.)
- ``adam_update_at_`` is that step in place, for a graph's static
  buffers: one hand-written pass (``csrc/adam.cu``) over every leaf, a
  few launches in all, bit-equal to ``adam_update_at`` in f32. It takes
  contiguous f32 leaves on one card and rounds nothing stochastically;
  ``TrainSteps`` keeps the functional form for f64, bf16 and CPU leaves.
- bf16 parameters can be written with stochastic rounding
  (``stochastic_round_bf16``), whose dither is the JAX package's counter hash
  (``_fmix32``) bit for bit: uint32 arithmetic emulated in int64, with every
  product split so that it stays below 2⁶³.
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable, List, Mapping, NamedTuple, Optional

import torch

from big_linear_algebra_tpu_torch.ops import cuda_utils

_MASK32 = 0xFFFFFFFF

# Kernel launches of ``adam_update_at_`` (``csrc/adam.cu``)
adam_launch_count = 0


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves of a nested dict, in its key order."""
    if isinstance(tree, Mapping):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _sorted_tree_map(fn: Callable[[Any], Any], tree):
    """``fn`` over the leaves of a nested dict, called in sorted key-path
    order (``jax.tree.flatten``'s order); the result keeps ``tree``'s own
    key order."""
    if isinstance(tree, Mapping):
        out = {k: _sorted_tree_map(fn, tree[k]) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    return fn(tree)


def sgd_update(params: Any, grads: Any, lr) -> Any:
    """θ ← θ − lr·g (model/mnist_nn.c:303-315's negative-scale + add)."""
    return tree_map(lambda p, g: p - lr * g, params, grads)


class AdamState(NamedTuple):
    step: int         # steps taken
    m: Any            # first moments  (the reference's unused ``gm``)
    v: Any            # second moments (the reference's unused ``gsm``)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Moment and update dtype for a parameter leaf: at least f32."""
    return torch.promote_types(dtype, torch.float32)


def adam_init(params: Any) -> AdamState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=_acc_dtype(p.dtype),
                           device=p.device)

    return AdamState(step=0, m=tree_map(zeros, params),
                     v=tree_map(zeros, params))


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h · c) mod 2³² for h in [0, 2³²) (int64) and a uint32 constant c,
    in two halves of h so that no product passes 2⁶³."""
    lo = (h & 0xFFFF) * c
    hi = (((h >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def stochastic_round_bf16(x32: torch.Tensor, seed,
                          index: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """f32 → bf16 with stochastic rounding: dither the 16 low mantissa bits
    with a counter hash of the element index and ``seed``, then truncate,
    so E[rounded] = x (round-to-nearest bf16 writes lose updates below half
    an ulp of the weight). ``seed``: a uint32 value, as an int or an int64
    tensor on x's device. ``index``: each element's index (int64, x's
    shape) when x is a slice of a larger leaf, so that the slice rounds as
    the whole leaf would; default ``arange``. Bit for bit the JAX package's
    function."""
    x32 = x32.to(torch.float32).contiguous()
    u = x32.view(torch.int32).to(torch.int64) & _MASK32
    idx = index if index is not None else torch.arange(
        x32.numel(), dtype=torch.int64, device=x32.device).reshape(x32.shape)
    seed = torch.as_tensor(seed, dtype=torch.int64, device=x32.device)
    r = _fmix32(_mul32(idx, 2654435761) ^ (seed & _MASK32)) & 0xFFFF
    trunc = (u + r) & 0xFFFF0000
    # back to int32 bits (two's complement), then the truncated f32, which
    # bf16 holds exactly: the narrowing is not a second rounding
    bits = (trunc - ((trunc >> 31) << 32)).to(torch.int32)
    return bits.view(torch.float32).to(torch.bfloat16)


def leaf_seeds(base, n: int) -> List[Any]:
    """Per-leaf dither seeds from one uint32 ``base`` (an int or an int64
    tensor), as the JAX package derives them from a key's words:
    ``_fmix32(base ^ (0x9E3779B9·i mod 2³²))``."""
    base = torch.as_tensor(base, dtype=torch.int64)
    return [_fmix32(base ^ ((0x9E3779B9 * i) & _MASK32)) for i in range(n)]


def _bias_correction(step: int, b1: float, b2: float) -> torch.Tensor:
    """(1 − b1**t, 1 − b2**t) at t = ``step``, in f32 on the CPU from an f32
    t (the JAX package's arithmetic)."""
    t = torch.tensor(float(step), dtype=torch.float32)
    return torch.stack([1 - torch.pow(b1, t), 1 - torch.pow(b2, t)])


def bias_corrections(first_step: int, n: int, b1: float = 0.9,
                     b2: float = 0.999) -> torch.Tensor:
    """The bias corrections of steps ``first_step`` … ``first_step + n − 1``
    (1-based, as ``AdamState.step`` after the update): an (n, 2) f32 table
    on the CPU, row i = (1 − b1**t, 1 − b2**t) at t = first_step + i. Each
    row is computed as ``adam_update`` computes its own (one scalar pow at a
    time: a vectorized pow can round otherwise)."""
    rows = [_bias_correction(first_step + i, b1, b2) for i in range(n)]
    return (torch.stack(rows) if rows
            else torch.zeros((0, 2), dtype=torch.float32))


def _adam_core(params: Any, grads: Any, m: Any, v: Any, bc1, bc2, lr,
               b1: float, b2: float, eps: float, sr_seed, sr_index):
    """The update of ``adam_update`` given the bias corrections ``bc1``,
    ``bc2`` (0-dim f32 tensors on the moments' device): (params, m, v)."""
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(m_.dtype), m, grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
        g.to(v_.dtype)), v, grads)

    def write(p, m_, v_, seed=None, index=None):
        new = p.to(m_.dtype) - lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
        if seed is not None and p.dtype == torch.bfloat16:
            return stochastic_round_bf16(new, seed.to(new.device), index)
        return new.to(p.dtype)

    if sr_seed is None:
        new_params = tree_map(write, params, m, v)
    else:
        seeds = iter(leaf_seeds(sr_seed, len(tree_leaves(params))))
        seed_tree = _sorted_tree_map(lambda _: next(seeds), params)
        if sr_index is None:
            sr_index = tree_map(lambda _: None, params)
        new_params = tree_map(write, params, m, v, seed_tree, sr_index)
    return new_params, m, v


def adam_update(params: Any, grads: Any, state: AdamState, lr,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                sr_seed: Optional[Any] = None,
                sr_index: Optional[Any] = None):
    """One Adam step with bias correction. Returns (params, state).

    Moment and update arithmetic run in the moment dtype (≥ f32); the new
    value is rounded back to each leaf's own dtype. ``sr_seed``: when given
    (a uint32 base, int or int64 tensor), bf16 leaves are written with
    stochastic rounding, one derived seed per leaf (``leaf_seeds``), leaf
    *i* in sorted key-path order as the JAX package numbers them, whatever
    order the dict was built in; f32 and f64 leaves are untouched by it.
    ``sr_index``: a tree of element indices (or None leaves) for leaves that
    are slices of larger ones (``stochastic_round_bf16``'s ``index``)."""
    step = state.step + 1
    device = tree_leaves(state.m)[0].device
    bc1, bc2 = _bias_correction(step, b1, b2).to(device)
    new_params, m, v = _adam_core(params, grads, state.m, state.v, bc1, bc2,
                                  lr, b1, b2, eps, sr_seed, sr_index)
    return new_params, AdamState(step=step, m=m, v=v)


def adam_update_at(params: Any, grads: Any, state: AdamState,
                   counter: torch.Tensor, table: torch.Tensor, lr,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   sr_seed: Optional[Any] = None,
                   sr_index: Optional[Any] = None):
    """``adam_update`` with its bias corrections read on the device: row
    ``counter`` (a 0-dim int64 tensor) of ``table`` (``bias_corrections`` of
    the steps ahead, on the moments' device), so that nothing of the step
    is on the host and a CUDA graph can replay it. Bit-equal to
    ``adam_update`` at the row's step. Returns (params, state) with
    ``state.step`` one more; the counter is the caller's to advance."""
    bc1, bc2 = table.index_select(0, counter.reshape(1))[0]
    new_params, m, v = _adam_core(params, grads, state.m, state.v, bc1, bc2,
                                  lr, b1, b2, eps, sr_seed, sr_index)
    return new_params, AdamState(step=state.step + 1, m=m, v=v)


def _in_place_leaves(params: Any, grads: Any, m: Any,
                     v: Any) -> List[List[torch.Tensor]]:
    """The leaves of the four trees, which ``adam_update_at_`` writes or
    reads through their pointers: raises ValueError unless the trees
    match leaf for leaf in size and every leaf is a contiguous f32 tensor
    on one CUDA device."""
    trees = [tree_leaves(t) for t in (params, grads, m, v)]
    if len({len(leaves) for leaves in trees}) != 1:
        raise ValueError("adam_update_at_: trees of different lengths")
    if any(len({x.numel() for x in leaf}) != 1 for leaf in zip(*trees)):
        raise ValueError("adam_update_at_: leaves of different sizes")
    for leaf in (x for leaves in trees for x in leaves):
        if leaf.dtype != torch.float32:
            raise ValueError(f"adam_update_at_: a {leaf.dtype} leaf")
        if not leaf.is_contiguous():
            raise ValueError("adam_update_at_: a leaf that is not "
                             "contiguous")
    devices = {x.device for leaves in trees for x in leaves}
    if len(devices) > 1:
        raise ValueError("adam_update_at_: leaves on more than one device")
    for device in devices:
        if device.type != "cuda":
            raise ValueError(f"adam_update_at_: a leaf on the {device.type}")
    return trees


_P = ctypes.c_void_p
_ADAM_ARGS = [ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int64,
              ctypes.c_double, ctypes.c_double, ctypes.c_double,
              ctypes.c_double, ctypes.POINTER(ctypes.c_int), _P]


def adam_update_at_(params: Any, grads: Any, m: Any, v: Any,
                    counter: torch.Tensor, table: torch.Tensor, lr,
                    b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8) -> None:
    """``adam_update_at`` in place: the parameters ``params`` and the
    moments ``m``, ``v`` (trees of one structure with ``grads``) take their
    new values in their own storage, from the bias corrections of row
    ``counter`` (0-dim int64; a device assert outside the table, as
    ``index_select``'s) of ``table`` (f32, (rows, 2)), both read on the
    device. One hand-written pass over every leaf (``csrc/adam.cu``:
    up to 48 leaves a launch, each launch counted in
    ``adam_launch_count``), bit-equal to ``adam_update_at``. Raises
    ValueError unless the trees match and every leaf is a contiguous f32
    tensor on one CUDA device; the Adam step count and the counter are
    the caller's to advance."""
    global adam_launch_count
    trees = _in_place_leaves(params, grads, m, v)
    n = len(trees[0])
    if n == 0:
        return
    device = trees[0][0].device
    if (counter.dtype != torch.int64 or counter.numel() != 1
            or counter.device != device):
        raise ValueError("adam_update_at_: the counter is one int64 on "
                         f"{device}")
    if (table.dtype != torch.float32 or table.dim() != 2
            or table.shape[1] != 2 or not table.is_contiguous()
            or table.device != device):
        raise ValueError("adam_update_at_: the table is a contiguous (rows, "
                         f"2) f32 tensor on {device}")
    pointers = [(_P * n)(*(x.data_ptr() for x in leaves))
                for leaves in trees]
    sizes = (ctypes.c_int64 * n)(*(x.numel() for x in trees[0]))
    launches = ctypes.c_int(0)
    lib = cuda_utils.load_library("adam")
    fn = lib.bla_adam_update
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ADAM_ARGS
    with torch.cuda.device(device):
        rc = fn(n, *pointers, sizes, counter.data_ptr(), table.data_ptr(),
                table.shape[0], float(lr), b1, b2, eps,
                ctypes.byref(launches),
                torch.cuda.current_stream(device).cuda_stream)
    adam_launch_count += launches.value
    cuda_utils.check(lib, rc, "adam_update_at_ launch", *trees[0],
                     *trees[2], *trees[3])
