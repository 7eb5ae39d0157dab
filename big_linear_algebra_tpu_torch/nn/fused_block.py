"""The U-Net's whole resnet block as one kernel per direction, the
counterpart of ``big_linear_algebra_tpu/nn/fused_block.py`` (opt-in with
``cifar_unet --fused-block``, for the blocks at H·W ≤ 64).

The block (``_forward_resnet``, model/cifar_unet.c:1044-1072):

    GN → ReLU → conv3×3 → +td → GN → ReLU → dropout → conv3×3 → +residual

with td = temb·time_w + time_b computed outside (the JAX package does the
same), and the residual x itself or a 1×1 conv w3 of it when the channels
change.

- ``fused_resnet_block`` is a ``torch.autograd.Function``. On a CUDA tensor
  the forward launches K5a (the TPU's ``_fused_fwd_kernel``) on one of two
  routes, by a fixed rule (``_fwd_route``): bf16 shapes that
  ``_tc_plan`` admits (every full-width U-Net block) go to the tensor-core
  kernel (``csrc/fused_block_tc.cu``); f32, and bf16 shapes it does not
  take (the TINY blocks), to the FMA kernel (``csrc/fused_block.cu``),
  which keeps f32 true f32. The backward launches K5b (the TPU's
  recompute backward ``_fused_bwd_kernel``) as two kernels on one of two
  routes, by a fixed rule (``_bwd_route``): bf16 shapes that
  ``_bwd_tc_plan`` admits (every block of the full-width train step) go to
  the tensor-core kernels of ``csrc/fused_block_tc.cu``; f32, and the TINY
  blocks, to the FMA kernels of ``csrc/fused_block.cu``. First its
  data-gradient kernel, which recomputes the forward and leaves the
  rounded a1, d and dh1t of every example in workspaces (bf16 on the
  tensor-core route, f32 on the FMA route), then its weight-gradient
  kernel, which sums the per-example products over the batch. On a CPU
  tensor the plain versions ``_plain_fused_fwd`` and
  ``_plain_fused_bwd`` run. On a CUDA tensor a kernel launches or the call
  raises: there is no fallback.
- Only (x, td, w1, w2, w3, seed) are saved; the backward recomputes the
  rest, as the TPU kernel does.
- Arithmetic of the JAX kernel body (``_fwd_body``, ``_fused_bwd_kernel``):
  GN with one-pass statistics var = max(E[x²] − mean², 0) and
  rsqrt(var + eps); the operands of every product (the ReLU'd GN output a1,
  the dropout output d, x for the 1×1 conv, the cotangent g and dh1t)
  rounded to the compute dtype first, with sums and statistics in f32 (f64
  in the plain version's f64 mode, which the gate never dispatches).
- Dropout: keep iff bits ≥ rate·2³², survivors scaled by 1/(1 − rate) in
  f32 (``_mask_from_bits``). The bits are a counter hash of (seed, index in
  the packed (F, B·H·W) layout), murmur3's finalizer over the index times
  the golden ratio, keyed by the finalized seed: the kernels and
  ``_dropout_bits`` compute the same bits, and the backward regenerates the
  forward's mask. The stream differs from the TPU's hardware PRNG, as
  ``--prng`` streams differ. ``bits`` (F, B·H·W) may be passed instead on
  the CPU, so that tests can inject the JAX package's.
- ``supported`` is the JAX package's shape gate, with its formula and
  constants, so that the same blocks dispatch in both packages.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from big_linear_algebra_tpu_torch.nn.optim import _MASK32, _fmix32, _mul32
from big_linear_algebra_tpu_torch.ops import cuda_utils
from big_linear_algebra_tpu_torch.ops.precision import accum_dtype

# The JAX package's VMEM limit (nn/fused_block.py:55); its gate admits a
# block whose working set takes at most half of it.
_VMEM_LIMIT = 96 * 1024 * 1024
_GOLDEN = 0x9E3779B1

# Kernel launches since import (or since a caller last set them to 0): K5a,
# K5b's data-gradient kernel and K5b's weight-gradient kernel (each on both
# routes), each counted only where it is launched; and the launches of each
# on the tensor-core route alone.
launch_count = 0
bwd_launch_count = 0
wgrad_launch_count = 0
tc_launch_count = 0
bwd_tc_launch_count = 0
wgrad_tc_launch_count = 0

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# What csrc/fused_block.cu takes (its THREADS, MAX_OUT, IC, the shared
# memory of an H100 block): kernels of 1x1 or 3x3, H·W of 16, 32 or 64, at
# most 16 output channels per thread, clusters of at most 8 blocks.
_THREADS = 256
_MAX_OUT = 16
_STAGE_CHANNELS = 16
_MAX_SMEM = 232448
_MAX_CLUSTER = 8
# What csrc/fused_block_tc.cu takes (its constants of the same names): 256
# threads; clusters of 16 blocks at B <= _TC_SMALL_BATCH, else 8; weight
# chunks of 32 input channels x 9 taps staged in a three-slot ring of rows
# of 296 bf16; partial tiles of H·W + 4 f32 a row.
_TC_THREADS = 256
_TC_MAX_CLUSTER = 16
_TC_SMALL_BATCH = 4
_TC_CHUNK = 32
_TC_RING_ROW = 296
_TC_RING_SLOTS = 3
_TC_PART_PAD = 4
# What the tensor-core data-gradient kernel of K5b takes (the constants of
# csrc/fused_block_tc.cu of the same names, BWD_*): clusters of 8 blocks;
# each thread holds at most 8 values of GN 2's x̂ and 16 of the C slice.
_BWD_TC_CLUSTER = 8
_BWD_TC_MAX_EF = 8
_BWD_TC_MAX_EC = 16


def supported(x_shape, in_ch: int, out_ch: int, k: int, group_size: int,
              dtype: torch.dtype) -> bool:
    """The JAX package's shape gate (nn/fused_block.py ``supported``): odd
    kernels, channels in whole groups, no f64, and the block's working set
    (~12 (Cmax, B·H·W) f32 buffers, two tap sets, f32 tap-gradient
    accumulators) within half the TPU's VMEM limit."""
    b, c, h, w = x_shape
    if k % 2 == 0 or c != in_ch:
        return False
    if c % group_size or out_ch % group_size:
        return False
    if dtype.itemsize > 4:
        return False
    bhw = b * h * w
    cm = max(in_ch, out_ch)
    need = 12 * cm * bhw * 4 + 2 * k * k * in_ch * out_ch * 6 + \
        2 * k * k * cm * cm * 4
    return need <= _VMEM_LIMIT // 2


# ---------------------------------------------------------------------------
# Layouts and dropout bits
# ---------------------------------------------------------------------------


def _unpack(xp: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    """The packed (C, B·H·W) layout of the dropout bits → (B, C, H, W)."""
    return xp.reshape(xp.shape[0], b, h, w).transpose(0, 1)


def _seed_tensor(seed, device) -> torch.Tensor:
    """``seed`` (an int32 value: an int or an integer tensor) as the (1,)
    int32 tensor the kernels read, on ``device``. An int is filled in on
    the device: a copy from the host would synchronise the stream."""
    if isinstance(seed, torch.Tensor):
        return seed.reshape(1).to(device, torch.int32)
    return torch.full((1,), seed, dtype=torch.int32, device=device)


def _dropout_bits(seed: torch.Tensor, n: int) -> torch.Tensor:
    """The n dropout bits of ``seed`` (uint32 values in int64, on the
    seed's device): fmix32(i·0x9E3779B1 ^ fmix32(seed)) for i < n, the
    kernels' hash (uint32 arithmetic emulated as in ``nn/optim.py``)."""
    key = _fmix32(seed.to(torch.int64) & _MASK32)
    idx = torch.arange(n, dtype=torch.int64, device=seed.device)
    return _fmix32(_mul32(idx, _GOLDEN) ^ key)


def _threshold(rate: float) -> int:
    """keep iff bits ≥ rate·2³² (the JAX package's ``_mask_from_bits``)."""
    return min(int(rate * float(2 ** 32)), 2 ** 32 - 1)


def _keep_scale(rate: float) -> float:
    """1/(1 − rate) as f32 divides it (the survivors' scale)."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def _dropout_mask(seed, bits, rate, shape, dtype) -> torch.Tensor:
    """keep·1/(1 − rate) in ``dtype``, (B, F, H, W), from ``bits`` (F, B·H·W)
    or, when None, from the hash of ``seed``."""
    b, f, h, w = shape
    if bits is None:
        bits = _dropout_bits(seed, f * b * h * w)
    keep = bits.to(torch.int64).reshape(f, b * h * w) >= _threshold(rate)
    return _unpack(keep.to(dtype) / torch.tensor(1.0 - rate, dtype=dtype),
                   b, h, w)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _gn_stats(xs: torch.Tensor, gsz: int, eps: float):
    """One-pass GroupNorm statistics of (B, C, H, W) in its dtype: (x̂, rstd)
    with var = max(E[x²] − mean², 0) and rstd = rsqrt(var + eps), rstd
    (B, groups, 1)."""
    b, c, h, w = xs.shape
    v = xs.reshape(b, c // gsz, gsz * h * w)
    n = gsz * h * w
    mean = v.sum(-1, keepdim=True) / n
    var = torch.clamp((v * v).sum(-1, keepdim=True) / n - mean * mean,
                      min=0.0)
    rstd = torch.rsqrt(var + eps)
    return ((v - mean) * rstd).reshape(xs.shape), rstd


def _gn_bwd(g: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor,
            gsz: int) -> torch.Tensor:
    """(g − mean_group(g) − x̂·mean_group(g·x̂))·rstd."""
    b, c, h, w = g.shape
    n = gsz * h * w
    gv = g.reshape(b, c // gsz, n)
    xv = xhat.reshape(b, c // gsz, n)
    gm = gv.sum(-1, keepdim=True) / n
    gxm = (gv * xv).sum(-1, keepdim=True) / n
    return ((gv - gm - xv * gxm) * rstd).reshape(g.shape)


def _tap_grads(inp: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """dW[f, c, kh, kw] = Σ_{b,t} inp[b, c, t + tap]·g[b, f, t] ("same"
    zero padding): the weight gradient of a stride-1 conv."""
    b, c = inp.shape[:2]
    cols = F.unfold(inp, k, padding=k // 2)               # (B, C·k², H·W)
    dw = torch.einsum("bft,bkt->fk", g.flatten(2), cols)
    return dw.reshape(g.shape[1], c, k, k)


def _common(x, td, w1, w2, w3):
    """The operands in the block's dtype (the promotion of x's and w1's),
    and that dtype's accumulation type."""
    dt = torch.promote_types(x.dtype, w1.dtype)
    cast = (a if a is None else a.to(dt) for a in (x, td, w1, w2, w3))
    return (*cast, dt, accum_dtype(dt))


def _plain_parts(x, td, w1, w2, seed, gsz, rate, train, eps, bits):
    """The forward math up to conv_2's input, on operands in the block's
    dtype: (xs, x̂1, rstd1, a1, x̂2, rstd2, mask or None, d), with a1 and d
    rounded to the block's dtype as the products take them."""
    dt, acc = x.dtype, accum_dtype(x.dtype)
    k = w1.shape[-1]
    xs = x.to(acc)
    xhat1, rstd1 = _gn_stats(xs, gsz, eps)
    a1 = torch.relu(xhat1).to(dt).to(acc)
    h1t = F.conv2d(a1, w1.to(acc), padding=k // 2) \
        + td.to(acc)[:, :, None, None]
    xhat2, rstd2 = _gn_stats(h1t, gsz, eps)
    d = torch.relu(xhat2)
    mask = None
    if train and rate > 0.0:
        mask = _dropout_mask(seed, bits, rate, h1t.shape, acc)
        d = d * mask
    return xs, xhat1, rstd1, a1, xhat2, rstd2, mask, d.to(dt).to(acc)


def _plain_fused_fwd(x, td, w1, w2, w3, seed, gsz, rate, train, eps,
                     bits=None) -> torch.Tensor:
    """The plain PyTorch version of K5a: the block's output (B, F, H, W) in
    the block's dtype."""
    x, td, w1, w2, w3, dt, acc = _common(x, td, w1, w2, w3)
    xs, *_, d = _plain_parts(x, td, w1, w2, seed, gsz, rate, train, eps,
                             bits)
    h2 = F.conv2d(d, w2.to(acc), padding=w2.shape[-1] // 2)
    res = xs if w3 is None else F.conv2d(xs, w3.to(acc))
    return (h2 + res).to(dt)


def _plain_fused_bwd(x, td, w1, w2, w3, seed, gsz, rate, train, eps, g,
                     bits=None):
    """The plain PyTorch version of K5b: (dx, d_td, dw1, dw2, dw3 or None),
    each in its input's dtype, from the recomputed forward."""
    dtypes = [a if a is None else a.dtype for a in (x, td, w1, w2, w3)]
    x, td, w1, w2, w3, dt, acc = _common(x, td, w1, w2, w3)
    k = w1.shape[-1]
    xs, xhat1, rstd1, a1, xhat2, rstd2, mask, d = _plain_parts(
        x, td, w1, w2, seed, gsz, rate, train, eps, bits)
    g = g.to(dt).to(acc)
    # conv_2, then dropout, ReLU 2 and GN 2
    dw2 = _tap_grads(d, g, k)
    dd = F.conv_transpose2d(g, w2.to(acc), padding=k // 2)
    if mask is not None:
        dd = dd * mask
    dh1t = _gn_bwd(dd * (xhat2 > 0), xhat2, rstd2, gsz)
    d_td = dh1t.sum(dim=(2, 3))
    # conv_1, then ReLU 1 and GN 1
    dh1t = dh1t.to(dt).to(acc)
    dw1 = _tap_grads(a1, dh1t, k)
    da1 = F.conv_transpose2d(dh1t, w1.to(acc), padding=k // 2)
    dx = _gn_bwd(da1 * (xhat1 > 0), xhat1, rstd1, gsz)
    # residual
    dw3 = None
    if w3 is None:
        dx = dx + g
    else:
        dw3 = torch.einsum("bft,bct->fc", g.flatten(2), xs.flatten(2))
        dx = dx + F.conv_transpose2d(g, w3.to(acc))
        dw3 = dw3.reshape(w3.shape).to(dtypes[4])
    return (dx.to(dtypes[0]), d_td.to(dtypes[1]), dw1.to(dtypes[2]),
            dw2.to(dtypes[3]), dw3)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _plan(b, c, f, h, w, k, gsz) -> Tuple[int, int]:
    """(cluster size, shared-memory bytes) of K5a/K5b's data-gradient
    kernel for one example's block; raises on a shape the kernels do not
    take. A cluster of nc blocks shares an example: block r owns output
    channels [r·F/nc, (r+1)·F/nc) and input channels [r·C/nc, (r+1)·C/nc),
    each a whole number of groups."""
    hw = h * w
    if k not in (1, 3):
        raise ValueError(f"fused_resnet_block: the kernels take 1x1 or 3x3 "
                         f"convs, got {k}x{k}")
    if hw not in (16, 32, 64):
        raise ValueError(f"fused_resnet_block: the kernels take H·W of 16, "
                         f"32 or 64, got {h}x{w}")
    if c % gsz or f % gsz:
        raise ValueError(f"fused_resnet_block: channels {c}, {f} are not "
                         f"whole groups of {gsz}")
    if not 0 < b <= 65535:
        raise ValueError(f"fused_resnet_block: the kernels take 1 <= B <= "
                         f"65535, got {b}")
    groups = math.gcd(c // gsz, f // gsz)
    nc = max(d for d in range(1, _MAX_CLUSTER + 1) if groups % d == 0)
    fs, cs = f // nc, c // nc
    m = max(fs, cs)
    # a thread's output channels: the power of two >= m / (threads a token
    # has); the staged taps' rows hold runs * nj + 4 floats
    runs = _THREADS // hw
    nj = 1 << max(0, math.ceil(math.log2(-(-m // runs))))
    if nj > _MAX_OUT:
        raise ValueError(f"fused_resnet_block: {m} channels per block of "
                         f"{hw} tokens exceed {_MAX_OUT} outputs per thread")
    floats = (max(c, f) * hw + _STAGE_CHANNELS * k * k * (runs * nj + 4)
              + 2 * m * hw + 2 * (c // gsz) + 2 * (f // gsz)
              + 2 * (m // gsz))
    if floats * 4 > _MAX_SMEM:
        raise ValueError(f"fused_resnet_block: {floats * 4} bytes of shared "
                         f"memory exceed {_MAX_SMEM}")
    return nc, floats * 4


@functools.lru_cache(maxsize=None)
def _tc_plan(b, c, f, h, w, k, gsz) -> Tuple[int, int]:
    """(cluster size, shared-memory bytes) of the tensor-core K5a
    (``csrc/fused_block_tc.cu`` ``tc_plan``) for one example's block;
    raises on a shape it does not take: 3x3 convs on 8×8 or 4×4 maps,
    channels and group size powers of two (channels ≥ 32), the U-Net's
    full-width blocks. A cluster of nc blocks (16 at B ≤ 4, else 8, at
    most F/16) shares an example: block r owns output channels [r·mb,
    (r+1)·mb), mb = F/nc, a whole fraction of one GN group (mb ≤ group
    size)."""
    def pow2(v):
        return v > 0 and v & (v - 1) == 0

    why = None
    if k != 3:
        why = f"3x3 convs, got {k}x{k}"
    elif h != w or h not in (4, 8):
        why = f"8x8 or 4x4 maps, got {h}x{w}"
    elif not (pow2(c) and pow2(f) and min(c, f) >= _TC_CHUNK):
        why = f"channels powers of two >= {_TC_CHUNK}, got {c} -> {f}"
    elif not (pow2(gsz) and gsz <= min(c, f)):
        why = f"groups of a power of two of channels, got {gsz}"
    elif not 0 < b <= 65535:
        why = f"1 <= B <= 65535, got {b}"
    if why is None:
        nc = min(f // 16, _TC_MAX_CLUSTER if b <= _TC_SMALL_BATCH else 8)
        mb = f // nc
        warps = _TC_THREADS // 32
        if warps % (mb // 16) or mb > gsz:
            why = (f"{mb} output channels a block in {warps} warps, within "
                   f"one group of {gsz}")
    if why is not None:
        raise ValueError(f"fused_resnet_block: the tensor-core kernel takes "
                         f"{why}")
    # the conv input (or, on the same bytes, the warps' partial tiles and
    # the summed tile), the weight ring, the GN statistics, the warps' GN 2
    # sums and td, and an identity residual
    hw = h * w
    act = (h + 2) * (w + 2) * (max(c, f) + 8) * 2
    scratch = (warps // (mb // 16) + 1) * mb * (hw + _TC_PART_PAD) * 4
    smem = (-(-max(act, scratch) // 16) * 16
            + _TC_RING_SLOTS * mb * _TC_RING_ROW * 2
            + -(-(2 * (c // gsz) + 4 + 2 * warps + mb) * 4 // 16) * 16
            + mb * hw * 2)
    if smem > _MAX_SMEM:
        raise ValueError(f"fused_resnet_block: {smem} bytes of shared memory "
                         f"exceed {_MAX_SMEM}")
    return nc, smem


@functools.lru_cache(maxsize=None)
def _fwd_route(dtype, b, c, f, h, w, k, gsz) -> str:
    """K5a's route, a fixed rule: "tc" (the tensor-core kernel) for bf16
    shapes ``_tc_plan`` admits, else "fma" (``csrc/fused_block.cu``'s
    kernel, which keeps f32 true f32); raises on a shape neither takes."""
    if dtype == torch.bfloat16:
        try:
            _tc_plan(b, c, f, h, w, k, gsz)
            return "tc"
        except ValueError:
            pass
    _plan(b, c, f, h, w, k, gsz)
    return "fma"


@functools.lru_cache(maxsize=None)
def _bwd_tc_plan(b, c, f, h, w, k, gsz) -> Tuple[int, int]:
    """(cluster size, shared-memory bytes) of K5b's tensor-core
    data-gradient kernel (``csrc/fused_block_tc.cu`` ``bwd_tc_plan``) for
    one example's block; raises on a shape it does not take: 3x3 convs on
    8×8 or 4×4 maps, channels and group size powers of two. A cluster of 8
    blocks shares an example: block r owns output channels [r·mb, (r+1)·mb)
    of h1t, dd and dh1t (mb = F/8) and input channels [r·cb, (r+1)·cb) of
    da1 and dx (cb = C/8), each 16 to 128 channels and a whole number of GN
    groups, so that every GN sum stays in one block; a pass of the block's
    256 threads over a slice lies in one group (group size · H·W ≥ 256); a
    thread holds at most 8 of GN 2's x̂ (mb·H·W ≤ 2048) and 16 values of the
    C slice (cb·H·W ≤ 4096)."""
    def pow2(v):
        return v > 0 and v & (v - 1) == 0

    hw = h * w
    nc = _BWD_TC_CLUSTER
    mb, cb = f // nc, c // nc
    warps = _TC_THREADS // 32
    why = None
    if k != 3:
        why = f"3x3 convs, got {k}x{k}"
    elif h != w or h not in (4, 8):
        why = f"8x8 or 4x4 maps, got {h}x{w}"
    elif not (pow2(c) and pow2(f) and 16 * nc <= min(c, f)
              and max(c, f) <= 128 * nc):
        why = (f"channels powers of two from {16 * nc} to {128 * nc}, got "
               f"{c} -> {f}")
    elif not (pow2(gsz) and gsz <= min(mb, cb)
              and gsz * hw >= _TC_THREADS and gsz >= 8):
        why = (f"groups of a power of two of channels within a block's "
               f"{min(mb, cb)} and of at least {max(8, _TC_THREADS // hw)}, "
               f"got {gsz}")
    elif (mb * hw > _BWD_TC_MAX_EF * _TC_THREADS
          or cb * hw > _BWD_TC_MAX_EC * _TC_THREADS):
        why = (f"at most {_BWD_TC_MAX_EF * _TC_THREADS} of F's and "
               f"{_BWD_TC_MAX_EC * _TC_THREADS} of C's values a block, got "
               f"{mb * hw} and {cb * hw}")
    elif not 0 < b <= 65535:
        why = f"1 <= B <= 65535, got {b}"
    if why is not None:
        raise ValueError(f"fused_resnet_block: the tensor-core backward "
                         f"takes {why}")
    # the conv input (or, on the same bytes, the warps' partial tiles and
    # the staged dh1t), the weight ring of max(mb, cb) rows, then the GN
    # statistics, the warps' group sums, td and d_td's partial sums
    ldp = hw + _TC_PART_PAD
    act = (h + 2) * (w + 2) * (max(c, f) + 8) * 2
    scratch = max((warps // (mb // 16) + 1) * mb * ldp * 4,
                  warps // (cb // 16) * cb * ldp * 4)
    groups = max(mb, cb) // gsz
    stats = (2 * (c // gsz) + 2 * (mb // gsz) + 2 * warps * groups
             + 2 * groups + mb + mb * hw // min(hw, 32))
    smem = (-(-max(act, scratch) // 16) * 16
            + _TC_RING_SLOTS * max(mb, cb) * _TC_RING_ROW * 2
            + -(-stats * 4 // 16) * 16)
    if smem > _MAX_SMEM:
        raise ValueError(f"fused_resnet_block: {smem} bytes of shared memory "
                         f"exceed {_MAX_SMEM}")
    return nc, smem


@functools.lru_cache(maxsize=None)
def _bwd_route(dtype, b, c, f, h, w, k, gsz) -> str:
    """K5b's route, a fixed rule: "tc" (the tensor-core kernels) for bf16
    shapes ``_bwd_tc_plan`` admits, else "fma" (``csrc/fused_block.cu``'s
    kernels, which keep f32 true f32); raises on a shape neither takes. The
    weight gradients follow the data gradients' route."""
    if dtype == torch.bfloat16:
        try:
            _bwd_tc_plan(b, c, f, h, w, k, gsz)
            return "tc"
        except ValueError:
            pass
    _plan(b, c, f, h, w, k, gsz)
    return "fma"


def _check_kernel_operands(what, *tensors) -> None:
    x = tensors[0]
    if x.dtype not in _KERNEL_DTYPES or any(
            t.dtype != x.dtype for t in tensors):
        raise TypeError(f"{what}: the kernels take f32 or bf16 operands of "
                        f"one dtype, got {[t.dtype for t in tensors]}")
    if any(t.device != x.device or t.device.type != "cuda"
           for t in tensors):
        raise ValueError(f"{what}: kernel operands must share one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")


def _function(lib, name, argtypes):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


_P = ctypes.c_void_p
_I = ctypes.c_int
_SHAPE = [_I] * 9  # dtype, b, c, f, h, w, k, group size, cluster size
_DROP = [_I, ctypes.c_uint32, ctypes.c_float, ctypes.c_float, _P]
_TC_SHAPE = [_I] * 6  # b, c, f, h, w, group size


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _kernel_operands(what, x, td, w1, w2, w3, seed, gsz, rate, train, bits,
                     g=None, route="fma"):
    """The operands in the block's dtype, contiguous and checked, and the
    launch's leading arguments: (operands, seed tensor, shape args, dropout
    args without the stream). The shape args are those of the FMA kernels
    (``_plan``'s cluster size last), or with ``route`` "tc" those of the
    tensor-core kernels (b, c, f, h, w, group size; the caller checks its
    plan), whose operands are also made 16-byte aligned."""
    if bits is not None:
        raise ValueError(f"{what}: the kernels draw their own dropout bits; "
                         "caller bits are for the plain version on the CPU")
    x, td, w1, w2, w3, dt, _ = _common(x, td, w1, w2, w3)
    fix = cuda_utils.aligned if route == "tc" else torch.Tensor.contiguous
    ops = [fix(a) for a in (x, td, w1, w2)]
    ops.append(None if w3 is None else fix(w3))
    if g is not None:
        ops.append(fix(g.to(dt)))
    _check_kernel_operands(what, *(a for a in ops if a is not None))
    b, c, h, w = x.shape
    f, _, k, _ = w1.shape
    if route == "tc":
        args = [b, c, f, h, w, gsz]
    else:
        nc, _ = _plan(b, c, f, h, w, k, gsz)
        args = [_KERNEL_DTYPES[dt], b, c, f, h, w, k, gsz, nc]
    drop = bool(train and rate > 0.0)
    dropargs = [int(drop), _threshold(rate) if drop else 0,
                _keep_scale(rate) if drop else 1.0]
    return ops, _seed_tensor(seed, x.device), args, dropargs


def _kernel_fused_fwd(x, td, w1, w2, w3, seed, gsz, rate, train, eps,
                      bits=None, route=None) -> torch.Tensor:
    """K5a on CUDA tensors → the block's output (B, F, H, W), on the route
    ``_fwd_route`` gives ("tc": ``csrc/fused_block_tc.cu``, "fma":
    ``csrc/fused_block.cu``); ``route`` names one instead (to time both on
    one input); a shape that route does not take raises."""
    global launch_count, tc_launch_count
    if route is None:
        dt = torch.promote_types(x.dtype, w1.dtype)
        route = _fwd_route(dt, *x.shape[:2], w1.shape[0], *x.shape[2:],
                           w1.shape[-1], gsz)
    if route not in ("tc", "fma"):
        raise ValueError(f"fused_resnet_block: no K5a route {route!r}")
    (x, td, w1, w2, w3), seed, args, drop = _kernel_operands(
        "fused_resnet_block", x, td, w1, w2, w3, seed, gsz, rate, train,
        bits, route=route)
    b, c, h, w = x.shape
    f = w1.shape[0]
    if route == "tc":
        if x.dtype != torch.bfloat16:
            raise TypeError("fused_resnet_block: the tensor-core K5a takes "
                            f"bf16 operands, got {x.dtype}")
        _tc_plan(b, c, f, h, w, w1.shape[-1], gsz)
    out = torch.empty((b, f, h, w), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "tc":
        lib = cuda_utils.load_library("fused_block_tc")
        fn = _function(lib, "bla_fused_block_fwd_tc",
                       _TC_SHAPE + [_P] * 7 + _DROP)
        with torch.cuda.device(x.device):
            rc = fn(*args, _ptr(x), _ptr(td), _ptr(w1), _ptr(w2), _ptr(w3),
                    _ptr(seed), _ptr(out), *drop, eps, stream)
        cuda_utils.check(lib, rc, "fused_resnet_block tensor-core K5a launch",
                         out)
        tc_launch_count += 1
    else:
        ws = torch.empty((b, f, h * w), dtype=torch.float32, device=x.device)
        lib = cuda_utils.load_library("fused_block")
        fn = _function(lib, "bla_fused_block_fwd",
                       _SHAPE + [_P] * 8 + _DROP)
        with torch.cuda.device(x.device):
            rc = fn(*args, _ptr(x), _ptr(td), _ptr(w1), _ptr(w2), _ptr(w3),
                    _ptr(seed), _ptr(out), _ptr(ws), *drop, eps, stream)
        cuda_utils.check(lib, rc, "fused_resnet_block K5a launch", out)
    launch_count += 1
    return out


def _flipped_t(w: torch.Tensor) -> torch.Tensor:
    """(O, I, k, k) → (I, O, k, k), the taps flipped: a stride-1 "same"
    conv with them is the transposed conv with ``w`` (the JAX wrapper's
    ``_taps_t``), contiguous."""
    return w.flip(2, 3).transpose(0, 1).contiguous()


def _kernel_bwd_data(x, td, w1, w2, w3, seed, gsz, rate, train, eps, g,
                     bits=None, route=None):
    """K5b's data-gradient kernel on CUDA tensors, on the route
    ``_bwd_route`` gives ("tc": ``csrc/fused_block_tc.cu``, from w1 and the
    flipped, transposed copies of w2, w1 and w3; "fma":
    ``csrc/fused_block.cu``), or the one ``route`` names (to time both on
    one input) → (dx in the block's dtype, d_td in f32, work), where work
    holds what the weight-gradient kernel reads: (x, g, and the rounded a1,
    d and dh1t of every example in workspaces, bf16 on the tensor-core
    route and f32 on the FMA route)."""
    global bwd_launch_count, bwd_tc_launch_count
    b, c, h, w = x.shape
    f, _, k, _ = w1.shape
    if route is None:
        route = _bwd_route(torch.promote_types(x.dtype, w1.dtype), b, c, f,
                           h, w, k, gsz)
    if route not in ("tc", "fma"):
        raise ValueError(f"fused_resnet_block: no K5b route {route!r}")
    (x, td, w1, w2, w3, g), seed, args, drop = _kernel_operands(
        "fused_resnet_block backward", x, td, w1, w2, w3, seed, gsz, rate,
        train, bits, g, route=route)
    dev = x.device
    f32 = torch.float32
    dx = torch.empty_like(x)
    dtd = torch.empty((b, f), dtype=f32, device=dev)
    ws = [torch.empty((b, n, h * w), device=dev,
                      dtype=torch.bfloat16 if route == "tc" else f32)
          for n in (c, f, f)]  # a1, d, dh1t
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "tc":
        if x.dtype != torch.bfloat16:
            raise TypeError("fused_resnet_block backward: the tensor-core "
                            f"kernel takes bf16 operands, got {x.dtype}")
        _bwd_tc_plan(b, c, f, h, w, k, gsz)
        w1t, w2t = _flipped_t(w1), _flipped_t(w2)
        w3t = None if w3 is None else _flipped_t(w3)
        # w3ᵀ·g of the examples, f32, read back by the thread that wrote it
        res = None if w3 is None else torch.empty((b, c, h * w), dtype=f32,
                                                  device=dev)
        lib = cuda_utils.load_library("fused_block_tc")
        fn = _function(lib, "bla_fused_block_bwd_tc",
                       _TC_SHAPE + [_P] * 14 + _DROP)
        with torch.cuda.device(dev):
            rc = fn(*args, _ptr(x), _ptr(td), _ptr(w1), _ptr(w2t),
                    _ptr(w1t), _ptr(w3t), _ptr(seed), _ptr(g), _ptr(dx),
                    _ptr(dtd), *(_ptr(a) for a in ws), _ptr(res), *drop, eps,
                    stream)
        cuda_utils.check(lib, rc, "fused_resnet_block tensor-core K5b launch",
                         dx, dtd)
        bwd_tc_launch_count += 1
    else:
        lib = cuda_utils.load_library("fused_block")
        fn = _function(lib, "bla_fused_block_bwd", _SHAPE + [_P] * 12 + _DROP)
        with torch.cuda.device(dev):
            rc = fn(*args, _ptr(x), _ptr(td), _ptr(w1), _ptr(w2), _ptr(w3),
                    _ptr(seed), _ptr(g), _ptr(dx), _ptr(dtd),
                    *(_ptr(a) for a in ws), *drop, eps, stream)
        cuda_utils.check(lib, rc, "fused_resnet_block K5b launch", dx, dtd)
    bwd_launch_count += 1
    return dx, dtd, (x, g, *ws)


def _kernel_bwd_wgrad(work, k: int, has_w3: bool):
    """K5b's weight-gradient kernel on what the data-gradient kernel left
    (``work``), on that kernel's route: bf16 workspaces (the tensor-core
    route) go to ``csrc/fused_block_tc.cu``'s tensor-core kernel, f32 ones
    to ``csrc/fused_block.cu``'s FMA kernel → (dw1, dw2, dw3 or None) in
    f32, summed over the batch in a fixed order."""
    global wgrad_launch_count, wgrad_tc_launch_count
    x, g, ws_a1, ws_d, ws_dh = work
    b, c, h, w = x.shape
    f = ws_d.shape[1]
    dev = x.device
    dw1 = torch.empty((f, c, k, k), dtype=torch.float32, device=dev)
    dw2 = torch.empty((f, f, k, k), dtype=torch.float32, device=dev)
    dw3 = (torch.empty((f, c, 1, 1), dtype=torch.float32, device=dev)
           if has_w3 else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if ws_d.dtype == torch.bfloat16:
        lib = cuda_utils.load_library("fused_block_tc")
        fn = _function(lib, "bla_fused_block_wgrad_tc", [_I] * 5 + [_P] * 9)
        with torch.cuda.device(dev):
            rc = fn(b, c, f, h, w, _ptr(ws_a1), _ptr(ws_d), _ptr(ws_dh),
                    _ptr(g), _ptr(x), _ptr(dw1), _ptr(dw2), _ptr(dw3),
                    stream)
        cuda_utils.check(lib, rc, "fused_resnet_block tensor-core K5b "
                                  "weight-gradient launch", dw1, dw2, dw3)
        wgrad_tc_launch_count += 1
    else:
        lib = cuda_utils.load_library("fused_block")
        fn = _function(lib, "bla_fused_block_wgrad", [_I] * 7 + [_P] * 9)
        with torch.cuda.device(dev):
            rc = fn(_KERNEL_DTYPES[x.dtype], b, c, f, h, w, k, _ptr(x),
                    _ptr(g), _ptr(ws_a1), _ptr(ws_d), _ptr(ws_dh), _ptr(dw1),
                    _ptr(dw2), _ptr(dw3), stream)
        cuda_utils.check(lib, rc, "fused_resnet_block K5b weight-gradient "
                                  "launch", dw1, dw2, dw3)
    wgrad_launch_count += 1
    return dw1, dw2, dw3


def _kernel_fused_bwd(x, td, w1, w2, w3, seed, gsz, rate, train, eps, g,
                      bits=None):
    """K5b on CUDA tensors: its data-gradient kernel (dx, d_td, and the
    rounded a1, d and dh1t of every example into workspaces), then its
    weight-gradient kernel (dw1, dw2, dw3 summed over the batch in a fixed
    order) → (dx, d_td, dw1, dw2, dw3 or None) in the inputs' dtypes."""
    dtypes = [a if a is None else a.dtype for a in (x, td, w1, w2, w3)]
    dx, dtd, work = _kernel_bwd_data(x, td, w1, w2, w3, seed, gsz, rate,
                                     train, eps, g, bits)
    dw1, dw2, dw3 = _kernel_bwd_wgrad(work, w1.shape[-1], w3 is not None)
    return (dx.to(dtypes[0]), dtd.to(dtypes[1]), dw1.to(dtypes[2]),
            dw2.to(dtypes[3]), None if dw3 is None else dw3.to(dtypes[4]))


def kernel_dropout_bits(seed, n: int, device) -> torch.Tensor:
    """The kernels' dropout bits of ``seed`` for indices 0..n−1, computed on
    the card by the same device function K5a and K5b use (uint32 values in
    int64), for holding them equal to ``_dropout_bits``."""
    seed = _seed_tensor(seed, device)
    out = torch.empty(n, dtype=torch.int32, device=device)
    lib = cuda_utils.load_library("fused_block")
    fn = _function(lib, "bla_fused_block_bits", [_P, _I, _P, _P])
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(_ptr(seed), n, _ptr(out), stream)
    cuda_utils.check(lib, rc, "fused_resnet_block bits launch", out)
    return out.to(torch.int64) & _MASK32


# ---------------------------------------------------------------------------
# The autograd Function
# ---------------------------------------------------------------------------


def _by_device(x, kernel, plain):
    if x.device.type == "cuda":
        return kernel
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"fused_resnet_block: no kernel for device {x.device}")


class _FusedResnetBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, td, w1, w2, w3, seed, group_size, rate, train, eps,
                bits):
        ctx.save_for_backward(x, td, w1, w2, w3, seed)
        ctx.args = (group_size, rate, train, eps, bits)
        return _by_device(x, _kernel_fused_fwd, _plain_fused_fwd)(
            x, td, w1, w2, w3, seed, group_size, rate, train, eps, bits)

    @staticmethod
    def backward(ctx, g):
        x, td, w1, w2, w3, seed = ctx.saved_tensors
        group_size, rate, train, eps, bits = ctx.args
        grads = _by_device(x, _kernel_fused_bwd, _plain_fused_bwd)(
            x, td, w1, w2, w3, seed, group_size, rate, train, eps, g, bits)
        return (*grads, None, None, None, None, None, None)


def fused_resnet_block(x: torch.Tensor, td: torch.Tensor, w1: torch.Tensor,
                       w2: torch.Tensor, w3: Optional[torch.Tensor], seed,
                       group_size: int, rate: float, train: bool,
                       eps: float = 1e-8,
                       bits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole resnet block. x (B, C, H, W); td (B, F), the time
    embedding's projection; w1 (F, C, k, k), w2 (F, F, k, k); w3 (F, C, 1, 1)
    or None when C == F; seed: an int32 value (int or tensor) for the
    dropout bits; ``bits``: (F, B·H·W) uint32 values in an integer tensor
    instead of the hash, on the CPU only. Returns (B, F, H, W) in the
    promotion of x's and w1's dtypes."""
    seed = _seed_tensor(seed, x.device)
    return _FusedResnetBlock.apply(x, td, w1, w2, w3, seed, group_size,
                                   float(rate), bool(train), float(eps),
                                   bits)
