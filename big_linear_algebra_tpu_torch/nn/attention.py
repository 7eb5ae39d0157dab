"""Scaled dot-product attention, the counterpart of
``big_linear_algebra_tpu/nn/attention.py``: the dense reference math with
its hand-written VJP, the flash kernels (forward K2, backward K2c/K2d) and
the U-Net's self-attention block.

Single head, unmasked (model/cifar_unet.c:999-1022): ``softmax(QKᵀ/√d)V`` on
q, k, v of shape (B, N, d).

- ``attention_dense``: the N×N matrix materialized, as the reference does;
  a ``torch.autograd.Function`` whose backward is the JAX package's
  softmax-Jacobian VJP.
- ``flash_attention``: a ``torch.autograd.Function``. On a CUDA tensor the
  forward launches ``csrc/flash_attn.cu`` (K2: one CUDA kernel replaces both
  TPU forwards, ``_flash_fwd_kernel`` and ``_flash_fwd_stream_kernel``,
  whatever ``stream`` asks for). The backward takes the JAX package's route
  (``_bwd_route``): by default ``csrc/flash_attn_bwd.cu`` (K2c for dq and
  K2d for dk/dv, the TPU's streaming ``_flash_bwd_stream_dq_kernel`` and
  ``_flash_bwd_stream_dkv_kernel``); with ``stream=False``,
  ``csrc/flash_attn_bwd_fused.cu`` (K3a, dq, dk and dv in one pass, the
  TPU's ``_flash_bwd_fused_kernel``), or past the TPU's fused budget K2c
  and K2d again, which compute what the TPU's row-resident two-pass
  ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel`` (K3b, K3c) compute.
  On a CPU tensor the plain versions ``_plain_flash`` and
  ``_plain_flash_bwd`` run. On a CUDA tensor a kernel launches or the call
  raises: there is no fallback.
- ``attention``: the JAX package's dispatch, kept as it is: flash for
  self-attention shapes with N ≥ ``_FLASH_MIN_N`` outside f64, dense
  otherwise. The threshold was chosen on a TPU; re-deriving it for the H100
  is later work.
"""

from __future__ import annotations

import ctypes
import math
from typing import Mapping, Tuple

import torch

from big_linear_algebra_tpu_torch.ops import cuda_utils
from big_linear_algebra_tpu_torch.ops.precision import accum_dtype

_FLASH_MIN_N = 1024  # the JAX package's threshold (nn/attention.py:36)

_LOG2E = math.log2(math.e)


def _qscale(d: int) -> float:
    """1/√d·log2(e), folded into q (then rounded to q's dtype) by the
    forward and the backward alike."""
    return (1.0 / math.sqrt(d)) * _LOG2E


_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Head dims the kernels are instantiated for (a template parameter).
_KERNEL_DIMS = (4, 8, 16, 32, 64, 128)

# Kernel launches since import (or since a caller last set them to 0): K2,
# K2c, K2d and K3a. Each is counted only where its CUDA kernel is launched,
# so a run can show that its main path went through the kernels.
launch_count = 0
bwd_dq_launch_count = 0
bwd_dkv_launch_count = 0
bwd_fused_launch_count = 0

# The JAX package's VMEM budget for the fused backward's row-resident
# operands (nn/attention.py:605). These are the TPU's numbers, as is the
# padding in ``_bwd_route``: they are kept so that one call reaches the
# counterpart of the TPU kernel that the same call reaches in JAX.
_BWD_FUSED_VMEM_BUDGET = 40 * 1024 * 1024


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _bwd_route(shape, dtype: torch.dtype, block_q: int, block_k: int,
               stream) -> str:
    """The backward kernels one call takes, by the JAX package's rule
    (``_flash_bwd_padded``, nn/attention.py:651-704), from shape and dtype
    alone: "stream" (``stream`` None or True: K2c + K2d), "fused" (False,
    and the TPU's resident rows fit the budget: K3a) or "two_pass" (False
    beyond it: the TPU's K3b + K3c, here K2c + K2d)."""
    if stream is None or stream:
        return "stream"
    _, n, d = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    n_pad = _round_up(n, math.lcm(block_q, block_k))
    d_pad = _round_up(d, 128)
    fused_bytes = (
        n_pad * d_pad * (3 * itemsize + 4)     # q, g, dq out, dq f32 scratch
        + n_pad * 128 * 8                      # lse + delta rows
        + 4 * block_k * d_pad * itemsize * 2)  # k/v/dk/dv double-buffered
    return "fused" if fused_bytes <= _BWD_FUSED_VMEM_BUDGET else "two_pass"


def _dense_fwd(q, k, v):
    """(o, p): scores and probabilities in ≥f32 (f64 stays f64), the output
    in q's dtype."""
    acc = accum_dtype(q.dtype)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q.to(acc) @ k.to(acc).transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    return (p @ v.to(acc)).to(q.dtype), p


class _AttentionDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        o, p = _dense_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, p)
        return o

    @staticmethod
    def backward(ctx, g):
        """The JAX package's ``_attention_dense_bwd``: the softmax Jacobian
        per row, ds = p ⊙ (dp − Σ dp ⊙ p) (model/cifar_unet.c:1246-1258)."""
        q, k, v, p = ctx.saved_tensors
        scale = 1.0 / math.sqrt(q.shape[-1])
        g = g.to(p.dtype)
        dv = p.transpose(-1, -2) @ g
        dp = g @ v.to(p.dtype).transpose(-1, -2)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq = (ds @ k.to(ds.dtype)) * scale
        dk = (ds.transpose(-1, -2) @ q.to(ds.dtype)) * scale
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_dense(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(QKᵀ/√d)V with the N×N matrix materialized (the reference's
    exact formulation). Scores and probabilities in ≥f32 (f64 stays f64);
    the output in q's dtype. k and v may have another length than q."""
    return _AttentionDense.apply(q, k, v)


def _check_self_attention(q, k, v) -> None:
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        # the kernel takes its length from q alone — shorter k/v would be
        # read past their end; attention_dense takes other key lengths
        raise ValueError(
            f"flash_attention is self-attention-shaped: q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)} must match and be "
            "(B, N, d) (attention_dense supports differing key/query "
            "lengths)")


def _plain_flash(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K2: (o, lse), the same arithmetic as
    the kernel with the whole key axis as one block. q is scaled by
    log2(e)/√d in the accumulation type and rounded back to its own dtype;
    scores are exp2'd against the row max; P is rounded to the input dtype
    before the PV product; sums in f32 (f64 for f64). lse is the natural-log
    logsumexp of the scaled scores, (B, N), in the accumulation type."""
    acc = accum_dtype(q.dtype)
    qs = (q.to(acc) * _qscale(q.shape[-1])).to(q.dtype)
    s = qs.to(acc) @ k.to(acc).transpose(-1, -2)  # log2 domain
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(q.dtype).to(acc) @ v.to(acc)) / l
    lse = (m + torch.log2(l)).squeeze(-1) / _LOG2E
    return o.to(q.dtype), lse


def _bwd_prepare(g, o, lse, dtype):
    """The JAX package's ``_flash_bwd_prepare`` (its XLA side): g cast to
    the input dtype, delta = Σ_d g·o in the accumulation type, and the lse
    moved to the log2 domain. Returns (g, lse2, delta)."""
    acc = accum_dtype(dtype)
    g = g.to(dtype)
    delta = (g.to(acc) * o.to(acc)).sum(dim=-1)
    return g, lse * _LOG2E, delta


def _plain_flash_bwd(q, k, v, o, lse, g):
    """The plain PyTorch version of K2c and K2d, and of K3a: (dq, dk, dv),
    the same roundings as the kernels with the whole key axis as one block. The
    scores are the forward's: q scaled by log2(e)/√d and rounded to its
    own dtype, so that p = exp2(s − lse2) stays ≤ 1 (the Pallas kernels
    scale the unrounded f32 score instead; in bf16 that score can exceed
    the forward's by more than 128 where |s| reaches ~1e5, as at the
    full-width U-Net's up_3 sites, and p overflows to inf). ds = p·(dp −
    delta) is rounded to the input dtype before its products, p before the
    dv product; the 1/√d of dq and dk is applied once, at the end."""
    acc = accum_dtype(q.dtype)
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    g, lse2, delta = _bwd_prepare(g, o, lse, q.dtype)
    qa, ka, va, ga = (x.to(acc) for x in (q, k, v, g))
    qs = (qa * _qscale(d)).to(q.dtype).to(acc)
    s = qs @ ka.transpose(-1, -2)
    p = torch.exp2(s - lse2.to(acc)[..., None])
    dp = ga @ va.transpose(-1, -2)
    ds = (p * (dp - delta[..., None])).to(q.dtype).to(acc)
    dv = p.to(q.dtype).to(acc).transpose(-1, -2) @ ga
    dq = (ds @ ka) * scale
    dk = (ds.transpose(-1, -2) @ qa) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_operands(what, *tensors) -> None:
    """Raise on anything the flash kernels do not take."""
    q = tensors[0]
    b, n, d = q.shape
    if d not in _KERNEL_DIMS:
        raise ValueError(f"{what}: the kernel takes head dims "
                         f"{_KERNEL_DIMS}, got {d}")
    if q.dtype not in _KERNEL_DTYPES or any(t.dtype != q.dtype
                                            for t in tensors):
        raise TypeError(f"{what}: the kernel takes f32 or bf16 operands of "
                        f"one dtype, got {[t.dtype for t in tensors]}")
    if any(t.device != q.device or t.device.type != "cuda" for t in tensors):
        raise ValueError(
            f"{what}: kernel operands must share one CUDA device, got "
            f"{[str(t.device) for t in tensors]}")
    if not 0 < b <= 65535 or n == 0:
        raise ValueError(f"{what}: the kernel takes 1 <= B <= 65535 and "
                         f"N >= 1, got B={b}, N={n}")


def _function(lib, name, n_ptrs, n_floats):
    """``lib.name`` with its ctypes signature: (dtype, b, n, d, pointers...,
    floats..., stream) → int."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * n_ptrs
                       + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    return fn


def _kernel_flash(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_attn.cu`` on CUDA tensors → (o, lse f32); raises
    on anything the kernel does not take and on a failed build or launch."""
    global launch_count
    _check_self_attention(q, k, v)
    _check_kernel_operands("flash_attention", q, k, v)
    b, n, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b, n), dtype=torch.float32, device=q.device)
    lib = cuda_utils.load_library("flash_attn")
    fn = _function(lib, "bla_flash_fwd", 5, 1)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(_KERNEL_DTYPES[q.dtype], b, n, d, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                _qscale(d), stream)
    cuda_utils.check(lib, rc, "flash_attention kernel launch")
    launch_count += 1
    return o, lse


def _launch_bwd(entry, n_out, q, k, v, g, lse2, delta):
    """Launch ``entry`` of ``csrc/flash_attn_bwd.cu`` on prepared, checked
    CUDA operands → its ``n_out`` outputs (dq; or dk, dv), shaped like q."""
    b, n, d = q.shape
    outs = tuple(torch.empty_like(q) for _ in range(n_out))
    lib = cuda_utils.load_library("flash_attn_bwd")
    fn = _function(lib, entry, 6 + n_out, 2)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(_KERNEL_DTYPES[q.dtype], b, n, d, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), g.data_ptr(), lse2.data_ptr(), delta.data_ptr(),
                *(x.data_ptr() for x in outs), _qscale(d),
                1.0 / math.sqrt(d), stream)
    cuda_utils.check(lib, rc, f"flash_attention backward {entry} launch")
    return outs


def _kernel_bwd_dq(q, k, v, g, lse2, delta) -> torch.Tensor:
    """K2c: dq from prepared operands (``_kernel_flash_bwd``)."""
    global bwd_dq_launch_count
    (dq,) = _launch_bwd("bla_flash_bwd_dq", 1, q, k, v, g, lse2, delta)
    bwd_dq_launch_count += 1
    return dq


def _kernel_bwd_dkv(q, k, v, g, lse2, delta):
    """K2d: (dk, dv) from prepared operands (``_kernel_flash_bwd``)."""
    global bwd_dkv_launch_count
    dk, dv = _launch_bwd("bla_flash_bwd_dkv", 2, q, k, v, g, lse2, delta)
    bwd_dkv_launch_count += 1
    return dk, dv


def _kernel_bwd_operands(q, k, v, o, lse, g):
    """The prep in plain torch (``_bwd_prepare``), then the checks: (q, k,
    v, g, lse2, delta), contiguous, as K2c and K2d take them."""
    _check_self_attention(q, k, v)
    g, lse2, delta = _bwd_prepare(g, o, lse, q.dtype)
    _check_kernel_operands("flash_attention backward", q, k, v, g)
    q, k, v, g = (x.contiguous() for x in (q, k, v, g))
    return q, k, v, g, lse2.float().contiguous(), delta.float().contiguous()


def _kernel_flash_bwd(q, k, v, o, lse, g):
    """The prep in plain torch, then K2c (dq) and K2d (dk, dv) from
    ``csrc/flash_attn_bwd.cu`` on CUDA tensors → (dq, dk, dv); raises on
    anything the kernels do not take and on a failed build or launch."""
    ops = _kernel_bwd_operands(q, k, v, o, lse, g)
    return (_kernel_bwd_dq(*ops), *_kernel_bwd_dkv(*ops))


def _kernel_flash_bwd_fused(q, k, v, o, lse, g):
    """The prep in plain torch, then K3a from ``csrc/flash_attn_bwd_fused.cu``
    on CUDA tensors → (dq, dk, dv); raises on anything the kernels do not
    take and on a failed build or launch."""
    return _kernel_bwd_fused(*_kernel_bwd_operands(q, k, v, o, lse, g))


def _kernel_bwd_fused(q, k, v, g, lse2, delta):
    """K3a on prepared operands (``_kernel_flash_bwd_fused``): a pass over
    the key tiles that writes dk and dv and each tile's f32 share of dq
    into a workspace, then a reduction that sums the shares in tile order
    (two kernels, counted as one launch)."""
    global bwd_fused_launch_count
    b, n, d = q.shape
    lib = cuda_utils.load_library("flash_attn_bwd_fused")
    tiles = lib.bla_flash_bwd_fused_tiles
    if tiles.argtypes is None:
        tiles.restype = ctypes.c_int
        tiles.argtypes = [ctypes.c_int, ctypes.c_int]
    # (key tiles, B, N, d) f32: each key tile's share of dq
    ws = torch.empty((tiles(n, d), b, n, d), dtype=torch.float32,
                     device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    fn = _function(lib, "bla_flash_bwd_fused", 10, 2)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(_KERNEL_DTYPES[q.dtype], b, n, d, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), g.data_ptr(), lse2.data_ptr(), delta.data_ptr(),
                ws.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                _qscale(d), 1.0 / math.sqrt(d), stream)
    cuda_utils.check(lib, rc, "flash_attention fused backward launch")
    bwd_fused_launch_count += 1
    return dq, dk, dv


def _by_device(q, kernel, plain):
    if q.device.type == "cuda":
        return kernel
    if q.device.type == "cpu":
        return plain
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, block_q, block_k, stream):
        ctx.route = _bwd_route(q.shape, q.dtype, block_q, block_k, stream)
        o, lse = _by_device(q, _kernel_flash, _plain_flash)(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        kernel = (_kernel_flash_bwd_fused if ctx.route == "fused"
                  else _kernel_flash_bwd)
        grads = _by_device(q, kernel, _plain_flash_bwd)(q, k, v, o, lse, g)
        return (*grads, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_q: int = 512, block_k: int = 1024,
                    stream=None) -> torch.Tensor:
    """Blockwise online-softmax attention; the N×N matrix is never stored,
    forward or backward. The kernels on a CUDA tensor, the plain versions
    on a CPU tensor. ``block_q``, ``block_k`` and ``stream`` are the JAX
    package's arguments: they choose the backward's kernels by its rule
    (``_bwd_route``); the CUDA kernels tile on their own."""
    _check_self_attention(q, k, v)
    return _FlashAttention.apply(q, k, v, block_q, block_k, stream)


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Dispatch: dense for short sequences (and cross-attention shapes,
    which the flash kernel rejects), flash for long self-attention."""
    if (q.shape == k.shape == v.shape and q.shape[1] >= _FLASH_MIN_N
            and q.dtype != torch.float64):
        return flash_attention(q, k, v)
    return attention_dense(q, k, v)


def self_attention_block(x: torch.Tensor,
                         params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """(B, C, H, W) → (B, C, H, W). ≈ ``_forward_attention``
    (model/cifar_unet.c:999-1022): tokens (B, HW, C), q/k/v projections to
    key_dim, attention, dense back to C with bias.

    ``params``: q/k/v (C, key_dim), w (key_dim, C), b (C,)."""
    b, c, h, w = x.shape
    tokens = x.reshape(b, c, h * w).transpose(1, 2)      # (B, HW, C)
    out = _attention_core(tokens, params)
    return out.transpose(1, 2).reshape(b, c, h, w)


def _attention_core(tokens: torch.Tensor,
                    params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """(B, N, C) → (B, N, C): projections → attention → output dense with
    bias. Plain torch products (XLA einsums in the JAX package, which leaves
    their gradients to autodiff, as the port leaves them to autograd), in
    true f32 for f32 (TF32 is off)."""
    q = tokens @ params["q"]
    k = tokens @ params["k"]
    v = tokens @ params["v"]
    return attention(q, k, v) @ params["w"] + params["b"]
