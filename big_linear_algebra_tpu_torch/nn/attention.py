"""Scaled dot-product attention, the counterpart of
``big_linear_algebra_tpu/nn/attention.py``: the dense reference math, the
flash kernel (K2) and the U-Net's self-attention block.

Single head, unmasked (model/cifar_unet.c:999-1022): ``softmax(QKᵀ/√d)V`` on
q, k, v of shape (B, N, d).

- ``attention_dense``: the N×N matrix materialized, as the reference does.
- ``flash_attention``: the blockwise online-softmax kernel
  ``csrc/flash_attn.cu`` on a CUDA tensor — one CUDA kernel replaces both
  TPU forwards, ``_flash_fwd_kernel`` and ``_flash_fwd_stream_kernel`` — and
  its plain version ``_plain_flash`` on a CPU tensor. On a CUDA tensor the
  kernel launches or the call raises: there is no fallback.
- ``attention``: the JAX package's dispatch, kept as it is: flash for
  self-attention shapes with N ≥ ``_FLASH_MIN_N`` outside f64, dense
  otherwise. The threshold was chosen on a TPU; re-deriving it for the H100
  is later work.

Forward only: the hand-written backwards (the dense VJP, the flash dq and
dk/dv kernels K2c/K2d) come with training; until then these ops raise when
autograd would need a graph through them.
"""

from __future__ import annotations

import ctypes
import math
from typing import Mapping, Tuple

import torch

from big_linear_algebra_tpu_torch.ops import cuda_utils, forward_only
from big_linear_algebra_tpu_torch.ops.precision import accum_dtype

_FLASH_MIN_N = 1024  # the JAX package's threshold (nn/attention.py:36)

_LOG2E = math.log2(math.e)


def _qscale(d: int) -> float:
    """1/√d·log2(e), folded into q (the Pallas kernels' ``scale * _LOG2E``)."""
    return (1.0 / math.sqrt(d)) * _LOG2E


_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Head dims the kernel is instantiated for (a template parameter).
_KERNEL_DIMS = (4, 8, 16, 32, 64, 128)

# Kernel launches since import (or since a caller last set it to 0). Counted
# only where the CUDA kernel is launched, so a run can show that its main
# path went through the kernel.
launch_count = 0


def attention_dense(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(QKᵀ/√d)V with the N×N matrix materialized (the reference's
    exact formulation). Scores and probabilities in ≥f32 (f64 stays f64);
    the output in q's dtype. k and v may have another length than q."""
    forward_only.check("attention_dense", q, k, v)
    acc = accum_dtype(q.dtype)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q.to(acc) @ k.to(acc).transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    return (p @ v.to(acc)).to(q.dtype)


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


def _kernel_flash(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_attn.cu`` on CUDA tensors → (o, lse f32); raises
    on anything the kernel does not take and on a failed build or launch."""
    global launch_count
    _check_self_attention(q, k, v)
    b, n, d = q.shape
    if d not in _KERNEL_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head dims "
                         f"{_KERNEL_DIMS}, got {d}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: the kernel takes f32 or bf16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if any(t.device != q.device or t.device.type != "cuda"
           for t in (q, k, v)):
        raise ValueError(
            f"flash_attention: kernel operands must share one CUDA device, "
            f"got {[str(t.device) for t in (q, k, v)]}")
    if not 0 < b <= 65535 or n == 0:
        raise ValueError(f"flash_attention: the kernel takes 1 <= B <= 65535 "
                         f"and N >= 1, got B={b}, N={n}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b, n), dtype=torch.float32, device=q.device)
    lib = cuda_utils.load_library("flash_attn")
    fn = lib.bla_flash_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_float, ctypes.c_void_p]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(_KERNEL_DTYPES[q.dtype], b, n, d, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                _qscale(d), stream)
    cuda_utils.check(lib, rc, "flash_attention kernel launch")
    launch_count += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Blockwise online-softmax attention; the N×N matrix is never stored.
    The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    forward_only.check("flash_attention", q, k, v)
    _check_self_attention(q, k, v)
    if q.device.type == "cuda":
        return _kernel_flash(q, k, v)[0]
    if q.device.type == "cpu":
        return _plain_flash(q, k, v)[0]
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


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
    bias. Plain torch products (XLA einsums in the JAX package), in true
    f32 for f32 (TF32 is off)."""
    q = tokens @ params["q"]
    k = tokens @ params["k"]
    v = tokens @ params["v"]
    return attention(q, k, v) @ params["w"] + params["b"]
