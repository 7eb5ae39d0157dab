"""Implicit-GEMM convolution, the counterpart of
``big_linear_algebra_tpu/nn/conv_implicit.py``: a stride-1 "same" conv
with odd k as k² tap products whose im2col never exists.

- ``conv2d_implicit`` and ``conv2d_packed``: ``torch.autograd.Function``\\ s
  with the JAX package's VJP. dx is the same conv of the gradient with the
  flipped, channel-transposed kernels (lib/conv.c:225-226 intent), through
  the same kernel; dk is ``nn/conv.py``'s ``_dk_conv`` (the reference's
  im2colᵀ·del_Q GEMM on cuBLAS; the JAX package leaves dk to XLA).
- On a CUDA tensor both launch ``csrc/conv_implicit.cu`` (K4: one CUDA
  kernel replaces the TPU's per-example ``_conv_kernel`` and batch-packed
  ``_conv_packed_kernel``, since a tile over the flattened B·H·W positions
  fills a block at any H·W, which the TPU's packing was for); on a CPU
  tensor the plain version ``_plain_conv`` runs (the k² tap sum). On a CUDA
  tensor the kernel launches or the call raises: there is no fallback.
- What the TPU kernels did not take goes to the port's ``conv2d`` forward,
  as the JAX package's goes to its XLA conv: f64, even or non-square
  kernels, and shapes past ``supported`` / ``packed_supported``, whose
  formulas are the TPU's VMEM budget, kept so that a call takes the
  counterpart of the route it takes in JAX.

Layouts: x (B, C, H, W); kernels (F, C, k, k) → (B, F, H, W) in x's dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from big_linear_algebra_tpu_torch.nn import conv
from big_linear_algebra_tpu_torch.ops import cuda_utils
from big_linear_algebra_tpu_torch.ops.precision import accum_dtype

# The JAX package's VMEM limit (nn/conv_implicit.py:35), a TPU number.
_VMEM_LIMIT = 64 * 1024 * 1024

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since import (or since a caller last set them to 0), one
# count per entry point, each counted only where K4 is launched.
implicit_launch_count = 0
packed_launch_count = 0


def supported(x_shape, k_shape, stride: int) -> bool:
    """The JAX package's gate of ``conv2d_implicit`` (one example's block,
    its f32 accumulator and the taps within half the TPU's VMEM limit)."""
    _, c, h, w = x_shape
    f, _, kh, kw = k_shape
    if stride != 1 or kh != kw or kh % 2 == 0:
        return False
    need = (c + f) * h * w * 4 + f * h * w * 4 + kh * kw * c * f * 4
    return need <= _VMEM_LIMIT // 2


def packed_supported(x_shape, k_shape, stride: int) -> bool:
    """The JAX package's gate of ``conv2d_packed`` (the whole packed batch,
    its accumulator, output and taps within half the TPU's VMEM limit)."""
    b, c, h, w = x_shape
    f, _, kh, kw = k_shape
    if stride != 1 or kh != kw or kh % 2 == 0:
        return False
    bhw = b * h * w
    need = (c * bhw + f * bhw) * 4 + f * bhw * 4 + kh * kw * c * f * 4
    return need <= _VMEM_LIMIT // 2


def _takes_kernel(x: torch.Tensor, kernels: torch.Tensor, packed: bool) -> bool:
    """Whether the JAX package runs its Pallas kernel on these operands
    (``_conv_fwd_pallas`` / ``_conv_fwd_packed``), else its XLA conv."""
    _, _, kh, kw = kernels.shape
    gate = packed_supported if packed else supported
    promoted = torch.promote_types(x.dtype, kernels.dtype)
    return not (kh != kw or kh % 2 == 0 or promoted.itemsize > 4
                or not gate(x.shape, kernels.shape, 1))


def _plain_conv(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K4: out += W_tapᵀ · (x shifted by the
    tap, zero past the border) over the k² taps, summed in f32 (f64 for
    f64), cast to x's dtype."""
    acc = accum_dtype(torch.promote_types(x.dtype, kernels.dtype))
    b, c, h, w = x.shape
    f, _, k, _ = kernels.shape
    half = k // 2
    xp = F.pad(x.to(acc), (half, half, half, half))
    wa = kernels.to(acc)
    out = torch.zeros((b, f, h * w), dtype=acc, device=x.device)
    for i in range(k):
        for j in range(k):
            shifted = xp[:, :, i:i + h, j:j + w].reshape(b, c, h * w)
            out += wa[:, :, i, j] @ shifted
    return out.reshape(b, f, h, w).to(x.dtype)


def _launch(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/conv_implicit.cu`` on CUDA tensors → (B, F, H, W) in
    x's dtype; raises on anything the kernel does not take and on a failed
    build or launch."""
    b, c, h, w = x.shape
    f, c2, k, kw = kernels.shape
    if c2 != c or kw != k or k % 2 == 0:
        raise ValueError(f"conv2d_implicit: the kernel takes (F, {c}, k, k) "
                         f"kernels with odd k, got {tuple(kernels.shape)}")
    if any(t.device != x.device or t.device.type != "cuda"
           for t in (x, kernels)):
        raise ValueError(
            f"conv2d_implicit: kernel operands must share one CUDA device, "
            f"got {x.device} and {kernels.device}")
    promoted = torch.promote_types(x.dtype, kernels.dtype)
    if promoted not in _KERNEL_DTYPES or x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"conv2d_implicit: the kernel takes f32 or bf16, got "
                        f"{x.dtype} and {kernels.dtype}")
    out = torch.empty((b, f, h, w), dtype=x.dtype, device=x.device)
    x, kernels = (t.to(promoted).contiguous() for t in (x, kernels))
    lib = cuda_utils.load_library("conv_implicit")
    fn = lib.bla_conv_implicit
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(_KERNEL_DTYPES[promoted], _KERNEL_DTYPES[out.dtype],
                x.data_ptr(), kernels.data_ptr(), out.data_ptr(), b, c, h, w,
                f, k, stream)
    cuda_utils.check(lib, rc, "conv2d_implicit kernel launch")
    return out


def _kernel_implicit(x, kernels):
    """K4 for ``conv2d_implicit``, counted as its launch."""
    global implicit_launch_count
    out = _launch(x, kernels)
    implicit_launch_count += 1
    return out


def _kernel_packed(x, kernels):
    """K4 for ``conv2d_packed``, counted as its launch."""
    global packed_launch_count
    out = _launch(x, kernels)
    packed_launch_count += 1
    return out


def _conv_fwd(x: torch.Tensor, kernels: torch.Tensor,
              packed: bool) -> torch.Tensor:
    """The JAX package's ``_conv_fwd_pallas`` (``packed``: its
    ``_conv_fwd_packed``): K4 or its plain version by device where the TPU
    kernel runs, else the port's ``conv2d`` forward."""
    if x.shape[1] != kernels.shape[1]:
        raise ValueError(f"kernel expects {kernels.shape[1]} input channels, "
                         f"x has {x.shape[1]}")
    if not _takes_kernel(x, kernels, packed):
        return conv._conv(x, kernels, conv._same_pads(x, kernels.shape, 1))
    if x.device.type == "cuda":
        return (_kernel_packed if packed else _kernel_implicit)(x, kernels)
    if x.device.type == "cpu":
        return _plain_conv(x, kernels)
    raise ValueError(f"conv2d_implicit: no kernel for device {x.device}")


class _ConvImplicit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernels, packed):
        ctx.save_for_backward(x, kernels)
        ctx.packed = packed
        return _conv_fwd(x, kernels, packed)

    @staticmethod
    def backward(ctx, g):
        """The JAX package's ``_ci_bwd`` / ``_cp_bwd``."""
        x, kernels = ctx.saved_tensors
        g = g.to(x.dtype)
        k_t = torch.flip(kernels, dims=(-2, -1)).transpose(0, 1)
        dx = _conv_fwd(g, k_t, ctx.packed)
        dk = conv._dk_conv(x, g, 1, kernels.shape)
        return dx, dk.contiguous(), None


def conv2d_implicit(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Stride-1 "same" conv on the implicit-GEMM kernel.
    x: (B, C, H, W), kernels: (F, C, k, k) → (B, F, H, W)."""
    return _ConvImplicit.apply(x, kernels, False)


def conv2d_packed(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """The same conv under the batch-packed kernel's gate
    (``packed_supported``). x: (B, C, H, W), kernels: (F, C, k, k) → (B, F,
    H, W)."""
    return _ConvImplicit.apply(x, kernels, True)
