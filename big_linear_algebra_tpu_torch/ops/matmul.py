"""The GEMM (kernel K1) and its dispatch, the counterpart of
``big_linear_algebra_tpu/ops/matmul.py``.

Rebuilds the reference's dense matmul (``lib/matrix.c:35``
``matrix_multiply``). Three variants cover the forward pass and both backward
GEMMs without ever materializing a transpose:

- ``matmul(a, b)``    : ``a @ b``
- ``matmul_nt(a, b)`` : ``a @ b.T``
- ``matmul_tn(a, b)`` : ``a.T @ b``

``_dispatch`` keeps the JAX package's rule: f64 operands, or fewer than
``_SMALL_FLOPS`` FLOPs, take the plain product (``_plain_mm``, the
counterpart of ``_xla_mm``); everything else takes the hand-written CUDA
kernel ``csrc/matmul.cu`` on a CUDA tensor, or the same plain product on a
CPU tensor (the CPU tests' path, as Pallas interpret mode is the JAX
package's). On a CUDA tensor the kernel launches or the call raises: there is
no fallback.

The three public functions go through ``_MatmulFn``, whose backward is the
JAX package's hand-written ``_matmul_bwd``: both gradients are GEMMs of the
other two variants, each through ``_dispatch`` (so the small/f64 rule and the
kernel apply there too), and no transpose is materialized. ``_dispatch``
itself records no graph and raises when autograd would need one through it:
a ctypes launch would cut the graph silently, and on the CPU autograd would
differentiate the plain product instead of the hand-written rule. Grad mode
is off inside a Function's forward and backward, so its proper callers
(``_MatmulFn``, ``nn/dense.py``, ``nn/conv_pallas.py``) never trip it.
"""

from __future__ import annotations

import ctypes
from typing import Literal, Optional

import torch

from big_linear_algebra_tpu_torch.ops import cuda_utils
from big_linear_algebra_tpu_torch.ops.precision import accum_dtype

# Below this many FLOPs the plain product is used (the JAX package's rule,
# chosen on a TPU; re-deriving it for the H100 is later work).
_SMALL_FLOPS = 2 ** 22

Variant = Literal["nn", "nt", "tn"]

# Per-variant geometry: (M, N, K) from the stored operand shapes, and the
# contraction check.
_VARIANTS = {
    # C[M,N] = A[M,K] @ B[K,N]
    "nn": dict(shapes=lambda a, b: (a.shape[0], b.shape[1], a.shape[1]),
               check=lambda a, b: a.shape[1] == b.shape[0], code=0),
    # C[M,N] = A[M,P] @ B[N,P].T
    "nt": dict(shapes=lambda a, b: (a.shape[0], b.shape[0], a.shape[1]),
               check=lambda a, b: a.shape[1] == b.shape[1], code=1),
    # C[M,N] = A[P,M].T @ B[P,N]
    "tn": dict(shapes=lambda a, b: (a.shape[1], b.shape[1], a.shape[0]),
               check=lambda a, b: a.shape[0] == b.shape[0], code=2),
}

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since import (or since a caller last set them to 0), in
# all and by variant. Counted only where the CUDA kernel is launched, so a
# run can show that its main path went through the kernel.
launch_count = 0
variant_launch_counts = {"nn": 0, "nt": 0, "tn": 0}


def _plain_mm(a: torch.Tensor, b: torch.Tensor, variant: Variant,
              out_dtype: torch.dtype, bias: Optional[torch.Tensor] = None,
              activation: Optional[str] = None) -> torch.Tensor:
    """The plain PyTorch version of K1: the product accumulated in f32 (f64
    for an f64 output), + bias in the accumulation type, ReLU, cast."""
    acc = accum_dtype(out_dtype)
    a, b = a.to(acc), b.to(acc)
    if variant == "nt":
        b = b.T
    elif variant == "tn":
        a = a.T
    out = a @ b
    if bias is not None:
        out = out + bias.to(acc)[None, :]
    if activation == "relu":
        out = torch.clamp_min(out, 0.0)
    return out.to(out_dtype)


def _kernel_mm(a: torch.Tensor, b: torch.Tensor, variant: Variant,
               out_dtype: torch.dtype, bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None) -> torch.Tensor:
    """Launch ``csrc/matmul.cu`` on CUDA tensors; raises on anything the
    kernel does not take and on a failed build or launch."""
    global launch_count
    m, n, k = _VARIANTS[variant]["shapes"](a, b)
    tensors = [a, b] + ([bias] if bias is not None else [])
    if any(t.device != a.device or t.device.type != "cuda" for t in tensors):
        raise ValueError(
            f"matmul_{variant}: kernel operands must share one CUDA device, "
            f"got {[str(t.device) for t in tensors]}")
    if a.dtype != b.dtype or a.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"matmul_{variant}: kernel takes f32 or bf16 "
                        f"operands of one dtype, got {a.dtype} and {b.dtype}")
    if out_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"matmul_{variant}: kernel output must be f32 or "
                        f"bf16, got {out_dtype}")
    if bias is not None and bias.shape != (n,):
        raise ValueError(
            f"matmul_{variant}: bias shape {tuple(bias.shape)} != ({n},)")
    a, b = a.contiguous(), b.contiguous()
    # the epilogue adds the bias in f32, whatever the operand type
    bias_f32 = bias.to(torch.float32).contiguous() if bias is not None else None
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    lib = cuda_utils.load_library("matmul")
    fn = lib.bla_matmul
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        rc = fn(_VARIANTS[variant]["code"], _KERNEL_DTYPES[a.dtype],
                _KERNEL_DTYPES[out_dtype], a.data_ptr(), b.data_ptr(),
                bias_f32.data_ptr() if bias_f32 is not None else None,
                1 if activation == "relu" else 0, out.data_ptr(),
                m, n, k, stream)
    cuda_utils.check(lib, rc, f"matmul_{variant} kernel launch", out)
    launch_count += 1
    variant_launch_counts[variant] += 1
    return out


def _dispatch(a: torch.Tensor, b: torch.Tensor, variant: Variant,
              out_dtype: Optional[torch.dtype] = None,
              bias: Optional[torch.Tensor] = None,
              activation: Optional[str] = None) -> torch.Tensor:
    spec = _VARIANTS[variant]
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(
            f"matmul_{variant} expects 2-D operands, got {tuple(a.shape)} "
            f"and {tuple(b.shape)}")
    if not spec["check"](a, b):
        # Reference behavior: dimension mismatch is a hard error
        # (lib/matrix.c:36-39 printf + exit(1)).
        raise ValueError(f"matmul_{variant}: incompatible shapes "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if activation not in (None, "relu"):
        raise ValueError(f"unsupported fused activation {activation!r}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, bias)):
        raise RuntimeError(
            f"_dispatch (matmul_{variant}) records no autograd graph; "
            "differentiate through matmul, matmul_nt, matmul_tn, dense or "
            "conv2d_im2col, whose backwards are the hand-written rules")
    promoted = torch.result_type(a, b)
    if out_dtype is None:
        out_dtype = promoted
    m, n, k = spec["shapes"](a, b)
    # float64 (CPU parity mode) and tiny problems take the plain product,
    # keyed on the PROMOTED dtype as in the JAX package.
    if promoted.itemsize > 4 or 2 * m * n * k < _SMALL_FLOPS:
        return _plain_mm(a, b, variant, out_dtype, bias, activation)
    if a.device.type == "cuda":
        if a.dtype != promoted or b.dtype != promoted:
            a, b = a.to(promoted), b.to(promoted)
        return _kernel_mm(a, b, variant, out_dtype, bias, activation)
    if a.device.type == "cpu":
        return _plain_mm(a, b, variant, out_dtype, bias, activation)
    raise ValueError(f"matmul_{variant}: no kernel for device {a.device}")


# dC = g for C = f(A, B) (JAX ``_matmul_bwd``, the reference's dense backward
# model/mnist_nn.c:267-289 without its matrix_transpose clones):
#   nn: C = A @ B     → dA = g @ B.T  = nt(g, B);   dB = A.T @ g = tn(A, g)
#   nt: C = A @ B.T   → dA = g @ B    = nn(g, B);   dB = g.T @ A = tn(g, A)
#   tn: C = A.T @ B   → dA = B @ g.T  = nt(B, g);   dB = A @ g   = nn(A, g)
class _MatmulFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, variant):
        ctx.variant = variant
        ctx.save_for_backward(a, b)
        return _dispatch(a, b, variant)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(torch.result_type(a, b))
        need_a, need_b = ctx.needs_input_grad[:2]
        if ctx.variant == "nn":
            da = _dispatch(g, b, "nt", a.dtype) if need_a else None
            db = _dispatch(a, g, "tn", b.dtype) if need_b else None
        elif ctx.variant == "nt":
            da = _dispatch(g, b, "nn", a.dtype) if need_a else None
            db = _dispatch(g, a, "tn", b.dtype) if need_b else None
        else:  # tn
            da = _dispatch(b, g, "nt", a.dtype) if need_a else None
            db = _dispatch(a, g, "nn", b.dtype) if need_b else None
        return da, db, None


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``. Rebuilds ``matrix_multiply`` (lib/matrix.c:35)."""
    return _MatmulFn.apply(a, b, "nn")


def matmul_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` without materializing the transpose
    (model/mnist_nn.c:267-269)."""
    return _MatmulFn.apply(a, b, "nt")


def matmul_tn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a.T @ b`` without materializing the transpose
    (model/mnist_nn.c:273-275)."""
    return _MatmulFn.apply(a, b, "tn")
