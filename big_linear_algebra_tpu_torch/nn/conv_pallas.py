"""Explicit im2col → GEMM convolution (the reference's formulation), the
counterpart of ``big_linear_algebra_tpu/nn/conv_pallas.py``.

The reference computes conv as ``_im2col`` → kernel reshape → GEMM → reshape
(lib/conv.c:205-212) and its backward as two GEMMs and ``_col2im``
(lib/conv.c:214-227). ``nn/conv.py`` is the production path; this module is
the same math materialized the reference's way, with its three GEMMs on the
port's K1 (``ops/matmul.py`` ``_dispatch``: nn forward, tn for dk, nt for
dx's columns, each with ``_dispatch``'s small/f64 rule), kept for parity
work.

- ``im2col``: patch extraction with the reference's column order
  (c·k² + i·k + j, lib/conv.c:59-74), ``F.unfold`` on the "same" padding
  (asymmetric where its total is odd).
- ``col2im``: the exact transpose of ``im2col``, ``F.fold`` then a crop of
  the padding: the scatter-add with the *intended* output-grid iteration
  (the reference's loop is out of bounds at stride > 1, SURVEY.md §7.14).
- ``conv2d_im2col``: a ``torch.autograd.Function`` equal to ``conv2d``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from big_linear_algebra_tpu_torch.nn.conv import out_size, same_padding
from big_linear_algebra_tpu_torch.ops.matmul import _dispatch


def _pads(h: int, w: int, k: int, stride: int):
    """(top, bottom), (left, right) of the reference's "same" padding."""
    return same_padding(h, k, stride), same_padding(w, k, stride)


def im2col(x: torch.Tensor, kernel_size: int, stride: int) -> torch.Tensor:
    """x: (B, C, H, W) → (B, oh·ow, k·k·C) patches with the reference's
    column order (channel-major, then kernel row, then kernel column)."""
    _, _, h, w = x.shape
    (top, bottom), (left, right) = _pads(h, w, kernel_size, stride)
    cols = F.unfold(F.pad(x, (left, right, top, bottom)), kernel_size,
                    stride=stride)                       # (B, C·k·k, L)
    return cols.transpose(1, 2)


def col2im(cols: torch.Tensor, x_shape, kernel_size: int,
           stride: int) -> torch.Tensor:
    """(B, oh·ow, k·k·C) → (B, C, H, W) scatter-add (the intended
    ``_col2im``): the transpose of ``im2col``."""
    _, _, h, w = x_shape
    (top, bottom), (left, right) = _pads(h, w, kernel_size, stride)
    padded = F.fold(cols.transpose(1, 2),
                    (h + top + bottom, w + left + right), kernel_size,
                    stride=stride)
    return padded[:, :, top:top + h, left:left + w]


def kernels_to_matrix(kernels: torch.Tensor) -> torch.Tensor:
    """(F, C, k, k) → (k·k·C, F) with the reference row order
    (c·k² + i·k + j — ``_reshape_kernels_matrix``, lib/conv.c:138-155)."""
    return kernels.reshape(kernels.shape[0], -1).T


class _Conv2dIm2col(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernels, stride):
        b, _, h, w = x.shape
        f, _, k, _ = kernels.shape
        cols = im2col(x, k, stride)                      # (B, P, k²C)
        p = cols.shape[1]
        prod = _dispatch(cols.reshape(b * p, -1), kernels_to_matrix(kernels),
                         "nn", x.dtype)
        ctx.save_for_backward(kernels, cols)
        ctx.x_shape, ctx.stride = x.shape, stride
        oh, ow = out_size(h, stride), out_size(w, stride)
        return prod.reshape(b, oh, ow, f).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        """The JAX package's ``_conv_bwd``: del_K = im2colᵀ @ del_Q and
        del_X = col2im(del_Q @ Kᵀ) (lib/conv.c:214-227)."""
        kernels, cols = ctx.saved_tensors
        f, c, k, _ = kernels.shape
        b, p = cols.shape[:2]
        # del_Q: (B·P, F) (the intended reshape direction, SURVEY.md §7.1)
        dq = g.permute(0, 2, 3, 1).reshape(b * p, f).to(cols.dtype)
        cols2 = cols.reshape(b * p, -1)
        dk = _dispatch(cols2, dq, "tn", kernels.dtype).T.reshape(f, c, k, k)
        dcols = _dispatch(dq, kernels_to_matrix(kernels), "nt", cols.dtype)
        dx = col2im(dcols.reshape(b, p, -1), ctx.x_shape, k, ctx.stride)
        return dx, dk.contiguous(), None


def conv2d_im2col(x: torch.Tensor, kernels: torch.Tensor,
                  stride: int = 1) -> torch.Tensor:
    """Reference-formulation conv: im2col → K1 GEMM → reshape. Equal to
    ``nn/conv.py``'s ``conv2d`` up to the order of the sums."""
    return _Conv2dIm2col.apply(x, kernels, stride)
