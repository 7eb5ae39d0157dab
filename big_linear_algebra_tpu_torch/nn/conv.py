"""2-D convolution with the reference's "same" padding and a hand-written
backward, the counterpart of ``big_linear_algebra_tpu/nn/conv.py`` (≈
lib/conv.c).

Correlation (no kernel flip) over channels-first maps with TF-style "SAME"
padding: total pad ``(ceil(in/s)−1)·s + k − in`` split floor (lo) / ceil (hi)
(lib/conv.c:13-24), output ``ceil(in/s)``; no bias. The split is asymmetric
whenever the total is odd — the stride-2 downsample of an even size pads
lo = 0, hi = 1 — which ``F.conv2d``'s symmetric ``padding`` cannot express,
so such inputs are padded with ``F.pad`` first.

The backward is the JAX package's (a ``torch.autograd.Function``), after
the reference's ``del_X = col2im(del_Q @ Kᵀ)`` and ``del_K = im2colᵀ @
del_Q`` (lib/conv.c:214-227):
- dx: the gradient, dilated by the stride, convolved with the spatially
  flipped, channel-transposed kernels, padded by ``_dx_pads`` (which derive
  from the asymmetric forward split);
- dk: the correlation of the padded input with the stride-dilated gradient,
  formed as the reference's ``im2colᵀ @ del_Q``: one GEMM over the batch
  and the output positions, exactly kh×kw taps (the leading ones where
  "same" padding clamps to 0).

The JAX package leaves the convolutions to XLA; the port leaves them to
cuDNN through ``F.conv2d`` and dk's GEMM to cuBLAS. f32 runs in true f32
(the package switches TF32 off at import, ``ops/precision.py``); bf16 stays
bf16 in and out, with f32 accumulation; f64 (CPU parity mode) stays f64.

Layouts: x (B, C, H, W); kernels (F, C, kh, kw). ``conv2d_nhwc`` is the
channels-last twin: x (B, H, W, C), kernels still (F, C, kh, kw). A
contiguous (B, H, W, C) tensor viewed through ``permute(0, 3, 1, 2)`` is a
``torch.channels_last`` NCHW tensor, so its forward and dx run on the same
``F.conv2d`` in channels-last memory with no copy of the activations (cuDNN
writes its output channels-last too), and its dk is the same
``im2colᵀ @ del_Q`` GEMM with the windows taken along H and W of the NHWC
map. ``conv2d_single`` is the reference's unbatched (C, H, W) signature.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def same_padding(in_size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """The reference's pad split (lib/conv.c:13-24): total =
    (ceil(in/s)−1)·s + k − in, lo = floor(total/2), hi = ceil(total/2)."""
    total = (math.ceil(in_size / stride) - 1) * stride + kernel - in_size
    total = max(total, 0)
    return total // 2, (total + 1) // 2


def out_size(in_size: int, stride: int) -> int:
    """out = ceil(in/stride) (lib/conv.c:56-57)."""
    return math.ceil(in_size / stride)


def _dx_pads(in_size: int, k: int, stride: int,
             g_size: int) -> Tuple[int, int]:
    """Transpose-conv padding for dx along one dim: the pads that make the
    stride-dilated gradient, convolved with the flipped kernel, produce
    exactly ``in_size`` outputs."""
    lo, _ = same_padding(in_size, k, stride)
    dil = (g_size - 1) * stride + 1
    pad_lo = k - 1 - lo
    pad_hi = in_size + k - 1 - dil - pad_lo
    return pad_lo, pad_hi


def _hw(nhwc: bool) -> Tuple[int, int]:
    """The spatial dims of a map in either layout."""
    return (1, 2) if nhwc else (2, 3)


def _pad(x, pads, nhwc: bool):
    (top, bottom), (left, right) = pads
    return F.pad(x, (0, 0, left, right, top, bottom) if nhwc
                 else (left, right, top, bottom))


def _conv(x, kernels, pads, stride=1, nhwc=False):
    """F.conv2d with pads ((top, bottom), (left, right)), through its own
    ``padding`` where they are symmetric. ``nhwc``: x is (B, H, W, C),
    handed to F.conv2d as its channels-last view, and so is the output."""
    (top, bottom), (left, right) = pads
    if top == bottom and left == right:
        padding = (top, left)
    else:
        x, padding = _pad(x, pads, nhwc), 0
    if nhwc:
        return F.conv2d(x.permute(0, 3, 1, 2), kernels, stride=stride,
                        padding=padding).permute(0, 2, 3, 1)
    return F.conv2d(x, kernels, stride=stride, padding=padding)


def _same_pads(x, kernel_shape, stride, nhwc=False):
    kh, kw = kernel_shape[-2:]
    h, w = _hw(nhwc)
    return (same_padding(x.shape[h], kh, stride),
            same_padding(x.shape[w], kw, stride))


def _dilate(g: torch.Tensor, stride: int, nhwc=False) -> torch.Tensor:
    """Insert stride − 1 zeros between neighbouring elements of the spatial
    dims (XLA's ``lhs_dilation``)."""
    if stride == 1:
        return g
    shape = list(g.shape)
    for d in _hw(nhwc):
        shape[d] = (shape[d] - 1) * stride + 1
    out = g.new_zeros(shape)
    if nhwc:
        out[:, ::stride, ::stride, :] = g
    else:
        out[:, :, ::stride, ::stride] = g
    return out


def _dx_conv(g, kernels, stride, in_shape, nhwc=False):
    kh, kw = kernels.shape[-2:]
    h, w = _hw(nhwc)
    k_t = torch.flip(kernels, dims=(-2, -1)).transpose(0, 1)  # (C, F, kh, kw)
    pads = (_dx_pads(in_shape[h], kh, stride, g.shape[h]),
            _dx_pads(in_shape[w], kw, stride, g.shape[w]))
    return _conv(_dilate(g, stride, nhwc), k_t, pads, nhwc=nhwc)


def _dk_conv(x, g, stride, k_shape):
    """The correlation of the padded input with the stride-dilated gradient,
    as the reference forms it: ``im2colᵀ @ del_Q`` (lib/conv.c:214-227),
    one GEMM over the batch and the output positions. Passed to
    ``F.conv2d`` with the gradient as an oh×ow kernel (the JAX package's
    form), cuDNN takes a generic kernel off the tensor cores, ~100× slower
    at the U-Net's 64×64 maps. The windows are exactly kh×kw, so where
    "same" padding clamps to 0 (a kernel smaller than the stride) they are
    the leading kh×kw taps that the JAX package's clamp keeps."""
    f, c, kh, kw = k_shape
    (top, bottom), (left, right) = _same_pads(x, k_shape, stride)
    cols = F.unfold(F.pad(x, (left, right, top, bottom)), (kh, kw),
                    stride=stride)                       # (B, C·kh·kw, L)
    b, ckk, _ = cols.shape
    # (rows, B·L) operands: the copies keep L, the fastest axis, in place
    g = g.reshape(b, f, -1).transpose(0, 1).reshape(f, -1)
    cols = cols.transpose(0, 1).reshape(ckk, -1)
    return (g @ cols.T).reshape(f, c, kh, kw)


def _dk_conv_nhwc(x, g, stride, k_shape):
    """``_dk_conv`` on (B, H, W, C) maps: the same GEMM, its contraction
    over the batch and the output positions in the same order. The
    windows are strided views along H and W of the padded map, copied once
    into (B·oh·ow, C·kh·kw) rows; the gradient's (B·oh·ow, F) rows are a
    view. (The JAX package's NHWC dk is a conv with the gradient as its
    kernel, which cuDNN runs off the tensor cores; see ``_dk_conv``.)"""
    f, c, kh, kw = k_shape
    xp = _pad(x, _same_pads(x, k_shape, stride, True), True)
    cols = xp.unfold(1, kh, stride).unfold(2, kw, stride)  # (B,oh,ow,C,kh,kw)
    return (g.reshape(-1, f).T @ cols.reshape(-1, c * kh * kw)).reshape(
        f, c, kh, kw)


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernels, stride):
        ctx.save_for_backward(x, kernels)
        ctx.stride = stride
        return _conv(x, kernels, _same_pads(x, kernels.shape, stride), stride)

    @staticmethod
    def backward(ctx, g):
        """The JAX package's ``_conv2d_bwd``."""
        x, kernels = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = _dx_conv(g, kernels, ctx.stride, x.shape)
        dk = _dk_conv(x, g, ctx.stride, kernels.shape)
        return dx, dk.contiguous(), None


def conv2d(x: torch.Tensor, kernels: torch.Tensor,
           stride: int = 1) -> torch.Tensor:
    """x: (B, C, H, W), kernels: (F, C, kh, kw) → (B, F, ceil(H/s),
    ceil(W/s)), in x's dtype."""
    return _Conv2d.apply(x, kernels, stride)


def conv2d_single(x: torch.Tensor, kernels: torch.Tensor,
                  stride: int = 1) -> torch.Tensor:
    """The reference's unbatched signature (lib/conv.c:205): x (C, H, W)
    → (F, ceil(H/s), ceil(W/s))."""
    return conv2d(x[None], kernels, stride)[0]


class _Conv2dNHWC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernels, stride):
        ctx.save_for_backward(x, kernels)
        ctx.stride = stride
        return _conv(x, kernels, _same_pads(x, kernels.shape, stride, True),
                     stride, nhwc=True)

    @staticmethod
    def backward(ctx, g):
        """The JAX package's ``_conv2d_nhwc_bwd``, dk as ``_dk_conv``'s
        GEMM (``_dk_conv_nhwc``)."""
        x, kernels = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()  # (B, oh, ow, F): channels-last
        dx = _dx_conv(g, kernels, ctx.stride, x.shape, nhwc=True)
        dk = _dk_conv_nhwc(x, g, ctx.stride, kernels.shape)
        return dx, dk.contiguous(), None


def conv2d_nhwc(x: torch.Tensor, kernels: torch.Tensor,
                stride: int = 1) -> torch.Tensor:
    """The channels-last twin of ``conv2d``: x (B, H, W, C), kernels (F, C,
    kh, kw) → (B, ceil(H/s), ceil(W/s), F), in x's dtype; a contiguous x
    gives a contiguous output (channels-last memory throughout)."""
    return _Conv2dNHWC.apply(x, kernels, stride)
