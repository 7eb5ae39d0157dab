"""2-D convolution with the reference's "same" padding, the counterpart of
``big_linear_algebra_tpu/nn/conv.py`` (≈ lib/conv.c).

Correlation (no kernel flip) over channels-first maps with TF-style "SAME"
padding: total pad ``(ceil(in/s)−1)·s + k − in`` split floor (lo) / ceil (hi)
(lib/conv.c:13-24), output ``ceil(in/s)``; no bias. The split is asymmetric
whenever the total is odd — the stride-2 downsample of an even size pads
lo = 0, hi = 1 — which ``F.conv2d``'s symmetric ``padding`` cannot express,
so such inputs are padded with ``F.pad`` first.

The JAX package leaves the convolution itself to XLA; the port leaves it to
cuDNN through ``F.conv2d``. f32 runs in true f32 (the package switches TF32
off at import, ``ops/precision.py``); bf16 stays bf16 in and out, with f32
accumulation; f64 (CPU parity mode) stays f64.

Forward only: the hand-written dilated-conv backward comes with training.

Layouts: x (B, C, H, W); kernels (F, C, kh, kw).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from big_linear_algebra_tpu_torch.ops import forward_only


def same_padding(in_size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """The reference's pad split (lib/conv.c:13-24): total =
    (ceil(in/s)−1)·s + k − in, lo = floor(total/2), hi = ceil(total/2)."""
    total = (math.ceil(in_size / stride) - 1) * stride + kernel - in_size
    total = max(total, 0)
    return total // 2, (total + 1) // 2


def out_size(in_size: int, stride: int) -> int:
    """out = ceil(in/stride) (lib/conv.c:56-57)."""
    return math.ceil(in_size / stride)


def conv2d(x: torch.Tensor, kernels: torch.Tensor,
           stride: int = 1) -> torch.Tensor:
    """x: (B, C, H, W), kernels: (F, C, kh, kw) → (B, F, ceil(H/s),
    ceil(W/s)), in x's dtype."""
    forward_only.check("conv2d", x, kernels)
    kh, kw = kernels.shape[-2:]
    (top, bottom) = same_padding(x.shape[-2], kh, stride)
    (left, right) = same_padding(x.shape[-1], kw, stride)
    if top == bottom and left == right:
        return F.conv2d(x, kernels, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), kernels,
                    stride=stride)
