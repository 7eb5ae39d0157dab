"""Group normalization, the counterpart of ``big_linear_algebra_tpu/nn/norm.py``
(≈ lib/norm.c).

Per channel-group mean and variance over (group channels × H × W), then
normalize; no learned scale or offset (the reference has none). As in the JAX
package:
- the default is textbook GN, dividing by ``sqrt(σ² + eps)``;
  ``reference_compat=True`` reproduces the reference's division by σ² with
  ε = 0 (SURVEY.md §7.5);
- statistics are taken in at least f32 (bf16 in, f32 stats, bf16 out);
- ragged groups (C not divisible by ``group_size``) follow the reference's
  ``num_in_this_group`` clamp (lib/norm.c:8-11): the channels are padded to
  whole groups, and the padding is masked out of the sums and the counts.

Forward only: the hand-written backward comes with training. The JAX package
leaves this op to XLA, so the port writes it as plain torch ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from big_linear_algebra_tpu_torch.ops import forward_only


def _stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """Statistics accumulate in ≥f32 (bf16 mean/variance loses too much)."""
    return dtype if dtype.itemsize >= 4 else torch.float32


def group_norm(x: torch.Tensor, group_size: int, eps: float = 1e-8,
               reference_compat: bool = False) -> torch.Tensor:
    """x: (..., C, H, W) → same shape. ≈ ``group_norm`` (lib/norm.c:5)."""
    forward_only.check("group_norm", x)
    xs = x.to(_stat_dtype(x.dtype))
    *lead, c, h, w = xs.shape
    n_groups = -(-c // group_size)
    pad_c = n_groups * group_size - c
    # (..., groups, group_size·H·W): one group's elements on the last axis
    xp = F.pad(xs, (0, 0, 0, 0, 0, pad_c)) if pad_c else xs
    xg = xp.reshape(*lead, n_groups, group_size * h * w)
    if pad_c:
        real = torch.arange(n_groups * group_size, device=x.device) < c
        mask = real.to(xs.dtype).reshape(n_groups, group_size, 1).expand(
            n_groups, group_size, h * w).reshape(n_groups, -1)
        counts = mask.sum(dim=-1, keepdim=True)
        mean = (xg * mask).sum(dim=-1, keepdim=True) / counts
        var = (((xg - mean) ** 2) * mask).sum(dim=-1, keepdim=True) / counts
    else:
        mean = xg.mean(dim=-1, keepdim=True)
        var = ((xg - mean) ** 2).mean(dim=-1, keepdim=True)
    denom = var if reference_compat else torch.sqrt(var + eps)
    out = ((xg - mean) / denom).reshape(*lead, n_groups * group_size, h, w)
    return out[..., :c, :, :].to(x.dtype)
