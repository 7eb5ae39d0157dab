"""Group normalization, the counterpart of ``big_linear_algebra_tpu/nn/norm.py``
(≈ lib/norm.c), with its hand-written backward.

Per channel-group mean and variance over (group channels × H × W), then
normalize; no learned scale or offset (the reference has none). As in the JAX
package:
- the default is textbook GN, dividing by ``sqrt(σ² + eps)``;
  ``reference_compat=True`` reproduces the reference's division by σ² with
  ε = 0 (SURVEY.md §7.5);
- statistics are taken in at least f32 (bf16 in, f32 stats, bf16 out);
- ragged groups (C not divisible by ``group_size``) follow the reference's
  ``num_in_this_group`` clamp (lib/norm.c:8-11): the channels are padded to
  whole groups, and the padding is masked out of the sums and the counts;
- the backward (lib/norm.c:52-91) centres the gradient and removes its
  projection on the normalized value, ``dx = (g − mean(g) − x̂·mean(g·x̂))
  / denom``, with the forward's group means (ragged mask included).

The JAX package leaves this op to XLA, so the port writes it as plain torch
ops inside a ``torch.autograd.Function``. ``group_norm_nhwc`` is the
channels-last twin, (..., H, W, C), whose groups are reduced where they lie
(over H·W and the group's channels), so its maps stay channels-last.

``group_norm_affine`` is the ADM U-Net's normalization (guided-diffusion's
``GroupNorm32``: 32 groups, eps 1e-5, a learned per-channel scale γ and
offset β, computed in f32 and returned in x's dtype), with its own
backward: dγ = Σ g·x̂ and dβ = Σ g over batch and space, and the group
backward above on g·γ. It saves x (no f32 copy) and recomputes x̂.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """Statistics accumulate in ≥f32 (bf16 mean/variance loses too much)."""
    return dtype if dtype.itemsize >= 4 else torch.float32


def _group_reduce(x: torch.Tensor, group_size: int, with_var: bool,
                  nhwc: bool = False):
    """Per-group (mean, var) of x (..., C, H, W), broadcast back per channel
    as (..., C, 1, 1); with ``nhwc`` of x (..., H, W, C) as (..., 1, 1, C).
    var is None without ``with_var``. The one place the group formulas
    live, for the forward's statistics and the backward's means alike, in
    either layout."""
    if nhwc:
        *lead, h, w, c = x.shape
    else:
        *lead, c, h, w = x.shape
    n_groups = -(-c // group_size)
    pad_c = n_groups * group_size - c
    if nhwc:
        # (..., H·W, groups, group_size)
        xp = F.pad(x, (0, pad_c)) if pad_c else x
        xg = xp.reshape(*lead, h * w, n_groups, group_size)
        mask_shape = (n_groups, group_size)
    else:
        # (..., groups, group_size·H·W): one group's elements on the last axis
        xp = F.pad(x, (0, 0, 0, 0, 0, pad_c)) if pad_c else x
        xg = xp.reshape(*lead, n_groups, group_size * h * w)
        mask_shape = (n_groups, group_size * h * w)

    def group_sum(t):
        if not nhwc:
            return t.sum(dim=-1, keepdim=True)
        # over the group's channels, then over H·W along the contiguous
        # axis of the (..., groups, H·W) partial sums (1/group_size of the
        # map): a strided sum over H·W adds its terms one by one on the CPU,
        # with several times the f32 rounding of the NCHW layout's sum
        part = t.sum(dim=-1).transpose(-1, -2).contiguous()
        return part.sum(dim=-1)[..., None, :, None]

    if pad_c:
        real = torch.arange(n_groups * group_size, device=x.device) < c
        mask = real.to(x.dtype).reshape(n_groups, group_size, 1).expand(
            n_groups, group_size, 1 if nhwc else h * w).reshape(mask_shape)
        counts = mask.sum(dim=-1, keepdim=True)
        if nhwc:
            counts = counts * (h * w)
        mean = group_sum(xg * mask) / counts
        var = (group_sum(((xg - mean) ** 2) * mask) / counts if with_var
               else None)
    elif nhwc:
        n = group_size * h * w
        mean = group_sum(xg) / n
        var = group_sum((xg - mean) ** 2) / n if with_var else None
    else:
        mean = xg.mean(dim=-1, keepdim=True)
        var = ((xg - mean) ** 2).mean(dim=-1, keepdim=True) if with_var \
            else None

    def per_channel(stat):
        if nhwc:  # (..., 1, groups, 1) → (..., 1, 1, C)
            return stat.expand(*lead, 1, n_groups, group_size).reshape(
                *lead, 1, 1, n_groups * group_size)[..., :c]
        out = stat.expand(*lead, n_groups, group_size).reshape(
            *lead, n_groups * group_size)[..., :c]
        return out[..., None, None]

    return per_channel(mean), per_channel(var) if with_var else None


def _denom(var, eps, reference_compat):
    # the reference divides by the variance with ε = 0 (SURVEY.md §7.5)
    return var if reference_compat else torch.sqrt(var + eps)


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group_size, eps, reference_compat, nhwc):
        # contiguous out in x's own layout, whatever x's strides (the NCHW
        # attention block hands over channels-last views): the convs that
        # follow would take other algorithms, and round otherwise. An NHWC
        # map's contiguous order is channels-last memory.
        xs = x.to(_stat_dtype(x.dtype)).contiguous()
        mean, var = _group_reduce(xs, group_size, True, nhwc)
        ctx.save_for_backward(x, mean, var)
        ctx.args = (group_size, eps, reference_compat, nhwc)
        return ((xs - mean) / _denom(var, eps, reference_compat)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        """The JAX package's ``_group_norm_bwd`` (``_group_norm_nhwc_bwd``
        with ``nhwc``)."""
        x, mean, var = ctx.saved_tensors
        group_size, eps, reference_compat, nhwc = ctx.args
        g = g.to(_stat_dtype(x.dtype))
        denom = _denom(var, eps, reference_compat)
        xhat = (x.to(g.dtype) - mean) / denom
        g_mean = _group_reduce(g, group_size, False, nhwc)[0]
        gx_mean = _group_reduce(g * xhat, group_size, False, nhwc)[0]
        dx = (g - g_mean - xhat * gx_mean) / denom
        return dx.to(x.dtype), None, None, None, None


def group_norm(x: torch.Tensor, group_size: int, eps: float = 1e-8,
               reference_compat: bool = False) -> torch.Tensor:
    """x: (..., C, H, W) → same shape. ≈ ``group_norm`` (lib/norm.c:5)."""
    return _GroupNorm.apply(x, group_size, eps, reference_compat, False)


def group_norm_nhwc(x: torch.Tensor, group_size: int, eps: float = 1e-8,
                    reference_compat: bool = False) -> torch.Tensor:
    """x: (..., H, W, C) → same shape, contiguous (channels-last memory):
    ``group_norm`` channels-last."""
    return _GroupNorm.apply(x, group_size, eps, reference_compat, True)


class _GroupNormAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, group_size, eps):
        xs = x.to(_stat_dtype(x.dtype)).contiguous()
        mean, var = _group_reduce(xs, group_size, True)
        xhat = (xs - mean) / torch.sqrt(var + eps)
        y = (xhat * gamma.to(xs.dtype)[:, None, None]
             + beta.to(xs.dtype)[:, None, None])
        ctx.save_for_backward(x, mean, var, gamma)
        ctx.args = (group_size, eps, beta.dtype)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, mean, var, gamma = ctx.saved_tensors
        group_size, eps, beta_dtype = ctx.args
        g = g.to(_stat_dtype(x.dtype))
        denom = torch.sqrt(var + eps)
        xhat = (x.to(g.dtype) - mean) / denom
        dims = tuple(i for i in range(g.ndim) if i != g.ndim - 3)
        dgamma = (g * xhat).sum(dim=dims)
        dbeta = g.sum(dim=dims)
        g = g * gamma.to(g.dtype)[:, None, None]
        g_mean = _group_reduce(g, group_size, False)[0]
        gx_mean = _group_reduce(g * xhat, group_size, False)[0]
        dx = (g - g_mean - xhat * gx_mean) / denom
        return (dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(beta_dtype),
                None, None)


def group_norm_affine(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, groups: int = 32,
                      eps: float = 1e-5) -> torch.Tensor:
    """x: (..., C, H, W) → same shape: ``groups`` groups of C/groups
    channels, normalized in ≥f32, then x̂·γ + β per channel (γ, β: (C,))."""
    c = x.shape[-3]
    if c % groups:
        raise ValueError(f"group_norm_affine: {c} channels do not split "
                         f"into {groups} groups")
    return _GroupNormAffine.apply(x, gamma, beta, c // groups, eps)
