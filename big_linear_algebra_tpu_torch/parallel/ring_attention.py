"""Sequence-parallel ring attention over a mesh axis, the counterpart of
``big_linear_algebra_tpu/parallel/ring_attention.py``.

The sequence is sharded over an axis: each rank holds its rows of q, k
and v, (B, N/P, d). q stays; the k/v blocks rotate around the ring, each
rank sending to the next rank of the axis and receiving from the previous
one (``spmd.hop``, point-to-point; JAX's ``ppermute``).

- **Forward**: each of the P rotations runs the flash forward (K2,
  ``nn/attention.py`` ``_kernel_flash``, on a CUDA tensor; its plain
  version on a CPU tensor) on (local q, visiting k/v) → a partial (o_r,
  lse_r), and the partials are merged by the stable logsumexp combination
  (``_merge``), lse in the natural-log domain as the flash forward returns
  it. Each rotation's K2 scales and rounds q the same way, so the merged
  lse belongs to the scores every backward kernel recomputes.
- **Backward**: a ``torch.autograd.Function`` with JAX's explicit VJP. The
  rotation-invariant prep (g in q's dtype, delta = Σ g·o, lse moved to
  log₂) is made once from the *global* (o, lse); each rotation then runs
  K2c (dq) and K2d (dk, dv) on (local q, visiting k/v), which yields
  exactly that block's share, because p = exp2(s − lse2) with the global
  lse is that block's slice of the softmax. dq accumulates locally; dk and
  dv accumulate in buffers that travel with their k/v block, and a final
  hop brings them home. This is the route JAX's ``_flash_bwd_padded``
  call without ``stream`` takes (its streaming dq and dk/dv kernels), not
  the fused K3a.

JAX's ``_ring_blocks`` picks Pallas block sizes that pad the local shard
to the TPU's 8-row sublane tile; the CUDA kernels tile and mask ragged
rows on their own, so it has no counterpart (nor has its sublane test).

Comm: P−1 hops of the local k/v forward; P hops backward (P−1 of k, v, dk
and dv in the loop, one final hop of dk and dv). Single head, (B, N, d),
as ``nn/attention.py``.
"""

from __future__ import annotations

import torch

from big_linear_algebra_tpu_torch.nn.attention import (
    _by_device,
    _check_self_attention,
    _kernel_bwd_dkv,
    _kernel_bwd_dq,
    _kernel_bwd_operands,
    _kernel_flash,
    _plain_flash,
    _plain_flash_bwd,
)
from big_linear_algebra_tpu_torch.ops import cuda_utils
from big_linear_algebra_tpu_torch.ops.precision import accum_dtype
from big_linear_algebra_tpu_torch.parallel.spmd import hop


def _merge(o, lse, o_r, lse_r):
    """Stable merge of two flash partials (o in the accumulation type, lse
    in the natural-log domain)."""
    new_lse = torch.logaddexp(lse, lse_r)
    o = (o * torch.exp(lse - new_lse)[..., None]
         + o_r.to(o.dtype) * torch.exp(lse_r - new_lse)[..., None])
    return o, new_lse


def _block_bwd(q, kr, vr, o, lse, g, prepared):
    """(dq, dk, dv) of one visiting block with the global (o, lse): K2c and
    K2d on prepared CUDA operands, or the plain backward on the CPU."""
    if prepared is None:
        return _plain_flash_bwd(q, kr, vr, o, lse, g)
    qp, gp, lse2, delta = prepared
    kr, vr = cuda_utils.aligned(kr), cuda_utils.aligned(vr)
    return (_kernel_bwd_dq(qp, kr, vr, gp, lse2, delta),
            *_kernel_bwd_dkv(qp, kr, vr, gp, lse2, delta))


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis):
        flash = _by_device(q, _kernel_flash, _plain_flash)
        acc = accum_dtype(q.dtype)
        o_r, lse = flash(q, k, v)
        o, lse = o_r.to(acc), lse.to(acc)
        kr, vr = k, v
        for _ in range(mesh.size(axis) - 1):
            kr, vr = hop([kr, vr], mesh, axis)
            o_r, lse_r = flash(q, kr, vr)
            o, lse = _merge(o, lse, o_r, lse_r.to(acc))
        o = o.to(q.dtype)
        ctx.mesh, ctx.axis = mesh, axis
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        mesh, axis = ctx.mesh, ctx.axis
        acc = accum_dtype(q.dtype)
        prepared = None
        if q.device.type == "cuda":  # the prep once, then only k/v change
            qp, _, _, gp, lse2, delta = _kernel_bwd_operands(q, k, v, o,
                                                             lse, g)
            prepared = (qp, gp, lse2, delta)
        dq = torch.zeros(q.shape, dtype=acc, device=q.device)
        kr, vr = k, v
        dkr = torch.zeros(k.shape, dtype=acc, device=k.device)
        dvr = torch.zeros(v.shape, dtype=acc, device=v.device)
        for r in range(mesh.size(axis)):
            if r > 0:
                kr, vr, dkr, dvr = hop([kr, vr, dkr, dvr], mesh, axis)
            dq_r, dk_r, dv_r = _block_bwd(q, kr, vr, o, lse, g, prepared)
            dq = dq + dq_r.to(acc)
            dkr = dkr + dk_r.to(acc)
            dvr = dvr + dv_r.to(acc)
        # after P−1 hops each (k, dk, dv) bundle sits one rank short of its
        # owner; one final hop brings the accumulated gradients home
        dkr, dvr = hop([dkr, dvr], mesh, axis)
        return dq.to(q.dtype), dkr.to(k.dtype), dvr.to(v.dtype), None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis_name: str = "seq") -> torch.Tensor:
    """Sequence-sharded attention: q, k, v are this rank's rows (B, N/P, d)
    of a sequence sharded over ``axis_name`` in axis order; returns this
    rank's rows of softmax(QKᵀ/√d)V over the whole sequence. Exact (up to
    rounding) against ``attention_dense`` on the gathered sequence. Every
    rank of the axis must call it with the same shapes."""
    _check_self_attention(q, k, v)
    return _RingFlash.apply(q, k, v, mesh, axis_name)
