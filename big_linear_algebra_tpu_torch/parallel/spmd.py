"""Collectives over a mesh axis, the counterpart of
``big_linear_algebra_tpu/parallel/spmd.py``.

JAX writes a sharded step once, per shard, and ``shard_map`` runs it on
every device of the mesh; its ``shard_map_fn`` exists to do that. Under
``torch.distributed`` every rank is already a process that runs its own
shard, so the port has no counterpart of ``shard_map_fn``: a step here is
the per-shard body itself, and its collectives are explicit calls.

- ``psum_tree`` / ``pmean_tree``: a tree of tensors summed (averaged) over
  an axis, packed into one buffer for one all-reduce.
- ``all_gather`` and ``psum``: the collectives that sit inside a
  differentiated step, each a ``torch.autograd.Function`` with an explicit
  backward (the port's rule for every op). ``all_gather``'s backward is
  this rank's slice of the cotangent summed over the axis: JAX transposes
  ``all_gather`` into ``psum_scatter``. ``psum``'s backward is the
  identity, as JAX's transpose of ``psum`` under ``shard_map`` is.
- ``hop``: each rank sends to the rank ``direction`` steps along its line
  and receives from the rank as far behind it (JAX's ``ppermute`` with
  ``i → i+1``, or ``i → i−1``), by ``batch_isend_irecv``: around the ring,
  or between neighbours only, with received shapes of their own (the
  pipeline's stage boundaries).

On the gloo backend, CUDA tensors go through host memory: each collective
and each point-to-point send copies its buffer to the CPU, runs there and
copies the result back, one rule for all of them (gloo runs on the host;
this is how ranks that share one card exchange data). NCCL takes the
device buffers. On a line of one rank, or outside a process group, every
collective is the identity.

Under NCCL the collectives read nothing to the host and allocate only on
the current stream's pool (an all-gather fills one flat buffer), so a step
that makes them can be captured in a CUDA graph (``utils/graphs.py``) once
every group it uses has run a collective (NCCL makes a group's
communicator at its first one).

``collective_calls`` counts every collective; ``collective_bytes`` gives,
for each kind ("all_reduce", "all_gather", "hop"), the bytes this rank
handed to it (the buffer summed, this rank's part gathered, the tensors
sent). The count and the bytes come from the call and the shapes, with no
device read, and a graph's replay adds what its capture recorded.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from big_linear_algebra_tpu_torch.nn.optim import tree_leaves, tree_map

collective_calls = 0
collective_bytes = {"all_reduce": 0, "all_gather": 0, "hop": 0}


def _count(kind: str, tensors=()) -> None:
    global collective_calls
    collective_calls += 1
    collective_bytes[kind] += sum(t.numel() * t.element_size()
                                  for t in tensors if t is not None)


def _staged(x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend() == "gloo"


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over ``group`` (a new tensor; x itself is unchanged). The
    buffer is contiguous whatever x's strides: the ranks sum their buffers
    in memory order, so a channels-last x on one rank and a contiguous one
    on another would add unlike elements."""
    _count("all_reduce", [x])
    buf = (x.cpu() if _staged(x) else x).clone(
        memory_format=torch.contiguous_format)
    dist.all_reduce(buf, group=group)
    return buf.to(x.device)


def _reduce_dtype(dtype: torch.dtype) -> torch.dtype:
    # bf16 and f16 leaves are summed in f32, then rounded once
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype


def _psum_leaves(leaves, group) -> list:
    """The leaves summed over ``group``: those of one reduction dtype packed
    into one buffer, one all-reduce per dtype; returned in that dtype."""
    out = [None] * len(leaves)
    by_dtype = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(_reduce_dtype(leaf.dtype), []).append(i)
    for dtype, idx in by_dtype.items():
        flat = torch.cat([leaves[i].reshape(-1).to(dtype) for i in idx])
        summed = _all_reduce(flat, group)
        at = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = summed[at:at + n].reshape(leaves[i].shape)
            at += n
    return out


def psum_tree(tree: Any, mesh, axis: str = "data") -> Any:
    """Every leaf of ``tree`` (a tensor or nested dicts of tensors) summed
    over ``axis`` (the gradient all-reduce), in one all-reduce per dtype.
    bf16 leaves are summed in f32 and rounded back once."""
    group = mesh.group(axis)
    if group is None:
        return tree
    it = iter(_psum_leaves(tree_leaves(tree), group))
    return tree_map(lambda leaf: next(it).to(leaf.dtype), tree)


def pmean_tree(tree: Any, mesh, axis: str = "data") -> Any:
    """Every leaf of ``tree`` averaged over ``axis``: the sum in the leaf's
    reduction dtype, divided by the axis size, rounded back once."""
    group = mesh.group(axis)
    if group is None:
        return tree
    size = mesh.size(axis)
    it = iter(_psum_leaves(tree_leaves(tree), group))
    return tree_map(lambda leaf: (next(it) / size).to(leaf.dtype), tree)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.index, ctx.width = mesh.index(axis), x.shape[dim]
        group = mesh.group(axis)
        if group is None:
            return x.clone()
        _count("all_gather", [x])
        n = mesh.size(axis)
        if dist.get_backend() != "nccl":
            src = x.cpu().contiguous() if _staged(x) else x.contiguous()
            parts = [torch.empty_like(src) for _ in range(n)]
            dist.all_gather(parts, src, group=group)
            return torch.cat(parts, dim=dim).to(x.device)
        src = x.contiguous()
        flat = torch.empty((n,) + tuple(src.shape), dtype=src.dtype,
                           device=src.device)
        dist.all_gather_into_tensor(flat, src, group=group)
        return torch.cat(flat.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        """psum_scatter: the cotangent summed over the axis, then this
        rank's slice of it."""
        group = ctx.mesh.group(ctx.axis)
        if group is not None:  # bf16 and f16 summed in f32, rounded once
            g = _all_reduce(g.to(_reduce_dtype(g.dtype)).contiguous(),
                            group).to(g.dtype)
        return (g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width),
                None, None, None)


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` concatenated on ``dim`` in axis order
    (JAX's ``all_gather(..., tiled=True)``), differentiable."""
    return _AllGather.apply(x, mesh, axis, dim)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        group = mesh.group(axis)
        if group is None:
            return x.clone()
        return _all_reduce(x.to(_reduce_dtype(x.dtype)), group).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` summed over ``axis`` (bf16 and f16 in f32, rounded once),
    differentiable (backward: identity)."""
    return _Psum.apply(x, mesh, axis)


def hop(tensors, mesh, axis: str, direction: int = 1, like=None,
        wrap: bool = True):
    """Each rank's ``tensors`` sent to the rank ``direction`` steps along its
    line of ``axis``, and those of the rank ``direction`` steps behind it
    received: JAX's ``ppermute`` with ``i → i+1`` (``direction=1``) or
    ``i → i−1`` (``direction=-1``). The received tensors take the shapes,
    dtypes and device of ``like`` (default: ``tensors``).

    ``wrap=True``: around the ring, every rank sends and receives.
    ``wrap=False``: between neighbours only, as a pipeline's stages hop:
    a rank with no rank ahead sends nothing (its ``tensors`` may be None),
    and one with no rank behind receives nothing (returns None).

    Every rank posts its sends, then its receives, in list order, so that
    two ranks never wait on each other's second message."""
    line = mesh.line(axis)
    n, i = len(line), mesh.index(axis)
    dst, src = i + direction, i - direction
    if wrap:
        dst, src = dst % n, src % n
    to = line[dst] if 0 <= dst < n else None
    frm = line[src] if 0 <= src < n else None
    like = tensors if like is None else like
    group = mesh.group(axis)
    if group is None:  # a line of one rank
        return [t.clone() for t in tensors] if wrap else None
    sends = [] if to is None else tensors
    recvs = [] if frm is None else like
    _count("hop", sends)
    staged = _staged((sends or recvs)[0])
    bufs = [(t.cpu() if staged else t).contiguous() for t in sends]
    got = [torch.empty(t.shape, dtype=t.dtype,
                       device="cpu" if staged else t.device)
           for t in recvs]
    ops = ([dist.P2POp(dist.isend, t, to, group) for t in bufs]
           + [dist.P2POp(dist.irecv, t, frm, group) for t in got])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if frm is None:
        return None
    return [r.to(t.device) for r, t in zip(got, recvs)]
