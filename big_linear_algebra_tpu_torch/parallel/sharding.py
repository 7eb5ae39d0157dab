"""Shardings for DP/TP training, the counterpart of
``big_linear_algebra_tpu/parallel/sharding.py``.

JAX describes a layout (``NamedSharding``) and lets ``device_put`` or the
compiler move the data. Here each rank holds its own shard, so each
function returns the shard itself:

- data parallel: ``batch_sharding`` cuts this rank's contiguous slice of
  dim 0, as ``P("data")`` lays a batch out over the data axis;
- ``replicate``: every leaf broadcast from the mesh's first rank;
- tensor parallel: ``shard_params_tp`` keeps this rank's slice of each
  dense layer's output dim (Megatron column-parallel), as JAX's
  ``P(None, "model")`` / ``P("model")`` do.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from big_linear_algebra_tpu_torch.nn.optim import tree_map


class BatchShard:
    """This rank's contiguous slice along one dim over a mesh axis:
    ``shard(x)`` for a tensor or array, ``shard.bounds(n)`` for the
    (start, stop) of an axis of length n."""

    def __init__(self, index: int, size: int):
        self.index, self.size = index, size

    def bounds(self, n: int) -> tuple[int, int]:
        if n % self.size:
            raise ValueError(f"dimension {n} is not divisible by the "
                             f"{self.size} shards of the axis")
        per = n // self.size
        return self.index * per, (self.index + 1) * per

    def __call__(self, x, dim: int = 0):
        start, stop = self.bounds(x.shape[dim])
        index = [slice(None)] * x.ndim
        index[dim] = slice(start, stop)
        return x[tuple(index)]


def batch_sharding(mesh, data_axis: str = "data") -> BatchShard:
    """Shard dim 0 (the batch) over ``data_axis``; replicate the rest."""
    return BatchShard(mesh.index(data_axis), mesh.size(data_axis))


def replicate(mesh, tree: Any) -> Any:
    """Every leaf of ``tree`` (a tensor or nested dicts of tensors) as the
    mesh's first rank holds it, broadcast to every rank of the mesh (a new
    tree; on one rank, the tree itself)."""
    if not dist.is_initialized() or mesh.devices.size == 1:
        return tree
    if mesh.devices.size != dist.get_world_size():
        raise ValueError(f"replicate broadcasts over the whole group of "
                         f"{dist.get_world_size()} ranks; the mesh holds "
                         f"{mesh.devices.size}")
    src = int(mesh.devices.flat[0])

    def bcast(x: torch.Tensor) -> torch.Tensor:
        staged = x.is_cuda and dist.get_backend() == "gloo"
        buf = (x.cpu() if staged else x).clone().contiguous()
        dist.broadcast(buf, src=src)
        return buf.to(x.device)

    return tree_map(bcast, tree)


def shard_params_tp(mesh, params: Any, model_axis: str = "model") -> Any:
    """An MLP's params in a tensor-parallel layout: this rank's slice of
    each (in, out) weight's output dim and of each (out,) bias; rank-0
    leaves replicate. Consecutive layers sharded on their output dims need
    an all-gather of each activation (``spmd.all_gather``)."""
    shard = BatchShard(mesh.index(model_axis), mesh.size(model_axis))

    def place(x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 2:
            return shard(x, dim=1).contiguous()
        if x.ndim == 1:
            return shard(x, dim=0).contiguous()
        return x.clone()

    return tree_map(place, params)
