"""``dryrun_multichip(n)``: the port's twin of ``__graft_entry__.py``'s
``dryrun_multichip``, a check that the parallel modes run across n ranks.

It spawns n gloo ranks on the CPU (``mesh.spawn_ranks``) and runs, each
rank on its shard:

1. a TINY U-Net DP train step (``cifar_unet.make_train_step_dp``, batch 2
   per rank);
2. the mnist_nn DP×TP train step on a (data, model) factorization of n
   that the model admits (``mnist_nn.make_train_step_dp_tp``);
3. ring attention's forward and gradient over a ``seq`` axis of n ranks.

Each must be finite. Rank 0 writes the JAX function's summary line, which
the caller prints and returns. The JAX twin's U-Net TP, U-Net DP×TP and
pipeline sections wait for the U-Net TP and pipeline slice: the line says
so in their place.

    python -m big_linear_algebra_tpu_torch.parallel.dryrun [n]   # default 4
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

_WAITING = "waiting for the U-Net TP and pipeline slice"


def _fmt(v) -> str:
    """A skipped section reads 'skipped', not like a passing one."""
    return "skipped" if v is None else f"{float(v):.4f}"


def _finite(name: str, *tensors) -> None:
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        raise FloatingPointError(f"dryrun_multichip: {name} is not finite")


def _dryrun_rank(n: int, out_path: str) -> int:
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.models import mnist_nn
    from big_linear_algebra_tpu_torch.nn.optim import adam_init
    from big_linear_algebra_tpu_torch.parallel import (batch_sharding,
                                                       make_mesh,
                                                       ring_attention)
    from big_linear_algebra_tpu_torch.parallel.mesh import distributed_init
    from big_linear_algebra_tpu_torch.parallel.sharding import BatchShard

    torch.set_num_threads(1)
    rank = distributed_init(device="cpu")
    rng = np.random.default_rng(0)  # the same global arrays on every rank

    # 1) DP: the U-Net DDPM train step, the batch over all n ranks
    mesh = make_mesh({"data": n})
    cfg = cu.TINY
    params = cu.init_params(torch.Generator().manual_seed(0), cfg)
    x0 = torch.from_numpy(rng.standard_normal(
        (2 * n, 3, cfg.image_size, cfg.image_size)).astype(np.float32))
    step = cu.make_train_step_dp(mesh, cfg)
    params, _, loss = step(params, adam_init(params),
                           batch_sharding(mesh)(x0),
                           torch.Generator().manual_seed(1))
    _finite("the U-Net DP step's loss", loss)

    # 2) DP×TP: the mnist_nn step, the batch over "data", the dense output
    # dims over "model" (which must divide the hidden 128; the batch 64
    # must divide over "data")
    mcfg = mnist_nn.CONFIG
    mesh2 = ce = None
    for model in (2, 4, 8, 1):
        data = n // model
        if (n % model == 0 and 128 % model == 0
                and mcfg.batch_size % data == 0):
            mesh2 = make_mesh({"data": data, "model": model})
            break
    if mesh2 is not None:
        full = mnist_nn.init_params(torch.Generator().manual_seed(0), mcfg)
        mp = mnist_nn.place_params_tp(mesh2, full)
        xb = torch.from_numpy(rng.random((mcfg.batch_size, 784)).astype(
            np.float32))
        onehot = torch.from_numpy(np.eye(10, dtype=np.float32)[
            rng.integers(0, 10, mcfg.batch_size)])
        mask = torch.ones((mcfg.batch_size,), dtype=torch.float32)
        shard = batch_sharding(mesh2)
        _, _, ce = mnist_nn.make_train_step_dp_tp(mesh2, mcfg)(
            mp, shard(xb), shard(onehot), shard(mask))
        _finite("the mnist_nn DPxTP step's loss", ce)

    # 3) SP: ring attention over a "seq" axis, forward and gradients
    mesh3 = make_mesh({"seq": n})
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, 16 * n, 8)).astype(np.float32)) for _ in range(3))
    rows = BatchShard(mesh3.index("seq"), n)
    q, k, v = (rows(x, dim=1).clone().requires_grad_() for x in (q, k, v))
    o = ring_attention(q, k, v, mesh3, "seq")
    o.sum().backward()
    _finite("ring attention's output and gradients", o, q.grad, k.grad,
            v.grad)

    if rank == 0:
        line = (f"dryrun_multichip({n}): U-Net DP loss={float(loss):.4f}, "
                f"U-Net TP loss={_WAITING}, U-Net DPxTP loss={_WAITING}, "
                f"mnist_nn DPxTP ce={_fmt(ce)}, SP ring-attn grad ok, "
                f"PP sections {_WAITING} — every step ran per rank over "
                f"torch.distributed (gloo)")
        with open(out_path, "w") as f:
            f.write(line)
    return 0


def dryrun_multichip(n_devices: int) -> str:
    """Spawn ``n_devices`` gloo CPU ranks, run the sections above, print
    and return the summary line. Raises when a rank fails."""
    from big_linear_algebra_tpu_torch.parallel.mesh import spawn_ranks

    with tempfile.TemporaryDirectory(prefix="bla_dryrun_") as tmp:
        out = os.path.join(tmp, "summary.txt")
        spawn_ranks(_dryrun_rank, n_devices, n_devices, out)
        with open(out) as f:
            line = f.read()
    print(line, flush=True)
    return line


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
