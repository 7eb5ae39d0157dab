"""``dryrun_multichip(n)``: the port's twin of ``__graft_entry__.py``'s
``dryrun_multichip``, a check that the parallel modes run across n ranks.

It spawns n gloo ranks on the CPU (``mesh.spawn_ranks``) and runs, each
rank on its shard, the JAX function's sections:

1. a TINY U-Net DP train step (``cifar_unet.make_train_step_dp``, batch 2
   per rank);
1b. the U-Net TP step over a ``model`` axis of n ranks
   (``cifar_unet.place_tp``, ``make_train_step_tp``), batch 2;
2. the mnist_nn DP×TP train step on a (data, model) factorization of n
   that the model admits (``mnist_nn.make_train_step_dp_tp``);
3. ring attention's forward and gradient over a ``seq`` axis of n ranks;
4. ``gpipe`` of ``tanh(x @ p)`` over a ``stage`` axis of n ranks;
5. with n ≥ 3, the hetero U-Net stages in train mode (``gpipe_hetero``)
   on the first 3 ranks; 5b the PP train step and 5b′ its 1F1B schedule
   (``make_train_step_pp``, 2 microbatches); 5c with n ≥ 6 both on a
   ``stage 3 × data n//3`` mesh;
6. the U-Net DP×TP step on the mnist_nn section's mesh
   (``place_dp_tp``).

Each must be finite. Rank 0 writes the JAX function's summary line, with
"skipped" where JAX skips, which the caller prints and returns.

    python -m big_linear_algebra_tpu_torch.parallel.dryrun [n]   # default 4
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch


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
    from big_linear_algebra_tpu_torch.parallel import (batch_sharding, gpipe,
                                                       make_mesh,
                                                       ring_attention)
    from big_linear_algebra_tpu_torch.parallel.mesh import distributed_init
    from big_linear_algebra_tpu_torch.parallel.pipeline import gpipe_hetero
    from big_linear_algebra_tpu_torch.parallel.sharding import BatchShard

    torch.set_num_threads(1)
    rank = distributed_init(device="cpu")
    rng = np.random.default_rng(0)  # the same global arrays on every rank
    notes = []

    def fresh():
        return cu.init_params(torch.Generator().manual_seed(0), cfg)

    # 1) DP: the U-Net DDPM train step, the batch over all n ranks
    mesh = make_mesh({"data": n})
    cfg = cu.TINY
    params = fresh()
    x0 = torch.from_numpy(rng.standard_normal(
        (2 * n, 3, cfg.image_size, cfg.image_size)).astype(np.float32))
    step = cu.make_train_step_dp(mesh, cfg)
    params, _, loss = step(params, adam_init(params),
                           batch_sharding(mesh)(x0),
                           cu.DPGenerators(1, mesh.index("data"), "cpu"))
    _finite("the U-Net DP step's loss", loss)

    # 1b) TP: the conv kernels' output channels over a "model" axis
    mesh_tp = make_mesh({"model": n})
    p0 = fresh()
    p_tp, opt_tp = cu.place_tp(mesh_tp, p0, adam_init(p0))
    step_tp = cu.make_train_step_tp(mesh_tp, cu.tp_param_specs(p0, n), cfg)
    _, _, loss_tp = step_tp(p_tp, opt_tp, x0[:2],
                            torch.Generator().manual_seed(2))
    _finite("the U-Net TP step's loss", loss_tp)

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
    if mesh2 is None:
        notes.append(f"dryrun_multichip({n}): no (data, model) "
                     f"factorization fits mnist_nn (batch "
                     f"{mcfg.batch_size}, hidden 128) — skipping the DPxTP "
                     f"sections")
    else:
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

    # 4) PP: GPipe's microbatch ring over a "stage" axis of every rank
    mesh4 = make_mesh({"stage": n})
    sw = torch.from_numpy(rng.standard_normal((n, 8, 8)).astype(
        np.float32) * 0.3)
    xs = torch.from_numpy(rng.standard_normal((2 * n, 4, 8)).astype(
        np.float32))
    _finite("gpipe's output", gpipe(lambda p, x: torch.tanh(x @ p), sw, xs,
                                    mesh4))

    # 5) PP hetero: the U-Net's down/mid/up stages on the first 3 ranks
    loss_pp = loss_1f1b = loss_ppdp = loss_ppdp_1f1b = None
    if n < 3:
        notes.append(f"dryrun_multichip({n}): <3 devices — skipping the "
                     f"3-stage hetero U-Net pipeline section")
    mesh5 = make_mesh({"stage": 3}, devices=range(3)) if n >= 3 else None
    if mesh5 is not None and mesh5.coords is not None:
        fns = cu.unet_pipeline_stages(cfg, train=True)
        xs_p = torch.from_numpy(rng.standard_normal(
            (3, 1, 3, cfg.image_size, cfg.image_size)).astype(np.float32))
        ts_p = torch.from_numpy(rng.integers(0, cfg.timesteps, (3, 1))
                                .astype(np.float32))
        _finite("the hetero U-Net pipeline's output", gpipe_hetero(
            fns, cu.split_params_stages(fresh()), (xs_p, ts_p), mesh5,
            key=11))
        # 5b) the PP train step, and 5b') on the 1F1B schedule
        for schedule in ("gpipe", "1f1b"):
            p0 = fresh()
            _, _, lp = cu.make_train_step_pp(
                mesh5, cfg, n_micro=2, schedule=schedule)(
                p0, adam_init(p0), x0[:4], torch.Generator().manual_seed(3))
            _finite(f"the U-Net PP ({schedule}) step's loss", lp)
            loss_pp, loss_1f1b = (lp, loss_1f1b) if schedule == "gpipe"                 else (loss_pp, lp)
    # 5c) PP×DP: the pipeline step on a stage × data mesh
    if n >= 6:
        n_data = n // 3
        mesh5c = make_mesh({"stage": 3, "data": n_data},
                           devices=range(3 * n_data))
        x_ppdp = torch.from_numpy(rng.standard_normal(
            (2 * n_data, 3, cfg.image_size, cfg.image_size)).astype(
            np.float32))
        if mesh5c.coords is not None:
            losses = []
            for schedule in ("gpipe", "1f1b"):
                p0 = fresh()
                _, _, lp = cu.make_train_step_pp(
                    mesh5c, cfg, n_micro=2 * n_data, data_axis="data",
                    schedule=schedule)(p0, adam_init(p0), x_ppdp,
                                       torch.Generator().manual_seed(5))
                _finite(f"the U-Net PPxDP ({schedule}) step's loss", lp)
                losses.append(lp)
            loss_ppdp, loss_ppdp_1f1b = losses
    elif n >= 3:
        notes.append(f"dryrun_multichip({n}): <6 devices — no 3×N "
                     f"stage×data factorization, skipping the PPxDP section")

    # 6) DP×TP: the U-Net on the data × model mesh of section 2
    loss_2d = None
    if mesh2 is not None:
        p0 = fresh()
        p_2d, opt_2d = cu.place_dp_tp(mesh2, p0, adam_init(p0))
        x_2d = cu.dp_tp_batch_sharding(mesh2)(x0[:2 * mesh2.size("data")])
        _, _, loss_2d = cu.make_train_step_tp(
            mesh2, cu.tp_param_specs(p0, mesh2.size("model")), cfg,
            data_axis="data")(p_2d, opt_2d, x_2d,
                              torch.Generator().manual_seed(4))
        _finite("the U-Net DPxTP step's loss", loss_2d)

    if rank == 0:
        head = (f"dryrun_multichip({n}): U-Net DP loss={float(loss):.4f}, "
                f"U-Net TP loss={float(loss_tp):.4f}")
        if n < 3:
            line = (f"{head}, mnist_nn DPxTP ce={_fmt(ce)}, SP ring-attn "
                    f"grad ok, PP gpipe ok")
        else:
            line = (f"{head}, U-Net DPxTP loss={_fmt(loss_2d)}, "
                    f"mnist_nn DPxTP ce={_fmt(ce)}, SP ring-attn grad ok, "
                    f"PP gpipe ok, PP hetero U-Net stages ok, "
                    f"PP U-Net train step loss={float(loss_pp):.4f}, "
                    f"PP 1F1B train step loss={float(loss_1f1b):.4f}, "
                    f"PPxDP U-Net train step loss={_fmt(loss_ppdp)}, "
                    f"PPxDP 1F1B train step loss={_fmt(loss_ppdp_1f1b)} — "
                    f"every step ran per rank over torch.distributed "
                    f"(gloo)")
        with open(out_path, "w") as f:
            f.write("\n".join(notes + [line]))
    return 0


def dryrun_multichip(n_devices: int) -> str:
    """Spawn ``n_devices`` gloo CPU ranks, run the sections above, print
    JAX's notes of skipped sections and return the summary line (the last
    printed). Raises when a rank fails."""
    from big_linear_algebra_tpu_torch.parallel.mesh import spawn_ranks

    with tempfile.TemporaryDirectory(prefix="bla_dryrun_") as tmp:
        out = os.path.join(tmp, "summary.txt")
        spawn_ranks(_dryrun_rank, n_devices, n_devices, out)
        with open(out) as f:
            text = f.read()
    print(text, flush=True)
    return text.splitlines()[-1]


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
