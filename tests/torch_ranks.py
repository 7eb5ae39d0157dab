"""Rank bodies for the port's parallel tests, run in spawned gloo CPU ranks.

This module imports torch and the port, never jax: every spawned rank
imports it afresh. A test module builds a list of cases (name, function
name here, keyword arguments of numpy data), ``spawn`` runs them all in one
launch of ``world`` ranks, and each rank's results come back as numpy.
"""

import contextlib
import hashlib
import io
import os
import pickle
import tempfile

import numpy as np
import torch

from big_linear_algebra_tpu_torch.parallel import mesh as pmesh
from big_linear_algebra_tpu_torch.parallel.mesh import spawn_ranks


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float64).numpy()
    return x


def _snap(x):
    """``_np`` as copies, so that a buffer updated later leaves them be."""
    if isinstance(x, dict):
        return {k: _snap(v) for k, v in x.items()}
    return np.array(_np(x), copy=True)


def _t(x):
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    return torch.from_numpy(np.array(x, copy=True))


def run(cases_path: str, out_dir: str, timeout=None) -> int:
    torch.set_num_threads(1)
    rank = pmesh.distributed_init(device="cpu", timeout=timeout)
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    results = {name: globals()[fn](**kwargs) for name, fn, kwargs in cases}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    return 0


def spawn(world: int, cases, timeout=None) -> list:
    """Run ``cases`` in one launch of ``world`` gloo CPU ranks (``timeout``:
    the process group's, in seconds); returns each rank's {case name:
    result}, in rank order."""
    with tempfile.TemporaryDirectory(prefix="bla_ranks_") as tmp:
        path = os.path.join(tmp, "cases.pkl")
        with open(path, "wb") as f:
            pickle.dump(cases, f)
        with contextlib.redirect_stdout(io.StringIO()):
            spawn_ranks(run, world, path, tmp, timeout)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


@contextlib.contextmanager
def stood_in_graphs():
    """``utils/graphs.py`` on the CPU as on the card, capture and replay
    stood in for: every ``StepGraph`` made with the default ``graphed`` is
    graphed (``eager_reason`` None); its warm-up steps run eagerly; a
    capture runs nothing and keeps the step; a replay runs it ``unroll``
    times with the launch and collective counters held, and sets the
    graph's ``deltas`` to what those steps counted, which
    ``StepGraph.replay`` then adds, as it adds what a capture recorded.
    Yields the log of captures and replays."""
    from big_linear_algebra_tpu_torch.utils import graphs

    log = []

    class Replayed:
        def __init__(self, owner, step):
            self.owner, self.step = owner, step

        def replay(self):
            before = graphs.launch_counts()
            for _ in range(self.owner.unroll):
                self.step()
            after = graphs.launch_counts()
            graphs._set_counts(before)
            self.owner.deltas = {k: after[k] - v for k, v in before.items()
                                 if after[k] != v}
            log.append("replay")

    def capture(self, step):
        self.graph = Replayed(self, step)
        log.append("capture")

    patches = [(graphs, "eager_reason", lambda device: None),
               (graphs.StepGraph, "_on_capture_stream",
                lambda self: contextlib.nullcontext()),
               (graphs.StepGraph, "capture", capture)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, value in patches:
        setattr(obj, name, value)
    try:
        yield log
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def collective_counts():
    """The collective counters now: (calls, bytes by kind)."""
    from big_linear_algebra_tpu_torch.parallel import spmd

    return spmd.collective_calls, dict(spmd.collective_bytes)


def counted(fn):
    """(fn(), the collective counters' advance during it)."""
    c0, b0 = collective_counts()
    out = fn()
    c1, b1 = collective_counts()
    return out, (c1 - c0, {k: v - b0[k] for k, v in b1.items()})


# ---------------------------------------------------------------------------
# mesh, sharding, collectives
# ---------------------------------------------------------------------------


def mesh_facts():
    """What the mesh, sharding and collective helpers give this rank of a
    world of 4."""
    from big_linear_algebra_tpu_torch.parallel import (batch_sharding,
                                                       default_mesh,
                                                       make_hybrid_mesh,
                                                       make_mesh, replicate,
                                                       shard_params_tp, spmd)

    r = pmesh.rank()
    out = {}
    mesh = make_mesh({"data": 2, "model": 2})
    out["shape"] = mesh.shape
    out["grid"] = mesh.devices.tolist()
    out["coords"] = mesh.coords
    out["lines"] = (mesh.line("data"), mesh.line("model"))
    out["default"] = default_mesh().shape
    out["hybrid"] = make_hybrid_mesh({"dcn": 1}, {"data": 2,
                                                  "model": 2}).shape
    for bad in ({"data": 3}, {"data": 2, "model": 4}):
        try:
            make_mesh(bad)
        except ValueError as e:
            out[f"error {bad}"] = str(e)
    try:
        make_hybrid_mesh({"dcn": 2}, {"data": 2})
    except ValueError as e:
        out["hybrid error"] = str(e)
    x = torch.arange(8.0).reshape(8, 1)
    out["batch"] = _np(batch_sharding(mesh)(x))
    params = {"w": torch.arange(12.0).reshape(3, 4), "b": torch.arange(4.0),
              "s": torch.tensor(7.0)}
    out["tp"] = _np(shard_params_tp(mesh, params))
    out["replicate"] = _np(replicate(mesh, {"a": torch.full((2,),
                                                            float(r))}))
    tree = {"a": torch.full((3,), float(r + 1), dtype=torch.float64),
            "b": {"c": torch.full((2,), float(r), dtype=torch.bfloat16)}}
    out["psum data"] = _np(spmd.psum_tree(tree, mesh, "data"))
    out["pmean model"] = _np(spmd.pmean_tree(tree, mesh, "model"))
    out["psum dtypes"] = [str(v.dtype) for v in (
        spmd.psum_tree(tree, mesh, "data")["a"],
        spmd.psum_tree(tree, mesh, "data")["b"]["c"])]
    z = torch.full((2, 3), float(r), dtype=torch.float64, requires_grad=True)
    g = spmd.all_gather(z, mesh, "model", dim=1)
    out["gathered"] = _np(g)
    (g * torch.arange(12.0, dtype=torch.float64).reshape(2, 6)).sum() \
        .backward()
    out["gather grad"] = _np(z.grad)
    p = torch.full((1,), float(r), requires_grad=True)
    s = spmd.psum(p, mesh, "data")
    (3 * s).sum().backward()
    out["psum"], out["psum grad"] = _np(s), _np(p.grad)
    out["hop"] = _np(spmd.hop([torch.full((2,), float(r))], mesh,
                              "data")[0])
    return out


# ---------------------------------------------------------------------------
# mnist_nn and mnist_hinge
# ---------------------------------------------------------------------------


def mnist_dp_step(params, x, onehot, mask, lr):
    from big_linear_algebra_tpu_torch.models import mnist_nn
    from big_linear_algebra_tpu_torch.parallel import (batch_sharding,
                                                       default_mesh)

    cfg = mnist_nn.Config(learn_rate=lr)
    mesh = default_mesh()
    model = mnist_nn.MnistNN.from_params(_t(params), cfg)
    shard = batch_sharding(mesh)
    correct, ce = mnist_nn.make_train_step_dp(mesh, cfg)(
        model, *(shard(_t(v)) for v in (x, onehot, mask)))
    return {"params": _np(model.params()), "correct": float(correct),
            "ce": float(ce)}


def mnist_dp_tp_step(params, x, onehot, mask, lr, data, model, clip):
    from big_linear_algebra_tpu_torch.models import mnist_nn
    from big_linear_algebra_tpu_torch.parallel import (batch_sharding,
                                                       make_mesh)

    cfg = mnist_nn.Config(learn_rate=lr, grad_clip=clip)
    mesh = make_mesh({"data": data, "model": model})
    shards = mnist_nn.place_params_tp(mesh, _t(params))
    shard = batch_sharding(mesh)
    new, correct, ce = mnist_nn.make_train_step_dp_tp(mesh, cfg)(
        shards, *(shard(_t(v)) for v in (x, onehot, mask)))
    return {"params": _np(mnist_nn.gather_params_tp(mesh, new)),
            "correct": float(correct), "ce": float(ce)}


def mnist_dp_epoch(params, x_raw, y, perm, lr):
    from big_linear_algebra_tpu_torch.models import mnist_nn
    from big_linear_algebra_tpu_torch.parallel import default_mesh

    cfg = mnist_nn.Config(learn_rate=lr)
    model = mnist_nn.MnistNN.from_params(_t(params), cfg)
    epoch = mnist_nn.make_epoch_resident_dp(default_mesh(), cfg)
    correct, ce = epoch(model, _t(x_raw), _t(y), _t(perm))
    return {"params": _np(model.params()), "correct": float(correct),
            "ce": float(ce)}


def hinge_dp_chunk(w, x, labels, lr, n_iters):
    from big_linear_algebra_tpu_torch.models import mnist_hinge as hinge
    from big_linear_algebra_tpu_torch.parallel import (batch_sharding,
                                                       default_mesh)

    mesh = default_mesh()
    xp, lp = hinge.pad_examples(x, labels, mesh.size("data"))
    shard = batch_sharding(mesh)
    xt = _t(shard(xp))
    chunk = hinge.make_train_chunk_dp(mesh, x.shape[0], n_iters)
    w, norms = chunk(_t(w), xt, hinge.signed_targets(_t(shard(lp)),
                                                     xt.dtype), lr)
    return {"w": _np(w), "norms": _np(norms), "rows": xt.shape[0]}


def cli(module, argv, data_dir):
    """``module.main(argv)`` in this rank (the process group is joined):
    (exit code or SystemExit message, stdout)."""
    import importlib

    mod = importlib.import_module(
        f"big_linear_algebra_tpu_torch.models.{module}")
    os.environ["BLA_DATA_DIR"] = data_dir
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = mod.main(argv)
    except SystemExit as e:
        rc = str(e)
    finally:
        del os.environ["BLA_DATA_DIR"]
    return rc, out.getvalue()


# ---------------------------------------------------------------------------
# cifar_unet
# ---------------------------------------------------------------------------


def injected_dropout(mask_of):
    """A ``dropout`` whose mask of the i-th call is ``mask_of(i, shape,
    keep)`` (the same formula as ``nn/dropout.py``)."""
    calls = []

    def dropout(x, rate, generator, deterministic=False):
        if deterministic or rate == 0.0:
            return x
        keep = 1.0 - rate
        mask = mask_of(len(calls), tuple(x.shape), keep).to(x.device)
        calls.append(tuple(x.shape))
        return torch.where(mask, x / keep, 0.0).to(x.dtype)

    return dropout, calls


def unet_dp_step(params, x0, t, noise, mask_seed, cfg_kwargs, inject=True):
    """One TINY DP step with this rank's (t, noise) and dropout masks
    injected (without ``inject`` the masks come from the rank's generator:
    ``--remat`` replays a generator, not an injected mask's call count);
    returns the loss, the params and the Adam moments."""
    import dataclasses

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn.optim import adam_init
    from big_linear_algebra_tpu_torch.parallel import (batch_sharding,
                                                       default_mesh)

    cfg = dataclasses.replace(cu.TINY, **cfg_kwargs)
    mesh = default_mesh()
    shard = batch_sharding(mesh)
    dropout, calls = injected_dropout(
        lambda i, shape, keep: torch.from_numpy(
            np.random.default_rng([mask_seed, pmesh.rank(), i]).random(
                shape) < keep))
    real = cu.dropout
    if inject:
        cu.dropout = dropout
    try:
        p = _t(params)
        p, opt, loss = cu.make_train_step_dp(mesh, cfg)(
            p, adam_init(p), shard(_t(x0)),
            cu.DPGenerators(3, mesh.index("data"), "cpu"),
            draws=(shard(_t(t)), shard(_t(noise))))
    finally:
        cu.dropout = real
    return {"loss": float(loss), "params": _np(p), "m": _np(opt.m),
            "v": _np(opt.v), "calls": calls}


def unet_bf16_replicas(x0, n_steps):
    """``n_steps`` TINY DP steps with bf16 stored params (stochastic
    rounding), this rank's draws from its rank generator: a hash of the
    params' bytes, and how far they moved."""
    import dataclasses

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn.optim import adam_init, tree_leaves
    from big_linear_algebra_tpu_torch.parallel import (batch_sharding,
                                                       default_mesh)

    cfg = dataclasses.replace(cu.TINY, param_dtype="bfloat16")
    mesh = default_mesh()
    p0 = cu.cast_params(cu.init_params(torch.Generator().manual_seed(0),
                                       cfg), cfg)
    p, opt = p0, adam_init(p0)
    step = cu.make_train_step_dp(mesh, cfg)
    gen = cu.DPGenerators(5, mesh.index("data"), "cpu")
    losses = []
    for _ in range(n_steps):
        p, opt, loss = step(p, opt, batch_sharding(mesh)(_t(x0)), gen)
        losses.append(float(loss))
    digest = hashlib.sha256()
    for leaf in tree_leaves(p):
        digest.update(leaf.contiguous().view(torch.int16).numpy().tobytes())
    moved = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(tree_leaves(p), tree_leaves(p0)))
    return {"hash": digest.hexdigest(), "moved": moved, "losses": losses,
            "dtype": str(tree_leaves(p)[0].dtype)}


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------


def ring(q, k, v, g):
    """Ring attention over a ``seq`` axis of every rank, this rank's rows:
    the output and the gradients of <o, g>."""
    from big_linear_algebra_tpu_torch.parallel import (default_mesh,
                                                       ring_attention)
    from big_linear_algebra_tpu_torch.parallel.sharding import BatchShard

    mesh = default_mesh("seq")
    rows = BatchShard(mesh.index("seq"), mesh.size("seq"))
    q, k, v = (rows(_t(a), dim=1).clone().requires_grad_()
               for a in (q, k, v))
    o = ring_attention(q, k, v, mesh, "seq")
    o.backward(rows(_t(g), dim=1))
    return {"o": _np(o), "dq": _np(q.grad), "dk": _np(k.grad),
            "dv": _np(v.grad)}


# ---------------------------------------------------------------------------
# cifar_unet tensor parallelism
# ---------------------------------------------------------------------------


def _unet_cfg(cfg_kwargs):
    import dataclasses

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu

    return dataclasses.replace(cu.TINY, **cfg_kwargs)


@contextlib.contextmanager
def _schedule(schedule):
    """The U-Net's ``ddpm_schedule`` replaced by ``schedule`` (the JAX
    package's (betas, alphas, alpha_bars): its f32 cumprod may round
    otherwise) when given."""
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu

    real = cu.ddpm_schedule
    if schedule is not None:
        fixed = tuple(_t(a) for a in schedule)
        cu.ddpm_schedule = lambda cfg: fixed
    try:
        yield
    finally:
        cu.ddpm_schedule = real


@contextlib.contextmanager
def _masks(mask_seed, data_index):
    """The U-Net's dropout replaced by ``injected_dropout``: call i's mask
    from ``default_rng([mask_seed, data_index, i])``, the same on every
    rank of one model line."""
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu

    dropout, calls = injected_dropout(
        lambda i, shape, keep: torch.from_numpy(
            np.random.default_rng([mask_seed, data_index, i]).random(shape)
            < keep))
    real = cu.dropout
    cu.dropout = dropout
    try:
        yield calls
    finally:
        cu.dropout = real


def unet_tp_step(params, x0, t, noise, mask_seed, cfg_kwargs, dp,
                 schedule=None, inject=True):
    """One TINY TP step on the (data 2 × model 2) mesh of a world of 4:
    with ``dp`` the DP×TP step (x0, t, noise cut over "data", masks per
    data index), else every model line runs the TP step on the whole batch.
    ``schedule``: the DDPM schedule to use (``_schedule``); without
    ``inject`` the masks come from the step's generator. Returns the loss
    and the gathered params and Adam moments."""
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn.optim import adam_init
    from big_linear_algebra_tpu_torch.parallel import make_mesh

    cfg = _unet_cfg(cfg_kwargs)
    mesh = make_mesh({"data": 2, "model": 2})
    full = _t(params)
    specs = cu.tp_param_specs(full, 2)
    p, opt = cu.place_dp_tp(mesh, full, adam_init(full))
    shard = (cu.dp_tp_batch_sharding(mesh) if dp
             else (lambda x: x))
    step = cu.make_train_step_tp(mesh, specs, cfg,
                                 data_axis="data" if dp else None)
    masks = (_masks(mask_seed, mesh.index("data") if dp else 0) if inject
             else contextlib.nullcontext([]))
    with masks as calls, _schedule(schedule):
        p, opt, loss = step(p, opt, shard(_t(x0)),
                            torch.Generator().manual_seed(3),
                            draws=(shard(_t(t)), shard(_t(noise))))
    p, opt = cu.gather_tp(cu.TPLayout(mesh, specs), p, opt)
    return {"loss": float(loss), "params": _np(p), "m": _np(opt.m),
            "v": _np(opt.v), "calls": calls}


def unet_tp_place(params):
    """``place_tp`` over a model axis of 2 (of the (data 2 × model 2) mesh)
    and of 4, each followed by ``gather_tp``: the tree back, its leaves'
    local shapes; and one ``--bf16-params`` Adam write of each rank's
    slices with ``TPLayout.sr_index``, with the slices of a full gradient
    tree."""
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn.optim import (adam_init,
                                                       adam_update, tree_map)
    from big_linear_algebra_tpu_torch.parallel import make_mesh

    full = _t(params)
    out = {}
    for name, axes in (("model 2", {"data": 2, "model": 2}),
                       ("model 4", {"model": 4})):
        mesh = make_mesh(axes)
        layout = cu.TPLayout(mesh, cu.tp_param_specs(full, axes["model"]))
        local, opt = cu.place_tp(mesh, full, adam_init(full))
        back, opt_back = cu.gather_tp(layout, local, opt)
        out[name] = {"back": _np(back), "index": mesh.index("model"),
                     "shapes": tree_map(lambda x: tuple(x.shape), local),
                     "opt": _np(opt_back.m)}
        p16 = tree_map(lambda x: x.to(torch.bfloat16), full)
        grads = tree_map(lambda x: torch.sin(3.0 * x + 1.0), full)
        new, _ = adam_update(layout.place(p16), layout.place(grads),
                             adam_init(layout.place(p16)), 1e-2,
                             sr_seed=1234567, sr_index=layout.sr_index(
                                 layout.place(p16)))
        out[name]["sr"] = _np(layout.gather(new))
    return out


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------


def _stage_mesh():
    from big_linear_algebra_tpu_torch.parallel import make_mesh

    return make_mesh({"stage": 3})


def gpipe_toy(ws, xs):
    """``gpipe`` of ``tanh(x @ p)`` over the 3 ranks: the output and the
    gradient of sum(out²) with respect to the stacked params; and a stage
    that is not total on zeros (x/‖x‖): its output and gradient."""
    from big_linear_algebra_tpu_torch.parallel import gpipe

    mesh = _stage_mesh()
    out = {}

    def nontotal(p, x):
        x = x / torch.sqrt(torch.sum(x * x))  # NaN at x = 0
        return torch.tanh(x @ p)

    for name, fn in (("tanh", lambda p, x: torch.tanh(x @ p)),
                     ("nontotal", nontotal)):
        w = _t(ws).requires_grad_()
        o = gpipe(fn, w, _t(xs), mesh)
        torch.sum(o ** 2).backward()
        out[name] = {"out": _np(o), "grad": _np(w.grad)}
    return out


def unet_hetero(params, xs, ts, cfg_kwargs, key):
    """``gpipe_hetero`` over the TINY U-Net's three stages: inference mode,
    train mode with ``key``, and the two key/train mismatches' errors."""
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.parallel.pipeline import gpipe_hetero

    cfg = _unet_cfg(cfg_kwargs)
    mesh = _stage_mesh()
    sp = cu.split_params_stages(_t(params))
    boundary = (_t(xs), _t(ts))
    out = {"inference": _np(gpipe_hetero(cu.unet_pipeline_stages(cfg), sp,
                                         boundary, mesh)),
           "train": _np(gpipe_hetero(cu.unet_pipeline_stages(cfg, True), sp,
                                     boundary, mesh, key=key))}
    for name, train, k in (("no key", True, None), ("key", False, key)):
        try:
            gpipe_hetero(cu.unet_pipeline_stages(cfg, train), sp, boundary,
                         mesh, key=k)
        except ValueError as e:
            out[f"error {name}"] = str(e)
    return out


def unet_pp_step(params, x0, t, noise, cfg_kwargs, n_micro, schedule,
                 data=1, ddpm=None):
    """One TINY PP step (``make_train_step_pp``) with (t, noise) injected,
    on the 3 ranks, or with ``data`` > 1 on a (stage 3 × data) mesh;
    the generator of seed 3 gives its step seed; ``ddpm``: the DDPM
    schedule to use (``_schedule``). Returns the loss, the params and the
    Adam moments, and a hash of this rank's params."""
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn.optim import adam_init, tree_leaves
    from big_linear_algebra_tpu_torch.parallel import make_mesh, spmd

    cfg = _unet_cfg(cfg_kwargs)
    axes = {"stage": 3} if data == 1 else {"stage": 3, "data": data}
    mesh = make_mesh(axes)
    p = _t(params)
    bytes0 = dict(spmd.collective_bytes)
    step = cu.make_train_step_pp(mesh, cfg, n_micro=n_micro,
                                 schedule=schedule,
                                 data_axis=None if data == 1 else "data")
    with _schedule(ddpm):
        p, opt, loss = step(p, adam_init(p), _t(x0),
                            torch.Generator().manual_seed(3),
                            draws=(_t(t), _t(noise)))
    digest = hashlib.sha256()
    for leaf in tree_leaves(p):
        digest.update(leaf.contiguous().view(torch.uint8).numpy().tobytes())
    return {"loss": float(loss), "params": _np(p), "m": _np(opt.m),
            "v": _np(opt.v), "hash": digest.hexdigest(),
            "hop bytes": spmd.collective_bytes["hop"] - bytes0["hop"]}


# ---------------------------------------------------------------------------
# graphed parallel epochs (capture and replay stood in for)
# ---------------------------------------------------------------------------


def graphs_gloo_rule():
    """In a gloo process group: why a step on a card would run eagerly,
    and what ``say_eager_rule`` prints on this rank."""
    from big_linear_algebra_tpu_torch.models import common
    from big_linear_algebra_tpu_torch.utils import graphs

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        common.say_eager_rule("dp", "cuda")
        common.say_eager_rule("dp", "cpu")
    return {"reason": graphs.eager_reason(torch.device("cuda")),
            "cpu": graphs.eager_reason(torch.device("cpu")),
            "printed": out.getvalue()}


def graphs_mnist_dp_epoch(params, x_raw, y, perm, lr, unroll):
    """Two resident DP epochs on one ``ResidentEpoch`` with the mesh
    (graphs of ``unroll`` steps stood in for) against two eager DP epochs
    as the port ran them before (one ``make_train_step_dp`` call per batch
    of this rank's rows, the metrics summed from 0.0): the params and
    metrics after each epoch, the collective counters' advance, the log."""
    from big_linear_algebra_tpu_torch.models import mnist_nn
    from big_linear_algebra_tpu_torch.parallel import default_mesh

    mesh = default_mesh()
    cfg = mnist_nn.Config(learn_rate=lr, scan_unroll=unroll)
    x, yy, p = _t(x_raw), _t(y), _t(perm)
    ranks, r = mesh.size("data"), mesh.index("data")
    idx = p.long().reshape(-1, ranks, cfg.batch_size // ranks)[:, r]
    model = mnist_nn.MnistNN.from_params(_t(params), cfg)
    step = mnist_nn.make_train_step_dp(mesh, cfg)

    def eager_epoch():
        correct = ce_sum = 0.0
        for batch in mnist_nn._resident_batches(x, yy, idx, cfg):
            c, ce = step(model, *batch)
            correct, ce_sum = correct + c, ce_sum + ce
        return correct, ce_sum

    out = {"eager": [], "graphed": []}
    for _ in range(2):
        (c, ce), counts = counted(eager_epoch)
        out["eager"].append((_snap(model.params()), float(c), float(ce),
                             counts))
    model = mnist_nn.MnistNN.from_params(_t(params), cfg)
    with stood_in_graphs() as log:
        epoch = mnist_nn.ResidentEpoch(model, x, yy, cfg, mesh=mesh)
        for _ in range(2):
            (c, ce), counts = counted(lambda: epoch(p))
            out["graphed"].append((_snap(model.params()), float(c),
                                   float(ce), counts))
    out["log"] = log
    return out


def graphs_hinge_dp_chunks(w, x, labels, lr):
    """``Chunks`` with the mesh (a whole chunk a stood-in graph; chunks of
    10, 10 and a ragged 3) against ``make_train_chunk_dp``'s eager chunks
    from the same weights: the weights and histories, the collective
    counters' advance."""
    from big_linear_algebra_tpu_torch.models import mnist_hinge as hinge
    from big_linear_algebra_tpu_torch.parallel import (batch_sharding,
                                                       default_mesh)

    mesh = default_mesh()
    xp, lp = hinge.pad_examples(x, labels, mesh.size("data"))
    shard = batch_sharding(mesh)
    xt = _t(shard(xp))
    yt = hinge.signed_targets(_t(shard(lp)), xt.dtype)
    sizes = (10, 10, 3)

    def eager():
        wt, hist = _t(w), []
        for n in sizes:
            wt, h = hinge.make_train_chunk_dp(mesh, x.shape[0], n)(
                wt, xt, yt, lr)
            hist.append(h)
        return wt, torch.cat(hist)

    def graphed():
        chunks = hinge.Chunks(_t(w), xt, yt, lr, x.shape[0], mesh)
        hist = [chunks.run(n).clone() for n in sizes]
        return chunks.w, torch.cat(hist)

    (we, he), ce = counted(eager)
    with stood_in_graphs() as log:
        (wg, hg), cg = counted(graphed)
    return {"eager": (_snap(we), _snap(he), ce),
            "graphed": (_snap(wg), _snap(hg), cg), "log": log}


def _unet_epoch_rows(x0, n_steps, batch):
    rng = np.random.default_rng(11)
    return torch.from_numpy(np.stack([rng.permutation(x0.shape[0])[:batch]
                                      for _ in range(n_steps)]))


def _unet_state(params, opt, losses, gens):
    return {"params": _snap(params), "m": _snap(opt.m), "v": _snap(opt.v),
            "step": opt.step, "losses": _snap(torch.stack(list(losses))),
            "gens": [g.get_state().numpy().copy() for g in gens]}


def graphs_unet_dp_epochs(x0, n_steps, unroll, cfg_kwargs):
    """Two DP epochs of ``n_steps`` TINY steps (batch 2 a rank) through
    ``TrainSteps`` with the mesh (graphs of ``unroll`` stood in for, one
    object for both epochs, ``DPGenerators.new_epoch`` between them)
    against ``make_train_step_dp``'s eager steps on the same rows and
    generator seeds: the state after each epoch (params, moments, losses,
    both generators' states), the collective counters, the log."""
    import dataclasses

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn.optim import adam_init
    from big_linear_algebra_tpu_torch.parallel import (batch_sharding,
                                                       default_mesh)

    mesh = default_mesh()
    world = mesh.size("data")
    cfg = dataclasses.replace(cu.TINY, batch_size=2 * world, **cfg_kwargs)
    data = _t(x0)
    rows = _unet_epoch_rows(x0, n_steps, cfg.batch_size)
    lo, hi = batch_sharding(mesh).bounds(cfg.batch_size)
    p0 = cu.cast_params(cu.init_params(torch.Generator().manual_seed(0),
                                       cfg), cfg)

    def eager():
        gens = cu.DPGenerators(7, mesh.index("data"), "cpu")
        step = cu.make_train_step_dp(mesh, cfg)
        p, opt, states = p0, adam_init(p0), []
        for _ in range(2):
            losses = []
            for r in rows:
                p, opt, loss = step(p, opt, cu._fit_images(data[r[lo:hi]],
                                                           cfg), gens)
                losses.append(loss)
            states.append(_unet_state(p, opt, losses,
                                      (gens.replicated, gens.rank)))
            gens.new_epoch()
        return states

    def graphed():
        gens = cu.DPGenerators(7, mesh.index("data"), "cpu")
        steps = cu.TrainSteps(p0, adam_init(p0), data, gens, cfg,
                              unroll=unroll, mesh=mesh)
        states = []
        for _ in range(2):
            losses = steps.run(rows[:, lo:hi])
            states.append(_unet_state(steps.params, steps.opt_state(),
                                      losses, (gens.replicated, gens.rank)))
            gens.new_epoch()
        return states

    want, counts_eager = counted(eager)
    with stood_in_graphs() as log:
        got, counts_graphed = counted(graphed)
    return {"eager": want, "graphed": got, "log": log,
            "counts": (counts_eager, counts_graphed)}


def graphs_unet_tp_chunks(x0, n_steps, unroll):
    """``n_steps`` TINY TP steps over a model axis of every rank through
    ``TrainSteps`` with the layout (chunks of ``unroll`` stood in for, a
    ragged tail) against ``make_train_step_tp``'s eager steps: the gathered
    state, the collective counters, the log."""
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn.optim import adam_init
    from big_linear_algebra_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"model": pmesh.world_size()})
    cfg = cu.TINY
    data = _t(x0)
    rows = _unet_epoch_rows(x0, n_steps, cfg.batch_size)
    full = cu.init_params(torch.Generator().manual_seed(0), cfg)
    layout = cu.TPLayout(mesh, cu.tp_param_specs(full, mesh.size("model")))

    def eager():
        gen = torch.Generator().manual_seed(8)
        p, opt = cu.place_tp(mesh, full, adam_init(full))
        step = cu.make_train_step_tp(mesh, layout.specs, cfg)
        losses = []
        for r in rows:
            p, opt, loss = step(p, opt, cu._fit_images(data[r], cfg), gen)
            losses.append(loss)
        p, opt = cu.gather_tp(layout, p, opt)
        return _unet_state(p, opt, losses, (gen,))

    def graphed():
        gen = torch.Generator().manual_seed(8)
        p, opt = cu.place_tp(mesh, full, adam_init(full))
        steps = cu.TrainSteps(p, opt, data, gen, cfg, unroll=unroll,
                              tp=layout)
        whole = n_steps // unroll * unroll
        losses = torch.cat([steps.run(rows[:whole]),
                            steps.run(rows[whole:])])
        p, opt = cu.gather_tp(layout, steps.params, steps.opt_state())
        return _unet_state(p, opt, losses, (gen,))

    want, counts_eager = counted(eager)
    with stood_in_graphs() as log:
        got, counts_graphed = counted(graphed)
    return {"eager": want, "graphed": got, "log": log,
            "counts": (counts_eager, counts_graphed)}
