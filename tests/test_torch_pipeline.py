"""The port's pipeline modes (``parallel/pipeline.py``, cifar_unet
``--pp``) against the JAX package's and the sequential fold chain.

Two launches for the whole file: 3 gloo CPU ranks (one stage each) and 6
(a stage 3 × data 2 mesh), ``tests/torch_ranks.py``; the JAX references
run here, jitted, on the conftest's virtual CPU devices. Every case holds
the same numpy inputs:

- ``gpipe`` of ``tanh(x @ p)`` at 3 ranks against JAX's ``gpipe``: output
  and the stacked gradient (f64 1e-12); a stage that is not total on zeros
  (x/‖x‖) has a finite gradient, equal to the sequential one;
- ``hetero_stats`` equal to JAX's dict for the TINY U-Net stages and for
  JAX's three-stage toy;
- ``gpipe_hetero`` over the TINY U-Net's stages in f64: inference mode
  against JAX's ``gpipe_hetero`` (1e-10), train mode against the port's
  sequential run of the same fold chain (1e-12); a key/train mismatch
  raises JAX's errors;
- ``make_train_step_pp`` in f64 with (t, noise) injected, 4 microbatches:
  GPipe and 1F1B each equal the port's sequential step on the same fold
  chain (1e-10: loss, params, both moments) and each other; at dropout 0
  they match JAX's GPipe ``make_train_step_pp``; the replicas are
  bit-equal; each rank's hops move each boundary at its own width on every
  tick (fill and drain included);
- PP×DP (stage 3 × data 2), GPipe and 1F1B: equal to the 1-D pipeline at
  the same global batch (1e-10), the six replicas bit-equal;
- the CLI: ``train 1 --tiny --pp --pp-micro=2`` with both schedules (the
  second resuming the first), ``--pp --dp`` on 3 ranks (JAX's fallback
  line) and on 6 (the 2-D mesh), and JAX's rejections.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_linear_algebra_tpu.models import cifar_unet as jax_cu
from big_linear_algebra_tpu.nn.optim import adam_init as jax_adam_init
from big_linear_algebra_tpu.parallel import make_mesh as jax_make_mesh
from big_linear_algebra_tpu.parallel import pipeline as jax_pl
from big_linear_algebra_tpu_torch.data import synth
from big_linear_algebra_tpu_torch.models import cifar_unet as cu
from big_linear_algebra_tpu_torch.models import common
from big_linear_algebra_tpu_torch.nn.optim import (AdamState, adam_init,
                                                   tree_leaves, tree_map)
from big_linear_algebra_tpu_torch.parallel import pipeline as pl
from tests import torch_ranks
from tests.test_torch_unet_tp import (_assert_step, _flat, _tree_np,
                                      assert_bit_equal_step,
                                      assert_step_matches_jax)
from tests.torch_parity import n, t

F64 = {"compute_dtype": "float64"}
F64_NO_DROPOUT = {"compute_dtype": "float64", "dropout_rate": 0.0}
F64_NHWC_REMAT = {"compute_dtype": "float64", "layout": "NHWC",
                  "remat": True}
N_MICRO = 4
KEY = 7


def _jax_mesh(size):
    return jax_make_mesh({"stage": size}, devices=jax.devices()[:size])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case, run once: 3 ranks and 6 ranks; the inputs; the JAX
    draws of the dropout-0 cases."""
    rng = np.random.default_rng(16)
    params = _tree_np(cu.init_params(torch.Generator().manual_seed(0),
                                     cu.TINY))
    ws = rng.standard_normal((3, 6, 6)) * 0.3
    xs = rng.standard_normal((4, 2, 6))
    hx = rng.standard_normal((3, 2, 3, 32, 32))
    hts = rng.integers(0, cu.TINY.timesteps, (3, 2)).astype(np.float64)
    x0 = rng.uniform(-1, 1, (4, 3, 32, 32))
    tt = rng.integers(0, cu.TINY.timesteps, 4).astype(np.int64)
    noise = rng.standard_normal(x0.shape)
    jcfg = dataclasses.replace(jax_cu.TINY, **F64_NO_DROPOUT)
    _, jt, jnoise, _ = jax_cu._ddpm_draws(jnp.asarray(x0),
                                          jax.random.key(11), jcfg)
    jt, jnoise = np.asarray(jt).astype(np.int64), np.asarray(jnoise)
    base = tmp_path_factory.mktemp("pp")

    sched = [np.asarray(a) for a in jax_cu.ddpm_schedule(jcfg)]

    def pp(draws, cfg_kwargs, schedule, data=1):
        return ("unet_pp_step", dict(
            params=params, x0=x0, t=draws[0], noise=draws[1],
            cfg_kwargs=cfg_kwargs, n_micro=N_MICRO, schedule=schedule,
            data=data, ddpm=sched if draws[0] is jt else None))

    def cli(where, *flags):
        return ("cli", dict(module="cifar_unet",
                            argv=["train", "1", "--tiny", "--device=cpu",
                                  *flags], data_dir=str(base / where)))

    three = torch_ranks.spawn(3, [
        ("gpipe", "gpipe_toy", dict(ws=ws, xs=xs)),
        ("hetero", "unet_hetero", dict(params=params, xs=hx, ts=hts,
                                       cfg_kwargs=F64, key=KEY)),
        ("pp gpipe", *pp((tt, noise), F64, "gpipe")),
        ("pp 1f1b", *pp((tt, noise), F64, "1f1b")),
        ("pp gpipe nhwc remat", *pp((tt, noise), F64_NHWC_REMAT, "gpipe")),
        ("pp 1f1b nhwc remat", *pp((tt, noise), F64_NHWC_REMAT, "1f1b")),
        ("pp gpipe remat", *pp((tt, noise), {**F64, "remat": True},
                               "gpipe")),
        ("pp 1f1b remat", *pp((tt, noise), {**F64, "remat": True}, "1f1b")),
        ("pp gpipe jax", *pp((jt, jnoise), F64_NO_DROPOUT, "gpipe")),
        ("pp 1f1b jax", *pp((jt, jnoise), F64_NO_DROPOUT, "1f1b")),
        ("cli gpipe", *cli("pp", "--pp", "--pp-micro=2", "--max-steps=2")),
        ("cli 1f1b", *cli("pp", "--pp", "--pp-micro=2", "--max-steps=2",
                          "--pp-schedule=1f1b")),
        ("cli pp dp", *cli("ppdp3", "--pp", "--dp", "--pp-micro=2",
                           "--max-steps=1")),
    ])
    six = torch_ranks.spawn(6, [
        ("ppdp gpipe", *pp((tt, noise), F64, "gpipe", data=2)),
        ("ppdp 1f1b", *pp((tt, noise), F64, "1f1b", data=2)),
        ("cli", *cli("ppdp6", "--pp", "--dp", "--pp-micro=2",
                     "--max-steps=2", "--pp-schedule=1f1b")),
        ("cli micro", *cli("ppdp6", "--pp", "--dp", "--pp-micro=1")),
    ])
    return {"three": three, "six": six, "params": params, "ws": ws,
            "xs": xs, "hetero": (hx, hts), "x0": x0, "t": tt,
            "noise": noise, "jax draws": (jt, jnoise)}


def _same_on_every_rank(results, case):
    """Every rank's result of ``case``, whose params hash the same."""
    assert len({r[case]["hash"] for r in results}) == 1, case
    return [r[case] for r in results]


def _sequential_step(ranks, cfg_kwargs=F64):
    """The port's sequential PP step: the stage functions one after the
    other on each microbatch, stage s on microbatch m drawing from
    ``fold_generator(step seed, s·n_micro + m)``, the loss's gradient by
    autograd, then Adam (the step seed from the generator of seed 3, as
    the ranks draw it)."""
    cfg = dataclasses.replace(cu.TINY, **cfg_kwargs)
    x0, tt, noise = t(ranks["x0"]), t(ranks["t"]), t(ranks["noise"])
    _, seed, _, _ = cu.pp_draws(x0, torch.Generator().manual_seed(3), cfg)
    params = torch_ranks._t(ranks["params"])
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    fns = cu.unet_pipeline_stages(cfg, train=True)
    stages = cu.split_params_stages(leaves)
    mb = x0.shape[0] // N_MICRO
    xs = cu._noised(x0, tt, noise, cfg).reshape(N_MICRO, mb, 3, 32, 32)
    ts = tt.reshape(N_MICRO, mb).to(x0.dtype)
    preds = []
    for m in range(N_MICRO):
        b = (xs[m], ts[m])
        for s, (fn, p) in enumerate(zip(fns, stages)):
            b = fn(p, b, pl.fold_generator(seed, s * N_MICRO + m, "cpu"))
        preds.append(b)
    loss = cu.mse_loss(torch.stack(preds).reshape(x0.shape), noise) \
        / x0.numel()
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                     allow_unused=True))
    grads = tree_map(lambda p: cu._zero_if_none(next(grads), p), leaves)
    new, opt = cu._adam(params, grads, adam_init(params), cfg, None)
    return new, opt, loss.detach()


def test_gpipe_matches_jax_and_nontotal_stage_grads_finite(ranks):
    """``gpipe`` of ``tanh(x @ p)`` over 3 ranks (4 microbatches): output
    and the gradient of sum(out²) with respect to the stacked params
    against JAX's ``gpipe`` (f64 1e-12), the whole stacked gradient on
    every rank. A stage that is not total on zeros (x/‖x‖, NaN at 0): the
    fill and drain ticks do not run it, so the gradient is finite, and
    equal to the sequential chain's."""
    ws, xs = jnp.asarray(ranks["ws"]), jnp.asarray(ranks["xs"])
    mesh = _jax_mesh(3)

    def stage(p, x):
        return jnp.tanh(x @ p)

    want_out = jax_pl.gpipe(stage, ws, xs, mesh)
    want_grad = jax.grad(
        lambda w: jnp.sum(jax_pl.gpipe(stage, w, xs, mesh) ** 2))(ws)
    w = torch_ranks._t(ranks["ws"]).requires_grad_()
    seq = torch_ranks._t(ranks["xs"])
    for i in range(3):
        seq = torch.stack([torch.tanh(
            (x / torch.sqrt(torch.sum(x * x))) @ w[i]) for x in seq])
    torch.sum(seq ** 2).backward()
    for rank in ranks["three"]:
        got = rank["gpipe"]
        np.testing.assert_allclose(got["tanh"]["out"], n(want_out),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(got["tanh"]["grad"], n(want_grad),
                                   rtol=0, atol=1e-12)
        assert np.isfinite(got["nontotal"]["grad"]).all()
        np.testing.assert_allclose(got["nontotal"]["out"], n(seq), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(got["nontotal"]["grad"], n(w.grad),
                                   rtol=0, atol=1e-12)


def _jax_toy_stages():
    def f1(p, x):
        return jnp.tanh(x @ p)

    def f2(p, x):
        return {"a": jnp.tanh(x @ p["w"] + p["b"]),
                "s": jnp.sum(x, axis=-1)}

    def f3(p, d):
        return jnp.concatenate([d["a"], d["s"][:, None]], axis=-1) @ p
    f32 = jnp.float32
    return [f1, f2, f3], [jnp.zeros((6, 10), f32),
                          {"w": jnp.zeros((10, 4), f32),
                           "b": jnp.zeros((4,), f32)},
                          jnp.zeros((5, 3), f32)]


def _torch_toy_stages():
    def f1(p, x):
        return torch.tanh(x @ p)

    def f2(p, x):
        return {"a": torch.tanh(x @ p["w"] + p["b"]), "s": x.sum(-1)}

    def f3(p, d):
        return torch.cat([d["a"], d["s"][:, None]], -1) @ p
    return [f1, f2, f3], [torch.zeros(6, 10), {"w": torch.zeros(10, 4),
                                               "b": torch.zeros(4)},
                          torch.zeros(5, 3)]


@pytest.mark.parametrize("stages", ["unet", "unet train", "toy"])
def test_hetero_stats_equal_jax(stages):
    """``hetero_stats`` is JAX's dict, key for key and value for value:
    the TINY U-Net's three stages (4 microbatches of 2, inference and train
    mode) and JAX's three-stage toy with its dict boundary."""
    if stages == "toy":
        jf, jp = _jax_toy_stages()
        tf, tp = _torch_toy_stages()
        jxs, txs, key, tkey = jnp.zeros((5, 4, 6), jnp.float32), \
            torch.zeros(5, 4, 6), None, None
    else:
        train = stages == "unet train"
        jf = jax_cu.unet_pipeline_stages(jax_cu.TINY, train=train)
        tf = cu.unet_pipeline_stages(cu.TINY, train=train)
        jp = jax_cu.split_params_stages(
            jax_cu.init_params(jax.random.key(0), jax_cu.TINY))
        tp = cu.split_params_stages(
            cu.init_params(torch.Generator().manual_seed(0), cu.TINY))
        jxs = (jnp.zeros((4, 2, 3, 32, 32), jnp.float32),
               jnp.zeros((4, 2), jnp.float32))
        txs = (torch.zeros(4, 2, 3, 32, 32), torch.zeros(4, 2))
        key, tkey = (jax.random.key(0), 1) if train else (None, None)
    want = jax_pl.hetero_stats(jf, jp, jxs, key)
    got = pl.hetero_stats(tf, tp, txs, tkey)
    assert got == want


def test_gpipe_hetero_unet_stages(ranks):
    """The TINY U-Net's stages over 3 ranks in f64 (3 microbatches of 2):
    inference mode against JAX's ``gpipe_hetero`` (1e-10); train mode
    equal to the port's sequential chain with the same folds,
    ``fold_generator(7, s·3 + m)`` (1e-12); train stages without a key
    and inference stages with one raise JAX's errors."""
    hx, hts = ranks["hetero"]
    p64 = jax.tree.map(lambda a: jnp.asarray(np.array(a)), ranks["params"])
    cfg = dataclasses.replace(jax_cu.TINY, **F64)
    want = jax_pl.gpipe_hetero(
        jax_cu.unet_pipeline_stages(cfg), jax_cu.split_params_stages(p64),
        (jnp.asarray(hx), jnp.asarray(hts)), _jax_mesh(3))
    tcfg = dataclasses.replace(cu.TINY, **F64)
    fns = cu.unet_pipeline_stages(tcfg, train=True)
    sp = cu.split_params_stages(torch_ranks._t(ranks["params"]))
    seq = []
    for m in range(3):
        b = (t(hx[m]), t(hts[m]))
        for s, (fn, p) in enumerate(zip(fns, sp)):
            b = fn(p, b, pl.fold_generator(KEY, s * 3 + m, "cpu"))
        seq.append(n(b))
    for rank in ranks["three"]:
        got = rank["hetero"]
        np.testing.assert_allclose(got["inference"], n(want), rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(got["train"], np.stack(seq), rtol=0,
                                   atol=1e-12)
        assert np.abs(got["train"] - got["inference"]).max() > 1e-3
        assert got["error no key"] == ("train=True pipeline stages need "
                                       "gpipe_hetero(..., key=...)")
        assert got["error key"].startswith("inference stages got a key")


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp_step_equals_sequential_fold_chain(ranks, schedule):
    """``make_train_step_pp`` over 3 ranks in f64, 4 microbatches, dropout
    on, (t, noise) injected: equal to the port's sequential step on the
    same fold chain (loss, params, both moments within 1e-10), on every
    rank; the replicas bit-equal; 1F1B equal to GPipe (1e-12)."""
    want_p, want_opt, want_loss = _sequential_step(ranks)
    results = _same_on_every_rank(ranks["three"], f"pp {schedule}")
    for got in results:
        _assert_step(got, want_p, want_opt, want_loss, 1e-10)
    other = ranks["three"][0]["pp gpipe"]
    for k, v in _flat(results[0]["params"]).items():
        np.testing.assert_allclose(v, _flat(other["params"])[k], rtol=0,
                                   atol=1e-12, err_msg=k)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp_step_nhwc_remat_equals_plain_pp_step(ranks, schedule):
    """``--layout=NHWC --remat`` through the pipeline: the down stage
    transposes at entry, the mid boundaries carry channels-last skips, the
    up stage transposes back, and each resnet block is recomputed (under
    1F1B inside the stage's own recompute), its fold generator's draws
    replayed. Against the same step without the flags, the replicas
    bit-equal: under ``--remat`` alone bit-equal; with NHWC too the loss
    within 1e-9, the moments within 1e-7 of each leaf's max|ref| (the
    layouts sum in other orders, which the net amplifies to ~1e-8 of the
    gradient; JAX's own NHWC test allows 1e-6), the
    parameters within Adam's response, and the same hop bytes (the
    boundaries keep their widths)."""
    want = ranks["three"][0][f"pp {schedule}"]
    for got in _same_on_every_rank(ranks["three"], f"pp {schedule} remat"):
        assert_bit_equal_step(got, want)
    for got in _same_on_every_rank(ranks["three"],
                                   f"pp {schedule} nhwc remat"):
        assert_step_matches_jax(got, want["params"],
                                AdamState(step=1, m=want["m"], v=want["v"]),
                                want["loss"], moments_of_max=1e-7)
    for rank in ranks["three"]:
        assert rank[f"pp {schedule} nhwc remat"]["hop bytes"] == \
            rank[f"pp {schedule}"]["hop bytes"]


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp_step_matches_jax_at_dropout_0(ranks, schedule):
    """At dropout 0 with JAX's draws of the step key and its DDPM schedule
    (whose f32 cumprod may round otherwise): the port's GPipe and 1F1B
    steps against JAX's GPipe ``make_train_step_pp`` on 3 devices, 4
    microbatches (the two JAX schedules are held equal by JAX's own
    tests), on every rank: ``assert_step_matches_jax`` with the moments
    within 1e-8 of max|ref|. f64 summation order alone moves these
    gradients by ~1e-9 of max|ref| here: JAX's own gradient over 4
    microbatches differs from its whole-batch one by 1.4e-9 of max|ref| on
    these inputs (the reference's group norm divides by the raw
    variance)."""
    cfg = dataclasses.replace(jax_cu.TINY, **F64_NO_DROPOUT)
    p = jax.tree.map(lambda a: jnp.asarray(np.array(a)), ranks["params"])
    want = jax_cu.make_train_step_pp(_jax_mesh(3), cfg, n_micro=N_MICRO)(
        p, jax_adam_init(p), jnp.asarray(ranks["x0"]), jax.random.key(11))
    for got in _same_on_every_rank(ranks["three"], f"pp {schedule} jax"):
        assert_step_matches_jax(got, *want, moments_of_max=1e-8)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp_hops_move_each_boundary_at_its_own_width(ranks, schedule):
    """Each rank's hop bytes in one step: every tick (GPipe: n_micro + S −
    2 hops each way; 1F1B: n_micro + 2S − 3 slots' hops each way) sends
    this rank's output boundary forward and its input cotangent back, each
    at its own width (f64 here), zeros on the fill and drain ticks."""
    tcfg = dataclasses.replace(cu.TINY, **F64)
    widths = pl.hetero_stats(
        cu.unet_pipeline_stages(tcfg, train=True),
        cu.split_params_stages(torch_ranks._t(ranks["params"])),
        (torch.zeros(N_MICRO, 1, 3, 32, 32, dtype=torch.float64),
         torch.zeros(N_MICRO, 1, dtype=torch.float64)), 1)[
        "boundary_widths"]
    hops = N_MICRO + 1 if schedule == "gpipe" else N_MICRO + 3
    for s, rank in enumerate(ranks["three"]):
        forward = widths[s + 1] if s < 2 else 0
        backward = widths[s] if s > 0 else 0
        assert rank[f"pp {schedule}"]["hop bytes"] == \
            hops * 8 * (forward + backward)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp_dp_step_equals_1d_pipeline(ranks, schedule):
    """PP×DP on (stage 3 × data 2), 4 global microbatches (2 per data
    coordinate, global indices in the folds): equal to the 1-D pipeline at
    the same global batch (1e-10), and the six replicas bit-equal."""
    want = ranks["three"][0][f"pp {schedule}"]
    for got in _same_on_every_rank(ranks["six"], f"ppdp {schedule}"):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                                   atol=1e-10)
        for name in ("params", "m", "v"):
            g, w = _flat(got[name]), _flat(want[name])
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-10,
                                           err_msg=f"{name} {k}")


def test_cli_pp_schedules_and_pp_dp(ranks):
    """``train 1 --tiny --pp --pp-micro=2 --max-steps=2`` on 3 ranks prints
    JAX's pipeline line and one metrics line from rank 0 alone; the 1F1B
    run resumes its train state; ``--pp --dp`` on 3 ranks prints JAX's
    fallback and runs pure --pp; on 6 ranks the 2-D mesh's line, and
    ``--pp-micro=1`` there is not divisible by the 2 data shards."""
    def rank0(results, case):
        (rc, out), rest = results[0][case], [r[case] for r in results[1:]]
        assert rc == 0, out
        assert all(r == (0, "") for r in rest), rest
        assert sum(line.startswith("epoch:") for line in out.splitlines()) \
            == 1
        return out

    out = rank0(ranks["three"], "cli gpipe")
    assert "--pp: 3-stage pipeline (down/mid/up), 2 microbatches, gpipe " \
           "schedule" in out
    assert "step: 2" in out
    out = rank0(ranks["three"], "cli 1f1b")
    assert "2 microbatches, 1f1b schedule" in out
    assert "resumed train state at step 2 (epoch 1)" in out
    out = rank0(ranks["three"], "cli pp dp")
    assert "--pp --dp needs >= 6 devices (3 stages × >=2 data shards), " \
           "have 3; running pure --pp" in out
    out = rank0(ranks["six"], "cli")
    assert "--pp --dp: 3-stage pipeline × 2 data shards, 2 global " \
           "microbatches, 1f1b schedule" in out
    for r in ranks["six"]:
        assert r["cli micro"][0] == (
            "--pp --dp: --pp-micro=1 microbatches are not divisible by the 2 "
            "data shards (3 stages × 2 data on 6 devices)")


# The process group's timeout of the launch with a rank left out, and the
# steps of a TINY pipeline run that outlasts it (~0.25 s a step here).
IDLE_TIMEOUT_S = 5
IDLE_STEPS = 50


def test_cli_pp_leaves_a_rank_out_past_the_timeout(tmp_path):
    """``train 1 --tiny --pp`` launched on 4 gloo ranks whose process group
    times out after 5 s, with a run longer than that: the pipeline takes
    ranks 0–2 and ends the verb with a barrier among them; rank 3, left
    out of the mesh, leaves at once instead of waiting out the run in a
    barrier of the whole launch."""
    synth.ensure_cifar(str(tmp_path))  # rank 0 would make it within the run
    results = torch_ranks.spawn(4, [("cli", "cli", dict(
        module="cifar_unet", data_dir=str(tmp_path),
        argv=["train", "1", "--tiny", "--device=cpu", "--pp",
              "--pp-micro=2", f"--max-steps={IDLE_STEPS}"]))],
        timeout=IDLE_TIMEOUT_S)
    rc, out = results[0]["cli"]
    assert rc == 0, out
    assert "--pp: 3-stage pipeline (down/mid/up)" in out
    seconds = float(re.search(r"epoch_seconds: ([0-9.]+)", out).group(1))
    assert seconds > IDLE_TIMEOUT_S, out
    assert [r["cli"] for r in results[1:]] == [(0, "")] * 3


@pytest.mark.parametrize("cards, flags, want", [
    (4, ["pp"], 3), (5, ["pp", "dp"], 3), (7, ["pp", "dp"], 6),
    (8, ["pp", "dp"], 6), (2, ["pp"], 0), (1, ["pp"], 0), (4, ["dp"], 4),
    (4, ["tp"], 4), (1, ["dp"], 0)])
def test_plain_launch_spawns_the_ranks_of_the_mesh(monkeypatch, cards,
                                                    flags, want):
    """A parallel mode launched plainly spawns one rank per card its mesh
    uses: 3 for --pp (3·⌊n/3⌋ for --pp --dp on n ≥ 6), every card for --dp
    and --tp; none on one card, or for --pp on two."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert common._ranks_to_spawn({f: "" for f in flags}) == want


def test_cli_pp_rejections(capsys):
    """JAX's rejections, raised before any rank or data is touched: --pp
    with --tp; a batch the microbatches do not divide; a non-positive or
    bare --pp-micro; a schedule other than gpipe or 1f1b. The port also
    rejects --pp-micro and --pp-schedule without --pp and the parallel
    flags outside train (the JAX package ignores them there)."""
    with pytest.raises(SystemExit, match="--pp cannot be combined with "
                                         "--tp"):
        cu.main(["train", "1", "--tiny", "--device=cpu", "--pp", "--tp"])
    with pytest.raises(SystemExit, match="batch size 2 is not divisible by "
                                         "--pp-micro=4 microbatches"):
        cu.main(["train", "1", "--tiny", "--device=cpu", "--pp"])
    with pytest.raises(ValueError, match="must be positive"):
        cu.main(["train", "1", "--tiny", "--device=cpu", "--pp", "--pp-micro=0"])
    with pytest.raises(ValueError, match="needs an integer value"):
        cu.main(["train", "1", "--tiny", "--device=cpu", "--pp", "--pp-micro"])
    with pytest.raises(SystemExit, match="gpipe or 1f1b, got 'zigzag'"):
        cu.main(["train", "1", "--tiny", "--device=cpu", "--pp",
                 "--pp-micro=2", "--pp-schedule=zigzag"])
    with pytest.raises(SystemExit, match="--pp-micro applies to --pp"):
        cu.main(["train", "1", "--tiny", "--device=cpu", "--pp-micro=2"])
    for flag in ("--tp", "--pp"):
        assert cu.main(["run", "1", "--tiny", flag]) == 1
        assert "applies to train" in capsys.readouterr().out
