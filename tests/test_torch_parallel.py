"""The port's data- and tensor-parallel modes against the JAX package's.

The ranks run in spawned gloo CPU processes, two launches for the whole
file (2 and 4 ranks, ``tests/torch_ranks.py``); the JAX references run
here, on the conftest's 8 virtual CPU devices, on meshes of the same
shapes. Every case holds the same numpy inputs:

- mnist_nn: the DP step at 2 and 4 ranks in f64 against JAX's
  ``make_train_step_dp`` and its single-device ``train_step`` (1e-10 leaf
  by leaf), DP×TP on (data 2 × model 2) against JAX's
  ``make_train_step_dp_tp`` (1e-10; with and without a finite clip), the
  resident DP epoch on a ragged 200-example set at batch 64 against JAX's
  ``make_epoch_resident_dp`` (1e-10), one f32 DP step against the Pallas
  kernel in interpret mode (2e-4 of max|ref|);
- mnist_hinge: ``make_train_chunk_dp`` with an example count that needs
  padding, the convergence freeze reached, against JAX's ``_train_chunk``
  and ``make_train_chunk_dp`` in f64 (1e-12);
- cifar_unet TINY in f64: with each rank's (t, noise) and dropout masks
  injected, the DP step equals the single-device step over the
  concatenated batch with those draws (1e-10: loss, params, Adam moments);
  a ``--bf16-params`` DP run leaves the replicas bit-equal;
- the mesh, the shardings and the collectives; ``dryrun_multichip(4)``;
- the CLIs: ``torchrun --standalone --nproc-per-node=2 ... mnist_nn train
  1 --dp --device=cpu`` against the single-process ``train 1``, mnist_hinge
  ``train --dp`` printing what the single-process run prints, a batch that
  does not divide over the ranks, and cifar_unet's rejections of the
  flags it does not port.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_linear_algebra_tpu.models import mnist_hinge as jax_hinge
from big_linear_algebra_tpu.models import mnist_nn as jax_nn
from big_linear_algebra_tpu.parallel import make_mesh as jax_make_mesh
from big_linear_algebra_tpu_torch.data import synth
from big_linear_algebra_tpu_torch.models import cifar_unet as cu
from big_linear_algebra_tpu_torch.models import mnist_hinge as hinge
from big_linear_algebra_tpu_torch.models import mnist_nn
from big_linear_algebra_tpu_torch.nn.optim import AdamState, adam_init
from big_linear_algebra_tpu_torch.parallel import (distributed_init,
                                                   local_device_count,
                                                   make_hybrid_mesh,
                                                   make_mesh)
from big_linear_algebra_tpu_torch.parallel.dryrun import dryrun_multichip
from tests import torch_ranks
from tests.test_torch_legacy_models import assert_same_stdout
from tests.test_torch_unet_tp import (assert_bit_equal_step,
                                      assert_step_matches_jax)
from tests.torch_parity import n, t

REPO = Path(__file__).resolve().parents[1]
LR = 0.5  # the JAX tests' rate: every leaf moves visibly in one step


def _jax_mesh(axes):
    size = int(np.prod(list(axes.values())))
    return jax_make_mesh(axes, devices=jax.devices()[:size])


def _jax(params):
    """Fresh JAX arrays: the JAX package's steps donate their params."""
    return {k: jnp.asarray(np.array(v)) for k, v in params.items()}


def _mnist_inputs(rng, b=64, masked=9):
    x = rng.random((b, 784))
    onehot = np.eye(10)[rng.integers(0, 10, size=b)]
    mask = np.ones(b)
    mask[-masked:] = 0.0
    return x, onehot, mask


def _hinge_case(rng):
    """162 examples (padding to 4 ranks: 2 zero rows; to JAX's 8: 6) whose
    chunk converges at its first iteration: that update lands, and the
    freeze holds the weights for the other nine."""
    x = rng.uniform(0, 1, (162, 784)) * 2e-4
    labels = rng.integers(0, 10, 162)
    w0 = rng.normal(0, 0.01, (784, 10))
    return x, labels, w0, 0.05


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return n(tree)


def _unet_inputs(rng, cfg, world):
    p = _tree_np(cu.init_params(torch.Generator().manual_seed(0), cfg))
    b = 2 * world
    x0 = rng.uniform(-1, 1, (b, 3, cfg.image_size, cfg.image_size))
    tt = rng.integers(0, cfg.timesteps, b).astype(np.int64)
    noise = rng.standard_normal(x0.shape)
    return p, x0, tt, noise


UNET_F64 = {"compute_dtype": "float64"}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case, run once: the port in spawned ranks (2 and 4), the JAX
    references here."""
    rng = np.random.default_rng(42)
    params = {k: np.asarray(v, np.float64) for k, v in
              jax_nn.init_params(jax.random.key(5)).items()}
    p32 = {k: v.astype(np.float32) for k, v in params.items()}
    x, onehot, mask = _mnist_inputs(rng)
    x32, onehot32, mask32 = (v.astype(np.float32)
                             for v in _mnist_inputs(rng, masked=0))
    x_raw = rng.integers(0, 256, (200, 784)).astype(np.float64)
    y = rng.integers(0, 10, 200).astype(np.float64)
    perm = mnist_nn.epoch_permutation(np.random.default_rng(7), 200, 64)
    hx, hl, hw, hlr = _hinge_case(rng)
    unet_p, x0, tt, noise = _unet_inputs(rng, cu.TINY, 2)
    data_dir = tmp_path_factory.mktemp("dp")
    w_hinge = hinge.weights_from_jax(
        rng.normal(0, 0.01, (784, 10)).astype(np.float32))
    for d in ("dp", "single"):  # the hinge CLI's data and initial weights
        synth.ensure_mnist(str(data_dir / d), train_n=512, test_n=64)
        os.environ["BLA_DATA_DIR"] = str(data_dir / d)
        try:
            hinge.save_weights(w_hinge)
        finally:
            del os.environ["BLA_DATA_DIR"]

    step = ("mnist_dp_step", dict(params=params, x=x, onehot=onehot,
                                  mask=mask, lr=LR))
    two = torch_ranks.spawn(2, [
        ("dp", *step),
        ("dp f32", "mnist_dp_step", dict(params=p32, x=x32, onehot=onehot32,
                                         mask=mask32, lr=LR)),
        ("unet", "unet_dp_step", dict(params=unet_p, x0=x0, t=tt,
                                      noise=noise, mask_seed=9,
                                      cfg_kwargs=UNET_F64)),
        ("unet drawn", "unet_dp_step", dict(
            params=unet_p, x0=x0, t=tt, noise=noise, mask_seed=9,
            cfg_kwargs=UNET_F64, inject=False)),
        ("unet nhwc remat", "unet_dp_step", dict(
            params=unet_p, x0=x0, t=tt, noise=noise, mask_seed=9,
            cfg_kwargs={**UNET_F64, "layout": "NHWC", "remat": True},
            inject=False)),
        ("unet remat", "unet_dp_step", dict(
            params=unet_p, x0=x0, t=tt, noise=noise, mask_seed=9,
            cfg_kwargs={**UNET_F64, "remat": True}, inject=False)),
        ("bf16", "unet_bf16_replicas", dict(x0=x0.astype(np.float32),
                                            n_steps=2)),
        ("hinge cli", "cli", dict(module="mnist_hinge",
                                  argv=["train", "30", "0.0005", "--dp",
                                        "--device=cpu"],
                                  data_dir=str(data_dir / "dp"))),
        ("batch", "cli", dict(module="mnist_nn",
                              argv=["train", "1", "--dp", "--device=cpu",
                                    "--batch=63"],
                              data_dir=str(data_dir / "batch"))),
        ("scan dp", "cli", dict(module="cifar_unet",
                                argv=["train", "1", "--tiny", "--dp",
                                      "--scan-steps=2", "--device=cpu"],
                                data_dir=str(data_dir / "scan"))),
        ("scan tp", "cli", dict(module="cifar_unet",
                                argv=["train", "1", "--tiny", "--tp",
                                      "--scan-steps=2", "--max-steps=3",
                                      "--device=cpu"],
                                data_dir=str(data_dir / "scan_tp"))),
    ])
    four = torch_ranks.spawn(4, [
        ("mesh", "mesh_facts", {}),
        ("dp", *step),
        ("dp tp", "mnist_dp_tp_step", dict(params=params, x=x,
                                           onehot=onehot, mask=mask, lr=LR,
                                           data=2, model=2,
                                           clip=float("inf"))),
        ("dp tp clip", "mnist_dp_tp_step", dict(params=params, x=x,
                                                onehot=onehot, mask=mask,
                                                lr=LR, data=2, model=2,
                                                clip=0.05)),
        ("epoch", "mnist_dp_epoch", dict(params=params, x_raw=x_raw, y=y,
                                         perm=perm, lr=0.1)),
        ("hinge", "hinge_dp_chunk", dict(w=hw, x=hx, labels=hl, lr=hlr,
                                         n_iters=10)),
        ("scan pp", "cli", dict(module="cifar_unet",
                                argv=["train", "1", "--tiny", "--pp",
                                      "--pp-micro=2", "--scan-steps=2",
                                      "--device=cpu"],
                                data_dir=str(data_dir / "scan"))),
    ])
    return {"two": two, "four": four, "params": params, "p32": p32,
            "mnist": (x, onehot, mask), "mnist32": (x32, onehot32, mask32),
            "epoch": (x_raw, y, perm), "hinge": (hx, hl, hw, hlr),
            "unet": (unet_p, x0, tt, noise), "data_dir": data_dir}


def _assert_leaves(got, want, atol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], n(want[k]), rtol=0, atol=atol,
                                   err_msg=k)


def _replicated(results, case):
    """Every rank's result of ``case``, which must be the same."""
    first = results[0][case]
    for other in results[1:]:
        for k, v in first["params"].items():
            np.testing.assert_array_equal(other[case]["params"][k], v)
    return first


@pytest.mark.parametrize("world", ["two", "four"])
def test_mnist_dp_step_f64_matches_jax(ranks, world):
    """The DP step at 2 and 4 ranks, f64, the batch of 64 with 9 masked
    rows: replicated on every rank, every leaf within 1e-10 of JAX's
    ``make_train_step_dp`` on a mesh of as many devices, and of the
    single-device ``train_step``; the same correct count and CE sum."""
    size = 2 if world == "two" else 4
    got = _replicated(ranks[world], "dp")
    cfg = jax_nn.Config(learn_rate=LR)
    batch = [jnp.asarray(v) for v in ranks["mnist"]]
    want_dp, c_dp, ce_dp = jax_nn.make_train_step_dp(
        _jax_mesh({"data": size}), cfg)(_jax(ranks["params"]), *batch)
    want, c, ce = jax_nn.train_step(_jax(ranks["params"]), *batch, cfg)
    for ref in (want_dp, want):
        _assert_leaves(got["params"], ref, 1e-10)
    assert got["correct"] == float(c_dp) == float(c)
    np.testing.assert_allclose(got["ce"], float(ce_dp), rtol=1e-10)
    np.testing.assert_allclose(got["ce"], float(ce), rtol=1e-10)


def test_mnist_dp_step_f32_matches_pallas_interpret(ranks):
    """One f32 DP step at 2 ranks (K1's plain version at batch 32 per rank)
    against JAX's DP step with the Pallas kernel in interpret mode: each
    leaf within 2e-4 of its max|ref|."""
    got = _replicated(ranks["two"], "dp f32")
    want, _, _ = jax_nn.make_train_step_dp(
        _jax_mesh({"data": 2}), jax_nn.Config(learn_rate=LR))(
        _jax(ranks["p32"]), *(jnp.asarray(v) for v in ranks["mnist32"]))
    for k in want:
        scale = np.abs(n(want[k])).max()
        np.testing.assert_allclose(got["params"][k], n(want[k]), rtol=0,
                                   atol=2e-4 * scale, err_msg=k)


@pytest.mark.parametrize("case", ["dp tp", "dp tp clip"])
def test_mnist_dp_tp_step_f64_matches_jax(ranks, case):
    """DP×TP on (data 2 × model 2): the gathered shards within 1e-10 of
    JAX's ``make_train_step_dp_tp`` leaf by leaf (and of the single-device
    step without the clip), on every rank alike; with a finite clip the
    norm spans the model shards."""
    clip = float("inf") if case == "dp tp" else 0.05
    got = _replicated(ranks["four"], case)
    cfg = jax_nn.Config(learn_rate=LR, grad_clip=clip)
    mesh = _jax_mesh({"data": 2, "model": 2})
    batch = [jnp.asarray(v) for v in ranks["mnist"]]
    want, c, ce = jax_nn.make_train_step_dp_tp(mesh, cfg)(
        jax_nn.place_params_tp(mesh, _jax(ranks["params"])), *batch)
    _assert_leaves(got["params"], want, 1e-10)
    if clip == float("inf"):
        single, _, _ = jax_nn.train_step(_jax(ranks["params"]), *batch, cfg)
        _assert_leaves(got["params"], single, 1e-10)
    assert got["correct"] == float(c)
    np.testing.assert_allclose(got["ce"], float(ce), rtol=1e-10)


def test_mnist_dp_resident_epoch_f64_matches_jax(ranks):
    """The resident DP epoch at 4 ranks on a ragged 200-example set at
    batch 64 (each rank gathers ``perm.reshape(4, 4, 16)[:, rank]``) against
    JAX's ``make_epoch_resident_dp``: every leaf within 1e-10, the same
    correct count and CE sum."""
    got = _replicated(ranks["four"], "epoch")
    x_raw, y, perm = ranks["epoch"]
    want, c, ce = jax_nn.make_epoch_resident_dp(
        _jax_mesh({"data": 4}), jax_nn.Config(learn_rate=0.1))(
        _jax(ranks["params"]), jnp.asarray(x_raw), jnp.asarray(y),
        jnp.asarray(perm))
    _assert_leaves(got["params"], want, 1e-10)
    assert got["correct"] == float(c)
    np.testing.assert_allclose(got["ce"], float(ce), rtol=1e-10)


def test_hinge_dp_chunk_f64_matches_jax(ranks):
    """``make_train_chunk_dp`` at 4 ranks on 162 examples (two zero rows
    pad the last shard) against JAX's ``_train_chunk`` on the 162 and its
    ``make_train_chunk_dp`` on 8 devices (six zero rows): weights and norms
    within 1e-12; the chunk converges and the freeze holds the weights
    after it, on every rank alike."""
    x, labels, w0, lr = ranks["hinge"]
    want_w, want_norms = jax_hinge._train_chunk(
        jnp.asarray(w0), jnp.asarray(x), jnp.asarray(labels, jnp.int32),
        lr, 10)
    pad = (-x.shape[0]) % 8
    xp = np.concatenate([x, np.zeros((pad, 784))])
    lp = np.concatenate([labels, np.zeros(pad, labels.dtype)])
    mesh = _jax_mesh({"data": 8})
    dp_w, dp_norms = jax_hinge.make_train_chunk_dp(mesh, x.shape[0], 10)(
        jnp.asarray(w0), jnp.asarray(xp), jnp.asarray(lp, jnp.int32), lr)
    results = [r["hinge"] for r in ranks["four"]]
    assert [r["rows"] for r in results] == [41] * 4
    for got in results:
        for w_ref, norms_ref in ((want_w, want_norms), (dp_w, dp_norms)):
            np.testing.assert_allclose(got["w"], n(w_ref), rtol=1e-12,
                                       atol=1e-14)
            np.testing.assert_allclose(got["norms"], n(norms_ref),
                                       rtol=1e-12, atol=1e-14)
        assert got["norms"][0].sum() < hinge.EPSILON
        np.testing.assert_array_equal(got["norms"][1:], np.repeat(
            got["norms"][1:2], 9, axis=0))
        assert not np.array_equal(got["w"], w0)
        np.testing.assert_array_equal(got["w"], results[0]["w"])


def _unet_reference(ranks, world=2, mask_seed=9):
    """The single-device port step over the concatenated batch, with the
    ranks' (t, noise) and dropout masks (each call's masks of the ranks
    concatenated along the batch)."""
    unet_p, x0, tt, noise = ranks["unet"]
    cfg = dataclasses.replace(cu.TINY, **UNET_F64)

    def mask_of(i, shape, keep):
        b = shape[0] // world
        return torch.cat([torch.from_numpy(
            np.random.default_rng([mask_seed, r, i]).random(
                (b,) + shape[1:]) < keep) for r in range(world)])

    dropout, _ = torch_ranks.injected_dropout(mask_of)
    real = cu.dropout
    cu.dropout = dropout
    try:
        p = torch_ranks._t(unet_p)
        return cu.train_step(p, adam_init(p), t(x0),
                             torch.Generator().manual_seed(0), cfg,
                             draws=(t(tt), t(noise)))
    finally:
        cu.dropout = real


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = n(v)
    return out


def test_unet_dp_step_equals_single_step_on_the_draws(ranks):
    """TINY U-Net in f64 at 2 ranks (batch 2 each): each rank's (t, noise)
    and dropout masks injected, the DP step (local mean loss, pmean of the
    gradients and the loss, replicated Adam) equals the single-device step
    over the concatenated batch with those draws: loss, every parameter and
    both Adam moments within 1e-10, on both ranks."""
    want_p, want_opt, want_loss = _unet_reference(ranks)
    results = [r["unet"] for r in ranks["two"]]
    assert results[0]["calls"] and results[0]["calls"] == results[1]["calls"]
    for got in results:
        np.testing.assert_allclose(got["loss"], float(want_loss), rtol=0,
                                   atol=1e-10)
        for name, want in (("params", want_p), ("m", want_opt.m),
                           ("v", want_opt.v)):
            g, w = _flat(got[name]), _flat(want)
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-10,
                                           err_msg=f"{name} {k}")


def test_unet_dp_step_nhwc_remat_equals_plain_dp_step(ranks):
    """The DP step under ``--layout=NHWC --remat`` against the DP step
    without the flags, each rank's masks from its rank generator (the NHWC
    mask drawn in the logical NCHW order, each block's draws replayed in
    its recompute): under ``--remat`` alone bit-equal, and the two ranks'
    replicas bit-equal; with NHWC too the loss within 1e-9, the moments
    within 1e-7 of each leaf's max|ref| (the layouts sum in other orders,
    which the net amplifies to ~1e-8 of the gradient; JAX's own NHWC test
    allows 1e-6), the parameters within Adam's
    response."""
    (want, _), (remat, other), (got, _) = (
        [r[case] for r in ranks["two"]]
        for case in ("unet drawn", "unet remat", "unet nhwc remat"))
    assert_bit_equal_step(remat, want)
    assert_bit_equal_step(other, remat)
    assert_step_matches_jax(got, want["params"],
                            AdamState(step=1, m=want["m"], v=want["v"]),
                            want["loss"], moments_of_max=1e-7)


def test_unet_bf16_params_dp_replicas_bit_equal(ranks):
    """Two ``--bf16-params`` DP steps, each rank drawing its own t, noise
    and masks: the stochastic-rounding seed comes from the replicated
    stream, so the bf16 replicas stay bit-equal (a hash of their bytes);
    they moved, and the pmean'd losses agree."""
    a, b = (r["bf16"] for r in ranks["two"])
    assert a["dtype"] == "torch.bfloat16"
    assert a["hash"] == b["hash"] and a["moved"] > 0
    assert a["losses"] == b["losses"] and np.isfinite(a["losses"]).all()


def test_rank_generators_differ_and_repeat():
    """Each rank's draws in a DP step come from the step seed with the rank
    folded in: other ranks draw otherwise, the same rank alike."""
    draw = [torch.rand(4, generator=cu.rank_generator(123, r, "cpu"))
            for r in (0, 1, 0)]
    assert not torch.equal(draw[0], draw[1])
    assert torch.equal(draw[0], draw[2])


def test_mesh_sharding_and_collectives(ranks):
    """At 4 ranks: the (data 2 × model 2) mesh's grid, coordinates and
    lines; ``default_mesh`` and the single-node ``make_hybrid_mesh``; the
    errors with JAX's messages; ``batch_sharding``, ``shard_params_tp`` and
    ``replicate``; psum/pmean of a tree (bf16 summed in f32, dtypes kept);
    ``all_gather`` and its backward (the cotangent summed over the axis,
    this rank's slice: JAX's psum_scatter); ``psum``'s identity backward;
    the ring hop."""
    facts = [r["mesh"] for r in ranks["four"]]
    for r, f in enumerate(facts):
        d, m = divmod(r, 2)
        assert f["shape"] == {"data": 2, "model": 2}
        assert f["grid"] == [[0, 1], [2, 3]]
        assert f["coords"] == {"data": d, "model": m}
        assert f["lines"] == ([m, 2 + m], [2 * d, 2 * d + 1])
        assert f["default"] == {"data": 4}
        assert f["hybrid"] == {"dcn": 1, "data": 2, "model": 2}
        assert f["error {'data': 3}"] == \
            "mesh shape {'data': 3} needs 3 devices, have 4"
        assert f["error {'data': 2, 'model': 4}"] == \
            "mesh shape {'data': 2, 'model': 4} needs 8 devices, have 4"
        assert "need 2 slices but all 4 devices are in one slice" in \
            f["hybrid error"]
        np.testing.assert_array_equal(f["batch"][:, 0], [4 * d + i
                                                         for i in range(4)])
        np.testing.assert_array_equal(
            f["tp"]["w"], np.arange(12.0).reshape(3, 4)[:, 2 * m:2 * m + 2])
        np.testing.assert_array_equal(f["tp"]["b"], [2 * m, 2 * m + 1])
        assert f["tp"]["s"] == 7.0
        np.testing.assert_array_equal(f["replicate"]["a"], [0.0, 0.0])
        # data lines hold ranks {m, 2+m}: (m+1) + (m+3)
        np.testing.assert_array_equal(f["psum data"]["a"],
                                      [2.0 * m + 4] * 3)
        np.testing.assert_array_equal(f["psum data"]["b"]["c"],
                                      [2.0 * m + 2] * 2)
        np.testing.assert_array_equal(f["pmean model"]["a"],
                                      [2.0 * d + 1.5] * 3)
        assert f["psum dtypes"] == ["torch.float64", "torch.bfloat16"]
        np.testing.assert_array_equal(
            f["gathered"], np.repeat([2.0 * d, 2.0 * d + 1], 3)[None]
            .repeat(2, axis=0))
        coeff = np.arange(12.0).reshape(2, 6)[:, 3 * m:3 * m + 3]
        np.testing.assert_array_equal(f["gather grad"], 2 * coeff)
        assert f["psum"][0] == 2.0 * m + 2 and f["psum grad"][0] == 3.0
        assert f["hop"][0] == float(2 * ((d - 1) % 2) + m)


def test_mesh_single_process():
    """Outside a process group: ``distributed_init`` does nothing (JAX's
    single-host no-op) and returns 0; a mesh of one rank has trivial
    groups, a larger one raises with JAX's message; no card here;
    ``make_hybrid_mesh``'s duplicate names raise before any mesh."""
    env = {v: os.environ.pop(v) for v in ("RANK", "WORLD_SIZE",
                                          "MASTER_ADDR") if v in os.environ}
    try:
        assert distributed_init(device="cpu") == 0
        assert distributed_init(device="cpu") == 0
        assert not torch.distributed.is_initialized()
    finally:
        os.environ.update(env)
    mesh = make_mesh({"data": 1})
    assert mesh.shape == {"data": 1} and mesh.index("data") == 0
    assert mesh.group("data") is None and mesh.device.type == "cpu"
    with pytest.raises(ValueError, match=r"mesh shape \{'data': 2\} needs "
                                         r"2 devices, have 1"):
        make_mesh({"data": 2})
    assert make_hybrid_mesh({"dcn": 1}, {"data": 1}).shape == {"dcn": 1,
                                                               "data": 1}
    with pytest.raises(ValueError, match=r"both dcn_axes and ici_axes: "
                                         r"\['data'\]"):
        make_hybrid_mesh({"data": 1}, {"data": 1})
    assert local_device_count() == 0


def test_dryrun_multichip(capsys):
    """The twin of ``__graft_entry__.dryrun_multichip`` on 4 gloo CPU ranks:
    every section JAX's prints at 4 devices runs and is finite (the U-Net
    DP, TP and DP×TP steps, the mnist_nn DP×TP step, ring attention's
    gradient, gpipe, the hetero U-Net stages, the PP step and its 1F1B
    schedule); the PP×DP sections say "skipped" with JAX's note, as JAX's
    do below 6 devices."""
    line = dryrun_multichip(4)
    out = capsys.readouterr().out
    assert line in out
    assert ("dryrun_multichip(4): <6 devices — no 3×N stage×data "
            "factorization, skipping the PPxDP section") in out
    assert line.startswith("dryrun_multichip(4): U-Net DP loss=")
    assert "mnist_nn DPxTP ce=" in line and "ce=skipped" not in line
    assert "SP ring-attn grad ok" in line
    assert "waiting" not in line
    for section in ("U-Net TP loss=", "U-Net DPxTP loss=",
                    "PP U-Net train step loss=",
                    "PP 1F1B train step loss="):
        value = line.split(section)[1].split(",")[0]
        assert np.isfinite(float(value)), section
    assert "PP gpipe ok, PP hetero U-Net stages ok" in line
    assert "PPxDP U-Net train step loss=skipped" in line
    assert "PPxDP 1F1B train step loss=skipped" in line


def _torchrun(argv, data_dir):
    env = dict(os.environ, BLA_DATA_DIR=str(data_dir), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=2", "-m",
         "big_linear_algebra_tpu_torch.models.mnist_nn", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)


def test_cli_mnist_nn_train_dp_torchrun(ranks, monkeypatch, capsys):
    """``torchrun --standalone --nproc-per-node=2 -m ...mnist_nn train 1
    --dp --device=cpu`` from the same initial CSVs as the single-process
    ``train 1 --device=cpu``: one metrics line (rank 0's), the same
    accuracy and loss, and each CSV leaf within f32 reduction-order noise
    of the single-process run: 1e-3 of the leaf's largest update over the
    epoch, plus one unit of the CSV's sixth decimal (two values a few f32
    ulps apart can round to neighbouring decimals)."""
    base = ranks["data_dir"]
    for d in ("tr_dp", "tr_single"):
        synth.ensure_mnist(str(base / d), train_n=512, test_n=64)
        mnist_nn.save_params_csv(mnist_nn.params_from_jax(ranks["p32"]),
                                 base=base / d / "mnist_nn")
    proc = _torchrun(["train", "1", "--dp", "--device=cpu"], base / "tr_dp")
    assert proc.returncode == 0, proc.stderr
    lines = [s for s in proc.stdout.splitlines() if s.startswith("epoch:")]
    assert len(lines) == 1
    assert "backend gloo (ranks on the CPU)" in proc.stdout
    monkeypatch.setenv("BLA_DATA_DIR", str(base / "tr_single"))
    assert mnist_nn.main(["train", "1", "--device=cpu"]) == 0
    single = [s for s in capsys.readouterr().out.splitlines()
              if s.startswith("epoch:")]
    assert lines[0].split("\tepoch_seconds")[0] == \
        single[0].split("\tepoch_seconds")[0]
    got = mnist_nn.load_params_csv(base=base / "tr_dp" / "mnist_nn")
    want = mnist_nn.load_params_csv(base=base / "tr_single" / "mnist_nn")
    for k, w in want.items():
        update = np.abs(n(w) - ranks["p32"][k]).max()
        assert update > 0
        assert np.abs(n(got[k]) - n(w)).max() <= 1e-3 * update + 1e-6, k


def test_cli_hinge_train_dp_prints_what_one_process_prints(ranks,
                                                           monkeypatch,
                                                           capsys):
    """mnist_hinge ``train 30 0.0005 --dp`` in the 2-rank launch (rank 0
    prints; the other rank prints nothing) against the single-process
    ``train`` from the same weights: the same lines, each printed number
    within one unit of its last place."""
    base = ranks["data_dir"]
    (rc0, out0), (rc1, out1) = (r["hinge cli"] for r in ranks["two"])
    assert rc0 == rc1 == 0 and out1 == ""
    monkeypatch.setenv("BLA_DATA_DIR", str(base / "single"))
    assert hinge.main(["train", "30", "0.0005", "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "Gradient norms after iteration 29:" in out
    assert_same_stdout(out0, out)


def test_cli_dp_batch_must_divide_and_unet_rejections(ranks, capsys):
    """A batch that does not divide over the ranks raises with JAX's
    message; ``--scan-steps>1`` exits with JAX's messages under ``--dp``
    and ``--pp``, and under ``--tp`` runs (chunks of 2 and a ragged tail
    of 1: three steps, one metrics line from rank 0); cifar_unet rejects
    the flag it does not port (``--prng``) with its reason, and the
    parallel flags outside train."""
    for r in ranks["two"]:
        rc, _ = r["batch"]
        assert rc == "--dp: batch size 63 is not divisible by 2 devices"
        rc, _ = r["scan dp"]
        assert rc == ("--scan-steps>1 is not supported with --dp; use the "
                      "default device-resident DP epoch mode")
        rc, out = r["scan tp"]
        assert rc == 0 and "later work" not in out
    out = ranks["two"][0]["scan tp"][1]
    assert "--tp: conv kernels channel-sharded over 2 devices" in out
    lines = [s for s in out.splitlines() if s.startswith("epoch: 0")]
    assert len(lines) == 1 and lines[0].endswith("\tstep: 3")
    for r in ranks["four"]:
        rc, _ = r["scan pp"]
        assert rc == ("--scan-steps>1 is not supported with --pp (the "
                      "chunked scan path runs the unsharded train_chunk)")
    for flag, reason in (("--prng=rbg", "torch.Generator"),):
        assert cu.main(["train", "1", "--tiny", flag]) == 1
        out = capsys.readouterr().out
        assert "not supported by cifar_unet" in out and reason in out
    for flag in ("--tp", "--pp", "--pp-micro=4", "--pp-schedule=1f1b"):
        assert cu.main(["run", "1", "--tiny", flag]) == 1
        assert "applies to train" in capsys.readouterr().out
