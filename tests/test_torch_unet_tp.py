"""The port's U-Net tensor parallelism against the JAX package's.

One launch of 4 gloo CPU ranks for the whole file (``tests/torch_ranks.py``,
a (data 2 × model 2) mesh); the JAX references run here, jitted, on the
conftest's virtual CPU devices. Every case holds the same numpy inputs:

- ``tp_param_specs`` leaf by leaf against JAX's PartitionSpecs at 2 and 4
  shards; ``place_tp`` then ``gather_tp`` gives the tree back bit-equal,
  at model 2 and 4, with each leaf's local shape; a ``--bf16-params`` Adam
  write of TP slices (``TPLayout.sr_index``) is bit-equal to the full
  leaf's write;
- TINY in f64 with (t, noise) and the dropout masks injected: the TP step
  (model 2) and the DP×TP step (data 2 × model 2) equal the port's
  single-device ``train_step`` (1e-10: loss, every gathered parameter,
  both Adam moments, on every rank); at dropout 0 they match JAX's
  ``place_tp`` / ``place_dp_tp`` ``train_step`` (loss 1e-9, moments 1e-9
  of max|ref|, parameters within Adam's response to those);
- the CLI: ``train 1 --tiny --tp --max-steps=2`` on the 4 ranks prints
  JAX's line, rank 0 alone, and its CSV tree loads in the JAX package;
  ``--tp --dp`` is rejected with JAX's message.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from big_linear_algebra_tpu.models import cifar_unet as jax_cu
from big_linear_algebra_tpu.nn.optim import adam_init as jax_adam_init
from big_linear_algebra_tpu.parallel import make_mesh as jax_make_mesh
from big_linear_algebra_tpu_torch.models import cifar_unet as cu
from big_linear_algebra_tpu_torch.nn.optim import (AdamState, adam_init,
                                                   adam_update, tree_map)
from tests import torch_ranks
from tests.torch_parity import n, t

F64 = {"compute_dtype": "float64"}
F64_NO_DROPOUT = {"compute_dtype": "float64", "dropout_rate": 0.0}
F64_NHWC_REMAT = {"compute_dtype": "float64", "layout": "NHWC",
                  "remat": True}
MASK_SEED = 9


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return n(tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = n(v)
    return out


def _jax_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.array(a)), tree)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case, run once in one launch of 4 ranks; the inputs, and the
    JAX draws the dropout-0 cases take."""
    rng = np.random.default_rng(15)
    params = _tree_np(cu.init_params(torch.Generator().manual_seed(0),
                                     cu.TINY))
    x0 = rng.uniform(-1, 1, (4, 3, 32, 32))
    tt = rng.integers(0, cu.TINY.timesteps, 4).astype(np.int64)
    noise = rng.standard_normal(x0.shape)
    jcfg = dataclasses.replace(jax_cu.TINY, **F64_NO_DROPOUT)
    _, jt, jnoise, _ = jax_cu._ddpm_draws(jnp.asarray(x0),
                                          jax.random.key(3), jcfg)
    jt, jnoise = np.asarray(jt).astype(np.int64), np.asarray(jnoise)
    data_dir = tmp_path_factory.mktemp("tp")

    sched = [np.asarray(a) for a in jax_cu.ddpm_schedule(jcfg)]

    def step(draw_t, draw_noise, cfg_kwargs, dp, inject=True):
        return dict(params=params, x0=x0, t=draw_t, noise=draw_noise,
                    mask_seed=MASK_SEED, cfg_kwargs=cfg_kwargs, dp=dp,
                    schedule=sched if draw_t is jt else None, inject=inject)

    four = torch_ranks.spawn(4, [
        ("tp", "unet_tp_step", step(tt, noise, F64, False)),
        ("dp tp", "unet_tp_step", step(tt, noise, F64, True)),
        ("tp jax", "unet_tp_step", step(jt, jnoise, F64_NO_DROPOUT, False)),
        ("dp tp jax", "unet_tp_step", step(jt, jnoise, F64_NO_DROPOUT,
                                           True)),
        ("tp drawn", "unet_tp_step", step(tt, noise, F64, False, False)),
        ("tp nhwc remat", "unet_tp_step", step(tt, noise, F64_NHWC_REMAT,
                                               False, False)),
        ("tp remat", "unet_tp_step", step(tt, noise, {**F64, "remat": True},
                                          False, False)),
        ("place", "unet_tp_place", dict(params=params)),
        ("cli", "cli", dict(module="cifar_unet",
                            argv=["train", "1", "--tiny", "--tp",
                                  "--max-steps=2", "--device=cpu"],
                            data_dir=str(data_dir))),
        ("cli tp dp", "cli", dict(module="cifar_unet",
                                  argv=["train", "1", "--tiny", "--tp",
                                        "--dp", "--batch=4",
                                        "--device=cpu"],
                                  data_dir=str(data_dir / "tpdp"))),
    ])
    return {"four": four, "params": params, "x0": x0, "t": tt,
            "noise": noise, "jax draws": (jt, jnoise), "data_dir": data_dir}


def _single_step(ranks, data_lines):
    """The port's single-device f64 step over the batch with the ranks'
    draws and masks: each mask call's masks of the data lines concatenated
    along the batch."""
    cfg = dataclasses.replace(cu.TINY, **F64)

    def mask_of(i, shape, keep):
        b = shape[0] // data_lines
        return torch.cat([torch.from_numpy(
            np.random.default_rng([MASK_SEED, d, i]).random(
                (b,) + shape[1:]) < keep) for d in range(data_lines)])

    dropout, _ = torch_ranks.injected_dropout(mask_of)
    real = cu.dropout
    cu.dropout = dropout
    try:
        p = torch_ranks._t(ranks["params"])
        return cu.train_step(p, adam_init(p), t(ranks["x0"]),
                             torch.Generator().manual_seed(0), cfg,
                             draws=(t(ranks["t"]), t(ranks["noise"])))
    finally:
        cu.dropout = real


def assert_step_matches_jax(got, want_p, want_opt, want_loss,
                            moments_of_max=1e-9, lr=cu.TINY.learn_rate,
                            eps=1e-8):
    """One Adam step of the port (``got``: loss, params, m, v as numpy
    trees) against JAX's, as ``test_three_adam_steps_f64_match_jax`` holds
    the single-device step: the loss within 1e-9, the moments within
    ``moments_of_max`` of each leaf's max|ref|, the parameters within
    1e-12 plus twice Adam's
    first-order response to the moment differences (an element whose
    gradient is near eps moves by up to lr·δ/eps for a gradient difference
    δ, so a flat bound on the parameters would hold f64 summation order,
    not the step)."""
    np.testing.assert_allclose(got["loss"], float(want_loss), rtol=0,
                               atol=1e-9)
    p, m, v = (_flat(got[k]) for k in ("params", "m", "v"))
    jp, jm, jv = (_flat(x) for x in (want_p, want_opt.m, want_opt.v))
    assert sorted(p) == sorted(jp)
    bc1, bc2 = 1 - 0.9, 1 - 0.999
    for k in jp:
        for name, a, b in (("m", m[k], jm[k]), ("v", v[k], jv[k])):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=moments_of_max * np.abs(b).max(),
                                       err_msg=f"{name} {k}")
        den = np.sqrt(jv[k] / bc2) + eps
        response = lr * (np.abs(m[k] - jm[k]) / bc1 / den
                         + np.abs(jm[k]) / bc1 * np.abs(
                             np.sqrt(v[k] / bc2) - np.sqrt(jv[k] / bc2))
                         / den ** 2)
        excess = np.abs(p[k] - jp[k]) - (1e-12 + 2 * response)
        assert excess.max() <= 0, (k, np.abs(p[k] - jp[k]).max())


def _assert_step(got, want_p, want_opt, want_loss, atol):
    np.testing.assert_allclose(got["loss"], float(want_loss), rtol=0,
                               atol=atol)
    for name, want in (("params", want_p), ("m", want_opt.m),
                       ("v", want_opt.v)):
        g, w = _flat(got[name]), _flat(want)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("n_shards", [2, 4])
def test_tp_param_specs_match_jax(ranks, n_shards):
    """``tp_param_specs`` leaf by leaf against JAX's: the dim a leaf shards
    along where JAX puts the model axis, None where JAX replicates; at 2
    and 4 shards some leaves shard (conv kernels, time_w, time_b) and some
    replicate (the attention projections; the 3-channel output head)."""
    jp = jax_cu.init_params(jax.random.key(0), jax_cu.TINY)
    want = jax_cu.tp_param_specs(jp, n_shards)
    got = _flat_specs(cu.tp_param_specs(torch_ranks._t(ranks["params"]),
                                        n_shards))
    flat_want = {jax.tree_util.keystr(path): spec for path, spec in
                 jax.tree_util.tree_leaves_with_path(
                     want, is_leaf=lambda x: isinstance(x, P))}
    assert len(got) == len(flat_want)
    for path, spec in flat_want.items():
        key = path.replace("['", "").replace("']", "/").rstrip("/")
        dims = [i for i, a in enumerate(spec) if a == "model"]
        assert got[key] == (dims[0] if dims else None), key
    values = set(got.values())
    assert values == {None, 0, 1}
    assert got["output_conv"] is None and got["mid/attn/q"] is None


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("axis", ["model 2", "model 4"])
def test_place_tp_and_gather_give_the_tree_back(ranks, axis):
    """``place_tp`` keeps each rank's slice of the sharded leaves (and of
    the Adam moments); ``gather_tp`` gives the whole tree back bit-equal on
    every rank. A ``--bf16-params`` Adam write of each rank's slices with
    ``TPLayout.sr_index`` rounds each element with its full leaf's bits:
    gathered, bit-equal to the full tree's write."""
    size = int(axis.split()[1])
    full = torch_ranks._t(ranks["params"])
    specs = _flat_specs(cu.tp_param_specs(full, size))
    grads = tree_map(lambda x: torch.sin(3.0 * x + 1.0), full)
    bf16 = tree_map(lambda x: x.to(torch.bfloat16), full)
    want_sr, _ = adam_update(bf16, grads, adam_init(bf16), 1e-2,
                             sr_seed=1234567)
    want_sr = _flat(want_sr)
    for rank in ranks["four"]:
        got = rank["place"][axis]
        back = _flat(got["back"])
        for k, v in _flat(full).items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
            shape = list(v.shape)
            if specs[k] is not None:
                shape[specs[k]] //= size
            assert tuple(_flat_specs(got["shapes"])[k]) == tuple(shape), k
        assert np.all(_flat(got["opt"])["down_1/resnet_1/conv_1"] == 0.0)
        sr = _flat(got["sr"])
        for k, v in want_sr.items():
            np.testing.assert_array_equal(sr[k], v, err_msg=k)


@pytest.mark.parametrize("case", ["tp", "dp tp"])
def test_unet_tp_step_equals_single_step_on_the_draws(ranks, case):
    """TINY in f64, (t, noise) and the dropout masks injected: the TP step
    on model 2 (each model line on the whole batch) and the DP×TP step on
    data 2 × model 2 (each data line on its half, its own masks) equal the
    single-device step over the batch with those draws: loss, every
    gathered parameter and both Adam moments within 1e-10, on all 4
    ranks; the ranks of a model line drew the same masks."""
    want_p, want_opt, want_loss = _single_step(
        ranks, 2 if case == "dp tp" else 1)
    results = [r[case] for r in ranks["four"]]
    assert results[0]["calls"]
    assert results[0]["calls"] == results[1]["calls"]
    for got in results:
        _assert_step(got, want_p, want_opt, want_loss, 1e-10)


@pytest.mark.parametrize("case", ["tp jax", "dp tp jax"])
def test_unet_tp_step_matches_jax_at_dropout_0(ranks, case):
    """At dropout 0 with JAX's draws (t, noise from ``_ddpm_draws`` of the
    step key) and its DDPM schedule (whose f32 cumprod may round
    otherwise): the TP step against JAX's ``place_tp`` + ``train_step`` on
    2 devices, the DP×TP step against its ``place_dp_tp`` step on a
    (data 2 × model 2) mesh with the batch in ``dp_tp_batch_sharding``, on
    every rank: the loss within 1e-9, the moments within 1e-9 of each
    leaf's max|ref|, the parameters within Adam's response to them
    (``assert_step_matches_jax``)."""
    cfg = dataclasses.replace(jax_cu.TINY, **F64_NO_DROPOUT)
    p = _jax_tree(ranks["params"])
    x0 = jnp.asarray(ranks["x0"])
    if case == "tp jax":
        mesh = jax_make_mesh({"model": 2}, devices=jax.devices()[:2])
        p, opt = jax_cu.place_tp(mesh, p, jax_adam_init(p))
    else:
        mesh = jax_make_mesh({"data": 2, "model": 2},
                             devices=jax.devices()[:4])
        p, opt = jax_cu.place_dp_tp(mesh, p, jax_adam_init(p))
        x0 = jax.device_put(x0, jax_cu.dp_tp_batch_sharding(mesh))
    want_p, want_opt, want_loss = jax_cu.train_step(
        p, opt, x0, jax.random.key(3), cfg)
    for rank in ranks["four"]:
        assert_step_matches_jax(rank[case], want_p, want_opt, want_loss)


def test_unet_tp_step_nhwc_remat_equals_plain_tp_step(ranks):
    """The TP step under ``--layout=NHWC --remat`` (the sharded convs'
    outputs gathered along the channels-last axis, each block recomputed,
    its gathers replayed on every rank) against the TP step without the
    flags, all drawing their masks from the step's generator, on all 4
    ranks: under ``--remat`` alone bit-equal; with NHWC too the loss
    within 1e-9, the moments within 1e-7 of each leaf's max|ref| (the
    layouts sum in other orders, which the net amplifies to ~1e-8 of the
    gradient; JAX's own NHWC test allows 1e-6), the
    parameters within Adam's response."""
    for rank in ranks["four"]:
        want = rank["tp drawn"]
        assert_bit_equal_step(rank["tp remat"], want)
        assert_step_matches_jax(
            rank["tp nhwc remat"], want["params"],
            AdamState(step=1, m=want["m"], v=want["v"]), want["loss"],
            moments_of_max=1e-7)


def assert_bit_equal_step(got, want):
    """Two steps' results (loss, params, m, v as numpy trees) bit-equal."""
    assert got["loss"] == want["loss"]
    for name in ("params", "m", "v"):
        g, w = _flat(got[name]), _flat(want[name])
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name} {k}")


def test_cli_tp_trains_and_writes_a_tree_jax_loads(ranks, capsys):
    """``cifar_unet train 1 --tiny --tp --max-steps=2`` on the 4 ranks:
    JAX's "--tp: conv kernels channel-sharded over 4 devices" and one
    metrics line from rank 0, nothing from the others; the CSV tree it
    wrote (the gathered tree) loads in the JAX package with finite
    leaves. ``--tp --dp`` on several ranks exits with JAX's message."""
    outs = [r["cli"] for r in ranks["four"]]
    rc0, out0 = outs[0]
    assert rc0 == 0, out0
    assert "--tp: conv kernels channel-sharded over 4 devices" in out0
    assert sum(line.startswith("epoch:") for line in out0.splitlines()) == 1
    assert "step: 2" in out0
    assert all(rc == 0 and out == "" for rc, out in outs[1:])
    import os

    os.environ["BLA_DATA_DIR"] = str(ranks["data_dir"])
    try:
        loaded = jax_cu.load_params_csv(jax_cu.TINY)
    finally:
        del os.environ["BLA_DATA_DIR"]
    init = _flat(cu.init_params(torch.Generator().manual_seed(
        cu.TINY.seed), cu.TINY))
    got = {jax.tree_util.keystr(path).replace("['", "").replace("']", "/")
           .rstrip("/"): np.asarray(leaf) for path, leaf in
           jax.tree_util.tree_leaves_with_path(loaded)}
    assert sorted(got) == sorted(init)
    assert all(np.isfinite(v).all() for v in got.values())
    assert max(np.abs(got[k] - init[k]).max() for k in init) > 0
    for rc, _ in (r["cli tp dp"] for r in ranks["four"]):
        assert rc == ("--tp cannot be combined with --dp on this CLI (use "
                      "the DP×TP API on a 2-D data×model mesh)")
