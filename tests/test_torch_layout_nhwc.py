"""The port's channels-last path (``--layout=NHWC``) and per-block recompute
(``--remat``) against the JAX package's and against the port's own plain
path.

- ``conv2d_nhwc`` (strides 1–3, three shapes), ``group_norm_nhwc`` (ragged
  groups, ``reference_compat``) and ``self_attention_block_nhwc`` against
  JAX's twins in f64, forward and VJP, at the JAX package's own tolerances
  (``tests/test_layout_nhwc.py``: 1e-12, 1e-12, 1e-10); each output
  contiguous, i.e. channels-last memory; ``conv2d_single`` and its VJP;
- the TINY U-Net's NHWC loss and gradient against JAX's NHWC (f64, dropout
  0, JAX's draws) at 1e-9 of each leaf's max|ref|; the port's NHWC step
  against its NCHW step with dropout on (the same masks);
- ``--remat`` bit-equal to the plain step (loss, parameters, moments and
  the generator's state after the step), in f64 and f32, NHWC and with
  ``--fused-block``;
- the CLI: ``train`` and ``run`` with ``--layout=NHWC`` and ``--remat``.

Each JAX reference is built once for the module, jitted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_linear_algebra_tpu.models import cifar_unet as jax_cu
from big_linear_algebra_tpu.nn import (
    conv2d_nhwc as jax_conv2d_nhwc,
    conv2d_single as jax_conv2d_single,
    group_norm_nhwc as jax_group_norm_nhwc,
    self_attention_block_nhwc as jax_attention_block_nhwc,
)
from big_linear_algebra_tpu_torch.models import cifar_unet as cu
from big_linear_algebra_tpu_torch.nn import attention as at
from big_linear_algebra_tpu_torch.nn import conv
from big_linear_algebra_tpu_torch.nn import fused_block
from big_linear_algebra_tpu_torch.nn import norm
from big_linear_algebra_tpu_torch.nn.optim import adam_init, tree_leaves
from tests.test_torch_unet_tp import _flat, assert_step_matches_jax
from tests.torch_parity import n, t

CONV_SHAPES = [(2, 5, 9, 7, 4, 3, 3), (1, 3, 8, 8, 6, 1, 1),
               (2, 4, 10, 6, 5, 3, 5)]  # b, c, h, w, f, kh, kw
GN_CASES = [(8, 4), (5, 2), (6, 8)]     # channels, group_size
CFG_F64 = dataclasses.replace(cu.TINY, compute_dtype="float64",
                              dropout_rate=0.0, layout="NHWC")
JAX_CFG_F64 = dataclasses.replace(jax_cu.TINY, compute_dtype="float64",
                                  dropout_rate=0.0, layout="NHWC")


def _vjp(fn, *static):
    """jit(x, g → (fn(x), vjp(g))) with ``static`` closed over."""
    def run(args, g):
        out, vjp = jax.vjp(lambda *a: fn(*a, *static), *args)
        return out, vjp(g)
    return jax.jit(run)


@pytest.fixture(scope="module")
def refs():
    """Every JAX reference of the module, computed once (jitted)."""
    rng = np.random.default_rng(16)
    out = {"conv": {}, "gn": {}}
    for shape in CONV_SHAPES:
        b, c, h, w, f, kh, kw = shape
        x = rng.standard_normal((b, h, w, c))
        k = rng.standard_normal((f, c, kh, kw))
        for stride in (1, 2, 3):
            g = rng.standard_normal((b, -(-h // stride), -(-w // stride), f))
            y, (dx, dk) = _vjp(jax_conv2d_nhwc, stride)(
                (jnp.asarray(x), jnp.asarray(k)), jnp.asarray(g))
            out["conv"][shape, stride] = (x, k, g, n(y), n(dx), n(dk))
    for (c, gs) in GN_CASES:
        x = rng.standard_normal((2, 5, 7, c))
        g = rng.standard_normal(x.shape)
        for compat in (False, True):
            y, (dx,) = _vjp(jax_group_norm_nhwc, gs, 1e-8, compat)(
                (jnp.asarray(x),), jnp.asarray(g))
            out["gn"][c, gs, compat] = (x, g, n(y), n(dx))
    b, c, h, w, kd = 2, 12, 4, 4, 4
    x = rng.standard_normal((b, h, w, c))
    params = {name: rng.standard_normal(s) for name, s in (
        ("q", (c, kd)), ("k", (c, kd)), ("v", (c, kd)), ("w", (kd, c)),
        ("b", (c,)))}
    g = rng.standard_normal(x.shape)
    y, (dx, dp) = _vjp(jax_attention_block_nhwc)(
        (jnp.asarray(x), jax.tree.map(jnp.asarray, params)), jnp.asarray(g))
    out["attn"] = (x, params, g, n(y), n(dx), jax.tree.map(n, dp))
    x = rng.standard_normal((5, 9, 8))
    k = rng.standard_normal((4, 5, 3, 3))
    g = rng.standard_normal((4, 5, 4))
    y, (dx, dk) = _vjp(jax_conv2d_single, 2)(
        (jnp.asarray(x), jnp.asarray(k)), jnp.asarray(g))
    out["single"] = (x, k, g, n(y), n(dx), n(dk))
    # the TINY U-Net, NHWC, f64, dropout 0, one gradient on JAX's draws:
    # the inputs of the NCHW parity test (test_torch_cifar_unet_train.py),
    # whose softmax rows are not saturated (where they are, f64 rounding
    # grows to several 1e-9 of max|ref| through the net in either layout)
    p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                       jax_cu.init_params(jax.random.key(0), jax_cu.TINY))
    x0 = np.random.default_rng(11).uniform(-1, 1, (2, 3, 32, 32))
    key = jax.random.split(jax.random.key(1), 3)[0]
    loss, grads = jax.jit(jax.value_and_grad(jax_cu.loss_fn),
                          static_argnums=3)(p64, jnp.asarray(x0), key,
                                            JAX_CFG_F64)
    _, tt, noise, _ = jax_cu._ddpm_draws(jnp.asarray(x0), key, JAX_CFG_F64)
    out["unet"] = {"params": jax.tree.map(np.asarray, p64), "x0": x0,
                   "draws": (n(tt).astype(np.int64), n(noise)),
                   "loss": float(loss), "grads": jax.tree.map(n, grads),
                   "schedule": tuple(np.asarray(a) for a in
                                     jax_cu.ddpm_schedule(JAX_CFG_F64))}
    return out


def _port_vjp(fn, inputs, g):
    """(fn(*inputs), gradients of <fn, g> w.r.t. each input) in the port."""
    leaves = [x.clone().requires_grad_() for x in inputs]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, g)


def _close(got, want, tol):
    np.testing.assert_allclose(n(got), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv2d_nhwc_matches_jax(refs, shape, stride):
    x, k, g, y, dx, dk = refs["conv"][shape, stride]
    out, (gx, gk) = _port_vjp(lambda a, b: conv.conv2d_nhwc(a, b, stride),
                              [t(x), t(k)], t(g))
    assert out.is_contiguous() and gx.is_contiguous()  # channels-last
    _close(out, y, 1e-12)
    _close(gx, dx, 1e-12)
    _close(gk, dk, 1e-12)


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("channels,group_size", GN_CASES)
def test_group_norm_nhwc_matches_jax(refs, channels, group_size, compat):
    x, g, y, dx = refs["gn"][channels, group_size, compat]
    out, (gx,) = _port_vjp(
        lambda a: norm.group_norm_nhwc(a, group_size,
                                       reference_compat=compat), [t(x)], t(g))
    assert out.is_contiguous()
    _close(out, y, 1e-12)
    _close(gx, dx, 1e-12)


def test_self_attention_block_nhwc_matches_jax(refs):
    x, params, g, y, dx, dp = refs["attn"]
    names = list(params)
    out, grads = _port_vjp(
        lambda a, *w: at.self_attention_block_nhwc(a, dict(zip(names, w))),
        [t(x)] + [t(params[k]) for k in names], t(g))
    _close(out, y, 1e-10)
    _close(grads[0], dx, 1e-10)
    for name, got in zip(names, grads[1:]):
        _close(got, dp[name], 1e-10)


def test_conv2d_single_matches_jax(refs):
    x, k, g, y, dx, dk = refs["single"]
    out, (gx, gk) = _port_vjp(lambda a, b: conv.conv2d_single(a, b, 2),
                              [t(x), t(k)], t(g))
    assert out.shape == y.shape == (4, 5, 4)
    _close(out, y, 1e-12)
    _close(gx, dx, 1e-12)
    _close(gk, dk, 1e-12)


def _assert_leaves_close(got, want, rtol_of_max):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, b in want.items():
        scale = max(np.abs(b).max(), 1e-300)
        assert np.abs(got[k] - b).max() <= rtol_of_max * scale, \
            (k, np.abs(got[k] - b).max(), scale)


def test_unet_nhwc_loss_and_grads_match_jax(refs, monkeypatch):
    """TINY, f64, dropout 0, JAX's draws and DDPM schedule: the NHWC loss
    and every gradient leaf within 1e-9 of JAX's NHWC (of each leaf's
    max|ref|)."""
    u = refs["unet"]
    sched = tuple(t(a) for a in u["schedule"])
    monkeypatch.setattr(cu, "ddpm_schedule", lambda cfg: sched)
    loss, grads = cu._loss_and_grads(cu.params_from_jax(u["params"]),
                                     t(u["x0"]), None, CFG_F64,
                                     tuple(map(t, u["draws"])))
    assert float(loss) == pytest.approx(u["loss"], rel=1e-9)
    _assert_leaves_close(grads, u["grads"], 1e-9)


def _tiny_params(dtype=torch.float64):
    p = cu.init_params(torch.Generator().manual_seed(0), cu.TINY)
    return cu.tree_map(lambda a: a.to(dtype), p)


def _step(cfg, params, x0, seed=3):
    """One ``train_step`` from the Adam init, its draws and masks from a
    generator of ``seed``: (params, opt_state, loss, generator state)."""
    gen = torch.Generator().manual_seed(seed)
    out = cu.train_step(params, adam_init(params), x0, gen, cfg)
    return (*out, gen.get_state())


def test_unet_nhwc_step_equals_nchw_step_with_dropout():
    """The port draws an NHWC map's dropout mask in the logical NCHW order,
    so with dropout on the NHWC step drops the same elements as the NCHW
    step: f64, the loss within 1e-10, both moments within 1e-9 of each
    leaf's max|ref| (the bound of the f64 parity with JAX: the layouts sum
    in other orders), the parameters within Adam's response to those
    (``assert_step_matches_jax``), the generator left in the same state."""
    cfg = dataclasses.replace(cu.TINY, compute_dtype="float64")
    assert cfg.dropout_rate > 0
    p = _tiny_params()
    x0 = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1,
                                                            (2, 3, 32, 32)))
    want = _step(cfg, p, x0)
    got = _step(dataclasses.replace(cfg, layout="NHWC"), p, x0)
    assert float(got[2]) == pytest.approx(float(want[2]), rel=1e-10)
    assert_step_matches_jax({"loss": float(got[2]), "params": got[0],
                             "m": got[1].m, "v": got[1].v},
                            want[0], want[1], want[2], moments_of_max=1e-9)
    assert torch.equal(got[3], want[3])


def _assert_bit_equal(got, want):
    assert torch.equal(got[2], want[2])
    for tree_got, tree_want in ((got[0], want[0]), (got[1].m, want[1].m),
                                (got[1].v, want[1].v)):
        for a, b in zip(tree_leaves(tree_got), tree_leaves(tree_want)):
            assert torch.equal(a, b)
    assert torch.equal(got[3], want[3])


@pytest.mark.parametrize("case", ["f64", "f32", "f64 nhwc", "f32 fused"])
def test_remat_step_bit_equal_to_plain_step(case, monkeypatch):
    """``--remat`` recomputes each resnet block in the backward, its
    dropout masks (and fused-block seeds) drawn once and handed back to
    the recompute: the step is bit-equal to the plain step,
    and the generator ends where the plain step leaves it. With
    ``--fused-block`` the fused blocks run (and rerun in the recompute)."""
    dtype = "float64" if case.startswith("f64") else "float32"
    cfg = dataclasses.replace(cu.TINY, compute_dtype=dtype,
                              layout="NHWC" if "nhwc" in case else "NCHW",
                              fused_block="fused" in case)
    fused = []
    real = fused_block.fused_resnet_block
    monkeypatch.setattr(fused_block, "fused_resnet_block",
                        lambda *a: fused.append(a[0].shape) or real(*a))
    p = _tiny_params(getattr(torch, dtype))
    x0 = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (2, 3, 32, 32))).to(getattr(torch, dtype))
    want = _step(cfg, p, x0)
    n_plain = len(fused)
    got = _step(dataclasses.replace(cfg, remat=True), p, x0)
    _assert_bit_equal(got, want)
    if "fused" in case:
        assert n_plain == 10 and len(fused) - n_plain == 2 * n_plain
    else:
        assert not fused


def test_remat_wraps_only_while_autograd_records(monkeypatch):
    """Sampling (inference mode) runs the plain blocks: no recompute."""
    calls = []
    monkeypatch.setattr(cu, "_recomputed",
                        lambda *a: calls.append(1) or cu._resnet_block_body(
                            *a[2:], a[1]))
    cfg = dataclasses.replace(cu.TINY, remat=True)
    gen = torch.Generator().manual_seed(0)
    cu.sample(_tiny_params(torch.float32), gen, cfg)
    assert not calls
    _step(cfg, _tiny_params(torch.float32), torch.zeros(2, 3, 32, 32))
    assert len(calls) == 18


def test_cfg_flags_layout_and_remat():
    cfg = cu._cfg_from_flags({"tiny": "", "layout": "nhwc", "remat": ""})
    assert cfg.layout == "NHWC" and cfg.remat
    cfg = cu._cfg_from_flags({"tiny": ""})
    assert cfg.layout == "NCHW" and not cfg.remat
    with pytest.raises(ValueError, match="NCHW or NHWC"):
        cu._cfg_from_flags({"layout": "NCWH"})
    with pytest.raises(ValueError, match="--remat takes no value"):
        cu._cfg_from_flags({"remat": "false"})


def test_cli_train_and_run_with_layout_and_remat(tmp_path, monkeypatch,
                                                 capsys):
    """``train 1 --layout=NHWC --remat`` and ``run --layout=NHWC`` on the
    CPU; ``train --remat`` writes the same train state, bit for bit, as
    the plain ``train``; ``--device=cuda`` without a card raises."""
    from big_linear_algebra_tpu_torch.data import synth

    states = {}
    for name, flags in (("plain", []), ("remat", ["--remat"]),
                        ("nhwc remat", ["--layout=NHWC", "--remat"])):
        monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path / name.replace(
            " ", "_")))
        synth.ensure_cifar(str(tmp_path / name.replace(" ", "_")),
                           n_batches=1, per_batch=8)
        assert cu.main(["init", "--tiny"]) == 0
        assert cu.main(["train", "1", "--tiny", "--device=cpu",
                        "--max-steps=2", *flags]) == 0
        states[name] = cu.ckpt_pytree.restore_pytree(cu.state_dir())
    assert "avg_loss" in capsys.readouterr().out
    plain, remat = ({"p": s["params"], "m": s["opt"]["m"],
                     "v": s["opt"]["v"], "rng": s["rng"]}
                    for s in (states["plain"], states["remat"]))
    for a, b in zip(tree_leaves(plain), tree_leaves(remat)):
        assert torch.equal(a, b)
    assert cu.main(["run", "1", "--tiny", "--device=cpu",
                    "--layout=NHWC"]) == 0
    assert "sample_0.bmp" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cu.main(["run", "1", "--tiny", "--layout=NHWC"])
