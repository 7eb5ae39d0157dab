"""The port's cifar_unet training path against the JAX package's: one TINY
training step (the loss and every gradient leaf) in f64 at 32×32 with dense
attention, three Adam steps from the same start, the same gradient in f32
at 64×64 through the four flash sites (Pallas interpret mode in JAX, the
plain K2/K2c/K2d in the port), the train-mode forward's dropout, learning
in bf16, and the ``train``/``run`` CLI with its train state and CSV tree.
The DDPM draws are made by JAX and injected into the port."""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_linear_algebra_tpu.models import cifar_unet as jax_cu
from big_linear_algebra_tpu.nn import losses as jax_losses
from big_linear_algebra_tpu_torch.data import synth
from big_linear_algebra_tpu_torch.models import cifar_unet as cu
from big_linear_algebra_tpu_torch.nn import attention as at
from tests.torch_parity import n, t

CFG_F64 = dataclasses.replace(cu.TINY, compute_dtype="float64",
                              dropout_rate=0.0)
JAX_CFG_F64 = dataclasses.replace(jax_cu.TINY, compute_dtype="float64",
                                  dropout_rate=0.0)
CFG64 = dataclasses.replace(cu.TINY, image_size=64, dropout_rate=0.0)
JAX_CFG64 = dataclasses.replace(jax_cu.TINY, image_size=64, dropout_rate=0.0)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(jax.tree.map(n, tree))[0]


@pytest.fixture(scope="module")
def refs():
    """The JAX references, computed once: the f64 32×32 loss and gradient
    and three train steps (with each step's draws), and the f32 64×64
    gradient through the flash sites."""
    rng = np.random.default_rng(11)
    p32 = jax_cu.init_params(jax.random.key(0), jax_cu.TINY)
    p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), p32)
    x0 = rng.uniform(-1, 1, (2, 3, 32, 32))
    v_and_g = jax.jit(jax.value_and_grad(jax_cu.loss_fn), static_argnums=3)
    keys = jax.random.split(jax.random.key(1), 3)

    def draws(x, key, cfg):
        _, tt, noise, _ = jax_cu._ddpm_draws(jnp.asarray(x), key, cfg)
        return n(tt).astype(np.int64), n(noise)

    loss, grads = v_and_g(p64, jnp.asarray(x0), keys[0], JAX_CFG_F64)
    states = [(p64, jax_cu.adam_init(p64))]
    step_draws = []
    for key in keys:
        step_draws.append(draws(x0, key, JAX_CFG_F64))
        params, opt = jax.tree.map(jnp.copy, states[-1])
        params, opt, _ = jax_cu.train_step(params, opt, jnp.asarray(x0), key,
                                           JAX_CFG_F64)
        states.append((params, opt))
    x64 = rng.uniform(-1, 1, (1, 3, 64, 64)).astype(np.float32)
    p32c = jax.tree_util.tree_map_with_path(_condition, p32)
    loss64, grads64 = v_and_g(p32c, jnp.asarray(x64), keys[0], JAX_CFG64)
    draws64 = draws(x64, keys[0], JAX_CFG64)
    # the f64 truth at 64×64, on the same draws (JAX's f64 loss_fn would
    # draw its noise in f64, another noise)
    cfg = dataclasses.replace(JAX_CFG64, compute_dtype="float64")
    grads64_f64 = jax.jit(jax.grad(_jax_loss_on_draws), static_argnums=4)(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), p32c),
        jnp.asarray(x64, jnp.float64), jnp.asarray(draws64[0]),
        jnp.asarray(draws64[1]), cfg)
    return {"p32": jax.tree.map(np.asarray, p32), "x0": x0,
            "loss": float(loss), "grads": grads, "draws": step_draws,
            "states": states, "x64": x64, "loss64": float(loss64),
            "p32c": jax.tree.map(np.asarray, p32c), "grads64": grads64,
            "grads64_f64": grads64_f64, "draws64": draws64}


# At random weights the activations grow through the TINY net, so at 64×64
# the up_3 sites' scores span up to 1.7e5 within a row: the softmax is
# saturated and the backward through it cancels (ds = p·(dp − delta)), so
# JAX's own f32 gradient is 0.43 of max|ref| from f64 at up_3 attn_2's q.
# The q and k projections of every attention site scaled by 0.1 bring the
# widest row to 17 and JAX's f32 gradient within 1e-4 of f64 at every leaf.
QK_SCALE = 0.1


def _condition(path, a):
    keys = [getattr(k, "key", None) for k in path]
    attn = any(str(k).startswith("attn") for k in keys)
    return a * QK_SCALE if attn and keys[-1] in ("q", "k") else a


def _jax_loss_on_draws(params, x0, tt, noise, cfg):
    """The JAX package's ``loss_fn`` with its draws given (dropout off)."""
    ab = jax_cu.ddpm_schedule(cfg)[2][tt][:, None, None, None]
    xt = jnp.sqrt(ab) * x0 + jnp.sqrt(1.0 - ab) * noise
    pred = jax_cu.forward(params, xt, tt, cfg, train=False)
    return jax_losses.mse_loss(pred, noise) / np.prod(x0.shape)


@pytest.fixture
def jax_schedule(monkeypatch):
    """JAX's schedule in the port: the two packages' f32 linspace/cumprod
    differ in the last bit (test_ddpm_update_matches_jax_body holds them
    within 1e-6), which f64 gradient parity at 1e-9 would see."""
    sched = tuple(t(a) for a in jax_cu.ddpm_schedule(jax_cu.TINY))
    monkeypatch.setattr(cu, "ddpm_schedule", lambda cfg: sched)


def _grad(params, x0, draws, cfg):
    leaves = cu.tree_map(lambda p: p.clone().requires_grad_(), params)
    loss = cu.loss_fn(leaves, x0, t(draws[0]), t(draws[1]), cfg)
    flat = cu.tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(grads)
    return loss, cu.tree_map(lambda p: cu._zero_if_none(next(it), p), leaves)


def _assert_leaves_close(got, want, rtol_of_max):
    flat_got, flat_want = _leaves(got), _leaves(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= rtol_of_max * max(scale, 1e-300), \
            (path, np.abs(a - b).max(), scale)


def test_train_step_f64_matches_jax(refs, jax_schedule):
    """The loss and every gradient leaf of one TINY step (dense attention,
    dropout 0) within 1e-9 of each leaf's max|ref|."""
    params = cu.params_from_jax(jax.tree.map(
        lambda a: a.astype(np.float64), refs["p32"]))
    loss, grads = _grad(params, t(refs["x0"]), refs["draws"][0], CFG_F64)
    assert loss.dtype == torch.float64
    assert float(loss.detach()) == pytest.approx(refs["loss"], rel=1e-9)
    _assert_leaves_close(grads, refs["grads"], 1e-9)


def test_three_adam_steps_f64_match_jax(refs, jax_schedule):
    """Three train steps, each from the JAX package's state (parameters and
    moments through ``adam_state_from_jax``) on its draws. The moments
    within 1e-8 of each leaf's max|ref| (the gradient's f64 agreement at
    the t = 0 draw of the third step); the parameters within 1e-12 plus
    Adam's first-order response to those moment differences. Adam divides
    each element's step by that element's own gradient scale, so at an
    element whose gradient is near eps = 1e-8 a difference δ moves the
    parameter by up to lr·δ/eps: whole trajectories part there, and each
    step is held on its own."""
    lr, eps = CFG_F64.learn_rate, 1e-8
    for i, draws in enumerate(refs["draws"]):
        (jp0, jo0), (jp, jo) = refs["states"][i:i + 2]
        params, opt, _ = cu.train_step(
            cu.params_from_jax(jax.tree.map(np.asarray, jp0)),
            cu.adam_state_from_jax(jax.tree.map(np.asarray, jo0)),
            t(refs["x0"]), None, CFG_F64, draws=tuple(map(t, draws)))
        assert opt.step == int(jo.step) == i + 1
        assert params["mid"]["attn"]["q"].dtype == torch.float64
        _assert_leaves_close(opt.m, jo.m, 1e-8)
        _assert_leaves_close(opt.v, jo.v, 1e-8)
        bc1, bc2 = 1 - 0.9 ** (i + 1), 1 - 0.999 ** (i + 1)
        for (path, p), (_, pj), (_, m), (_, mj), (_, v), (_, vj) in zip(
                *map(_leaves, (params, jp, opt.m, jo.m, opt.v, jo.v))):
            den = np.sqrt(vj / bc2) + eps
            response = lr * (np.abs(m - mj) / bc1 / den + np.abs(mj) / bc1
                             * np.abs(np.sqrt(v / bc2) - np.sqrt(vj / bc2))
                             / den ** 2)
            excess = np.abs(p - pj) - (1e-12 + 2 * response)
            assert excess.max() <= 0, (i, path, np.abs(p - pj).max())


def test_train_step_64_f32_through_flash_matches_jax(refs, monkeypatch):
    """f32 at 64×64: the four resolution-2 sites take the flash path (the
    plain backward on the CPU). On the conditioned net (``QK_SCALE``), the
    loss and every gradient leaf within 2e-4 of its max|ref| of JAX's
    (Pallas interpret mode), the tolerance of the 64×64 forward parity; and
    every leaf within 2e-4 of its max|ref| of the f64 truth on the same
    draws."""
    sched = tuple(t(a) for a in jax_cu.ddpm_schedule(jax_cu.TINY))
    monkeypatch.setattr(cu, "ddpm_schedule", lambda cfg: sched)
    calls = []
    real = at._plain_flash_bwd
    monkeypatch.setattr(at, "_plain_flash_bwd",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    params = cu.params_from_jax(refs["p32c"])
    loss, grads = _grad(params, t(refs["x64"]), refs["draws64"], CFG64)
    assert calls == [(1, 1024, cu.TINY.key_dim)] * 4
    assert float(loss.detach()) == pytest.approx(refs["loss64"], rel=2e-4)
    _assert_leaves_close(grads, refs["grads64"], 2e-4)
    _assert_leaves_close(grads, refs["grads64_f64"], 2e-4)


def test_train_forward_dropout_is_seeded(refs, monkeypatch):
    """Train mode draws every block's mask from the generator: the same
    seed gives the same output, another seed another; about 10% of the
    surviving activations are dropped."""
    params = cu.params_from_jax(refs["p32"])
    x = t(refs["x0"], torch.float32)
    tt = torch.tensor([1, 6])
    dropped, seen = [], []
    real = cu.dropout

    def spy(h, rate, gen, deterministic=False):
        out = real(h, rate, gen, deterministic)
        if not deterministic:
            live = h != 0
            dropped.append(int((out[live] == 0).sum()))
            seen.append(int(live.sum()))
        return out

    monkeypatch.setattr(cu, "dropout", spy)
    with torch.no_grad():
        outs = [cu.forward(params, x, tt, cu.TINY,
                           torch.Generator().manual_seed(s), train=True)
                for s in (3, 3, 4)]
        eval_out = cu.forward(params, x, tt, cu.TINY)
    assert len(seen) == 3 * 18  # 18 resnet blocks per forward
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    assert not torch.equal(outs[0], eval_out)
    assert 0.08 < sum(dropped) / sum(seen) < 0.12


def test_bf16_train_step_learns(refs):
    """bf16 compute over f32 masters: training on one batch lowers the loss
    (the JAX package's learning test), and the masters stay f32. Each
    step draws its own t and noise, so one step's loss is noisy; the mean
    of the last 8 of 24 steps is held below the mean of the first 8."""
    cfg = dataclasses.replace(cu.TINY, compute_dtype="bfloat16")
    params = cu.params_from_jax(refs["p32"])
    opt = cu.adam_init(params)
    gen = torch.Generator().manual_seed(1)
    x = t(refs["x0"], torch.float32)
    losses = []
    for _ in range(24):
        params, opt, loss = cu.train_step(params, opt, x, gen, cfg)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-8:]) < np.mean(losses[:8])
    assert params["output_conv"].dtype == torch.float32
    assert opt.m["output_conv"].dtype == torch.float32


def test_denoise_psnr_improves_with_training(rng):
    """The JAX package's sample-quality gate (tests/test_cifar_unet.py):
    one-shot denoising PSNR on held-out images rises at every probed
    timestep after 96 TINY steps, by more than 0.5 dB on average."""
    cfg = cu.TINY
    params = cu.init_params(torch.Generator().manual_seed(0), cfg)
    data = t(np.repeat(np.repeat(rng.random((96, 3, 8, 8)) * 2 - 1, 4, 2),
                       4, 3), torch.float32)
    train, held = data[:64], data[64:]
    ts = (1, 4, 6)
    before = cu.denoise_psnr(params, held, torch.Generator().manual_seed(9),
                             cfg, ts)
    opt = cu.adam_init(params)
    gen = torch.Generator().manual_seed(3)
    for _ in range(96):
        idx = torch.randperm(64, generator=gen)[:cfg.batch_size]
        params, opt, _ = cu.train_step(params, opt, train[idx], gen, cfg)
    after = cu.denoise_psnr(params, held, torch.Generator().manual_seed(9),
                            cfg, ts)
    assert torch.isfinite(before).all() and torch.isfinite(after).all()
    assert (after > before).all(), (before, after)
    assert (after.mean() - before.mean()).item() > 0.5, (before, after)


def test_bf16_params_train_step_rounds_stochastically():
    cfg = dataclasses.replace(cu.TINY, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = cu.init_params(torch.Generator().manual_seed(0), cfg)
    opt = cu.adam_init(params)
    x = torch.rand(2, 3, 32, 32) * 2 - 1
    out = [cu.train_step(params, opt, x, torch.Generator().manual_seed(s),
                         cfg) for s in (5, 5)]
    assert out[0][0]["output_conv"].dtype == torch.bfloat16
    assert out[0][1].v["output_conv"].dtype == torch.float32
    assert torch.equal(out[0][0]["output_conv"], out[1][0]["output_conv"])


def test_cli_train_resume_run(tmp_path, monkeypatch, capsys):
    """init, train, train again (resumes: epoch 1, no epoch 0), run from the
    newer train state; --keep=1 leaves one step; the CSV tree the port's
    train writes loads in the JAX package."""
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    synth.ensure_cifar(str(tmp_path), per_batch=4)  # 20 examples
    assert cu.main(["init", "--tiny"]) == 0
    flags = ["--tiny", "--device=cpu", "--max-steps=3", "--keep=1",
             f"--jsonl={tmp_path / 'm.jsonl'}"]
    capsys.readouterr()
    assert cu.main(["train", "1", *flags]) == 0
    out = capsys.readouterr().out
    assert "epoch: 0\t" in out and "step: 3" in out
    assert cu.main(["train", "1", *flags]) == 0
    out = capsys.readouterr().out
    assert "resumed train state at step 3 (epoch 1)" in out
    assert "epoch: 1\t" in out and "epoch: 0\t" not in out
    state = tmp_path / "cifar_unet" / "train_state_torch"
    assert sorted(p.name for p in state.iterdir()) == ["step_6"]
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 2

    # %f keeps six decimals (5e-7), and the f32 parse adds half an ulp
    theirs = jax_cu.load_params_csv(jax_cu.TINY, tmp_path / "cifar_unet")
    saved = cu.ckpt_pytree.restore_pytree(state)["params"]
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        n(a), n(b), rtol=0, atol=5e-7 + 6e-8), theirs, saved)

    (tmp_path / "cifar_unet" / "output_conv.csv").unlink()
    assert cu.main(["run", "1", "--tiny", "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "sampling from train_state_torch step 6 (no CSV tree)" in out
    assert (tmp_path / "cifar_unet" / "samples" / "sample_0.bmp").is_file()


def test_cli_train_streamed_equals_resident(tmp_path, monkeypatch, capsys):
    """A set over the device budget streams through ``prefetch_to_device``
    in the same order as the resident copy: the same parameters after the
    same steps."""
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    synth.ensure_cifar(str(tmp_path), per_batch=4)
    streamed = []
    real = cu.prefetch_to_device
    monkeypatch.setattr(cu, "prefetch_to_device",
                        lambda *a: streamed.append(1) or real(*a))
    state = tmp_path / "cifar_unet" / "train_state_torch"
    params = {}
    for budget in (cu._RESIDENT_BYTES, 0):
        monkeypatch.setattr(cu, "_RESIDENT_BYTES", budget)
        assert cu.main(["init", "--tiny"]) == 0
        assert cu.main(["train", "1", "--tiny", "--device=cpu",
                        "--max-steps=3"]) == 0
        params[budget] = cu.ckpt_pytree.restore_pytree(state)["params"]
        shutil.rmtree(state)
    capsys.readouterr()
    assert streamed == [1]
    jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
                 *params.values())


def test_cli_train_flags(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    reasons = {"--prng=rbg": "Philox"}
    for flag, reason in reasons.items():
        assert cu.main(["train", "1", "--tiny", flag]) == 1, flag
        assert reason in capsys.readouterr().out, flag
    # the dispatch flags are train's (tests/test_torch_graphs.py runs them):
    # a bad value reaches train's own parsing
    for flag, match in (("--scan-steps=0", "must be >= 1"),
                        ("--scan-unroll=0", "must be positive"),
                        ("--host-loop=1", "takes no value"),
                        ("--max-steps=0", "must be >= 1"),
                        ("--keep=-1", "must be >= 0"),
                        ("--batch=0", "must be positive"),
                        ("--keep-best=1", "takes no value"),
                        ("--remat=1", "takes no value"),
                        ("--layout=NCWH", "must be NCHW or NHWC")):
        with pytest.raises(ValueError, match=match):
            cu.main(["train", "1", "--tiny", "--device=cpu", flag])
    synth.ensure_cifar(str(tmp_path), n_batches=5, per_batch=1)
    with pytest.raises(SystemExit, match="exceeds the dataset"):
        cu.main(["train", "1", "--tiny", "--device=cpu", "--batch=6"])
    # --tp is ported: one process is one device, which runs unsharded
    assert cu.main(["train", "1", "--tiny", "--device=cpu", "--tp",
                    "--max-steps=1"]) == 0
    assert "--tp: single device, running unsharded" in \
        capsys.readouterr().out
