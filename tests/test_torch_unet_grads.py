"""The port's hand-written backwards, optimizer and training data against the
JAX package's: the layer VJPs in f64 (relu, group norm, the "same" conv,
the MSE loss, dense attention), the flash backward's plain version against
the Pallas backward in interpret mode, Adam and the stochastic rounding, the
CIFAR batches and their synthesis, the metrics logger and the port's train
state checkpoints. The CUDA kernels K2c/K2d run only on a card, where
chip_smoke.py holds them against the plain version."""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_linear_algebra_tpu.data import cifar10 as jax_cifar10
from big_linear_algebra_tpu.data import synth as jax_synth
from big_linear_algebra_tpu.models import common as jax_common
from big_linear_algebra_tpu.nn import conv as jax_conv
from big_linear_algebra_tpu.nn import losses as jax_losses
from big_linear_algebra_tpu.nn import norm as jax_norm
from big_linear_algebra_tpu.nn import optim as jax_optim
from big_linear_algebra_tpu.ops import activations as jax_act
from big_linear_algebra_tpu_torch.ckpt import pytree
from big_linear_algebra_tpu_torch.data import _native, cifar10, prefetch, synth
from big_linear_algebra_tpu_torch.models import cifar_unet as cu
from big_linear_algebra_tpu_torch.models import common
from big_linear_algebra_tpu_torch.nn import attention as at
from big_linear_algebra_tpu_torch.nn import conv, losses, norm, optim
from big_linear_algebra_tpu_torch.ops import activations
from tests.torch_parity import n, t

# the module: the JAX package's nn/__init__ re-exports a function of the
# same name, which shadows the attribute
jax_at = importlib.import_module("big_linear_algebra_tpu.nn.attention")

F64_RTOL_OF_MAX = 1e-10  # the f64 layer parity of the forwards


def _port_vjp(fn, inputs, g):
    """Gradients of ``fn(*inputs)`` against the cotangent ``g``, through
    the port's autograd Functions."""
    xs = [t(x).requires_grad_() for x in inputs]
    out = fn(*xs)
    return [n(d) for d in torch.autograd.grad(out, xs, t(g))]


def _jax_vjp(fn, inputs, g):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, inputs))
    return [n(d) for d in vjp(jnp.asarray(g, out.dtype))]


def _assert_close_of_max(got, want, tol):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), \
            (np.abs(a - b).max(), np.abs(b).max())


def test_relu_vjp_f64_matches_jax(rng):
    x = rng.standard_normal((3, 4, 5))
    x[0, 0, :2] = 0.0  # the subgradient at 0 is 0 on both sides
    g = rng.standard_normal(x.shape)
    got = _port_vjp(activations.relu, [x], g)
    want = _jax_vjp(jax_act.relu, [x], g)
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("shape,group,compat", [
    ((2, 8, 5, 6), 4, False),
    ((2, 8, 5, 6), 4, True),
    ((2, 3, 7, 7), 32, False),     # the U-Net's first block: one group of 3
    ((1, 12, 4, 3), 5, False),     # ragged: groups of 5, 5 and 2
    ((1, 12, 4, 3), 5, True),
])
def test_group_norm_vjp_f64_matches_jax(rng, shape, group, compat):
    x = rng.standard_normal(shape) * 3 + 1
    g = rng.standard_normal(shape)
    got = _port_vjp(lambda a: norm.group_norm(a, group,
                                              reference_compat=compat),
                    [x], g)
    want = _jax_vjp(lambda a: jax_norm.group_norm(a, group, 1e-8, compat),
                    [x], g)
    _assert_close_of_max(got, want, F64_RTOL_OF_MAX)


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("stride,k", [(1, 3), (2, 3), (1, 1), (2, 1)])
def test_conv2d_vjp_f64_matches_jax(rng, size, stride, k):
    """dx and dk, the asymmetric stride-2 pads (lo 0, hi 1 at even sizes)
    and the clamped dk of a 1×1 kernel at stride 2 included."""
    x = rng.standard_normal((2, 5, size, size))
    w = rng.standard_normal((6, 5, k, k))
    out = jax_conv.out_size(size, stride)
    g = rng.standard_normal((2, 6, out, out))
    got = _port_vjp(lambda a, b: conv.conv2d(a, b, stride), [x, w], g)
    want = _jax_vjp(lambda a, b: jax_conv.conv2d(a, b, stride), [x, w], g)
    _assert_close_of_max(got, want, F64_RTOL_OF_MAX)


def test_conv2d_dx_pads_match_jax():
    for in_size in range(1, 12):
        for k in (1, 3, 5):
            for s in (1, 2, 3):
                g_size = jax_conv.out_size(in_size, s)
                assert (conv._dx_pads(in_size, k, s, g_size)
                        == jax_conv._dx_pads(in_size, k, s, g_size))


@pytest.mark.parametrize("masked", [False, True])
def test_mse_loss_vjp_f64_matches_jax(rng, masked):
    pred, target = (rng.standard_normal((3, 2, 4, 4)) for _ in range(2))
    mask = np.array([1.0, 0.0, 0.5]) if masked else None
    g = np.asarray(1.7)

    def port(p, q):
        return losses.mse_loss(p, q, None if mask is None else t(mask))

    def ref(p, q):
        return jax_losses.mse_loss(p, q, None if mask is None
                                   else jnp.asarray(mask))

    assert n(port(t(pred), t(target))) == pytest.approx(
        float(n(ref(pred, target))), rel=1e-14)
    _assert_close_of_max(_port_vjp(port, [pred, target], g),
                         _jax_vjp(ref, [pred, target], g), F64_RTOL_OF_MAX)


@pytest.mark.parametrize("nq,nk", [(7, 7), (7, 9)])
def test_attention_dense_vjp_f64_matches_jax(rng, nq, nk):
    q = rng.standard_normal((2, nq, 5))
    k, v = (rng.standard_normal((2, nk, 5)) for _ in range(2))
    g = rng.standard_normal((2, nq, 5))
    _assert_close_of_max(_port_vjp(at.attention_dense, [q, k, v], g),
                         _jax_vjp(jax_at.attention_dense, [q, k, v], g),
                         F64_RTOL_OF_MAX)


@pytest.mark.parametrize("shape", [(1, 1024, 4), (2, 300, 16)])
def test_plain_flash_bwd_matches_pallas_interpret(rng, shape):
    """dq, dk, dv of the flash backward's plain version (through the
    autograd Function on CPU tensors) against the JAX package's flash VJP,
    which runs its streaming Pallas kernels (K2c/K2d) in interpret mode:
    the TINY U-Net's flash shape at 64×64, and a ragged one. f32, at the JAX
    tests' flash-backward tolerance (tests/test_attention.py)."""
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))
    want = _jax_vjp(jax_at.flash_attention, [q, k, v], g)
    got = _port_vjp(at.flash_attention, [q, k, v], g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=3e-5)
    # the same through the plain backward called directly
    o, lse = at._plain_flash(t(q), t(k), t(v))
    direct = at._plain_flash_bwd(t(q), t(k), t(v), o, lse, t(g))
    for a, b in zip(direct, got):
        np.testing.assert_array_equal(n(a), b)


def test_plain_flash_bwd_bf16_rounds_like_pallas(rng):
    """bf16: the plain backward rounds g, p and ds to bf16 where the Pallas
    kernels do, and agrees with them (interpret mode) to bf16 rounding; its
    scores are the forward's rounded ones, which differ from the Pallas
    kernels' by a bf16 step of q."""
    q, k, v, g = (rng.standard_normal((1, 256, 16)).astype(np.float32)
                  for _ in range(4))
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g)]
    _, vjp = jax.vjp(lambda *a: jax_at.flash_attention(*a, 128, 128),
                     *jb[:3])
    want = vjp(jb[3])
    tb = [t(a, torch.bfloat16) for a in (q, k, v, g)]
    o, lse = at._plain_flash(*tb[:3])
    got = at._plain_flash_bwd(*tb[:3], o, lse, tb[3])
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert np.abs(n(a) - n(b)).max() <= 2e-2 * np.abs(n(b)).max()


def test_plain_flash_bwd_bf16_stays_finite_at_large_scores(rng):
    """Scores of |s| ~ 1e5–1e6, as the full-width U-Net's up_3 sites reach
    at init: recomputed from the forward's rounded q, p never exceeds 1, so
    the bf16 gradient is finite, where the Pallas kernels' unrounded score
    overflows p and JAX's VJP is not finite; and dv = pᵀg matches the f64
    dense backward of the same bf16 inputs."""
    q, k, v, g = (rng.standard_normal((1, 256, 16)).astype(np.float32)
                  for _ in range(4))
    tb = [t(a, torch.bfloat16) for a in (q * 300, k * 300, v, g)]
    o, lse = at._plain_flash(*tb[:3])
    got = at._plain_flash_bwd(*tb[:3], o, lse, tb[3])
    assert all(bool(torch.isfinite(x).all()) for x in got)
    jb = [jnp.asarray(n(x), jnp.bfloat16) for x in tb]
    _, vjp = jax.vjp(lambda *a: jax_at.flash_attention(*a, 128, 128),
                     *jb[:3])
    assert not all(bool(jnp.isfinite(x).all()) for x in vjp(jb[3]))
    ref = _port_vjp(at.attention_dense, [n(x.double()) for x in tb[:3]],
                    n(tb[3].double()))
    dv = n(got[2].double())
    assert np.abs(dv - ref[2]).max() <= 2e-2 * np.abs(ref[2]).max()


def test_flash_bwd_kernel_wrapper_rejects_cpu_tensors(rng):
    """On anything but a CUDA tensor the backward kernels do not launch:
    the wrapper raises, and no launch is counted."""
    q = torch.zeros(1, 64, 16)
    lse = torch.zeros(1, 64)
    before = (at.bwd_dq_launch_count, at.bwd_dkv_launch_count)
    with pytest.raises(ValueError, match="CUDA device"):
        at._kernel_flash_bwd(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="head dims"):
        odd = torch.zeros(1, 64, 24)
        at._kernel_flash_bwd(odd, odd, odd, odd, lse, odd)
    assert (at.bwd_dq_launch_count, at.bwd_dkv_launch_count) == before


def _tree(rng, dtype):
    return {"conv": {"w": rng.standard_normal((4, 3, 3, 3)).astype(dtype)},
            "b": rng.standard_normal((5,)).astype(dtype),
            "attn": {"q": rng.standard_normal((6, 2)).astype(dtype)}}


def test_adam_f64_matches_jax_from_one_state(rng):
    """Both optimizers step from one state (after two JAX steps) on the
    same gradients, f64, three times."""
    p = _tree(rng, np.float64)
    jp = jax.tree.map(jnp.asarray, p)
    state = jax_optim.adam_init(jp)
    for _ in range(2):
        grads = jax.tree.map(jnp.asarray, _tree(rng, np.float64))
        jp, state = jax_optim.adam_update(jp, grads, state, 2e-4)
    ours_p = cu.params_from_jax(jax.tree.map(np.asarray, jp))
    ours = cu.adam_state_from_jax(jax.tree.map(np.asarray, state))
    assert ours.step == 2 and ours.m["b"].dtype == torch.float64
    for _ in range(3):
        g = _tree(rng, np.float64)
        jp, state = jax_optim.adam_update(jp, jax.tree.map(jnp.asarray, g),
                                          state, 2e-4)
        ours_p, ours = optim.adam_update(ours_p, cu.params_from_jax(g), ours,
                                         2e-4)
    assert ours.step == int(state.step) == 5
    for got, want in ((ours_p, jp), (ours.m, state.m), (ours.v, state.v)):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            n(a), n(b), rtol=0, atol=1e-12), got, want)


def test_adam_bf16_params_keep_f32_moments(rng):
    p = {"w": t(rng.standard_normal(64) * 0.05, torch.bfloat16)}
    g = {"w": t(rng.standard_normal(64) * 0.1, torch.bfloat16)}
    state = optim.adam_init(p)
    assert state.m["w"].dtype == torch.float32
    rn, _ = optim.adam_update(p, g, state, 1e-3)
    sr, st = optim.adam_update(p, g, state, 1e-3, sr_seed=12345)
    assert rn["w"].dtype == sr["w"].dtype == torch.bfloat16
    assert st.v["w"].dtype == torch.float32
    # stochastic rounding moves each value by at most one bf16 step
    step = torch.finfo(torch.bfloat16).eps * rn["w"].float().abs()
    assert ((sr["w"].float() - rn["w"].float()).abs() <= step * 1.01).all()
    f32 = {"w": p["w"].float()}
    a, _ = optim.adam_update(f32, g, optim.adam_init(f32), 1e-3)
    b, _ = optim.adam_update(f32, g, optim.adam_init(f32), 1e-3,
                             sr_seed=7)
    assert torch.equal(a["w"], b["w"])  # f32 leaves are untouched by it


@pytest.mark.parametrize("seed", [0, 7, 0x9E3779B9, 2 ** 32 - 1])
def test_stochastic_round_bf16_bit_equal_to_jax(rng, seed):
    x = np.concatenate([
        rng.standard_normal(1000) * 10.0 ** rng.integers(-6, 6, 1000),
        [0.0, -0.0, 1.0, 1.0 + 2.0 ** -9, -3.5, 6.1e4]]).astype(np.float32)
    x = x.reshape(2, -1)
    want = jax_optim.stochastic_round_bf16(jnp.asarray(x), jnp.uint32(seed))
    got = optim.stochastic_round_bf16(t(x), seed)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(want).view(np.int16))


def test_leaf_seeds_and_fmix32_match_jax():
    base = 0xDEADBEEF
    want = [int(jax_optim._fmix32(jnp.uint32(base)
                                  ^ jnp.uint32((0x9E3779B9 * i) & 0xFFFFFFFF)))
            for i in range(5)]
    assert [int(s) for s in optim.leaf_seeds(base, 5)] == want
    h = np.array([0, 1, 2 ** 31, 2 ** 32 - 1, 123456789], np.uint32)
    np.testing.assert_array_equal(
        optim._fmix32(torch.from_numpy(h.astype(np.int64))).numpy(),
        np.asarray(jax_optim._fmix32(jnp.asarray(h))).astype(np.int64))


def test_adam_bf16_seeds_follow_jax_leaf_order(rng):
    """Leaf i's dither seed goes to the i-th leaf in sorted key-path order,
    as ``jax.tree.flatten`` numbers them, whatever order the dict was
    built in (the U-Net's trees are built in network order)."""
    def tree():
        def leaf():
            return rng.standard_normal(257).astype(np.float32) * 0.05
        return {"time_w": leaf(), "time_b": leaf(),
                "up": {"resnet_1": leaf(), "attn_1": leaf()}}

    base = 0xDEADBEEF
    p, g = tree(), tree()
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    jg = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g)
    want, _ = jax_optim.adam_update(
        jp, jg, jax_optim.adam_init(jp), 1e-3,
        sr_key=jax.random.wrap_key_data(jnp.array([base, 0], jnp.uint32)))
    want = jax.tree.map(lambda a: np.asarray(a).view(np.int16), want)

    def port(keys, sub_keys):
        def build(x):
            out = {k: t(x[k], torch.bfloat16) for k in keys if k != "up"}
            out["up"] = {k: t(x["up"][k], torch.bfloat16) for k in sub_keys}
            return {k: out[k] for k in keys}
        tp = build(p)
        got, _ = optim.adam_update(tp, build(g), optim.adam_init(tp), 1e-3,
                                   sr_seed=base)
        assert list(got) == list(keys)  # the input's structure is kept
        assert list(got["up"]) == list(sub_keys)
        return got

    for keys, sub_keys in ((("time_w", "time_b", "up"),
                            ("resnet_1", "attn_1")),
                           (("time_b", "time_w", "up"),
                            ("attn_1", "resnet_1"))):
        got = port(keys, sub_keys)
        for path in (("time_w",), ("time_b",), ("up", "resnet_1"),
                     ("up", "attn_1")):
            a, b = got, want
            for k in path:
                a, b = a[k], b[k]
            np.testing.assert_array_equal(a.view(torch.int16).numpy(), b,
                                          err_msg=f"{keys} {path}")


def test_sgd_update():
    p = {"a": torch.ones(3), "b": {"c": torch.zeros(2)}}
    g = {"a": torch.full((3,), 2.0), "b": {"c": torch.ones(2)}}
    out = optim.sgd_update(p, g, 0.5)
    assert torch.equal(out["a"], torch.zeros(3))
    assert torch.equal(out["b"]["c"], torch.full((2,), -0.5))


def test_ensure_cifar_writes_the_jax_packages_bytes(tmp_path, capsys):
    ours = synth.ensure_cifar(str(tmp_path / "port"), n_batches=2,
                              per_batch=5)
    theirs = jax_synth.ensure_cifar(str(tmp_path / "jax"), n_batches=2,
                                    per_batch=5)
    assert "synthesized CIFAR batches" in capsys.readouterr().out
    for a, b in zip(ours, theirs):
        assert open(a, "rb").read() == open(b, "rb").read()
    # present files are never rewritten
    before = open(ours[0], "rb").read()
    assert synth.ensure_cifar(str(tmp_path / "port"), n_batches=2,
                              per_batch=9) == ours
    assert open(ours[0], "rb").read() == before


def test_cifar_batches_match_jax(tmp_path, monkeypatch):
    paths = jax_synth.ensure_cifar(str(tmp_path), n_batches=2, per_batch=7)
    for got, want in zip(cifar10.read_batch(paths[0]),
                         jax_cifar10.read_batch(paths[0])):
        np.testing.assert_array_equal(got, want)
    ours = cifar10.Cifar10Batches(paths)
    theirs = jax_cifar10.Cifar10Batches(paths)
    assert ours.num_examples == theirs.num_examples == 14
    for (la, xa), (lb, xb) in zip(
            ours.epoch_batches(np.random.default_rng(5), 4),
            theirs.epoch_batches(np.random.default_rng(5), 4)):
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(xa, xb)
    for got, want in zip(ours.sample(np.random.default_rng(6), 8),
                         theirs.sample(np.random.default_rng(6), 8)):
        np.testing.assert_array_equal(got, want)
    assert len(list(ours.epoch_batches(np.random.default_rng(5), 4))) == 3
    assert len(list(ours.epoch_batches(np.random.default_rng(5), 4,
                                       drop_remainder=False))) == 4
    # the pure-Python reader gives what the native one gives
    monkeypatch.setattr(_native, "cifar_read", lambda *a: None)
    for got, want in zip(cifar10.read_batch(paths[1]),
                         jax_cifar10.read_batch(paths[1])):
        np.testing.assert_array_equal(got, want)


def test_prefetch_to_device_keeps_order_and_values():
    items = [(np.full((2, 3), i, np.float32), np.arange(i + 1))
             for i in range(5)]
    out = list(prefetch.prefetch_to_device(iter(items), torch.device("cpu"),
                                           size=2))
    assert len(out) == 5
    for (a, b), (x, y) in zip(items, out):
        assert isinstance(x, torch.Tensor) and torch.equal(x, t(a))
        assert torch.equal(y, t(b))


def test_metrics_logger_matches_jax(tmp_path, capsys):
    metrics = dict(epoch=3, avg_loss=0.123456789, step=40)
    for logger_cls, name in ((common.MetricsLogger, "port"),
                             (jax_common.MetricsLogger, "jax")):
        log = logger_cls(str(tmp_path / f"{name}.jsonl"))
        log.log(**metrics)
        log.close()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == "epoch: 3\tavg_loss: 0.12346\tstep: 40"
    for name in ("port", "jax"):
        line = json.loads((tmp_path / f"{name}.jsonl").read_text())
        assert {k: line[k] for k in metrics} == metrics and "time" in line


def test_train_state_checkpoints(tmp_path):
    state = {"params": {"w": torch.arange(4.0)}, "epoch": 2,
             "rng": torch.Generator().manual_seed(3).get_state(),
             "param_dtype": "float32"}
    base = tmp_path / "train_state_torch"
    assert pytree.latest_step(base) is None
    (base / "step_9").mkdir(parents=True)  # an interrupted save
    for s in (1, 2, 3):
        pytree.save_pytree(base, s, dict(state, epoch=s))
    assert pytree.all_steps(base) == [1, 2, 3]
    back = pytree.restore_pytree(base)
    assert back["epoch"] == 3 and torch.equal(back["params"]["w"],
                                              state["params"]["w"])
    assert torch.equal(back["rng"], state["rng"])
    best = tmp_path / "best"
    mgr = pytree.TrainCheckpointer(best, max_to_keep=2, best_metric="loss")
    for s, loss in ((1, 0.5), (2, 0.2), (3, 0.9), (4, 0.3)):
        mgr.save(s, dict(state, epoch=s), metrics={"loss": loss})
    assert pytree.all_steps(best) == [2, 4] and pytree.latest_step(best) == 4
    assert pytree.restore_pytree(best, 2)["epoch"] == 2
    last = tmp_path / "last"
    mgr = pytree.TrainCheckpointer(last, max_to_keep=1)
    for s in (5, 6):
        mgr.save(s, state)
    assert pytree.all_steps(last) == [6]
    with pytest.raises(FileNotFoundError):
        pytree.restore_pytree(tmp_path / "empty")
