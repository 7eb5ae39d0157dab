"""The port's Layer graph (``nn/layer_graph.py``) against the JAX package's
on the same numpy inputs: the forward, the cost, the hand-written SGD step
and the per-example training loop, in f64 (1e-12 for one step, 1e-10 for a
trajectory)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from big_linear_algebra_tpu.data.mnist import MnistCSVStream as JaxStream
from big_linear_algebra_tpu.data import synth as jax_synth
from big_linear_algebra_tpu.models import my_first_model as jax_mfm
from big_linear_algebra_tpu.nn import layer_graph as jax_lg
from big_linear_algebra_tpu_torch.models import mnist as port_mnist
from big_linear_algebra_tpu_torch.models import my_first_model as port_mfm
from big_linear_algebra_tpu_torch.nn import layer_graph as lg
from tests.torch_parity import n, t

STEP_TOL = 1e-12
TRAJECTORY_TOL = 1e-10


def _np_params(rng, sizes, w_scale=0.5, b_scale=0.1):
    return [(rng.standard_normal((o, i)) * w_scale,
             rng.standard_normal(o) * b_scale)
            for i, o in zip(sizes[:-1], sizes[1:])]


def _jax(np_params):
    return [(jnp.asarray(w), jnp.asarray(b)) for w, b in np_params]


def _assert_params(got, want, tol):
    assert len(got) == len(want)
    for (w, b), (jw, jb) in zip(got, want):
        np.testing.assert_allclose(n(w), n(jw), rtol=tol, atol=tol)
        np.testing.assert_allclose(n(b), n(jb), rtol=tol, atol=tol)


@pytest.mark.parametrize("sizes, acts", [
    *[((2, 3, 2), (a, a))
      for a in ("relu", "linear", "scale_0.1", "softmax_legacy")],
    ((3, 2), ("scale_0.1",)),                          # smoke's net
    ((20, 8, 8, 10), ("relu", "relu", "softmax_legacy")),  # narrow mnist
], ids=["relu", "linear", "scale_0.1", "softmax_legacy", "smoke",
        "mnist_narrow"])
def test_layer_graph_f64_matches_jax(rng, sizes, acts):
    """feed_forward (acts and raws), predict, predict_batch, cost, sgd_step
    and make_sgd_step in f64 against JAX at 1e-12."""
    npp = _np_params(rng, sizes)
    x = rng.standard_normal(sizes[0])
    y = rng.standard_normal(sizes[-1])
    xb = rng.standard_normal((5, sizes[0]))
    params, jparams = lg.params_from_jax(npp), _jax(npp)
    lr = 0.05

    acts_p, raws_p = lg.feed_forward(params, acts, t(x))
    acts_j, raws_j = jax_lg.feed_forward(jparams, acts, jnp.asarray(x))
    for got, want in zip(acts_p + raws_p, acts_j + raws_j):
        np.testing.assert_allclose(n(got), n(want), rtol=STEP_TOL,
                                   atol=STEP_TOL)
    np.testing.assert_allclose(
        n(lg.predict(params, acts, t(x))),
        n(jax_lg.predict(jparams, acts, jnp.asarray(x))), rtol=STEP_TOL,
        atol=STEP_TOL)
    np.testing.assert_allclose(
        n(lg.predict_batch(params, acts, t(xb))),
        n(jax_lg.predict_batch(jparams, acts, jnp.asarray(xb))),
        rtol=STEP_TOL, atol=STEP_TOL)
    np.testing.assert_allclose(
        n(lg.cost(params, acts, t(x), t(y))),
        n(jax_lg.cost(jparams, acts, jnp.asarray(x), jnp.asarray(y))),
        rtol=STEP_TOL, atol=STEP_TOL)
    want = jax_lg.sgd_step(jparams, acts, jnp.asarray(x), jnp.asarray(y), lr)
    _assert_params(lg.sgd_step(params, acts, t(x), t(y), lr), want,
                   STEP_TOL)
    _assert_params(lg.make_sgd_step(acts)(params, t(x), t(y), lr), want,
                   STEP_TOL)
    # the step is functional: the inputs are untouched
    _assert_params(params, jparams, 0.0)


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket)
        return func(*args, **(kwargs or {}))


def test_my_first_model_scan_f64_matches_jax(tmp_path, monkeypatch):
    """200 steps from the same CSVs (written by JAX's init) and the same
    numpy stream: parameters and costs at 1e-10. The loop reads no value
    back to the host (no ``_local_scalar_dense``)."""
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    jax_mfm.init()
    rng = np.random.default_rng(42)
    want_x = np.stack([jax_mfm._synth_example(rng, i)[0] for i in range(200)])
    xs, ys = port_mfm.synth_stream(200)
    np.testing.assert_array_equal(xs, want_x)
    jparams = [(w.astype(jnp.float64), b.astype(jnp.float64))
               for w, b in jax_mfm.load_params()]
    params = [(w.double(), b.double()) for w, b in port_mfm.load_params()]
    _assert_params(params, jparams, 0.0)
    want_p, want_c = jax_lg.make_sgd_scan(port_mfm.ACTS)(
        jparams, jnp.asarray(xs, jnp.float64), jnp.asarray(ys, jnp.float64),
        0.1)
    log = _OpLog()
    with log:
        got_p, got_c = lg.make_sgd_scan(port_mfm.ACTS)(
            params, t(xs).double(), t(ys).double(), 0.1)
    assert torch.ops.aten._local_scalar_dense not in log.ops
    _assert_params(got_p, want_p, TRAJECTORY_TOL)
    np.testing.assert_allclose(n(got_c), n(want_c), rtol=TRAJECTORY_TOL,
                               atol=TRAJECTORY_TOL)


def test_mnist_legacy_scan_narrow_f64_matches_jax(tmp_path, rng):
    """64 per-example steps of the legacy mnist stack at narrow width
    (784→24→16→10) on the streamed synthesized set, wrapping at EOF (32
    examples in the file), in f64: parameters and costs at 1e-10. The
    port's ``stream_examples`` equals the JAX train's staging loop."""
    train_csv, _ = jax_synth.ensure_mnist(str(tmp_path), train_n=32,
                                          test_n=8)
    xs, ys = port_mnist.stream_examples(train_csv, 64)
    stream = JaxStream(train_csv)
    for i in range(64):
        if not stream.get_next_data():
            stream.close()
            stream = JaxStream(train_csv)
            stream.get_next_data()
        np.testing.assert_array_equal(xs[i], stream.buffer[1:] / 255.0)
        assert ys[i].argmax() == int(stream.buffer[0]) and ys[i].sum() == 1
    stream.close()
    npp = [(rng.uniform(-0.05, 0.05, (o, i)), rng.uniform(-0.05, 0.05, o))
           for i, o in ((784, 24), (24, 16), (16, 10))]
    want_p, want_c = jax_lg.make_sgd_scan(port_mnist.ACTS)(
        _jax(npp), jnp.asarray(xs, jnp.float64), jnp.asarray(ys, jnp.float64),
        0.05)
    got_p, got_c = lg.make_sgd_scan(port_mnist.ACTS)(
        lg.params_from_jax(npp), t(xs).double(), t(ys).double(), 0.05)
    _assert_params(got_p, want_p, TRAJECTORY_TOL)
    np.testing.assert_allclose(n(got_c), n(want_c), rtol=TRAJECTORY_TOL,
                               atol=TRAJECTORY_TOL)
    assert float(n(got_c)[-1]) != float(n(got_c)[0])  # it trained


def test_sgd_step_equals_gradient_descent_for_relu(rng):
    """For exact-derivative activations, the reference recursion (lib/layer.c)
    equals plain gradient descent on the squared-error cost (autograd as
    the oracle)."""
    acts = ("relu", "relu")
    params = lg.params_from_jax(_np_params(rng, (4, 6, 3)))
    x, y = t(rng.standard_normal(4)), t(rng.standard_normal(3))
    lr = 0.05
    stepped = lg.sgd_step(params, acts, x, y, lr)
    leaves = [p.clone().requires_grad_() for pair in params for p in pair]
    pairs = list(zip(leaves[::2], leaves[1::2]))
    grads = torch.autograd.grad(lg.cost(pairs, acts, x, y), leaves)
    for (w_new, b_new), (w, b), gw, gb in zip(stepped, params, grads[::2],
                                              grads[1::2]):
        np.testing.assert_allclose(n(w_new), n(w - lr * gw), rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(n(b_new), n(b - lr * gb), rtol=1e-12,
                                   atol=1e-14)


def test_softmax_legacy_diagonal_jacobian(rng):
    """softmax_legacy's backward uses p(1−p) per element (the reference's
    deliberate independence approximation, model/mnist.c:37-46)."""
    (w, b), = _np_params(rng, (5, 4))
    x = rng.standard_normal(5)
    y = np.eye(4)[1]
    lr = 0.1
    raw = w @ x + b
    e = np.exp(raw - raw.max())
    p = e / e.sum()
    delta = (p * (1 - p)) * (2 * (p - y))
    (w_new, b_new), = lg.sgd_step(lg.params_from_jax([(w, b)]),
                                  ("softmax_legacy",), t(x), t(y), lr)
    np.testing.assert_allclose(n(w_new), w - lr * np.outer(delta, x),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(n(b_new), b - lr * delta, rtol=1e-12,
                               atol=1e-14)
