"""The port's mnist_nn training path against the JAX package's: the matrix
core (``ops/matrix.py``), the softmaxes, ``dense`` and the losses with
their hand-written backwards (f64, against ``jax.vjp``), ``train_step`` and
a ragged epoch (f64 leaf by leaf, and one f32 step against the Pallas
kernel in interpret mode), the resident and per-batch epochs, the samplers
and readers, and the ``train`` CLI across packages."""

import importlib
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_linear_algebra_tpu.data import csv as jax_csv
from big_linear_algebra_tpu.data import mnist as jax_mnist
from big_linear_algebra_tpu.data import synth as jax_synth
from big_linear_algebra_tpu.models import mnist_nn as jax_nn
from big_linear_algebra_tpu.nn.dense import dense as jax_dense
from big_linear_algebra_tpu.nn import losses as jax_losses
from big_linear_algebra_tpu.ops import activations as jax_act
from big_linear_algebra_tpu.ops import matrix as jax_matrix
from big_linear_algebra_tpu_torch.data import csv as port_csv
from big_linear_algebra_tpu_torch.data import mnist as port_mnist
from big_linear_algebra_tpu_torch.models import mnist_nn
from big_linear_algebra_tpu_torch.nn import init as port_init
from big_linear_algebra_tpu_torch.nn import losses as port_losses
from big_linear_algebra_tpu_torch.ops import activations as port_act
from big_linear_algebra_tpu_torch.ops import matrix as port_matrix
from tests.torch_parity import n, t

# the package re-exports the function ``dense`` under the module's name
port_dense = importlib.import_module("big_linear_algebra_tpu_torch.nn.dense")


def _grads(fn, args, g):
    """Value and the gradients of ``fn`` w.r.t. every tensor arg that
    requires grad, for cotangent ``g``."""
    out = fn(*args)
    leaves = [a for a in args if isinstance(a, torch.Tensor)
              and a.requires_grad]
    return out, torch.autograd.grad(out, leaves, t(g))


# ---------------------------------------------------------------------------
# ops/matrix.py
# ---------------------------------------------------------------------------

_MATRIX_CASES = {
    "matrix_scale": lambda ops, a, b, c, r: ops.matrix_scale(a, 2.5),
    "matrix_add": lambda ops, a, b, c, r: ops.matrix_add(a, b),
    "matrix_multiply_elementwise":
        lambda ops, a, b, c, r: ops.matrix_multiply_elementwise(a, b),
    "matrix_transpose": lambda ops, a, b, c, r: ops.matrix_transpose(a),
    "matrix_row_sum": lambda ops, a, b, c, r: ops.matrix_row_sum(a),
    "matrix_col_sum": lambda ops, a, b, c, r: ops.matrix_col_sum(a),
    "frobenius_norm": lambda ops, a, b, c, r: ops.frobenius_norm(a),
    "max_value": lambda ops, a, b, c, r: ops.max_value(a),
    "matrix_z_score_normalize":
        lambda ops, a, b, c, r: ops.matrix_z_score_normalize(a),
    "matrix_add_tile_columns":
        lambda ops, a, b, c, r: ops.matrix_add_tile_columns(a, c),
    "matrix_add_tile_rows":
        lambda ops, a, b, c, r: ops.matrix_add_tile_rows(a, r),
}


@pytest.mark.parametrize("name", sorted(_MATRIX_CASES))
def test_matrix_op_f64_matches_jax(rng, name):
    """Every ``lib/matrix.h`` op on a non-square (5, 7) f64 matrix, against
    the JAX package's (1e-12); ``matrix_col_sum`` is the intended per-row
    sum (SURVEY.md §7.6), not the reference's ``i*rows+j``."""
    a, b = rng.standard_normal((5, 7)), rng.standard_normal((5, 7))
    c, r = rng.standard_normal((5, 1)), rng.standard_normal((1, 7))
    fn = _MATRIX_CASES[name]
    want = fn(jax_matrix, *(jnp.asarray(v) for v in (a, b, c, r)))
    got = fn(port_matrix, *(t(v) for v in (a, b, c, r)))
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(n(got), n(want), rtol=1e-12, atol=1e-12)
    if name == "matrix_col_sum":
        np.testing.assert_allclose(n(got)[:, 0], a.sum(axis=1), rtol=1e-12)


def test_matrix_shape_errors_and_print(rng, capsys):
    a = t(rng.standard_normal((3, 4)))
    for call, what in (
            (lambda: port_matrix.matrix_add(a, a.T), "matrix_add"),
            (lambda: port_matrix.matrix_multiply_elementwise(a, a[:2]),
             "matrix_multiply_elementwise"),
            (lambda: port_matrix.matrix_add_tile_columns(a, a[:, :1].T),
             "matrix_add_tile_columns"),
            (lambda: port_matrix.matrix_add_tile_rows(a, a[:, :1]),
             "matrix_add_tile_rows")):
        with pytest.raises(ValueError, match=what):
            call()
    m = rng.standard_normal((3, 4)).astype(np.float32)
    jax_matrix.print_matrix(jnp.asarray(m), "m")
    want = capsys.readouterr().out
    port_matrix.print_matrix(t(m), "m")
    assert capsys.readouterr().out == want and want.startswith("m (3x4):")


# ---------------------------------------------------------------------------
# ops/activations.py: softmax, softmax_row_wise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["softmax", "softmax_row_wise"])
def test_softmax_and_vjp_f64_match_jax(rng, name):
    """Forward and the full-Jacobian backward against ``jax.vjp`` (1e-12),
    with a column and a row offset by 1e3 (the max is subtracted)."""
    x = rng.standard_normal((6, 9)) * 3
    x[:, 2] += 1e3
    x[4] -= 1e3
    g = rng.standard_normal((6, 9))
    want, vjp = jax.vjp(getattr(jax_act, name), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = t(x).requires_grad_()
    got, (dx,) = _grads(getattr(port_act, name), (xt,), g)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(n(dx), n(want_dx), rtol=1e-12, atol=1e-12)
    axis = 0 if name == "softmax" else 1
    np.testing.assert_allclose(n(got).sum(axis=axis), 1.0, rtol=1e-12)


# ---------------------------------------------------------------------------
# nn/dense.py, nn/losses.py, nn/init.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("activation", [None, "relu"])
def test_dense_grads_f64_match_jax(rng, activation):
    """All three gradients of ``dense`` against ``jax.vjp`` of the JAX
    package's (1e-10), with two output columns whose pre-activations are
    exactly 0 (zero weights and bias: ReLU' is 0 there, as in JAX)."""
    x = rng.standard_normal((12, 9))
    w = rng.standard_normal((9, 5))
    b = rng.standard_normal((5,))
    w[:, [1, 3]] = 0.0
    b[[1, 3]] = 0.0
    g = rng.standard_normal((12, 5))
    want, vjp = jax.vjp(lambda *a: jax_dense(*a, activation),
                        *(jnp.asarray(v) for v in (x, w, b)))
    wants = vjp(jnp.asarray(g))
    args = [t(v).requires_grad_() for v in (x, w, b)]
    got, grads = _grads(lambda *a: port_dense.dense(*a, activation), args, g)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-10, atol=1e-10)
    for got_g, want_g in zip(grads, wants):
        np.testing.assert_allclose(n(got_g), n(want_g), rtol=1e-10,
                                   atol=1e-10)
    if activation == "relu":
        assert not n(got)[:, [1, 3]].any()
        assert not n(grads[2])[[1, 3]].any()


def test_dense_input_gradient_only_when_asked(rng, monkeypatch):
    """The input layer's x takes no gradient: the backward then runs only
    the weight-gradient GEMM (tn), not the data-gradient one (nt)."""
    seen = []
    real = port_dense._dispatch

    def record(a, b, variant, *rest, **kw):
        seen.append(variant)
        return real(a, b, variant, *rest, **kw)

    monkeypatch.setattr(port_dense, "_dispatch", record)
    x = t(rng.standard_normal((4, 6)))
    w, b = (t(rng.standard_normal(s)).requires_grad_() for s in ((6, 3),
                                                                  (3,)))
    port_dense.dense(x, w, b, "relu").sum().backward()
    assert seen == ["nn", "tn"] and w.grad is not None
    layer = port_dense.Dense(6, 3)
    assert layer.weight.requires_grad and layer.bias.requires_grad


def test_softmax_cross_entropy_seed_masked_f64(rng):
    """The loss and the reference's seed (p − onehot)·g, masked per
    example, against the JAX package's custom VJP; ``cross_entropy_loss``
    (a metric) against JAX's."""
    logits = rng.standard_normal((7, 10)) * 2
    onehot = np.eye(10)[rng.integers(0, 10, 7)]
    mask = np.array([1, 1, 0, 1, 1, 1, 0], np.float64)
    want, vjp = jax.vjp(lambda z: jax_losses.softmax_cross_entropy(
        z, jnp.asarray(onehot), jnp.asarray(mask)), jnp.asarray(logits))
    (want_dz,) = vjp(jnp.asarray(0.37))
    z = t(logits).requires_grad_()
    got, (dz,) = _grads(lambda z: port_losses.softmax_cross_entropy(
        z, t(onehot), t(mask)), (z,), 0.37)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-12)
    np.testing.assert_allclose(n(dz), n(want_dz), rtol=1e-12, atol=1e-12)
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    np.testing.assert_allclose(n(dz), (p - onehot) * 0.37 * mask[:, None],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        float(port_losses.cross_entropy_loss(t(p), t(onehot))),
        float(jax_losses.cross_entropy_loss(jnp.asarray(p),
                                            jnp.asarray(onehot))),
        rtol=1e-12)


def test_hinge_loss_subgradient_f64(rng):
    """The hinge loss and its subgradient −Σ_{margin<1} y·x (masked) against
    the JAX package's custom VJP, with margins on both sides of 1."""
    x = rng.standard_normal((16, 8))
    w = rng.standard_normal((8,)) * 0.5
    y = np.where(rng.random(16) < 0.5, -1.0, 1.0)
    mask = (rng.random(16) < 0.8).astype(np.float64)
    margins = y * (x @ w)
    assert (margins < 1).any() and (margins >= 1).any()
    want, vjp = jax.vjp(lambda w_: jax_losses.hinge_loss(
        w_, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)),
        jnp.asarray(w))
    (want_dw,) = vjp(jnp.asarray(1.5))
    wt = t(w).requires_grad_()
    got, (dw,) = _grads(lambda w_: port_losses.hinge_loss(
        w_, t(x), t(y), t(mask)), (wt,), 1.5)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-12)
    np.testing.assert_allclose(n(dw), n(want_dw), rtol=1e-12, atol=1e-12)
    viol = (margins < 1) * mask
    np.testing.assert_allclose(n(dw), -(viol * y) @ x * 1.5, rtol=1e-12,
                               atol=1e-12)


def test_uniform_init():
    a = port_init.uniform_init((300, 40), torch.Generator().manual_seed(3),
                               scale=0.2)
    again = port_init.uniform_init((300, 40),
                                   torch.Generator().manual_seed(3), 0.2)
    assert a.dtype == torch.float32 and torch.equal(a, again)
    assert a.abs().max() <= 0.1 and a.std() > 0.1 / 3 ** 0.5 * 0.9


# ---------------------------------------------------------------------------
# models/mnist_nn.py: the step and the epoch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    return {k: np.asarray(v) for k, v in
            jax_nn.init_params(jax.random.key(5)).items()}


def _jax(params):
    """Fresh JAX arrays: the JAX package's steps donate their params."""
    return {k: jnp.asarray(np.array(v)) for k, v in params.items()}


def _model(params, dtype=None):
    return mnist_nn.MnistNN.from_params(mnist_nn.params_from_jax(params),
                                        dtype=dtype)


def _assert_params(model, want, rtol_of_max, atol=0.0):
    got = model.params()
    assert sorted(got) == sorted(want)
    for k in want:
        scale = np.abs(n(want[k])).max()
        np.testing.assert_allclose(n(got[k]), n(want[k]), rtol=0,
                                   atol=atol + rtol_of_max * scale,
                                   err_msg=k)


def _batch(rng, b, masked=0):
    x = rng.random((b, 784))
    onehot = np.eye(10)[rng.integers(0, 10, size=b)]
    mask = np.ones(b)
    if masked:
        mask[-masked:] = 0.0
    return x, onehot, mask


def test_train_step_f64_matches_jax(rng, jax_params):
    """One SGD step on a masked batch of 64, f64: every parameter leaf
    (1e-10), the correct count and the CE sum against JAX's jitted step."""
    p64 = {k: v.astype(np.float64) for k, v in jax_params.items()}
    x, onehot, mask = _batch(rng, 64, masked=9)
    want, want_c, want_ce = jax_nn.train_step(
        _jax(p64), *(jnp.asarray(v) for v in (x, onehot, mask)))
    model = _model(p64)
    got_c, got_ce = mnist_nn.train_step(model, t(x), t(onehot), t(mask))
    _assert_params(model, want, 0.0, atol=1e-10)
    assert int(got_c) == int(want_c)
    np.testing.assert_allclose(float(got_ce), float(want_ce), rtol=1e-10)


def test_train_step_f32_matches_pallas_interpret(rng, jax_params):
    """One f32 step at batch 64: layers 1 and 2 and their backward GEMMs
    reach the Pallas kernel (interpret mode) in JAX and the plain K1 in the
    port; each leaf within 2e-4 of its max|ref|."""
    x, onehot, mask = (v.astype(np.float32) for v in _batch(rng, 64))
    want, _, _ = jax_nn.train_step(
        _jax(jax_params), *(jnp.asarray(v) for v in (x, onehot, mask)))
    model = _model(jax_params)
    mnist_nn.train_step(model, t(x), t(onehot), t(mask))
    assert model.params()["w1"].dtype == torch.float32
    _assert_params(model, want, 2e-4)


@pytest.mark.parametrize("form", ["resident", "stacked"])
def test_ragged_epoch_f64_matches_jax(rng, jax_params, form):
    """A ragged epoch, 200 examples at batch 64 (the last batch has 8
    examples and 56 masked rows), f64 from the same parameters and
    permutation: every leaf against JAX's ``epoch_step_resident`` (or
    ``epoch_step`` over pre-stacked batches) within 1e-10, the same correct
    count and CE sum."""
    p64 = {k: v.astype(np.float64) for k, v in jax_params.items()}
    x_raw = rng.integers(0, 256, (200, 784)).astype(np.float64)
    y = rng.integers(0, 10, 200).astype(np.float64)
    perm = mnist_nn.epoch_permutation(np.random.default_rng(7), 200, 64)
    assert perm.shape == (256,) and (perm < 0).sum() == 56
    model = _model(p64)
    if form == "resident":
        want, want_c, want_ce = jax_nn.epoch_step_resident(
            _jax(p64), jnp.asarray(x_raw), jnp.asarray(y),
            jnp.asarray(perm))
        got_c, got_ce = mnist_nn.epoch_step_resident(model, t(x_raw), t(y),
                                                     t(perm))
    else:
        batches = [mnist_nn._make_batch(x_raw[idx[idx >= 0]],
                                        y[idx[idx >= 0]], 64, 10)
                   for idx in perm.reshape(-1, 64)]
        xs, onehots, masks = (np.stack(v).astype(np.float64)
                              for v in zip(*batches))
        want, want_c, want_ce = jax_nn.epoch_step(
            _jax(p64), *(jnp.asarray(v) for v in (xs, onehots, masks)))
        got_c, got_ce = mnist_nn.epoch_step(model, t(xs), t(onehots),
                                            t(masks))
    _assert_params(model, want, 0.0, atol=1e-10)
    assert int(got_c) == int(want_c)
    np.testing.assert_allclose(float(got_ce), float(want_ce), rtol=1e-10)


def test_resident_and_per_batch_epochs_equal(rng, jax_params):
    """The port's two epoch forms from one permutation: the device-resident
    gather (clamped indices, / 255 after the gather) and host batches from
    ``epoch_batches`` + ``_make_batch`` (--per-batch) give equal f32
    parameters and the same metrics."""
    x_raw = rng.integers(0, 256, (150, 784)).astype(np.float32)
    y = rng.integers(0, 10, 150).astype(np.float32)
    data = port_mnist.MnistDataset(x=x_raw, y=y)
    resident = _model(jax_params)
    perm = mnist_nn.epoch_permutation(np.random.default_rng(3), 150, 64)
    c1, ce1 = mnist_nn.epoch_step_resident(resident, t(x_raw), t(y), t(perm))
    per_batch = _model(jax_params)
    c2 = ce2 = 0.0
    for xb, yb in data.epoch_batches(np.random.default_rng(3), 64):
        c, ce = mnist_nn.train_step(
            per_batch, *(t(v) for v in mnist_nn._make_batch(xb, yb, 64, 10)))
        c2, ce2 = c2 + float(c), ce2 + float(ce)
    for k, v in resident.params().items():
        assert torch.equal(v, per_batch.params()[k]), k
    assert float(c1) == c2
    np.testing.assert_allclose(float(ce1), ce2, rtol=1e-6)


def test_clip_matches_jax(rng):
    g = rng.standard_normal((6, 4))
    norm = np.sqrt((g * g).sum())
    for threshold in (float("inf"), norm * 2, norm / 3):
        np.testing.assert_allclose(
            n(mnist_nn._clip(t(g), threshold)),
            n(jax_nn._clip(jnp.asarray(g), threshold)), rtol=1e-12)


# ---------------------------------------------------------------------------
# data: the samplers, the stream, visualize_digit, count_num_lines
# ---------------------------------------------------------------------------


def test_samplers_match_jax(rng):
    x = rng.integers(0, 256, (37, 784)).astype(np.float32)
    y = rng.integers(0, 10, 37).astype(np.float32)
    ours = port_mnist.MnistDataset(x=x, y=y)
    theirs = jax_mnist.MnistDataset(x=x, y=y)
    for a, b in zip(ours.sample_with_replacement(np.random.default_rng(4),
                                                 16),
                    theirs.sample_with_replacement(np.random.default_rng(4),
                                                   16)):
        np.testing.assert_array_equal(a, b)
    for drop in (False, True):
        got = list(ours.epoch_batches(np.random.default_rng(5), 10, drop))
        want = list(theirs.epoch_batches(np.random.default_rng(5), 10, drop))
        assert len(got) == len(want) == (3 if drop else 4)
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_stream_visualize_and_count_lines_match_jax(tmp_path, rng):
    """A three-example MNIST CSV whose last value ends the file (no comma,
    no newline): both packages' streams read the same three examples,
    ``count_num_lines`` counts its two newlines (native and Python paths),
    and ``visualize_digit`` draws the same digit."""
    rows = np.concatenate([rng.integers(0, 10, (3, 1)),
                           rng.integers(0, 256, (3, 784))], axis=1)
    text = "\n".join(",".join(str(v) for v in r) for r in rows)
    path = tmp_path / "m.csv"
    path.write_text(text)
    with port_mnist.MnistCSVStream(str(path)) as stream:
        got = list(stream)
    want_stream = jax_mnist.MnistCSVStream(str(path))
    want = list(want_stream)
    want_stream.close()
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.stack(got), rows)
    assert port_csv.count_num_lines(str(path)) == 2
    assert jax_csv.count_num_lines(str(path)) == 2
    assert port_csv._native.count_lines(str(path)) in (None, 2)
    pixels = rows[1, 1:] / 255.0
    art = port_mnist.visualize_digit(pixels, label=float(rows[1, 0]))
    assert art == jax_mnist.visualize_digit(pixels, label=float(rows[1, 0]))
    assert len(art.splitlines()) == 31


# ---------------------------------------------------------------------------
# The CLI across packages
# ---------------------------------------------------------------------------


def _got_correct(out: str) -> int:
    return int(re.search(r"Got (\d+) correct", out).group(1))


def test_cli_port_train_then_jax_run(tmp_path, monkeypatch, capsys):
    """Port ``init`` → port ``train 1 --device=cpu --jsonl`` (JAX's metric
    keys) → JAX ``run`` on the port's CSVs counts what the port's ``run``
    counts; a second ``train`` resumes from the CSVs."""
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    jax_synth.ensure_mnist(str(tmp_path), train_n=256, test_n=64)
    assert mnist_nn.main(["init"]) == 0
    before = mnist_nn.load_params_csv()
    jsonl = tmp_path / "m.jsonl"
    assert mnist_nn.main(["train", "1", "--device=cpu",
                          f"--jsonl={jsonl}"]) == 0
    out = capsys.readouterr().out
    assert "avg_accuracy" in out and "no checkpoint" not in out
    (line,) = [json.loads(s) for s in jsonl.read_text().splitlines()]
    assert set(line) == {"epoch", "avg_accuracy", "avg_loss",
                         "epoch_seconds", "images_per_sec", "time"}
    assert line["epoch"] == 0 and np.isfinite(line["avg_loss"])
    after = mnist_nn.load_params_csv()
    assert not torch.equal(before["w1"], after["w1"])
    assert jax_nn.main(["run"]) == 0
    want = _got_correct(capsys.readouterr().out)
    assert mnist_nn.main(["run", "--device=cpu"]) == 0
    assert _got_correct(capsys.readouterr().out) == want
    assert mnist_nn.main(["train", "1", "--device=cpu", "--batch=32"]) == 0
    assert not torch.equal(after["w1"], mnist_nn.load_params_csv()["w1"])


def test_cli_both_packages_train_from_jax_init(tmp_path, monkeypatch,
                                               capsys):
    """JAX ``init``, then ``train 1`` by each package from copies of the
    same CSVs (f32; the permutation is numpy's from the same seed): each
    file within 2e-4 of its max|ref|; the port's ``--per-batch`` epoch
    writes the same CSVs as its resident epoch."""
    jax_synth.ensure_mnist(str(tmp_path / "jax"), train_n=256, test_n=64)
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path / "jax"))
    assert jax_nn.main(["init"]) == 0
    init = jax_nn.load_params_csv()
    dirs = {}
    for name in ("port", "per_batch"):
        jax_synth.ensure_mnist(str(tmp_path / name), train_n=256, test_n=64)
        jax_nn.save_params_csv(init, base=tmp_path / name / "mnist_nn")
        dirs[name] = tmp_path / name
    assert jax_nn.main(["train", "1"]) == 0
    monkeypatch.setenv("BLA_DATA_DIR", str(dirs["port"]))
    assert mnist_nn.main(["train", "1", "--device=cpu"]) == 0
    monkeypatch.setenv("BLA_DATA_DIR", str(dirs["per_batch"]))
    assert mnist_nn.main(["train", "1", "--device=cpu", "--per-batch"]) == 0
    capsys.readouterr()
    want = jax_nn.load_params_csv(base=tmp_path / "jax" / "mnist_nn")
    for k, v in mnist_nn.load_params_csv(
            base=dirs["port"] / "mnist_nn").items():
        scale = np.abs(n(want[k])).max()
        np.testing.assert_allclose(n(v), n(want[k]), rtol=0,
                                   atol=2e-4 * scale, err_msg=k)
        assert not np.array_equal(n(v), n(init[k]))
    for name in mnist_nn._LAYOUT:
        assert ((dirs["port"] / "mnist_nn" / name).read_bytes()
                == (dirs["per_batch"] / "mnist_nn" / name).read_bytes())
