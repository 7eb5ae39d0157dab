"""The port's legacy programs (my_first_model, legacy mnist, mnist_hinge,
smoke) against the JAX package's: the CLIs across packages on the CPU at
the JAX tests' sizes, mnist_hinge's chunk in f64, and the flags."""

import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_linear_algebra_tpu.data import synth as jax_synth
from big_linear_algebra_tpu.data.csv import write_csv_matrix
from big_linear_algebra_tpu.models import mnist as jax_mnist
from big_linear_algebra_tpu.models import mnist_hinge as jax_hinge
from big_linear_algebra_tpu.models import my_first_model as jax_mfm
from big_linear_algebra_tpu.models import smoke as jax_smoke
from big_linear_algebra_tpu_torch.models import mnist as port_mnist
from big_linear_algebra_tpu_torch.models import mnist_hinge as port_hinge
from big_linear_algebra_tpu_torch.models import my_first_model as port_mfm
from big_linear_algebra_tpu_torch.models import smoke as port_smoke
from tests.torch_parity import n, t

_NUM = re.compile(r"-?\d+(?:\.\d+)?")
# Printed numbers of two f32 runs: an integer is exact; a decimal may sit
# on the other side of a rounding boundary (one unit in its last place);
# past 3 decimals the f32 trajectories themselves may differ by a few
# parts in 1e5 (100 full-batch hinge iterations).
F32_PRINT_RTOL = 2e-5
# Trained leaves of the two packages' f32 runs, per leaf, of max|ref|.
F32_LEAF_RTOL = 1e-4


def assert_same_stdout(got: str, want: str) -> None:
    """Line by line: the text equal, the numbers as ``_NUM``'s rule."""
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert len(got_lines) == len(want_lines), (got, want)
    for g, w in zip(got_lines, want_lines):
        assert _NUM.sub("#", g) == _NUM.sub("#", w), (g, w)
        for a, b in zip(_NUM.findall(g), _NUM.findall(w)):
            if "." not in b:
                assert a == b, (g, w)
                continue
            places = len(b.split(".")[1])
            tol = 10.0 ** -places * 1.001
            if places > 3:
                tol += F32_PRINT_RTOL * abs(float(b))
            assert abs(float(a) - float(b)) <= tol, (g, w)


def _leaves(port_mod, program):
    if program == "mnist_hinge":
        return [port_mod.load_weights()]
    return [x for pair in port_mod.load_params() for x in pair]


# program: (JAX module, port module, (train_n, test_n) of the synthesized
# set or None, init argv, train argv, run argv). Legacy mnist starts from
# --he-init: from the reference's saturating init its per-example steps are
# chaotic, and two f32 runs part within a few dozen steps (the f64 runs are
# held to each other in tests/test_torch_layer_graph.py).
PROGRAMS = {
    "my_first_model": (jax_mfm, port_mfm, None, ["init"],
                       ["train", "200", "0.1"], ["run"]),
    "mnist": (jax_mnist, port_mnist, (64, 32), ["init", "--he-init"],
              ["train", "40", "0.05"], ["run", "10", "5"]),
    "mnist_hinge": (jax_hinge, port_hinge, (512, 128), ["init"],
                    ["train", "100", "0.0005"], ["run", "-1", "0"]),
}


@pytest.mark.parametrize("init_by", ["jax", "port"])
@pytest.mark.parametrize("program", list(PROGRAMS))
def test_cli_across_packages(tmp_path, monkeypatch, capsys, program,
                             init_by):
    """One package's ``init``; both packages ``train`` from it (the port on
    the CPU in f32), stdout equal and the trained leaves within f32
    tolerance; then the other package's ``run`` on the trained checkpoint
    (JAX init → port train → JAX run, or port init → JAX train → port run),
    stdout equal to the training package's own ``run``."""
    jax_mod, port_mod, sizes, init, train, run = PROGRAMS[program]
    jd, pd = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setenv("BLA_DATA_DIR", str(jd))
    if sizes:
        jax_synth.ensure_mnist(str(jd), *sizes)
    assert (jax_mod if init_by == "jax" else port_mod).main(init) == 0
    shutil.copytree(jd, pd)
    capsys.readouterr()
    assert jax_mod.main(train) == 0
    out_jax = capsys.readouterr().out
    monkeypatch.setenv("BLA_DATA_DIR", str(pd))
    assert port_mod.main([*train, "--device=cpu"]) == 0
    assert_same_stdout(capsys.readouterr().out, out_jax)
    assert "Finished training" in out_jax
    got = _leaves(port_mod, program)
    monkeypatch.setenv("BLA_DATA_DIR", str(jd))
    for g, w in zip(got, _leaves(port_mod, program)):
        assert float((g - w).abs().max()) <= (
            F32_LEAF_RTOL * float(w.abs().max())), program

    trained = pd if init_by == "jax" else jd
    monkeypatch.setenv("BLA_DATA_DIR", str(trained))
    assert jax_mod.main(run) == 0
    out_jax = capsys.readouterr().out
    assert port_mod.main([*run, "--device=cpu"]) == 0
    assert_same_stdout(capsys.readouterr().out, out_jax)


def _tiny_pixel_mnist(base):
    """An MNIST CSV pair whose examples hold one pixel of 1 (of 255): the
    hinge gradients are tiny, so training converges at iteration 0."""
    for name, count in (("mnist_train.csv", 16), ("mnist_test.csv", 8)):
        rows = np.zeros((count, 785), np.float32)
        rows[:, 0] = np.arange(count) % 10
        rows[:, 101] = 1.0
        write_csv_matrix(str(base / "mnist" / name), rows)


def test_mnist_hinge_convergence_prints_the_frozen_norms(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """Training that converges at iteration 0 of a chunk: the converging
    update lands, the chunk's later norms are computed on the frozen
    weights, and the port prints what JAX prints — the chunk's last row,
    which differs from the converging iteration's norms here."""
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    _tiny_pixel_mnist(tmp_path)
    assert jax_hinge.main(["init"]) == 0
    shutil.copytree(tmp_path / "mnist_hinge", tmp_path / "init")
    capsys.readouterr()
    assert jax_hinge.main(["train", "25", "5000"]) == 0
    out_jax = capsys.readouterr().out
    shutil.rmtree(tmp_path / "mnist_hinge")
    shutil.copytree(tmp_path / "init", tmp_path / "mnist_hinge")
    w0 = port_hinge.load_weights()
    assert port_hinge.main(["train", "25", "5000", "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert_same_stdout(out, out_jax)
    assert "Gradient norms after iteration 9:" in out
    assert "converged < epsilon after iteration 0" in out
    data = port_hinge.MnistDataset.from_csv(
        str(tmp_path / "mnist" / "mnist_train.csv"))
    x = t(data.x / 255.0)
    _, first = port_hinge.train_chunk(
        w0, x, port_hinge.signed_targets(t(data.y), x.dtype), 5000.0, 1)
    first_line = "".join(f"\tModel {j}: {v:.5f}\n"
                         for j, v in enumerate(n(first)[0]))
    assert first_line not in out


def test_hinge_chunk_f64_matches_jax(rng):
    """``train_chunk`` against JAX's ``_train_chunk`` in f64 at 1e-12: a
    chunk that does not converge, and one that converges at iteration 0
    (exactly one update lands; the later rows are the frozen weights'
    norms, all equal)."""
    cases = [
        (rng.uniform(0, 1, (64, 784)), rng.integers(0, 10, 64),
         rng.normal(0, 0.01, (784, 10)), 0.0005),
        (rng.normal(0, 0.0001, (1, 784)), np.array([3]),
         rng.normal(0, 0.01, (784, 10)), 0.5),
    ]
    for x, labels, w0, lr in cases:
        want_w, want_norms = jax_hinge._train_chunk(
            jnp.asarray(w0), jnp.asarray(x), jnp.asarray(labels, jnp.int32),
            lr, 10)
        xt = t(x)
        got_w, got_norms = port_hinge.train_chunk(
            port_hinge.weights_from_jax(w0), xt,
            port_hinge.signed_targets(t(labels), xt.dtype), lr, 10)
        np.testing.assert_allclose(n(got_w), n(want_w), rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(n(got_norms), n(want_norms), rtol=1e-12,
                                   atol=1e-14)
    # the converging case: one update, then frozen
    y = np.where(np.eye(10)[labels] > 0, 1.0, -1.0)
    g0 = -(x.T @ (((y * (x @ w0)) < 1.0) * y))
    np.testing.assert_allclose(n(got_w), w0 - lr * g0, rtol=1e-12,
                               atol=1e-14)
    assert n(got_norms)[0].sum() < port_hinge.EPSILON
    np.testing.assert_array_equal(n(got_norms)[1:],
                                  np.repeat(n(got_norms)[1:2], 9, axis=0))


def test_mnist_hinge_reference_scoring_and_bad_counts(tmp_path, monkeypatch,
                                                      capsys):
    """``run --reference-scoring`` prints what JAX prints on the same
    weights; ``run 0`` and ``run -2`` exit before any work."""
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    jax_synth.ensure_mnist(str(tmp_path), train_n=16, test_n=32)
    assert port_hinge.main(["init"]) == 0
    capsys.readouterr()
    assert jax_hinge.main(["run", "-1", "7", "--reference-scoring"]) == 0
    out_jax = capsys.readouterr().out
    assert port_hinge.main(["run", "-1", "7", "--reference-scoring",
                            "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert_same_stdout(out, out_jax)
    assert "Digit 6:" in out
    for bad in ("0", "-2"):
        with pytest.raises(SystemExit):
            port_hinge.main(["run", bad, "--device=cpu"])


def test_mnist_he_init_and_autoinit(tmp_path, monkeypatch, capsys):
    """``init --he-init``: He-uniform weights and zero biases; a ``train``
    on a fresh directory forwards the flag to its automatic init; the
    He-initialized Layer path learns (the JAX test's bar)."""
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    jax_synth.ensure_mnist(str(tmp_path), train_n=256, test_n=64)
    seen = {}
    real_init = port_mnist.init

    def spy(flags=None):
        seen["flags"] = flags
        return real_init(flags=flags)

    monkeypatch.setattr(port_mnist, "init", spy)
    assert port_mnist.main(["train", "600", "0.05", "0", "--he-init",
                            "--device=cpu"]) == 0
    assert "he-init" in seen["flags"]
    final = float(capsys.readouterr().out.split("Final batch avg:")[1]
                  .split()[0])
    assert final < 0.5
    assert port_mnist.main(["init", "--he-init"]) == 0
    for (w, b), ((rows, cols), _) in zip(port_mnist.load_params(),
                                         port_mnist.SHAPES):
        assert tuple(w.shape) == (rows, cols)
        assert float(w.abs().max()) <= (6.0 / cols) ** 0.5
        assert float(w.std()) > 0.5 * (2.0 / cols) ** 0.5
        assert not b.any()


def test_legacy_cli_flags(tmp_path, monkeypatch, capsys):
    """``--dp`` is rejected with JAX's own reasons (my_first_model, mnist)
    and, outside ``train``, by mnist_hinge (whose ``train --dp`` is data
    parallel), ``--jsonl`` as a flag these programs would ignore, and the
    base flags are accepted; all before any work."""
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    for jax_mod, port_mod in ((jax_mfm, port_mfm), (jax_mnist, port_mnist)):
        assert jax_mod.main(["train", "1", "0.1", "--dp"]) == 1
        want = capsys.readouterr().out
        assert port_mod.main(["train", "1", "0.1", "--dp"]) == 1
        assert capsys.readouterr().out == want
    assert port_hinge.main(["run", "--dp"]) == 1
    assert "data parallelism applies to train" in capsys.readouterr().out
    for port_mod in (port_mfm, port_mnist, port_hinge):
        assert port_mod.main(["train", "1", "0.1", "--jsonl=x"]) == 1
        assert "logs no metrics" in capsys.readouterr().out
        assert port_mod.main(["train", "1", "0.1", "--bogus"]) == 1
        assert "Unrecognized flag --bogus" in capsys.readouterr().out
    assert not any(tmp_path.iterdir())
    assert port_mfm.main(["init", "--debug-nans", "--disable-jit"]) == 0
    assert port_mfm.main(["train", "40", "0.1", "--device=cpu",
                          "--debug-nans", "--disable-jit"]) == 0
    assert "Finished training" in capsys.readouterr().out
    if not torch.cuda.is_available():
        for port_mod in (port_mfm, port_mnist, port_hinge):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                port_mod.main(["run"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_smoke.main([])


def test_smoke_prints_what_jax_prints(tmp_path, monkeypatch, capsys):
    """The same fixtures (generated once by JAX's numpy stream, then read by
    both): the 3×3 product and the one-layer net before and after one step,
    printed to 6 decimals, within 1e-6 (one unit in the last place)."""
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    assert jax_smoke.main([]) == 0
    out_jax = capsys.readouterr().out
    assert port_smoke.main(["--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert_same_stdout(out, out_jax)
    assert "output after one step (2x1):" in out
    shutil.rmtree(tmp_path)
    tmp_path.mkdir()
    assert port_smoke.main(["--device=cpu", "--debug-nans"]) == 0
    assert_same_stdout(capsys.readouterr().out, out_jax)  # same fixtures
    assert port_smoke.main(["extra"]) == 1
    assert port_smoke.main(["--jsonl"]) == 1
