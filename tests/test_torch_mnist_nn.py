"""The port's mnist_nn serving path against the JAX package's: forward and
eval metrics on the same parameters and inputs, checkpoints read by either
package, the ``init``/``run`` CLI across packages, and an import of the port
with JAX blocked."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_linear_algebra_tpu.data import synth as jax_synth
from big_linear_algebra_tpu.models import mnist_nn as jax_nn
from big_linear_algebra_tpu_torch.models import mnist_nn
from tests.torch_parity import n, t

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_params():
    return {k: np.asarray(v) for k, v in
            jax_nn.init_params(jax.random.key(3)).items()}


def _batch(rng, b, masked=0):
    x = rng.random((b, 784))
    labels = rng.integers(0, 10, size=b)
    onehot = np.eye(10)[labels]
    mask = np.ones(b)
    if masked:
        mask[-masked:] = 0.0
    return x, onehot, mask


def test_forward_f64_matches_jax(rng, jax_params):
    p64 = {k: v.astype(np.float64) for k, v in jax_params.items()}
    x, _, _ = _batch(rng, 32)
    want = jax_nn.forward({k: jnp.asarray(v) for k, v in p64.items()},
                          jnp.asarray(x))
    model = mnist_nn.MnistNN.from_params(mnist_nn.params_from_jax(p64))
    with torch.inference_mode():
        got = model(t(x))
    assert got.dtype == torch.float64 and got.shape == (32, 10)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-10, atol=1e-10)


def test_forward_f32_matches_pallas_interpret(rng, jax_params):
    """Batch 64: the first two layers reach the Pallas kernel (interpret
    mode) in JAX and the plain K1 in the port."""
    x, _, _ = _batch(rng, 64)
    x = x.astype(np.float32)
    want = jax_nn.forward({k: jnp.asarray(v) for k, v in jax_params.items()},
                          jnp.asarray(x))
    model = mnist_nn.MnistNN.from_params(mnist_nn.params_from_jax(jax_params))
    with torch.inference_mode():
        got = model(t(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), rtol=2e-4, atol=2e-4)


def test_eval_metrics_f64_match_jax(rng, jax_params):
    p64 = {k: v.astype(np.float64) for k, v in jax_params.items()}
    x, onehot, mask = _batch(rng, 48, masked=5)
    want_c, want_ce = jax_nn.eval_batch(
        {k: jnp.asarray(v) for k, v in p64.items()}, jnp.asarray(x),
        jnp.asarray(onehot), jnp.asarray(mask))
    model = mnist_nn.MnistNN.from_params(mnist_nn.params_from_jax(p64))
    got_c, got_ce = mnist_nn.eval_batch(model, t(x), t(onehot), t(mask))
    assert int(got_c) == int(want_c)
    np.testing.assert_allclose(float(got_ce), float(want_ce), rtol=1e-9)


def test_make_batch_and_init_params(rng):
    xb = rng.integers(0, 256, size=(5, 784)).astype(np.float32)
    yb = rng.integers(0, 10, size=5).astype(np.float32)
    for ours, theirs in zip(mnist_nn._make_batch(xb, yb, 8, 10),
                            jax_nn._make_batch(xb, yb, 8, 10)):
        np.testing.assert_array_equal(ours, theirs)
    p = mnist_nn.init_params(torch.Generator().manual_seed(7))
    again = mnist_nn.init_params(torch.Generator().manual_seed(7))
    for i, (fan_in, fan_out) in enumerate([(784, 256), (256, 128),
                                           (128, 10)], start=1):
        w = p[f"w{i}"]
        assert w.shape == (fan_in, fan_out) and w.dtype == torch.float32
        assert w.abs().max() <= (6.0 / fan_in) ** 0.5
        assert w.std() > 0.5 * (2.0 / fan_in) ** 0.5  # U(±l) has std l/√3
        assert torch.equal(w, again[f"w{i}"])
        assert torch.count_nonzero(p[f"b{i}"]) == 0


def test_checkpoints_load_across_packages(tmp_path, jax_params):
    jax_nn.save_params_csv(jax_params, base=tmp_path / "jax")
    ours = mnist_nn.load_params_csv(base=tmp_path / "jax")
    port = mnist_nn.init_params(torch.Generator().manual_seed(1))
    mnist_nn.save_params_csv(port, base=tmp_path / "port")
    theirs = jax_nn.load_params_csv(base=tmp_path / "port")
    for k in jax_params:
        np.testing.assert_allclose(n(ours[k]), jax_params[k], atol=5e-7)
        np.testing.assert_allclose(n(theirs[k]), n(port[k]), atol=5e-7)
    mnist_nn.save_params_csv(ours, base=tmp_path / "again")
    for name in mnist_nn._LAYOUT:  # same bytes for the same values
        assert ((tmp_path / "again" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())


def _got_correct(out: str) -> int:
    return int(re.search(r"Got (\d+) correct", out).group(1))


def test_cli_across_packages(tmp_path, monkeypatch, capsys):
    """A checkpoint from either package's ``init``, evaluated by both
    packages' ``run``, gives the same correct count."""
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    jax_synth.ensure_mnist(str(tmp_path), train_n=16, test_n=64)
    for init in (jax_nn.main, mnist_nn.main):
        assert init(["init"]) == 0
        assert jax_nn.main(["run"]) == 0
        want = _got_correct(capsys.readouterr().out)
        assert mnist_nn.main(["run", "--device=cpu"]) == 0
        out = capsys.readouterr().out
        assert "Running predictions for 64 digits" in out
        assert _got_correct(out) == want


def test_cli_flags(tmp_path, monkeypatch, capsys):
    """Bad verbs and flags exit 1 with their reasons before any work;
    ``--batch``, ``--per-batch`` and ``--jsonl`` are accepted (train is
    ported; tests/test_torch_mnist_nn_train.py runs it), and so are
    ``--debug-nans`` and ``--disable-jit``, which take no value
    (tests/test_torch_debug.py runs them)."""
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    assert mnist_nn.main([]) == 1
    assert mnist_nn.main(["train"]) == 1
    assert "number of epochs" in capsys.readouterr().out
    assert mnist_nn.main(["train", "1", "--bogus"]) == 1
    # --dp and --scan-unroll are train's (tests/test_torch_graphs.py runs
    # the resident epoch's graph form)
    assert mnist_nn.main(["run", "--scan-unroll=2"]) == 1
    assert mnist_nn.main(["run", "--dp"]) == 1
    out = capsys.readouterr().out
    assert "data parallelism applies to train" in out
    assert "the train steps' dispatch applies to train" in out
    assert "Unrecognized flag" in out
    with pytest.raises(ValueError, match="must be positive"):
        mnist_nn.main(["train", "1", "--scan-unroll=0", "--device=cpu"])
    with pytest.raises(ValueError, match="takes no value"):
        mnist_nn.main(["train", "1", "--per-batch=1", "--device=cpu"])
    with pytest.raises(ValueError, match="must be positive"):
        mnist_nn.main(["train", "1", "--batch=0", "--device=cpu"])
    for flag in ("--debug-nans=1", "--disable-jit=yes"):
        with pytest.raises(ValueError, match="takes no value"):
            mnist_nn.main(["train", "1", flag, "--device=cpu"])
    assert not (tmp_path / "mnist").exists()  # rejected before any work
    with pytest.raises(ValueError, match="cuda or cpu"):
        mnist_nn.main(["run", "--device=tpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mnist_nn.main(["run"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mnist_nn.main(["train", "1"])


def test_port_imports_and_runs_without_jax():
    code = (
        "import importlib, pkgutil, sys; sys.modules['jax'] = None\n"
        "import torch\n"
        "import big_linear_algebra_tpu_torch as pkg\n"
        "for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(mod.name)\n"
        "from big_linear_algebra_tpu_torch.models import mnist_nn\n"
        "p = mnist_nn.init_params(torch.Generator().manual_seed(0))\n"
        "m = mnist_nn.MnistNN.from_params(p)\n"
        "with torch.inference_mode():\n"
        "    y = m(torch.rand(64, 784))\n"
        "assert y.shape == (64, 10) and torch.isfinite(y).all()\n"
        "from big_linear_algebra_tpu_torch.models import cifar_unet as cu\n"
        "cp = cu.init_params(torch.Generator().manual_seed(0), cu.TINY)\n"
        "with torch.inference_mode():\n"
        "    u = cu.forward(cp, torch.randn(1, 3, 32, 32), torch.tensor([3]),"
        " cu.TINY)\n"
        "assert u.shape == (1, 3, 32, 32) and torch.isfinite(u).all()\n"
        "assert not any(k == 'big_linear_algebra_tpu' or\n"
        "               k.startswith('big_linear_algebra_tpu.')\n"
        "               for k in sys.modules)\n"
        "print('ok')\n")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
