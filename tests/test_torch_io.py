"""The port's host IO against the JAX package's: CSV bytes and parsing,
checkpoints loaded across the two packages, synthesized MNIST files."""

import numpy as np
import pytest

from big_linear_algebra_tpu.data import csv as jax_csv
from big_linear_algebra_tpu.data import synth as jax_synth
from big_linear_algebra_tpu.data.mnist import MnistDataset as JaxMnistDataset
from big_linear_algebra_tpu_torch.data import _native
from big_linear_algebra_tpu_torch.data import csv as port_csv
from big_linear_algebra_tpu_torch.data import synth as port_synth
from big_linear_algebra_tpu_torch.data.mnist import MnistDataset
from big_linear_algebra_tpu_torch.ckpt import csv_layouts
import tests.torch_parity  # noqa: F401  (one torch thread)


@pytest.mark.parametrize("native", [True, False])
def test_csv_writer_bytes_identical(rng, tmp_path, monkeypatch, native):
    arr = (rng.standard_normal((7, 13)) * 100).astype(np.float32)
    arr[0, 0], arr[1, 1] = 0.0, -0.0
    jax_csv.write_csv_matrix(str(tmp_path / "jax.csv"), arr)
    if not native:  # the port's pure-Python writer
        monkeypatch.setattr(_native, "csv_write", lambda path, data: False)
    port_csv.write_csv_matrix(str(tmp_path / "port.csv"), arr)
    assert ((tmp_path / "port.csv").read_bytes()
            == (tmp_path / "jax.csv").read_bytes())


@pytest.mark.parametrize("native", [True, False])
def test_csv_reader_matches_jax(tmp_path, monkeypatch, native):
    """Trailing commas, empty tokens, CRLF, strtof prefixes and an
    EOF-terminated last value."""
    path = tmp_path / "odd.csv"
    path.write_text("1.5,,-2e3,\r\n3abc,inf,  7,\n.25,x,4")
    want = jax_csv.read_csv_values(str(path))
    if not native:
        monkeypatch.setattr(_native, "csv_read", lambda p: None)
    got = port_csv.read_csv_values(str(path))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        port_csv.read_csv_matrix(str(path), 2, 3),
        jax_csv.read_csv_matrix(str(path), 2, 3))
    with pytest.raises(ValueError, match="exactly"):
        port_csv.read_csv_matrix(str(path), 2, 3, exact=True)


def test_ensure_mnist_files_identical(tmp_path):
    j = jax_synth.ensure_mnist(str(tmp_path / "jax"), train_n=24, test_n=16)
    p = port_synth.ensure_mnist(str(tmp_path / "port"), train_n=24, test_n=16)
    for jp, pp in zip(j, p):
        with open(jp, "rb") as fj, open(pp, "rb") as fp:
            assert fj.read() == fp.read()
    ours, theirs = MnistDataset.from_csv(p[1]), JaxMnistDataset.from_csv(j[1])
    assert ours.num_examples == 16
    np.testing.assert_array_equal(ours.x, theirs.x)
    np.testing.assert_array_equal(ours.y, theirs.y)


def test_csv_layouts_roundtrip(rng, tmp_path):
    spec = {"a.csv": (3, 4), "sub/b.csv": (1, 5)}
    arrays = {name: rng.standard_normal(shape).astype(np.float32)
              for name, shape in spec.items()}
    assert not csv_layouts.layout_exists(str(tmp_path), spec)
    csv_layouts.save_matrices(str(tmp_path), arrays)
    assert csv_layouts.layout_exists(str(tmp_path), spec)
    back = csv_layouts.load_matrices(str(tmp_path), spec)
    for name in spec:
        np.testing.assert_allclose(back[name], arrays[name], atol=5e-7)
