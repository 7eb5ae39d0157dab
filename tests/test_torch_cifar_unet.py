"""The port's cifar_unet serving path against the JAX package's: the whole
U-Net forward at TINY (32×32 in f64 with dense attention, 64×64 in f32 where
the four resolution-2 attention sites take the flash path — Pallas interpret
mode in JAX, the plain K2 in the port), the sampler's update, the CSV tree
read by either package, and the ``init``/``run`` CLI."""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_linear_algebra_tpu.data import bmp as jax_bmp
from big_linear_algebra_tpu.data import cifar10 as jax_cifar10
from big_linear_algebra_tpu.models import cifar_unet as jax_cu
from big_linear_algebra_tpu_torch.data import _native, bmp, cifar10
from big_linear_algebra_tpu_torch.models import cifar_unet as cu
from big_linear_algebra_tpu_torch.nn import attention as at
from tests.torch_parity import n, t

CFG64 = dataclasses.replace(cu.TINY, image_size=64)
JAX_CFG64 = dataclasses.replace(jax_cu.TINY, image_size=64)
# The JAX forward as one jitted computation: op by op, the two forwards of
# ``refs`` took 26 s of compiling on the CPU, jitted 5 s.
JAX_FORWARD = jax.jit(jax_cu.forward, static_argnums=3)


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray,
                        jax_cu.init_params(jax.random.key(0), jax_cu.TINY))


@pytest.fixture(scope="module")
def refs(jax_params):
    """JAX forwards, computed once: 32×32 f64 and 64×64 f32 (the flash
    sites in Pallas interpret mode)."""
    rng = np.random.default_rng(7)
    x32 = rng.standard_normal((2, 3, 32, 32))
    x64 = rng.standard_normal((1, 3, 64, 64)).astype(np.float32)
    t32, t64 = np.array([0, 5]), np.array([3])
    p = jax.tree.map(jnp.asarray, jax_params)
    f64 = JAX_FORWARD(p, jnp.asarray(x32), jnp.asarray(t32),
                      dataclasses.replace(jax_cu.TINY,
                                          compute_dtype="float64"))
    f32 = JAX_FORWARD(p, jnp.asarray(x64), jnp.asarray(t64), JAX_CFG64)
    return {"x32": x32, "t32": t32, "f64": n(f64),
            "x64": x64, "t64": t64, "f32": n(f32)}


def _rel_err(got, want):
    return np.abs(n(got) - want).max() / np.abs(want).max()


def test_forward_32_f64_matches_jax(jax_params, refs):
    cfg = dataclasses.replace(cu.TINY, compute_dtype="float64")
    with torch.inference_mode():
        got = cu.forward(cu.params_from_jax(jax_params), t(refs["x32"]),
                         t(refs["t32"]), cfg)
    assert got.dtype == torch.float64 and got.shape == (2, 3, 32, 32)
    assert _rel_err(got, refs["f64"]) <= 1e-9


def test_forward_64_f32_runs_flash_and_matches_jax(jax_params, refs,
                                                   monkeypatch):
    calls = []
    real = at.flash_attention
    monkeypatch.setattr(at, "flash_attention",
                        lambda q, k, v: calls.append(q.shape) or real(q, k, v))
    with torch.inference_mode():
        got = cu.forward(cu.params_from_jax(jax_params), t(refs["x64"]),
                         t(refs["t64"]), CFG64)
    assert got.dtype == torch.float32 and got.shape == (1, 3, 64, 64)
    # down_2 attn_1/attn_2 and up_3 attn_1/attn_2; mid (8×8) stays dense
    assert calls == [(1, 1024, cu.TINY.key_dim)] * 4
    assert _rel_err(got, refs["f32"]) <= 2e-4


def test_time_embedding_matches_jax():
    steps = np.array([0, 1, 7, 500, 999])
    for dt in ("float32", "float64"):
        cfg = dataclasses.replace(cu.CONFIG, compute_dtype=dt)
        jcfg = dataclasses.replace(jax_cu.CONFIG, compute_dtype=dt)
        want = jax_cu.time_embedding(jnp.asarray(steps), jcfg)
        got = cu.time_embedding(t(steps), cfg)
        assert got.dtype == getattr(torch, dt) and got.shape == (5, 512)
        tol = 1e-12 if dt == "float64" else 2e-4
        np.testing.assert_allclose(n(got), n(want), rtol=tol, atol=tol)


def test_ddpm_update_matches_jax_body(rng):
    """The sampler's step with injected ε and z against the JAX loop body's
    formula (models/cifar_unet.py sample, :1106-1111) on JAX's schedule."""
    cfg = cu.CONFIG
    betas, alphas, alpha_bars = (np.asarray(a) for a in
                                 jax_cu.ddpm_schedule(jax_cu.CONFIG))
    for a, b in zip(cu.ddpm_schedule(cfg), (betas, alphas, alpha_bars)):
        np.testing.assert_allclose(n(a), b, rtol=1e-6, atol=0)
    schedule = cu.ddpm_schedule(cfg)
    shape = (2, 3, 8, 8)
    for step in (999, 500, 1, 0):
        x, eps, z = (rng.standard_normal(shape).astype(np.float32)
                     for _ in range(3))
        beta, alpha, ab = betas[step], alphas[step], alpha_bars[step]
        mean = (jnp.asarray(x) - beta / jnp.sqrt(1.0 - ab)
                * jnp.asarray(eps)) / jnp.sqrt(alpha)
        want = jnp.where(step > 0, mean + jnp.sqrt(beta) * jnp.asarray(z),
                         mean)
        got = cu.ddpm_update(t(x), t(eps), step, t(z), schedule)
        np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=1e-6)


def test_sample_tiny_is_seeded_and_in_range():
    params = cu.init_params(torch.Generator().manual_seed(0), cu.TINY)
    imgs = [cu.sample(params, torch.Generator().manual_seed(5), cu.TINY, 2)
            for _ in range(2)]
    assert imgs[0].shape == (2, 3, 32, 32) and imgs[0].dtype == torch.float32
    assert torch.equal(imgs[0], imgs[1])
    assert imgs[0].abs().max() <= 1.0 and imgs[0].std() > 0.1


def test_init_params_tree_matches_jax(jax_params):
    ours = cu.init_params(torch.Generator().manual_seed(1), cu.TINY)
    flat_jax = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    flat_ours = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, ours))[0]
    assert [p for p, _ in flat_ours] == [p for p, _ in flat_jax]
    for (path, a), (_, b) in zip(flat_ours, flat_jax):
        assert a.shape == b.shape and a.dtype == np.float32, path
        if b.std() == 0:  # biases
            assert not a.any(), path
        else:  # the same uniform bound
            assert np.abs(a).max() <= np.abs(b).max() * 1.5, path
    bf16 = cu.cast_params(ours, dataclasses.replace(cu.TINY,
                                                    param_dtype="bfloat16"))
    assert bf16["mid"]["attn"]["q"].dtype == torch.bfloat16


def test_csv_trees_load_across_packages(tmp_path, monkeypatch, jax_params,
                                        refs):
    """A tree from JAX ``init --tiny`` loads in the port and gives the same
    forward; the port's ``init --tiny`` tree loads in JAX, and writing it
    again gives the same bytes."""
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path / "jax"))
    assert jax_cu.main(["init", "--tiny"]) == 0
    base = tmp_path / "jax" / "cifar_unet"
    ours = cu.load_params_csv(cu.TINY, base)
    theirs = jax_cu.load_params_csv(jax_cu.TINY, base)
    cfg = dataclasses.replace(cu.TINY, compute_dtype="float64")
    with torch.inference_mode():
        got = cu.forward(ours, t(refs["x32"]), t(refs["t32"]), cfg)
    want = JAX_FORWARD(theirs, jnp.asarray(refs["x32"]),
                       jnp.asarray(refs["t32"]),
                       dataclasses.replace(jax_cu.TINY,
                                           compute_dtype="float64"))
    assert _rel_err(got, n(want)) <= 1e-9

    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path / "port"))
    assert cu.main(["init", "--tiny"]) == 0
    base = tmp_path / "port" / "cifar_unet"
    theirs = jax.tree.map(np.asarray, jax_cu.load_params_csv(jax_cu.TINY,
                                                             base))
    ours = cu.load_params_csv(cu.TINY, base)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(n(a), b),
                 ours, theirs)
    jax_cu.save_params_csv(theirs, jax_cu.TINY, tmp_path / "again")
    files = sorted(p.relative_to(base) for p in base.rglob("*.csv"))
    assert len(files) == len(cu._csv_tree(ours))
    for rel in files:
        assert (tmp_path / "again" / rel).read_bytes() == \
            (base / rel).read_bytes(), rel
    with pytest.raises(ValueError, match="different model configuration"):
        cu.load_params_csv(dataclasses.replace(cu.TINY, key_dim=2), base)


def test_cli_run_writes_the_jax_packages_bmp(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    assert cu.main(["init", "--tiny"]) == 0
    assert cu.main(["run", "1", "--tiny", "--image-size=64", "--device=cpu",
                    "--sample-seed=3", "--layout=NCHW"]) == 0
    path = tmp_path / "cifar_unet" / "samples" / "sample_0.bmp"
    assert f"wrote {path}" in capsys.readouterr().out
    r, g, b = bmp.read_bmp(str(path))
    assert r.shape == (64, 64) and len({r.min(), r.max()}) == 2
    jax_bmp.write_bmp(str(tmp_path / "jax.bmp"), r, g, b)
    assert (tmp_path / "jax.bmp").read_bytes() == path.read_bytes()


def test_bmp_and_pixel_conversions_match_jax(tmp_path, rng, monkeypatch):
    planes = [rng.integers(0, 256, (5, 7), dtype=np.uint8) for _ in range(3)]
    jax_bmp.write_bmp(str(tmp_path / "jax.bmp"), *planes)
    bmp.write_bmp(str(tmp_path / "native.bmp"), *planes)
    monkeypatch.setattr(_native, "bmp_write", lambda *a: False)
    bmp.write_bmp(str(tmp_path / "python.bmp"), *planes)
    want = (tmp_path / "jax.bmp").read_bytes()
    assert (tmp_path / "native.bmp").read_bytes() == want
    assert (tmp_path / "python.bmp").read_bytes() == want
    for got, plane in zip(bmp.read_bmp(str(tmp_path / "python.bmp")), planes):
        np.testing.assert_array_equal(got, plane)
    pix = rng.integers(0, 256, (2, 3072), dtype=np.uint8)
    np.testing.assert_array_equal(cifar10.pixels_to_chw(pix, True),
                                  jax_cifar10.pixels_to_chw(pix, True))
    chw = rng.standard_normal((2, 3, 64, 64)) * 0.7
    np.testing.assert_array_equal(cifar10.chw_to_pixels(chw),
                                  jax_cifar10.chw_to_pixels(chw))


def test_cli_flags(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    reasons = {"--prng=threefry": "Philox",
               "--dp": "applies to train", "--tp": "parallel",
               "--pp": "parallel", "--pp-micro=2": "parallel",
               "--pp-schedule=1f1b": "parallel",
               "--scan-steps=2": "applies to train",
               "--host-loop": "applies to train",
               "--scan-unroll=2": "applies to train",
               "--bogus": "Unrecognized flag"}
    for flag, reason in reasons.items():
        assert cu.main(["run", "1", "--tiny", flag]) == 1, flag
        assert reason in capsys.readouterr().out, flag
    for flag, match in (("--image-size=48", "multiple of 32"),
                        ("--image-size", "integer value"),
                        ("--layout=abc", "NCHW or NHWC"),
                        ("--tiny=yes", "takes no value"),
                        ("--sample-seed=x", "integer value"),
                        ("--debug-nans=1", "takes no value"),
                        ("--disable-jit=1", "takes no value")):
        with pytest.raises(ValueError, match=match):
            cu.main(["run", "1", flag])
    # the debug flags are accepted, and a sample under them is bit-equal
    assert cu.main(["init", "--tiny"]) == 0
    bmps = []
    for flags in ([], ["--debug-nans", "--disable-jit"]):
        assert cu.main(["run", "1", "--tiny", "--device=cpu", *flags]) == 0
        bmps.append((tmp_path / "cifar_unet" / "samples" /
                     "sample_0.bmp").read_bytes())
    assert bmps[0] == bmps[1]
    # --layout=NHWC and --remat are accepted (sampling records no autograd,
    # so --remat recomputes nothing there)
    assert cu.main(["run", "1", "--tiny", "--device=cpu", "--layout=nhwc",
                    "--remat"]) == 0
    if not torch.cuda.is_available():
        for verb in (["run", "1"], ["train", "1"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cu.main([*verb, "--tiny"])


def test_run_raises_on_a_newer_train_state(tmp_path, monkeypatch):
    """The JAX package would sample from a train_state newer than the CSV
    tree; the port cannot read one, so it raises instead of sampling from
    the older tree."""
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    assert cu.main(["init", "--tiny"]) == 0
    state = tmp_path / "cifar_unet" / "train_state"
    (state / "step_3").mkdir(parents=True)  # empty: not a checkpoint
    assert cu._newer_train_state(tmp_path / "cifar_unet"
                                 / "output_conv.csv") is None
    marker = state / "step_3" / "checkpoint"
    marker.write_text("x")
    later = time.time() + 5
    os.utime(marker, (later, later))
    with pytest.raises(RuntimeError, match="cannot read orbax train states"):
        cu.main(["run", "1", "--tiny", "--device=cpu"])
