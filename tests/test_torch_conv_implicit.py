"""The port's implicit-GEMM convs (``nn/conv_implicit.py``) and im2col conv
(``nn/conv_pallas.py``) against the JAX package's: ``conv2d_implicit`` and
``conv2d_packed`` forward and VJP against its Pallas kernels (K4a/K4b) in
interpret mode at its tests' shapes (tests/test_conv_pallas.py), the plain
tap sum in f64 against the XLA conv, the gates, the routes the kernels do
not take, and ``conv2d_im2col`` with ``im2col``/``col2im`` in f64. The CUDA
kernel K4 runs only on a card, where chip_smoke.py holds it against the
plain version. Each JAX reference is one jitted computation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_linear_algebra_tpu.nn import conv as jax_conv
from big_linear_algebra_tpu.nn import conv_implicit as jax_ci
from big_linear_algebra_tpu.nn import conv_pallas as jax_cp
from big_linear_algebra_tpu_torch.nn import conv_implicit as ci
from big_linear_algebra_tpu_torch.nn import conv_pallas as cp
from tests.torch_parity import n, t

# (B, C, H, W, F, k): tests/test_conv_pallas.py's shapes
IMPLICIT_SHAPES = [(2, 8, 8, 8, 16, 3), (1, 4, 5, 7, 8, 5)]
PACKED_SHAPES = [(4, 8, 8, 8, 16, 3), (3, 4, 5, 7, 8, 5), (16, 8, 4, 4, 8, 3)]
# (C, H, W, F, k, stride): tests/test_conv_pallas.py's CASES
IM2COL_CASES = [(3, 8, 8, 4, 3, 1), (2, 9, 7, 5, 3, 2), (4, 8, 8, 8, 1, 1)]


def _conv_inputs(shape, dtype=np.float32):
    b, c, h, w, f, k = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal((b, c, h, w))
    kr = rng.standard_normal((f, c, k, k)) * 0.2
    g = rng.standard_normal((b, f, h, w))
    return [a.astype(dtype) for a in (x, kr, g)]


def _jax_fwd_vjp(fn, x, kr, g):
    """(out, dx, dk) of ``fn`` in one jitted computation."""
    def run(x, kr, g):
        out, vjp = jax.vjp(fn, x, kr)
        return (out, *vjp(g))
    return [n(a) for a in jax.jit(run)(*map(jnp.asarray, (x, kr, g)))]


def _port_fwd_vjp(fn, x, kr, g):
    xs = [t(x).requires_grad_(), t(kr).requires_grad_()]
    out = fn(*xs)
    return [n(out)] + [n(a) for a in torch.autograd.grad(out, xs, t(g))]


@pytest.mark.parametrize("shape", IMPLICIT_SHAPES)
def test_conv2d_implicit_matches_jax(shape, monkeypatch):
    """Forward, dx and dk against JAX's ``conv2d_implicit`` (its Pallas
    kernel, forward and dx, in interpret mode), at its tests' 1e-5; the
    port's forward and dx both take the kernel's plain version."""
    calls = []
    real = ci._plain_conv
    monkeypatch.setattr(ci, "_plain_conv",
                        lambda *a: calls.append(1) or real(*a))
    x, kr, g = _conv_inputs(shape)
    got = _port_fwd_vjp(ci.conv2d_implicit, x, kr, g)
    want = _jax_fwd_vjp(jax_ci.conv2d_implicit, x, kr, g)
    assert len(calls) == 2
    for name, a, b in zip(("out", "dx", "dk"), got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_conv2d_packed_matches_jax(shape):
    """The same against JAX's ``conv2d_packed`` (batch packed on the lane
    axis, the cross-example roll masked), non-square maps included."""
    x, kr, g = _conv_inputs(shape)
    got = _port_fwd_vjp(ci.conv2d_packed, x, kr, g)
    want = _jax_fwd_vjp(jax_ci.conv2d_packed, x, kr, g)
    for name, a, b in zip(("out", "dx", "dk"), got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("shape", IMPLICIT_SHAPES + [(2, 3, 6, 9, 7, 1),
                                                     (1, 5, 3, 3, 4, 7)])
def test_plain_conv_f64_matches_jax_conv2d(shape):
    """The plain tap sum in f64 against JAX's ``conv2d`` (the XLA conv),
    1×1 and a kernel wider than the map included."""
    x, kr, _ = _conv_inputs(shape, np.float64)
    got = n(ci._plain_conv(t(x), t(kr)))
    want = n(jax_conv.conv2d(jnp.asarray(x), jnp.asarray(kr), 1))
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def test_gates_match_jax():
    """``supported`` and ``packed_supported`` (the TPU's VMEM formulas)
    against the JAX package's on a grid that crosses both budgets, and the
    kernel route (odd square k within the gate, at most 4-byte dtypes)."""
    seen = set()
    for b in (1, 16, 64):
        for c, f in ((3, 128), (128, 128), (256, 512), (512, 512)):
            for hw in (4, 16, 32, 64, 128):
                for k in (1, 2, 3, 5):
                    for kw in {k, k + 2}:
                        xs, ks = (b, c, hw, hw), (f, c, k, kw)
                        for stride in (1, 2):
                            assert (ci.supported(xs, ks, stride)
                                    == jax_ci.supported(xs, ks, stride))
                            assert (ci.packed_supported(xs, ks, stride)
                                    == jax_ci.packed_supported(xs, ks,
                                                               stride))
                        seen.add((ci.supported(xs, ks, 1),
                                  ci.packed_supported(xs, ks, 1)))
    assert seen == {(True, True), (True, False), (False, False)}
    x = torch.zeros(2, 3, 8, 8)
    for kr, dtype, want in ((torch.zeros(4, 3, 3, 3), torch.float32, True),
                            (torch.zeros(4, 3, 3, 3), torch.bfloat16, True),
                            (torch.zeros(4, 3, 3, 3), torch.float64, False),
                            (torch.zeros(4, 3, 2, 2), torch.float32, False),
                            (torch.zeros(4, 3, 3, 5), torch.float32, False)):
        for packed in (False, True):
            assert ci._takes_kernel(x.to(dtype), kr.to(dtype), packed) == want


@pytest.mark.parametrize("fn", ["conv2d_implicit", "conv2d_packed"])
def test_f64_and_even_k_take_conv2d(fn, monkeypatch):
    """What the TPU kernels do not take goes to the port's ``conv2d``, as
    JAX's goes to its XLA conv: f64 (forward and VJP at 1e-10) and an even
    kernel (f32, its asymmetric "same" padding, at 1e-5); the kernel's plain
    version never runs."""
    def no_kernel(*a):
        raise AssertionError("the plain kernel version ran")

    monkeypatch.setattr(ci, "_plain_conv", no_kernel)
    for shape, dtype, tol in (((2, 3, 6, 5, 4, 3), np.float64, 1e-10),
                              ((2, 3, 6, 5, 4, 2), np.float32, 1e-5)):
        x, kr, g = _conv_inputs(shape, dtype)
        got = _port_fwd_vjp(getattr(ci, fn), x, kr, g)
        want = _jax_fwd_vjp(getattr(jax_ci, fn), x, kr, g)
        for name, a, b in zip(("out", "dx", "dk"), got, want):
            if dtype == np.float64:
                assert np.abs(a - b).max() <= tol * np.abs(b).max(), name
            else:
                np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                           err_msg=name)


@pytest.mark.parametrize("case", IM2COL_CASES)
def test_conv2d_im2col_matches_jax(case):
    """``conv2d_im2col`` forward (1e-9) and VJP (1e-8) in f64 against
    JAX's, stride 2 included (its asymmetric pad and ``col2im``)."""
    c, h, w, f, k, stride = case
    rng = np.random.default_rng(sum(case))
    x = rng.standard_normal((2, c, h, w))
    kr = rng.standard_normal((f, c, k, k))
    g = rng.standard_normal((2, f, jax_conv.out_size(h, stride),
                             jax_conv.out_size(w, stride)))
    got = _port_fwd_vjp(lambda a, b: cp.conv2d_im2col(a, b, stride), x, kr, g)
    want = _jax_fwd_vjp(lambda a, b: jax_cp.conv2d_im2col(a, b, stride),
                        x, kr, g)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=1e-10)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("case", IM2COL_CASES)
def test_im2col_and_col2im_match_jax(case):
    c, h, w, _, k, stride = case
    rng = np.random.default_rng(sum(case) + 1)
    x = rng.standard_normal((2, c, h, w))
    cols = n(cp.im2col(t(x), k, stride))
    want = n(jax_cp.im2col(jnp.asarray(x), k, stride))
    np.testing.assert_allclose(cols, want, rtol=1e-12, atol=1e-12)
    dcols = rng.standard_normal(cols.shape)
    got = n(cp.col2im(t(dcols), x.shape, k, stride))
    want = n(jax_cp.col2im(jnp.asarray(dcols), x.shape, k, stride))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_kernels_to_matrix_order(rng):
    kernels = rng.standard_normal((2, 3, 2, 2))
    kmat = n(cp.kernels_to_matrix(t(kernels)))
    # row index = c*k*k + i*k + j (lib/conv.c:138-155)
    assert kmat.shape == (12, 2)
    assert kmat[0, 0] == kernels[0, 0, 0, 0]
    assert kmat[3, 1] == kernels[1, 0, 1, 1]
    assert kmat[4, 0] == kernels[0, 1, 0, 0]
    np.testing.assert_array_equal(
        kmat, n(jax_cp.kernels_to_matrix(jnp.asarray(kernels))))


def test_kernel_wrapper_rejects_cpu_tensors():
    """On anything but a CUDA tensor K4 does not launch: the wrappers
    raise, and no launch is counted."""
    x, kr = torch.zeros(1, 3, 4, 4), torch.zeros(2, 3, 3, 3)
    before = (ci.implicit_launch_count, ci.packed_launch_count)
    for wrapper in (ci._kernel_implicit, ci._kernel_packed):
        with pytest.raises(ValueError, match="CUDA device"):
            wrapper(x, kr)
        with pytest.raises(ValueError, match="odd k"):
            wrapper(x, torch.zeros(2, 3, 2, 2))
    assert (ci.implicit_launch_count, ci.packed_launch_count) == before


def test_kernel_operands_are_copied_unless_aligned():
    """K4's bf16 kernel loads x in 16-byte pieces: a contiguous operand at a
    16-byte boundary is passed as it is, and a view at an odd offset or a
    strided one is copied into a fresh contiguous tensor with the same
    values."""
    buf = torch.arange(1 + 2 * 8 * 4 * 4, dtype=torch.bfloat16)
    kernels = torch.zeros(4, 8, 3, 3, dtype=torch.bfloat16)
    whole = buf[:-1].view(2, 8, 4, 4)
    assert whole.data_ptr() % 16 == 0
    assert ci._kernel_operands(whole, kernels, False)[0] is whole
    odd = buf[1:].view(2, 8, 4, 4)
    strided = whole.transpose(2, 3)
    for x in (odd, strided):
        y = ci._kernel_operands(x, kernels, False)[0]
        assert y.is_contiguous() and y.data_ptr() % 16 == 0
        assert y.data_ptr() != x.data_ptr() and torch.equal(y, x)


def test_taps_are_jax_w_taps(monkeypatch):
    """The per-tap weights K4's bf16 kernel gets, read back tap by tap in
    f64, are the JAX package's ``w_taps`` (captured from its pallas_call,
    forward and dx) transposed to its (k², out, in) layout, zero past the
    input channels; for dx, read in the kernel's reverse tap order, they
    are the taps of ``_ConvImplicit.backward``'s flipped, channel-transposed
    kernels. The f32 kernel reads the same taps transposed (in, out)."""
    b, c, h, w, f, k = 2, 3, 5, 5, 4, 3
    x, kr, g = _conv_inputs((b, c, h, w, f, k))
    captured = []

    def pallas_call(body, *, out_shape, **_):
        def run(*operands):
            captured.append(np.asarray(operands[1]))
            return jnp.zeros(out_shape.shape, out_shape.dtype)
        return run

    monkeypatch.setattr(jax_ci.pl, "pallas_call", pallas_call)
    _, vjp = jax.vjp(jax_ci.conv2d_implicit, jnp.asarray(x), jnp.asarray(kr))
    vjp(jnp.asarray(g))
    w_fwd, w_dx = captured  # (k², C, F), and (k², F, C) for dx
    kernels = torch.from_numpy(kr.astype(np.float64))
    taps = ci._taps(kernels, torch.float64)
    dx_taps = ci._taps(kernels, torch.float64, swap=True)
    assert taps.shape == (k * k, f, 8) and dx_taps.shape == (k * k, c, 8)
    assert not taps[..., c:].any() and not dx_taps[..., f:].any()
    k_t = torch.flip(kernels, dims=(-2, -1)).transpose(0, 1)
    for t in range(k * k):
        i, j = divmod(t, k)
        np.testing.assert_array_equal(n(taps[t, :, :c]), w_fwd[t].T)
        read = n(dx_taps[k * k - 1 - t, :, :f])
        np.testing.assert_array_equal(read, w_dx[t].T)
        np.testing.assert_array_equal(read, n(k_t[:, :, i, j]))
    for dx, want in ((False, dx_taps), (True, taps)):
        got = ci._kernel_operands(torch.zeros(1, f if dx else c, 2, 2),
                                  kernels.float(), dx)[1]
        assert torch.equal(got, want.float())
    for dx, want in ((False, taps), (True, dx_taps)):
        got = ci._kernel_operands(torch.zeros(1, f if dx else c, 2, 2,
                                              dtype=torch.bfloat16),
                                  kernels.bfloat16(), dx)[1]
        assert torch.equal(got, want.bfloat16())
