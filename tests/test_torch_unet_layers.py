"""The port's U-Net layers against the JAX package's: group norm, the "same"
conv, dropout, relu, the initializers, dense attention, the flash kernel's
plain version (against the Pallas forwards in interpret mode), the
attention dispatch and the self-attention block. The CUDA kernel itself runs
only on a card, where chip_smoke.py holds it against the plain version."""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_linear_algebra_tpu.nn import conv as jax_conv
from big_linear_algebra_tpu.nn import norm as jax_norm
from big_linear_algebra_tpu.ops import activations as jax_act
from big_linear_algebra_tpu_torch.nn import attention as at
from big_linear_algebra_tpu_torch.nn import conv, dropout, init, norm
from big_linear_algebra_tpu_torch.ops import activations, cuda_utils, matmul
from tests.torch_parity import n, t

# the module: the JAX package's nn/__init__ re-exports a function of the
# same name, which shadows the attribute
jax_at = importlib.import_module("big_linear_algebra_tpu.nn.attention")


@pytest.mark.parametrize("shape,group,compat", [
    ((2, 8, 5, 6), 4, False),
    ((2, 8, 5, 6), 4, True),
    ((2, 3, 7, 7), 32, False),     # the U-Net's first block: one group of 3
    ((1, 12, 4, 3), 5, False),     # ragged: groups of 5, 5 and 2
    ((1, 12, 4, 3), 5, True),
])
def test_group_norm_f64_matches_jax(rng, shape, group, compat):
    x = rng.standard_normal(shape) * 3 + 1
    want = jax_norm.group_norm(jnp.asarray(x), group, 1e-8, compat)
    got = norm.group_norm(t(x), group, reference_compat=compat)
    assert got.dtype == torch.float64 and got.shape == shape
    np.testing.assert_allclose(n(got), n(want), rtol=1e-10, atol=1e-10)


def test_group_norm_bf16_takes_f32_stats(rng):
    """bf16 in, bf16 out, statistics in f32 on both sides: the outputs
    agree to one bf16 rounding."""
    x = (rng.standard_normal((2, 64, 6, 6)) * 4 + 2).astype(np.float32)
    want = jax_norm.group_norm(jnp.asarray(x, jnp.bfloat16), 32)
    got = norm.group_norm(t(x, torch.bfloat16), 32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(n(got), n(want), rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("stride,k", [(1, 3), (2, 3), (1, 1)])
def test_conv2d_f64_matches_jax(rng, size, stride, k):
    x = rng.standard_normal((2, 5, size, size))
    w = rng.standard_normal((6, 5, k, k))
    want = jax_conv.conv2d(jnp.asarray(x), jnp.asarray(w), stride)
    got = conv.conv2d(t(x), t(w), stride)
    out = jax_conv.out_size(size, stride)
    assert got.shape == (2, 6, out, out) and got.dtype == torch.float64
    np.testing.assert_allclose(n(got), n(want), rtol=1e-10, atol=1e-10)


def test_same_padding_and_out_size_match_jax():
    for in_size in range(1, 12):
        for kernel in (1, 2, 3, 5):
            for stride in (1, 2, 3):
                assert (conv.same_padding(in_size, kernel, stride)
                        == jax_conv.same_padding(in_size, kernel, stride))
        assert conv.out_size(in_size, 2) == jax_conv.out_size(in_size, 2)
    assert conv.same_padding(64, 3, 2) == (0, 1)  # asymmetric downsample


def test_relu_and_initializers(rng):
    x = rng.standard_normal((4, 7))
    x[0, 0] = np.nan
    np.testing.assert_array_equal(n(activations.relu(t(x))),
                                  n(jax_act.relu(jnp.asarray(x))))
    g = torch.Generator().manual_seed(0)
    w = init.xavier_uniform((256, 16), 256, 16, g)
    limit = math.sqrt(6.0) / math.sqrt(272.0)
    assert w.dtype == torch.float32 and w.abs().max() <= limit
    assert w.std() > 0.5 * limit / math.sqrt(3.0)
    assert torch.equal(
        w, init.xavier_uniform((256, 16), 256, 16,
                               torch.Generator().manual_seed(0)))


def test_dropout(rng):
    x = t(rng.standard_normal((64, 64)), torch.float32)
    assert dropout.dropout(x, 0.1, None, deterministic=True) is x
    assert dropout.dropout(x, 0.0, None) is x
    g = torch.Generator().manual_seed(3)
    y = dropout.dropout(x, 0.25, g)
    kept = y != 0
    assert 0.70 < kept.float().mean() < 0.80
    torch.testing.assert_close(y[kept], x[kept] / 0.75)
    g2 = torch.Generator().manual_seed(3)
    assert torch.equal(dropout.dropout(x, 0.25, g2), y)


@pytest.mark.parametrize("nq,nk", [(7, 7), (7, 9)])
def test_attention_dense_f64_matches_jax(rng, nq, nk):
    q = rng.standard_normal((2, nq, 5))
    k, v = (rng.standard_normal((2, nk, 5)) for _ in range(2))
    want = jax_at.attention_dense(*map(jnp.asarray, (q, k, v)))
    got = at.attention_dense(t(q), t(k), t(v))
    np.testing.assert_allclose(n(got), n(want), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("nn_,d", [(256, 16), (300, 16), (256, 64),
                                   (300, 64)])
def test_plain_flash_matches_pallas_interpret(rng, nn_, d, stream):
    """o and lse of K2's plain version against the resident (K2a) and the
    streaming (K2b) Pallas forwards in interpret mode, f32, at the JAX
    tests' tolerance (tests/test_attention.py)."""
    q, k, v = (rng.standard_normal((2, nn_, d)).astype(np.float32)
               for _ in range(3))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_o, want_lse = jax_at._flash_fwd(jq, jk, jv, 128, 128, stream)
    got_o, got_lse = at._plain_flash(t(q), t(k), t(v))
    assert got_o.dtype == torch.float32 and got_lse.shape == (2, nn_)
    np.testing.assert_allclose(n(got_o), n(want_o), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(n(got_lse), n(want_lse), rtol=2e-4, atol=2e-5)
    public = jax_at.flash_attention(jq, jk, jv, 128, 128)
    np.testing.assert_allclose(n(at.flash_attention(t(q), t(k), t(v))),
                               n(public), rtol=2e-4, atol=2e-5)


def test_plain_flash_bf16_rounds_q_and_p(rng):
    """bf16: the plain version rounds the scaled q and P to bf16, as the
    Pallas kernel does, and agrees with it (interpret mode) to bf16
    rounding; lse stays f32."""
    q, k, v = (rng.standard_normal((1, 256, 16)).astype(np.float32)
               for _ in range(3))
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want_o, want_lse = jax_at._flash_fwd(*jb, 128, 128)
    got_o, got_lse = at._plain_flash(*(t(a, torch.bfloat16)
                                       for a in (q, k, v)))
    assert got_o.dtype == torch.bfloat16 and got_lse.dtype == torch.float32
    scale = np.abs(n(want_o)).max()
    assert np.abs(n(got_o) - n(want_o)).max() <= 2e-2 * scale
    np.testing.assert_allclose(n(got_lse), n(want_lse), rtol=1e-5, atol=1e-5)


def test_attention_dispatch(monkeypatch):
    calls = []
    for name in ("flash_attention", "attention_dense"):
        real = getattr(at, name)
        monkeypatch.setattr(at, name, lambda *a, _f=real, _n=name:
                            calls.append(_n) or _f(*a))
    g = torch.Generator().manual_seed(0)
    long32 = torch.randn(1, 1024, 4, generator=g)
    at.attention(long32, long32, long32)
    at.attention(long32.double(), long32.double(), long32.double())
    short = torch.randn(1, 1023, 4, generator=g)
    at.attention(short, short, short)
    cross = torch.randn(1, 1100, 4, generator=g)
    at.attention(long32, cross, cross)
    assert calls == ["flash_attention", "attention_dense", "attention_dense",
                     "attention_dense"]


def test_self_attention_block_f64_matches_jax(rng):
    c, kd = 12, 4
    params = {"q": rng.standard_normal((c, kd)),
              "k": rng.standard_normal((c, kd)),
              "v": rng.standard_normal((c, kd)),
              "w": rng.standard_normal((kd, c)),
              "b": rng.standard_normal((c,))}
    x = rng.standard_normal((2, c, 5, 6))
    want = jax_at.self_attention_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()})
    got = at.self_attention_block(t(x), {k: t(v) for k, v in params.items()})
    assert got.shape == x.shape
    np.testing.assert_allclose(n(got), n(want), rtol=1e-10, atol=1e-10)


def test_forward_only_ops_raise_under_autograd(rng):
    """No op is forward-only any more: the U-Net's ops and K1's GEMM carry
    their hand-written backwards."""
    x = t(rng.standard_normal((1, 4, 3, 3))).requires_grad_()
    w = t(rng.standard_normal((2, 4, 3, 3)))
    q = t(rng.standard_normal((1, 8, 4))).requires_grad_()
    a = t(rng.standard_normal((3, 4))).requires_grad_()
    for call in (lambda: norm.group_norm(x, 2),
                 lambda: conv.conv2d(x, w, 1),
                 lambda: activations.relu(x),
                 lambda: at.attention_dense(q, q, q),
                 lambda: at.flash_attention(q, q, q),
                 lambda: matmul.matmul(a, t(rng.standard_normal((4, 2))))):
        assert call().requires_grad
    with torch.no_grad():
        assert matmul.matmul(a, t(rng.standard_normal((4, 2)))).shape == (3, 2)


def test_flash_kernel_wrapper_rejects_what_it_cannot_take():
    """The kernel path never takes a CPU tensor or a head dim it was not
    built for, and flash never takes cross-attention shapes."""
    q = torch.zeros(1, 64, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        at._kernel_flash(q, q, q)
    odd = torch.zeros(1, 64, 24)
    with pytest.raises(ValueError, match="head dims"):
        at._kernel_flash(odd, odd, odd)
    with pytest.raises(TypeError, match="f32 or bf16"):
        at._kernel_flash(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="self-attention-shaped"):
        at.flash_attention(q, torch.zeros(1, 32, 16), torch.zeros(1, 32, 16))


def test_kernel_operands_are_copied_unless_aligned():
    """The flash kernels copy rows in 16-byte pieces: a contiguous operand
    at a 16-byte boundary is passed as it is, and a view at an odd offset
    or a strided one is copied into a fresh contiguous tensor with the same
    values."""
    buf = torch.arange(1 + 2 * 64 * 16, dtype=torch.bfloat16)
    whole = buf[:-1].view(2, 64, 16)
    assert whole.data_ptr() % 16 == 0
    assert cuda_utils.aligned(whole) is whole
    odd = buf[1:].view(2, 64, 16)
    strided = whole.transpose(1, 2)
    for x in (odd, strided):
        y = cuda_utils.aligned(x)
        assert y.is_contiguous() and y.data_ptr() % 16 == 0
        assert y.data_ptr() != x.data_ptr() and torch.equal(y, x)
