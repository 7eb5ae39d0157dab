"""The port's flash attention with ``stream=False`` against the JAX
package's, run as its own tests run it (Pallas interpret mode): the
forward and the three gradients where JAX's backward takes its fused kernel
(K3a) and, with the fused budget set to 0 on both sides, its two-pass
kernels (K3b/K3c); the backward's route against JAX's rule on a grid of
shapes, dtypes and blocks; the plain backward in f64 against the dense
VJP. The CUDA kernel K3a runs only on a card, where chip_smoke.py holds it
against the plain version. Each JAX reference is one jitted computation,
made once per module."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_linear_algebra_tpu_torch.nn import attention as at
from tests.torch_parity import n, t

# the module: the JAX package's nn/__init__ re-exports a function of the
# same name, which shadows the attribute
jax_at = importlib.import_module("big_linear_algebra_tpu.nn.attention")

_JAX_KERNELS = ("_flash_bwd_fused_kernel", "_flash_bwd_dq_kernel",
                "_flash_bwd_dkv_kernel", "_flash_bwd_stream_dq_kernel",
                "_flash_bwd_stream_dkv_kernel")
_JAX_ROUTE = {("_flash_bwd_stream_dkv_kernel", "_flash_bwd_stream_dq_kernel"):
              "stream",
              ("_flash_bwd_fused_kernel",): "fused",
              ("_flash_bwd_dkv_kernel", "_flash_bwd_dq_kernel"): "two_pass"}

NS = [256, 300]
BLOCKS = [(128, 128), (384, 256)]
SHAPE_B, SHAPE_D = 2, 16


class _Traced:
    """Record which JAX backward kernels a trace reaches: each kernel body
    is wrapped while ``budget`` stands in for the fused VMEM budget."""

    def __init__(self, budget=None):
        self.budget = budget
        self.names = set()

    def __enter__(self):
        self.saved = {name: getattr(jax_at, name) for name in _JAX_KERNELS}
        self.saved_budget = jax_at._BWD_FUSED_VMEM_BUDGET
        for name, fn in self.saved.items():
            setattr(jax_at, name, self._wrap(name, fn))
        if self.budget is not None:
            jax_at._BWD_FUSED_VMEM_BUDGET = self.budget
        return self

    def _wrap(self, name, fn):
        def kernel(*args, **kwargs):
            self.names.add(name)
            return fn(*args, **kwargs)
        return kernel

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(jax_at, name, fn)
        jax_at._BWD_FUSED_VMEM_BUDGET = self.saved_budget

    @property
    def route(self):
        return _JAX_ROUTE[tuple(sorted(self.names))]


def _inputs(n_tok):
    rng = np.random.default_rng(n_tok)
    return [rng.standard_normal((SHAPE_B, n_tok, SHAPE_D)).astype(np.float32)
            for _ in range(4)]


@functools.lru_cache(maxsize=None)
def _jax_ref(n_tok, bq, bk, budget):
    """(route, o, [dq, dk, dv]) of JAX's ``flash_attention(..., bq, bk,
    stream=False)`` in interpret mode, one jitted computation, with the fused
    budget replaced by ``budget`` (None: JAX's own) while it is traced."""
    q, k, v, g = map(jnp.asarray, _inputs(n_tok))

    def run(q, k, v, g):
        o, vjp = jax.vjp(lambda *a: jax_at.flash_attention(*a, bq, bk, False),
                         q, k, v)
        return o, vjp(g)

    with _Traced(budget) as traced:
        o, grads = jax.jit(run)(q, k, v, g)
    return traced.route, n(o), [n(x) for x in grads]


def _port(n_tok, bq, bk, stream, monkeypatch):
    """(kernel names the backward chose, o, [dq, dk, dv]) of the port's
    flash attention through autograd on CPU tensors."""
    chosen = []
    real = at._by_device

    def by_device(q, kernel, plain):
        chosen.append(kernel.__name__)
        return real(q, kernel, plain)

    monkeypatch.setattr(at, "_by_device", by_device)
    q, k, v, g = (t(x).requires_grad_() for x in _inputs(n_tok))
    o = at.flash_attention(q, k, v, bq, bk, stream)
    grads = torch.autograd.grad(o, (q, k, v), g.detach())
    return chosen, n(o), [n(x) for x in grads]


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("bq,bk", BLOCKS)
@pytest.mark.parametrize("n_tok", NS)
def test_stream_false_fused_matches_jax(n_tok, bq, bk, monkeypatch):
    """JAX's backward takes K3a here; the port's takes its counterpart,
    and the forward and three gradients agree at the JAX tests'
    flash-backward tolerance (tests/test_attention.py)."""
    route, o_want, want = _jax_ref(n_tok, bq, bk, None)
    assert route == "fused"
    assert at._bwd_route((SHAPE_B, n_tok, SHAPE_D), torch.float32, bq, bk,
                         False) == "fused"
    chosen, o, got = _port(n_tok, bq, bk, False, monkeypatch)
    assert chosen == ["_kernel_flash", "_kernel_flash_bwd_fused"]
    _assert_close(o, o_want)
    for a, b in zip(got, want):
        _assert_close(a, b)


@pytest.mark.parametrize("bq,bk", BLOCKS)
@pytest.mark.parametrize("n_tok", NS)
def test_stream_false_two_pass_matches_jax(n_tok, bq, bk, monkeypatch):
    """With the fused budget at 0 on both sides, JAX's backward takes its
    two-pass kernels K3b/K3c and the port's takes K2c/K2d, which compute
    the same dq and dk/dv."""
    route, o_want, want = _jax_ref(n_tok, bq, bk, 0)
    assert route == "two_pass"
    monkeypatch.setattr(at, "_BWD_FUSED_VMEM_BUDGET", 0)
    chosen, o, got = _port(n_tok, bq, bk, False, monkeypatch)
    assert chosen == ["_kernel_flash", "_kernel_flash_bwd"]
    _assert_close(o, o_want)
    for a, b in zip(got, want):
        _assert_close(a, b)


# (n, d, bq, bk): each side of the f32 and bf16 budget edges at d_pad 128
# (f32 n_pad 12288 fills the budget exactly), a wider d_pad, the padding
# to lcm(bq, bk), and the U-Net's and bench.py's shapes
ROUTE_SHAPES = [(12288, 16, 512, 1024), (12289, 16, 512, 1024),
                (16384, 64, 512, 1024), (16385, 64, 512, 1024),
                (9000, 200, 512, 1024), (300, 16, 384, 256),
                (12000, 128, 384, 256), (1024, 16, 512, 1024),
                (4096, 128, 512, 1024)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_route_matches_jax(dtype):
    """``_bwd_route`` against the kernels JAX's ``_flash_bwd_padded``
    reaches (traced abstractly, nothing runs) for every ``stream``."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    for n_tok, d, bq, bk in ROUTE_SHAPES:
        n_pad = -(-n_tok // np.lcm(bq, bk)) * np.lcm(bq, bk)
        d_pad = -(-d // 128) * 128
        row = jax.ShapeDtypeStruct((1, n_pad, d_pad), jdt)
        stat = jax.ShapeDtypeStruct((1, n_pad, 128), jnp.float32)
        for stream in (None, True, False):
            with _Traced() as traced:
                jax.eval_shape(
                    lambda *a: jax_at._flash_bwd_padded(
                        *a, (1, n_tok, d), bq, bk, stream),
                    row, row, row, row, stat, stat)
            got = at._bwd_route((1, n_tok, d), dtype, bq, bk, stream)
            assert got == traced.route, (n_tok, d, bq, bk, stream)


def test_bwd_route_reaches_every_kernel():
    """The route grid above crosses the budget both ways."""
    routes = {at._bwd_route((1, n_tok, d), dt, bq, bk, False)
              for n_tok, d, bq, bk in ROUTE_SHAPES
              for dt in (torch.float32, torch.bfloat16)}
    assert routes == {"fused", "two_pass"}


@pytest.mark.parametrize("stream", [None, True])
def test_stream_true_and_none_take_k2c_k2d(stream, monkeypatch):
    """``stream`` None or True: the streaming backward (K2c/K2d on the
    card), whatever the budget, as in JAX."""
    assert at._bwd_route((SHAPE_B, 300, SHAPE_D), torch.float32, 128, 128,
                         stream) == "stream"
    chosen, _, _ = _port(300, 128, 128, stream, monkeypatch)
    assert chosen == ["_kernel_flash", "_kernel_flash_bwd"]


def test_plain_bwd_f64_matches_dense_vjp(rng):
    """In f64 the port's flash attention (the plain forward and backward,
    through the stream=False route) against JAX's ``attention_dense`` VJP,
    the exact math, at 1e-10 of max|ref|."""
    q, k, v, g = (rng.standard_normal((2, 300, 16)) for _ in range(4))
    xs = [t(x).requires_grad_() for x in (q, k, v)]
    o = at.flash_attention(*xs, 128, 128, False)
    got = [n(o)] + [n(x) for x in torch.autograd.grad(o, xs, t(g))]
    o_ref, vjp = jax.vjp(jax_at.attention_dense, *map(jnp.asarray, (q, k, v)))
    want = [n(o_ref)] + [n(x) for x in vjp(jnp.asarray(g))]
    for a, b in zip(got, want):
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max()


def test_fused_kernel_wrapper_rejects_cpu_tensors():
    """On anything but a CUDA tensor K3a does not launch: the wrapper
    raises, and no launch is counted."""
    q = torch.zeros(1, 64, 16)
    lse = torch.zeros(1, 64)
    before = at.bwd_fused_launch_count
    with pytest.raises(ValueError, match="CUDA device"):
        at._kernel_flash_bwd_fused(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="head dims"):
        odd = torch.zeros(1, 64, 24)
        at._kernel_flash_bwd_fused(odd, odd, odd, odd, lse, odd)
    assert at.bwd_fused_launch_count == before
