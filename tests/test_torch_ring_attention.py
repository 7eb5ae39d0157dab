"""The port's ring attention (``parallel/ring_attention.py``) against the JAX
package's, over a ``seq`` axis of 4 and 8 gloo CPU ranks (one launch of
each, ``tests/torch_ranks.py``), the plain K2 and K2c/K2d on every
rotation.

- f32, forward and gradients against JAX's ``ring_attention`` on a mesh of
  as many of the conftest's virtual devices, at the JAX tests' tolerances
  (rtol 2e-5 / atol 2e-6 forward; 5e-5 / 5e-6 gradients);
- f64 against the port's ``attention_dense`` over the whole sequence, at
  1e-10;
- shards of 16 and 8 rows, and as in JAX's tests an unaligned shard (20
  rows) and a non-power-of-two one (24 rows).

JAX's ``test_ring_blocks_sublane_aligned`` has no twin: ``_ring_blocks``
picks Pallas block sizes for the TPU's 8-row sublane tile, and the CUDA
kernels tile and mask ragged rows on their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from big_linear_algebra_tpu.parallel import make_mesh as jax_make_mesh
from big_linear_algebra_tpu.parallel.ring_attention import (
    ring_attention as jax_ring)
from big_linear_algebra_tpu_torch.nn.attention import attention_dense
from tests import torch_ranks
from tests.torch_parity import n, t

# (name, ranks on the axis, (B, N, d))
CASES = [
    ("16 rows", 4, (2, 64, 16)),
    ("unaligned 20 rows", 4, (1, 80, 8)),
    ("non-pow2 24 rows", 4, (1, 96, 8)),
    ("8 ranks, 8 rows", 8, (2, 64, 16)),
    ("8 ranks, unaligned 20 rows", 8, (1, 160, 8)),
]
DTYPES = (np.float32, np.float64)


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(dtype) for _ in range(4))


def _assemble(results, key):
    """The ranks' rows of ``key`` (rank order is sequence order)."""
    return np.concatenate([r[key] for r in results], axis=1)


@pytest.fixture(scope="module")
def ranks():
    """Every case in both dtypes, run once per world size."""
    out = {}
    for world in (4, 8):
        cases = []
        for i, (name, size, shape) in enumerate(CASES):
            if size != world:
                continue
            for dtype in DTYPES:
                q, k, v, g = _inputs(shape, dtype, i)
                cases.append(((name, dtype.__name__), "ring",
                              dict(q=q, k=k, v=v, g=g)))
        results = torch_ranks.spawn(world, cases)
        for case, *_ in cases:
            out[case] = [r[case] for r in results]
    return out


@pytest.mark.parametrize("name,size,shape", CASES, ids=[c[0] for c in CASES])
def test_ring_f32_matches_jax(ranks, name, size, shape):
    """f32 forward and gradients of <o, g> against JAX's ring attention on
    ``size`` virtual devices (Pallas interpret mode), at JAX's own ring
    tolerances."""
    i = [c[0] for c in CASES].index(name)
    q, k, v, g = _inputs(shape, np.float32, i)
    mesh = jax_make_mesh({"seq": size}, devices=jax.devices()[:size])

    def fwd_bwd(q, k, v, g):  # jitted whole: one compile of the ring
        o, vjp = jax.vjp(lambda *a: jax_ring(*a, mesh, "seq"), q, k, v)
        return o, vjp(g)

    o, grads = jax.jit(fwd_bwd)(*(jnp.asarray(x) for x in (q, k, v, g)))
    results = ranks[(name, "float32")]
    np.testing.assert_allclose(_assemble(results, "o"), n(o), rtol=2e-5,
                               atol=2e-6)
    for key, want in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_assemble(results, key), n(want),
                                   rtol=5e-5, atol=5e-6, err_msg=key)


@pytest.mark.parametrize("name,size,shape", CASES, ids=[c[0] for c in CASES])
def test_ring_f64_matches_dense(ranks, name, size, shape):
    """f64 forward and gradients against the port's ``attention_dense`` over
    the whole sequence (its softmax-Jacobian backward), at 1e-10."""
    i = [c[0] for c in CASES].index(name)
    q, k, v, g = (t(x).requires_grad_() for x in _inputs(shape, np.float64,
                                                         i))
    o = attention_dense(q, k, v)
    o.backward(g.detach())
    results = ranks[(name, "float64")]
    np.testing.assert_allclose(_assemble(results, "o"), n(o), rtol=0,
                               atol=1e-10)
    for key, want in (("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        np.testing.assert_allclose(_assemble(results, key), n(want), rtol=0,
                                   atol=1e-10, err_msg=key)
