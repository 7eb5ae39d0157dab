"""Adam in place (``nn/optim.py`` ``adam_update_at_``, the hand-written
pass of ``csrc/adam.cu``) against its functional form ``adam_update_at``.

- Here: the leaves the pass refuses (not f32, not contiguous, not on
  the card, trees that do not match), each before the library loads.
- On the card (marked ``card``): 40 steps bit-equal to ``adam_update_at``
  at the U-Net's 122 leaf shapes plus leaves of 1, 3, 129 and 8197
  elements, a leaf whose pointer is not 16-byte aligned, one whose
  gradient alone is not, and an all-zero gradient; its launches counted.

This file imports no JAX, so it runs on the card's machine:

    python -m pytest tests/test_torch_adam_in_place.py -m card --noconftest
"""

import pytest
import torch

from big_linear_algebra_tpu_torch.models import cifar_unet as cu
from big_linear_algebra_tpu_torch.nn import optim
from big_linear_algebra_tpu_torch.nn.optim import (
    AdamState,
    adam_update_at,
    adam_update_at_,
    bias_corrections,
    tree_leaves,
    tree_map,
)
from big_linear_algebra_tpu_torch.ops import cuda_utils
from tests.torch_parity import card


def _trees(dtype=torch.float32):
    p = {"a": torch.ones((3, 4), dtype=dtype),
         "b": {"c": torch.ones(5, dtype=dtype)}}
    return p, *(tree_map(torch.zeros_like, p) for _ in range(3))


def _strided_grad():
    p, g, m, v = _trees()
    g["a"] = torch.zeros((4, 3)).t()
    return p, g, m, v


def _longer_grad():
    p, g, m, v = _trees()
    g["b"]["c"] = torch.zeros(6)
    return p, g, m, v


def _short_m():
    p, g, m, v = _trees()
    del m["a"]
    return p, g, m, v


@pytest.mark.parametrize("trees, reason", [
    (_trees, "a leaf on the cpu"),
    (lambda: _trees(torch.float64), "a torch.float64 leaf"),
    (lambda: _trees(torch.bfloat16), "a torch.bfloat16 leaf"),
    (_strided_grad, "a leaf that is not contiguous"),
    (_longer_grad, "leaves of different sizes"),
    (_short_m, "trees of different lengths")],
    ids=["cpu", "f64", "bf16", "strided", "sizes", "lengths"])
def test_adam_update_at_in_place_raises_for_leaves_it_cannot_write(
        monkeypatch, trees, reason):
    """The pass writes contiguous f32 leaves on one card, from trees that
    match leaf for leaf: anything else raises before the library is loaded
    or a launch is counted, and leaves every tree as it was."""
    def refuse(name):
        raise AssertionError(f"a refused step loaded {name}")

    monkeypatch.setattr(cuda_utils, "load_library", refuse)
    launches = optim.adam_launch_count
    p, g, m, v = trees()
    before = [tree_map(torch.clone, t) for t in (p, g, m, v)]
    with pytest.raises(ValueError, match=reason):
        adam_update_at_(p, g, m, v, torch.zeros((), dtype=torch.int64),
                        bias_corrections(1, 1), 2e-4)
    assert optim.adam_launch_count == launches
    for got, want in zip((p, g, m, v), before):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                     tree_leaves(want)))


def _off(x):
    """``x`` in a buffer one float past a 16-byte boundary (contiguous)."""
    return torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape)


def _card_leaves(device):
    """{name: parameter} on the card: the U-Net's 122 leaf shapes, the edge
    sizes, a leaf one float into its buffer (its moments too) and one
    whose gradient alone will be."""
    shapes = [p.shape for p in optim.tree_leaves(cu.init_params(
        torch.Generator().manual_seed(0), cu.CONFIG))]
    assert len(shapes) == 122
    shapes += [(1,), (3,), (129,), (8197,)]
    gen = torch.Generator(device).manual_seed(1)
    p = {f"leaf_{i:03d}": torch.randn(s, device=device, generator=gen)
         for i, s in enumerate(shapes)}
    p["misaligned"] = _off(torch.randn(1000, device=device, generator=gen))
    p["grad_misaligned"] = torch.randn(1000, device=device, generator=gen)
    return p, gen


@pytest.mark.card
def test_adam_update_at_in_place_bit_equal_on_the_card():
    """40 steps of ``adam_update_at_`` against ``adam_update_at`` from the
    same zero moments, the bias corrections read from one table by a
    device counter: every parameter and both moments bit for bit after
    every step. Gradients span scales 1 to 1e-8 (where eps rules the
    denominator); leaf 0's is all zeros."""
    device = card()
    p, gen = _card_leaves(device)
    m = tree_map(torch.zeros_like, p)
    v = tree_map(torch.zeros_like, p)
    m["misaligned"], v["misaligned"] = (_off(m["misaligned"]),
                                        _off(v["misaligned"]))
    plain = tree_map(torch.clone, p)
    first = plain["leaf_001"].clone()
    state = AdamState(0, tree_map(torch.clone, m), tree_map(torch.clone, v))
    counter = torch.zeros((), dtype=torch.int64, device=device)
    table = bias_corrections(1, 40).to(device)
    scales = {k: 10.0 ** -(i % 9) for i, k in enumerate(p)}
    per_step = -(-len(p) // cuda_utils.load_library(
        "adam").bla_adam_leaves_per_launch())
    launches = optim.adam_launch_count
    for step in range(40):
        g = {k: torch.randn(x.shape, device=device, generator=gen)
             * scales[k] for k, x in p.items()}
        g["leaf_000"].zero_()
        g["misaligned"] = _off(g["misaligned"])
        g["grad_misaligned"] = _off(g["grad_misaligned"])
        plain, state = adam_update_at(plain, g, state, counter, table, 2e-4)
        adam_update_at_(p, g, m, v, counter, table, 2e-4)
        counter.add_(1)
        for k in p:
            assert torch.equal(p[k], plain[k]), (step, k)
            assert torch.equal(m[k], state.m[k]), (step, k)
            assert torch.equal(v[k], state.v[k]), (step, k)
    assert all(x.data_ptr() % 16 != 0 for x in (
        p["misaligned"], m["misaligned"], v["misaligned"],
        g["misaligned"], g["grad_misaligned"]))
    assert optim.adam_launch_count - launches == 40 * per_step
    assert not torch.equal(p["leaf_001"], first)
