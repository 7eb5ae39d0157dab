"""The yardstick's arithmetic: the model's operations against PyTorch's
own count, the bounds at known shapes, the union of busy intervals."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import reference as ref
from portbench import yardstick as y
from portbench.tests import tiny

FULL = dict(tiny.TINY, embed_dims=[128, 256, 256, 256], time_embed_dim=512,
            group_size=32, key_dim=16, compute_dtype="bfloat16")


def counted(cfg, device, batch=2):
    """FlopCounterMode's count over the reference's forward (multiply-adds
    counted twice), per image."""
    params = {}
    for path, shape, _ in ref.param_specs(cfg):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.ones(shape, device=device)
    s = cfg["image_size"]
    x = torch.ones((batch, 3, s, s), device=device)
    t = torch.zeros((batch,), dtype=torch.int32, device=device)
    with FlopCounterMode(display=False) as fc:
        ref.forward(params, x, t, cfg)
    return fc.get_total_flops() // batch


@pytest.mark.parametrize("size", [32, 64])
def test_forward_flops_tiny(size):
    cfg = dict(tiny.TINY, image_size=size)
    assert y.forward_flops(cfg) == counted(cfg, "cpu")


@pytest.mark.parametrize("size,gflop", [(32, 7.133216768),
                                        (64, 28.72180736)])
def test_forward_flops_full_width(size, gflop):
    cfg = dict(FULL, image_size=size)
    assert y.forward_flops(cfg) == counted(cfg, "meta")
    assert y.forward_flops(cfg) == round(gflop * 1e9)
    assert y.forward_flops(cfg, 16) == 16 * y.forward_flops(cfg)


def test_k5_bound_counts_the_block_not_its_workspaces():
    # B=16, C=F=256 at 8x8: operations bound both directions
    fwd = y.k5_bound_s("fwd", 16, 256, 256, 8, 8, "bfloat16")
    bwd = y.k5_bound_s("bwd", 16, 256, 256, 8, 8, "bfloat16")
    conv = 2 * 16 * 64 * 9 * 256 * 256
    assert fwd == pytest.approx(2 * conv / 989e12)
    assert bwd == pytest.approx(5 * conv / 989e12)
    # a 1x1 residual adds its product once forward, twice backward
    with_w3 = y.k5_bound_s("fwd", 128, 512, 256, 4, 4, "bfloat16")
    flops = 2 * 128 * 16 * (9 * 512 * 256 + 9 * 256 * 256 + 512 * 256)
    assert with_w3 == pytest.approx(flops / 989e12)
    # at batch 16 its weights' bytes bound it
    w_bytes = 2 * (9 * 512 * 256 + 9 * 256 * 256 + 512 * 256)
    assert y.k5_bound_s("fwd", 16, 512, 256, 4, 4, "bfloat16") > \
        w_bytes / y.HBM_BYTES_PER_S


def test_union_counts_overlap_once():
    assert y.union_s([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert y.union_s([]) == 0
    assert y.gaps([(1, 2), (1.5, 3), (4, 5)], 0, 6) == [
        (0, 1), (3, 4), (5, 6)]
    assert math.isclose(y.union_s([(0, 1)] * 3), 1)
