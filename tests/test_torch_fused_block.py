"""The port's fused resnet block (``nn/fused_block.py``) against the JAX
package's, run as ``tests/test_fused_block.py`` runs it (Pallas interpret
mode, the dropout bits drawn outside the kernel and injected into the
port): the block forward and its five gradients in f32, the plain
version's math in f64 against the XLA composition, the dropout bits, the
shape gate, the kernel wrappers' checks; then the TINY U-Net with
``fused_block=True`` against JAX at 32×32 and the ``--fused-block`` CLI.

The U-Net checks use the TINY net with every attention site's q and k
scaled by 0.1: at random weights its 16×16 attention sites saturate, and
the f32 forward and gradient then differ from f64 by 4.8e-4 and 4.3e-3 of
max|ref| (fused or not); conditioned, by under 1e-5. Each JAX reference is
one jitted computation, made once per module."""

import dataclasses
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_linear_algebra_tpu.models import cifar_unet as jax_cu
from big_linear_algebra_tpu.nn import fused_block as jax_fb
from big_linear_algebra_tpu.nn import losses as jax_losses
from big_linear_algebra_tpu_torch.data import synth
from big_linear_algebra_tpu_torch.models import cifar_unet as cu
from big_linear_algebra_tpu_torch.nn import fused_block as fb
from tests.torch_parity import n, t

GSZ = 8
SEED = 123
QK_SCALE = 0.1


def _inputs(b=4, c=32, f=32, hw=4, with_w3=False, dtype=np.float32):
    """The JAX test's block inputs (tests/test_fused_block.py ``_inputs``),
    from a fixed numpy seed."""
    rng = np.random.default_rng(42)
    x = rng.standard_normal((b, c, hw, hw))
    td = rng.standard_normal((b, f))
    w1 = rng.standard_normal((f, c, 3, 3)) * 0.05
    w2 = rng.standard_normal((f, f, 3, 3)) * 0.05
    w3 = rng.standard_normal((f, c, 1, 1)) * 0.1 if with_w3 else None
    return [None if a is None else a.astype(dtype) for a in (x, td, w1, w2, w3)]


def _jax_args(args):
    return [None if a is None else jnp.asarray(a) for a in args]


def _port_args(args, requires_grad=False):
    return [None if a is None else t(a).requires_grad_(requires_grad)
            for a in args]


def _jax_bits(x, f, rate, train):
    """The bits the JAX wrappers draw off the TPU (``_ext_bits``), as the
    port's int64 tensor; None when dropout is off."""
    b, _, h, w = x.shape
    bits = jax_fb._ext_bits(jnp.int32(SEED), (f, b * h * w), rate, train)
    return None if bits is None else t(np.asarray(bits).astype(np.int64))


BLOCKS = [(False, 32), (True, 64)]  # (with w3, C), F = 32
MODES = [(0.0, False), (0.5, True)]  # (rate, train)


@functools.lru_cache(maxsize=None)
def _jax_block(with_w3, c):
    """JAX's fused block on a case's inputs: ({(rate, train): output} for
    both modes, the five gradients of sum(sin(out)) in train mode at rate
    0.5)."""
    args = _jax_args(_inputs(c=c, with_w3=with_w3))
    live = tuple(i for i, a in enumerate(args) if a is not None)

    def loss(*xs):
        full = list(xs) + [None] * (5 - len(xs))
        out = jax_fb.fused_resnet_block(*full, SEED, GSZ, 0.5, True)
        return jnp.sum(jnp.sin(out)), out

    grads, out_train = jax.jit(jax.grad(loss, argnums=live, has_aux=True))(
        *(args[i] for i in live))
    out_eval = jax.jit(jax_fb.fused_resnet_block, static_argnums=(6, 7, 8))(
        *args, SEED, GSZ, 0.0, False)
    return ({(0.0, False): n(out_eval), (0.5, True): n(out_train)},
            [n(g) for g in grads])


@pytest.mark.parametrize("rate,train", MODES)
@pytest.mark.parametrize("with_w3,c", BLOCKS)
def test_forward_matches_jax(with_w3, c, rate, train):
    args = _inputs(c=c, with_w3=with_w3)
    got = fb.fused_resnet_block(*_port_args(args), SEED, GSZ, rate, train,
                                bits=_jax_bits(args[0], 32, rate, train))
    assert got.dtype == torch.float32 and got.shape == (4, 32, 4, 4)
    want = _jax_block(with_w3, c)[0][(rate, train)]
    np.testing.assert_allclose(n(got), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("with_w3,c", BLOCKS)
def test_grads_match_jax(with_w3, c):
    """All five gradients through the recompute backward, against
    ``jax.grad`` through JAX's fused block with the same dropout bits
    (rate 0.5, train), at the JAX test's tolerance."""
    args = _inputs(c=c, with_w3=with_w3)
    live = [i for i, a in enumerate(args) if a is not None]
    want = _jax_block(with_w3, c)[1]
    ours = _port_args(args, requires_grad=True)
    out = fb.fused_resnet_block(*ours, SEED, GSZ, 0.5, True,
                                bits=_jax_bits(args[0], 32, 0.5, True))
    got = torch.autograd.grad(torch.sin(out).sum(), [ours[i] for i in live])
    for name, a, b in zip(("dx", "dtd", "dw1", "dw2", "dw3"), got, want):
        np.testing.assert_allclose(n(a), n(b), rtol=5e-4, atol=5e-5,
                                   err_msg=name)


@pytest.mark.parametrize("with_w3,c", BLOCKS)
def test_plain_f64_matches_xla_composition(with_w3, c):
    """The plain version's math in f64 (the gate keeps f64 off the fused
    path, so this is the only place it runs) against the JAX package's
    unfused ``_resnet_block_body`` in f64 at rate 0: the block and its
    VJP, 1e-10."""
    x, _, w1, w2, w3 = _inputs(c=c, with_w3=with_w3, dtype=np.float64)
    rng = np.random.default_rng(3)
    temb = rng.standard_normal((4, 16))
    p = {"conv_1": w1, "conv_2": w2,
         "conv_3": w3 if with_w3 else np.zeros((32, c, 1, 1)),
         "time_w": rng.standard_normal((16, 32)) * 0.3,
         "time_b": rng.standard_normal(32) * 0.1}
    cfg = dataclasses.replace(jax_cu.TINY, group_size=GSZ,
                              compute_dtype="float64")
    g = rng.standard_normal((4, 32, 4, 4))

    def body(x_, p_):
        return jax_cu._resnet_block_body(x_, jnp.asarray(temb), p_, None,
                                         cfg=cfg, train=False, nhwc=False)

    @jax.jit
    def ref(x_, p_, g_):
        out, vjp = jax.vjp(body, x_, p_)
        return out, vjp(g_)

    want, (dx_want, dp_want) = ref(jnp.asarray(x), jax.tree.map(
        jnp.asarray, p), jnp.asarray(g))
    td = t(temb @ p["time_w"] + p["time_b"])
    ops = [t(x), td, t(w1), t(w2), t(w3) if with_w3 else None]
    got = fb._plain_fused_fwd(*ops, fb._seed_tensor(0, "cpu"), GSZ, 0.0,
                              False, 1e-8)
    grads = fb._plain_fused_bwd(*ops, fb._seed_tensor(0, "cpu"), GSZ, 0.0,
                                False, 1e-8, t(g))
    np.testing.assert_allclose(n(got), n(want), rtol=1e-10, atol=1e-10)
    dtd_want = np.asarray(dp_want["time_b"])  # d td = d time_b, per batch
    np.testing.assert_allclose(n(grads[1]).sum(0), dtd_want, rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(temb.T @ n(grads[1]),
                               np.asarray(dp_want["time_w"]), rtol=1e-10,
                               atol=1e-10)
    pairs = [(grads[0], dx_want), (grads[2], dp_want["conv_1"]),
             (grads[3], dp_want["conv_2"])]
    if with_w3:
        pairs.append((grads[4], dp_want["conv_3"]))
    for a, b in pairs:
        np.testing.assert_allclose(n(a), n(b), rtol=1e-10, atol=1e-10)


def _numpy_bits(seed: int, count: int) -> np.ndarray:
    """The kernels' hash in numpy uint32 arithmetic (wrapping multiplies):
    fmix32(i·0x9E3779B1 ^ fmix32(seed))."""
    def fmix32(h):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))

    with np.errstate(over="ignore"):
        key = fmix32(np.array(seed, dtype=np.int64).astype(np.uint32))
        i = np.arange(count, dtype=np.uint32)
        return fmix32((i * np.uint32(0x9E3779B1)) ^ key)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, -5])
def test_dropout_bits(seed):
    """The port's hash equals the uint32 formula the kernels compute, is
    deterministic per seed and differs across seeds."""
    count = 1 << 15
    bits = fb._dropout_bits(fb._seed_tensor(seed, "cpu"), count)
    np.testing.assert_array_equal(bits.numpy(),
                                  _numpy_bits(seed, count).astype(np.int64))
    assert torch.equal(bits, fb._dropout_bits(fb._seed_tensor(
        torch.tensor(seed), "cpu"), count))
    other = fb._dropout_bits(fb._seed_tensor(seed ^ 1, "cpu"), count)
    assert (bits == other).float().mean() < 1e-3


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_dropout_keeps_a_binomial_fraction(rate):
    """In train mode the fused block keeps each element of conv_2's input
    with probability 1 − rate (within 5 binomial standard deviations),
    scaled by 1/(1 − rate); the mask is the same for the same seed."""
    shape = (16, 32, 8, 8)
    masks = [fb._dropout_mask(fb._seed_tensor(s, "cpu"), None, rate, shape,
                              torch.float32) for s in (11, 11, 12)]
    assert torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[0], masks[2])
    count = masks[0].numel()
    kept = int((masks[0] > 0).sum())
    sd = (count * rate * (1 - rate)) ** 0.5
    assert abs(kept - count * (1 - rate)) <= 5 * sd, (kept, count)
    scale = np.float32(1) / np.float32(1 - rate)
    assert set(masks[0].unique().tolist()) == {0.0, float(scale)}


def test_supported_matches_jax():
    """The JAX gate's answers, test_supported_gates's cases and the U-Net's
    blocks at 32×32 included (up_2 resnet_1, 512 in-channels at 8×8, fails
    the gate at batch 16 and passes at batch 1)."""
    cases = [((4, 32, 4, 4), 32, 32, 3, 8, "float32"),
             ((4, 32, 4, 4), 32, 32, 4, 8, "float32"),
             ((4, 30, 4, 4), 30, 32, 3, 8, "float32"),
             ((4, 32, 4, 4), 32, 32, 3, 8, "float64"),
             ((512, 256, 32, 32), 256, 256, 3, 32, "bfloat16"),
             ((4, 32, 4, 4), 32, 31, 3, 8, "float32"),
             ((4, 32, 4, 4), 16, 32, 3, 8, "float32")]
    for b in (1, 16):
        for c, hw in ((256, 8), (256, 4), (512, 4), (512, 8)):
            cases.append(((b, c, hw, hw), c, 256, 3, 32, "bfloat16"))
    answers = []
    for shape, c, f, k, gsz, dt in cases:
        ours = fb.supported(shape, c, f, k, gsz, getattr(torch, dt))
        assert ours == jax_fb.supported(shape, c, f, k, gsz,
                                        getattr(jnp, dt)), (shape, c, f, dt)
        answers.append(ours)
    assert answers[:7] == [True, False, False, False, False, False, False]
    assert answers[7:] == [True] * 4 + [True] * 3 + [False]


def test_kernel_wrappers_check_their_operands():
    """On the CPU the kernel wrappers raise (they never fall back), and
    shapes the kernels do not take are refused before any build."""
    args = _port_args(_inputs())
    with pytest.raises(ValueError, match="one CUDA device"):
        fb._kernel_fused_fwd(*args, fb._seed_tensor(1, "cpu"), GSZ, 0.0,
                             False, 1e-8)
    with pytest.raises(ValueError, match="draw their own dropout bits"):
        fb._kernel_fused_fwd(*args, fb._seed_tensor(1, "cpu"), GSZ, 0.5,
                             True, 1e-8, bits=torch.zeros(1))
    assert fb._plan(16, 512, 256, 8, 8, 3, 32) == (8, 203216)
    assert fb._plan(2, 24, 12, 8, 8, 3, 4)[0] == 3
    for shape, match in (((2, 8, 8, 6, 6, 3, 4), "16, 32 or 64"),
                         ((2, 8, 8, 4, 4, 5, 4), "3x3"),
                         ((2, 8, 8, 4, 4, 3, 3), "whole groups")):
        with pytest.raises(ValueError, match=match):
            fb._plan(*shape)


def _unet_fused_blocks(cfg, batch, dtype="bfloat16"):
    """The fused blocks of ``cfg``'s U-Net forward with fused_block=True at
    ``batch``, as (B, C, F, H, W, k, group size) in forward order: the
    model's own wiring and gate, with every conv, attention site and fused
    block replaced by zeros of its output's shape, so that nothing is
    computed at full width."""
    cfg = dataclasses.replace(cfg, fused_block=True, compute_dtype=dtype)
    blocks = []

    def block(x, td, w1, w2, w3, seed, gsz, rate, train, eps=1e-8,
              bits=None):
        blocks.append((*x.shape[:2], w1.shape[0], *x.shape[2:],
                       w1.shape[-1], gsz))
        return x.new_zeros(x.shape[0], w1.shape[0], *x.shape[2:])

    def conv(x, k, stride=1):
        return x.new_zeros(x.shape[0], k.shape[0], -(-x.shape[2] // stride),
                           -(-x.shape[3] // stride))

    params = cu.init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.zeros(batch, cfg.in_channels, cfg.image_size, cfg.image_size)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cu, "conv2d", conv)
        mp.setattr(cu, "self_attention_block", lambda h, p: h)
        mp.setattr(fb, "fused_resnet_block", block)
        with torch.inference_mode():
            cu.forward(params, x, torch.zeros(batch, dtype=torch.int64), cfg)
    return blocks


@pytest.mark.parametrize("batch,count,cluster", [(1, 10, 16), (16, 9, 8)])
def test_k5a_route_takes_every_full_width_block(batch, count, cluster):
    """K5a's route rule on the full-width U-Net's fused blocks at 32×32
    (listed from ``cu.CONFIG``): all ten at batch 1 and the gate's nine at
    batch 16 go to the tensor-core kernel in bf16, in clusters of 16 and 8
    blocks, and to the FMA kernel (``csrc/fused_block.cu``) in f32."""
    blocks = _unet_fused_blocks(cu.CONFIG, batch)
    assert len(blocks) == count
    assert {(c, f, h) for _, c, f, h, *_ in blocks} == (
        {(256, 256, 8), (256, 256, 4), (512, 256, 4), (512, 256, 8)}
        if batch == 1 else
        {(256, 256, 8), (256, 256, 4), (512, 256, 4)})
    for shape in blocks:
        assert fb._fwd_route(torch.bfloat16, *shape) == "tc", shape
        nc, smem = fb._tc_plan(*shape)
        assert nc == cluster and smem <= fb._MAX_SMEM
        assert fb._fwd_route(torch.float32, *shape) == "fma", shape


def test_k5a_route_rule_edges():
    """The TINY U-Net's blocks (12 and 24 channels, not multiples of 32)
    go to the FMA kernel in bf16 and f32; clusters of 16 up to B = 4, of
    8 from B = 5; a shape neither kernel takes raises, and so does an
    unknown route."""
    tiny = _unet_fused_blocks(cu.TINY, 2)
    assert len(tiny) == 10
    for shape in tiny:
        for dt in (torch.bfloat16, torch.float32):
            assert fb._fwd_route(dt, *shape) == "fma", shape
        with pytest.raises(ValueError, match="powers of two"):
            fb._tc_plan(*shape)
    assert fb._tc_plan(4, 256, 256, 8, 8, 3, 32)[0] == 16
    assert fb._tc_plan(5, 256, 256, 8, 8, 3, 32)[0] == 8
    with pytest.raises(ValueError, match="8x8 or 4x4"):
        fb._tc_plan(16, 256, 256, 2, 8, 3, 32)
    for shape, match in (((2, 32, 32, 6, 6, 3, 8), "16, 32 or 64"),
                         ((2, 32, 32, 4, 4, 5, 8), "3x3")):
        with pytest.raises(ValueError, match=match):
            fb._fwd_route(torch.bfloat16, *shape)
    args = _port_args(_inputs())
    with pytest.raises(ValueError, match="no K5a route"):
        fb._kernel_fused_fwd(*args, fb._seed_tensor(1, "cpu"), GSZ, 0.0,
                             False, 1e-8, route="wmma")


def test_k5b_route_takes_every_block_of_the_train_step():
    """K5b's data-gradient route rule on the full-width U-Net's nine fused
    blocks of the batch-16 train step at 32×32 (listed from ``cu.CONFIG``):
    the tensor-core kernel in bf16, in clusters of 8 blocks within the
    shared memory of an H100 block, and the FMA kernel in f32."""
    blocks = _unet_fused_blocks(cu.CONFIG, 16)
    assert sorted({(c, f, h) for _, c, f, h, *_ in blocks}) == [
        (256, 256, 4), (256, 256, 8), (512, 256, 4)]
    assert len(blocks) == 9
    for shape in blocks:
        assert fb._bwd_route(torch.bfloat16, *shape) == "tc", shape
        nc, smem = fb._bwd_tc_plan(*shape)
        assert nc == 8 and smem <= fb._MAX_SMEM
        assert fb._bwd_route(torch.float32, *shape) == "fma", shape


def test_k5_routes_take_every_block_of_the_dp_train_step():
    """``train --dp --fused-block`` on two ranks steps at batch 8 a rank:
    the gate admits all ten full-width blocks there (up_2 resnet_1, 512 →
    256 at 8×8, fails it only at batch 16), and K5a and K5b both take the
    tensor-core kernels in bf16, in clusters of 8 within an H100 block's
    shared memory."""
    blocks = _unet_fused_blocks(cu.CONFIG, 8)
    assert len(blocks) == 10
    assert {(c, f, h) for _, c, f, h, *_ in blocks} == {
        (256, 256, 8), (256, 256, 4), (512, 256, 4), (512, 256, 8)}
    for shape in blocks:
        assert fb._fwd_route(torch.bfloat16, *shape) == "tc", shape
        assert fb._bwd_route(torch.bfloat16, *shape) == "tc", shape
        for plan in (fb._tc_plan, fb._bwd_tc_plan):
            nc, smem = plan(*shape)
            assert nc == 8 and smem <= fb._MAX_SMEM, (plan, shape)


def test_k5b_route_rule_edges():
    """The TINY U-Net's blocks go to the FMA data-gradient kernel in bf16
    and f32; the tensor-core plan's shared memory at the train step's
    blocks (two blocks an SM at C = 256, one at 512 -> 256) and at its
    edges; the shapes it refuses, each with its reason; and a shape neither
    kernel takes raises, as does an unknown route."""
    tiny = _unet_fused_blocks(cu.TINY, 2)
    for shape in tiny:
        for dt in (torch.bfloat16, torch.float32):
            assert fb._bwd_route(dt, *shape) == "fma", shape
        with pytest.raises(ValueError, match="powers of two"):
            fb._bwd_tc_plan(*shape)
    assert fb._bwd_tc_plan(16, 256, 256, 8, 8, 3, 32) == (8, 110160)
    assert fb._bwd_tc_plan(1, 256, 256, 8, 8, 3, 32) == (8, 110160)
    assert fb._bwd_tc_plan(16, 256, 256, 4, 4, 3, 32) == (8, 76240)
    assert fb._bwd_tc_plan(16, 512, 256, 4, 4, 3, 32) == (8, 151648)
    assert fb._bwd_tc_plan(5, 512, 256, 8, 8, 3, 32) == (8, 218336)
    # the edges: 16 and 64 channels a block (128 exceed the shared memory),
    # groups from 8 (8x8) or 16 (4x4) channels to a whole slice, 65535
    # examples
    assert fb._bwd_tc_plan(1, 128, 128, 8, 8, 3, 8)[0] == 8
    assert fb._bwd_tc_plan(1, 128, 128, 8, 8, 3, 16)[0] == 8
    assert fb._bwd_tc_plan(1, 512, 512, 4, 4, 3, 16)[0] == 8
    assert fb._bwd_tc_plan(1, 512, 512, 4, 4, 3, 64)[0] == 8
    assert fb._bwd_tc_plan(65535, 256, 256, 8, 8, 3, 32)[0] == 8
    for shape, match in (
            ((16, 256, 256, 8, 8, 5, 32), "3x3"),
            ((16, 256, 256, 8, 4, 3, 32), "8x8 or 4x4"),
            ((16, 256, 256, 16, 16, 3, 32), "8x8 or 4x4"),
            ((16, 64, 256, 8, 8, 3, 8), "from 128 to 1024"),
            ((16, 256, 2048, 4, 4, 3, 32), "from 128 to 1024"),
            ((16, 256, 256, 8, 8, 3, 64), "groups"),
            ((16, 256, 256, 4, 4, 3, 8), "groups"),
            ((16, 256, 256, 8, 8, 3, 24), "groups"),
            ((16, 256, 512, 8, 8, 3, 32), "2048 of F's"),
            ((16, 1024, 256, 8, 8, 3, 32), "4096 of C's"),
            ((0, 256, 256, 8, 8, 3, 32), "1 <= B"),
            ((65536, 256, 256, 8, 8, 3, 32), "1 <= B"),
            ((1, 1024, 1024, 4, 4, 3, 32), "shared memory")):
        with pytest.raises(ValueError, match=match):
            fb._bwd_tc_plan(*shape)
    # bf16 shapes neither kernel takes raise on the route
    with pytest.raises(ValueError, match="16, 32 or 64"):
        fb._bwd_route(torch.bfloat16, 2, 32, 32, 6, 6, 3, 8)
    args = _port_args(_inputs())
    with pytest.raises(ValueError, match="no K5b route"):
        fb._kernel_bwd_data(*args, fb._seed_tensor(1, "cpu"), GSZ, 0.0,
                            False, 1e-8, t(np.zeros((4, 32, 4, 4))),
                            route="wmma")


@pytest.mark.parametrize("with_w3", [False, True])
def test_k5b_flipped_weights_match_jax_taps_t(with_w3):
    """The tensor-core data-gradient kernel's weights, ``_flipped_t`` of
    w1, w2 (and w3): as taps, the JAX wrapper's ``_taps_t`` of the same
    numpy weights; and a stride-1 "same" conv with them is the transposed
    conv with the stored weights (f64, 1e-12 of max|ref|)."""
    _, _, w1, w2, w3 = _inputs(b=2, c=24, f=16, hw=5, with_w3=with_w3,
                               dtype=np.float64)
    g = np.random.default_rng(3).standard_normal((2, 16, 5, 5))
    for w in (w1, w2) + ((w3,) if with_w3 else ()):
        flipped = fb._flipped_t(t(w))
        assert flipped.is_contiguous()
        o, i, k, _ = w.shape
        taps = flipped.permute(2, 3, 1, 0).reshape(k * k, o, i)
        np.testing.assert_array_equal(
            n(taps), np.asarray(jax_fb._taps_t(jnp.asarray(w))))
        src = t(g) if o == 16 else t(np.random.default_rng(4)
                                     .standard_normal((2, o, 5, 5)))
        want = torch.nn.functional.conv_transpose2d(src, t(w),
                                                    padding=k // 2)
        got = torch.nn.functional.conv2d(src, flipped, padding=k // 2)
        err = (got - want).abs().max() / want.abs().max()
        assert err <= 1e-12, err


def _cuda_constants(name):
    """{NAME: value} of the ``constexpr int``/``size_t`` constants of
    ``csrc/<name>.cu``."""
    src = (Path(fb.__file__).parents[1] / "csrc" / f"{name}.cu").read_text()
    return {k: int(v) for k, v in re.findall(
        r"constexpr (?:int|size_t) (\w+) = (\d+);", src)}


def test_kernel_constants_match_the_sources():
    """The wrapper's mirrors of the kernels' constants equal the values in
    the CUDA sources, so that the plans cannot drift apart."""
    fma = _cuda_constants("fused_block")
    assert (fb._THREADS, fb._MAX_OUT, fb._STAGE_CHANNELS, fb._MAX_SMEM,
            fb._MAX_CLUSTER) == (fma["THREADS"], fma["MAX_OUT"], fma["IC"],
                                 fma["MAX_SMEM"], fma["MAX_CLUSTER"])
    tc = _cuda_constants("fused_block_tc")
    assert (fb._TC_THREADS, fb._TC_MAX_CLUSTER, fb._TC_SMALL_BATCH,
            fb._TC_CHUNK, fb._TC_RING_ROW, fb._TC_RING_SLOTS,
            fb._TC_PART_PAD, fb._MAX_SMEM) == (
        tc["THREADS"], tc["MAX_CLUSTER"], tc["SMALL_BATCH"], tc["CHUNK"],
        tc["RING_ROW"], tc["RING_SLOTS"], tc["PART_PAD"], tc["MAX_SMEM"])
    assert (fb._BWD_TC_CLUSTER, fb._BWD_TC_MAX_EF, fb._BWD_TC_MAX_EC) == (
        tc["BWD_CLUSTER"], tc["BWD_MAX_EF"], tc["BWD_MAX_EC"])


# ---------------------------------------------------------------------------
# The TINY U-Net with fused_block=True
# ---------------------------------------------------------------------------


# JAX's U-Net in the fused configuration, in f64, dropout 0: the gate keeps
# f64 on the XLA composition, the fused block's function at rate 0.
JAX_CFG = dataclasses.replace(jax_cu.TINY, fused_block=True,
                              compute_dtype="float64", dropout_rate=0.0)


def _jax_loss(params, x0, key):
    """The JAX package's DDPM loss on its own draws, with the draws and the
    network's input and output as aux: (loss, (t, noise, x_t, prediction))."""
    _, tt, noise, _ = jax_cu._ddpm_draws(x0, key, JAX_CFG)
    ab = jax_cu.ddpm_schedule(JAX_CFG)[2][tt][:, None, None, None]
    xt = jnp.sqrt(ab) * x0 + jnp.sqrt(1.0 - ab) * noise
    pred = jax_cu.forward(params, xt, tt, JAX_CFG, train=False)
    loss = jax_losses.mse_loss(pred, noise) / np.prod(x0.shape)
    return loss, (tt, noise, xt, pred)


@pytest.fixture(scope="module")
def unet():
    """The port's TINY parameters (seed 0), conditioned, and JAX's
    references on them, computed once: the f64 loss, its gradient, the
    draws, and the forward at the noised input."""
    params = cu.init_params(torch.Generator().manual_seed(0), cu.TINY)
    for stage in params.values():
        for name, blk in stage.items() if isinstance(stage, dict) else ():
            if name.startswith("attn"):
                blk["q"], blk["k"] = blk["q"] * QK_SCALE, blk["k"] * QK_SCALE
    p64 = jax.tree.map(lambda a: jnp.asarray(a.numpy(), jnp.float64),
                       params)
    x0 = np.random.default_rng(5).uniform(-1, 1, (2, 3, 32, 32))
    (loss, (tt, noise, xt, pred)), grads = jax.jit(jax.value_and_grad(
        _jax_loss, has_aux=True))(p64, jnp.asarray(x0), jax.random.key(0))
    it = iter(jax.tree_util.tree_flatten_with_path(grads)[0])
    return {"params": params, "x0": x0, "t": n(tt).astype(np.int64),
            "noise": n(noise), "xt": n(xt), "pred": n(pred),
            "loss": float(loss), "grads": {path: n(g) for path, g in it}}


def _spy(monkeypatch, name):
    """Count the calls of the plain version ``name`` of ``nn/fused_block``
    (the fused blocks the CPU path runs), recording x's shape."""
    calls = []
    real = getattr(fb, name)
    monkeypatch.setattr(fb, name,
                        lambda *a, **k: calls.append(a[0].shape)
                        or real(*a, **k))
    return calls


def test_unet_forward_fused_matches_jax(unet, monkeypatch):
    """32×32, f32: all ten blocks at H·W ≤ 64 (down_3, down_4, mid, up_1,
    up_2) take the fused block, and the output is within 2e-4 of max|ref|
    of JAX's forward with fused_block=True (in f64)."""
    calls = _spy(monkeypatch, "_plain_fused_fwd")
    cfg = dataclasses.replace(cu.TINY, fused_block=True)
    with torch.inference_mode():
        got = cu.forward(unet["params"], t(unet["xt"], torch.float32),
                         t(unet["t"]), cfg)
    assert [tuple(s) for s in calls] == (
        [(2, 12, 8, 8)] * 2 + [(2, 12, 4, 4)] * 4 + [(2, 24, 4, 4),
                                                     (2, 12, 4, 4),
                                                     (2, 24, 8, 8),
                                                     (2, 12, 8, 8)])
    ref = unet["pred"]
    assert np.abs(n(got) - ref).max() <= 2e-4 * np.abs(ref).max()


def test_unet_train_step_fused_matches_jax(unet, monkeypatch):
    """One train step's loss and every gradient leaf in f32 through the
    fused blocks (their recompute backward), dropout 0, on JAX's (t,
    noise) of key 0 (t = [0, 4]): within 2e-4 of each leaf's max|ref| of
    JAX's f64 gradient. (On key 1's draws, t = [6, 4], the f32 gradient of
    up_4 resnet_2, a block never fused, is 5.3e-4 of its max|ref| from f64
    with or without the fused blocks: its time-embedding gradient sums a
    channel of the GN backward, which cancels.)"""
    calls = _spy(monkeypatch, "_plain_fused_bwd")
    cfg = dataclasses.replace(cu.TINY, fused_block=True, dropout_rate=0.0)
    leaves = cu.tree_map(lambda a: a.clone().requires_grad_(),
                         unet["params"])
    loss = cu.loss_fn(leaves, t(unet["x0"], torch.float32), t(unet["t"]),
                      t(unet["noise"], torch.float32), cfg)
    flat = cu.tree_leaves(leaves)
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    grads = cu.tree_map(lambda p: cu._zero_if_none(next(grads), p), leaves)
    assert len(calls) == 10
    assert float(loss.detach()) == pytest.approx(unet["loss"], rel=2e-4)
    got = jax.tree_util.tree_flatten_with_path(cu.tree_map(n, grads))[0]
    assert [path for path, _ in got] == list(unet["grads"])
    for path, a in got:
        b = unet["grads"][path]
        assert np.abs(a - b).max() <= 2e-4 * max(np.abs(b).max(), 1e-300), \
            (path, np.abs(a - b).max(), np.abs(b).max())


def test_cli_fused_block_train_resume_run(tmp_path, monkeypatch, capsys):
    """``init --tiny``, ``train 1 --tiny --fused-block --max-steps=3`` twice
    (the second resumes), then ``run 1 --tiny --fused-block``: ten fused
    blocks per forward (and per backward) at TINY's batch 2, eight
    forwards in ``run`` (TINY's 8 DDPM steps)."""
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    synth.ensure_cifar(str(tmp_path), per_batch=4)
    fwd = _spy(monkeypatch, "_plain_fused_fwd")
    bwd = _spy(monkeypatch, "_plain_fused_bwd")
    assert cu.main(["init", "--tiny"]) == 0
    flags = ["--tiny", "--fused-block", "--device=cpu", "--max-steps=3"]
    assert cu.main(["train", "1", *flags]) == 0
    assert (len(fwd), len(bwd)) == (30, 30)
    assert cu.main(["train", "1", *flags]) == 0
    assert "resumed train state at step 3 (epoch 1)" in \
        capsys.readouterr().out
    del fwd[:]
    assert cu.main(["run", "1", "--tiny", "--fused-block",
                    "--device=cpu"]) == 0
    assert len(fwd) == 10 * cu.TINY.timesteps
    assert (tmp_path / "cifar_unet" / "samples" / "sample_0.bmp").is_file()


def test_cli_fused_block_flag(tmp_path, monkeypatch, capsys):
    """``--fused-block`` is accepted and sets ``Config.fused_block``; with
    ``--layout=NHWC`` it runs with no fused block, as JAX's dispatch
    (``cfg.fused_block and not nhwc``) does."""
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    assert cu._cfg_from_flags({"fused-block": ""}).fused_block
    assert not cu._cfg_from_flags({}).fused_block
    fused = []
    real = fb.fused_resnet_block
    monkeypatch.setattr(fb, "fused_resnet_block",
                        lambda *a: fused.append(1) or real(*a))
    assert cu.main(["init", "--tiny"]) == 0
    assert cu.main(["run", "1", "--tiny", "--fused-block", "--device=cpu",
                    "--layout=NHWC"]) == 0
    assert "sample_0.bmp" in capsys.readouterr().out
    assert not fused
    with pytest.raises(ValueError, match="takes no value"):
        cu.main(["run", "1", "--tiny", "--fused-block=yes"])
