"""The plain reference of the DDPM noise-prediction U-Net, in float32 with
TF32 off, written from the model's description and independent of the
program under test (it imports nothing of it).

The model (the C reference's ``model/cifar_unet.c:26-37,1099-1165``, the
CIFAR-10 widths of Ho et al. 2020): four resolutions of ``embed_dims``
channels; two resnet blocks a resolution (GN -> ReLU -> conv3x3 + the time
dense -> GN -> ReLU -> dropout -> conv3x3, plus x or a 1x1 conv of x);
single-head self-attention of ``key_dim`` after each resnet block at the
second resolution (down and up) and between the mid blocks; stride-2 convs
down, nearest x2 up with a channel conv where the widths differ, the skips
concatenated as ``[h, skip]``; GN -> ReLU -> conv3x3 out. GroupNorm has
``group_size`` channels a group, eps 1e-8 inside the square root and no
affine; convs have no bias and "same" padding split floor/ceil (a stride-2
conv of an even size pads 0 before and 1 after). The DDPM loss is the mean
of (eps - eps_hat)^2; Adam (0.9, 0.999, 1e-8) with bias corrections; the
sampler is Ho et al.'s algorithm 2 with sigma_t^2 = beta_t.

The draws follow the program's stated protocol, so that the reference and
the program compute the same step from the same seed: per train step t ~
U{0..T-1} then eps ~ N(0, 1) (the data's shape), then each resnet block's
dropout in block order. A block that the fused path takes (``fused_sites``,
the program's shape gate) draws one int32 seed and keeps element i of its
(F, B*H*W) layout iff fmix32(i * 0x9E3779B1 ^ fmix32(seed)) >= rate * 2^32;
any other block draws U[0, 1) in its (B, F, H, W) shape and drops where the
draw is >= 1 - rate. Sampling draws x_T, then one z a step.

``Precision``: the reference computes in float32. ``CONTROL`` computes in
float8, the step below the program's bfloat16: every weight and map that
an op reads, and every gradient that reaches one, is rounded to e4m3 at a
per-tensor scale; sums and statistics stay float32, as they do in the
program. ``STATED`` rounds the same operands to bfloat16 instead: the
reference at the configuration's own precision.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tree = Dict[str, object]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
GN_EPS = 1e-8
GOLDEN = 0x9E3779B1
MASK32 = 0xFFFFFFFF
# q and k are drawn at this share of Xavier's limit: at the full limit the
# random net's attention softmax saturates, and its q and k gradients are
# then lost to cancellation even in float32 (40% from float64 at a small
# size), so that no comparison could hold them.
QK_SCALE = 0.1
# The output conv is drawn at this share of He's limit: the sampler feeds
# the net's noise estimate back for 1000 steps, and with random weights that
# loop amplifies rounding; at the full limit the float32 program's images
# stand 12-20% from the float32 reference's (in L2), as far as the bfloat16
# program's, and the float8 control's only twice that; at a tenth, 0.7-0.9%,
# 2.5-4.8% and 12-14% (and smaller still below).
OUT_SCALE = 0.03
# The program's fused-block gate (its constant): half of this working set.
GATE_VMEM_BYTES = 96 * 1024 * 1024


def no_tf32() -> None:
    """float32 products in true float32 (TF32 would be a lower precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Parameters: the tree, and weights made from a seed on the device
# ---------------------------------------------------------------------------


def _resnet_specs(prefix, cin, cout, cfg) -> List[tuple]:
    k, t = cfg["kernel_size"], cfg["time_embed_dim"]
    he = lambda fan: math.sqrt(6.0 / fan)  # noqa: E731
    return [(prefix + ("conv_1",), (cout, cin, k, k), he(k * k * cin)),
            (prefix + ("conv_2",), (cout, cout, k, k), he(k * k * cout)),
            (prefix + ("conv_3",), (cout, cin, 1, 1), he(cin)),
            (prefix + ("time_w",), (t, cout), he(t)),
            (prefix + ("time_b",), (cout,), 0.0)]


def _attn_specs(prefix, ch, cfg) -> List[tuple]:
    kd = cfg["key_dim"]
    xavier = QK_SCALE * math.sqrt(6.0) / math.sqrt(float(ch + kd))
    return [(prefix + ("q",), (ch, kd), xavier),
            (prefix + ("k",), (ch, kd), xavier),
            (prefix + ("v",), (ch, kd), math.sqrt(6.0 / ch)),
            (prefix + ("w",), (kd, ch), math.sqrt(6.0 / kd)),
            (prefix + ("b",), (ch,), 0.0)]


def param_specs(cfg: dict) -> List[tuple]:
    """(key path, shape, uniform limit) of every leaf, in tree order: He
    uniform for convs and dense weights (fan in = k*k*C_in), Xavier uniform
    for q and k at ``QK_SCALE`` of its limit, zero biases."""
    d1, d2, d3, d4 = cfg["embed_dims"]
    c, k = cfg["in_channels"], cfg["kernel_size"]
    he = lambda fan: math.sqrt(6.0 / fan)  # noqa: E731

    def conv(path, f, cin):
        return [(path, (f, cin, k, k), he(k * k * cin))]

    s = []
    s += _resnet_specs(("down_1", "resnet_1"), c, d1, cfg)
    s += _resnet_specs(("down_1", "resnet_2"), d1, d1, cfg)
    s += conv(("down_1", "conv"), d2, d1)
    s += _resnet_specs(("down_2", "resnet_1"), d2, d2, cfg)
    s += _attn_specs(("down_2", "attn_1"), d2, cfg)
    s += _resnet_specs(("down_2", "resnet_2"), d2, d2, cfg)
    s += _attn_specs(("down_2", "attn_2"), d2, cfg)
    s += conv(("down_2", "conv"), d3, d2)
    s += _resnet_specs(("down_3", "resnet_1"), d3, d3, cfg)
    s += _resnet_specs(("down_3", "resnet_2"), d3, d3, cfg)
    s += conv(("down_3", "conv"), d4, d3)
    s += _resnet_specs(("down_4", "resnet_1"), d4, d4, cfg)
    s += _resnet_specs(("down_4", "resnet_2"), d4, d4, cfg)
    s += _resnet_specs(("mid", "resnet_1"), d4, d4, cfg)
    s += _attn_specs(("mid", "attn"), d4, cfg)
    s += _resnet_specs(("mid", "resnet_2"), d4, d4, cfg)
    s += _resnet_specs(("up_1", "resnet_1"), 2 * d4, d4, cfg)
    s += _resnet_specs(("up_1", "resnet_2"), d4, d4, cfg)
    s += conv(("up_1", "conv"), d3, d4)
    s += _resnet_specs(("up_2", "resnet_1"), 2 * d3, d3, cfg)
    s += _resnet_specs(("up_2", "resnet_2"), d3, d3, cfg)
    s += conv(("up_2", "conv"), d2, d3)
    s += _resnet_specs(("up_3", "resnet_1"), 2 * d2, d2, cfg)
    s += _attn_specs(("up_3", "attn_1"), d2, cfg)
    s += _resnet_specs(("up_3", "resnet_2"), d2, d2, cfg)
    s += _attn_specs(("up_3", "attn_2"), d2, cfg)
    s += conv(("up_3", "conv"), d1, d2)
    s += _resnet_specs(("up_4", "resnet_1"), 2 * d1, d1, cfg)
    s += _resnet_specs(("up_4", "resnet_2"), d1, d1, cfg)
    s += [(("output_conv",), (c, d1, k, k), OUT_SCALE * he(k * k * d1))]
    return s


def leaf_paths(cfg: dict) -> List[str]:
    return ["/".join(p) for p, _, _ in param_specs(cfg)]


def make_params(generator: torch.Generator, cfg: dict) -> Tree:
    """Every leaf drawn at once: one U(-1, 1) buffer on the generator's
    device, scaled by each leaf's limit, cut into the tree (float32)."""
    specs = param_specs(cfg)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    dev = generator.device
    flat = torch.empty(sum(sizes), device=dev).uniform_(-1.0, 1.0,
                                                        generator=generator)
    limits = torch.tensor([lim for _, _, lim in specs], device=dev)
    flat.mul_(torch.repeat_interleave(
        limits, torch.tensor(sizes, device=dev), output_size=flat.numel()))
    tree: Tree = {}
    for (path, shape, _), part in zip(specs, flat.split(sizes)):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = part.view(shape)
    return tree


def leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# Which blocks the program fuses (its gate), and the dropout protocol
# ---------------------------------------------------------------------------


def block_shapes(cfg: dict, batch: int) -> List[Tuple[str, int, int, int]]:
    """(block path, C_in, C_out, H) of the 18 resnet blocks in order."""
    d1, d2, d3, d4 = cfg["embed_dims"]
    s = cfg["image_size"]
    c = cfg["in_channels"]
    return [("down_1/resnet_1", c, d1, s), ("down_1/resnet_2", d1, d1, s),
            ("down_2/resnet_1", d2, d2, s // 2),
            ("down_2/resnet_2", d2, d2, s // 2),
            ("down_3/resnet_1", d3, d3, s // 4),
            ("down_3/resnet_2", d3, d3, s // 4),
            ("down_4/resnet_1", d4, d4, s // 8),
            ("down_4/resnet_2", d4, d4, s // 8),
            ("mid/resnet_1", d4, d4, s // 8), ("mid/resnet_2", d4, d4, s // 8),
            ("up_1/resnet_1", 2 * d4, d4, s // 8),
            ("up_1/resnet_2", d4, d4, s // 8),
            ("up_2/resnet_1", 2 * d3, d3, s // 4),
            ("up_2/resnet_2", d3, d3, s // 4),
            ("up_3/resnet_1", 2 * d2, d2, s // 2),
            ("up_3/resnet_2", d2, d2, s // 2),
            ("up_4/resnet_1", 2 * d1, d1, s),
            ("up_4/resnet_2", d1, d1, s)]


def _gate(batch, cin, cout, h, cfg) -> bool:
    k, g = cfg["kernel_size"], cfg["group_size"]
    if k % 2 == 0 or cin % g or cout % g:
        return False
    bhw, cm = batch * h * h, max(cin, cout)
    need = (12 * cm * bhw * 4 + 2 * k * k * cin * cout * 6
            + 2 * k * k * cm * cm * 4)
    return need <= GATE_VMEM_BYTES // 2


def fused_sites(cfg: dict, batch: int) -> List[Tuple[str, int, int, int]]:
    """The blocks the program runs as one fused block: with ``fused_block``
    on, in NCHW, at H*W <= 64, where its gate admits the shape."""
    if not cfg.get("fused_block") or cfg.get("layout", "NCHW") != "NCHW" \
            or cfg["compute_dtype"] == "float64":
        return []
    return [b for b in block_shapes(cfg, batch)
            if b[3] * b[3] <= 64 and _gate(batch, b[1], b[2], b[3], cfg)]


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    lo = (h & 0xFFFF) * c
    hi = (((h >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hashed_keep(seed: torch.Tensor, shape, rate: float) -> torch.Tensor:
    """The fused blocks' keep mask (B, F, H, W) of an int32 ``seed``."""
    b, f, h, w = shape
    key = fmix32(seed.to(torch.int64).reshape(()) & MASK32)
    i = torch.arange(f * b * h * w, dtype=torch.int64, device=seed.device)
    bits = fmix32(_mul32(i, GOLDEN) ^ key)
    keep = bits >= min(int(rate * float(2 ** 32)), 2 ** 32 - 1)
    return keep.reshape(f, b, h, w).transpose(0, 1)


class Dropout:
    """Each block's dropout draw from ``generator``, in block order."""

    def __init__(self, generator: torch.Generator, cfg: dict, batch: int):
        self.generator = generator
        self.rate = cfg["dropout_rate"]
        self.fused = {b[0] for b in fused_sites(cfg, batch)}

    def seed(self, block: str):
        """Drawn where the fused block draws its seed: before the block."""
        if block in self.fused and self.rate > 0.0:
            return torch.randint(0, 2 ** 31 - 1, (1,),
                                 generator=self.generator,
                                 device=self.generator.device,
                                 dtype=torch.int32)
        return None

    def apply(self, h: torch.Tensor, seed) -> torch.Tensor:
        if self.rate == 0.0:
            return h
        if seed is not None:
            keep = hashed_keep(seed, h.shape, self.rate)
        else:
            keep = ~(torch.rand(h.shape, generator=self.generator,
                                device=h.device) >= 1.0 - self.rate)
        return torch.where(keep, h / (1.0 - self.rate), torch.zeros_like(h))


# ---------------------------------------------------------------------------
# Precision: the reference's (float32), and the control's (float8: what an
# op reads rounded to e4m3 at a per-tensor scale, forward and backward)
# ---------------------------------------------------------------------------


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return ((x.float() / scale).to(torch.float8_e4m3fn).float()
            * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 (amax scaled), and so is its gradient."""
    return _Fp8.apply(x)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _bf16(x)

    @staticmethod
    def backward(ctx, g):
        return _bf16(g)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, and so is its gradient."""
    return _Bf16.apply(x)


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


@dataclasses.dataclass(frozen=True)
class Precision:
    """``dtype``: the maps and weights inside the net (statistics, softmax
    and the loss stay float32); ``read``: the rounding of every weight and
    map an op reads (the operands of the products, GroupNorm's input, the
    terms of the residual and time sums)."""
    dtype: torch.dtype = torch.float32
    read: Callable = exact


EXACT = Precision()
CONTROL = Precision(torch.bfloat16, fp8)
# The configuration's precision: every operand rounded to bfloat16, the
# products and sums in float32 (what the program's kernels do): how far
# rounding alone moves a step from the seed.
STATED = Precision(torch.float32, bf16)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
    return total // 2, (total + 1) // 2


def conv(x, w, stride: int, prec: Precision) -> torch.Tensor:
    k = w.shape[-1]
    lo, hi = _pads(x.shape[-1], k, stride)
    x = F.pad(x, (lo, hi, lo, hi))
    return F.conv2d(prec.read(x), prec.read(w), stride=stride)


def mm(a, b, prec: Precision) -> torch.Tensor:
    return prec.read(a) @ prec.read(b)


def group_norm(x, group_size: int) -> torch.Tensor:
    """Groups of ``group_size`` channels (a last group of fewer, as the
    3-channel input's, is a group of its own); statistics in float32."""
    b, c, h, w = x.shape
    if c % group_size:
        return torch.cat([group_norm(part, part.shape[1])
                          for part in x.split(group_size, dim=1)], 1)
    g = x.float().reshape(b, c // group_size, group_size * h * w)
    mean = g.mean(-1, keepdim=True)
    var = ((g - mean) ** 2).mean(-1, keepdim=True)
    out = ((g - mean) / torch.sqrt(var + GN_EPS)).reshape(b, c, h, w)
    return out.to(x.dtype)


def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / max(half - 1, 1))
    ang = t.float()[:, None] * freqs[None, :]
    return torch.relu(torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1))


def attention(x, p, prec: Precision) -> torch.Tensor:
    b, c, h, w = x.shape
    tok = x.reshape(b, c, h * w).transpose(1, 2)
    qq, kk, vv = (mm(tok, p[n], prec) for n in ("q", "k", "v"))
    s = mm(qq, kk.transpose(1, 2), prec).float() / math.sqrt(qq.shape[-1])
    o = mm(torch.softmax(s, dim=-1).to(x.dtype), vv, prec)
    out = mm(o, p["w"], prec) + p["b"]
    return out.transpose(1, 2).reshape(b, c, h, w)


def resnet(x, temb, p, name, cfg, drop: Optional[Dropout],
           prec: Precision) -> torch.Tensor:
    gsz = cfg["group_size"]
    seed = drop.seed(name) if drop is not None else None
    r = prec.read
    td = mm(temb, p["time_w"], prec) + p["time_b"]
    h = conv(torch.relu(group_norm(r(x), gsz)), p["conv_1"], 1, prec)
    h = r(h) + r(td)[:, :, None, None]
    h = torch.relu(group_norm(r(h), gsz))
    if drop is not None:
        h = drop.apply(h, seed)
    h = conv(h, p["conv_2"], 1, prec)
    same = x.shape[1] == p["conv_1"].shape[0]
    return r(h) + r(x if same else conv(x, p["conv_3"], 1, prec))


def _up(x, stride: int):
    return x.repeat_interleave(stride, 2).repeat_interleave(stride, 3)


def forward(params: Tree, x: torch.Tensor, t: torch.Tensor, cfg: dict,
            drop: Optional[Dropout] = None, prec: Precision = EXACT
            ) -> torch.Tensor:
    """eps_hat(x, t) in ``prec.dtype``; dropout on when ``drop`` is
    given."""
    d1, d2, d3, d4 = cfg["embed_dims"]
    s = cfg["resize_stride"]
    params = tree_map(lambda a: a.to(prec.dtype), params)
    x = x.to(prec.dtype)
    temb = time_embedding(t, cfg["time_embed_dim"]).to(prec.dtype)

    def block(h, grp, name):
        return resnet(h, temb, params[grp][name], f"{grp}/{name}", cfg,
                      drop, prec)

    def attn(h, grp, name):
        return attention(h, params[grp][name], prec)

    h = block(x, "down_1", "resnet_1")
    skip_1 = block(h, "down_1", "resnet_2")
    h = conv(skip_1, params["down_1"]["conv"], s, prec)
    h = block(h, "down_2", "resnet_1")
    h = attn(h, "down_2", "attn_1")
    h = block(h, "down_2", "resnet_2")
    skip_2 = attn(h, "down_2", "attn_2")
    h = conv(skip_2, params["down_2"]["conv"], s, prec)
    h = block(h, "down_3", "resnet_1")
    skip_3 = block(h, "down_3", "resnet_2")
    h = conv(skip_3, params["down_3"]["conv"], s, prec)
    h = block(h, "down_4", "resnet_1")
    skip_4 = block(h, "down_4", "resnet_2")

    h = block(skip_4, "mid", "resnet_1")
    h = attn(h, "mid", "attn")
    h = block(h, "mid", "resnet_2")

    h = block(torch.cat([h, skip_4], 1), "up_1", "resnet_1")
    h = block(h, "up_1", "resnet_2")
    h = _up(h, s)
    h = conv(h, params["up_1"]["conv"], 1, prec) if d4 != d3 else h
    h = block(torch.cat([h, skip_3], 1), "up_2", "resnet_1")
    h = block(h, "up_2", "resnet_2")
    h = _up(h, s)
    h = conv(h, params["up_2"]["conv"], 1, prec) if d3 != d2 else h
    h = block(torch.cat([h, skip_2], 1), "up_3", "resnet_1")
    h = attn(h, "up_3", "attn_1")
    h = block(h, "up_3", "resnet_2")
    h = attn(h, "up_3", "attn_2")
    h = _up(h, s)
    h = conv(h, params["up_3"]["conv"], 1, prec) if d2 != d1 else h
    h = block(torch.cat([h, skip_1], 1), "up_4", "resnet_1")
    h = block(h, "up_4", "resnet_2")
    return conv(torch.relu(group_norm(prec.read(h), cfg["group_size"])),
                params["output_conv"], 1, prec)


# ---------------------------------------------------------------------------
# Training: the DDPM loss, its gradient, Adam
# ---------------------------------------------------------------------------


def schedule(cfg: dict, device) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    betas = torch.linspace(cfg["beta_start"], cfg["beta_end"],
                           cfg["timesteps"], dtype=torch.float32,
                           device=device)
    alphas = 1.0 - betas
    return betas, alphas, torch.cumprod(alphas, 0)


def loss_and_grads(params: Tree, x0: torch.Tensor, generator, cfg: dict,
                   prec: Precision = EXACT):
    """(loss, gradient tree) of one step on ``x0``, its draws (t, eps, the
    dropout) from ``generator`` in the program's order."""
    t = torch.randint(0, cfg["timesteps"], (x0.shape[0],),
                      generator=generator, device=x0.device)
    noise = torch.randn(x0.shape, generator=generator, device=x0.device,
                        dtype=x0.dtype)
    ab = schedule(cfg, x0.device)[2][t][:, None, None, None]
    xt = torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    it = iter(flat)
    tracked = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        pred = forward(tracked, xt, t, cfg, Dropout(generator, cfg,
                                                    x0.shape[0]), prec)
        loss = torch.sum((pred.float() - noise) ** 2) / noise.numel()
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), grads


def skip_steps(generator: torch.Generator, cfg: dict, shape, n: int) -> None:
    """Advances ``generator`` past ``n`` train steps' draws on batches of
    ``shape`` (t, eps, then each resnet block's dropout in block order),
    computing nothing."""
    dev, b = generator.device, shape[0]
    fused = {s[0] for s in fused_sites(cfg, b)}
    for _ in range(n):
        torch.randint(0, cfg["timesteps"], (b,), generator=generator,
                      device=dev)
        torch.randn(shape, generator=generator, device=dev)
        if cfg["dropout_rate"] == 0.0:
            continue
        for name, _, cout, h in block_shapes(cfg, b):
            if name in fused:
                torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                              device=dev, dtype=torch.int32)
            else:
                torch.rand((b, cout, h, h), generator=generator, device=dev)


def adam(params: List[torch.Tensor], grads, m, v, step: int, lr: float):
    """One Adam step on lists of leaves (``step`` counts from 1)."""
    bc1 = 1.0 - ADAM_B1 ** step
    bc2 = 1.0 - ADAM_B2 ** step
    out_p, out_m, out_v = [], [], []
    for p, g, m_, v_ in zip(params, grads, m, v):
        m_ = ADAM_B1 * m_ + (1 - ADAM_B1) * g
        v_ = ADAM_B2 * v_ + (1 - ADAM_B2) * g * g
        out_p.append(p - lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + ADAM_EPS))
        out_m.append(m_)
        out_v.append(v_)
    return out_p, out_m, out_v


@dataclasses.dataclass
class State:
    """Adam's state, lists of float32 leaves in tree order, after ``step``
    steps."""
    params: List[torch.Tensor]
    m: List[torch.Tensor]
    v: List[torch.Tensor]
    step: int

    @classmethod
    def start(cls, params: Tree) -> "State":
        p = [x.detach().float() for x in leaves(params)]
        return cls(p, [torch.zeros_like(x) for x in p],
                   [torch.zeros_like(x) for x in p], 0)


def train_steps(state: State, batches: Sequence[torch.Tensor], generator,
                cfg: dict, tree: Tree, prec: Precision = EXACT,
                update: Optional[Callable] = None):
    """Adam steps from ``state`` on ``batches`` (32x32 records), their
    draws from ``generator``: (the losses, the state after them). ``tree``
    gives the leaves' key paths; ``update`` stands in for ``adam``."""
    update = update or adam
    losses = []
    for x0 in batches:
        it = iter(state.params)
        loss, g = loss_and_grads(tree_map(lambda _: next(it), tree), x0,
                                 generator, cfg, prec)
        losses.append(float(loss))
        p, m, v = update(state.params, g, state.m, state.v, state.step + 1,
                         cfg["learn_rate"])
        state = State(p, m, v, state.step + 1)
    return losses, state


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def sample(params: Tree, generator, cfg: dict, n: int,
           rows: Sequence[int], prec: Precision = EXACT) -> torch.Tensor:
    """Ancestral sampling (Ho et al. alg. 2) of a call of ``n`` images
    whose draws come from ``generator``: x_T, then a z a step, all of the
    call's shape; only ``rows`` of the call are computed. Returns those
    images clamped to [-1, 1]."""
    dev = generator.device
    shape = (n, cfg["in_channels"], cfg["image_size"], cfg["image_size"])
    betas, alphas, abar = schedule(cfg, dev)
    idx = torch.tensor(list(rows), device=dev)
    with torch.no_grad():
        x = torch.randn(shape, generator=generator, device=dev)[idx]
        for t in range(cfg["timesteps"] - 1, -1, -1):
            tb = torch.full((len(rows),), t, device=dev, dtype=torch.int32)
            eps = forward(params, x, tb, cfg, None, prec).float()
            z = torch.randn(shape, generator=generator, device=dev)[idx]
            mean = (x - betas[t] / torch.sqrt(1.0 - abar[t]) * eps) \
                / torch.sqrt(alphas[t])
            x = mean + torch.sqrt(betas[t]) * z if t > 0 else mean
    return x.clamp(-1.0, 1.0)
