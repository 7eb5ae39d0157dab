"""adm_unet: the class-conditional ImageNet 64×64 U-Net of Dhariwal & Nichol,
"Diffusion Models Beat GANs on Image Synthesis" (arXiv:2105.05233; ADM),
trained with Improved DDPM's hybrid loss. The JAX package has no such
model; this one is the port's own, built from the port's layers.

The architecture is guided-diffusion's ``UNetModel`` with the flags of its
README for ImageNet 64×64 (``Config``): ``--num_channels 192
--num_res_blocks 3`` at channel mult (1, 2, 3, 4), ``--attention_resolutions
32,16,8 --num_head_channels 64 --use_new_attention_order True
--resblock_updown True --use_scale_shift_norm True --class_cond True
--learn_sigma True --noise_schedule cosine --diffusion_steps 1000 --dropout
0.1``. 295.9M parameters.

- Embedding: [cos, sin] timestep features of ``num_channels`` (frequencies
  exp(−ln 10⁴·i/half)), linear → SiLU → linear to 4·``num_channels``, plus
  a learned class embedding.
- ResBlock: GN → SiLU → conv3×3; then GN → h·(1 + scale) + shift, (scale,
  shift) from SiLU(emb) → linear(2·C_out) → SiLU → dropout → conv3×3; plus
  x, or a 1×1 conv of x where the widths differ. The resampling blocks
  (BigGAN's, ``--resblock_updown``) pool 2×2 (down) or repeat ×2 nearest
  (up) both h, after its first GN → SiLU, and x.
- Attention (``nn/attention.py`` ``multi_head_attention_block``) after each
  ResBlock at the attention resolutions, in the middle between two
  ResBlocks; heads of ``num_head_channels``. ``attention`` routes N ≥ 1024
  tokens (32×32) to flash, the rest dense.
- Skips concatenated ``[h, skip]``; the output GN → SiLU → conv3×3 to 6
  channels: ε̂ and v, the learned interpolation of the log variance.
  Every conv and linear has a bias. GroupNorm has 32 groups, eps 1e-5 and
  an affine (``nn/norm.py`` ``group_norm_affine``).
- The loss (``loss_terms``): the cosine schedule (s = 0.008, β ≤ 0.999),
  L_simple = mean (ε − ε̂)² and L_t, the KL of q(x_{t−1}|x_t, x_0) from
  p(x_{t−1}|x_t) in bits per dimension, p's mean from a stop-gradient ε̂
  and its log variance f·log β_t + (1 − f)·log β̃_t with f = (v + 1)/2; at
  t = 0 the discretized Gaussian decoder's NLL. A step minimises the batch
  mean of L_simple + L_t (guided-diffusion's ``training_losses`` with
  ``learn_sigma`` and the MSE loss type: Improved DDPM's L_hybrid with
  λ = 0.001 at T = 1000). The schedule's tables are computed in f64 and
  read in f32, as guided-diffusion's are.

Precision is the port's default: f32 stored parameters and Adam moments,
bf16 products and maps; statistics, the loss and the schedule in f32.
(ADM trained in fp16.)

A step draws, from one generator: t ~ U{0..T−1} (B,), then ε ~ N(0, 1) in
the batch's shape, then each ResBlock's dropout mask in block order. It
runs through ``cifar_unet.TrainSteps`` (``step_fn``), the port's graphed
train step, with the batch's class labels gathered from a device-resident
label set beside the images.

Verbs (``common.run_cli``):
- ``init``: ADM's initialisation (PyTorch's defaults; conv2 of every
  ResBlock, the attention's projection and the output conv at zero; the
  class embedding N(0, 1)) from ``Config.seed``, written to
  ``adm_unet/params.pt``.
- ``train <epochs> [--max-steps=N] [--rows=N] [--tiny]``: Adam
  at ``learn_rate`` over a synthesized set of ``--rows`` images uniform in
  [−1, 1] with uniform labels, drawn on the device from the seed, a
  permutation an epoch. The train state (parameters, moments, step, the
  generator, the epoch) is saved under ``adm_unet/train_state/`` and
  resumed from there.
- ``run``: sampling is not part of this model yet; it exits with 2.
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from big_linear_algebra_tpu_torch.models import common
from big_linear_algebra_tpu_torch.models.cifar_unet import TrainSteps
from big_linear_algebra_tpu_torch.nn.attention import (
    multi_head_attention_block,
)
from big_linear_algebra_tpu_torch.nn.conv import conv2d
from big_linear_algebra_tpu_torch.nn.dropout import dropout
from big_linear_algebra_tpu_torch.nn.norm import group_norm_affine
from big_linear_algebra_tpu_torch.nn.optim import (
    AdamState,
    adam_init,
    tree_leaves,
    tree_map,
)
from big_linear_algebra_tpu_torch.ops.activations import silu
from big_linear_algebra_tpu_torch.utils import trace

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Config:
    image_size: int = 64
    in_channels: int = 3
    num_channels: int = 192
    channel_mult: tuple = (1, 2, 3, 4)
    num_res_blocks: int = 3
    attention_resolutions: tuple = (32, 16, 8)
    num_head_channels: int = 64
    num_classes: int = 1000
    groups: int = 32
    diffusion_steps: int = 1000
    noise_schedule: str = "cosine"
    dropout: float = 0.1
    # the flags this port implements only one way (guided-diffusion's
    # README values); any other value is refused
    use_new_attention_order: bool = True
    resblock_updown: bool = True
    use_scale_shift_norm: bool = True
    class_cond: bool = True
    learn_sigma: bool = True
    batch_size: int = 128
    learn_rate: float = 3e-4
    seed: int = 42
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # K5 fuses the DDPM U-Net's additive-time block, not this one
    fused_block: bool = False
    scan_unroll: int = 2

    def __post_init__(self):
        fixed = ("use_new_attention_order", "resblock_updown",
                 "use_scale_shift_norm", "class_cond", "learn_sigma")
        off = [f for f in fixed if not getattr(self, f)]
        if off or self.fused_block:
            raise ValueError(f"adm_unet implements {', '.join(fixed)} on "
                             f"and fused_block off; got {off or 'fused'}")
        if self.noise_schedule != "cosine":
            raise ValueError(f"adm_unet implements the cosine schedule, got "
                             f"{self.noise_schedule!r}")
        if self.param_dtype != "float32":
            raise ValueError("adm_unet keeps f32 parameters")


CONFIG = Config()
# 32×32, two levels: attention at 32×32 (1024 tokens: the flash route) and
# at 16×16, two heads of 8 and four, for CPU tests and smoke runs.
TINY = Config(image_size=32, num_channels=16, channel_mult=(1, 2),
              num_res_blocks=1, attention_resolutions=(32, 16),
              num_head_channels=8, num_classes=10, groups=8, batch_size=2,
              compute_dtype="float32")


def ckpt_dir() -> Path:
    return common.data_dir() / "adm_unet"


# ---------------------------------------------------------------------------
# The plan: the blocks in forward order, and the parameter tree
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Op:
    """One block of the forward: ``kind`` "res" (a ResBlock, ``resample``
    "", "down" or "up") or "attn"; ``cin``/``cout`` its widths, ``size``
    the side of its input; ``heads`` of an attention block."""
    key: Tuple[str, str]
    kind: str
    cin: int
    cout: int
    size: int
    resample: str = ""
    heads: int = 0


def plan(cfg: Config) -> Tuple[List[Op], List[Op], List[Op]]:
    """(input, middle, output) blocks in forward order, as guided-diffusion's
    ``UNetModel.__init__`` lays them out. An output block's first ResBlock
    takes the skip popped from the input side."""
    mc, size = cfg.num_channels, cfg.image_size
    ch = cfg.channel_mult[0] * mc
    chans = [ch]
    inp, mid, out = [], [], []

    def attn(key, c, s):
        if s in cfg.attention_resolutions:
            return [Op((key, "attn"), "attn", c, c, s,
                       heads=c // cfg.num_head_channels)]
        return []

    n = 0
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            n += 1
            key = f"input_{n}"
            inp.append(Op((key, "res"), "res", ch, mult * mc, size))
            ch = mult * mc
            inp += attn(key, ch, size)
            chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            n += 1
            inp.append(Op((f"input_{n}", "down"), "res", ch, ch, size,
                          "down"))
            size //= 2
            chans.append(ch)
    mid = [Op(("mid", "res_1"), "res", ch, ch, size),
           Op(("mid", "attn"), "attn", ch, ch, size,
              heads=ch // cfg.num_head_channels),
           Op(("mid", "res_2"), "res", ch, ch, size)]
    n = 0
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            n += 1
            key = f"output_{n}"
            out.append(Op((key, "res"), "res", ch + chans.pop(), mult * mc,
                          size))
            ch = mult * mc
            out += attn(key, ch, size)
            if level and i == cfg.num_res_blocks:
                out.append(Op((key, "up"), "res", ch, ch, size, "up"))
                size *= 2
    return inp, mid, out


def param_specs(cfg: Config) -> List[Tuple[Tuple[str, ...], Tuple[int, ...],
                                           Any]]:
    """(key path, shape, init) of every leaf in tree order. ``init``: a
    float b, U(−b, b) (PyTorch's default for conv and linear weights and
    biases, b = 1/√fan_in with fan_in = C_in·k·k for a conv (C_out, C_in,
    k, k) and ``in`` for a linear (in, out); b = 0 for ADM's zero-initialised
    leaves), "one" (GroupNorm's γ) or "normal" (the class embedding)."""
    mc, e = cfg.num_channels, 4 * cfg.num_channels
    c0 = cfg.channel_mult[0] * mc
    specs: List[Tuple[Tuple[str, ...], Tuple[int, ...], Any]] = []

    def pair(path, w_shape, fan, zero):
        bound = 0.0 if zero else 1.0 / math.sqrt(fan)
        specs.append((path + ("w",), w_shape, bound))
        specs.append((path + ("b",), (w_shape[1] if len(w_shape) == 2
                                      else w_shape[0],), bound))

    def linear(path, fin, fout, zero=False):
        pair(path, (fin, fout), fin, zero)

    def conv(path, cin, cout, k, zero=False):
        pair(path, (cout, cin, k, k), cin * k * k, zero)

    def norm(path, c):
        specs.append((path + ("g",), (c,), "one"))
        specs.append((path + ("b",), (c,), 0.0))

    linear(("time_embed", "linear_1"), mc, e)
    linear(("time_embed", "linear_2"), e, e)
    specs.append((("label_emb",), (cfg.num_classes, e), "normal"))
    conv(("input_conv",), cfg.in_channels, c0, 3)
    inp, mid, out = plan(cfg)
    for op in inp + mid + out:
        p = op.key
        if op.kind == "attn":
            norm(p + ("norm",), op.cin)
            linear(p + ("qkv",), op.cin, 3 * op.cin)
            linear(p + ("proj",), op.cin, op.cin, zero=True)
            continue
        norm(p + ("norm_1",), op.cin)
        conv(p + ("conv_1",), op.cin, op.cout, 3)
        linear(p + ("emb",), e, 2 * op.cout)
        norm(p + ("norm_2",), op.cout)
        conv(p + ("conv_2",), op.cout, op.cout, 3, zero=True)
        if op.cin != op.cout:
            conv(p + ("skip",), op.cin, op.cout, 1)
    norm(("out", "norm"), c0)
    conv(("out", "conv"), c0, 2 * cfg.in_channels, 3, zero=True)
    return specs


def _nest(pairs) -> Params:
    tree: Params = {}
    for path, leaf in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def init_params(generator: Optional[torch.Generator], cfg: Config = CONFIG,
                device=None) -> Params:
    """ADM's initialisation, drawn leaf by leaf in tree order from
    ``generator`` (on its device), f32. On the ``meta`` device (``device``)
    the leaves are shapes alone and nothing is drawn."""
    device = torch.device(device if device is not None
                          else generator.device)
    leaves = []
    for path, shape, init in param_specs(cfg):
        x = torch.empty(shape, dtype=torch.float32, device=device)
        if device.type != "meta":
            if init == "one":
                x.fill_(1.0)
            elif init == "normal":
                x.normal_(generator=generator)
            elif init:
                x.uniform_(-init, init, generator=generator)
            else:
                x.zero_()
        leaves.append((path, x))
    return _nest(leaves)


def count_params(cfg: Config = CONFIG) -> int:
    return sum(p.numel() for p in tree_leaves(
        init_params(None, cfg, device="meta")))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def timestep_features(t: torch.Tensor, dim: int) -> torch.Tensor:
    """guided-diffusion's ``timestep_embedding``: [cos, sin] of t·f_i, f_i
    = exp(−ln 10⁴·i/half), i < half = dim/2; (B, dim) f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _conv(x, p, stride: int = 1) -> torch.Tensor:
    return conv2d(x, p["w"], stride) + p["b"][:, None, None]


def _linear(x, p) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def _norm(x, p, cfg: Config) -> torch.Tensor:
    return group_norm_affine(x, p["g"], p["b"], cfg.groups)


def _resample(x, how: str) -> torch.Tensor:
    if how == "down":
        return F.avg_pool2d(x, 2)
    if how == "up":
        return F.interpolate(x, scale_factor=2, mode="nearest")
    return x


def res_block(x, emb_act, p, op: Op, cfg: Config, generator,
              train: bool) -> torch.Tensor:
    """One ResBlock; ``emb_act`` is SiLU(emb), which every block's
    embedding layer opens with."""
    h = silu(_norm(x, p["norm_1"], cfg))
    h = _conv(_resample(h, op.resample), p["conv_1"])
    x = _resample(x, op.resample)
    scale, shift = _linear(emb_act, p["emb"]).chunk(2, dim=1)
    h = (_norm(h, p["norm_2"], cfg) * (1.0 + scale[:, :, None, None])
         + shift[:, :, None, None])
    h = dropout(silu(h), cfg.dropout, generator, deterministic=not train)
    h = _conv(h, p["conv_2"])
    return (x if op.cin == op.cout else _conv(x, p["skip"])) + h


def forward(params: Params, x: torch.Tensor, t: torch.Tensor,
            y: torch.Tensor, cfg: Config = CONFIG,
            generator: Optional[torch.Generator] = None,
            train: bool = False) -> torch.Tensor:
    """(B, 2·C, H, W) in the compute dtype: ε̂ and v for x_t (B, C, H, W),
    timesteps t (B,) and class labels y (B,). Parameters and x are cast to
    ``cfg.compute_dtype`` inside the autograd graph; ``train`` switches
    dropout on, its masks drawn from ``generator`` in block order."""
    dt = getattr(torch, cfg.compute_dtype)
    params = tree_map(lambda p: p if p.dtype == dt else p.to(dt), params)
    te = params["time_embed"]
    emb = _linear(silu(_linear(timestep_features(
        t, cfg.num_channels).to(dt), te["linear_1"])), te["linear_2"])
    emb = emb + params["label_emb"][y]
    emb_act = silu(emb)

    def apply(h, op):
        p = params[op.key[0]][op.key[1]]
        if op.kind == "attn":
            return multi_head_attention_block(h, p, cfg.num_head_channels,
                                              cfg.groups)
        return res_block(h, emb_act, p, op, cfg, generator, train)

    inp, mid, out = plan(cfg)
    h = _conv(x.to(dt), params["input_conv"])
    skips = [h]
    for i, op in enumerate(inp):
        h = apply(h, op)
        if i + 1 == len(inp) or inp[i + 1].kind != "attn":
            skips.append(h)
    for op in mid:
        h = apply(h, op)
    for op in out:
        if op.kind == "res" and not op.resample:
            h = torch.cat([h, skips.pop()], dim=1)
        h = apply(h, op)
    return _conv(silu(_norm(h, params["out"]["norm"], cfg)),
                 params["out"]["conv"])


# ---------------------------------------------------------------------------
# The diffusion: the schedule, the hybrid loss, the train step
# ---------------------------------------------------------------------------

# Columns of the schedule's table, each (T,), read at t.
COLUMNS = ("sqrt_ab", "sqrt_1m_ab", "sqrt_recip_ab", "sqrt_recipm1_ab",
           "coef_1", "coef_2", "post_log_var", "log_beta")


def betas(cfg: Config) -> torch.Tensor:
    """β_t in f64: Improved DDPM's cosine schedule (s = 0.008, β ≤ 0.999;
    guided-diffusion's ``get_named_beta_schedule``)."""
    n = cfg.diffusion_steps

    def alpha_bar(u):
        return math.cos((u + 0.008) / 1.008 * math.pi / 2) ** 2

    return torch.tensor([min(1.0 - alpha_bar((i + 1) / n)
                             / alpha_bar(i / n), 0.999) for i in range(n)],
                        dtype=torch.float64)


def schedule(cfg: Config, device) -> torch.Tensor:
    """The (T, len(COLUMNS)) table, computed in f64 and stored in f32 on
    ``device`` (guided-diffusion's ``GaussianDiffusion`` arrays)."""
    b = betas(cfg)
    ab = torch.cumprod(1.0 - b, 0)
    ab_prev = torch.cat([torch.ones(1, dtype=torch.float64), ab[:-1]])
    post_var = b * (1.0 - ab_prev) / (1.0 - ab)
    cols = {"sqrt_ab": ab.sqrt(), "sqrt_1m_ab": (1.0 - ab).sqrt(),
            "sqrt_recip_ab": (1.0 / ab).sqrt(),
            "sqrt_recipm1_ab": (1.0 / ab - 1.0).sqrt(),
            "coef_1": b * ab_prev.sqrt() / (1.0 - ab),
            "coef_2": (1.0 - ab_prev) * (1.0 - b).sqrt() / (1.0 - ab),
            "post_log_var": torch.cat([post_var[1:2], post_var[1:]]).log(),
            "log_beta": b.log()}
    return torch.stack([cols[c] for c in COLUMNS], 1).float().to(device)


def _cdf(x: torch.Tensor) -> torch.Tensor:
    """guided-diffusion's approximate standard normal CDF."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x ** 3)))


def decoder_nll(x0, mean, log_var) -> torch.Tensor:
    """−log p(x0) per element under the discretized Gaussian decoder (bins
    of 2/255 on [−1, 1], the edges open), in nats."""
    centered = x0 - mean
    inv_std = torch.exp(-0.5 * log_var)
    cdf_plus = _cdf(inv_std * (centered + 1.0 / 255.0))
    cdf_min = _cdf(inv_std * (centered - 1.0 / 255.0))
    log_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return -torch.where(x0 < -0.999, log_plus,
                        torch.where(x0 > 0.999, log_one_minus, log_delta))


def hybrid_terms(out: torch.Tensor, x0: torch.Tensor, xt: torch.Tensor,
                 t: torch.Tensor, noise: torch.Tensor,
                 table: torch.Tensor) -> torch.Tensor:
    """(L_simple, L_t) as a (2,) f32 tensor, batch means, from the net's
    output ``out`` (B, 2·C, H, W): L_simple = mean (ε − ε̂)²; L_t in bits a
    dimension, with p's mean from ε̂ under a stop-gradient."""
    c = x0.shape[1]
    col = {n: table[t, i][:, None, None, None]
           for i, n in enumerate(COLUMNS)}
    eps, v = out[:, :c].float(), out[:, c:].float()
    mse = ((noise - eps) ** 2).mean(dim=(1, 2, 3))
    pred_x0 = col["sqrt_recip_ab"] * xt - col["sqrt_recipm1_ab"] * eps.detach()
    mean = col["coef_1"] * pred_x0 + col["coef_2"] * xt
    frac = (v + 1.0) / 2.0
    log_var = frac * col["log_beta"] + (1.0 - frac) * col["post_log_var"]
    true_mean = col["coef_1"] * x0 + col["coef_2"] * xt
    true_log_var = col["post_log_var"]
    kl = 0.5 * (-1.0 + log_var - true_log_var
                + torch.exp(true_log_var - log_var)
                + (true_mean - mean) ** 2 * torch.exp(-log_var))
    bits = 1.0 / math.log(2.0)
    kl = kl.mean(dim=(1, 2, 3)) * bits
    nll = decoder_nll(x0, mean, log_var).mean(dim=(1, 2, 3)) * bits
    vb = torch.where(t == 0, nll, kl)
    return torch.stack([mse.mean(), vb.mean()])


def draws(x0: torch.Tensor, generator: torch.Generator,
          cfg: Config) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step's draws before the net's: t ~ U{0..T−1} (B,), then
    ε ~ N(0, 1) in x0's shape."""
    t = torch.randint(0, cfg.diffusion_steps, (x0.shape[0],),
                      generator=generator, device=x0.device)
    noise = torch.randn(x0.shape, generator=generator, device=x0.device,
                        dtype=x0.dtype)
    return t, noise


_TABLES: Dict[Tuple[Config, torch.device], torch.Tensor] = {}


def device_schedule(cfg: Config, device) -> torch.Tensor:
    """``schedule(cfg, device)``, made once per (cfg, device): a step reads
    it without a copy from the host, which a CUDA graph could not
    replay."""
    key = (cfg, torch.device(device))
    if key not in _TABLES:
        _TABLES[key] = schedule(cfg, device)
    return _TABLES[key]


def loss_terms(params: Params, x0, y, t, noise, cfg: Config = CONFIG,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(L_simple, L_t) of the batch x0 (B, C, H, W) f32 with labels y, at
    the draws t and ε; the forward in train mode, its dropout from
    ``generator``."""
    table = device_schedule(cfg, x0.device)
    xt = (table[t, 0][:, None, None, None] * x0
          + table[t, 1][:, None, None, None] * noise)
    out = forward(params, xt, t, y, cfg, generator, train=True)
    return hybrid_terms(out, x0, xt, t, noise, table)


def step_grads(params: Params, x0: torch.Tensor, y: torch.Tensor,
               generator: torch.Generator, cfg: Config):
    """What a train step hands Adam (``TrainSteps``' ``step_fn``): the
    (L_simple, L_t) terms, the gradient tree of their sum, and no
    rounding seed or index (f32 parameters)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with trace.phase("forward", x0):
        t, noise = draws(x0, generator, cfg)
        with torch.enable_grad():
            terms = loss_terms(leaves, x0, y, t, noise, cfg, generator)
    with trace.phase("backward", x0):
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(terms.sum(),
                                             tree_leaves(leaves)))
        grads = tree_map(lambda _: next(grads), leaves)
    return terms.detach(), grads, None, None


def train_steps(params: Params, opt_state: AdamState, data: torch.Tensor,
                labels: torch.Tensor, generator: torch.Generator,
                cfg: Config = CONFIG,
                unroll: Optional[int] = None) -> TrainSteps:
    """The port's graphed train step over ``data`` (N, C, H, W) and
    ``labels`` (N,) on the device: ``run(rows)`` takes a step a row of
    batch indices and returns the (k, 2) loss terms."""
    return TrainSteps(params, opt_state, data, generator, cfg,
                      unroll=unroll, labels=labels, step_fn=step_grads,
                      loss_shape=(2,))


# ---------------------------------------------------------------------------
# Verbs
# ---------------------------------------------------------------------------


def _cfg_from_flags(flags) -> Config:
    flags = flags or {}
    return TINY if common.presence_flag(flags, "tiny") else CONFIG


def init(flags=None) -> None:
    cfg = _cfg_from_flags(flags)
    params = init_params(torch.Generator().manual_seed(cfg.seed), cfg)
    path = ckpt_dir() / "params.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(params, path)
    print(f"initialized {count_params(cfg)} parameters in {path}")


def _state_path() -> Path:
    return ckpt_dir() / "train_state" / "state.pt"


def train(num_epochs: int, *args, flags=None) -> int:
    """Adam epochs over the synthesized set through ``train_steps``."""
    flags = flags or {}
    cfg = _cfg_from_flags(flags)
    device = common.device_flag(flags)
    rows = common.int_flag(flags, "rows", 64 if cfg is TINY else 50000, 1)
    max_steps = common.int_flag(flags, "max-steps", 0, 0)
    if rows < cfg.batch_size:
        raise ValueError(f"--rows={rows} is less than a batch "
                         f"({cfg.batch_size})")
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    data = torch.empty((rows, cfg.in_channels, cfg.image_size,
                        cfg.image_size), device=device)
    data.uniform_(-1.0, 1.0, generator=gen)
    labels = torch.randint(0, cfg.num_classes, (rows,), generator=gen,
                           device=device)
    if _state_path().is_file():
        state = torch.load(_state_path(), map_location=device)
        params, epoch = state["params"], state["epoch"]
        opt = AdamState(state["step"], state["m"], state["v"])
        gen.set_state(state["rng"].cpu())
        print(f"resumed at step {opt.step}, epoch {epoch}")
    else:
        params = torch.load(ckpt_dir() / "params.pt", map_location=device)
        opt, epoch = adam_init(params), 0
    steps = train_steps(params, opt, data, labels, gen, cfg)
    n = rows // cfg.batch_size
    if max_steps:
        n = min(n, max_steps)
    log = common.MetricsLogger()
    for _ in range(num_epochs):
        perm = torch.randperm(rows, generator=gen, device=device)
        start = time.perf_counter()
        terms = steps.run(perm[:n * cfg.batch_size].reshape(
            n, cfg.batch_size)).cpu()
        epoch += 1
        log.log(epoch=epoch, steps=steps.step,
                l_simple=float(terms[:, 0].mean()),
                l_vb=float(terms[:, 1].mean()),
                ms_per_step=1e3 * (time.perf_counter() - start) / n)
    _state_path().parent.mkdir(parents=True, exist_ok=True)
    torch.save({"params": steps.params, "m": steps.m, "v": steps.v,
                "step": steps.step, "rng": gen.get_state(),
                "epoch": epoch}, _state_path())
    return 0


def run(num: int = 1, flags=None) -> int:
    print("adm_unet samples nothing yet: its sampler (250 steps with the "
          "learned variance) is not ported")
    return 2


def main(argv=None) -> int:
    return common.run_cli(
        "adm_unet", init, train, run, argv=argv,
        train_usage="train <num epochs> [--max-steps=N] [--rows=N]",
        run_usage="run (not ported)",
        extra_flags=("tiny", "rows", "max-steps"))


if __name__ == "__main__":
    raise SystemExit(main())
