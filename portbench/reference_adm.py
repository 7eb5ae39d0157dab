"""The plain reference of the ADM ImageNet 64x64 U-Net and its hybrid loss,
in float32 with TF32 off, written from guided-diffusion's ``unet.py`` and
``gaussian_diffusion.py`` (github.com/openai/guided-diffusion) and
independent of the program under test (it imports nothing of it, and no
JAX).

The model (``forward``): guided-diffusion's ``UNetModel`` with
``use_scale_shift_norm``, ``resblock_updown`` (avg-pool / nearest-x2
resampling inside the block, on h and x), ``QKVAttention`` (the new
order: q, k, v split, then heads of ``num_head_channels``, scaled by
ch^-1/4 each), ``GroupNorm32`` (32 groups, eps 1e-5, affine, in float32),
class embedding added to the time MLP's output, convs with bias and
padding 1, the output GN -> SiLU -> conv3x3 to 6 channels. The loss
(``loss_and_grads``): ``training_losses`` with ``learn_sigma`` and the
MSE loss type: mean (eps - eps_hat)^2 plus the variational bound term in
bits per dimension (KL of the true posterior from p, p's mean from a
detached eps_hat, the learned-range log variance; the discretized Gaussian
NLL at t = 0), the schedule's arrays computed in float64 and read in
float32. Adam (0.9, 0.999, 1e-8) with bias corrections.

Departures from guided-diffusion, each because the benchmark draws its
weights and data from a seed and checks a single step:
- weights (``make_params``) are U(-1, 1) times each leaf's limit: PyTorch's
  default 1/sqrt(fan_in) for every conv and linear weight and bias, where
  guided-diffusion zero-initialises each ResBlock's second conv, the
  attention's ``proj_out`` and the output conv (zeros would leave most of
  the net without a gradient); the q and k columns of every qkv projection
  at ``QK_SCALE`` times that limit (below); GroupNorm's scale 1 and offset
  0; the class embedding N(0, 1) as U(-sqrt 3, sqrt 3) (same variance);
- compute is float32 (ADM trained in float16); no EMA;
- the draws follow the program's stated protocol, so that the reference
  and the program compute the same step from the same seed: per train step
  t ~ U{0..T-1} (B,), then eps ~ N(0, 1) (the images' shape), then each
  ResBlock's dropout, in block order, as U[0, 1) of its (B, C, H, W) shape
  dropping where the draw is >= 1 - rate.

``train_steps`` can compute a step in chunks of images (``chunk``): the
draws are made for the whole batch first, and each chunk's gradient of its
share of the batch-mean loss is summed.

``Precision`` as in ``reference.py``: ``EXACT`` (float32), ``CONTROL``
(every operand rounded to float8 e4m3 at a per-tensor scale, its gradient
too) and ``STATED`` (the operands rounded to bfloat16: the configuration's
own precision). ``fault`` plants one of ``FAULTS`` in the model or loss,
for calibrating the limits.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# the model-free parts, shared (and used through this module by the driver)
from portbench.reference import (  # noqa: F401
    ADAM_B1, CONTROL, EXACT, STATED, Precision, State, adam, leaves, no_tf32,
    tree_map)

Tree = Dict[str, object]

# The q and k columns of each qkv projection are drawn at this multiple of
# the fan-in limit. At 1x a head's scores (64 dims, GroupNorm'd tokens)
# have a standard deviation of about 0.33, and a softmax over 256 or 1024
# tokens is then nearly uniform, so that merging the heads would hardly
# change it; at 2.5x about 2, neither uniform nor saturated.
QK_SCALE = 2.5
GN_EPS = 1e-5
FAULTS = ("merged_heads", "additive_time", "no_vb", "linear_schedule")


# ---------------------------------------------------------------------------
# The layout: the blocks in order, and every leaf
# ---------------------------------------------------------------------------


def layout(cfg: dict):
    """(input, middle, output) lists of blocks in forward order, each a
    dict: ``path`` (two keys), ``type`` ("res" or "attn"), ``cin``,
    ``cout``, ``res`` (the side of the input) and ``resample`` (None,
    "down", "up"); an output block's first ResBlock takes a skip."""
    mc = cfg["num_channels"]
    mults = cfg["channel_mult"]
    res = cfg["image_size"]
    ch = mults[0] * mc
    chans, inp, out = [ch], [], []
    idx = 0
    for level, mult in enumerate(mults):
        for _ in range(cfg["num_res_blocks"]):
            idx += 1
            inp.append(dict(path=(f"input_{idx}", "res"), type="res",
                            cin=ch, cout=mult * mc, res=res, resample=None))
            ch = mult * mc
            if res in cfg["attention_resolutions"]:
                inp.append(dict(path=(f"input_{idx}", "attn"), type="attn",
                                cin=ch, cout=ch, res=res, resample=None))
            chans.append(ch)
        if level < len(mults) - 1:
            idx += 1
            inp.append(dict(path=(f"input_{idx}", "down"), type="res",
                            cin=ch, cout=ch, res=res, resample="down"))
            res //= 2
            chans.append(ch)
    mid = [dict(path=("mid", "res_1"), type="res", cin=ch, cout=ch, res=res,
                resample=None),
           dict(path=("mid", "attn"), type="attn", cin=ch, cout=ch, res=res,
                resample=None),
           dict(path=("mid", "res_2"), type="res", cin=ch, cout=ch, res=res,
                resample=None)]
    idx = 0
    for level in reversed(range(len(mults))):
        for i in range(cfg["num_res_blocks"] + 1):
            idx += 1
            cout = mults[level] * mc
            out.append(dict(path=(f"output_{idx}", "res"), type="res",
                            cin=ch + chans.pop(), cout=cout, res=res,
                            resample=None, skip=True))
            ch = cout
            if res in cfg["attention_resolutions"]:
                out.append(dict(path=(f"output_{idx}", "attn"), type="attn",
                                cin=ch, cout=ch, res=res, resample=None))
            if level > 0 and i == cfg["num_res_blocks"]:
                out.append(dict(path=(f"output_{idx}", "up"), type="res",
                                cin=ch, cout=ch, res=res, resample="up"))
                res *= 2
    return inp, mid, out


def param_specs(cfg: dict) -> List[tuple]:
    """(key path, shape, uniform limit) of every leaf, in tree order;
    GroupNorm's scales have the limit None (they are ones). Linear weights
    are (in, out); conv weights (out, in, k, k)."""
    mc = cfg["num_channels"]
    emb = 4 * mc
    c0 = cfg["channel_mult"][0] * mc
    s: List[tuple] = []

    def dense(path, fin, fout):
        lim = 1.0 / math.sqrt(fin)
        s.append((path + ("w",), (fin, fout), lim))
        s.append((path + ("b",), (fout,), lim))

    def conv(path, cin, cout, k):
        lim = 1.0 / math.sqrt(cin * k * k)
        s.append((path + ("w",), (cout, cin, k, k), lim))
        s.append((path + ("b",), (cout,), lim))

    def gn(path, c):
        s.append((path + ("g",), (c,), None))
        s.append((path + ("b",), (c,), 0.0))

    dense(("time_embed", "linear_1"), mc, emb)
    dense(("time_embed", "linear_2"), emb, emb)
    s.append((("label_emb",), (cfg["num_classes"], emb), math.sqrt(3.0)))
    conv(("input_conv",), cfg["in_channels"], c0, 3)
    inp, mid, out = layout(cfg)
    for blk in inp + mid + out:
        p, cin, cout = blk["path"], blk["cin"], blk["cout"]
        if blk["type"] == "attn":
            gn(p + ("norm",), cin)
            dense(p + ("qkv",), cin, 3 * cin)
            dense(p + ("proj",), cin, cin)
            continue
        gn(p + ("norm_1",), cin)
        conv(p + ("conv_1",), cin, cout, 3)
        dense(p + ("emb",), emb, 2 * cout)
        gn(p + ("norm_2",), cout)
        conv(p + ("conv_2",), cout, cout, 3)
        if cin != cout:
            conv(p + ("skip",), cin, cout, 1)
    gn(("out", "norm"), c0)
    conv(("out", "conv"), c0, 2 * cfg["in_channels"], 3)
    return s


def leaf_paths(cfg: dict) -> List[str]:
    return ["/".join(p) for p, _, _ in param_specs(cfg)]


def make_params(generator: torch.Generator, cfg: dict) -> Tree:
    """Every leaf drawn at once: one U(-1, 1) buffer on the generator's
    device, scaled by each leaf's limit (the q and k columns of a qkv
    weight by ``QK_SCALE`` times it; GroupNorm's scales set to one), cut
    into the tree (float32)."""
    specs = param_specs(cfg)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    dev = generator.device
    flat = torch.empty(sum(sizes), device=dev).uniform_(-1.0, 1.0,
                                                        generator=generator)
    tree: Tree = {}
    for (path, shape, lim), part in zip(specs, flat.split(sizes)):
        x = part.view(shape)
        if lim is None:
            x.fill_(1.0)
        else:
            x.mul_(lim)
        if path[-2:] == ("qkv", "w"):
            x[:, :2 * shape[0]].mul_(QK_SCALE)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = x
    return tree


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _linear(x, p, prec: Precision):
    return prec.read(x) @ prec.read(p["w"]) + p["b"]


def _conv(x, p, prec: Precision):
    k = p["w"].shape[-1]
    return F.conv2d(prec.read(x), prec.read(p["w"]), p["b"],
                    padding=k // 2)


def _gn(x, p, cfg: dict, prec: Precision):
    """GroupNorm32: in float32, back in the map's dtype."""
    return F.group_norm(prec.read(x).float(), cfg.get("groups", 32),
                        p["g"].float(), p["b"].float(),
                        eps=GN_EPS).to(x.dtype)


def attention_block(x, p, heads: int, cfg: dict, prec: Precision):
    """guided-diffusion's ``AttentionBlock`` with ``QKVAttention``."""
    r = prec.read
    b, c, hh, ww = x.shape
    n = hh * ww
    xs = x.reshape(b, c, n)
    hn = _gn(x, p["norm"], cfg, prec).reshape(b, c, n)
    qkv = torch.einsum("bcn,cd->bdn", r(hn), r(p["qkv"]["w"])) \
        + p["qkv"]["b"][None, :, None]
    q, k, v = qkv.chunk(3, dim=1)
    ch = c // heads
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    w = torch.einsum("bct,bcs->bts", r((q * scale).reshape(b * heads, ch, n)),
                     r((k * scale).reshape(b * heads, ch, n)))
    w = torch.softmax(w.float(), dim=-1).to(w.dtype)
    a = torch.einsum("bts,bcs->bct", r(w), r(v.reshape(b * heads, ch, n)))
    h = torch.einsum("bcn,cd->bdn", r(a.reshape(b, c, n)),
                     r(p["proj"]["w"])) + p["proj"]["b"][None, :, None]
    return (r(xs) + r(h)).reshape(b, c, hh, ww)


def _resample(x, how):
    if how == "down":
        return F.avg_pool2d(x, kernel_size=2, stride=2)
    if how == "up":
        return F.interpolate(x, scale_factor=2, mode="nearest")
    return x


def res_block(x, emb, p, blk: dict, cfg: dict, drop, prec: Precision,
              fault: str = ""):
    """guided-diffusion's ``ResBlock`` (``use_scale_shift_norm``,
    ``resblock_updown``); ``drop``: its dropout mask (True drops), or
    None."""
    r = prec.read
    h = F.silu(_gn(x, p["norm_1"], cfg, prec))
    h = _conv(_resample(h, blk["resample"]), p["conv_1"], prec)
    x = _resample(x, blk["resample"])
    e = _linear(F.silu(emb), p["emb"], prec)
    scale, shift = e[:, :, None, None].chunk(2, dim=1)
    if fault == "additive_time":
        h = _gn(h, p["norm_2"], cfg, prec) + shift
    else:
        h = _gn(h, p["norm_2"], cfg, prec) * (1 + scale) + shift
    h = F.silu(h)
    if drop is not None:
        h = torch.where(drop, torch.zeros_like(h),
                        h / (1.0 - cfg["dropout"]))
    h = _conv(h, p["conv_2"], prec)
    skip = x if blk["cin"] == blk["cout"] else _conv(x, p["skip"], prec)
    return r(skip) + r(h)


def timestep_embedding(t, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        0, half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def forward(params: Tree, x, t, y, cfg: dict, masks=None,
            prec: Precision = EXACT, fault: str = "") -> torch.Tensor:
    """(B, 6, H, W): eps_hat and v; ``masks`` the ResBlocks' dropout masks
    in block order (None: no dropout)."""
    params = tree_map(lambda a: a.to(prec.dtype), params)
    te = params["time_embed"]
    emb = _linear(F.silu(_linear(timestep_embedding(
        t, cfg["num_channels"]).to(prec.dtype), te["linear_1"], prec)),
        te["linear_2"], prec) + params["label_emb"][y]
    mask_iter = iter(masks) if masks is not None else None

    def run(h, blk):
        p = params[blk["path"][0]][blk["path"][1]]
        if blk["type"] == "attn":
            heads = 1 if fault == "merged_heads" else \
                blk["cin"] // cfg["num_head_channels"]
            return attention_block(h, p, heads, cfg, prec)
        drop = next(mask_iter) if mask_iter is not None else None
        return res_block(h, emb, p, blk, cfg, drop, prec, fault)

    inp, mid, out = layout(cfg)
    h = _conv(x.to(prec.dtype), params["input_conv"], prec)
    hs = [h]
    for i, blk in enumerate(inp):
        h = run(h, blk)
        last = i + 1 == len(inp) or inp[i + 1]["path"][0] != blk["path"][0]
        if last:
            hs.append(h)
    for blk in mid:
        h = run(h, blk)
    for blk in out:
        if blk.get("skip"):
            h = torch.cat([h, hs.pop()], dim=1)
        h = run(h, blk)
    h = F.silu(_gn(h, params["out"]["norm"], cfg, prec))
    return _conv(h, params["out"]["conv"], prec)


# ---------------------------------------------------------------------------
# The diffusion: schedule, hybrid loss, its gradient, Adam steps
# ---------------------------------------------------------------------------


def betas(cfg: dict, fault: str = "") -> torch.Tensor:
    """guided-diffusion's ``get_named_beta_schedule`` in float64: the
    cosine schedule, or (the planted fault) the linear one."""
    n = cfg["diffusion_steps"]
    if fault == "linear_schedule":
        scale = 1000 / n
        return torch.linspace(scale * 0.0001, scale * 0.02, n,
                              dtype=torch.float64)
    out = []
    for i in range(n):
        t1, t2 = i / n, (i + 1) / n
        ab1 = math.cos((t1 + 0.008) / 1.008 * math.pi / 2) ** 2
        ab2 = math.cos((t2 + 0.008) / 1.008 * math.pi / 2) ** 2
        out.append(min(1 - ab2 / ab1, 0.999))
    return torch.tensor(out, dtype=torch.float64)


def diffusion_arrays(cfg: dict, device, fault: str = "") -> dict:
    """``GaussianDiffusion``'s arrays, float64 then float32 on ``device``."""
    b = betas(cfg, fault)
    alphas = 1.0 - b
    ac = torch.cumprod(alphas, dim=0)
    ac_prev = torch.cat([torch.tensor([1.0], dtype=torch.float64), ac[:-1]])
    pv = b * (1.0 - ac_prev) / (1.0 - ac)
    arrays = {
        "sqrt_alphas_cumprod": torch.sqrt(ac),
        "sqrt_one_minus_alphas_cumprod": torch.sqrt(1.0 - ac),
        "sqrt_recip_alphas_cumprod": torch.sqrt(1.0 / ac),
        "sqrt_recipm1_alphas_cumprod": torch.sqrt(1.0 / ac - 1),
        "posterior_log_variance_clipped": torch.log(
            torch.cat([pv[1:2], pv[1:]])),
        "posterior_mean_coef1": b * torch.sqrt(ac_prev) / (1.0 - ac),
        "posterior_mean_coef2": (1.0 - ac_prev) * torch.sqrt(alphas)
        / (1.0 - ac),
        "log_betas": torch.log(b),
    }
    return {k: v.float().to(device) for k, v in arrays.items()}


def _normal_kl(mean1, logvar1, mean2, logvar2):
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def _approx_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * torch.pow(x, 3))))


def _discretized_gaussian_log_likelihood(x, means, log_scales):
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = _approx_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = _approx_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    cdf_delta = cdf_plus - cdf_min
    return torch.where(
        x < -0.999, log_cdf_plus,
        torch.where(x > 0.999, log_one_minus_cdf_min,
                    torch.log(cdf_delta.clamp(min=1e-12))))


def per_image_terms(out, x0, xt, t, noise, arr) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """(mse, vb) per image, float32: ``training_losses``' terms."""
    def ex(name):
        return arr[name][t][:, None, None, None]

    c = x0.shape[1]
    eps, v = out[:, :c].float(), out[:, c:].float()
    mse = ((noise - eps) ** 2).mean(dim=(1, 2, 3))
    pred_x0 = (ex("sqrt_recip_alphas_cumprod") * xt
               - ex("sqrt_recipm1_alphas_cumprod") * eps.detach())
    model_mean = (ex("posterior_mean_coef1") * pred_x0
                  + ex("posterior_mean_coef2") * xt)
    min_log = ex("posterior_log_variance_clipped")
    max_log = ex("log_betas")
    frac = (v + 1) / 2
    model_log_variance = frac * max_log + (1 - frac) * min_log
    true_mean = (ex("posterior_mean_coef1") * x0
                 + ex("posterior_mean_coef2") * xt)
    kl = _normal_kl(true_mean, min_log, model_mean, model_log_variance)
    kl = kl.mean(dim=(1, 2, 3)) / math.log(2.0)
    nll = -_discretized_gaussian_log_likelihood(
        x0, model_mean, 0.5 * model_log_variance)
    nll = nll.mean(dim=(1, 2, 3)) / math.log(2.0)
    return mse, torch.where(t == 0, nll, kl)


def res_shapes(cfg: dict, batch: int) -> List[Tuple[int, int, int, int]]:
    """The (B, C, H, W) of each ResBlock's dropout, in block order."""
    inp, mid, out = layout(cfg)
    shapes = []
    for blk in inp + mid + out:
        if blk["type"] == "res":
            side = {"down": blk["res"] // 2, "up": blk["res"] * 2}.get(
                blk["resample"], blk["res"])
            shapes.append((batch, blk["cout"], side, side))
    return shapes


def step_draws(generator, cfg: dict, shape):
    """(t, eps, dropout masks) of a step on images of ``shape``, in the
    program's order."""
    dev, b = generator.device, shape[0]
    t = torch.randint(0, cfg["diffusion_steps"], (b,), generator=generator,
                      device=dev)
    noise = torch.randn(shape, generator=generator, device=dev)
    masks = None
    if cfg["dropout"] > 0.0:
        masks = [torch.rand(s, generator=generator, device=dev)
                 >= 1.0 - cfg["dropout"] for s in res_shapes(cfg, b)]
    return t, noise, masks


def skip_steps(generator, cfg: dict, shape, n: int) -> None:
    """Advances ``generator`` past ``n`` steps' draws, computing nothing."""
    for _ in range(n):
        step_draws(generator, cfg, shape)


def loss_and_grads(params: Tree, x0, y, generator, cfg: dict,
                   prec: Precision = EXACT, fault: str = "",
                   chunk: Optional[int] = None):
    """((L_simple, L_t), gradient list) of one step on ``x0`` with labels
    ``y``, its draws from ``generator``; computed ``chunk`` images at a
    time (all at once by default)."""
    t, noise, masks = step_draws(generator, cfg, x0.shape)
    arr = diffusion_arrays(cfg, x0.device, fault)
    xt = (arr["sqrt_alphas_cumprod"][t][:, None, None, None] * x0
          + arr["sqrt_one_minus_alphas_cumprod"][t][:, None, None, None]
          * noise)
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    it = iter(flat)
    tracked = tree_map(lambda _: next(it), params)
    b = x0.shape[0]
    chunk = chunk or b
    terms = torch.zeros(2, device=x0.device)
    grads = [torch.zeros_like(p) for p in flat]
    for lo in range(0, b, chunk):
        sl = slice(lo, lo + chunk)
        with torch.enable_grad():
            out = forward(tracked, xt[sl], t[sl], y[sl], cfg,
                          None if masks is None else [m[sl] for m in masks],
                          prec, fault)
            mse, vb = per_image_terms(out, x0[sl], xt[sl], t[sl],
                                      noise[sl], arr)
            if fault == "no_vb":
                vb = torch.zeros_like(vb)
            part = torch.stack([mse.sum(), vb.sum()]) / b
            g = torch.autograd.grad(part.sum(), flat, allow_unused=True)
        terms += part.detach()
        for acc, gi in zip(grads, g):
            if gi is not None:
                acc += gi
        del out, mse, vb, part, g
    return terms, grads


def train_steps(state: State, batches: Sequence[Tuple[torch.Tensor,
                                                        torch.Tensor]],
                generator, cfg: dict, tree: Tree, prec: Precision = EXACT,
                update: Optional[Callable] = None, fault: str = "",
                chunk: Optional[int] = None):
    """Adam steps from ``state`` on ``batches`` of (images, labels), their
    draws from ``generator``: (the losses as [L_simple, L_t] a step, the
    state after them). ``tree`` gives the leaves' key paths; ``update``
    stands in for ``adam``."""
    update = update or adam
    losses = []
    for x0, y in batches:
        it = iter(state.params)
        terms, g = loss_and_grads(tree_map(lambda _: next(it), tree), x0, y,
                                  generator, cfg, prec, fault, chunk)
        losses.append([float(v) for v in terms])
        p, m, v = update(state.params, g, state.m, state.v, state.step + 1,
                         cfg["learn_rate"])
        state = State(p, m, v, state.step + 1)
    return losses, state
