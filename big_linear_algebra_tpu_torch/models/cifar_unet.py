"""cifar_unet: the DDPM noise-prediction U-Net (≈ model/cifar_unet.c), the
counterpart of ``big_linear_algebra_tpu/models/cifar_unet.py``.

Architecture (model/cifar_unet.c:26-37,1099-1165): 4 resolutions with embed
dims 128/256/256/256; per resolution two resnet blocks (GN→ReLU→conv3×3 →
+time-dense → GN→ReLU→dropout→conv3×3, plus a 1×1-conv residual when the
channels change); self-attention (key_dim 16) after each resnet at
resolution 2 on the down and up paths and between the mid resnets;
strided-conv downsample; nearest ×2 upsample with a channel-matching conv
only when dims differ (:1130-1133); skip concatenation ``[h, skip]`` from
each down level; output GN→ReLU→conv3×3 → 3 channels. The up_3 wiring is
the JAX package's fixed one (SURVEY.md §7.2).

Verbs:
- ``init``: He/Xavier-uniform parameters from a ``torch.Generator`` seeded
  with ``Config.seed``, written as the reference CSV tree — the files the
  JAX package reads and writes.
- ``train <epochs>``: the DDPM simple loss (Ho et al. alg. 1), its gradient
  through the hand-written backward of every layer, and Adam, one eager step
  per batch of the CIFAR batches (synthesized when absent). bf16 compute
  over f32 stored parameters by default. The train state (parameters, Adam
  moments and step, the generator's state, the epoch) is saved each epoch
  under ``train_state_torch/step_<n>/`` and resumed from there; the CSV
  tree is written at exit.
- ``run [n]``: DDPM ancestral sampling (Ho et al. alg. 2) of n images to
  ``samples/sample_<i>.bmp``, from the port's train state when it is newer
  than the CSV tree.
- ``train --dp``: data parallel over the ranks of the launch
  (``make_train_step_dp``, the JAX package's shard_map DP step): each rank
  steps on its rows of every batch with its own draws, the gradients and
  the loss are averaged over the ranks, every rank applies the same Adam
  update, and rank 0 alone prints and writes. ``--tp`` and the pipeline
  flags wait for the U-Net TP and pipeline slice.
Every draw (DDPM noise and timesteps, dropout masks, sampling noise, the
stochastic-rounding seeds of ``--bf16-params``) comes from one
``torch.Generator`` on the model's device (Philox on a GPU); JAX's
rbg/threefry streams are not reproduced, and the tests inject draws.

At ``--image-size=64`` the four attention sites at resolution 2 (down_2 and
up_3) see 32×32 = 1024 tokens and run the flash kernels (K2 forward,
``csrc/flash_attn.cu``; K2c/K2d backward, ``csrc/flash_attn_bwd.cu``).
With ``--fused-block`` every resnet block at H·W ≤ 64 that the JAX
package's gate admits (``nn/fused_block.py`` ``supported``) runs as one
fused block (K5a forward, K5b recompute backward, ``csrc/fused_block.cu``):
at 32×32 the blocks of down_3, down_4, mid, up_1 and up_2. Its dropout bits
come from a seed the block draws from the generator where the unfused block
draws its mask. Everything else is plain torch (cuDNN convs, cuBLAS
products), as the JAX package leaves it to XLA. Activations are NCHW and
parameters the JAX package's nested dict, with the same keys and layouts.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import re
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from big_linear_algebra_tpu_torch.ckpt import pytree as ckpt_pytree
from big_linear_algebra_tpu_torch.data import bmp as bmp_io
from big_linear_algebra_tpu_torch.data import synth
from big_linear_algebra_tpu_torch.data.cifar10 import (
    Cifar10Batches,
    chw_to_pixels,
    pixels_to_chw,
)
from big_linear_algebra_tpu_torch.data.csv import (
    read_csv_matrix,
    write_csv_matrix,
)
from big_linear_algebra_tpu_torch.data.prefetch import prefetch_to_device
from big_linear_algebra_tpu_torch.models import common
from big_linear_algebra_tpu_torch.nn.attention import self_attention_block
from big_linear_algebra_tpu_torch.nn.conv import conv2d
from big_linear_algebra_tpu_torch.nn import fused_block
from big_linear_algebra_tpu_torch.nn.dropout import dropout
from big_linear_algebra_tpu_torch.nn.init import he_uniform, xavier_uniform
from big_linear_algebra_tpu_torch.nn.losses import mse_loss
from big_linear_algebra_tpu_torch.nn.norm import group_norm
from big_linear_algebra_tpu_torch.nn.optim import (
    AdamState,
    adam_init,
    adam_update,
    tree_leaves,
    tree_map,
)
from big_linear_algebra_tpu_torch.ops.activations import relu
from big_linear_algebra_tpu_torch.parallel import spmd
from big_linear_algebra_tpu_torch.parallel.sharding import batch_sharding

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Config:
    image_size: int = 32                      # IMAGE_HEIGHT/WIDTH, :26-27
    in_channels: int = 3
    embed_dims: tuple = (128, 256, 256, 256)  # RESOLUTION_N_EMBED_DIM, :29-32
    time_embed_dim: int = 512                 # TIME_EMBED_DIM, :33
    kernel_size: int = 3                      # KERNEL_SIZE, :34
    group_size: int = 32                      # GROUP_SIZE, :35
    key_dim: int = 16                         # SELF_ATTENTION_KEY_DIM, :36
    dropout_rate: float = 0.1                 # DROPOUT_RATE, :37
    resize_stride: int = 2                    # RESIZE_STRIDE, :28
    # DDPM schedule (Ho et al. 2020 defaults)
    timesteps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    batch_size: int = 16
    learn_rate: float = 2e-4
    seed: int = 42
    # the JAX package's mixed precision: f32 stored parameters, bf16
    # activations and weights inside the network; "float32" is the
    # full-precision mode and "float64" the CPU parity mode
    compute_dtype: str = "bfloat16"
    # stored-parameter dtype; "bfloat16" with --bf16-params (Adam moments
    # stay f32, writes use stochastic rounding)
    param_dtype: str = "float32"
    # --fused-block: the resnet blocks at H·W ≤ 64 as one fused block (K5)
    fused_block: bool = False


CONFIG = Config()
# Tiny config for CPU tests and fast smoke runs
TINY = Config(embed_dims=(8, 12, 12, 12), time_embed_dim=16, group_size=4,
              key_dim=4, timesteps=8, batch_size=2, image_size=32,
              compute_dtype="float32")


def ckpt_dir() -> Path:
    return common.data_dir() / "cifar_unet"


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _init_resnet(gen, in_ch, out_ch, cfg: Config) -> Params:
    k = cfg.kernel_size
    return {
        "conv_1": he_uniform((out_ch, in_ch, k, k), k * k * in_ch, gen),
        "conv_2": he_uniform((out_ch, out_ch, k, k), k * k * out_ch, gen),
        "conv_3": he_uniform((out_ch, in_ch, 1, 1), in_ch, gen),
        "time_w": he_uniform((cfg.time_embed_dim, out_ch),
                             cfg.time_embed_dim, gen),
        "time_b": torch.zeros((out_ch,), dtype=torch.float32),
    }


def _init_attn(gen, ch, cfg: Config) -> Params:
    kd = cfg.key_dim
    return {
        "q": xavier_uniform((ch, kd), ch, kd, gen),
        "k": xavier_uniform((ch, kd), ch, kd, gen),
        "v": he_uniform((ch, kd), ch, gen),
        "w": he_uniform((kd, ch), kd, gen),
        "b": torch.zeros((ch,), dtype=torch.float32),
    }


def init_params(generator: torch.Generator, cfg: Config = CONFIG) -> Params:
    """The JAX package's tree and distributions (He-uniform with fan_in =
    k²·C_in for convs, Xavier-uniform for q/k, zero biases), drawn on the
    CPU from ``generator``, cast to ``cfg.param_dtype``."""
    d1, d2, d3, d4 = cfg.embed_dims
    k = cfg.kernel_size
    g = generator

    def down_conv(f, c):
        return he_uniform((f, c, k, k), k * k * c, g)

    p: Params = {
        "down_1": {
            "resnet_1": _init_resnet(g, cfg.in_channels, d1, cfg),
            "resnet_2": _init_resnet(g, d1, d1, cfg),
            "conv": down_conv(d2, d1),
        },
        "down_2": {
            "resnet_1": _init_resnet(g, d2, d2, cfg),
            "attn_1": _init_attn(g, d2, cfg),
            "resnet_2": _init_resnet(g, d2, d2, cfg),
            "attn_2": _init_attn(g, d2, cfg),
            "conv": down_conv(d3, d2),
        },
        "down_3": {
            "resnet_1": _init_resnet(g, d3, d3, cfg),
            "resnet_2": _init_resnet(g, d3, d3, cfg),
            "conv": down_conv(d4, d3),
        },
        "down_4": {
            "resnet_1": _init_resnet(g, d4, d4, cfg),
            "resnet_2": _init_resnet(g, d4, d4, cfg),
        },
        "mid": {
            "resnet_1": _init_resnet(g, d4, d4, cfg),
            "attn": _init_attn(g, d4, cfg),
            "resnet_2": _init_resnet(g, d4, d4, cfg),
        },
        "up_1": {
            "resnet_1": _init_resnet(g, 2 * d4, d4, cfg),
            "resnet_2": _init_resnet(g, d4, d4, cfg),
            "conv": down_conv(d3, d4),
        },
        "up_2": {
            "resnet_1": _init_resnet(g, 2 * d3, d3, cfg),
            "resnet_2": _init_resnet(g, d3, d3, cfg),
            "conv": down_conv(d2, d3),
        },
        "up_3": {
            "resnet_1": _init_resnet(g, 2 * d2, d2, cfg),
            "attn_1": _init_attn(g, d2, cfg),
            "resnet_2": _init_resnet(g, d2, d2, cfg),
            "attn_2": _init_attn(g, d2, cfg),
            "conv": down_conv(d1, d2),
        },
        "up_4": {
            "resnet_1": _init_resnet(g, 2 * d1, d1, cfg),
            "resnet_2": _init_resnet(g, d1, d1, cfg),
        },
        "output_conv": down_conv(cfg.in_channels, d1),
    }
    return cast_params(p, cfg)


def cast_params(params: Params, cfg: Config) -> Params:
    """Round a parameter tree to ``cfg.param_dtype``."""
    pdt = getattr(torch, cfg.param_dtype)
    return tree_map(lambda a: a.to(pdt), params)


def params_from_jax(np_tree) -> Params:
    """The JAX package's parameter tree (numpy arrays, same keys and
    layouts) as the port's CPU tensors, dtype kept. Arrays from JAX are
    read-only, so each is copied."""
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)),
                     np_tree)


# ---------------------------------------------------------------------------
# Reference CSV checkpoint tree
# ---------------------------------------------------------------------------


def _kernels_to_rows(k: np.ndarray) -> np.ndarray:
    """(F, C, kh, kw) → (F·C, kh·kw) — the reference _save_conv_kernels
    layout (row i·C+j = kernel [f=i][c=j], model/cifar_unet.c:1520-1538)."""
    f, c, kh, kw = k.shape
    return np.asarray(k).reshape(f * c, kh * kw)


def _rows_to_kernels(rows: np.ndarray, f, c, kh, kw) -> np.ndarray:
    return rows.reshape(f, c, kh, kw)


_ATTN_FILES = {"q": "query.csv", "k": "key.csv", "v": "value.csv",
               "w": "weight.csv"}


def _csv_tree(params: Params) -> Dict[str, np.ndarray]:
    """{relative file: 2-D f32 array} of the reference CSV tree."""
    arrays: Dict[str, np.ndarray] = {}
    p = tree_map(lambda a: a.detach().to("cpu", torch.float32).numpy(),
                  params)

    def resnet(r, prefix):
        for i in (1, 2, 3):
            arrays[f"{prefix}/conv_{i}.csv"] = _kernels_to_rows(r[f"conv_{i}"])
        arrays[f"{prefix}/time_weight.csv"] = r["time_w"]
        arrays[f"{prefix}/time_bias.csv"] = r["time_b"].reshape(1, -1)

    def attn(a, prefix):
        for key, fname in _ATTN_FILES.items():
            arrays[f"{prefix}/{fname}"] = a[key]
        arrays[f"{prefix}/bias.csv"] = a["b"].reshape(1, -1)

    for side in ("down", "up"):
        for lvl in (1, 2, 3, 4):
            grp = p[f"{side}_{lvl}"]
            resnet(grp["resnet_1"], f"{side}_{lvl}/resnet_1")
            resnet(grp["resnet_2"], f"{side}_{lvl}/resnet_2")
            if "conv" in grp:
                arrays[f"{side}_{lvl}/conv_0.csv"] = _kernels_to_rows(
                    grp["conv"])
            if "attn_1" in grp:
                attn(grp["attn_1"], f"{side}_{lvl}/self_attention_1")
                attn(grp["attn_2"], f"{side}_{lvl}/self_attention_2")
        if side == "down":
            resnet(p["mid"]["resnet_1"], "mid/resnet_1")
            attn(p["mid"]["attn"], "mid/self_attention_0")
            resnet(p["mid"]["resnet_2"], "mid/resnet_2")
    arrays["output_conv.csv"] = _kernels_to_rows(p["output_conv"])
    return arrays


def save_params_csv(params: Params, cfg: Config = CONFIG,
                    base: Path | None = None) -> None:
    """Write the reference CSV tree (``%f`` text of the f32 values, the same
    bytes as the JAX package's writer)."""
    base = base or ckpt_dir()
    for rel, arr in _csv_tree(params).items():
        write_csv_matrix(str(base / rel), arr)


def load_params_csv(cfg: Config = CONFIG,
                    base: Path | None = None) -> Params:
    """Read the reference CSV tree written for ``cfg``. ``exact=True``: a
    tree written by another configuration (a full-size checkpoint read
    under --tiny) is a hard error, not a file prefix read as weights."""
    base = base or ckpt_dir()
    d1, d2, d3, d4 = cfg.embed_dims
    k = cfg.kernel_size
    kd = cfg.key_dim

    def mat(rel, rows, cols):
        return torch.from_numpy(read_csv_matrix(str(base / rel), rows, cols,
                                                exact=True))

    def kernels(rel, f, c, kh, kw):
        return mat(rel, f * c, kh * kw).reshape(f, c, kh, kw)

    def resnet(prefix, in_ch, out_ch):
        return {
            "conv_1": kernels(f"{prefix}/conv_1.csv", out_ch, in_ch, k, k),
            "conv_2": kernels(f"{prefix}/conv_2.csv", out_ch, out_ch, k, k),
            "conv_3": kernels(f"{prefix}/conv_3.csv", out_ch, in_ch, 1, 1),
            "time_w": mat(f"{prefix}/time_weight.csv", cfg.time_embed_dim,
                          out_ch),
            "time_b": mat(f"{prefix}/time_bias.csv", 1, out_ch)[0],
        }

    def attn(prefix, ch):
        out = {key: mat(f"{prefix}/{fname}", *((kd, ch) if key == "w"
                                                 else (ch, kd)))
               for key, fname in _ATTN_FILES.items()}
        out["b"] = mat(f"{prefix}/bias.csv", 1, ch)[0]
        return out

    p = {
        "down_1": {"resnet_1": resnet("down_1/resnet_1", cfg.in_channels, d1),
                   "resnet_2": resnet("down_1/resnet_2", d1, d1),
                   "conv": kernels("down_1/conv_0.csv", d2, d1, k, k)},
        "down_2": {"resnet_1": resnet("down_2/resnet_1", d2, d2),
                   "attn_1": attn("down_2/self_attention_1", d2),
                   "resnet_2": resnet("down_2/resnet_2", d2, d2),
                   "attn_2": attn("down_2/self_attention_2", d2),
                   "conv": kernels("down_2/conv_0.csv", d3, d2, k, k)},
        "down_3": {"resnet_1": resnet("down_3/resnet_1", d3, d3),
                   "resnet_2": resnet("down_3/resnet_2", d3, d3),
                   "conv": kernels("down_3/conv_0.csv", d4, d3, k, k)},
        "down_4": {"resnet_1": resnet("down_4/resnet_1", d4, d4),
                   "resnet_2": resnet("down_4/resnet_2", d4, d4)},
        "mid": {"resnet_1": resnet("mid/resnet_1", d4, d4),
                "attn": attn("mid/self_attention_0", d4),
                "resnet_2": resnet("mid/resnet_2", d4, d4)},
        "up_1": {"resnet_1": resnet("up_1/resnet_1", 2 * d4, d4),
                 "resnet_2": resnet("up_1/resnet_2", d4, d4),
                 "conv": kernels("up_1/conv_0.csv", d3, d4, k, k)},
        "up_2": {"resnet_1": resnet("up_2/resnet_1", 2 * d3, d3),
                 "resnet_2": resnet("up_2/resnet_2", d3, d3),
                 "conv": kernels("up_2/conv_0.csv", d2, d3, k, k)},
        "up_3": {"resnet_1": resnet("up_3/resnet_1", 2 * d2, d2),
                 "attn_1": attn("up_3/self_attention_1", d2),
                 "resnet_2": resnet("up_3/resnet_2", d2, d2),
                 "attn_2": attn("up_3/self_attention_2", d2),
                 "conv": kernels("up_3/conv_0.csv", d1, d2, k, k)},
        "up_4": {"resnet_1": resnet("up_4/resnet_1", 2 * d1, d1),
                 "resnet_2": resnet("up_4/resnet_2", d1, d1)},
        "output_conv": kernels("output_conv.csv", cfg.in_channels, d1, k, k),
    }
    return cast_params(p, cfg)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def time_embedding(t: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Sinusoidal timestep embedding (Ho et al. 2020 §B) → ReLU, (B, dim).
    Internals in f32 (f64 in the f64 parity mode, where an f32 seed here
    would perturb the whole net by ~1e-7 and the GN chain amplify it)."""
    half = cfg.time_embed_dim // 2
    dt = torch.float64 if cfg.compute_dtype == "float64" else torch.float32
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=dt, device=t.device)
                      / max(half - 1, 1))
    ang = t.to(dt)[:, None] * freqs[None, :]
    return relu(torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1))


def _gn_relu(x: torch.Tensor, cfg: Config) -> torch.Tensor:
    """The GN→ReLU pair every reference block opens with
    (model/cifar_unet.c:1046-1047)."""
    return relu(group_norm(x, cfg.group_size))


def _resnet_block(x, temb, p, cfg: Config, generator, train: bool):
    """GN→ReLU→conv3×3 → +time → GN→ReLU→dropout→conv3×3 + residual
    (``_forward_resnet``, model/cifar_unet.c:1044-1072). In train mode the
    dropout mask is drawn from ``generator``, so the blocks draw in the JAX
    package's key order (down 0–7, mid 8–9, up 10–17). With
    ``cfg.fused_block`` a block at H·W ≤ 64 that the gate admits is one
    fused block (the JAX package's dispatch), which draws its dropout seed
    from ``generator`` in place of the mask."""
    td = temb @ p["time_w"] + p["time_b"]                # (B, out)
    in_ch, out_ch = x.shape[1], p["conv_1"].shape[0]
    if (cfg.fused_block and x.shape[2] * x.shape[3] <= 64
            and fused_block.supported(x.shape, in_ch, out_ch,
                                      p["conv_1"].shape[-1], cfg.group_size,
                                      x.dtype)):
        seed = 0
        if train and cfg.dropout_rate > 0.0:
            seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                 device=x.device, dtype=torch.int32)
        w3 = p["conv_3"] if in_ch != out_ch else None
        return fused_block.fused_resnet_block(
            x, td, p["conv_1"], p["conv_2"], w3, seed, cfg.group_size,
            cfg.dropout_rate, train)
    h = conv2d(_gn_relu(x, cfg), p["conv_1"], 1)
    h = h + td[:, :, None, None]
    h = _gn_relu(h, cfg)
    h = dropout(h, cfg.dropout_rate, generator, deterministic=not train)
    h = conv2d(h, p["conv_2"], 1)
    return h + (x if in_ch == out_ch else conv2d(x, p["conv_3"], 1))


def _upsample(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Nearest-neighbour ×stride (``_nearest_neighbours``,
    model/cifar_unet.c:1074-1086)."""
    return x.repeat_interleave(stride, dim=2).repeat_interleave(stride, dim=3)


def _down_stage(params, x, temb, cfg: Config, generator, train: bool):
    """Down path (model/cifar_unet.c:1103-1118): the four skip activations
    (skip_4 is also the mid stage's input)."""
    s = cfg.resize_stride

    def block(h, p):
        return _resnet_block(h, temb, p, cfg, generator, train)

    h = block(x, params["down_1"]["resnet_1"])
    skip_1 = block(h, params["down_1"]["resnet_2"])
    h = conv2d(skip_1, params["down_1"]["conv"], s)

    h = block(h, params["down_2"]["resnet_1"])
    h = self_attention_block(h, params["down_2"]["attn_1"])
    h = block(h, params["down_2"]["resnet_2"])
    skip_2 = self_attention_block(h, params["down_2"]["attn_2"])
    h = conv2d(skip_2, params["down_2"]["conv"], s)

    h = block(h, params["down_3"]["resnet_1"])
    skip_3 = block(h, params["down_3"]["resnet_2"])
    h = conv2d(skip_3, params["down_3"]["conv"], s)

    h = block(h, params["down_4"]["resnet_1"])
    skip_4 = block(h, params["down_4"]["resnet_2"])
    return skip_1, skip_2, skip_3, skip_4


def _mid_stage(params, skip_4, temb, cfg: Config, generator, train: bool):
    """Mid: resnet → attention → resnet (model/cifar_unet.c:1121-1123)."""
    h = _resnet_block(skip_4, temb, params["mid"]["resnet_1"], cfg,
                      generator, train)
    h = self_attention_block(h, params["mid"]["attn"])
    return _resnet_block(h, temb, params["mid"]["resnet_2"], cfg, generator,
                         train)


def _up_stage(params, h, skips, temb, cfg: Config, generator, train: bool):
    """Up path + output head (model/cifar_unet.c:1126-1165): ``[h, skip]``
    concatenated along channels (:1088-1097), the channel-matching conv only
    when dims differ, the §7.2 up_3 wiring fixed."""
    skip_1, skip_2, skip_3, skip_4 = skips
    s = cfg.resize_stride
    d1, d2, d3, d4 = cfg.embed_dims

    def block(h, p):
        return _resnet_block(h, temb, p, cfg, generator, train)

    h = torch.cat([h, skip_4], dim=1)
    h = block(h, params["up_1"]["resnet_1"])
    h = block(h, params["up_1"]["resnet_2"])
    h = _upsample(h, s)
    if d4 != d3:
        h = conv2d(h, params["up_1"]["conv"], 1)

    h = torch.cat([h, skip_3], dim=1)
    h = block(h, params["up_2"]["resnet_1"])
    h = block(h, params["up_2"]["resnet_2"])
    h = _upsample(h, s)
    if d3 != d2:
        h = conv2d(h, params["up_2"]["conv"], 1)

    h = torch.cat([h, skip_2], dim=1)
    h = block(h, params["up_3"]["resnet_1"])
    h = self_attention_block(h, params["up_3"]["attn_1"])
    h = block(h, params["up_3"]["resnet_2"])
    h = self_attention_block(h, params["up_3"]["attn_2"])  # §7.2 fixed
    h = _upsample(h, s)
    if d2 != d1:
        h = conv2d(h, params["up_3"]["conv"], 1)

    h = torch.cat([h, skip_1], dim=1)
    h = block(h, params["up_4"]["resnet_1"])
    h = block(h, params["up_4"]["resnet_2"])

    # Output (:1163-1165)
    return conv2d(_gn_relu(h, cfg), params["output_conv"], 1)


def forward(params: Params, x: torch.Tensor, t: torch.Tensor,
            cfg: Config = CONFIG, generator: Optional[torch.Generator] = None,
            train: bool = False) -> torch.Tensor:
    """Full U-Net forward (≈ ``forward``, model/cifar_unet.c:1099-1165).
    x: (B, 3, H, W) in [−1, 1]; t: (B,) timesteps. Params and x are cast to
    ``cfg.compute_dtype`` inside the autograd graph, so gradients arrive on
    the stored parameters in their own dtype (f32 masters under bf16
    compute); the output is in the compute dtype. ``train`` switches
    dropout on, its masks drawn from ``generator``."""
    dt = getattr(torch, cfg.compute_dtype)
    params = tree_map(lambda p: p if p.dtype == dt else p.to(dt), params)
    x = x.to(dt)
    temb = time_embedding(t, cfg).to(dt)
    skips = _down_stage(params, x, temb, cfg, generator, train)
    h = _mid_stage(params, skips[3], temb, cfg, generator, train)
    return _up_stage(params, h, skips, temb, cfg, generator, train)


# ---------------------------------------------------------------------------
# DDPM loss, training step, sampling
# ---------------------------------------------------------------------------


def ddpm_schedule(cfg: Config) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Linear β schedule (f32, CPU): (betas, alphas, alpha_bars)."""
    betas = torch.linspace(cfg.beta_start, cfg.beta_end, cfg.timesteps,
                           dtype=torch.float32)
    alphas = 1.0 - betas
    return betas, alphas, torch.cumprod(alphas, dim=0)


def _ddpm_draws(x0: torch.Tensor, generator: torch.Generator,
                cfg: Config) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step's DDPM draws from ``generator`` on x0's device: timesteps
    t ~ U{0, …, T−1} (B,) and noise ε ~ N(0, 1) in x0's shape and dtype."""
    t = torch.randint(0, cfg.timesteps, (x0.shape[0],), generator=generator,
                      device=x0.device)
    noise = torch.randn(x0.shape, generator=generator, device=x0.device,
                        dtype=x0.dtype)
    return t, noise


def _noised(x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
            cfg: Config) -> torch.Tensor:
    """x_t = √ᾱ_t·x₀ + √(1−ᾱ_t)·ε (the JAX package's ``_ddpm_draws``)."""
    alpha_bars = ddpm_schedule(cfg)[2].to(x0.device)
    ab = alpha_bars[t][:, None, None, None]
    return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise


def loss_fn(params: Params, x0: torch.Tensor, t: torch.Tensor,
            noise: torch.Tensor, cfg: Config = CONFIG,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """DDPM simple loss ‖ε − ε̂(√ᾱ_t·x₀ + √(1−ᾱ_t)·ε, t)‖², as a mean (the
    reference's sum seed normalized like compute_mse_loss,
    model/cifar_unet.c:1858), in ≥ f32. The draws t and ε are arguments, so
    a test can feed the JAX package's; the train-mode forward's dropout
    masks come from ``generator``."""
    pred = forward(params, _noised(x0, t, noise, cfg), t, cfg,
                   generator=generator, train=True)
    acc = torch.promote_types(torch.float32, x0.dtype)
    return mse_loss(pred.to(acc), noise.to(acc)) / math.prod(x0.shape)


def _zero_if_none(grad, p):
    return torch.zeros_like(p) if grad is None else grad


def _loss_and_grads(params: Params, x0: torch.Tensor,
                    generator: torch.Generator, cfg: Config, draws):
    """(loss, gradient tree) of the DDPM loss on x0, the draws (t, noise)
    given or drawn from ``generator``, the dropout masks from it."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    t, noise = draws if draws is not None else _ddpm_draws(x0, generator,
                                                           cfg)
    with torch.enable_grad():
        loss = loss_fn(leaves, x0, t, noise, cfg, generator)
        flat = tree_leaves(leaves)
        grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    # leaves the forward does not use (conv_3 of a block whose channels do
    # not change, the channel-matching convs of equal dims) get zeros, as
    # jax.grad gives them
    return loss.detach(), tree_map(lambda p: _zero_if_none(next(grads), p),
                                   leaves)


def _sr_seed(generator: torch.Generator, cfg: Config):
    """The step's stochastic-rounding seed for bf16 stored parameters (None
    for f32/f64 ones), a uint32 drawn from ``generator``."""
    if cfg.param_dtype != "bfloat16":
        return None
    return torch.randint(0, 2 ** 32, (), generator=generator,
                         device=generator.device)


def _adam(params: Params, grads: Params, opt_state: AdamState, cfg: Config,
          sr_seed):
    with torch.no_grad():
        return adam_update(tree_map(torch.Tensor.detach, params), grads,
                           opt_state, cfg.learn_rate, sr_seed=sr_seed)


def train_step(params: Params, opt_state: AdamState, x0: torch.Tensor,
               generator: torch.Generator, cfg: Config = CONFIG,
               draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One step: the loss and its gradient with respect to every parameter,
    then Adam. ``draws``: (t, noise) to use instead of drawing them from
    ``generator``. With ``--bf16-params`` the stochastic-rounding seed of
    the Adam writes is drawn from ``generator`` after the step's masks.
    Returns (params, opt_state, loss); nothing is updated in place."""
    loss, grads = _loss_and_grads(params, x0, generator, cfg, draws)
    params, opt_state = _adam(params, grads, opt_state, cfg,
                              _sr_seed(generator, cfg))
    return params, opt_state, loss


# ---------------------------------------------------------------------------
# Data parallelism: the JAX package's shard_map DP step
# (models/cifar_unet.py:846-876). Each rank runs its shard of the batch;
# the gradients and the loss are averaged over the ranks.
# ---------------------------------------------------------------------------

_GOLDEN64 = 0x9E3779B97F4A7C15


def rank_generator(step_seed: int, rank: int,
                   device: torch.device) -> torch.Generator:
    """The generator of one rank's draws in one DP step: the step's seed
    with the rank folded in (JAX's ``fold_in(key, axis_index)``)."""
    seed = (step_seed ^ ((rank + 1) * _GOLDEN64)) & (2 ** 63 - 1)
    return torch.Generator(device=device).manual_seed(seed)


def make_train_step_dp(mesh, cfg: Config = CONFIG, axis: str = "data"):
    """DP train step over ``mesh``: x0 is this rank's shard of the batch
    (``batch_sharding``), params and Adam state are replicated.
    ``step(params, opt_state, x0, generator, draws=None)``: ``generator``
    is the replicated stream, the same on every rank (a host generator, so
    that drawing a seed waits for no device). From it the step draws the
    stochastic-rounding seed of ``--bf16-params`` first (JAX's ``_sr_key``
    from the pre-fold key: every rank must round the replicated params
    alike or the replicas part), then a step seed; the rank's generator
    (``rank_generator``) makes its t, noise and dropout masks. ``draws``:
    this rank's (t, noise) instead. The local loss is a mean over the
    shard, so the gradients and the loss are averaged over ``axis``
    (pmean, one all-reduce), and every rank applies the same Adam update.
    Statistically the single-device step at the global batch: each rank
    draws its own timesteps, noise and masks. (JAX's ``make_epoch_step_dp``
    is this step under an XLA scan; the port runs one step per batch.)
    Returns (params, opt_state, loss)."""

    def step(params: Params, opt_state: AdamState, x0: torch.Tensor,
             generator: torch.Generator, draws=None):
        sr_seed = _sr_seed(generator, cfg)
        step_seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                                      device=generator.device))
        local = rank_generator(step_seed, mesh.index(axis), x0.device)
        loss, grads = _loss_and_grads(params, x0, local, cfg, draws)
        mean = spmd.pmean_tree({"grads": grads, "loss": loss}, mesh, axis)
        params, opt_state = _adam(params, mean["grads"], opt_state, cfg,
                                  sr_seed)
        return params, opt_state, mean["loss"]

    return step


def adam_state_from_jax(state) -> AdamState:
    """The JAX package's ``AdamState`` (its leaves as numpy arrays) as the
    port's, on the CPU, dtypes kept."""
    return AdamState(step=int(state.step), m=params_from_jax(state.m),
                     v=params_from_jax(state.v))


def _fit_images(x: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Nearest-neighbour upscale of the stored 32×32 CIFAR records to
    ``cfg.image_size`` (the record format is fixed by the reference,
    lib/cifar10.c:6-13; the network is fully convolutional)."""
    k = cfg.image_size // x.shape[-1]
    if k == 1:
        return x
    return x.repeat_interleave(k, dim=-2).repeat_interleave(k, dim=-1)


def denoise_psnr(params: Params, x0: torch.Tensor,
                 generator: torch.Generator, cfg: Config = CONFIG,
                 timesteps: Optional[tuple] = None) -> torch.Tensor:
    """Sample quality as a number (the DDPM intent of
    model/cifar_unet.c:1936-1938): noise held-out images to x_t, reconstruct
    x̂₀ = (x_t − √(1−ᾱ_t)·ε̂)/√ᾱ_t from one noise prediction, and return
    PSNR(x̂₀, x₀) in dB per timestep (peak-to-peak 2 for [−1, 1] pixels).
    Default timesteps: the schedule's quartiles."""
    if timesteps is None:
        T = cfg.timesteps
        timesteps = tuple(sorted({1, T // 4, T // 2, (3 * T) // 4}))
    bad = [t for t in timesteps if not 0 <= t < cfg.timesteps]
    if bad:
        raise ValueError(f"timesteps {bad} outside [0, {cfg.timesteps})")
    alpha_bars = ddpm_schedule(cfg)[2]
    noise = torch.randn(x0.shape, generator=generator, device=x0.device,
                        dtype=x0.dtype)
    out = []
    with torch.inference_mode():
        for t in timesteps:
            ab = float(alpha_bars[t])
            xt = math.sqrt(ab) * x0 + math.sqrt(1.0 - ab) * noise
            tb = torch.full((x0.shape[0],), t, dtype=torch.int32,
                            device=x0.device)
            eps = forward(params, xt, tb, cfg).float()
            x0_hat = (xt.float() - math.sqrt(1.0 - ab) * eps) / math.sqrt(ab)
            mse = torch.mean((x0_hat - x0.float()) ** 2)
            out.append(10.0 * torch.log10(4.0 / torch.clamp(mse, min=1e-12)))
    return torch.stack(out)


def ddpm_update(x: torch.Tensor, eps: torch.Tensor, t: int,
                z: torch.Tensor, schedule) -> torch.Tensor:
    """One ancestral step x_t → x_{t−1} (the JAX sampler's loop body):
    mean = (x − β/√(1−ᾱ)·ε)/√α, plus √β·z except at t = 0. The
    coefficients are computed in f32 on the host, as the JAX body computes
    them from f32 schedule scalars."""
    betas, alphas, alpha_bars = schedule
    beta, alpha, ab = betas[t], alphas[t], alpha_bars[t]
    mean = (x - float(beta / torch.sqrt(1.0 - ab)) * eps) \
        / float(torch.sqrt(alpha))
    return mean + float(torch.sqrt(beta)) * z if t > 0 else mean


def sample(params: Params, generator: torch.Generator, cfg: Config = CONFIG,
           num_samples: int = 1) -> torch.Tensor:
    """DDPM ancestral sampling (Ho et al. alg. 2) → (n, 3, S, S) f32 in
    [−1, 1], on the device of ``params`` and ``generator``. The initial
    noise and every step's z are drawn from ``generator``."""
    device = generator.device
    dt = getattr(torch, cfg.compute_dtype)
    params = tree_map(lambda p: p.to(device, dt), params)  # cast once
    schedule = ddpm_schedule(cfg)
    shape = (num_samples, cfg.in_channels, cfg.image_size, cfg.image_size)
    x = torch.randn(shape, generator=generator, device=device)
    with torch.inference_mode():
        for i in range(cfg.timesteps):
            t = cfg.timesteps - 1 - i
            tb = torch.full((num_samples,), t, dtype=torch.int32,
                            device=device)
            eps = forward(params, x, tb, cfg).float()
            z = torch.randn(shape, generator=generator, device=device)
            x = ddpm_update(x, eps, t, z, schedule)
    return x.clamp(-1.0, 1.0)


# ---------------------------------------------------------------------------
# CLI verbs
# ---------------------------------------------------------------------------

_STEP_RE = re.compile(r"^step_(\d+)$")


def state_dir() -> Path:
    """The port's train states (``ckpt/pytree.py``)."""
    return ckpt_dir() / "train_state_torch"


def _is_newer(step_dir: Path, csv_file: Path) -> bool:
    """Whether anything in ``step_dir`` is newer than the CSV tree (or the
    tree is missing)."""
    if not csv_file.is_file():
        return True
    mtime = max((p.stat().st_mtime for p in step_dir.rglob("*")),
                default=step_dir.stat().st_mtime)
    return mtime > csv_file.stat().st_mtime


def _newer_train_state(csv_file: Path) -> Optional[Path]:
    """The newest complete orbax ``train_state/step_<n>`` directory of the
    JAX package when it is newer than the CSV tree (or the tree is missing),
    else None — the JAX package would sample from it or resume it."""
    jax_state = ckpt_dir() / "train_state"
    if not jax_state.is_dir():
        return None
    steps = [(int(m.group(1)), p) for p in jax_state.iterdir()
             if (m := _STEP_RE.match(p.name)) and p.is_dir()
             and any(p.iterdir())]
    if not steps:
        return None
    step_dir = max(steps)[1]
    return step_dir if _is_newer(step_dir, csv_file) else None


def _refuse_jax_state(csv_file: Path) -> None:
    state = _newer_train_state(csv_file)
    if state is not None:
        raise RuntimeError(
            f"{state} is newer than the CSV tree in {ckpt_dir()}: the JAX "
            "package would use it, and the port cannot read orbax train "
            "states (its own are under train_state_torch/; the CSV tree is "
            "the format both packages read)")


def _params_for_run(cfg: Config) -> Params:
    """The freshest of the CSV tree (written when ``train`` ends) and the
    port's newest train state (written every epoch, so a run killed mid-
    train leaves only it). Where the JAX package would sample from a newer
    orbax ``train_state``, this raises rather than serve older weights."""
    csv_file = ckpt_dir() / "output_conv.csv"
    _refuse_jax_state(csv_file)
    step = ckpt_pytree.latest_step(state_dir())
    if step is not None and _is_newer(state_dir() / f"step_{step}",
                                      csv_file):
        print(f"sampling from train_state_torch step {step}"
              + ("" if csv_file.is_file() else " (no CSV tree)"))
        state = ckpt_pytree.restore_pytree(state_dir(), step,
                                           map_location="cpu")
        return cast_params(state["params"], cfg)
    return load_params_csv(cfg)


def _cfg_from_flags(flags) -> Config:
    flags = flags or {}
    cfg = TINY if common.presence_flag(flags, "tiny") else CONFIG
    if "batch" in flags:
        cfg = dataclasses.replace(
            cfg, batch_size=common.positive_int_flag(flags, "batch"))
    if "layout" in flags and str(flags["layout"]).upper() != "NCHW":
        # NHWC is rejected by main() with its reason
        raise ValueError(
            f"--layout must be NCHW or NHWC, got {flags['layout']!r}")
    if "image-size" in flags:
        size = common.positive_int_flag(flags, "image-size")
        if size % 32:
            # the model needs a multiple of 8 (three stride-2 stages); the
            # data path also upscales the fixed 32x32 records
            raise ValueError(
                f"--image-size must be a multiple of 32, got {size}")
        cfg = dataclasses.replace(cfg, image_size=size)
    if common.presence_flag(flags, "bf16-params"):
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    if common.presence_flag(flags, "fused-block"):
        cfg = dataclasses.replace(cfg, fused_block=True)
    return cfg


def init(flags=None) -> None:
    cfg = _cfg_from_flags(flags)
    params = init_params(torch.Generator().manual_seed(cfg.seed), cfg)
    save_params_csv(params, cfg)
    print(f"initialized parameters in {ckpt_dir()}")


def _train_state(params, opt_state: AdamState, generator, epoch: int,
                 cfg: Config, device: torch.device, dp: bool) -> dict:
    return {"params": params,
            "opt": {"step": opt_state.step, "m": opt_state.m,
                    "v": opt_state.v},
            "rng": generator.get_state(), "device": device.type,
            "dp": dp, "epoch": epoch, "param_dtype": cfg.param_dtype}


def _resume(state: dict, generator, cfg: Config, device: torch.device,
            dp: bool):
    """(params, opt_state, epoch) from a saved train state, cast to this
    run's parameter dtype (a state written under the other ``--bf16-params``
    setting resumes into this one); the generator continues its stream. A
    ``--dp`` state holds the replicated host stream, whatever the rank
    count: a run with another count of ranks continues it, each rank
    folding its own index into every step's seed."""
    if state.get("dp", False) != dp:
        raise ValueError(
            "the train state was written by a --dp run, whose draws come "
            "from a replicated host generator with each rank's index folded "
            "in; resume it with --dp on two or more ranks (any count)"
            if not dp else
            "the train state was written by a run without --dp, whose draws "
            "come from the device's generator; resume it without --dp")
    if state["device"] != device.type:
        raise ValueError(
            f"the train state was written by a run on {state['device']}; "
            f"its generator state does not fit a {device.type} generator "
            f"(resume with --device={state['device']})")
    pdt = getattr(torch, cfg.param_dtype)
    mdt = torch.promote_types(pdt, torch.float32)
    params = tree_map(lambda a: a.to(device, pdt), state["params"])
    opt = state["opt"]
    opt_state = AdamState(
        step=int(opt["step"]),
        m=tree_map(lambda a: a.to(device, mdt), opt["m"]),
        v=tree_map(lambda a: a.to(device, mdt), opt["v"]))
    generator.set_state(state["rng"].cpu())
    return params, opt_state, int(state["epoch"])


# Most bytes of f32 training records kept on the device for a whole run;
# 174762 CIFAR examples (CIFAR-10 has 50000, 614 MB).
_RESIDENT_BYTES = 2 << 30


def train(num_epochs: int, *args, flags=None) -> int:
    """Train for ``num_epochs`` epochs, resuming the newest train state."""
    flags = flags or {}
    cfg = _cfg_from_flags(flags)
    device = common.device_flag(flags)
    # absent = whole epochs; when given, --max-steps caps each epoch
    max_steps = common.int_flag(flags, "max-steps", default=0, minimum=1)
    keep = common.int_flag(flags, "keep", default=3, minimum=0) or None
    best = common.presence_flag(flags, "keep-best")
    mesh = common.dp_mesh(flags, cfg.batch_size)
    dp = mesh is not None
    if dp:
        device = mesh.device
    rank0 = common.is_rank0()
    data = Cifar10Batches(common.rank0_first(
        lambda: synth.ensure_cifar(str(common.data_dir()))))
    if data.num_examples < cfg.batch_size:
        raise SystemExit(
            f"batch size {cfg.batch_size} exceeds the dataset "
            f"({data.num_examples} examples): no full batch to train on")
    # --dp: the replicated stream is a host generator (make_train_step_dp)
    generator = torch.Generator(device="cpu" if dp else device).manual_seed(
        cfg.seed)
    step0 = ckpt_pytree.latest_step(state_dir())
    csv_file = ckpt_dir() / "output_conv.csv"
    epoch0 = 0
    if step0 is not None:
        params, opt_state, epoch0 = _resume(
            ckpt_pytree.restore_pytree(state_dir(), step0, device), generator,
            cfg, device, dp)
        if rank0:
            print(f"resumed train state at step {opt_state.step} "
                  f"(epoch {epoch0})")
    else:
        _refuse_jax_state(csv_file)
        if csv_file.is_file():
            params = load_params_csv(cfg)
        else:
            if rank0:
                print("no checkpoint found; initializing")
            params = init_params(torch.Generator().manual_seed(cfg.seed),
                                 cfg)
        params = tree_map(lambda a: a.to(device), params)
        opt_state = adam_init(params)
    # rank 0 alone writes the train states and the CSV tree, and logs
    manager = ckpt_pytree.TrainCheckpointer(
        state_dir(), max_to_keep=keep,
        best_metric="loss" if best else None) if rank0 else None
    logger = common.MetricsLogger(flags.get("jsonl") or None, enabled=rank0)
    rng = np.random.default_rng([cfg.seed, epoch0])
    b, n_ex = cfg.batch_size, data.num_examples
    step = (make_train_step_dp(mesh, cfg) if dp
            else functools.partial(train_step, cfg=cfg))
    # each rank's rows of every batch (all of them without --dp)
    lo, hi = batch_sharding(mesh).bounds(b) if dp else (0, b)
    # The JAX package's 2 GiB rule, applied to the copy the port keeps on
    # the device: the 32x32 records in f32 (each batch is upscaled after
    # it is drawn). A larger set streams through pinned host memory two
    # batches ahead. Both walk rng.permutation per epoch.
    resident = data.pixels.size * 4 < _RESIDENT_BYTES
    if resident:
        data_dev = torch.from_numpy(pixels_to_chw(data.pixels)).to(device)
    for epoch in range(epoch0, epoch0 + num_epochs):
        t0 = time.perf_counter()
        if resident:
            perm = torch.from_numpy(rng.permutation(n_ex)).to(device)
            batches = (data_dev[perm[i + lo:i + hi]]
                       for i in range(0, (n_ex // b) * b, b))
        else:
            batches = prefetch_to_device(
                (x[lo:hi] for _, x in data.epoch_batches(rng, b)), device)
        losses = []
        for step_i, x0 in enumerate(batches):
            if max_steps and step_i >= max_steps:
                break
            params, opt_state, loss = step(params, opt_state,
                                           _fit_images(x0, cfg), generator)
            losses.append(loss)
        losses = torch.stack(losses).float().cpu().numpy()
        dt = time.perf_counter() - t0
        avg = float(losses.mean())
        logger.log(epoch=epoch, avg_loss=avg, epoch_seconds=dt,
                   images_per_sec=losses.size * b / dt, step=opt_state.step)
        if rank0:
            manager.save(opt_state.step,
                         _train_state(params, opt_state, generator,
                                      epoch + 1, cfg, device, dp),
                         metrics={"loss": avg})
    if rank0:
        save_params_csv(params, cfg)
    common.dp_done(mesh)
    logger.close()
    return 0


def run(num_predictions: int = 1, flags=None) -> None:
    """Sample images and write BMPs (the reference's intended ``run``)."""
    flags = flags or {}
    cfg = _cfg_from_flags(flags)
    seed = common.int_flag(flags, "sample-seed", default=0,
                           minimum=-(2 ** 62))
    device = common.device_flag(flags)
    # -1 = the reference's "whole set" convention → one sample here
    n = 1 if num_predictions < 1 else num_predictions
    params = _params_for_run(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    imgs = sample(params, gen, cfg, n).cpu().numpy()
    out_dir = ckpt_dir() / "samples"
    for i in range(n):
        pix = chw_to_pixels(imgs[i]).reshape(3, cfg.image_size,
                                             cfg.image_size)
        # flip rows: BMP renders bottom-up (lib/cifar10.c:19-30)
        path = out_dir / f"sample_{i}.bmp"
        bmp_io.write_bmp(str(path), pix[0][::-1], pix[1][::-1], pix[2][::-1])
        print(f"wrote {path}")


def main(argv=None) -> int:
    return common.run_cli(
        "cifar_unet", init, train, run, argv=argv,
        train_usage="train <num epochs>",
        run_usage="run [<num samples> (default 1)]",
        extra_flags=("tiny", "image-size", "sample-seed", "bf16-params",
                     "layout", "batch", "max-steps", "keep", "keep-best",
                     "jsonl", "fused-block", "dp"),
        unsupported_flags={
            "layout=NHWC": "the channels-last twins are not ported yet "
                           "(ROADMAP: one code path on torch.channels_last)",
            "prng": "the port draws from torch.Generator (Philox on the "
                    "GPU); rbg/threefry are JAX's generators",
            "remat": "torch.utils.checkpoint restores only the global RNG "
                     "states, not the explicit torch.Generator the dropout "
                     "masks come from, so recomputed masks would differ "
                     "from the forward's; it waits for a port that "
                     "handles that",
            **{f: common.XLA_DISPATCH_MODE
               for f in ("scan-steps", "scan-unroll", "host-loop")},
            **{f: common.PARALLEL_NOT_PORTED
               for f in ("tp", "pp", "pp-micro", "pp-schedule")},
        })


if __name__ == "__main__":
    raise SystemExit(main())
