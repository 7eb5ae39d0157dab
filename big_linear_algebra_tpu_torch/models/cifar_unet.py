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
  through the hand-written backward of every layer, and Adam, one step per
  batch of the CIFAR batches (synthesized when absent), replayed from a
  CUDA graph or eager (below). bf16 compute
  over f32 stored parameters by default. The train state (parameters, Adam
  moments and step, the generator's state, the epoch) is saved each epoch
  under ``train_state_torch/step_<n>/`` and resumed from there; the CSV
  tree is written at exit.
- ``run [n]``: DDPM ancestral sampling (Ho et al. alg. 2) of n images to
  ``samples/sample_<i>.bmp``, from the port's train state when it is newer
  than the CSV tree.
- ``train --dp``: data parallel over the ranks of the launch
  (``make_train_step_dp``, the JAX package's shard_map DP step, and its
  epoch, ``make_epoch_step_dp``, as ``TrainSteps`` with a mesh): each rank
  steps on its rows of every batch with its own draws (``DPGenerators``,
  on its device), the gradients and the loss are averaged over the ranks,
  every rank applies the same Adam update, and rank 0 alone prints and
  writes.
- ``train --tp``: tensor parallel over every rank of the launch
  (``place_tp``, ``make_train_step_tp``): each sharded conv computes its
  rank's output channels, which are gathered before the group norm; the
  step is the single-device step, its draws included.
- ``train --pp [--pp-micro=n] [--pp-schedule=gpipe|1f1b] [--dp]``: the
  down, mid and up stages on three ranks (``make_train_step_pp``,
  ``parallel/pipeline.py``), n microbatches a batch; with ``--dp`` at six
  or more ranks a ``stage 3 × data n`` mesh.
- ``--layout=NHWC`` (``Config.layout``): every map channels-last inside
  the net (``conv2d_nhwc``, ``group_norm_nhwc``,
  ``self_attention_block_nhwc``), one transpose at entry and one at exit;
  ``--remat`` (``Config.remat``): each resnet block recomputed in the
  backward from its inputs, its draws replayed (``_recomputed``). Both
  reach ``run``, ``train`` and every parallel mode.
- The JAX package's XLA dispatch modes as replayed CUDA graphs
  (``utils/graphs.py``): ``train`` runs a whole epoch as ``epoch_step``
  (graphs of ``Config.scan_unroll`` steps, ``--scan-unroll=U``),
  ``--scan-steps=K`` as ``train_chunk``'s K steps a replay, and
  ``--host-loop`` one eager step per batch, by the JAX package's rules
  (``train``); ``run`` samples through a graph of the denoising step.
  ``--dp`` and ``--tp`` (``--tp --scan-steps=K`` too) capture their
  collectives in the graph when the ranks run over NCCL, one card each;
  ranks that share a card (gloo), ``--pp`` (one step a dispatch in the
  JAX package too), ``--debug-nans`` and ``--disable-jit`` run eager
  steps. Not ported: ``--prng``, which ``main`` rejects with its reason.
Every draw (DDPM noise and timesteps, dropout masks, sampling noise, the
stochastic-rounding seeds of ``--bf16-params``) comes from one
``torch.Generator`` on the model's device (Philox on a GPU; under
``--dp`` two a rank, ``DPGenerators``); JAX's rbg/threefry streams are
not reproduced, and the tests inject draws.

At ``--image-size=64`` the four attention sites at resolution 2 (down_2 and
up_3) see 32×32 = 1024 tokens and run the flash kernels (K2 forward,
``csrc/flash_attn.cu``; K2c/K2d backward, ``csrc/flash_attn_bwd.cu``).
With ``--fused-block`` every resnet block at H·W ≤ 64 that the JAX
package's gate admits (``nn/fused_block.py`` ``supported``) runs as one
fused block (K5a forward, K5b recompute backward, ``csrc/fused_block.cu``):
at 32×32 the blocks of down_3, down_4, mid, up_1 and up_2. Its dropout bits
come from a seed the block draws from the generator where the unfused block
draws its mask. Everything else is plain torch (cuDNN convs, cuBLAS
products), as the JAX package leaves it to XLA. Activations are NCHW (NHWC
inside the net under ``--layout=NHWC``) and parameters the JAX package's
nested dict, with the same keys and layouts.
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
import torch.utils.checkpoint

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
from big_linear_algebra_tpu_torch.nn.attention import (
    self_attention_block,
    self_attention_block_nhwc,
)
from big_linear_algebra_tpu_torch.nn.conv import conv2d, conv2d_nhwc
from big_linear_algebra_tpu_torch.nn import fused_block
from big_linear_algebra_tpu_torch.nn.dropout import dropout, dropout_mask
from big_linear_algebra_tpu_torch.nn.init import he_uniform, xavier_uniform
from big_linear_algebra_tpu_torch.nn.losses import mse_loss
from big_linear_algebra_tpu_torch.nn.norm import group_norm, group_norm_nhwc
from big_linear_algebra_tpu_torch.nn.optim import (
    AdamState,
    adam_init,
    adam_update,
    adam_update_at,
    adam_update_at_,
    bias_corrections,
    tree_leaves,
    tree_map,
)
from big_linear_algebra_tpu_torch.ops.activations import relu
from big_linear_algebra_tpu_torch.parallel import spmd
from big_linear_algebra_tpu_torch.parallel.pipeline import (
    assemble_grads,
    fold_generator,
    fold_seed,
    gpipe_hetero,
    gpipe_hetero_1f1b,
    pipeline_plan,
)
from big_linear_algebra_tpu_torch.parallel.sharding import (
    BatchShard,
    batch_sharding,
)
from big_linear_algebra_tpu_torch.utils import debug, graphs, trace

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
    # --layout: the maps inside the net, "NCHW" or "NHWC" (channels-last,
    # transposed once at entry and exit; inputs, outputs and parameters
    # keep their layouts either way)
    layout: str = "NCHW"
    # --remat: each resnet block recomputed in the backward from its
    # inputs (its activations are not kept), its draws replayed
    remat: bool = False
    # steps in one CUDA graph of the device epoch (and of the sampler's
    # loop), the JAX package's lax.scan unroll factor: --scan-unroll=U
    scan_unroll: int = 4


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


def _gn_relu(x: torch.Tensor, cfg: Config, nhwc: bool = False
             ) -> torch.Tensor:
    """The GN→ReLU pair every reference block opens with
    (model/cifar_unet.c:1046-1047)."""
    return relu((group_norm_nhwc if nhwc else group_norm)(x, cfg.group_size))


@dataclasses.dataclass(frozen=True)
class _Shard:
    """A weight of the TP forward (``forward(..., tp=...)``): this rank's
    slice ``local`` along ``dim`` of a leaf of full ``shape``, whose slices
    the ranks of ``mesh``'s ``axis`` hold in axis order."""
    local: torch.Tensor
    dim: int
    shape: torch.Size
    mesh: Any
    axis: str

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """x, computed from this slice, gathered along ``dim`` over the
        axis (backward: the cotangent summed over the axis, then sliced)."""
        return spmd.all_gather(x, self.mesh, self.axis, dim)


def _local(w):
    return w.local if isinstance(w, _Shard) else w


def _full(w):
    """The whole weight: a sharded one gathered."""
    return w.gather(w.local, w.dim) if isinstance(w, _Shard) else w


def _conv(x: torch.Tensor, w, stride: int, add=None,
          nhwc: bool = False) -> torch.Tensor:
    """``conv2d`` (``conv2d_nhwc`` with ``nhwc``) plus ``add`` (B, F) on
    every position when given. A sharded kernel computes this rank's
    output channels (and ``add`` is their slice); the full activation is
    then gathered along the channels, so everything after it sees whole
    activations (the column-parallel GEMM GSPMD makes of JAX's conv)."""
    y = (conv2d_nhwc if nhwc else conv2d)(x, _local(w), stride)
    if add is not None:
        y = y + (add[:, None, None, :] if nhwc else add[:, :, None, None])
    return w.gather(y, -1 if nhwc else 1) if isinstance(w, _Shard) else y


class _Draws:
    """A block's draws under ``--remat``: on the block's first run each is
    drawn from ``generator`` and kept; when the block is recomputed they
    are handed back in the same order. Only the draws are kept (a dropout
    mask as bool, a fused block's seed), which the plain step's autograd
    keeps too; nothing is read to the host and no generator state is
    copied, so a CUDA graph can capture the step."""

    def __init__(self, generator):
        self.generator = generator
        self.kept = []
        self.replay = None

    def draw(self, fn):
        """``fn(generator)``, or on a recompute the draw it gave."""
        if self.replay is not None:
            return next(self.replay)
        out = fn(self.generator)
        self.kept.append(out)
        return out

    def rewind(self) -> None:
        self.replay = iter(self.kept)


def _draw(generator, fn):
    """``fn(generator)``: a block's draw, through ``_Draws`` under
    ``--remat``."""
    return generator.draw(fn) if isinstance(generator, _Draws) \
        else fn(generator)


def _dropout(h: torch.Tensor, cfg: Config, generator, train: bool,
             nhwc: bool) -> torch.Tensor:
    """The block's dropout. An NHWC map's mask is drawn in the logical
    NCHW order and permuted, so that both layouts consume ``generator``
    alike and drop the same elements (the JAX package draws in the
    activation's own layout, so its two layouts drop different ones)."""
    x = h.permute(0, 3, 1, 2) if nhwc else h
    if isinstance(generator, _Draws) and train and cfg.dropout_rate > 0.0:
        drop = generator.draw(lambda g: dropout_mask(
            x.shape, cfg.dropout_rate, g, x.device))
        out = dropout(x, cfg.dropout_rate, None, drop=drop)
    else:
        out = dropout(x, cfg.dropout_rate, generator,
                      deterministic=not train)
    return out.permute(0, 2, 3, 1) if nhwc else out


def _recomputed(body, generator, *args):
    """``body(*args, draws)`` under ``torch.utils.checkpoint``: its
    activations are dropped after the forward and recomputed from ``args``
    when the backward reaches them. The block draws through ``_Draws``
    (``draws``): from ``generator`` in the forward, and the same masks
    (and fused-block seeds) again in the recompute, while ``generator``
    advances only as the plain forward advances it. The graph is the plain
    one, so the step is bit-equal to the step without recompute. The
    recompute runs the whole body (no early stop), so under TP every rank
    replays every gather."""
    draws = _Draws(generator)
    calls = 0

    def run(*a):
        nonlocal calls
        if calls:
            draws.rewind()
        calls += 1
        return body(*a, draws)

    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        return torch.utils.checkpoint.checkpoint(
            run, *args, use_reentrant=False, preserve_rng_state=False)


def _resnet_block(x, temb, p, cfg: Config, generator, train: bool,
                  nhwc: bool = False):
    """GN→ReLU→conv3×3 → +time → GN→ReLU→dropout→conv3×3 + residual
    (``_forward_resnet``, model/cifar_unet.c:1044-1072). In train mode the
    dropout mask is drawn from ``generator``, so the blocks draw in the JAX
    package's key order (down 0–7, mid 8–9, up 10–17). With
    ``cfg.fused_block`` a block at H·W ≤ 64 that the gate admits is one
    fused block (the JAX package's dispatch; NCHW only, as there), which
    draws its dropout seed from ``generator`` in place of the mask. Under
    TP the time dense computes this rank's channels of ``td``, added to the
    conv's own channels; a fused block gathers its kernels and ``td`` and
    runs whole on every rank (GSPMD has no partitioning rule for a
    ``pallas_call``). With ``cfg.remat``, while autograd records, the block
    is recomputed in the backward (``_recomputed``)."""
    if cfg.remat and torch.is_grad_enabled():
        return _recomputed(_resnet_block_body, generator, x, temb, p, cfg,
                           train, nhwc)
    return _resnet_block_body(x, temb, p, cfg, train, nhwc, generator)


def _resnet_block_body(x, temb, p, cfg: Config, train: bool, nhwc: bool,
                       generator):
    td = temb @ _local(p["time_w"]) + _local(p["time_b"])  # (B, out)
    in_ch = x.shape[-1] if nhwc else x.shape[1]
    out_ch = p["conv_1"].shape[0]
    if (cfg.fused_block and not nhwc and x.shape[2] * x.shape[3] <= 64
            and fused_block.supported(x.shape, in_ch, out_ch,
                                      p["conv_1"].shape[-1], cfg.group_size,
                                      x.dtype)):
        seed = 0
        if train and cfg.dropout_rate > 0.0:
            seed = _draw(generator, lambda g: torch.randint(
                0, 2 ** 31 - 1, (1,), generator=g, device=x.device,
                dtype=torch.int32))
        if isinstance(p["time_w"], _Shard):
            td = p["time_w"].gather(td, 1)
        w3 = _full(p["conv_3"]) if in_ch != out_ch else None
        return fused_block.fused_resnet_block(
            x, td, _full(p["conv_1"]), _full(p["conv_2"]), w3, seed,
            cfg.group_size, cfg.dropout_rate, train)
    h = _conv(_gn_relu(x, cfg, nhwc), p["conv_1"], 1, add=td, nhwc=nhwc)
    h = _gn_relu(h, cfg, nhwc)
    h = _dropout(h, cfg, generator, train, nhwc)
    h = _conv(h, p["conv_2"], 1, nhwc=nhwc)
    return h + (x if in_ch == out_ch
                else _conv(x, p["conv_3"], 1, nhwc=nhwc))


def _upsample(x: torch.Tensor, stride: int, nhwc: bool = False
              ) -> torch.Tensor:
    """Nearest-neighbour ×stride (``_nearest_neighbours``,
    model/cifar_unet.c:1074-1086)."""
    h, w = (1, 2) if nhwc else (2, 3)
    return x.repeat_interleave(stride, dim=h).repeat_interleave(stride, dim=w)


def _down_stage(params, x, temb, cfg: Config, generator, train: bool,
                nhwc: bool = False):
    """Down path (model/cifar_unet.c:1103-1118): the four skip activations
    (skip_4 is also the mid stage's input), in the net's layout."""
    s = cfg.resize_stride
    attn = self_attention_block_nhwc if nhwc else self_attention_block

    def block(h, p):
        return _resnet_block(h, temb, p, cfg, generator, train, nhwc)

    def down(h, w):
        return _conv(h, w, s, nhwc=nhwc)

    h = block(x, params["down_1"]["resnet_1"])
    skip_1 = block(h, params["down_1"]["resnet_2"])
    h = down(skip_1, params["down_1"]["conv"])

    h = block(h, params["down_2"]["resnet_1"])
    h = attn(h, params["down_2"]["attn_1"])
    h = block(h, params["down_2"]["resnet_2"])
    skip_2 = attn(h, params["down_2"]["attn_2"])
    h = down(skip_2, params["down_2"]["conv"])

    h = block(h, params["down_3"]["resnet_1"])
    skip_3 = block(h, params["down_3"]["resnet_2"])
    h = down(skip_3, params["down_3"]["conv"])

    h = block(h, params["down_4"]["resnet_1"])
    skip_4 = block(h, params["down_4"]["resnet_2"])
    return skip_1, skip_2, skip_3, skip_4


def _mid_stage(params, skip_4, temb, cfg: Config, generator, train: bool,
               nhwc: bool = False):
    """Mid: resnet → attention → resnet (model/cifar_unet.c:1121-1123)."""
    attn = self_attention_block_nhwc if nhwc else self_attention_block
    h = _resnet_block(skip_4, temb, params["mid"]["resnet_1"], cfg,
                      generator, train, nhwc)
    h = attn(h, params["mid"]["attn"])
    return _resnet_block(h, temb, params["mid"]["resnet_2"], cfg, generator,
                         train, nhwc)


def _up_stage(params, h, skips, temb, cfg: Config, generator, train: bool,
              nhwc: bool = False):
    """Up path + output head (model/cifar_unet.c:1126-1165): ``[h, skip]``
    concatenated along channels (:1088-1097), the channel-matching conv only
    when dims differ, the §7.2 up_3 wiring fixed."""
    skip_1, skip_2, skip_3, skip_4 = skips
    s = cfg.resize_stride
    d1, d2, d3, d4 = cfg.embed_dims
    attn = self_attention_block_nhwc if nhwc else self_attention_block
    ch = -1 if nhwc else 1

    def block(h, p):
        return _resnet_block(h, temb, p, cfg, generator, train, nhwc)

    def up(h, w, d_in, d_out):
        h = _upsample(h, s, nhwc)
        return _conv(h, w, 1, nhwc=nhwc) if d_in != d_out else h

    h = torch.cat([h, skip_4], dim=ch)
    h = block(h, params["up_1"]["resnet_1"])
    h = block(h, params["up_1"]["resnet_2"])
    h = up(h, params["up_1"]["conv"], d4, d3)

    h = torch.cat([h, skip_3], dim=ch)
    h = block(h, params["up_2"]["resnet_1"])
    h = block(h, params["up_2"]["resnet_2"])
    h = up(h, params["up_2"]["conv"], d3, d2)

    h = torch.cat([h, skip_2], dim=ch)
    h = block(h, params["up_3"]["resnet_1"])
    h = attn(h, params["up_3"]["attn_1"])
    h = block(h, params["up_3"]["resnet_2"])
    h = attn(h, params["up_3"]["attn_2"])  # §7.2 fixed
    h = up(h, params["up_3"]["conv"], d2, d1)

    h = torch.cat([h, skip_1], dim=ch)
    h = block(h, params["up_4"]["resnet_1"])
    h = block(h, params["up_4"]["resnet_2"])

    # Output (:1163-1165)
    return _conv(_gn_relu(h, cfg, nhwc), params["output_conv"], 1, nhwc=nhwc)


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → a contiguous (B, H, W, C): channels-last memory."""
    return x.permute(0, 2, 3, 1).contiguous()


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → its (B, C, H, W) view (no copy)."""
    return x.permute(0, 3, 1, 2)


def forward(params: Params, x: torch.Tensor, t: torch.Tensor,
            cfg: Config = CONFIG, generator: Optional[torch.Generator] = None,
            train: bool = False, tp=None) -> torch.Tensor:
    """Full U-Net forward (≈ ``forward``, model/cifar_unet.c:1099-1165).
    x: (B, 3, H, W) in [−1, 1]; t: (B,) timesteps. Params and x are cast to
    ``cfg.compute_dtype`` inside the autograd graph, so gradients arrive on
    the stored parameters in their own dtype (f32 masters under bf16
    compute); the output is in the compute dtype. ``train`` switches
    dropout on, its masks drawn from ``generator``. ``tp``: a ``TPLayout``
    when ``params`` are this rank's TP slices (``place_tp``); the sharded
    convs then compute their own channels and gather them. Under
    ``cfg.layout == "NHWC"`` x is transposed once at entry and the output
    is a (B, 3, H, W) view of the channels-last result."""
    dt = getattr(torch, cfg.compute_dtype)
    params = tree_map(lambda p: p if p.dtype == dt else p.to(dt), params)
    if tp is not None:
        params = tp.mark(params)
    nhwc = cfg.layout == "NHWC"
    x = _to_nhwc(x.to(dt)) if nhwc else x.to(dt)
    temb = time_embedding(t, cfg).to(dt)
    skips = _down_stage(params, x, temb, cfg, generator, train, nhwc)
    h = _mid_stage(params, skips[3], temb, cfg, generator, train, nhwc)
    out = _up_stage(params, h, skips, temb, cfg, generator, train, nhwc)
    return _to_nchw(out) if nhwc else out


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


@functools.lru_cache(maxsize=8)
def _schedule_on(schedule_fn, cfg: Config, device: torch.device):
    return tuple(a.to(device) for a in schedule_fn(cfg))


def device_schedule(cfg: Config, device) -> Tuple[torch.Tensor, ...]:
    """``ddpm_schedule(cfg)`` on ``device``, copied there once per (cfg,
    device): a step reads it without a copy from the host, which a CUDA
    graph could not replay. (The cache is keyed by the schedule function
    too, so that a test's replacement of ``ddpm_schedule`` takes effect.)"""
    return _schedule_on(ddpm_schedule, cfg, torch.device(device))


def _noised(x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
            cfg: Config) -> torch.Tensor:
    """x_t = √ᾱ_t·x₀ + √(1−ᾱ_t)·ε (the JAX package's ``_ddpm_draws``)."""
    alpha_bars = device_schedule(cfg, x0.device)[2]
    ab = alpha_bars[t][:, None, None, None]
    return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise


def loss_fn(params: Params, x0: torch.Tensor, t: torch.Tensor,
            noise: torch.Tensor, cfg: Config = CONFIG,
            generator: Optional[torch.Generator] = None,
            tp=None) -> torch.Tensor:
    """DDPM simple loss ‖ε − ε̂(√ᾱ_t·x₀ + √(1−ᾱ_t)·ε, t)‖², as a mean (the
    reference's sum seed normalized like compute_mse_loss,
    model/cifar_unet.c:1858), in ≥ f32. The draws t and ε are arguments, so
    a test can feed the JAX package's; the train-mode forward's dropout
    masks come from ``generator``; ``tp`` as in ``forward``."""
    pred = forward(params, _noised(x0, t, noise, cfg), t, cfg,
                   generator=generator, train=True, tp=tp)
    acc = torch.promote_types(torch.float32, x0.dtype)
    return mse_loss(pred.to(acc), noise.to(acc)) / math.prod(x0.shape)


def _zero_if_none(grad, p):
    return torch.zeros_like(p) if grad is None else grad


def _loss_and_grads(params: Params, x0: torch.Tensor,
                    generator: torch.Generator, cfg: Config, draws,
                    tp=None):
    """(loss, gradient tree) of the DDPM loss on x0, the draws (t, noise)
    given or drawn from ``generator``, the dropout masks from it. ``tp``:
    the ``TPLayout`` of TP slices ``params``; every rank of the model axis
    then holds the whole loss, and each ``all_gather``'s backward sums the
    ranks' cotangents, so loss/n is differentiated: a sharded leaf's
    gradient is then exact, and a replicated leaf's is summed over the
    axis (each rank holds a share of it)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with trace.phase("forward", x0):
        t, noise = draws if draws is not None else _ddpm_draws(
            x0, generator, cfg)
        with torch.enable_grad():
            loss = loss_fn(leaves, x0, t, noise, cfg, generator, tp)
    with trace.phase("backward", x0):
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(
                loss if tp is None else loss / tp.n, tree_leaves(leaves),
                allow_unused=True))
        # leaves the forward does not use (conv_3 of a block whose channels
        # do not change, the channel-matching convs of equal dims) get
        # zeros, as jax.grad gives them
        grads = tree_map(lambda p: _zero_if_none(next(grads), p), leaves)
        if tp is not None:
            grads = tp.sum_replicated(grads)
    return loss.detach(), grads


def _sr_seed(generator: torch.Generator, cfg: Config):
    """The step's stochastic-rounding seed for bf16 stored parameters (None
    for f32/f64 ones), a uint32 drawn from ``generator``."""
    if cfg.param_dtype != "bfloat16":
        return None
    return torch.randint(0, 2 ** 32, (), generator=generator,
                         device=generator.device)


def _adam(params: Params, grads: Params, opt_state: AdamState, cfg: Config,
          sr_seed, sr_index=None):
    with torch.no_grad(), trace.phase("adam", tree_leaves(params)[0]):
        return adam_update(tree_map(torch.Tensor.detach, params), grads,
                           opt_state, cfg.learn_rate, sr_seed=sr_seed,
                           sr_index=sr_index)


def _step_grads(params: Params, x0: torch.Tensor, generator, cfg: Config,
                draws=None, mesh=None, tp=None, axis: str = "data"):
    """What a train step hands Adam: (loss, gradients, the
    ``--bf16-params`` rounding seed, the rounding's element indices). One
    device: the draws from ``generator``, then the seed. ``tp`` (a
    ``TPLayout``): the same on this rank's slices, which round with their
    full leaves' indices. ``mesh`` (DP over its ``axis``): ``generator`` is
    the rank's ``DPGenerators``; the seed from the replicated stream, the
    draws from the rank's, the gradients and the loss averaged over the
    axis (one all-reduce)."""
    if mesh is not None:
        sr_seed = _sr_seed(generator.replicated, cfg)
        loss, grads = _loss_and_grads(params, x0, generator.rank, cfg, draws)
        mean = spmd.pmean_tree({"grads": grads, "loss": loss}, mesh, axis)
        return mean["loss"], mean["grads"], sr_seed, None
    loss, grads = _loss_and_grads(params, x0, generator, cfg, draws, tp)
    sr_seed = _sr_seed(generator, cfg)
    index = (tp.sr_index(params) if tp is not None and sr_seed is not None
             else None)
    return loss, grads, sr_seed, index


def train_step(params: Params, opt_state: AdamState, x0: torch.Tensor,
               generator: torch.Generator, cfg: Config = CONFIG,
               draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One step: the loss and its gradient with respect to every parameter,
    then Adam. ``draws``: (t, noise) to use instead of drawing them from
    ``generator``. With ``--bf16-params`` the stochastic-rounding seed of
    the Adam writes is drawn from ``generator`` after the step's masks.
    Returns (params, opt_state, loss); nothing is updated in place."""
    loss, grads, sr_seed, _ = _step_grads(params, x0, generator, cfg, draws)
    params, opt_state = _adam(params, grads, opt_state, cfg, sr_seed)
    return params, opt_state, loss


# ---------------------------------------------------------------------------
# Many steps a dispatch: the JAX package's lax.scan over train steps
# (train_chunk, epoch_step; models/cifar_unet.py:789-836) as a replayed CUDA
# graph (utils/graphs.py).
# ---------------------------------------------------------------------------


class TrainSteps:
    """Train steps over static buffers, replayed as a CUDA graph of
    ``unroll`` steps (default ``cfg.scan_unroll``) on the card and run
    eagerly on the CPU, under the debug modes and over gloo: the state of
    the JAX package's scanned steps.

    It holds the parameters and Adam moments (copies of those given), the
    batch indices of the steps ahead, their bias corrections
    (``nn/optim.py`` ``bias_corrections``), a device step counter and the
    losses. A step gathers its batch from ``data`` (N, 3, 32, 32) on the
    card, row ``counter`` of the indices; runs ``train_step``'s loss,
    gradient and Adam update, its draws from ``generator`` in the same
    order; records its loss; and advances the counter. With f32
    parameters on the card Adam updates the buffers in place
    (``adam_update_at_``, one hand-written pass); elsewhere (the CPU,
    f64, ``--bf16-params``' stochastic rounding) it is
    ``adam_update_at``, the new parameters and moments copied back. A
    replayed step is bit-equal to ``train_step`` on the same batch and
    generator, and the generator ends where the eager steps leave it.

    The parallel modes (``_step_grads``): with ``mesh`` the step is
    ``make_train_step_dp``'s (JAX ``make_epoch_step_dp``): ``generator`` is
    the rank's ``DPGenerators`` (both registered with the graph), the rows
    given to ``run`` are this rank's columns of each batch, and the
    all-reduce is captured with the step; with ``tp`` (a ``TPLayout``) it
    is ``make_train_step_tp``'s on this rank's slices, its all-gathers and
    all-reduces captured. Either needs NCCL to be graphed.

    Another model's step (``step_fn``): the same object drives it, the
    graph, the Adam pass and the buffers alike. ``step_fn(params, x0,
    labels, generator, cfg)`` returns what ``_step_grads`` returns, on the
    batch ``data[rows]`` as stored and its rows of ``labels`` (N,), a
    device-resident label set beside ``data`` (the ADM U-Net,
    ``models/adm_unet.py``). Its loss may be a vector of ``loss_shape``:
    ``run`` then returns (k, *loss_shape). ``cfg`` needs ``batch_size``,
    ``scan_unroll``, ``learn_rate`` and ``param_dtype``."""

    def __init__(self, params: Params, opt_state: AdamState,
                 data: torch.Tensor, generator, cfg: Config = CONFIG,
                 unroll: Optional[int] = None, mesh=None, tp=None,
                 labels: Optional[torch.Tensor] = None, step_fn=None,
                 loss_shape: Tuple[int, ...] = ()):
        device = data.device
        self.cfg, self.data, self.generator = cfg, data, generator
        self.mesh, self.tp = mesh, tp
        self.labels, self.step_fn = labels, step_fn
        self.loss_shape = tuple(loss_shape)
        self.params = tree_map(lambda p: p.detach().clone(), params)
        self.m = tree_map(lambda a: a.detach().clone(), opt_state.m)
        self.v = tree_map(lambda a: a.detach().clone(), opt_state.v)
        self.step = opt_state.step
        # what the in-place pass computes: f32 parameters on the card
        self.in_place = all(p.dtype == torch.float32 and p.is_cuda
                            for p in tree_leaves(self.params))
        self.counter = torch.zeros((), dtype=torch.int64, device=device)
        self.idx = torch.zeros((0, cfg.batch_size), dtype=torch.int64,
                               device=device)
        self.table = torch.zeros((0, 2), dtype=torch.float32, device=device)
        # the loss in train_step's dtype (f64 for f64 data)
        self.losses = torch.zeros((0, *self.loss_shape), device=device,
                                  dtype=torch.promote_types(torch.float32,
                                                            data.dtype))
        gens = ((generator.replicated, generator.rank) if mesh is not None
                else (generator,))
        self.graph = graphs.StepGraph(unroll or cfg.scan_unroll, device, gens)

    def opt_state(self) -> AdamState:
        return AdamState(step=self.step, m=self.m, v=self.v)

    def _one(self) -> None:
        row = self.counter.reshape(1)
        rows = self.idx.index_select(0, row)[0]
        if self.step_fn is None:
            x0 = _fit_images(self.data[rows], self.cfg)
            loss, grads, sr_seed, index = _step_grads(
                self.params, x0, self.generator, self.cfg, mesh=self.mesh,
                tp=self.tp)
        else:
            x0 = self.data[rows]
            loss, grads, sr_seed, index = self.step_fn(
                self.params, x0, self.labels[rows], self.generator, self.cfg)
        with torch.no_grad(), trace.phase("adam", x0):
            if self.in_place and sr_seed is None:
                adam_update_at_(self.params, grads, self.m, self.v,
                                self.counter, self.table,
                                self.cfg.learn_rate)
            else:
                params, opt = adam_update_at(
                    self.params, grads, self.opt_state(), self.counter,
                    self.table, self.cfg.learn_rate, sr_seed=sr_seed,
                    sr_index=index)
                for mine, new in ((self.params, params), (self.m, opt.m),
                                  (self.v, opt.v)):
                    for a, b in zip(tree_leaves(mine), tree_leaves(new)):
                        a.copy_(b)
            self.losses.index_copy_(0, row,
                                    loss.reshape(1, *self.loss_shape))
            self.counter.add_(1)

    def run(self, idx: torch.Tensor) -> torch.Tensor:
        """One step per row of ``idx`` (k, B), the batches' rows of
        ``data`` (under ``mesh`` this rank's B/ranks of each), on this
        object's state; returns the k losses (f32, on the device; (k,
        *loss_shape) for a vector loss)."""
        k = idx.shape[0]
        with trace.span("bla.train.run"):
            with trace.span("bla.train.buffers"):
                # new buffers: the graph reads the old ones
                if k > self.idx.shape[0]:
                    device = self.counter.device
                    self.idx = torch.zeros((k, idx.shape[1]),
                                           dtype=torch.int64, device=device)
                    self.table = torch.zeros((k, 2), dtype=torch.float32,
                                             device=device)
                    self.losses = torch.zeros((k, *self.loss_shape),
                                              dtype=self.losses.dtype,
                                              device=device)
                    self.graph.reset()
                self.idx[:k].copy_(idx)
                self.table[:k].copy_(bias_corrections(self.step + 1, k))
                self.counter.zero_()
            self.graph.run(k, self._one)
            self.step += k
            return self.losses[:k].clone()


def train_chunk(params: Params, opt_state: AdamState, data: torch.Tensor,
                idx: torch.Tensor, generator: torch.Generator,
                cfg: Config = CONFIG):
    """K train steps as one CUDA graph of K steps (the JAX package's
    ``train_chunk``, one dispatch per chunk): ``idx`` (K, B) holds each
    step's rows of ``data`` (N, 3, 32, 32), which the steps gather on the
    device (the JAX package's chunk takes the stacked batches). Equal bit
    for bit to K ``train_step`` calls on those batches and ``generator``.
    A graph is captured after its warm-up, which for one chunk is the whole
    chunk: ``train`` keeps one ``TrainSteps`` for all the chunks of a run.
    Returns (params, opt_state, losses)."""
    steps = TrainSteps(params, opt_state, data, generator, cfg,
                       unroll=idx.shape[0])
    losses = steps.run(idx)
    return steps.params, steps.opt_state(), losses


def epoch_step(params: Params, opt_state: AdamState, data: torch.Tensor,
               perm: torch.Tensor, generator: torch.Generator,
               cfg: Config = CONFIG):
    """A whole epoch over a device-resident dataset (the JAX package's
    ``epoch_step``): ``data`` (N, 3, 32, 32) on the device, ``perm``
    (n_batches·B,) this epoch's order; each step gathers its batch on the
    device, and on the card the steps after the warm-up are replays of a
    graph of ``cfg.scan_unroll`` steps. Equal bit for bit to the same
    ``train_step`` calls. Returns (params, opt_state, losses)."""
    b = cfg.batch_size
    n = perm.shape[0] // b
    steps = TrainSteps(params, opt_state, data, generator, cfg)
    losses = steps.run(perm[:n * b].reshape(n, b))
    return steps.params, steps.opt_state(), losses


# ---------------------------------------------------------------------------
# Data parallelism: the JAX package's shard_map DP step
# (models/cifar_unet.py:846-876) and its scanned epoch (make_epoch_step_dp,
# :878-911: TrainSteps with a mesh). Each rank runs its shard of the batch;
# the gradients and the loss are averaged over the ranks.
# ---------------------------------------------------------------------------

def rank_generator(step_seed: int, rank: int,
                   device: torch.device) -> torch.Generator:
    """The generator of one rank's draws from ``step_seed`` with the rank
    folded in (JAX's ``fold_in(key, axis_index)``; the DP×TP step's)."""
    return fold_generator(step_seed, rank, device)


def _step_seed(generator: torch.Generator) -> int:
    return int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))


class DPGenerators:
    """``--dp``'s two generators on the rank's device, made once.
    ``replicated``, seeded alike on every rank, draws the ``--bf16-params``
    rounding seed (JAX's ``_sr_key`` from the pre-fold key: every rank
    must round the replicated params alike or the replicas part).
    ``rank``, this rank's own (the seed with the rank ``index`` folded in),
    draws its t, noise and dropout masks. ``new_epoch`` seeds ``rank``
    anew from a seed the replicated stream draws (one host read an epoch),
    the rank folded in: the train state keeps the replicated stream alone
    (``get_state``/``set_state``), whatever the rank count, and a run
    resumed at an epoch draws as the unbroken run. A graph registers both,
    and the eager DP step draws from the same two, so graphed and eager
    steps are one stream."""

    def __init__(self, seed: int, index: int, device):
        self.index = index
        self.replicated = torch.Generator(device=device).manual_seed(seed)
        self.rank = fold_generator(seed, index, device)

    def new_epoch(self) -> None:
        self.rank.manual_seed(fold_seed(_step_seed(self.replicated),
                                        self.index))

    def get_state(self) -> torch.Tensor:
        return self.replicated.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.replicated.set_state(state)


def make_train_step_dp(mesh, cfg: Config = CONFIG, axis: str = "data"):
    """DP train step over ``mesh``: x0 is this rank's shard of the batch
    (``batch_sharding``), params and Adam state are replicated.
    ``step(params, opt_state, x0, generators, draws=None)``:
    ``generators`` is the rank's ``DPGenerators``: the stochastic-rounding
    seed of ``--bf16-params`` from the replicated stream, this rank's t,
    noise and dropout masks from its own. ``draws``: this rank's (t,
    noise) instead. The local loss is a mean over the shard, so the
    gradients and the loss are averaged over ``axis`` (pmean, one
    all-reduce), and every rank applies the same Adam update.
    Statistically the single-device step at the global batch: each rank
    draws its own timesteps, noise and masks. ``TrainSteps`` with the mesh
    runs this step over static buffers (JAX's ``make_epoch_step_dp``, a
    graph under NCCL). Returns (params, opt_state, loss)."""
    def step(params: Params, opt_state: AdamState, x0: torch.Tensor,
             generators: DPGenerators, draws=None):
        loss, grads, sr_seed, _ = _step_grads(params, x0, generators, cfg,
                                              draws, mesh=mesh, axis=axis)
        params, opt_state = _adam(params, grads, opt_state, cfg, sr_seed)
        return params, opt_state, loss

    return step


# ---------------------------------------------------------------------------
# Tensor parallelism (the JAX package's place_tp / place_dp_tp, GSPMD's
# column-parallel convs written out per rank)
# ---------------------------------------------------------------------------


def tp_param_specs(params: Params, n_shards: int,
                   model_axis: str = "model") -> Params:
    """Which leaves shard over a model axis of ``n_shards`` ranks, by the
    JAX package's rule (``tp_param_specs``): a conv kernel ``(O, I, kh,
    kw)`` shards O, ``time_w`` ``(T, O)`` its dim 1, ``time_b`` its dim 0,
    each when ``n_shards`` divides it; the attention projections ``q``,
    ``k``, ``v``, ``w``, ``b`` and every other leaf replicate. Returns a
    tree of the dim each leaf shards along, or None where it replicates
    (JAX's ``P(model, ...)`` with the axis at that dim, or ``P()``).
    ``model_axis`` is JAX's argument; the markers do not name it."""

    def spec(name, leaf):
        if name in ("q", "k", "v", "w", "b"):
            return None
        if leaf.ndim == 4 and leaf.shape[0] % n_shards == 0:
            return 0
        if name == "time_w" and leaf.shape[1] % n_shards == 0:
            return 1
        if name == "time_b" and leaf.shape[0] % n_shards == 0:
            return 0
        return None

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return spec(name, tree)

    return walk(params)


class TPLayout:
    """A tree's TP layout over ``mesh``'s ``axis``: ``specs`` (the dim each
    leaf shards along, or None; ``tp_param_specs`` of the full tree)."""

    def __init__(self, mesh, specs: Params, axis: str = "model"):
        self.mesh, self.specs, self.axis = mesh, specs, axis
        self.n, self.index = mesh.size(axis), mesh.index(axis)

    def place(self, tree: Params) -> Params:
        """This rank's slice of every sharded leaf of a full tree."""
        shard = BatchShard(self.index, self.n)
        return tree_map(lambda x, d: x if d is None
                        else shard(x, dim=d).contiguous(), tree, self.specs)

    def gather(self, tree: Params) -> Params:
        """The full tree from the ranks' slices (collective)."""
        return tree_map(lambda x, d: x if d is None else spmd.all_gather(
            x, self.mesh, self.axis, d), tree, self.specs)

    def mark(self, tree: Params) -> Params:
        """The slices as ``_Shard`` weights for the TP forward."""
        def shard(x, d):
            if d is None:
                return x
            shape = list(x.shape)
            shape[d] *= self.n
            return _Shard(x, d, torch.Size(shape), self.mesh, self.axis)
        return tree_map(shard, tree, self.specs)

    def sum_replicated(self, grads: Params) -> Params:
        """``grads`` with every replicated leaf summed over the axis."""
        flat, specs = tree_leaves(grads), tree_leaves(self.specs)
        rep = {str(i): g for i, (g, d) in enumerate(zip(flat, specs))
               if d is None}
        summed = spmd.psum_tree(rep, self.mesh, self.axis)
        it = iter(range(len(flat)))
        return tree_map(lambda g: summed.get(str(next(it)), g), grads)

    def sr_index(self, tree: Params) -> Params:
        """Each sharded leaf's element indices in its full leaf (so that
        ``--bf16-params`` rounds a slice as the whole leaf would); None
        for replicated leaves."""
        def index(x, d):
            if d is None:
                return None
            shape = list(x.shape)
            shape[d] *= self.n
            full = torch.arange(math.prod(shape), dtype=torch.int64,
                                device=x.device).reshape(shape)
            return full.narrow(d, self.index * x.shape[d], x.shape[d])
        return tree_map(index, tree, self.specs)


def place_tp(mesh, params: Params, opt_state: Optional[AdamState] = None,
             model_axis: str = "model"):
    """This rank's TP slices of ``params`` (and of the Adam moments, which
    shard alike) on ``mesh``'s ``model_axis``: the JAX package's
    ``place_tp``, where the sharding is a layout and GSPMD partitions the
    step; here each rank keeps its slices and ``make_train_step_tp`` runs
    the partitioned step. ``gather_tp`` is the inverse."""
    layout = TPLayout(mesh, tp_param_specs(params, mesh.size(model_axis)),
                      model_axis)
    params = layout.place(params)
    if opt_state is None:
        return params
    return params, AdamState(step=opt_state.step, m=layout.place(opt_state.m),
                             v=layout.place(opt_state.v))


def gather_tp(layout: TPLayout, params: Params,
              opt_state: Optional[AdamState] = None):
    """The full tree (and Adam state) from the ranks' TP slices, on every
    rank of the model axis: what the train state and the CSV tree hold."""
    params = layout.gather(params)
    if opt_state is None:
        return params
    return params, AdamState(step=opt_state.step,
                             m=layout.gather(opt_state.m),
                             v=layout.gather(opt_state.v))


def place_dp_tp(mesh, params: Params, opt_state: Optional[AdamState] = None,
                model_axis: str = "model"):
    """The DP×TP layout on a 2-D ``data × model`` mesh: ``place_tp`` over
    ``model_axis``, replicated over the data axis; each batch is cut with
    ``dp_tp_batch_sharding``."""
    return place_tp(mesh, params, opt_state, model_axis=model_axis)


def dp_tp_batch_sharding(mesh, data_axis: str = "data") -> BatchShard:
    return batch_sharding(mesh, data_axis)


def make_train_step_tp(mesh, specs: Params, cfg: Config = CONFIG,
                       model_axis: str = "model",
                       data_axis: Optional[str] = None):
    """The TP train step on ``mesh``'s ``model_axis`` (params and Adam
    state from ``place_tp``, ``specs`` = ``tp_param_specs`` of the full
    tree): the TP forward and its backward (``_loss_and_grads``), then Adam
    on each rank's slices; a ``--bf16-params`` slice rounds with its full
    leaf's bits.

    Without ``data_axis`` every rank takes the whole batch and draws from
    ``generator`` exactly as ``train_step`` does (t, noise, the masks, then
    the rounding seed): every rank of the line draws alike, and the step is
    the single-device step, as JAX's GSPMD step is. With ``data_axis``
    (DP×TP) x0 is this rank's data shard and ``generator`` a replicated
    host stream: the rounding seed, then a step seed with the **data**
    index folded in (never the global rank, so
    that the ranks of one model line draw alike); the gradients and the
    loss are then averaged over ``data_axis``. ``draws``: this rank's (t,
    noise). Returns (params, opt_state, loss)."""
    layout = TPLayout(mesh, specs, model_axis)

    def step(params: Params, opt_state: AdamState, x0: torch.Tensor,
             generator: torch.Generator, draws=None):
        if data_axis is None:
            loss, grads, sr_seed, index = _step_grads(
                params, x0, generator, cfg, draws, tp=layout)
        else:
            sr_seed = _sr_seed(generator, cfg)
            local = rank_generator(_step_seed(generator),
                                   mesh.index(data_axis), x0.device)
            loss, grads = _loss_and_grads(params, x0, local, cfg, draws,
                                          layout)
            mean = spmd.pmean_tree({"grads": grads, "loss": loss}, mesh,
                                   data_axis)
            grads, loss = mean["grads"], mean["loss"]
            index = layout.sr_index(params) if sr_seed is not None else None
        params, opt_state = _adam(params, grads, opt_state, cfg, sr_seed,
                                  index)
        return params, opt_state, loss

    return step


# ---------------------------------------------------------------------------
# Pipeline parallelism: the U-Net's down/mid/up stages (the JAX package's
# unet_pipeline_stages and make_train_step_pp)
# ---------------------------------------------------------------------------


def split_params_stages(params: Params) -> list:
    """The parameter dict's three pipeline stages' subtrees (down / mid /
    up and the output head)."""
    down = {k: params[k] for k in ("down_1", "down_2", "down_3", "down_4")}
    mid = {"mid": params["mid"]}
    up = {k: params[k]
          for k in ("up_1", "up_2", "up_3", "up_4", "output_conv")}
    return [down, mid, up]


def unet_pipeline_stages(cfg: Config = CONFIG, train: bool = False) -> list:
    """The U-Net as three stages for ``gpipe_hetero`` (the same
    ``_down_stage``/``_mid_stage``/``_up_stage`` ``forward`` runs).
    Boundary 0 is ``(x, t as a float)``; the skips and the time embedding
    travel in the boundaries. Under ``cfg.layout == "NHWC"`` the down stage
    transposes x at entry and the up stage its output at exit, as
    ``forward`` does: boundary 0 and the output are NCHW, the boundaries
    between the stages carry channels-last maps. ``train=False``: ``(p, boundary)``, dropout
    off. ``train=True``: ``(p, boundary, generator)``, the masks from the
    per-(stage, microbatch) generator ``gpipe_hetero(key=...)`` makes. A
    mismatch raises, as in JAX: stages that silently ignored a generator
    would run deterministic where the caller believes dropout is on."""
    dt = getattr(torch, cfg.compute_dtype)
    nhwc = cfg.layout == "NHWC"

    def _check(generator):
        if train and generator is None:
            raise ValueError(
                "train=True pipeline stages need gpipe_hetero(..., key=...)")
        if not train and generator is not None:
            raise ValueError(
                "inference stages got a key; build unet_pipeline_stages("
                "cfg, train=True) for training-mode dropout")

    def _cast(p):
        return tree_map(lambda a: a if a.dtype == dt else a.to(dt), p)

    def stage_down(p, boundary, generator=None):
        _check(generator)
        x, t = boundary
        temb = time_embedding(t, cfg).to(dt)
        x = _to_nhwc(x.to(dt)) if nhwc else x.to(dt)
        skips = _down_stage(_cast(p), x, temb, cfg, generator, train, nhwc)
        return skips + (temb,)

    def stage_mid(p, boundary, generator=None):
        _check(generator)
        s1, s2, s3, s4, temb = boundary
        h = _mid_stage(_cast(p), s4, temb, cfg, generator, train, nhwc)
        return h, (s1, s2, s3, s4), temb

    def stage_up(p, boundary, generator=None):
        _check(generator)
        h, skips, temb = boundary
        out = _up_stage(_cast(p), h, skips, temb, cfg, generator, train,
                        nhwc)
        return _to_nchw(out) if nhwc else out

    return [stage_down, stage_mid, stage_up]


def pp_draws(x0: torch.Tensor, generator: torch.Generator, cfg: Config):
    """(rounding seed, step seed, t, noise) of one PP step from the
    replicated host ``generator``: the ``--bf16-params`` rounding seed
    first, then a step seed; t and noise come from a device generator of
    the step seed (the same on every rank), the dropout masks from its
    folds (``gpipe_hetero``'s key)."""
    sr_seed = _sr_seed(generator, cfg)
    seed = _step_seed(generator)
    t, noise = _ddpm_draws(
        x0, torch.Generator(device=x0.device).manual_seed(seed), cfg)
    return sr_seed, seed, t, noise


def make_pp_loss_and_grads(mesh, cfg: Config = CONFIG, axis: str = "stage",
                           n_micro: int = 4, data_axis: Optional[str] = None,
                           schedule: str = "gpipe"):
    """The pipeline's loss and gradient: ``fn(params, x0, t, noise, seed)
    -> (loss, grads)``, the MSE over the global batch's normalizer in ≥ f32
    (``loss_fn``'s), through ``gpipe_hetero`` and autograd (``"gpipe"``) or
    ``gpipe_hetero_1f1b`` with the analytic seed 2(pred − target)/N
    (``"1f1b"``), the dropout masks from the folds of ``seed``; the loss and
    the full gradient tree on every rank (``assemble_grads``)."""
    fns = unet_pipeline_stages(cfg, train=True)
    if data_axis is not None and n_micro % mesh.size(data_axis):
        raise ValueError(
            f"n_micro={n_micro} not divisible by data axis "
            f"{data_axis!r} of size {mesh.size(data_axis)}")
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"schedule must be gpipe or 1f1b, got {schedule!r}")
    s = mesh.index(axis)
    n_data = 1 if data_axis is None else mesh.size(data_axis)
    base = 0 if data_axis is None else mesh.index(data_axis) * (
        n_micro // n_data)
    plan = None  # the boundaries' shapes, made at the first call

    def loss_and_grads(params: Params, x0: torch.Tensor, t: torch.Tensor,
                       noise: torch.Tensor, seed: int):
        nonlocal plan
        b = x0.shape[0]
        if b % n_micro:
            raise ValueError(
                f"batch {b} not divisible by n_micro={n_micro}")
        mb, shape = b // n_micro, tuple(x0.shape[1:])
        xs = _noised(x0, t, noise, cfg).reshape(n_micro, mb, *shape)
        ts = t.reshape(n_micro, mb).to(x0.dtype)
        noise_m = noise.reshape(n_micro, mb, *shape)
        acc = torch.promote_types(torch.float32, x0.dtype)
        n_total = math.prod(x0.shape)
        stages = split_params_stages(params)
        if plan is None or not plan.fits(fns, stages, (xs, ts), seed):
            plan = pipeline_plan(fns, stages, (xs, ts), seed)
        if schedule == "1f1b":
            def seed_fn(pred, target):
                d = pred.to(acc) - target.to(acc)
                return torch.sum(d * d) / n_total, 2.0 * d / n_total

            loss, stage_grads = gpipe_hetero_1f1b(
                fns, stages, (xs, ts), noise_m, seed_fn, mesh, axis,
                key=seed, data_axis=data_axis, plan=plan)
        else:
            leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
            stages = split_params_stages(leaves)
            with torch.enable_grad():
                pred = gpipe_hetero(fns, stages, (xs, ts), mesh, axis,
                                    key=seed, data_axis=data_axis, plan=plan)
                target = noise_m[base:base + pred.shape[0]]
                loss = mse_loss(pred.to(acc), target.to(acc)) / n_total
                grads = iter(torch.autograd.grad(
                    loss, tree_leaves(stages[s]), allow_unused=True))
            loss = loss.detach()
            if data_axis is not None:
                loss = spmd.psum(loss, mesh, data_axis)
            stage_grads = assemble_grads(
                tree_map(lambda _: next(grads), stages[s]), stages, mesh,
                axis, data_axis)
        grads = {}
        for tree in stage_grads:  # disjoint stage subtrees
            grads.update(tree)
        return loss, {k: grads[k] for k in params}

    return loss_and_grads


def make_train_step_pp(mesh, cfg: Config = CONFIG, axis: str = "stage",
                       n_micro: int = 4, data_axis: Optional[str] = None,
                       schedule: str = "gpipe"):
    """The pipeline train step on ``mesh``'s ``axis`` of three ranks (down,
    mid, up): the batch in ``n_micro`` microbatches through the pipeline
    (``make_pp_loss_and_grads``: GPipe by autograd, or 1F1B), then Adam.

    Every rank holds the whole parameter tree and Adam state and runs its
    stage's subtree; after the backward each rank's stage gradients are
    assembled into the full gradient tree (``assemble_grads``: summed over
    ``data_axis``, then over ``axis`` from zero-padded trees), and every
    rank applies the same Adam update, so the replicas stay bit-equal and
    rank 0 writes. With ``data_axis`` (PP×DP, a ``stage × data`` mesh) each
    data coordinate runs its own ring over ``n_micro / n_data``
    microbatches, the dropout folds on global microbatch indices, so the
    step is the 1-D pipeline's at the same global batch.

    ``step(params, opt_state, x0, generator, draws=None)``: x0 the whole
    batch on every rank, ``generator`` the replicated host stream
    (``pp_draws``); ``draws``: (t, noise) instead. Returns (params,
    opt_state, loss)."""
    loss_and_grads = make_pp_loss_and_grads(mesh, cfg, axis, n_micro,
                                            data_axis, schedule)

    def step(params: Params, opt_state: AdamState, x0: torch.Tensor,
             generator: torch.Generator, draws=None):
        sr_seed, seed, t, noise = pp_draws(x0, generator, cfg)
        if draws is not None:
            t, noise = draws
        loss, grads = loss_and_grads(params, x0, t, noise, seed)
        params, opt_state = _adam(params, grads, opt_state, cfg, sr_seed)
        return params, opt_state, loss

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


def ddpm_update(x: torch.Tensor, eps: torch.Tensor, t, z: torch.Tensor,
                schedule) -> torch.Tensor:
    """One ancestral step x_t → x_{t−1}, the JAX sampler's loop body
    (:1106-1111): mean = (x − β/√(1−ᾱ)·ε)/√α, then
    ``where(t > 0, mean + √β·z, mean)``. ``t``: the timestep, a 0-dim
    integer tensor on x's device (an int is put there); ``schedule``:
    (betas, alphas, alpha_bars) on x's device (``device_schedule``). β, α
    and ᾱ are read on the device and every coefficient is computed there in
    f32, with true divisions as in JAX's body (a division of a CUDA tensor
    by a host scalar would multiply by its reciprocal), so the step is the
    same eagerly and in a CUDA graph."""
    t = torch.as_tensor(t, device=x.device)
    row = t.reshape(1)
    beta, alpha, ab = (a.index_select(0, row)[0] for a in schedule)
    mean = (x - beta / torch.sqrt(1.0 - ab) * eps) / torch.sqrt(alpha)
    return torch.where(t > 0, mean + torch.sqrt(beta) * z, mean)


def sample(params: Params, generator: torch.Generator, cfg: Config = CONFIG,
           num_samples: int = 1, graphed: Optional[bool] = None
           ) -> torch.Tensor:
    """DDPM ancestral sampling (Ho et al. alg. 2) → (n, 3, S, S) f32 in
    [−1, 1], on the device of ``params`` and ``generator``. The initial
    noise and every step's z are drawn from ``generator``. The loop is the
    JAX package's ``lax.fori_loop``: each denoising step reads the timestep
    from a device counter and writes x in place, so on the card the steps
    after the warm-up are replays of a CUDA graph of ``cfg.scan_unroll``
    steps (``utils/graphs.py``; eager on the CPU, under the debug modes or
    with ``graphed=False``), bit-equal to the eager loop."""
    device = generator.device
    dt = getattr(torch, cfg.compute_dtype)
    shape = (num_samples, cfg.in_channels, cfg.image_size, cfg.image_size)
    with trace.span("bla.sample"):
        with trace.span("bla.sample.prepare"):
            params = tree_map(lambda p: p.to(device, dt), params)  # once
            schedule = device_schedule(cfg, device)
            with torch.inference_mode():
                x = torch.randn(shape, generator=generator, device=device)
                t = torch.full((), cfg.timesteps - 1, dtype=torch.int64,
                               device=device)

        def step():
            with trace.phase("forward", x):
                tb = t.expand(num_samples).to(torch.int32)
                eps = forward(params, x, tb, cfg).float()
            with trace.phase("update", x):
                z = torch.randn(shape, generator=generator, device=device)
                x.copy_(ddpm_update(x, eps, t, z, schedule))
                t.sub_(1)

        with torch.inference_mode():
            graphs.StepGraph(cfg.scan_unroll, device, (generator,),
                             graphed).run(cfg.timesteps, step)
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
    if "layout" in flags:
        layout = str(flags["layout"]).upper()
        if layout not in ("NCHW", "NHWC"):
            raise ValueError(
                f"--layout must be NCHW or NHWC, got {flags['layout']!r}")
        cfg = dataclasses.replace(cfg, layout=layout)
    if common.presence_flag(flags, "remat"):
        cfg = dataclasses.replace(cfg, remat=True)
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
    if "scan-unroll" in flags:
        cfg = dataclasses.replace(
            cfg, scan_unroll=common.positive_int_flag(flags, "scan-unroll"))
    return cfg


def init(flags=None) -> None:
    cfg = _cfg_from_flags(flags)
    params = init_params(torch.Generator().manual_seed(cfg.seed), cfg)
    save_params_csv(params, cfg)
    print(f"initialized parameters in {ckpt_dir()}")


# The draw chains a train state's generator can belong to, and how to
# resume each: "device" (one device, and --tp, whose step is the
# single-device step), "dp-device" (--dp) and "pp" (--pp, and --pp --dp,
# whose step is the 1-D pipeline's at the same global batch). "dp" is the
# --dp chain of earlier versions of the port, which no run continues.
_CHAINS = {
    "device": "a run without --dp or --pp (one device, or --tp), whose draws "
              "come from the device's generator; resume it without --dp and "
              "--pp",
    "dp-device": "a --dp run, whose draws come from two generators on each "
                 "rank's device (the replicated stream, and the rank's own "
                 "seeded from it each epoch); resume it with --dp on two or "
                 "more ranks (any count)",
    "dp": "a --dp run of an earlier version of the port, whose draws came "
          "from a replicated host generator and a new generator every step; "
          "--dp now draws from two device generators a rank (so that its "
          "steps can be replayed as a CUDA graph) and cannot continue that "
          "stream: delete the train state (train_state_torch/) to start "
          "again from the CSV tree",
    "pp": "a --pp run, whose draws come from a replicated host generator "
          "with each stage and microbatch folded in; resume it with --pp on "
          "three or more ranks (with or without --dp)",
}


def _train_state(params, opt_state: AdamState, generator, epoch: int,
                 cfg: Config, device: torch.device, chain: str) -> dict:
    return {"params": params,
            "opt": {"step": opt_state.step, "m": opt_state.m,
                    "v": opt_state.v},
            "rng": generator.get_state(), "device": device.type,
            "chain": chain, "epoch": epoch, "param_dtype": cfg.param_dtype}


def _resume(state: dict, generator, cfg: Config, device: torch.device,
            chain: str):
    """(params, opt_state, epoch) from a saved train state (the full tree),
    cast to this run's parameter dtype (a state written under the other
    ``--bf16-params`` setting resumes into this one); the generator
    continues its stream. The state records its draw chain (``_CHAINS``;
    states from before the pipeline record ``dp``), and resuming it into
    another chain is refused, as is a ``--dp`` state of an earlier version
    (chain "dp"), whose stream no run continues. A ``--dp`` state holds the
    replicated stream of ``DPGenerators`` and a ``--pp`` state the
    replicated host stream, whatever the rank count."""
    written = state.get("chain") or ("dp" if state.get("dp") else "device")
    if written != chain:
        raise ValueError(f"the train state was written by {_CHAINS[written]}")
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


def _pp_flags(flags, cfg: Config):
    """(n_micro, schedule) of ``--pp``, with the JAX package's checks and
    messages; ``--pp-micro`` and ``--pp-schedule`` without ``--pp`` are
    rejected (the JAX package ignores them there)."""
    if not common.presence_flag(flags, "pp"):
        for f in ("pp-micro", "pp-schedule"):
            if f in flags:
                raise SystemExit(f"--{f} applies to --pp (the JAX package "
                                 f"ignores it without --pp)")
        return None
    if common.presence_flag(flags, "tp"):
        raise SystemExit("--pp cannot be combined with --tp on this CLI "
                         "(use --pp --dp for the 2-D composition)")
    n_micro = (common.positive_int_flag(flags, "pp-micro")
               if "pp-micro" in flags else 4)
    if cfg.batch_size % n_micro:
        raise SystemExit(
            f"--pp: batch size {cfg.batch_size} is not divisible by "
            f"--pp-micro={n_micro} microbatches")
    schedule = str(flags.get("pp-schedule") or "gpipe")
    if schedule not in ("gpipe", "1f1b"):
        raise SystemExit(
            f"--pp-schedule must be gpipe or 1f1b, got {schedule!r}")
    return n_micro, schedule


def _parallel_mode(flags, cfg: Config):
    """(kind, mesh, step) of the launch: "dp", "tp", "pp", or "single"
    (one device, or too few ranks: the JAX package's "running unsharded"),
    with the JAX CLI's rules and lines. The ranks are those of the launch
    (``common.launch_world``); ``--tp``'s model axis is every rank, ``--pp``
    takes the first 3 (3·n with ``--dp`` at 6 or more ranks). A rank
    outside the pipeline's mesh gets kind "idle"."""
    from big_linear_algebra_tpu_torch.parallel import make_mesh

    pp = _pp_flags(flags, cfg)
    mesh = None if pp else common.dp_mesh(flags, cfg.batch_size)
    if mesh is not None:
        if common.presence_flag(flags, "tp"):
            raise SystemExit("--tp cannot be combined with --dp on this CLI "
                             "(use the DP×TP API on a 2-D data×model mesh)")
        return "dp", mesh, make_train_step_dp(mesh, cfg)
    if common.presence_flag(flags, "tp"):
        n = common.launch_world(flags)
        if n <= 1:
            print("--tp: single device, running unsharded")
            return "single", None, None
        mesh = make_mesh({"model": n})
        if common.is_rank0():
            print(f"--tp: conv kernels channel-sharded over {n} devices")
        return "tp", mesh, None
    if pp is None:
        return "single", None, None
    n_micro, schedule = pp
    n = common.launch_world(flags)
    say = print if common.is_rank0() else (lambda *a: None)
    if common.presence_flag(flags, "dp") and n >= 6:
        n_data = n // 3
        if n_micro % n_data:
            raise SystemExit(
                f"--pp --dp: --pp-micro={n_micro} microbatches are not "
                f"divisible by the {n_data} data shards (3 stages × "
                f"{n_data} data on {n} devices)")
        mesh = make_mesh({"stage": 3, "data": n_data},
                         devices=range(3 * n_data))
        say(f"--pp --dp: 3-stage pipeline × {n_data} data shards, "
            f"{n_micro} global microbatches, {schedule} schedule")
        data_axis = "data"
    else:
        if "dp" in flags:
            say(f"--pp --dp needs >= 6 devices (3 stages × >=2 data "
                f"shards), have {n}; running pure --pp")
        if n < 3:
            say("--pp: fewer than 3 devices, running unsharded")
            return "single", None, None
        mesh = make_mesh({"stage": 3}, devices=range(3))
        say(f"--pp: 3-stage pipeline (down/mid/up), {n_micro} "
            f"microbatches, {schedule} schedule")
        data_axis = None
    if mesh.coords is None:
        return "idle", mesh, None
    return "pp", mesh, make_train_step_pp(mesh, cfg, n_micro=n_micro,
                                          data_axis=data_axis,
                                          schedule=schedule)


def _scan_steps(flags, kind: str) -> int:
    """``--scan-steps`` (default 1), with the JAX package's messages where
    a parallel mode runs (:1566-1573); ``--tp`` takes it, as the JAX
    package's GSPMD chunk does."""
    scan_steps = common.int_flag(flags, "scan-steps", default=1, minimum=1)
    if scan_steps > 1:
        if kind == "dp":
            raise SystemExit("--scan-steps>1 is not supported with --dp; use "
                             "the default device-resident DP epoch mode")
        if kind in ("pp", "idle"):
            raise SystemExit("--scan-steps>1 is not supported with --pp (the "
                             "chunked scan path runs the unsharded "
                             "train_chunk)")
    return scan_steps


def train(num_epochs: int, *args, flags=None) -> int:
    """Train for ``num_epochs`` epochs, resuming the newest train state.
    Under ``--tp`` each rank holds its slices and the train state and the
    CSV tree are written from the gathered tree; under ``--pp`` every rank
    holds the whole tree. Rank 0 alone prints and writes.

    The JAX package's dispatch rules (:1516-1630), its scans replayed as
    CUDA graphs (``TrainSteps``): with no ``--max-steps``, ``--scan-steps``
    or ``--host-loop``, with the data resident, on one device, under
    ``--dp`` (JAX's ``make_epoch_step_dp``) or ``--tp`` (its GSPMD epoch),
    each epoch is one ``TrainSteps`` run (graphs of ``cfg.scan_unroll``
    steps, ``--scan-unroll``); ``--scan-steps=K`` (one device or ``--tp``)
    takes K steps a replay (a ragged tail step by step); otherwise
    (``--host-loop``, ``--max-steps`` alone, ``--pp``, a dataset past
    ``_RESIDENT_BYTES``) one eager step per batch. Under the debug flags,
    and where ranks share a card over gloo, the same paths run their steps
    eagerly. Either way the steps, the draws and the saved train state are
    the same bit for bit."""
    flags = flags or {}
    cfg = _cfg_from_flags(flags)
    device = common.device_flag(flags)
    # absent = whole epochs; when given, --max-steps caps each epoch
    max_steps = common.int_flag(flags, "max-steps", default=0, minimum=1)
    host_loop = common.presence_flag(flags, "host-loop")
    keep = common.int_flag(flags, "keep", default=3, minimum=0) or None
    best = common.presence_flag(flags, "keep-best")
    kind, mesh, step = _parallel_mode(flags, cfg)
    scan_steps = _scan_steps(flags, kind)
    if mesh is not None:
        device = mesh.device
    rank0 = common.is_rank0()
    if kind in ("dp", "tp"):
        common.say_eager_rule(kind, device)
    if kind == "pp" and rank0:
        print("--pp: one eager step per batch (the JAX package trains the "
              "pipeline one step a dispatch)")
    data = Cifar10Batches(common.rank0_first(
        lambda: synth.ensure_cifar(str(common.data_dir()))))
    if data.num_examples < cfg.batch_size:
        raise SystemExit(
            f"batch size {cfg.batch_size} exceeds the dataset "
            f"({data.num_examples} examples): no full batch to train on")
    if kind == "idle":  # a rank the pipeline's mesh leaves out: it leaves
        return 0
    chain = {"dp": "dp-device", "pp": "pp"}.get(kind, "device")
    # --dp: the replicated and the rank's generator on the device; --pp:
    # the replicated stream is a host generator
    if kind == "dp":
        generator = DPGenerators(cfg.seed, mesh.index("data"), device)
    else:
        generator = torch.Generator(
            device="cpu" if chain == "pp" else device).manual_seed(cfg.seed)
    step0 = ckpt_pytree.latest_step(state_dir())
    csv_file = ckpt_dir() / "output_conv.csv"
    epoch0 = 0
    if step0 is not None:
        params, opt_state, epoch0 = _resume(
            ckpt_pytree.restore_pytree(state_dir(), step0, device), generator,
            cfg, device, chain)
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
    layout = None
    if kind == "tp":
        layout = TPLayout(mesh, tp_param_specs(params, mesh.size("model")))
        params, opt_state = place_tp(mesh, params, opt_state)
        step = make_train_step_tp(mesh, layout.specs, cfg)

    def full_state():
        return ((params, opt_state) if layout is None
                else gather_tp(layout, params, opt_state))

    # rank 0 alone writes the train states and the CSV tree, and logs
    manager = ckpt_pytree.TrainCheckpointer(
        state_dir(), max_to_keep=keep,
        best_metric="loss" if best else None) if rank0 else None
    logger = common.MetricsLogger(flags.get("jsonl") or None, enabled=rank0)
    rng = np.random.default_rng([cfg.seed, epoch0])
    b, n_ex = cfg.batch_size, data.num_examples
    step = step or functools.partial(train_step, cfg=cfg)
    # each rank's rows of every batch (all of them outside --dp)
    lo, hi = batch_sharding(mesh).bounds(b) if kind == "dp" else (0, b)
    # The JAX package's 2 GiB rule, applied to the copy the port keeps on
    # the device: the 32x32 records in f32 (each batch is upscaled after
    # it is drawn). A larger set streams through pinned host memory two
    # batches ahead. Both walk rng.permutation per epoch.
    resident = data.pixels.size * 4 < _RESIDENT_BYTES
    if resident:
        data_dev = torch.from_numpy(pixels_to_chw(data.pixels)).to(device)
    # the JAX package's dispatch (:1527-1530): the device epoch (one
    # device, --dp, --tp), the --scan-steps chunks, or one step per batch
    device_epoch = (not max_steps and scan_steps == 1 and not host_loop
                    and kind in ("single", "dp", "tp") and resident)
    steps_graph = None
    if device_epoch or scan_steps > 1:
        # a chunk path that streams stages each chunk in a device buffer
        source = data_dev if resident else torch.empty(
            (scan_steps * (hi - lo), cfg.in_channels, 32, 32), device=device)
        steps_graph = TrainSteps(
            params, opt_state, source, generator, cfg,
            unroll=None if device_epoch else scan_steps,
            mesh=mesh if kind == "dp" else None, tp=layout)
        params, opt_state = steps_graph.params, steps_graph.opt_state()
    n_steps = n_ex // b if not max_steps else min(n_ex // b, max_steps)
    for epoch in range(epoch0, epoch0 + num_epochs):
        t0 = time.perf_counter()
        if kind == "dp":
            generator.new_epoch()
        if steps_graph is not None:
            losses = _graph_epoch(steps_graph, data, rng, n_steps,
                                  scan_steps, resident, device, lo, hi)
            params, opt_state = steps_graph.params, steps_graph.opt_state()
        else:
            if resident:
                perm = torch.from_numpy(rng.permutation(n_ex)).to(device)
                batches = (data_dev[perm[i + lo:i + hi]]
                           for i in range(0, (n_ex // b) * b, b))
            else:
                batches = prefetch_to_device(
                    (x[lo:hi] for _, x in data.epoch_batches(rng, b)),
                    device)
            losses = []
            for step_i, x0 in enumerate(batches):
                if max_steps and step_i >= max_steps:
                    break
                params, opt_state, loss = step(params, opt_state,
                                               _fit_images(x0, cfg),
                                               generator)
                losses.append(loss)
            losses = torch.stack(losses)
        losses = losses.float().cpu().numpy()
        dt = time.perf_counter() - t0
        avg = float(losses.mean())
        logger.log(epoch=epoch, avg_loss=avg, epoch_seconds=dt,
                   images_per_sec=losses.size * b / dt, step=opt_state.step)
        state = full_state()
        if rank0:
            manager.save(opt_state.step,
                         _train_state(*state, generator, epoch + 1, cfg,
                                      device, chain),
                         metrics={"loss": avg})
    final = full_state()  # under --tp a collective: every rank gathers
    if rank0:
        save_params_csv(final[0], cfg)
    common.launch_done(mesh)
    logger.close()
    return 0


def _graph_epoch(steps: TrainSteps, data: Cifar10Batches,
                 rng: np.random.Generator, n_steps: int, scan_steps: int,
                 resident: bool, device, lo: int, hi: int) -> torch.Tensor:
    """One epoch of ``train``'s graph paths on ``steps``: the device epoch
    (``scan_steps`` 1: every step of the epoch in one ``run``) or the
    ``--scan-steps`` chunks (whole chunks first, then the ragged tail step
    by step), over ``rng``'s order, as the eager loop walks it; each step
    takes its batch's columns ``lo:hi`` (this rank's under ``--dp``). A
    dataset that is not resident streams each chunk into ``steps.data``.
    Returns the epoch's losses."""
    b = steps.cfg.batch_size
    if resident:
        perm = torch.from_numpy(rng.permutation(data.num_examples)).to(device)
        rows = perm[:n_steps * b].reshape(n_steps, b)[:, lo:hi]
        if scan_steps == 1:
            return steps.run(rows)
        whole = n_steps // scan_steps * scan_steps
        return torch.cat([steps.run(rows[:whole]), steps.run(rows[whole:])])
    chunk_rows = torch.arange(scan_steps * (hi - lo), device=device).reshape(
        scan_steps, hi - lo)
    losses, chunk = [], []
    batches = prefetch_to_device(
        (x[lo:hi] for _, x in data.epoch_batches(rng, b)), device)
    for step_i, x0 in enumerate(batches):
        if step_i >= n_steps:
            break
        chunk.append(x0)
        if len(chunk) == scan_steps or step_i == n_steps - 1:
            steps.data[:len(chunk) * (hi - lo)].copy_(torch.cat(chunk))
            losses.append(steps.run(chunk_rows[:len(chunk)]))
            chunk = []
    return torch.cat(losses)


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
                     "jsonl", "fused-block", "dp", "tp", "pp", "pp-micro",
                     "pp-schedule", "remat", "scan-steps", "scan-unroll",
                     "host-loop"),
        unsupported_flags={
            "prng": "the port draws from torch.Generator (Philox on the "
                    "GPU); rbg/threefry are JAX's generators",
        })


if __name__ == "__main__":
    raise SystemExit(main())
