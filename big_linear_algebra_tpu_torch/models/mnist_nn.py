"""mnist_nn: the 784→256→128→10 MLP (≈ model/mnist_nn.c), the counterpart
of ``big_linear_algebra_tpu/models/mnist_nn.py``.

- architecture, batch 64, SGD lr 0.02, He-uniform init with zero biases
  (model/mnist_nn.c:11-12,97-142), drawn from a ``torch.Generator`` seeded
  with ``Config.seed`` (the JAX package's values differ: its generator is
  ``jax.random``'s);
- loss: softmax + cross-entropy (ε=1e-15) with the gradient seed scaled by
  1/input_size, the reference's ``scale = 1/784`` (model/mnist_nn.c:260,
  SURVEY.md §7.10);
- per-gradient Frobenius clip, inert at the default ∞ threshold, as the
  reference is built (model/mnist_nn.c:13,76-81);
- epoch metrics: average accuracy and CE loss over the examples
  (model/mnist_nn.c:339-341), epoch seconds and images/s;
- CSV checkpoints in the reference layout (weights_N.csv (out, in)
  row-major, biases_N.csv one line), the same files the JAX package reads
  and writes; ``train`` resumes from them (model/mnist_nn.c:165-170,344-376).

Verbs: ``init``; ``train N``, N epochs of SGD; ``run [n]``, the test set as
one batch (model/mnist_nn.c:401-490). Each dense layer is one GEMM with the
bias and ReLU fused into its epilogue, and its backward the JAX package's
hand-written rules (``nn/dense.py``, ``nn/losses.py``): two more GEMMs, nt
and tn. ``ops/matmul.py``'s ``_dispatch`` sends each GEMM of at least 2²²
FLOPs to the kernel K1 (at batch 64: layers 1 and 2, five launches a
step) and the rest to the plain product. A train epoch keeps the
dataset on the device and ships one permutation per epoch; ``--per-batch``
builds each batch on the host instead, as the reference does. The numpy
permutation is the JAX package's (``default_rng(Config.seed)``), so both
packages visit the examples in the same order.

Flags: ``--device=cuda|cpu`` (default ``cuda``), ``--batch=N``,
``--per-batch``, ``--jsonl=PATH``, ``--dp``, ``--scan-unroll=U``. The
resident epoch (the JAX package's one ``lax.scan``) replays a CUDA graph
of ``Config.scan_unroll`` steps on the card (``ResidentEpoch``), under
``--dp`` too when the ranks run over NCCL; ``--per-batch``, the debug
flags and ranks that share a card over gloo run eager steps.

``train --dp`` is data parallel over every rank of the launch (``torchrun
--nproc-per-node=N -m big_linear_algebra_tpu_torch.models.mnist_nn train
1 --dp``; launched plainly on a node with several cards, one rank per
card; on one card, the JAX package's "single device, running unsharded"):
each rank takes its slice of every batch (the resident epoch by default,
``make_epoch_resident_dp``, graphed as above; ``make_train_step_dp``
under ``--per-batch``), the gradients and the metrics are summed over the
ranks on the device, and rank 0 alone logs and writes the CSVs.
``make_train_step_dp_tp`` is the DP×TP step (the dense layers
column-parallel over a ``model`` axis), an API as in the JAX package.

Batch-major activations (B, 784) with (in, out) weights, as in the JAX
package. Unlike the JAX package's functional step, ``train_step`` updates
the model's parameters in place.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from big_linear_algebra_tpu_torch.ckpt import csv_layouts
from big_linear_algebra_tpu_torch.ckpt.csv_layouts import layout_exists
from big_linear_algebra_tpu_torch.data import synth
from big_linear_algebra_tpu_torch.data.mnist import MnistDataset
from big_linear_algebra_tpu_torch.models import common
from big_linear_algebra_tpu_torch.nn import (Dense, dense, he_uniform,
                                             softmax_cross_entropy)
from big_linear_algebra_tpu_torch.nn.optim import tree_map
from big_linear_algebra_tpu_torch.ops.matrix import frobenius_norm
from big_linear_algebra_tpu_torch.parallel import spmd
from big_linear_algebra_tpu_torch.parallel.sharding import (
    batch_sharding, shard_params_tp)
from big_linear_algebra_tpu_torch.utils import graphs


@dataclasses.dataclass(frozen=True)
class Config:
    input_size: int = 784          # LAYER_INPUT_SIZE, model/mnist_nn.c:26
    layer_1: int = 256             # LAYER_1_SIZE
    layer_2: int = 128             # LAYER_2_SIZE
    layer_3: int = 10              # LAYER_3_SIZE
    batch_size: int = 64           # SGD_BATCH_SIZE, :11
    learn_rate: float = 0.02       # SGD_LEARN_RATE_MULTIPLIER, :12
    grad_clip: float = float("inf")  # SGD_GRADIENT_CLIP, :13
    seed: int = 42                 # srand(42), :513
    # steps in one CUDA graph of the resident epoch, the JAX package's
    # lax.scan unroll factor: --scan-unroll=U
    scan_unroll: int = 4

    @property
    def sizes(self):
        return (self.input_size, self.layer_1, self.layer_2, self.layer_3)


CONFIG = Config()

_LAYOUT = {  # reference on-disk layout: (rows, cols) per file
    "weights_1.csv": (256, 784),
    "weights_2.csv": (128, 256),
    "weights_3.csv": (10, 128),
    "biases_1.csv": (1, 256),
    "biases_2.csv": (1, 128),
    "biases_3.csv": (1, 10),
}


def ckpt_dir() -> Path:
    return common.data_dir() / "mnist_nn"


# ---------------------------------------------------------------------------
# Parameters: a dict {"w1": (in, out), "b1": (out,), ...}, as in the JAX
# package.
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator,
                cfg: Config = CONFIG) -> Dict[str, torch.Tensor]:
    """He-uniform weights U(±√(6/fan_in)), zero biases
    (model/mnist_nn.c:97-142). Drawn on the CPU, so a seed gives the same
    parameters on every machine."""
    s = cfg.sizes
    params = {}
    for i in range(3):
        params[f"w{i+1}"] = he_uniform((s[i], s[i + 1]), s[i], generator)
        params[f"b{i+1}"] = torch.zeros((s[i + 1],), dtype=torch.float32)
    return params


def params_from_jax(np_params: Mapping[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's param dict (numpy arrays, same keys and layouts)
    as the port's CPU tensors, dtype kept. Arrays from JAX are read-only, so
    each is copied before ``torch.from_numpy``."""
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in np_params.items()}


def save_params_csv(params: Mapping[str, torch.Tensor],
                    base: Path | None = None) -> None:
    """Write the reference CSV layout: (in, out) weights transpose to the
    reference's (out, in) row-major files; biases are one CSV line."""
    arrays = {}
    for i in (1, 2, 3):
        arrays[f"weights_{i}.csv"] = params[f"w{i}"].detach().cpu().numpy().T
        arrays[f"biases_{i}.csv"] = (
            params[f"b{i}"].detach().cpu().numpy().reshape(1, -1))
    csv_layouts.save_matrices(str(base or ckpt_dir()), arrays)


def load_params_csv(base: Path | None = None) -> Dict[str, torch.Tensor]:
    mats = csv_layouts.load_matrices(str(base or ckpt_dir()), _LAYOUT)
    params = {}
    for i in (1, 2, 3):
        params[f"w{i}"] = torch.from_numpy(
            np.ascontiguousarray(mats[f"weights_{i}.csv"].T))
        params[f"b{i}"] = torch.from_numpy(mats[f"biases_{i}.csv"][0].copy())
    return params


# ---------------------------------------------------------------------------
# Model / loss / eval
# ---------------------------------------------------------------------------


class MnistNN(nn.Module):
    """relu(dense) ×2 → logits (model/mnist_nn.c:221-234). The hidden layers'
    bias+ReLU are fused into the GEMM kernel's epilogue (nn/dense.py)."""

    def __init__(self, cfg: Config = CONFIG, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        s = cfg.sizes
        acts = ("relu", "relu", None)
        self.layers = nn.ModuleList(
            Dense(s[i], s[i + 1], acts[i], device=device, dtype=dtype)
            for i in range(3))

    @classmethod
    def from_params(cls, params: Mapping[str, torch.Tensor],
                    cfg: Config = CONFIG, *, device=None,
                    dtype=None) -> "MnistNN":
        """A model holding ``params`` (see ``init_params``), moved to
        ``device`` and cast to ``dtype`` (default: the params' own)."""
        dtype = dtype or params["w1"].dtype
        model = cls(cfg, device=device, dtype=dtype)
        with torch.no_grad():
            for i, layer in enumerate(model.layers, start=1):
                layer.weight.copy_(params[f"w{i}"])
                layer.bias.copy_(params[f"b{i}"])
        return model

    def params(self) -> Dict[str, torch.Tensor]:
        """The parameters under the JAX package's keys (the tensors
        themselves: ``train_step`` updates them in place)."""
        out = {}
        for i, layer in enumerate(self.layers, start=1):
            out[f"w{i}"], out[f"b{i}"] = layer.weight, layer.bias
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 784) scaled to [0, 1] by the caller (matrix_scale 1/255,
        model/mnist_nn.c:218) → logits (B, 10)."""
        for layer in self.layers:
            x = layer(x)
        return x


def loss_and_metrics(model: MnistNN, x, onehot, mask, cfg: Config = CONFIG):
    logits = model(x)
    # reference gradient scale: 1/LAYER_INPUT_SIZE (model/mnist_nn.c:260)
    loss = softmax_cross_entropy(logits, onehot, mask) / cfg.input_size
    pred = torch.argmax(logits, dim=-1)
    label = torch.argmax(onehot, dim=-1)
    correct = torch.sum((pred == label) * mask)
    # unscaled CE sum for the reference's epoch-avg-loss metric
    ce_sum = loss * cfg.input_size
    return loss, (correct, ce_sum)


def _clip(g: torch.Tensor, threshold: float) -> torch.Tensor:
    """Per-gradient Frobenius clip (≈ clip_gradient, model/mnist_nn.c:76-81).
    Inert at the default ∞ threshold, as the reference is built."""
    if threshold == float("inf"):
        return g
    norm = frobenius_norm(g)
    return torch.where(norm > threshold, g * (threshold / norm), g)


def train_step(model: MnistNN, x, onehot, mask, cfg: Config = CONFIG):
    """One SGD step on one batch, in place: the forward, ``loss.backward()``
    through the hand-written backwards, the clip, then p − lr·g. Returns
    (correct, ce_sum) as tensors on the model's device; reading them waits
    for the device, so callers read them once per epoch."""
    model.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss, (correct, ce_sum) = loss_and_metrics(model, x, onehot, mask,
                                                   cfg)
        loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            p -= cfg.learn_rate * _clip(p.grad, cfg.grad_clip)
    return correct, ce_sum.detach()


def _resident_batches(x_dev, y_dev, batch_indices, cfg: Config):
    """(x, onehot, mask) of each row of ``batch_indices`` (−1 = padding),
    gathered on the device from the resident raw pixels and labels."""
    # a divisor on the device: PyTorch's CUDA division by a CPU scalar
    # multiplies by its reciprocal, which rounds otherwise than the host's
    # x / 255.0 in _make_batch (--per-batch)
    scale = torch.full((), 255.0, dtype=x_dev.dtype, device=x_dev.device)
    for batch_idx in batch_indices:
        safe = torch.clamp(batch_idx, 0, x_dev.shape[0] - 1)
        x = x_dev[safe] / scale
        onehot = F.one_hot(y_dev[safe].long(), cfg.layer_3).to(torch.float32)
        yield x, onehot, (batch_idx >= 0).to(torch.float32)


class ResidentEpoch:
    """The resident epoch on ``model`` (updated in place): ``x_dev`` (N,
    784) raw 0-255 pixels and ``y_dev`` (N,) labels on the model's device.
    ``epoch(perm)`` runs one ``train_step`` per batch of ``perm``
    (n_batches·B indices, −1 = padding: the ragged last batch's mask, so
    every step has one shape) and returns the summed (correct, ce_sum) as
    device tensors. Each step gathers its batch on the device from row
    ``counter`` of a static index buffer (``_resident_batches``' gather),
    takes its gradients in ``.grad`` (a graph's from its own memory), and
    adds its metrics to static accumulators; on the card the steps after
    the warm-up are replays of a CUDA graph of ``cfg.scan_unroll`` steps
    (``utils/graphs.py``; eager on the CPU, under the debug modes, over
    gloo and with ``graphed=False``), bit-equal to the eager epoch.

    With ``mesh`` (DP over its ``axis``) the step is ``make_train_step_dp``'s
    on this rank's slice of every batch, ``perm.reshape(n_batches, ranks,
    B/ranks)[:, rank]`` as the JAX package slices it; its gradients and
    metrics are summed over the ranks inside the step (in the graph under
    NCCL), so the accumulators hold the epoch's global sums."""

    def __init__(self, model: MnistNN, x_dev, y_dev, cfg: Config = CONFIG,
                 graphed=None, mesh=None, axis: str = "data"):
        device = x_dev.device
        self.model, self.x_dev, self.y_dev, self.cfg = model, x_dev, y_dev, \
            cfg
        if mesh is None:
            self.ranks, self.rank = 1, 0
            self.step = functools.partial(train_step, cfg=cfg)
        else:
            self.ranks, self.rank = mesh.size(axis), mesh.index(axis)
            if cfg.batch_size % self.ranks:
                raise ValueError(f"batch_size {cfg.batch_size} not divisible "
                                 f"by {self.ranks} devices")
            self.step = make_train_step_dp(mesh, cfg, axis)
        self.idx = torch.zeros((0, cfg.batch_size // self.ranks),
                               dtype=torch.int64, device=device)
        self.counter = torch.zeros((), dtype=torch.int64, device=device)
        # the dtypes of train_step's metrics: the mask's and the loss's
        self.correct = torch.zeros((), dtype=torch.float32, device=device)
        self.ce_sum = torch.zeros((), device=device, dtype=torch.promote_types(
            torch.float32, model.layers[0].weight.dtype))
        self.graph = graphs.StepGraph(cfg.scan_unroll, device,
                                      graphed=graphed)

    def _one(self) -> None:
        rows = self.idx.index_select(0, self.counter.reshape(1))
        batch = next(_resident_batches(self.x_dev, self.y_dev, rows,
                                       self.cfg))
        c, ce = self.step(self.model, *batch)
        with torch.no_grad():
            self.correct.add_(c)
            self.ce_sum.add_(ce)
            self.counter.add_(1)

    def __call__(self, perm: torch.Tensor):
        rows = perm.long().reshape(-1, self.ranks,
                                   self.idx.shape[1])[:, self.rank]
        k = rows.shape[0]
        if k > self.idx.shape[0]:  # a new buffer: the graph reads the old
            self.idx = torch.zeros_like(rows)
            self.graph.reset()
        self.idx[:k].copy_(rows)
        for acc in (self.counter, self.correct, self.ce_sum):
            acc.zero_()
        self.graph.run(k, self._one)
        return self.correct.clone(), self.ce_sum.clone()


def epoch_step_resident(model: MnistNN, x_dev, y_dev, perm,
                        cfg: Config = CONFIG, graphed=None):
    """A whole epoch against a device-resident dataset (the JAX package's
    ``epoch_step_resident``): the host sends only the permutation; one
    ``ResidentEpoch`` run. ``perm``: (n_batches·B,) indices, −1 = padding.
    Returns the epoch's summed (correct, ce_sum) as device tensors."""
    return ResidentEpoch(model, x_dev, y_dev, cfg, graphed)(perm)


def epoch_step(model: MnistNN, xs, onehots, masks, cfg: Config = CONFIG):
    """A whole epoch over pre-stacked batches: xs (n_batches, B, 784) scaled
    to [0, 1], onehots (n_batches, B, 10), masks (n_batches, B). Returns the
    summed (correct, ce_sum) as device tensors."""
    correct = ce_sum = 0.0
    for x, onehot, mask in zip(xs, onehots, masks):
        c, ce = train_step(model, x, onehot, mask, cfg)
        correct, ce_sum = correct + c, ce_sum + ce
    return correct, ce_sum


def epoch_permutation(rng: np.random.Generator, n: int,
                      batch_size: int) -> np.ndarray:
    """One epoch's order, padded with −1 to whole batches (int32), as the
    JAX package's ``train`` draws it (one ``rng.permutation(n)``)."""
    perm = np.full(-(-n // batch_size) * batch_size, -1, np.int32)
    perm[:n] = rng.permutation(n).astype(np.int32)
    return perm


# ---------------------------------------------------------------------------
# Data and tensor parallelism: the JAX package's shard_map steps
# (models/mnist_nn.py:243-380). Each rank runs its shard's step; the
# collectives are explicit (parallel/spmd.py), and K1 runs on each rank's
# local shapes.
# ---------------------------------------------------------------------------


def make_train_step_dp(mesh, cfg: Config = CONFIG, axis: str = "data"):
    """DP train step on this rank's shard of the batch (``batch_sharding``):
    the local forward and backward, then the gradients and the step's
    (correct, ce_sum) summed over ``axis`` in one all-reduce, the clip and
    SGD, replicated. The loss is an example sum, so the summed gradient IS
    the full batch's (up to the order of the sums). ``step(model, x,
    onehot, mask)`` updates the model in place and returns the summed
    (correct, ce_sum) as device tensors."""

    def step(model: MnistNN, x, onehot, mask):
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, (correct, ce_sum) = loss_and_metrics(model, x, onehot,
                                                       mask, cfg)
            loss.backward()
        params = model.params()
        summed = spmd.psum_tree(
            {"grads": {k: p.grad for k, p in params.items()},
             "correct": correct, "ce_sum": ce_sum.detach()}, mesh, axis)
        with torch.no_grad():
            for k, p in params.items():
                p -= cfg.learn_rate * _clip(summed["grads"][k],
                                            cfg.grad_clip)
        return summed["correct"], summed["ce_sum"]

    return step


def tp_param_specs(model_axis: str = "model") -> Dict[str, tuple]:
    """The sharded dim of every leaf, as JAX's PartitionSpecs name it
    (Megatron column-parallel): weights (in, out) shard their out dim,
    biases their only dim."""
    specs = {}
    for i in (1, 2, 3):
        specs[f"w{i}"] = (None, model_axis)
        specs[f"b{i}"] = (model_axis,)
    return specs


def place_params_tp(mesh, params: Mapping[str, torch.Tensor],
                    model_axis: str = "model") -> Dict[str, torch.Tensor]:
    """This rank's shards of the full ``params`` (``init_params``,
    ``params_from_jax``, ``load_params_csv``), on the mesh's device: the
    column-parallel layout of ``tp_param_specs`` (``shard_params_tp``)."""
    return tree_map(lambda t: t.to(mesh.device),
                    shard_params_tp(mesh, params, model_axis))


def gather_params_tp(mesh, params: Mapping[str, torch.Tensor],
                     model_axis: str = "model") -> Dict[str, torch.Tensor]:
    """The full parameters from every rank's shards (for the CSV
    checkpoint): each leaf gathered along its sharded dim."""
    specs = tp_param_specs(model_axis)
    with torch.no_grad():
        return {k: spmd.all_gather(v, mesh, model_axis,
                                   dim=specs[k].index(model_axis))
                for k, v in params.items()}


def tp_forward(params: Mapping[str, torch.Tensor], x: torch.Tensor, mesh,
               model_axis: str = "model") -> torch.Tensor:
    """TP forward on output-dim-sharded weights: each dense layer (K1 on
    the shard, its ReLU in K1's epilogue: ReLU commutes with the
    feature-dim gather) computes a feature shard, and an ``all_gather``
    over ``model_axis`` rebuilds the full activation for the next layer."""
    a = x
    for i in (1, 2, 3):
        z = dense(a, params[f"w{i}"], params[f"b{i}"],
                  "relu" if i < 3 else None)
        a = spmd.all_gather(z, mesh, model_axis, dim=1)
    return a


def make_train_step_dp_tp(mesh, cfg: Config = CONFIG,
                          data_axis: str = "data",
                          model_axis: str = "model"):
    """DP×TP train step: the batch over ``data_axis``, the dense output dims
    over ``model_axis`` (``place_params_tp``). The weight shards' gradients
    arrive through ``all_gather``'s backward (the cotangent summed over
    ``model_axis``, then sliced) and a sum over ``data_axis``; a finite clip
    takes the Frobenius norm of the full gradient across the model shards.
    ``step(params, x, onehot, mask)`` returns (new shards, correct,
    ce_sum), the metrics summed over ``data_axis``."""
    tp = mesh.size(model_axis)

    def step(params, x, onehot, mask):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            logits = tp_forward(leaves, x, mesh, model_axis)
            loss = softmax_cross_entropy(logits, onehot, mask) \
                / cfg.input_size
            # every model shard holds an identical copy of this loss, and
            # all_gather's backward SUMS the cotangents of all copies:
            # differentiate loss/tp so that the gradient is exact
            grads = torch.autograd.grad(loss / tp, list(leaves.values()))
        with torch.no_grad():
            pred = torch.argmax(logits, dim=-1)
            label = torch.argmax(onehot, dim=-1)
            correct = torch.sum((pred == label) * mask)
            summed = spmd.psum_tree(
                {"grads": dict(zip(leaves, grads)), "correct": correct,
                 "ce_sum": loss.detach() * cfg.input_size}, mesh, data_axis)
            grads = summed["grads"]
            if cfg.grad_clip != float("inf"):
                grads = {k: g * torch.clamp(
                    cfg.grad_clip / torch.sqrt(spmd.psum(
                        torch.sum(g * g), mesh, model_axis)), max=1.0)
                    for k, g in grads.items()}
            new = {k: leaves[k].detach() - cfg.learn_rate * grads[k]
                   for k in leaves}
        return new, summed["correct"], summed["ce_sum"]

    return step


def make_epoch_resident_dp(mesh, cfg: Config = CONFIG, axis: str = "data"):
    """DP counterpart of ``epoch_step_resident``: the dataset is resident on
    every rank, and each rank gathers its slice of every batch by its
    position on ``axis``, ``perm.reshape(n_batches, ranks, B/ranks)[:,
    rank]`` as the JAX package slices it, so an epoch is the single-device
    epoch's math. ``epoch(model, x_dev, y_dev, perm)`` is one
    ``ResidentEpoch`` run with the mesh (``train`` keeps one for every
    epoch); it returns the summed (correct, ce_sum) as device tensors."""
    if cfg.batch_size % mesh.size(axis):
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by "
                         f"{mesh.size(axis)} devices")

    def epoch(model: MnistNN, x_dev, y_dev, perm):
        return ResidentEpoch(model, x_dev, y_dev, cfg, mesh=mesh,
                             axis=axis)(perm)

    return epoch


@torch.inference_mode()
def eval_batch(model: MnistNN, x, onehot, mask, cfg: Config = CONFIG):
    _, (correct, ce_sum) = loss_and_metrics(model, x, onehot, mask, cfg)
    return correct, ce_sum


def _make_batch(xb, yb, batch_size, num_classes):
    """Zero-pad a ragged batch to ``batch_size`` and build onehot + mask
    (host numpy, identical to the JAX package's)."""
    n = xb.shape[0]
    x = np.zeros((batch_size, xb.shape[1]), np.float32)
    x[:n] = xb / 255.0  # matrix_scale(1/255), model/mnist_nn.c:218
    onehot = np.zeros((batch_size, num_classes), np.float32)
    onehot[np.arange(n), yb.astype(np.int64)] = 1.0
    mask = np.zeros((batch_size,), np.float32)
    mask[:n] = 1.0
    return x, onehot, mask


# ---------------------------------------------------------------------------
# CLI verbs
# ---------------------------------------------------------------------------


def init(flags=None, cfg: Config = CONFIG) -> None:
    params = init_params(torch.Generator().manual_seed(cfg.seed), cfg)
    save_params_csv(params)
    print(f"initialized parameters in {ckpt_dir()}")


def train(num_epochs: int, *args, flags=None, cfg: Config = CONFIG) -> None:
    """Train ``num_epochs`` epochs from the CSV checkpoint (or a fresh init),
    then write the CSVs."""
    flags = flags or {}
    if "batch" in flags:
        # --batch=N: scale past the reference's 64 (model/mnist_nn.c:11)
        cfg = dataclasses.replace(
            cfg, batch_size=common.positive_int_flag(flags, "batch"))
    if "scan-unroll" in flags:
        cfg = dataclasses.replace(
            cfg, scan_unroll=common.positive_int_flag(flags, "scan-unroll"))
    per_batch = common.presence_flag(flags, "per-batch")
    device = common.device_flag(flags)
    mesh = common.dp_mesh(flags, cfg.batch_size)
    if mesh is not None:
        device = mesh.device
        common.say_eager_rule("dp", device)
    train_csv, _ = common.rank0_first(
        lambda: synth.ensure_mnist(str(common.data_dir())))
    if layout_exists(str(ckpt_dir()), _LAYOUT):
        params = load_params_csv()  # training IS resume (mnist_nn.c:165-170)
    else:
        if common.is_rank0():
            print("no checkpoint found; initializing")
        params = init_params(torch.Generator().manual_seed(cfg.seed), cfg)
    model = MnistNN.from_params(params, cfg, device=device)
    data = MnistDataset.from_csv(train_csv)
    n = data.num_examples
    rng = np.random.default_rng(cfg.seed)
    logger = common.MetricsLogger(flags.get("jsonl") or None,
                                  enabled=common.is_rank0())
    # --dp: each rank steps on its slice of every batch, the gradients
    # summed over the ranks (the resident epoch by default)
    step = (functools.partial(train_step, cfg=cfg) if mesh is None
            else make_train_step_dp(mesh, cfg))
    shard = (lambda a: a) if mesh is None else batch_sharding(mesh)
    try:
        if not per_batch:  # the dataset to the device once
            x_dev = torch.from_numpy(data.x).to(device)
            y_dev = torch.from_numpy(data.y).to(device)
            # one graph for every epoch (--dp: its step, this rank's rows)
            epoch_fn = ResidentEpoch(model, x_dev, y_dev, cfg, mesh=mesh)
        for epoch in range(num_epochs):
            t0 = time.perf_counter()
            if per_batch:  # reference-style: host batches, one at a time
                correct_sum, loss_sum = 0.0, 0.0
                for xb, yb in data.epoch_batches(rng, cfg.batch_size):
                    batch = (torch.from_numpy(shard(a)).to(device) for a in
                             _make_batch(xb, yb, cfg.batch_size, cfg.layer_3))
                    correct, ce_sum = step(model, *batch)
                    correct_sum += float(correct)
                    loss_sum += float(ce_sum)
            else:
                perm = torch.from_numpy(
                    epoch_permutation(rng, n, cfg.batch_size)).to(device)
                correct, ce_sum = epoch_fn(perm)
                correct_sum, loss_sum = float(correct), float(ce_sum)
            dt = time.perf_counter() - t0
            logger.log(epoch=epoch, avg_accuracy=correct_sum / n,
                       avg_loss=loss_sum / n, epoch_seconds=dt,
                       images_per_sec=n / dt)
        if common.is_rank0():
            save_params_csv(model.params())
        common.launch_done()
    finally:
        logger.close()


def run(num_predictions: int = -1, flags=None, cfg: Config = CONFIG) -> None:
    """Eval on the test set as one batch (model/mnist_nn.c:401-490);
    ``-1`` = whole set."""
    device = common.device_flag(flags)
    _, test_csv = synth.ensure_mnist(str(common.data_dir()))
    model = MnistNN.from_params(load_params_csv(), cfg, device=device)
    data = MnistDataset.from_csv(test_csv)
    # reference: -1 (or over-ask) = whole set (model/mnist_nn.c:419-421)
    n = data.num_examples if (num_predictions < 1
                              or num_predictions > data.num_examples) \
        else num_predictions
    print(f"Running predictions for {n} digits...", end="", flush=True)
    x, onehot, mask = (torch.from_numpy(a).to(device) for a in
                       _make_batch(data.x[:n], data.y[:n], n, cfg.layer_3))
    correct, _ = eval_batch(model, x, onehot, mask, cfg)
    correct = int(correct)
    print(f"done! Got {correct} correct ({correct / n:.3f}).")


def main(argv=None) -> int:
    return common.run_cli(
        "mnist_nn", init, train, run, argv=argv,
        extra_flags=("batch", "per-batch", "jsonl", "dp", "scan-unroll"))


if __name__ == "__main__":
    raise SystemExit(main())
