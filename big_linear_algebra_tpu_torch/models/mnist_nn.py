"""mnist_nn: the 784→256→128→10 MLP (≈ model/mnist_nn.c), the counterpart
of ``big_linear_algebra_tpu/models/mnist_nn.py``.

Ported so far: the serving path.
- ``init``: He-uniform weights U(±√(6/fan_in)) and zero biases
  (model/mnist_nn.c:97-142), drawn from a ``torch.Generator`` seeded with
  ``Config.seed``, saved in the reference CSV layout (weights_N.csv (out, in)
  row-major, biases_N.csv one line) — the same files the JAX package reads.
- ``run``: evaluates the test set as one batch (model/mnist_nn.c:401-490).
  Each of the three dense layers is one launch of the GEMM kernel with the
  bias and ReLU fused into its epilogue.
``train`` is not ported yet; ``--dp`` and the train-only flags
(``--batch``, ``--per-batch``, ``--scan-unroll``, ``--jsonl``) are rejected.

Batch-major activations (B, 784) with (in, out) weights, as in the JAX
package. The device comes from ``--device=cuda|cpu`` (default ``cuda``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from big_linear_algebra_tpu_torch.ckpt import csv_layouts
from big_linear_algebra_tpu_torch.data import synth
from big_linear_algebra_tpu_torch.data.mnist import MnistDataset
from big_linear_algebra_tpu_torch.models import common
from big_linear_algebra_tpu_torch.nn import Dense, he_uniform, softmax_cross_entropy


@dataclasses.dataclass(frozen=True)
class Config:
    input_size: int = 784          # LAYER_INPUT_SIZE, model/mnist_nn.c:26
    layer_1: int = 256             # LAYER_1_SIZE
    layer_2: int = 128             # LAYER_2_SIZE
    layer_3: int = 10              # LAYER_3_SIZE
    seed: int = 42                 # srand(42), :513

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


def train(num_epochs: int, *args, flags=None, cfg: Config = CONFIG) -> int:
    print("mnist_nn train is not ported to PyTorch yet (it needs the GEMM's "
          "hand-written backward); use big_linear_algebra_tpu.models.mnist_nn")
    return 1


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
        unsupported_flags={
            "dp": "data parallelism is not ported yet (ROADMAP Queue 1, "
                  "the parallel-modes item)",
            "per-batch": "train is not ported yet",
            "batch": "train is not ported yet",
            "scan-unroll": "train is not ported yet",
            "jsonl": "train, the only verb that logs metrics, is not ported "
                     "yet",
        })


if __name__ == "__main__":
    raise SystemExit(main())
