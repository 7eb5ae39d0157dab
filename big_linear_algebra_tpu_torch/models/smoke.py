"""Smoke program (≈ reference ``main.c``), the counterpart of
``big_linear_algebra_tpu/models/smoke.py``: exercises matmul, CSV IO, and a
one-layer Layer-graph net with the toy 0.1× linear activation, printing
before/after one backprop step (main.c:19-88).

Reads the reference's tiny fixtures when present (data/a.csv, b.csv,
inputs.csv, weights.csv, biases.csv — 3×3 / 3×1 / 3×2, main.c:43-70),
otherwise generates the JAX package's (``np.random.default_rng(42)``).

    python -m big_linear_algebra_tpu_torch.models.smoke [--device=cuda|cpu]

Flags: the base flags of the model CLIs (``--device``, default ``cuda``;
``--profile``, ``--debug-nans``, ``--disable-jit``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from big_linear_algebra_tpu_torch.data.csv import read_csv_matrix, write_csv_matrix
from big_linear_algebra_tpu_torch.models import common
from big_linear_algebra_tpu_torch.nn import layer_graph
from big_linear_algebra_tpu_torch.ops.matmul import matmul
from big_linear_algebra_tpu_torch.ops.matrix import print_matrix


def _smoke(device: torch.device) -> None:
    base = common.data_dir()
    if not (base / "a.csv").is_file():
        rng = np.random.default_rng(42)
        write_csv_matrix(str(base / "a.csv"), rng.standard_normal((3, 3)))
        write_csv_matrix(str(base / "b.csv"), rng.standard_normal((3, 3)))
        write_csv_matrix(str(base / "inputs.csv"), rng.standard_normal((3, 1)))
        write_csv_matrix(str(base / "weights.csv"),
                         rng.standard_normal((2, 3)))
        write_csv_matrix(str(base / "biases.csv"), rng.standard_normal((2, 1)))

    def load(name, rows, cols):
        return torch.from_numpy(
            read_csv_matrix(str(base / name), rows, cols)).to(device)

    # 1) matmul smoke (main.c:39-41)
    print_matrix(matmul(load("a.csv", 3, 3), load("b.csv", 3, 3)), "a @ b")

    # 2) Layer-graph net with the toy 0.1x activation (main.c:7-17,52-83)
    x = load("inputs.csv", 3, 1)[:, 0]
    params = [(load("weights.csv", 2, 3), load("biases.csv", 2, 1)[:, 0])]
    acts = ("scale_0.1",)
    with torch.no_grad():
        out = layer_graph.predict(params, acts, x)
    print_matrix(out.reshape(-1, 1), "output before")
    target = torch.tensor([1.0, 0.0], device=device)
    params = layer_graph.sgd_step(params, acts, x, target, 0.5)
    with torch.no_grad():
        out = layer_graph.predict(params, acts, x)
    print_matrix(out.reshape(-1, 1), "output after one step")


def main(argv=None) -> int:
    pos, flags = common.parse_flags(
        list(sys.argv[1:] if argv is None else argv))
    unknown = [k for k in flags if k not in common.BASE_FLAGS]
    if pos or unknown:
        print("usage: smoke [--device=cuda|cpu] [--profile[=DIR]] "
              "[--debug-nans] [--disable-jit]")
        return 1
    device = common.device_flag(flags)
    with common.maybe_profile("profile" in flags, flags.get("profile", "")), \
            common.debug_flags(flags):
        _smoke(device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
