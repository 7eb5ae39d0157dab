"""my_first_model: 2→3→2 ReLU MLP sign classifier (≈ model/my_first_model.c),
the counterpart of ``big_linear_algebra_tpu/models/my_first_model.py``.

Learns whether two numbers share a sign: output close to [1, 0] for same
sign, [0, 1] for different (model/my_first_model.c:139-143). Online SGD
against synthetic uniform data cycling the four sign quadrants (:71-97),
squared-error cost with a rolling 20-step cost window (:102-116).

CSV layout (the same files the JAX package reads and writes):
hidden_weights.csv (3, 2), hidden_biases.csv (1 line of 3),
output_weights.csv (2, 3), output_biases.csv (1 line of 2),
input_nodes.csv (the run input, 1 line of 2).

The data stream is the JAX package's (``_synth_example`` from
``np.random.default_rng(42)``), so both packages train on the same
examples. ``init`` draws from a ``torch.Generator`` seeded 42: the same
distribution as the JAX package's, not the same values. Deviations from
the reference as in the JAX package (SURVEY.md §7.14): train does not
clobber input_nodes.csv with zeros on save.

Flags: ``--device=cuda|cpu`` (default ``cuda``) and the base flags;
``--dp`` and ``--jsonl`` are rejected with their reasons.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from big_linear_algebra_tpu_torch.data.csv import read_csv_matrix, write_csv_matrix
from big_linear_algebra_tpu_torch.models import common
from big_linear_algebra_tpu_torch.nn import layer_graph
from big_linear_algebra_tpu_torch.nn.init import uniform_init

ACTS = ("relu", "relu")
SHAPES = [((3, 2), (3,)), ((2, 3), (2,))]
_FILES = [("hidden_weights.csv", "hidden_biases.csv"),
          ("output_weights.csv", "output_biases.csv")]
WINDOW = 20  # report_costs_every_n, model/my_first_model.c:69


def ckpt_dir() -> Path:
    return common.data_dir() / "my_first_model"


def load_params(device="cpu") -> layer_graph.Params:
    base = ckpt_dir()
    params = []
    for (wf, bf), ((r, c), _) in zip(_FILES, SHAPES):
        w = read_csv_matrix(str(base / wf), r, c)
        b = read_csv_matrix(str(base / bf), 1, r)[0]
        params.append((torch.from_numpy(w).to(device),
                       torch.from_numpy(b).to(device)))
    return params


def save_params(params: layer_graph.Params) -> None:
    base = ckpt_dir()
    for (wf, bf), (w, b) in zip(_FILES, params):
        write_csv_matrix(str(base / wf), w.cpu().numpy())
        write_csv_matrix(str(base / bf), b.cpu().numpy().reshape(1, -1))


def init(flags=None, seed: int = 42) -> None:
    """U(−0.5, 0.5) weights, biases of 0.1 (the reference ships trained
    weights and has no init verb for this model; zero biases leave this
    tiny all-ReLU net prone to dead units)."""
    gen = torch.Generator().manual_seed(seed)
    save_params([(uniform_init(shape_w, gen),
                  torch.full(shape_b, 0.1, dtype=torch.float32))
                 for shape_w, shape_b in SHAPES])
    # default run input (the reference ships one in data/my_first_model/)
    input_path = ckpt_dir() / "input_nodes.csv"
    if not input_path.is_file():
        write_csv_matrix(str(input_path), np.array([[0.5, 0.5]], np.float32))
    print(f"initialized parameters in {ckpt_dir()}")


def _synth_example(rng: np.random.Generator, i: int):
    """The reference's quadrant-cycling data synthesis
    (model/my_first_model.c:71-97): i%4 picks the sign pattern; expectation
    alternates [1,0] (same sign) / [0,1] (different) with i%2."""
    a, b = rng.random(), rng.random()
    signs = [(1, 1), (-1, 1), (-1, -1), (1, -1)][i % 4]
    x = np.array([signs[0] * a, signs[1] * b], np.float32)
    y = np.array([1.0, 0.0] if i % 2 == 0 else [0.0, 1.0], np.float32)
    return x, y


def synth_stream(iterations: int):
    """The training stream: (xs (T, 2), ys (T, 2)) float32, from
    ``np.random.default_rng(42)`` as in the JAX package."""
    rng = np.random.default_rng(42)
    xs = np.zeros((iterations, 2), np.float32)
    ys = np.zeros((iterations, 2), np.float32)
    for i in range(iterations):
        xs[i], ys[i] = _synth_example(rng, i)
    return xs, ys


def train(iterations: int, learn_rate: str = None, *args, flags=None):
    if learn_rate is None:
        print("Please supply a number of iterations and a learn rate, "
              "usage:\n\ttrain <iterations> <learn_rate>\n")
        return
    lr = float(learn_rate)
    device = common.device_flag(flags)
    if not (ckpt_dir() / "hidden_weights.csv").is_file():
        print("no checkpoint found; initializing")
        init()
    params = load_params(device)
    xs, ys = synth_stream(iterations)
    run_steps = layer_graph.make_sgd_scan(ACTS)
    params, costs = run_steps(params, torch.from_numpy(xs).to(device),
                              torch.from_numpy(ys).to(device), lr)
    common.print_cost_windows(costs.cpu().numpy(), WINDOW)
    save_params(params)
    print("Finished training")


def run(num: int = -1, flags=None):
    """Classify the pair in input_nodes.csv (model/my_first_model.c:22-54)."""
    device = common.device_flag(flags)
    params = load_params(device)
    x = read_csv_matrix(str(ckpt_dir() / "input_nodes.csv"), 1, 2)[0]
    with torch.no_grad():
        out = layer_graph.predict(params, ACTS,
                                  torch.from_numpy(x).to(device))
    out = out.cpu().numpy()
    for v in out:
        print(f"{v: .6f}")
    if out[0] > out[1]:
        print("Same sign!")
    else:
        print("Different signs!")


def main(argv=None) -> int:
    return common.run_cli(
        "my_first_model", init, train, run, argv=argv,
        train_usage="train <iterations> <learn_rate>",
        run_usage="run",
        unsupported_flags={
            "dp": "per-example online SGD on synthesized single examples is "
                  "inherently sequential (model/my_first_model.c:99-105); "
                  "use mnist_nn for data-parallel minibatch training",
            "jsonl": common.NO_METRICS_LOG},
    )


if __name__ == "__main__":
    raise SystemExit(main())
