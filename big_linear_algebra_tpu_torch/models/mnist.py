"""mnist (legacy): 784→200→200→10 Layer-graph MLP (≈ model/mnist.c), the
counterpart of ``big_linear_algebra_tpu/models/mnist.py``.

Per-example online SGD through the ``Layer`` abstraction with squared-error
cost on softmax outputs, streaming examples from the MNIST CSV
(model/mnist.c:132-216). Rolling 20-step cost window during training
(:175-192), per-example prediction printouts + final accuracy in ``run``
(:48-131).

Intended-semantics deviations, as in the JAX package (SURVEY.md §7.7-7.8):
- the output softmax forward is a true softmax (the reference divides raw
  logits by the sum of exponents, model/mnist.c:33); the backward keeps the
  reference's deliberate diagonal-only Jacobian (``softmax_legacy`` in
  nn/layer_graph.py)
- accuracy compares ``prediction == label`` (the reference has an off-by-one:
  ``prediction_index + 1 == label``, model/mnist.c:110)
- ``run``'s digit visualizer receives 1/255-scaled pixels (the reference
  visualizes unscaled values against 0-1 thresholds, §7.14)

Fidelity note: this model's learning dynamics are faithfully *weak* — the
reference's uniform(−0.5, 0.5) init saturates the 784-input first layer and
the diagonal softmax Jacobian vanishes on saturated outputs, so accuracy
stays near chance; ``--he-init`` (He-uniform weights, zero biases) is the
escape hatch. The legacy Layer-path models are commented out of the
reference's build (build.sh:4-7, SURVEY.md §0).

CSV layout (reference data/mnist/, the same files the JAX package reads and
writes): hidden_weights.csv (200, 784), hidden_weights_2.csv (200, 200),
output_weights.csv (10, 200), and one-line bias files.

The examples are staged on the host in file order, scaled by 1/255 in numpy
(as the JAX package scales them: CUDA's division by a CPU scalar would
round some pixels otherwise), and moved to the device once. ``run``
forwards the examples as one batch on the device and prints the
per-example report from the host copy of the outputs.

Flags: ``--device=cuda|cpu`` (default ``cuda``), ``--he-init`` and the base
flags; ``--dp`` and ``--jsonl`` are rejected with their reasons.
"""

from __future__ import annotations

import itertools
from pathlib import Path

import numpy as np
import torch

from big_linear_algebra_tpu_torch.data import synth
from big_linear_algebra_tpu_torch.data.csv import read_csv_matrix, write_csv_matrix
from big_linear_algebra_tpu_torch.data.mnist import MnistCSVStream, visualize_digit
from big_linear_algebra_tpu_torch.models import common
from big_linear_algebra_tpu_torch.nn import layer_graph
from big_linear_algebra_tpu_torch.nn.init import he_uniform, uniform_init

HIDDEN = 200  # HIDDEN_LAYER_SIZE, model/mnist.c:10
WINDOW = 20   # TRAINING_REPORT_COSTS_EVERY_N, :11
ACTS = ("relu", "relu", "softmax_legacy")
SHAPES = [((HIDDEN, 784), (HIDDEN,)),
          ((HIDDEN, HIDDEN), (HIDDEN,)),
          ((10, HIDDEN), (10,))]
_FILES = [("hidden_weights.csv", "hidden_biases.csv"),
          ("hidden_weights_2.csv", "hidden_biases_2.csv"),
          ("output_weights.csv", "output_biases.csv")]


def ckpt_dir() -> Path:
    return common.data_dir() / "mnist"


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
    """Uniform(−0.5, 0.5) for weights AND biases (model/mnist.c:218-249).

    ``--he-init``: He-uniform weights + zero biases instead — the escape
    hatch from the reference's saturating init (see the module docstring)."""
    gen = torch.Generator().manual_seed(seed)
    he = "he-init" in (flags or {})
    params = []
    for shape_w, shape_b in SHAPES:
        if he:
            params.append((he_uniform(shape_w, shape_w[1], gen),
                           torch.zeros(shape_b, dtype=torch.float32)))
        else:
            params.append((uniform_init(shape_w, gen),
                           uniform_init(shape_b, gen)))
    save_params(params)
    print(f"initialized parameters in {ckpt_dir()}")


def stream_examples(path: str, iterations: int):
    """``iterations`` examples of the MNIST CSV at ``path`` in file order,
    wrapping at EOF (the reference's fgetc stream, lib/mnist_csv.c:6) →
    (xs (T, 784) scaled by 1/255, one-hot ys (T, 10)), float32 numpy."""
    xs = np.zeros((iterations, 784), np.float32)
    ys = np.zeros((iterations, 10), np.float32)
    stream = MnistCSVStream(path)
    try:
        for i in range(iterations):
            if not stream.get_next_data():           # wrap at EOF
                stream.close()
                stream = MnistCSVStream(path)
                stream.get_next_data()
            xs[i] = stream.buffer[1:] / 255.0
            ys[i, int(stream.buffer[0])] = 1.0
    finally:
        stream.close()
    return xs, ys


def train(iterations: int, learn_rate: str = None, should_output: str = "1",
          *args, flags=None):
    if learn_rate is None:
        print("Please supply a number of iterations and a learn rate, "
              "usage:\n\ttrain <iterations> <learn_rate> [<output=1>]\n")
        return
    lr = float(learn_rate)
    should_output = bool(int(should_output))
    device = common.device_flag(flags)
    train_csv, _ = synth.ensure_mnist(str(common.data_dir()))
    if not (ckpt_dir() / "hidden_weights.csv").is_file():
        print("no checkpoint found; initializing")
        init(flags=flags)  # forward --he-init
    params = load_params(device)
    xs, ys = stream_examples(train_csv, iterations)
    run_steps = layer_graph.make_sgd_scan(ACTS)
    params, costs = run_steps(params, torch.from_numpy(xs).to(device),
                              torch.from_numpy(ys).to(device), lr)
    costs = costs.cpu().numpy()
    if should_output:
        common.print_cost_windows(costs, WINDOW)
    else:
        print(f"Final batch avg: {costs[max(0, iterations - WINDOW):].mean():.3f}")
    save_params(params)
    print("Finished training")


def run(num: int = -1, report_every_n: int = 1, flags=None):
    device = common.device_flag(flags)
    _, test_csv = synth.ensure_mnist(str(common.data_dir()))
    params = load_params(device)
    with MnistCSVStream(test_csv) as stream:  # -1: the whole file
        rows = list(itertools.islice(stream, None if num == -1
                                     else max(num, 0)))
    if not rows:
        return
    labels = [int(r[0]) for r in rows]
    pixels = np.stack([r[1:] / 255.0 for r in rows])
    with torch.no_grad():
        outs = layer_graph.predict_batch(
            params, ACTS, torch.from_numpy(pixels).to(device)).cpu().numpy()
    num_correct = 0
    for i, (label, out) in enumerate(zip(labels, outs)):
        report = report_every_n > 0 and i % report_every_n == report_every_n - 1
        prediction = int(out.argmax())
        if report:
            print(visualize_digit(pixels[i], label))
            print("Predictions:")
            for d, v in enumerate(out):
                print(f"\t{d}: {v:.2f}")
        onehot = np.zeros(10)
        onehot[label] = 1
        cost = float(((onehot - out) ** 2).sum())
        if prediction == label:
            num_correct += 1
            if report:
                print(f"Correct with cost: {cost:.2f}")
        elif report:
            print(f"Incorrect with cost: {cost:.2f}")
    total = len(rows)
    print(f"\nGot {num_correct} correct out of {total}, "
          f"({num_correct / total:.2f}%)")


def main(argv=None) -> int:
    return common.run_cli(
        "mnist", init, train, run, argv=argv,
        train_usage="train <iterations> <learn_rate> [<output=1>]",
        run_usage="run <num> [<output_every_n = 1>]",
        extra_flags=("he-init",),
        unsupported_flags={
            "dp": "per-example online SGD is inherently sequential "
                  "(each step's weights depend on the previous example, "
                  "model/mnist.c:158-173); use mnist_nn for data-parallel "
                  "minibatch training",
            "jsonl": common.NO_METRICS_LOG},
    )


if __name__ == "__main__":
    raise SystemExit(main())
