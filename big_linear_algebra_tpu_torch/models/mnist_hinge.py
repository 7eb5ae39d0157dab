"""mnist_hinge: 10-model one-vs-rest linear hinge ensemble
(≈ model/mnist_hinge.c), the counterpart of
``big_linear_algebra_tpu/models/mnist_hinge.py``.

Ten 784-weight linear classifiers, one per digit, trained with **full-batch**
hinge gradients per iteration and a convergence stop when the summed
per-model gradient norm (each normalized by the example count) drops below
0.05 (model/mnist_hinge.c:101-176). ``init`` draws U(−0.05, +0.05) weights
from a ``torch.Generator`` seeded 42 (the reference's srand(42), :14-25;
the same distribution as the JAX package's, not the same values). CSV
layout: weights_0..9.csv, one line of 784 values each (:16-24), the files
the JAX package reads and writes.

As in the JAX package the ensemble is one (784, 10) weight matrix, and an
iteration is one GEMM pair (margins = X @ W, then Xᵀ @ (viol·y)); the
training set is staged on the device once. ``train_chunk`` runs a chunk of
ten iterations on the device (the reference's logging and convergence
cadence, :152), and the host reads the chunk's norm history once. The
converging iteration's update lands; after it the weights stay frozen
while the chunk's remaining norms are still computed, so the last row the
host prints is what the JAX package prints. ``train`` runs its chunks over
static buffers (``Chunks``: the weights, the device ``done`` flag and the
norm history), each whole chunk a replay of one CUDA graph on the card
(the JAX package's one dispatch a chunk; ``utils/graphs.py``), the ragged
tail eagerly; ``--dp`` captures its all-reduce an iteration with it.

Intended-semantics deviations, as in the JAX package (SURVEY.md §7.9):
descent on max(0, 1 − y·wᵀx) with argmax-of-``wᵀx`` scoring and full
gradient resets; reference-trained weights are evaluated with ``run
--reference-scoring`` (the reference's 1 − wᵀx).

Flags: ``--device=cuda|cpu`` (default ``cuda``), ``--reference-scoring``,
``--dp`` and the base flags; ``--jsonl`` is rejected with its reason.
``train --dp`` shards the examples over the ranks of the launch (zero rows
pad them to a multiple of the rank count; ``torchrun`` or, on a node with
several cards, one rank per card) and sums the gradient over the ranks
once an iteration (``make_train_chunk_dp``), inside the chunk's graph
when the ranks run over NCCL (one card each) and eagerly over gloo;
rank 0 alone prints and writes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from big_linear_algebra_tpu_torch.data import synth
from big_linear_algebra_tpu_torch.data.csv import read_csv_matrix, write_csv_matrix
from big_linear_algebra_tpu_torch.data.mnist import MnistDataset, visualize_digit
from big_linear_algebra_tpu_torch.models import common
from big_linear_algebra_tpu_torch.nn.init import uniform_init
from big_linear_algebra_tpu_torch.parallel import spmd
from big_linear_algebra_tpu_torch.parallel.sharding import batch_sharding
from big_linear_algebra_tpu_torch.utils import graphs

EPSILON = 0.05  # convergence threshold, model/mnist_hinge.c:168
CHUNK = 10      # iterations between the reference's norm logs (:152)


def ckpt_dir() -> Path:
    return common.data_dir() / "mnist_hinge"


def load_weights(device="cpu") -> torch.Tensor:
    """→ (784, 10): column d is model d's weight vector."""
    cols = [
        read_csv_matrix(str(ckpt_dir() / f"weights_{i}.csv"), 1, 784)[0]
        for i in range(10)
    ]
    return torch.from_numpy(np.stack(cols, axis=1)).to(device)


def save_weights(w: torch.Tensor) -> None:
    arr = w.cpu().numpy()
    for i in range(10):
        write_csv_matrix(str(ckpt_dir() / f"weights_{i}.csv"),
                         arr[:, i].reshape(1, -1))


def weights_from_jax(w: np.ndarray) -> torch.Tensor:
    """The JAX package's (784, 10) weights (numpy) as a CPU tensor, dtype
    kept (copied: arrays from JAX are read-only)."""
    return torch.from_numpy(np.array(w, copy=True))


def init(flags=None, seed: int = 42) -> None:
    """U(−0.05, 0.05) per weight (model/mnist_hinge.c:14-25's
    rand()/(10·RAND_MAX) − 0.05)."""
    save_weights(uniform_init((784, 10), torch.Generator().manual_seed(seed),
                              scale=0.1))
    print(f"initialized parameters in {ckpt_dir()}")


def signed_targets(labels: torch.Tensor, dtype) -> torch.Tensor:
    """(N,) labels → (N, 10) targets: +1 for the label's model, −1 else."""
    onehot = F.one_hot(labels.long(), 10) > 0
    return torch.where(onehot, 1.0, -1.0).to(dtype)


@torch.no_grad()
def _iterate(w, done, history, x, y, lr, n_total, mesh=None, axis="data"):
    """``len(history)`` iterations in place (JAX ``_chunk_body`` under its
    scan): ``w`` updated, ``done`` cleared first and set at convergence,
    row i of ``history`` the i-th iteration's norms. With a mesh, x and y
    are this rank's examples and the gradient is summed over ``axis`` (one
    all-reduce an iteration); every rank then holds the same sum, so the
    same weights and the same convergence freeze."""
    done.zero_()
    for i in range(history.shape[0]):
        margins = y * (x @ w)
        viol = (margins < 1.0).to(x.dtype)
        grads = -(x.T @ (viol * y))
        if mesh is not None:
            grads = spmd.psum_tree(grads, mesh, axis)
        norms = torch.sqrt(torch.sum(grads * grads, dim=0)) / n_total
        w.copy_(torch.where(done, w, w - lr * grads))
        done.copy_(done | (torch.sum(norms) < EPSILON))
        history[i].copy_(norms)


def _chunk(w, x, y, lr, n_iters, n_total, mesh=None, axis="data"):
    """The iterations of ``train_chunk`` on new buffers: (w, history)."""
    w = w.clone()
    history = torch.zeros((n_iters, w.shape[1]), dtype=w.dtype,
                          device=w.device)
    _iterate(w, torch.zeros((), dtype=torch.bool, device=w.device), history,
             x, y, lr, n_total, mesh, axis)
    return w, history


class Chunks:
    """``train``'s chunks over static buffers: the weights ``w`` (a copy of
    those given), the device ``done`` flag and the (CHUNK, 10) norm
    history. ``run(n)`` makes n ≤ CHUNK iterations and returns the
    history's first n rows (the buffer itself): a whole chunk is one
    ``StepGraph`` step, so on the card the first chunk runs eagerly (the
    warm-up) and every later one is a replay; a shorter one (the ragged
    tail) runs eagerly. Bit-equal to ``_chunk``. ``graphed``: as
    ``StepGraph``'s."""

    def __init__(self, w, x, y, lr, n_total, mesh=None, axis="data",
                 graphed=None):
        self.w = w.clone()
        self.done = torch.zeros((), dtype=torch.bool, device=w.device)
        self.history = torch.zeros((CHUNK, w.shape[1]), dtype=w.dtype,
                                   device=w.device)
        self.args = (x, y, lr, n_total, mesh, axis)
        self.graph = graphs.StepGraph(1, w.device, graphed=graphed)

    def _whole(self) -> None:
        _iterate(self.w, self.done, self.history, *self.args)

    def run(self, n: int) -> torch.Tensor:
        if n == CHUNK:
            self.graph.run(1, self._whole)
        else:
            _iterate(self.w, self.done, self.history[:n], *self.args)
        return self.history[:n]


def train_chunk(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor, lr: float,
                n_iters: int = CHUNK):
    """``n_iters`` full-batch iterations on ``w``'s device with the
    reference's convergence semantics (model/mnist_hinge.c:158-171): the
    update is applied *before* the ε check, so the converging iteration's
    update lands, and every later iteration leaves ``w`` frozen (JAX
    ``_chunk_body``/``_train_chunk``). ``y``: ``signed_targets``. Returns
    (w, norms history (n_iters, 10)) as device tensors."""
    return _chunk(w, x, y, lr, n_iters, x.shape[0])


def make_train_chunk_dp(mesh, n_total: int, n_iters: int = CHUNK,
                        axis: str = "data"):
    """DP chunk (JAX ``make_train_chunk_dp``): the examples sharded over
    ``axis`` (``pad_examples``, then ``batch_sharding``), the full-batch
    gradient assembled by one all-reduce an iteration: the trajectory of
    ``train_chunk`` up to the order of the sums (the hinge gradient is an
    example sum). ``n_total``: the true (unpadded) example count, the
    reference's norm/N. ``chunk(w, x, y, lr)`` → (w, norms history)."""

    def chunk(w, x, y, lr):
        return _chunk(w, x, y, lr, n_iters, n_total, mesh, axis)

    return chunk


def pad_examples(x: np.ndarray, labels: np.ndarray, n_ranks: int):
    """Zero example rows up to a multiple of ``n_ranks``: a zero row adds
    exactly 0 to the hinge gradient (JAX ``train``'s padding)."""
    pad = (-x.shape[0]) % n_ranks
    if pad:
        x = np.concatenate([x, np.zeros((pad, x.shape[1]), x.dtype)])
        labels = np.concatenate([labels, np.zeros(pad, labels.dtype)])
    return x, labels


def train(iterations: int, learn_rate: str = None, *args, flags=None):
    if learn_rate is None:
        print("Please supply a number of iterations and a learn rate, "
              "usage:\n\ttrain <iterations> <learn_rate>\n")
        return
    lr = float(learn_rate)
    device = common.device_flag(flags)
    mesh = common.dp_mesh(flags)
    if mesh is not None:
        device = mesh.device
        common.say_eager_rule("dp", device)
    rank0 = common.is_rank0()
    train_csv, _ = common.rank0_first(
        lambda: synth.ensure_mnist(str(common.data_dir())))

    def ensure_weights():
        if not (ckpt_dir() / "weights_0.csv").is_file():
            print("no checkpoint found; initializing")
            init()

    common.rank0_first(ensure_weights)
    w = load_weights(device)
    data = MnistDataset.from_csv(train_csv)
    # matrix_scale 1/255 (:125) in numpy on the host, as the JAX package
    # scales: CUDA's division by a CPU scalar would round some pixels
    # otherwise
    x_np, labels_np = data.x / 255.0, data.y
    n_total = data.num_examples
    if mesh is not None:  # --dp: each rank's examples, zero rows padding
        x_np, labels_np = pad_examples(x_np, labels_np, mesh.size("data"))
        shard = batch_sharding(mesh)
        x_np, labels_np = shard(x_np), shard(labels_np)
    x = torch.from_numpy(x_np).to(device)
    y = signed_targets(torch.from_numpy(labels_np).to(device), x.dtype)
    chunks = Chunks(w, x, y, lr, n_total, mesh)
    i = 0
    while i < iterations:
        chunk = min(CHUNK, iterations - i)
        norms_hist = chunks.run(chunk).cpu().numpy()  # one read per chunk
        i += chunk
        if rank0 and ((i % CHUNK == 0) or i == iterations):  # logUpdate
            print(f"Gradient norms after iteration {i - 1}:")  # (:152)
            for j, nv in enumerate(norms_hist[-1]):
                print(f"\tModel {j}: {nv:.5f}")
        sums = norms_hist.sum(axis=1)
        if (sums < EPSILON).any():              # (:168-171)
            conv = i - chunk + int(np.argmax(sums < EPSILON))
            if rank0:
                print(f"Gradient converged < epsilon after iteration {conv}")
            break
    if rank0:
        save_weights(chunks.w)
        print("Finished training")
    common.launch_done()


def run(num: int = -1, log_update_every: int = 1, flags=None):
    flags = flags or {}
    device = common.device_flag(flags)
    _, test_csv = synth.ensure_mnist(str(common.data_dir()))
    w = load_weights(device)
    data = MnistDataset.from_csv(test_csv)
    if num != -1 and num < 1:
        # 0 would divide by zero below; negatives would slice a wrong
        # prefix and print a negative "accuracy"
        raise SystemExit(f"run: num predictions must be -1 or >= 1, "
                         f"got {num}")
    n = data.num_examples if (num == -1 or num > data.num_examples) else num
    x = data.x[:n] / 255.0
    with torch.no_grad():
        scores = (torch.from_numpy(x).to(device) @ w).cpu().numpy()
    if "reference-scoring" in flags:
        scores = 1.0 - scores                    # the reference's 1 − wᵀx (:70)
    preds = scores.argmax(axis=1)
    labels = data.y[:n].astype(np.int64)
    num_correct = int((preds == labels).sum())
    for i in range(n):
        if log_update_every > 0 and i % log_update_every == log_update_every - 1:
            print(f"Digit {i}:")
            print(visualize_digit(x[i], labels[i]))
            if preds[i] == labels[i]:
                print("\x1b[1;32mCORRECT\x1b[m")
            else:
                print(f"\x1b[1;31mINCORRECT\x1b[m predicted {preds[i]} "
                      f"instead of {labels[i]}")
            for p in range(10):
                print(f"\tModel {p}: {scores[i, p]:.2f}")
            print()
    print(f"Finished running with accuracy {num_correct / n:.5f}")


def main(argv=None) -> int:
    return common.run_cli(
        "mnist_hinge", init, train, run, argv=argv,
        train_usage="train <iterations> <learn_rate>",
        run_usage="run <num> [<output_every_n = 1>]",
        extra_flags=("reference-scoring", "dp"),
        unsupported_flags={"jsonl": common.NO_METRICS_LOG},
    )


if __name__ == "__main__":
    raise SystemExit(main())
