"""MNIST-CSV loaders, the counterpart of
``big_linear_algebra_tpu/data/mnist.py`` (≈ lib/mnist_csv.c streaming +
lib/mnist_csv2.c in-RAM).

File format: one example per line, ``label,p0,...,p783,`` with pixel values
0-255 (785 values/line, lib/mnist_csv2.c:8). Host-side numpy, no torch: the
samplers draw from the same ``np.random.Generator`` calls as the JAX
package's, so one seed gives both packages the same indices.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from big_linear_algebra_tpu_torch.data.csv import read_csv_values

MNIST_LINE_LENGTH = 785
MNIST_PIXELS = 784
MNIST_DIM = 28


class MnistCSVStream:
    """Streaming one-example-at-a-time reader (≈ ``MnistCSV`` +
    ``get_next_data``, lib/mnist_csv.c:6), for the legacy per-example
    models. Parses lazily, so a huge file needs no RAM."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "r")
        self.buffer = np.zeros(MNIST_LINE_LENGTH, dtype=np.float32)

    def get_next_data(self) -> bool:
        """Fill ``self.buffer`` with the next label + 784 pixels. Returns
        False at EOF (the reference returns 1, lib/mnist_csv.c:7-10)."""
        index = 0
        token = []
        while index < MNIST_LINE_LENGTH:
            c = self._file.read(1)
            if not c:
                # an EOF-terminated last value (no trailing comma or
                # newline) completes the example, as data/csv.py accepts it
                if token and index == MNIST_LINE_LENGTH - 1:
                    self.buffer[index] = float("".join(token))
                    return True
                return False
            if c == "," or (c == "\n" and token):
                self.buffer[index] = float("".join(token)) if token else 0.0
                token.clear()
                index += 1
            elif c not in "\n\r":
                token.append(c)
        return True

    def __iter__(self) -> Iterator[np.ndarray]:
        while self.get_next_data():
            yield self.buffer.copy()

    def close(self):
        self._file.close()

    def __enter__(self) -> "MnistCSVStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def visualize_digit(pixels: np.ndarray, label=None) -> str:
    """ASCII-art digit (≈ ``visualize_digit_data``, lib/mnist_csv.c:31-47).
    ``pixels`` scaled to [0, 1]; the reference's thresholds 0.32 and 0.6 (its
    legacy ``mnist run`` passes unscaled 0-255 values, SURVEY.md §7.14;
    callers scale)."""
    pixels = np.asarray(pixels).reshape(MNIST_DIM, MNIST_DIM)
    lines = ["=" * MNIST_DIM]
    if label is not None:
        lines.append(f"Data for digit {label:.0f}:")
    for row in pixels:
        lines.append("".join(" " if v < 0.32 else (":" if v < 0.6 else "#")
                             for v in row))
    lines.append("=" * MNIST_DIM)
    return "\n".join(lines)


@dataclasses.dataclass
class MnistDataset:
    """Whole-file in-RAM dataset with sampling (≈ ``mnist_csv_init`` +
    ``get_random_data_{replace,take}``, lib/mnist_csv2.c:13-62).

    ``x``: (N, 784) float32, raw 0-255 pixel values (scaling is the model's
    job). ``y``: (N,) float32 labels. Host numpy arrays, batch-major."""

    x: np.ndarray
    y: np.ndarray

    @property
    def num_examples(self) -> int:
        return self.x.shape[0]

    @classmethod
    def from_csv(cls, path: str) -> "MnistDataset":
        values = read_csv_values(path)
        n = values.size // MNIST_LINE_LENGTH
        values = values[: n * MNIST_LINE_LENGTH].reshape(n, MNIST_LINE_LENGTH)
        return cls(x=np.ascontiguousarray(values[:, 1:]),
                   y=np.ascontiguousarray(values[:, 0]))

    def sample_with_replacement(self, rng: np.random.Generator, batch: int):
        """Uniform with replacement (≈ get_random_data_replace,
        lib/mnist_csv2.c:36)."""
        idx = rng.integers(0, self.num_examples, size=batch)
        return self.x[idx], self.y[idx]

    def epoch_batches(self, rng: np.random.Generator, batch: int,
                      drop_remainder: bool = False):
        """Without-replacement epoch sweep by one permutation: the intended
        semantics of ``get_random_data_take`` (lib/mnist_csv2.c:41; the
        reference's bitmap scan can re-pick a sampled index, SURVEY.md
        §7.14)."""
        perm = rng.permutation(self.num_examples)
        stop = ((self.num_examples // batch) * batch if drop_remainder
                else self.num_examples)
        for start in range(0, stop, batch):
            idx = perm[start:start + batch]
            yield self.x[idx], self.y[idx]
