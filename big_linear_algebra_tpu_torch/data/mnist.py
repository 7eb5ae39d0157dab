"""MNIST-CSV loading, the counterpart of
``big_linear_algebra_tpu/data/mnist.py`` (≈ lib/mnist_csv2.c in-RAM).

File format: one example per line, ``label,p0,...,p783,`` with pixel values
0-255 (785 values/line, lib/mnist_csv2.c:8). The streaming reader and the
samplers come with training.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from big_linear_algebra_tpu_torch.data.csv import read_csv_values

MNIST_LINE_LENGTH = 785
MNIST_PIXELS = 784


@dataclasses.dataclass
class MnistDataset:
    """Whole-file in-RAM dataset (≈ ``mnist_csv_init``, lib/mnist_csv2.c:13).

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
