"""CIFAR-10 binary-batch loader and pixel conversions, the counterpart of
``big_linear_algebra_tpu/data/cifar10.py`` (≈ lib/cifar10.c); host numpy, no
torch.

Record format (lib/cifar10.c:6-11): each batch file holds up to 10000
records of 3073 bytes — 1 label byte + 3072 pixel bytes in RRR…GGG…BBB
planes, rows top-down.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from big_linear_algebra_tpu_torch.data import _native

NUM_EXAMPLES_PER_FILE = 10000
LINE_LENGTH = 3073
DATA_LENGTH = 3072
NUM_PIXELS = 1024
EXAMPLE_DIM = 32


def read_batch(path: str):
    """Load a whole batch file → (labels uint8 (N,), pixels uint8 (N, 3072)),
    through the native reader when it is available."""
    out = _native.cifar_read(str(path), NUM_EXAMPLES_PER_FILE)
    if out is not None:
        return out
    raw = np.frombuffer(Path(path).read_bytes(), dtype=np.uint8)
    n = min(raw.size // LINE_LENGTH, NUM_EXAMPLES_PER_FILE)
    raw = raw[: n * LINE_LENGTH].reshape(n, LINE_LENGTH)
    return raw[:, 0].copy(), raw[:, 1:].copy()


def pixels_to_chw(pixels: np.ndarray, flip_vertical: bool = False):
    """(…, 3072) plane bytes → (…, 3, 32, 32) float32 in [-1, 1] (x/127.5 − 1,
    model/cifar_unet.c:226-231). ``flip_vertical=True`` reproduces the
    reference's row flip for BMP previews (lib/cifar10.c:19-30)."""
    chw = pixels.reshape(*pixels.shape[:-1], 3, EXAMPLE_DIM, EXAMPLE_DIM)
    if flip_vertical:
        chw = chw[..., ::-1, :]
    return chw.astype(np.float32) / 127.5 - 1.0


def chw_to_pixels(chw: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pixels_to_chw` → uint8 plane bytes (for BMP dumps),
    the trailing (3, H, W) flattened whatever the resolution."""
    arr = np.clip(np.round((np.asarray(chw, np.float64) + 1.0) * 127.5),
                  0, 255).astype(np.uint8)
    return arr.reshape(*arr.shape[:-3], -1)


class Cifar10Batches:
    """All examples of a set of batch files, held in RAM (50000×3073 bytes
    ≈ 150 MB at most), sampled per epoch (≈ the U-Net train loop's
    open-all-5-batches + random draw, model/cifar_unet.c:1877-1882)."""

    def __init__(self, paths):
        labels, pixels = zip(*(read_batch(p) for p in paths))
        self.labels = np.concatenate(labels)
        self.pixels = np.concatenate(pixels)

    @property
    def num_examples(self) -> int:
        return self.labels.shape[0]

    def sample(self, rng: np.random.Generator, batch: int):
        """Uniform random batch → (labels (B,), chw float32 (B,3,32,32))."""
        idx = rng.integers(0, self.num_examples, size=batch)
        return self.labels[idx], pixels_to_chw(self.pixels[idx])

    def epoch_batches(self, rng: np.random.Generator, batch: int,
                      drop_remainder: bool = True):
        """One epoch in the order of ``rng.permutation``: (labels, chw)
        batches; the ragged tail is dropped unless ``drop_remainder`` is
        False."""
        perm = rng.permutation(self.num_examples)
        stop = (self.num_examples // batch) * batch if drop_remainder \
            else self.num_examples
        for start in range(0, stop, batch):
            idx = perm[start:start + batch]
            yield self.labels[idx], pixels_to_chw(self.pixels[idx])
