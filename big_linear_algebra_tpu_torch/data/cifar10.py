"""CIFAR-10 pixel conversions, the counterpart of
``big_linear_algebra_tpu/data/cifar10.py`` (≈ lib/cifar10.c); host numpy, no
torch.

Ported so far: the conversions the sampler needs. The binary-batch reader
and ``Cifar10Batches`` come with training.

Record format (lib/cifar10.c:6-11): 1 label byte + 3072 pixel bytes in
RRR…GGG…BBB planes, rows top-down.
"""

from __future__ import annotations

import numpy as np

DATA_LENGTH = 3072
NUM_PIXELS = 1024
EXAMPLE_DIM = 32


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
