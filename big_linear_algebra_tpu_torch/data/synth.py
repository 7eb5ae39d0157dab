"""Synthetic MNIST and CIFAR-10 generation, the counterpart of
``big_linear_algebra_tpu/data/synth.py`` (numpy only, ported as it is).

The reference ships no data, so the framework synthesizes learnable datasets
in the exact reference on-disk formats (MNIST CSV lines of 785 values,
CIFAR-10 3073-byte binary records). For the same seed the files are
byte-identical to the JAX package's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from big_linear_algebra_tpu_torch.data.csv import write_csv_matrix

# Seven-segment layout: segments a-g as (row0, row1, col0, col1) boxes in a
# 24x16 glyph cell, rendered into the 28x28 MNIST canvas.
_SEGS = {
    "a": (0, 3, 2, 14),    # top bar
    "b": (2, 12, 12, 16),  # top right
    "c": (12, 22, 12, 16), # bottom right
    "d": (21, 24, 2, 14),  # bottom bar
    "e": (12, 22, 0, 4),   # bottom left
    "f": (2, 12, 0, 4),    # top left
    "g": (10, 13, 2, 14),  # middle bar
}
_DIGIT_SEGS = {
    0: "abcdef", 1: "bc", 2: "abged", 3: "abgcd", 4: "fgbc",
    5: "afgcd", 6: "afgedc", 7: "abc", 8: "abcdefg", 9: "abcfgd",
}


def _glyph(digit: int) -> np.ndarray:
    cell = np.zeros((24, 16), dtype=np.float32)
    for s in _DIGIT_SEGS[digit]:
        r0, r1, c0, c1 = _SEGS[s]
        cell[r0:r1, c0:c1] = 1.0
    return cell


def synth_mnist_examples(rng: np.random.Generator, n: int):
    """n examples → (labels (n,), pixels uint8-valued float (n, 784)).

    Class-dependent seven-segment glyphs with random translation, amplitude
    jitter, blur-ish smoothing and pixel noise — learnable but not trivial.
    """
    labels = rng.integers(0, 10, size=n)
    out = np.zeros((n, 28, 28), dtype=np.float32)
    glyphs = {d: _glyph(d) for d in range(10)}
    for i, d in enumerate(labels):
        canvas = np.zeros((28, 28), dtype=np.float32)
        dr = rng.integers(0, 5)   # vertical offset 0-4 (24-high glyph)
        dc = rng.integers(0, 13)  # horizontal offset 0-12 (16-wide glyph)
        canvas[dr:dr + 24, dc:dc + 16] = glyphs[int(d)]
        # amplitude jitter + smoothing + noise
        canvas *= rng.uniform(0.6, 1.0)
        canvas = (canvas
                  + 0.25 * np.roll(canvas, 1, axis=0)
                  + 0.25 * np.roll(canvas, 1, axis=1)) / 1.5
        canvas += rng.normal(0, 0.05, canvas.shape)
        out[i] = np.clip(canvas, 0, 1)
    pixels = np.round(out.reshape(n, 784) * 255.0)
    return labels.astype(np.float32), pixels.astype(np.float32)


def write_mnist_csv(path: str, rng: np.random.Generator, n: int) -> None:
    """Write n synthetic examples in the MNIST-CSV line format
    (``label,p0,...,p783,`` — 785 values/line, lib/mnist_csv2.c:8)."""
    labels, pixels = synth_mnist_examples(rng, n)
    rows = np.concatenate([labels[:, None], pixels], axis=1)
    write_csv_matrix(path, rows)


def ensure_mnist(data_dir: str, train_n: int = 8192, test_n: int = 2048,
                 seed: int = 42):
    """Return (train_path, test_path) at the reference's expected layout
    ``<data_dir>/mnist/mnist_train.csv`` / ``mnist_test.csv``
    (model/mnist_nn.c:14-15).

    **Pre-existing files are always preferred and never touched** — real
    MNIST CSVs at those paths make every accuracy number real. Only absent
    files are synthesized, loudly, each from its own stream so a partial
    re-synthesis reproduces that file's draws."""
    d = Path(data_dir) / "mnist"
    train, test = d / "mnist_train.csv", d / "mnist_test.csv"
    missing = [p for p in (train, test) if not p.exists()]
    if missing:
        d.mkdir(parents=True, exist_ok=True)
        for i, (p, n) in enumerate(((train, train_n), (test, test_n))):
            if p in missing:
                write_mnist_csv(str(p), np.random.default_rng([seed, i]), n)
        print(f"synthesized MNIST data ({', '.join(p.name for p in missing)}"
              f" under {d}); place real MNIST CSVs there to train/eval on "
              "real data", flush=True)
    return str(train), str(test)


def synth_cifar_examples(rng: np.random.Generator, n: int):
    """n examples → (labels (n,), pixels uint8 (n, 3072) plane bytes).

    Class-dependent 2-D sinusoid texture + random colored gradient + noise:
    images with smooth statistics (sensible for the DDPM U-Net) and a
    learnable label signal.
    """
    labels = rng.integers(0, 10, size=n)
    yy, xx = np.mgrid[0:32, 0:32] / 32.0
    pixels = np.zeros((n, 3, 32, 32), dtype=np.float32)
    for i, d in enumerate(labels):
        freq = 1 + int(d) % 5
        phase = rng.uniform(0, 2 * np.pi)
        base = 0.5 + 0.35 * np.sin(
            2 * np.pi * freq * (xx * np.cos(phase) + yy * np.sin(phase))
        )
        color = rng.uniform(0.2, 1.0, size=3)
        grad = (rng.uniform(-0.3, 0.3) * (xx - 0.5)
                + rng.uniform(-0.3, 0.3) * (yy - 0.5))
        for c in range(3):
            img = color[c] * base + grad + rng.normal(0, 0.04, (32, 32))
            pixels[i, c] = np.clip(img, 0, 1)
    return (labels.astype(np.uint8),
            np.round(pixels * 255).astype(np.uint8).reshape(n, 3072))


def write_cifar_batch(path: str, rng: np.random.Generator,
                      n: int = 10000) -> None:
    """Write a CIFAR-10 binary batch file (3073-byte records,
    lib/cifar10.c:6-11)."""
    labels, pixels = synth_cifar_examples(rng, n)
    records = np.concatenate([labels[:, None], pixels], axis=1)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(records.tobytes())


def ensure_cifar(data_dir: str, n_batches: int = 5, per_batch: int = 2000,
                 seed: int = 42):
    """Return the CIFAR batch paths at the reference layout
    ``<data_dir>/cifar/data_batch_{1..n}.bin`` (model/cifar_unet.c:1877-1882).

    **Pre-existing batch files are always preferred and never overwritten**
    — the real CIFAR-10 binary batches there make the run a real-data one.
    Only absent batches are synthesized, loudly, each from its own stream
    keyed by its index (a real/synthetic mix is flagged)."""
    d = Path(data_dir) / "cifar"
    paths = [d / f"data_batch_{i}.bin" for i in range(1, n_batches + 1)]
    missing = [p for p in paths if not p.exists()]
    if missing:
        d.mkdir(parents=True, exist_ok=True)
        for p in missing:
            i = paths.index(p) + 1
            write_cifar_batch(str(p), np.random.default_rng([seed, i]),
                              per_batch)
        note = (" (MIXED with pre-existing batches — results are not a "
                "real-data run)" if len(missing) < len(paths) else "")
        print(f"synthesized CIFAR batches "
              f"({', '.join(p.name for p in missing)} under {d}){note}; "
              "place the real CIFAR-10 binary batches there to train on "
              "real data", flush=True)
    return [str(p) for p in paths]
