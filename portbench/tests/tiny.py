"""A small configuration and mixes for running the harness on the CPU."""

import json
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]

TINY = {"image_size": 32, "in_channels": 3, "embed_dims": [8, 12, 12, 12],
        "time_embed_dim": 16, "kernel_size": 3, "group_size": 4,
        "key_dim": 4, "dropout_rate": 0.1, "resize_stride": 2,
        "timesteps": 8, "beta_start": 1e-4, "beta_end": 0.02,
        "learn_rate": 2e-4, "compute_dtype": "float32",
        "param_dtype": "float32", "fused_block": True, "layout": "NCHW",
        "remat": False, "scan_unroll": 4}
TRAFFIC = {
    "train": {"kind": "train", "batch": 4, "dataset_rows": 64,
              "steps_per_call": 4},
    "sample": {"kind": "sample", "batch": 4, "warmup_steps": 4,
               "check_images": 2},
}


def cell(name: str, **model) -> harness.Cell:
    """The manifest's cell ``name`` with its own limits, at the small size
    (the mix of its kind at batch 4, the TINY widths, in float32)."""
    real = harness.load_cell(name)
    return harness.Cell(name, real.manifest, real.entry,
                        {"model": dict(TINY, **model)},
                        TRAFFIC[real.traffic["kind"]], real.limits)


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)
