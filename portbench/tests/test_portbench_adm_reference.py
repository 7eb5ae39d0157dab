"""The ADM reference against the program at the TINY widths on the CPU:
the same steps from the same seed read at rounding, the float8 control and
each planted fault of ``reference_adm.FAULTS`` far from them, and a whole
run of the harness's train_adm driver correct."""

import json
import time

import pytest
import torch

from portbench import harness
from portbench import reference_adm as ref
from portbench import run as runmod
from portbench.drivers import train_adm

CPU = torch.device("cpu")
SEED = 3_000_000_019  # past 32 bits
TINY = {"image_size": 32, "in_channels": 3, "num_channels": 16,
        "channel_mult": [1, 2], "num_res_blocks": 1,
        "attention_resolutions": [32, 16], "num_head_channels": 8,
        "use_new_attention_order": True, "resblock_updown": True,
        "use_scale_shift_norm": True, "class_cond": True,
        "num_classes": 10, "learn_sigma": True, "noise_schedule": "cosine",
        "diffusion_steps": 1000, "dropout": 0.1, "groups": 8,
        "learn_rate": 3e-4, "compute_dtype": "float32",
        "param_dtype": "float32", "fused_block": False, "scan_unroll": 2}
TRAFFIC = {"kind": "train_adm", "batch": 4, "dataset_rows": 32,
           "steps_per_call": 2, "reference_chunk": 2}


def cell() -> harness.Cell:
    real = harness.load_cell("adm_imagenet64.train_b128")
    return harness.Cell(real.name, real.manifest, real.entry,
                        {"model": TINY}, TRAFFIC, real.limits)


@pytest.fixture(scope="module")
def readings():
    c = cell()
    prog = train_adm.Program(c, SEED, CPU)
    prog.warm()
    batches, before = prog.batches(), prog.before
    want = train_adm.reference_readings(c, SEED, CPU, batches, before)
    return c, prog.readings, batches, before, want


def test_reference_follows_the_programs_steps(readings):
    c, got, _, before, want = readings
    assert before.step == 1 + TRAFFIC["steps_per_call"] + 1
    found = train_adm.numbers(got, want, c)
    small = {k: v for k, v in found.items()
             if not k.startswith(("update_norm", "out_grad_ratio"))}
    assert max(small.values()) < 1e-4, found


@pytest.mark.parametrize("kw", [{"prec": ref.CONTROL}] + [
    {"fault": f} for f in ref.FAULTS])
def test_control_and_faults_fail_a_limit(readings, kw):
    c, _, batches, before, want = readings
    flt = train_adm.reference_readings(c, SEED, CPU, batches, before,
                                       stated=False, **kw)
    assert not train_adm.judge(flt, want, c).correct


def test_a_sound_run_is_correct():
    line, _ = runmod.measure(cell(), SEED, 0.5, False, [CPU],
                             time.monotonic())
    out = json.loads(line)
    assert out["correct"] and out["failed"] == 0, out
    assert set(out["metrics"]) == {"setup_s", "train_images_per_s"}
