"""DDPM ancestral sampling through the program's ``cifar_unet.sample``:
back-to-back calls of ``batch`` images, each through all of the
configuration's denoising steps, each capturing and replaying its own CUDA
graph as the program's ``run`` verb does.

Set-up makes the weights from the seed and warms every shape with one call
of ``warmup_steps`` denoising steps at the cell's batch (the kernels, cuDNN
and a capture). Call n draws from its own generator, seeded from (seed, n).
The rate counts the images of the calls completed in the window over the
window's whole time. The check draws one completed call and
``check_images`` of its images from the seed and samples them again with
the reference, from the same weights and draws, once the window has closed.
"""

from __future__ import annotations

import dataclasses
import random
import time

import torch

from portbench import harness
from portbench import reference as ref
from portbench.drivers.train import generator, program_config


class Program:
    def __init__(self, cell: harness.Cell, seed: int, device):
        from big_linear_algebra_tpu_torch.models import cifar_unet as cu

        self.cu, self.cell, self.seed, self.device = cu, cell, seed, device
        self.cfg = program_config(cell)
        self.batch = cell.traffic["batch"]
        self.params = ref.make_params(generator(device, seed, "weights"),
                                      cell.config["model"])
        self.outputs = []

    def warm(self) -> None:
        short = dataclasses.replace(
            self.cfg, timesteps=self.cell.traffic["warmup_steps"])
        self.cu.sample(self.params, generator(self.device, self.seed, "warm"),
                       short, self.batch)
        harness.synchronize(self.device)

    def call(self) -> int:
        g = generator(self.device, self.seed, "call", len(self.outputs))
        self.outputs.append(self.cu.sample(self.params, g, self.cfg,
                                           self.batch))
        return self.batch


def image_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each image's L2 distance from the reference's, over the reference
    image's L2 norm."""
    d = (got.float() - want.float()).flatten(1)
    return torch.linalg.vector_norm(d, dim=1) / torch.linalg.vector_norm(
        want.float().flatten(1), dim=1)


def checked(cell: harness.Cell, seed: int, calls: int):
    """(call, rows) that the check samples again, drawn from the seed."""
    pick = random.Random(harness.subseed(seed, "check"))
    rows = sorted(pick.sample(range(cell.traffic["batch"]),
                              cell.traffic["check_images"]))
    return pick.randrange(calls), rows


def reference_images(cell: harness.Cell, seed: int, device, call: int,
                     rows, prec=ref.EXACT) -> torch.Tensor:
    model = cell.config["model"]
    ref.no_tf32()
    params = ref.make_params(generator(device, seed, "weights"), model)
    return ref.sample(params, generator(device, seed, "call", call), model,
                      cell.traffic["batch"], rows, prec)


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        devices, t_start: float) -> dict:
    device = devices[0]
    prog = Program(cell, seed, device)
    prog.warm()
    setup_s = time.monotonic() - t_start
    steps_per_call = cell.config["model"]["timesteps"]
    out = {"context": {"steps_kind": "sample",
                       "images_per_step": cell.traffic["batch"],
                       "chips": len(devices)}}
    if trace:
        def call():
            prog.call()
            return steps_per_call

        out["context"]["host_s_per_step"] = harness.host_per_step(
            call, device)
        out["trace"] = harness.traced(call, device)
    else:
        images, secs = harness.window(prog.call, seconds, device)
        out["metrics"] = {"setup_s": setup_s,
                          "sample_images_per_s": images / secs}
    out["device"] = harness.device_info(devices)
    out["attempted"] = len(prog.outputs) * prog.batch
    call, rows = checked(cell, seed, len(prog.outputs))
    got = prog.outputs[call][rows]
    del prog
    torch.cuda.empty_cache()
    want = reference_images(cell, seed, device, call, rows)
    errors = image_errors(got, want)
    limit = cell.limits["image_error"]
    out["check"] = harness.Check({"image_error": (float(errors.max()), limit)},
                                 int((errors > limit).sum()))
    return out
