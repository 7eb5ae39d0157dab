"""Adam training of the ADM U-Net through the program's graphed train step
(``adm_unet.train_steps``: ``cifar_unet.TrainSteps`` driving ADM's step):
one object holds the parameters, the Adam moments and the replayed CUDA
graph, and every step gathers its images and their class labels from a
device-resident set.

The protocol is ``train.py``'s. Set-up makes the weights
(``reference_adm.make_params``), the set (the mix's ``dataset_rows``
images at the configuration's size, uniform in [-1, 1], and labels uniform
over its classes) and the order (a permutation of the set an epoch) from
the seed and builds the object. It then drives it through its first steps:
- the first step alone, run eagerly (the start): its loss terms (L_simple,
  L_t), its gradient (Adam's first moment over 1 - b1) and its update are
  read;
- a call of ``steps_per_call`` + 1 steps (a step, the capture of
  ``scan_unroll`` steps, replays);
- a call of ``scan_unroll`` steps, one replay, as the window's calls are:
  its loss terms, the gradients as Adam took them and its update are read,
  with the state the program held before it.
The window calls ``run`` with ``steps_per_call`` new batches a call; its
rate counts every image of every step completed over the window's whole
time. The check runs the reference once the window has closed and the
object is freed, ``reference_chunk`` images at a time: the first step from
the seed's weights (in float32, and at bfloat16 rounding for the output
conv's yardstick), and the replayed steps from the state the program held
before them, its draws advanced past the steps in between.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List

import torch

from portbench import harness
from portbench import reference_adm as ref
from portbench.drivers.train import Order, generator, host, leaf_gaps

OUT_LEAF = "out/conv/w"


def program_config(cell: harness.Cell):
    from big_linear_algebra_tpu_torch.models import adm_unet

    fields = {f.name for f in dataclasses.fields(adm_unet.Config)}
    cfg = {k: tuple(v) if isinstance(v, list) else v
           for k, v in harness.config_with_batch(cell).items() if k in fields}
    return adm_unet.Config(**cfg)


def inputs(cell: harness.Cell, seed: int, device):
    """(weights, images, labels, order) of the seed, on the device."""
    model, traffic = cell.config["model"], cell.traffic
    params = ref.make_params(generator(device, seed, "weights"), model)
    rows, side = traffic["dataset_rows"], model["image_size"]
    data = torch.empty((rows, model["in_channels"], side, side),
                       device=device)
    data.uniform_(-1.0, 1.0, generator=generator(device, seed, "data"))
    labels = torch.randint(0, model["num_classes"], (rows,), device=device,
                           generator=generator(device, seed, "labels"))
    order = Order(rows, traffic["batch"], generator(device, seed, "order"))
    return params, data, labels, order


def readings(losses, before: ref.State, after: ref.State) -> dict:
    """The loss terms of the steps from ``before`` to ``after``, the
    gradients as Adam took them (the first moment's change over 1 - b1)
    and the update, leaf by leaf."""
    decay = ref.ADAM_B1 ** (after.step - before.step)
    return {"losses": [[float(v) for v in step] for step in losses],
            "grad": [(b - decay * a) / (1.0 - ref.ADAM_B1)
                     for a, b in zip(before.m, after.m)],
            "update": [b - a for a, b in zip(before.params, after.params)]}


class Program:
    """The program's train-step object, driven through its first steps."""

    def __init__(self, cell: harness.Cell, seed: int, device):
        from big_linear_algebra_tpu_torch.models import adm_unet
        from big_linear_algebra_tpu_torch.nn.optim import adam_init

        self.cell, self.device = cell, device
        self.unroll = cell.config["model"]["scan_unroll"]
        params, self.data, self.labels, self.order = inputs(cell, seed,
                                                            device)
        self.steps = adm_unet.train_steps(
            params, adam_init(params), self.data, self.labels,
            generator(device, seed, "draws"), program_config(cell))
        self.rows = {"start": self.order.take(1)}
        before = ref.State.start(ref.tree_map(lambda p: p.cpu(), params))
        del params
        loss = self.steps.run(self.rows["start"])
        self.readings = {"start": readings(loss.tolist(), before,
                                           self.state())}
        self.steps_done = 1

    def state(self) -> ref.State:
        return ref.State(*(host(ref.leaves(t)) for t in (
            self.steps.params, self.steps.m, self.steps.v)),
            self.steps.step)

    def warm(self) -> None:
        per_call = self.cell.traffic["steps_per_call"]
        self.steps.run(self.order.take(per_call + 1))
        self.steps_done += per_call + 1
        self.before = self.state()
        self.rows["replay"] = self.order.take(self.unroll)
        loss = self.steps.run(self.rows["replay"])
        self.steps_done += self.unroll
        self.readings["replay"] = readings(loss.tolist(), self.before,
                                           self.state())
        harness.synchronize(self.device)

    def call(self) -> int:
        per_call = self.cell.traffic["steps_per_call"]
        self.steps.run(self.order.take(per_call))
        self.steps_done += per_call
        return per_call

    def batches(self) -> Dict[str, List[tuple]]:
        return {k: [(self.data[r], self.labels[r]) for r in rows]
                for k, rows in self.rows.items()}

    def release(self) -> None:
        del self.steps
        torch.cuda.empty_cache()


def reference_readings(cell: harness.Cell, seed: int, device, batches,
                       before: ref.State, prec=ref.EXACT, fault: str = "",
                       update=None, stated: bool = True) -> dict:
    """The reference's ``readings`` of the same steps: the start from the
    seed's weights, the replay from ``before`` with the draws advanced past
    the steps in between, and (``stated``) the start again at the
    configuration's precision. ``prec``, ``fault`` and ``update``: a
    control's precision, a fault planted in the model or loss, in Adam."""
    model = cell.config["model"]
    chunk = cell.traffic.get("reference_chunk")
    ref.no_tf32()
    params = ref.make_params(generator(device, seed, "weights"), model)
    out = {}
    start = ref.State.start(params)
    for part, p in (("start", prec), ("stated", ref.STATED))[:1 + stated]:
        losses, after = ref.train_steps(
            start, batches["start"], generator(device, seed, "draws"), model,
            params, p, update, fault, chunk)
        out[part] = readings(losses, start, after)
    draws = generator(device, seed, "draws")
    ref.skip_steps(draws, model, batches["start"][0][0].shape, before.step)
    on_device = ref.State(*([x.to(device) for x in leaves] for leaves in (
        before.params, before.m, before.v)), before.step)
    losses, after = ref.train_steps(on_device, batches["replay"], draws,
                                    model, params, prec, update, fault, chunk)
    out["replay"] = readings(losses, on_device, after)
    return {part: {"losses": r["losses"], "grad": host(r["grad"]),
                   "update": host(r["update"])} for part, r in out.items()}


def part_numbers(got: dict, want: dict, out_leaf: int) -> Dict[str, float]:
    """One part's numbers: its first step's L_simple and L_t gaps relative
    to the reference's; the median leaf's gradient gap; the output conv's;
    the worst leaf's gap between the update's norms (leaves whose
    reference gradient is under a thousandth of the median leaf's left
    out: they move by round-off alone)."""
    g_norms = [float(torch.linalg.vector_norm(g)) for g in want["grad"]]
    used = [i for i, g in enumerate(g_norms) if g > 0]
    med = statistics.median(g_norms[i] for i in used)
    kept = [i for i in used if g_norms[i] >= 1e-3 * med]
    grad = leaf_gaps(got["grad"], want["grad"], used)
    (simple, vb), (ref_simple, ref_vb) = got["losses"][0], want["losses"][0]
    return {"l_simple_gap": abs(simple - ref_simple) / abs(ref_simple),
            "l_vb_gap": abs(vb - ref_vb) / abs(ref_vb),
            "grad_gap": statistics.median(grad.values()),
            "out_grad_gap": grad[out_leaf],
            "update_norm_gap": max(leaf_gaps(got["update"], want["update"],
                                             kept, of_norms=True).values())}


def numbers(got: dict, want: dict, cell: harness.Cell) -> Dict[str, float]:
    """Every number the limits may hold: ``<number>.<part>``, and
    ``out_grad_ratio.start``: the output conv's gradient gap of the start
    over the reference's own at the configuration's precision."""
    out_leaf = ref.leaf_paths(cell.config["model"]).index(OUT_LEAF)
    found = {f"{k}.{part}": v for part in ("start", "replay")
             for k, v in part_numbers(got[part], want[part],
                                      out_leaf).items()}
    stated = part_numbers(want["stated"], want["start"], out_leaf)
    found["out_grad_ratio.start"] = (found["out_grad_gap.start"]
                                     / stated["out_grad_gap"])
    return found


def judge(got: dict, want: dict, cell: harness.Cell) -> harness.Check:
    found = numbers(got, want, cell)
    compared = {k: (found[k], lim) for k, lim in cell.limits.items()}
    return harness.Check(compared,
                         int(any(v > lim for v, lim in compared.values())))


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        devices, t_start: float) -> dict:
    device = devices[0]
    prog = Program(cell, seed, device)
    prog.warm()
    setup_s = time.monotonic() - t_start
    out = {"context": {"steps_kind": "train",
                       "images_per_step": cell.traffic["batch"],
                       "chips": len(devices)}}
    if trace:
        out["context"]["host_s_per_step"] = harness.host_per_step(
            prog.call, device)
        out["trace"] = harness.traced(prog.call, device)
    else:
        steps, secs = harness.window(prog.call, seconds, device)
        out["metrics"] = {"setup_s": setup_s, "train_images_per_s":
                          steps * cell.traffic["batch"] / secs}
    out["device"] = harness.device_info(devices)
    out["attempted"] = prog.steps_done
    got, batches, before = prog.readings, prog.batches(), prog.before
    prog.release()
    del prog
    want = reference_readings(cell, seed, device, batches, before)
    out["check"] = judge(got, want, cell)
    return out
