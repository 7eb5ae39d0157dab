"""Adam training of the U-Net through the program's graphed train steps
(``cifar_unet.TrainSteps``, as its ``train`` verb drives an epoch): one
object holds the parameters, the Adam moments and the replayed CUDA graph,
and every step gathers its batch from a device-resident set.

Set-up makes the weights, the set (the mix's ``dataset_rows`` 32x32
records, uniform in [-1, 1]) and the order (a permutation of the set an
epoch) from the seed and builds the object. It then drives the object
through ``TrainSteps.run``, new batches at every call:
- the first step alone, run eagerly (the start): its loss, its gradient
  (Adam's first moment over 1 - b1) and its update are read;
- a call of ``steps_per_call`` + 1 steps, in which the program runs a
  step eagerly, captures its graph of ``scan_unroll`` steps and replays it;
- a call of ``scan_unroll`` steps, one replay of that graph, as the
  window's calls are: its losses, the gradients as Adam took them (the
  first moment's change over 1 - b1) and its update are read, with the
  state the program held before it.
The window calls ``run`` with ``steps_per_call`` new batches a call; its
rate counts every image of every step completed over the window's whole
time. The check runs the reference once the window has closed and the
object is freed: the first step from the seed's weights, and the replayed
steps from the state the program held before them, its draws advanced past
the steps in between. (A replay can only be read where a call ends, and
the steps before it are chaotic to follow: PERF.md, section 6.)
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List

import torch

from portbench import harness
from portbench import reference as ref


class Order:
    """Batches of row indices, a permutation of the set an epoch."""

    def __init__(self, rows: int, batch: int, generator: torch.Generator):
        self.rows, self.batch, self.generator = rows, batch, generator
        self.perm, self.pos = None, rows

    def take(self, k: int) -> torch.Tensor:
        need = k * self.batch
        if self.pos + need > self.rows:
            self.perm = torch.randperm(self.rows, generator=self.generator,
                                       device=self.generator.device)
            self.pos = 0
        out = self.perm[self.pos:self.pos + need].view(k, self.batch)
        self.pos += need
        return out


def generator(device, seed: int, *keys) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        harness.subseed(seed, *keys))


def program_config(cell: harness.Cell):
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu

    fields = {f.name for f in dataclasses.fields(cu.Config)}
    cfg = {k: tuple(v) if isinstance(v, list) else v
           for k, v in harness.config_with_batch(cell).items() if k in fields}
    return cu.Config(**cfg)


def inputs(cell: harness.Cell, seed: int, device):
    """(weights, data, order) of the seed, on the device."""
    model, traffic = cell.config["model"], cell.traffic
    params = ref.make_params(generator(device, seed, "weights"), model)
    data = torch.empty((traffic["dataset_rows"], model["in_channels"], 32,
                        32), device=device)
    data.uniform_(-1.0, 1.0, generator=generator(device, seed, "data"))
    order = Order(traffic["dataset_rows"], traffic["batch"],
                  generator(device, seed, "order"))
    return params, data, order


def host(tensors) -> List[torch.Tensor]:
    """Float32 copies on the host, leaf by leaf (copies also of tensors
    already there)."""
    return [t.detach().to("cpu", torch.float32, copy=True) for t in tensors]


def readings(losses, before: ref.State, after: ref.State) -> dict:
    """What the check compares of the steps from ``before`` to ``after``:
    their losses, the gradients as Adam took them (the first moment's
    change over 1 - b1: the gradient itself after one step from zero
    moments) and the update (the parameters' change), leaf by leaf."""
    decay = ref.ADAM_B1 ** (after.step - before.step)
    return {"losses": [float(x) for x in losses],
            "grad": [(b - decay * a) / (1.0 - ref.ADAM_B1)
                     for a, b in zip(before.m, after.m)],
            "update": [b - a for a, b in zip(before.params, after.params)]}


class Program:
    """The program's train-step object, driven through its first steps."""

    def __init__(self, cell: harness.Cell, seed: int, device):
        from big_linear_algebra_tpu_torch.models import cifar_unet as cu
        from big_linear_algebra_tpu_torch.nn.optim import adam_init

        self.cell, self.device = cell, device
        self.unroll = cell.config["model"]["scan_unroll"]
        params, self.data, self.order = inputs(cell, seed, device)
        self.steps = cu.TrainSteps(params, adam_init(params), self.data,
                                   generator(device, seed, "draws"),
                                   program_config(cell))
        self.rows = {"start": self.order.take(1)}
        before = ref.State.start(ref.tree_map(lambda p: p.cpu(), params))
        loss = self.steps.run(self.rows["start"])
        self.readings = {"start": readings(loss.tolist(), before,
                                           self.state())}
        self.steps_done = 1

    def state(self) -> ref.State:
        """The object's parameters and moments now, on the host."""
        return ref.State(*(host(ref.leaves(t)) for t in (
            self.steps.params, self.steps.m, self.steps.v)),
            self.steps.step)

    def warm(self) -> None:
        """A call one step longer than the window's (a step, the capture,
        replays), then the checked call: one replay."""
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

    def batches(self) -> Dict[str, List[torch.Tensor]]:
        return {k: [self.data[r] for r in rows]
                for k, rows in self.rows.items()}

    def release(self) -> None:
        del self.steps
        torch.cuda.empty_cache()


def reference_readings(cell: harness.Cell, seed: int, device, batches,
                       before: ref.State, prec=ref.EXACT, update=None,
                       stated: bool = True) -> dict:
    """The reference's ``readings`` of the same steps: the start from the
    seed's weights, the replay from ``before`` (the program's state then)
    with the draws advanced past the steps in between, and (``stated``)
    the start again at the configuration's precision (``ref.STATED``).
    ``prec``: the control's precision; ``update``: a fault planted in
    Adam."""
    model = cell.config["model"]
    ref.no_tf32()
    params = ref.make_params(generator(device, seed, "weights"), model)
    out = {}
    start = ref.State.start(params)
    for part, p in (("start", prec), ("stated", ref.STATED))[:1 + stated]:
        losses, after = ref.train_steps(start, batches["start"], generator(
            device, seed, "draws"), model, params, p, update)
        out[part] = readings(losses, start, after)
    draws = generator(device, seed, "draws")
    ref.skip_steps(draws, model, batches["start"][0].shape, before.step)
    on_device = ref.State(*([x.to(device) for x in leaves] for leaves in (
        before.params, before.m, before.v)), before.step)
    losses, after = ref.train_steps(on_device, batches["replay"], draws,
                                    model, params, prec, update)
    out["replay"] = readings(losses, on_device, after)
    return {part: {"losses": r["losses"], "grad": host(r["grad"]),
                   "update": host(r["update"])} for part, r in out.items()}


def leaf_gaps(got, want, leaves, of_norms: bool = False) -> Dict[int, float]:
    """Each leaf's gap over the larger of the reference's norm of that
    leaf and of the median leaf (over ``leaves``): ‖got − want‖, or
    (``of_norms``) the gap between ‖got‖ and ‖want‖."""
    norm = torch.linalg.vector_norm
    ref_norms = {i: float(norm(want[i])) for i in leaves}
    med = statistics.median(ref_norms.values())
    return {i: (abs(float(norm(got[i])) - r) if of_norms
                else float(norm(got[i] - want[i]))) / max(r, med)
            for i, r in ref_norms.items()}


def part_numbers(got: dict, want: dict, out_leaf: int) -> Dict[str, float]:
    """The numbers of one part (start or replay): its first step's loss
    gap relative to the reference's; the median leaf's gradient gap; the
    output conv's gradient gap; the worst leaf's gap between the update's
    norms. Leaves the model does not use have no gradient and are left
    out; so are, from the update, leaves whose reference gradient is under
    a thousandth of the median leaf's (they move by round-off alone)."""
    g_norms = [float(torch.linalg.vector_norm(g)) for g in want["grad"]]
    used = [i for i, g in enumerate(g_norms) if g > 0]
    med = statistics.median(g_norms[i] for i in used)
    kept = [i for i in used if g_norms[i] >= 1e-3 * med]
    grad = leaf_gaps(got["grad"], want["grad"], used)
    first, ref_first = got["losses"][0], want["losses"][0]
    return {"loss_gap": abs(first - ref_first) / abs(ref_first),
            "grad_gap": statistics.median(grad.values()),
            "out_grad_gap": grad[out_leaf],
            "update_norm_gap": max(leaf_gaps(got["update"], want["update"],
                                             kept, of_norms=True).values())}


def numbers(got: dict, want: dict, cell: harness.Cell) -> Dict[str, float]:
    """Every number the limits may hold: ``<number>.<part>``, and
    ``out_grad_ratio.start``: the output conv's gradient gap of the start
    over the reference's own at the configuration's precision (how far
    bfloat16 rounding moves that gradient on this seed's net)."""
    out_leaf = ref.leaf_paths(cell.config["model"]).index("output_conv")
    found = {f"{k}.{part}": v for part in ("start", "replay")
             for k, v in part_numbers(got[part], want[part],
                                      out_leaf).items()}
    stated = part_numbers(want["stated"], want["start"], out_leaf)
    found["out_grad_ratio.start"] = (found["out_grad_gap.start"]
                                     / stated["out_grad_gap"])
    return found


def judge(got: dict, want: dict, cell: harness.Cell) -> harness.Check:
    """The compared numbers beside their limits; the steps fail where one
    passes its limit."""
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
    want = reference_readings(cell, seed, device, batches, before)
    out["check"] = judge(got, want, cell)
    return out
