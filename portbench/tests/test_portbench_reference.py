"""The plain reference against the program at a small size on the CPU
(the same steps and samples from the same seed), the control, and a whole
run of the harness with the timed path broken underneath: each fault makes
``correct`` false."""

import time

import torch

from portbench import reference as ref
from portbench import run as runmod
from portbench.drivers import sample as sample_driver
from portbench.drivers import train as train_driver
from portbench.tests import tiny

CPU = torch.device("cpu")
SEED = 3_000_000_019  # past 32 bits


def test_reference_follows_the_programs_steps():
    """The start from the seed and the replayed call from the program's
    state: every number at rounding; the control's far above."""
    cell = tiny.cell("cifar32_fused.train_b16")
    prog = train_driver.Program(cell, SEED, CPU)
    prog.warm()
    assert prog.before.step == 1 + cell.traffic["steps_per_call"] + 1
    batches = prog.batches()
    want = train_driver.reference_readings(cell, SEED, CPU, batches,
                                           prog.before)
    got = train_driver.numbers(prog.readings, want, cell)
    assert max(got.values()) < 1e-3, got
    control = train_driver.numbers(train_driver.reference_readings(
        cell, SEED, CPU, batches, prog.before, ref.CONTROL), want, cell)
    for name in ("grad_gap", "out_grad_gap", "update_norm_gap"):
        for part in ("start", "replay"):
            key = f"{name}.{part}"
            assert control[key] > 10 * got[key], (key, control, got)


def test_skipped_steps_draw_as_steps():
    """``skip_steps`` leaves the generator where the steps' draws do."""
    model = dict(tiny.TINY)
    x0 = torch.zeros((4, 3, 32, 32))
    params = ref.make_params(torch.Generator().manual_seed(1), model)
    run, skip = (torch.Generator().manual_seed(2) for _ in range(2))
    for _ in range(2):
        ref.loss_and_grads(params, x0, run, model)
    ref.skip_steps(skip, model, x0.shape, 2)
    assert torch.equal(run.get_state(), skip.get_state())


def test_fused_blocks_follow_the_gate():
    model = tiny.cell("cifar32_fused.train_b16").config["model"]
    assert [b[0] for b in ref.fused_sites(model, 4)] == [
        "down_3/resnet_1", "down_3/resnet_2", "down_4/resnet_1",
        "down_4/resnet_2", "mid/resnet_1", "mid/resnet_2", "up_1/resnet_1",
        "up_1/resnet_2", "up_2/resnet_1", "up_2/resnet_2"]
    full = dict(model, embed_dims=[128, 256, 256, 256], group_size=32,
                time_embed_dim=512, key_dim=16)
    # at batch 16 the gate refuses up_2's first block (512 -> 256 at 8x8)
    sites = [b[0] for b in ref.fused_sites(full, 16)]
    assert "up_2/resnet_1" not in sites and "up_2/resnet_2" in sites
    assert len(sites) == 9
    assert ref.fused_sites(dict(full, fused_block=False), 16) == []


def test_reference_samples_as_the_program():
    cell = tiny.cell("cifar32_fused.sample_b32")
    prog = sample_driver.Program(cell, SEED, CPU)
    prog.call()
    call, rows = sample_driver.checked(cell, SEED, 1)
    want = sample_driver.reference_images(cell, SEED, CPU, call, rows)
    err = float(sample_driver.image_errors(prog.outputs[call][rows],
                                           want).max())
    assert err < 1e-5
    ctl = sample_driver.reference_images(cell, SEED, CPU, call, rows,
                                         ref.CONTROL)
    assert float(sample_driver.image_errors(ctl, want).max()) > 100 * err


def measure(cell):
    line, _ = runmod.measure(cell, SEED, 0.5, False, [CPU],
                             time.monotonic())
    import json
    return json.loads(line)


def test_a_sound_run_is_correct():
    for name in ("cifar32_fused.train_b16", "cifar32_fused.sample_b32"):
        out = measure(tiny.cell(name))
        assert out["correct"] and out["failed"] == 0, out
        assert list(out)[-1] == "compared"


def test_a_step_that_leaves_its_state_unchanged_fails(monkeypatch):
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu

    monkeypatch.setattr(cu.TrainSteps, "_one",
                        lambda self: self.counter.add_(1))
    out = measure(tiny.cell("cifar32_fused.train_b16"))
    assert not out["correct"] and out["failed"] > 0


def test_half_of_the_batch_left_out_fails(monkeypatch):
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu

    fit = cu._fit_images
    monkeypatch.setattr(cu, "_fit_images",
                        lambda x, cfg: fit(x[:x.shape[0] // 2], cfg))
    out = measure(tiny.cell("cifar32_fused.train_b16"))
    assert not out["correct"] and out["failed"] > 0


def test_an_altered_answer_fails(monkeypatch):
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu

    sample = cu.sample
    monkeypatch.setattr(cu, "sample",
                        lambda *a, **k: sample(*a, **k).roll(1, 0))
    out = measure(tiny.cell("cifar32_fused.sample_b32"))
    assert not out["correct"] and out["failed"] > 0


def test_a_wrong_adam_update_fails(monkeypatch):
    """Adam with twice the learning rate: the update is wrong, the
    gradient and the first moment are not."""
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu

    update = cu.adam_update_at
    monkeypatch.setattr(cu, "adam_update_at",
                        lambda p, g, s, c, t, lr, **k: update(p, g, s, c, t,
                                                              2 * lr, **k))
    out = measure(tiny.cell("cifar32_fused.train_b16"))
    assert not out["correct"] and out["failed"] > 0
    assert out["compared"]["update_norm_gap.start"]["value"] > 0.5


def test_replays_that_repeat_their_draws_fail(monkeypatch):
    """Steps after the capture that draw what the first of them drew (a
    generator the graph does not advance): after the capturing call's
    eager first step, the same t, noise and dropout at every step."""
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu

    one = cu.TrainSteps._one
    frozen = {}

    def repeat(self):
        if "state" in frozen or (self.step >= 1 and int(self.counter) >= 1):
            self.generator.set_state(
                frozen.setdefault("state", self.generator.get_state()))
        one(self)

    monkeypatch.setattr(cu.TrainSteps, "_one", repeat)
    out = measure(tiny.cell("cifar32_fused.train_b16"))
    assert not out["correct"] and out["failed"] > 0
