"""The ADM cell's yardstick and its readers on small recorded traces:
``adm_forward_flops`` pinned at the published widths, the flash bound at
hand-computed shapes, ``mfu``, ``flash_roofline`` and
``attention_ms_per_step`` of ``.adm_train``, and the train cells' shared
``.train`` readers on the same window."""

import json

import pytest

from portbench import harness, yardstick_adm
from portbench.tests.test_portbench_phases import write

CELL = "adm_imagenet64.train_b128"
NAMES = ("mfu.adm_train", "flash_roofline.adm_train",
         "attention_ms_per_step.adm_train")


def model():
    return harness.load_cell(CELL).config["model"]


def test_forward_flops_at_the_published_widths():
    """219.36 GFLOP an image (2 per multiply-add), linear in the batch."""
    assert yardstick_adm.adm_forward_flops(model()) == 219_356_037_120
    assert yardstick_adm.adm_forward_flops(model(), 3) == 3 * 219_356_037_120


def test_flash_sites_and_bound():
    assert yardstick_adm.flash_sites(model(), 128) == [(768, 1024, 64)] * 7
    # (2, 1024, 64) fwd: 4·1024²·64·2 operations over 989e12, above the
    # bytes 2·4·2·1024·64 + 4·2·1024 = 1,056,768 over 3.35e12
    assert yardstick_adm.flash_bound_s("fwd", 2, 1024, 64, "bfloat16") == \
        pytest.approx(536_870_912 / 989e12, rel=1e-12)
    # (8, 64, 64) fwd: bytes 2·4·8·64·64 + 4·8·64 = 264,192 bound it
    assert yardstick_adm.flash_bound_s("fwd", 8, 64, 64, "bfloat16") == \
        pytest.approx(264_192 / 3.35e12, rel=1e-12)
    # bwd at (2, 1024, 64): 10·1024²·64·2 operations
    assert yardstick_adm.flash_bound_s("bwd", 2, 1024, 64, "bfloat16") == \
        pytest.approx(1_342_177_280 / 989e12, rel=1e-12)
    # bwd at (8, 64, 64): bytes 2·8·8·64·64 + 4·8·64 = 526,336
    assert yardstick_adm.flash_bound_s("bwd", 8, 64, 64, "bfloat16") == \
        pytest.approx(526_336 / 3.35e12, rel=1e-12)


def read(name, trace, steps=2, batch=128):
    cell = harness.load_cell(CELL)
    trace.steps = steps
    patterns = harness.HERE / "metrics" / f"{name}.json"
    reader = harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                                 "adm_reader")
    return reader.read(trace, {"steps_kind": "train", "cell": cell,
                               "images_per_step": batch, "chips": 1},
                       json.loads(patterns.read_text())
                       if patterns.is_file() else {})


def adm_events():
    """Two steps of 40 ms: in each, a flash forward of 1 ms between
    attention marks, a dense block of 2 ms between marks, a 4 ms conv
    outside them, a backward block of 3 ms (K2c 1 ms, K2d 1.5 ms) between
    marks, and Adam's 0.3 ms after its mark."""
    ev = []
    for s in range(2):
        t = 5000.0 + 40000.0 * s
        ev += [("bla_mark_forward", t, 2.0),
               ("bla_mark_attention", t + 10, 2.0),
               ("void flash_fwd_tc<64>(Args)", t + 20, 1000.0),
               ("bla_mark_attention_end", t + 1100, 2.0),
               ("sm90_xmma_fprop_implicit_gemm", t + 1200, 4000.0),
               ("bla_mark_attention", t + 5300, 2.0),
               ("void at::native::reduce_kernel", t + 5310, 2000.0),
               ("bla_mark_attention_end", t + 7400, 2.0),
               ("bla_mark_backward", t + 7500, 2.0),
               ("void at::native::elementwise_kernel", t + 7510, 9470.0),
               ("bla_mark_attention", t + 17000, 2.0),
               ("void flash_bwd_dq_tc<64>(Args)", t + 17010, 1000.0),
               ("void flash_bwd_dkv_tc<64>(Args)", t + 18010, 1500.0),
               ("void at::native::copy_kernel", t + 19510, 500.0),
               ("bla_mark_attention_end", t + 20020, 2.0),
               ("bla_mark_adam", t + 20100, 2.0),
               ("void adam_update_kernel", t + 20110, 300.0)]
    return ev


def test_readers_on_a_recorded_window(tmp_path):
    tr = write(tmp_path / "t.json", adm_events())
    flops = 3 * 2 * yardstick_adm.adm_forward_flops(model(), 128)
    assert read("mfu.adm_train", tr) == pytest.approx(
        100.0 * flops / (989e12 * 0.1))
    least = 7 * (yardstick_adm.flash_bound_s("fwd", 768, 1024, 64,
                                             "bfloat16")
                 + yardstick_adm.flash_bound_s("bwd", 768, 1024, 64,
                                               "bfloat16"))
    assert read("flash_roofline.adm_train", tr) == pytest.approx(
        100.0 * least * 2 / (2 * 3.5e-3))
    # inside the marks: 1 + 2 + 3 ms of kernels and the three start marks'
    # own 2 µs (an end mark closes its span)
    assert read("attention_ms_per_step.adm_train", tr) == pytest.approx(
        6.0 + 3 * 2e-3)


def test_the_train_readers_read_the_adm_window(tmp_path):
    """The cell reports the train cells' phase, dispatch, kernel-class and
    idle readers beside its own: the forward from its mark to the
    backward's (7.010 ms of kernels and marks), the backward to Adam's
    (12.476 ms), Adam to the next forward (0.302 ms)."""
    tr = write(tmp_path / "t.json", adm_events())
    tr.steps = 2
    cell = harness.load_cell(CELL)
    got = harness.read_metrics(cell, tr, {
        "steps_kind": "train", "cell": cell, "images_per_step": 128,
        "chips": 1, "host_s_per_step": 0.25})
    assert set(got) == {m["name"] for m in cell.per_layer()}
    value = {k: v["value"] for k, v in got.items()}
    assert value["forward_ms_per_step.train"] == pytest.approx(7.010)
    assert value["backward_ms_per_step.train"] == pytest.approx(12.476)
    assert value["adam_ms_per_step.train"] == pytest.approx(0.302)
    assert value["host_ms_per_step.train"] == pytest.approx(250.0)
    assert value["device_idle_pct.train"] == pytest.approx(
        100.0 * (1 - tr.busy_s() / 0.1))
    assert value["conv_gemm_ms_per_step.train"] == pytest.approx(4.0)
    assert 0 < value["pointwise_ms_per_step.train"] < 20.0


def test_readers_find_nothing_without_the_program(tmp_path):
    """A program without flash kernels or attention marks (the parent's)
    gives those readers nothing; marks that do not pair up give None."""
    plain = [("void at::native::elementwise_kernel", 5000.0, 1000.0)]
    tr = write(tmp_path / "t.json", plain)
    assert read("flash_roofline.adm_train", tr) is None
    assert read("attention_ms_per_step.adm_train", tr) is None
    unpaired = adm_events()[:3]
    tr = write(tmp_path / "u.json", unpaired)
    assert read("attention_ms_per_step.adm_train", tr) is None
    for name in NAMES:
        tr.steps = 0
        cell = harness.load_cell(CELL)
        reader = harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                                     "adm_reader")
        assert reader.read(tr, {"steps_kind": "train", "cell": cell,
                                "images_per_step": 128, "chips": 1},
                           {"include": [], "exclude": []}) is None
