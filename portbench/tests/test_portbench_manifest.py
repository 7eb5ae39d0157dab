"""BENCHMARK.json against the contract's shape, and a cell found by name
from its files alone."""

import json
import re
import shutil

import pytest

from portbench import harness
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_names():
    m = tiny.manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["portbench"]
    assert 1 <= m["run_seconds"] <= 51
    names = [x["name"] for x in m["configs"] + m["workloads"]
             + m["end_to_end"] + m["per_layer"]]
    assert all(NAME.match(n) for n in names)
    metrics = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in (
            "lower", "higher")
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e
    for metric in m["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    for metric in m["per_layer"]:
        assert metric["moves"] in e2e
        assert "\n" not in metric["layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  tiny.manifest()["workloads"]])
def test_every_cell_resolves_from_its_files(cell):
    c = harness.load_cell(cell)
    assert (harness.HERE / "drivers" / f"{c.traffic['kind']}.py").is_file()
    reported = {m["name"] for m in c.end_to_end()}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer(), "every cell reports a per-layer metric"
    for metric in c.per_layer():
        assert (harness.HERE / "metrics" / f"{metric['name']}.py").is_file()
        assert metric["moves"] in reported
    assert c.limits and all(v > 0 for v in c.limits.values())


def test_configs_files_are_their_own():
    m = tiny.manifest()
    files = [c["file"] for c in m["configs"]]
    assert len(set(files)) == len(files)
    for c in m["configs"]:
        data = json.loads((tiny.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert all(k in data["model"] for k in c["reduced"])


def test_adding_files_and_an_entry_adds_a_cell(tmp_path):
    """A new cell is an entry and data files: no code file changes."""
    bench = tmp_path / "portbench"
    shutil.copytree(harness.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = tiny.manifest()
    m["workloads"].append({"name": "cifar32_fused.train_b64",
                           "config": "cifar32_fused", "traffic": "train_b64",
                           "chips": 1, "why": "a larger batch"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if "cifar32_fused.train_b16" in metric.get("workloads", []):
            metric["workloads"].append("cifar32_fused.train_b64")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    traffic = json.loads((bench / "traffic" / "train_b16.json").read_text())
    traffic["batch"] = 64
    (bench / "traffic" / "train_b64.json").write_text(json.dumps(traffic))
    (bench / "workloads" / "cifar32_fused.train_b64.json").write_text(
        (bench / "workloads" / "cifar32_fused.train_b16.json").read_text())
    cell = harness.load_cell("cifar32_fused.train_b64", tmp_path, bench)
    assert cell.traffic["batch"] == 64
    assert harness.config_with_batch(cell)["batch_size"] == 64
    assert "k5_roofline.train" in {x["name"] for x in cell.per_layer()}
    assert {x["name"] for x in cell.end_to_end()} == {
        "setup_s", "train_images_per_s"}


def test_a_missing_cell_gives_no_result():
    with pytest.raises(harness.NoResult):
        harness.load_cell("no_such.cell")
