"""A cell, a configuration, a traffic mix, a per-layer metric and a driver
added as files and manifest entries are found with no edit; the manifest
and the files it names agree; the run refuses JAX."""

import json
import shutil
import sys
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def test_manifest_names_files_that_exist_and_readers_that_agree():
    bench = harness.load_benchmark()
    for c in bench["configs"]:
        doc = json.loads((ROOT / c["file"]).read_text())
        assert doc["source"] == c["source"]
        assert doc["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"])
        assert cell.driver().drive
        assert cell.end_to_end and cell.per_layer
        for m in cell.per_layer:
            reader = cell.reader(m["name"])
            assert (reader.LAYER, reader.SOURCE, reader.MOVES) == (
                m["layer"], m["source"], m["moves"])


def test_new_cell_config_mix_metric_and_driver_are_found(tmp_path):
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_benchmark()
    here = tmp_path / "portbench"
    (here / "configs" / "tiny-dense.json").write_text(json.dumps({
        "source": "https://example.org/tiny", "hidden_size": 64,
        "intermediate_size": 128, "num_attention_heads": 4,
        "num_key_value_heads": 2, "num_hidden_layers": 2,
        "vocab_size": 256, "max_position_embeddings": 256,
        "rope_theta": 1e6, "rms_norm_eps": 1e-5,
        "initializer_range": 0.02, "reduced": []}))
    (here / "traffic" / "echo.json").write_text(json.dumps({"kind": "echo"}))
    (here / "drivers" / "echo.py").write_text(
        "def drive(run):\n"
        "    run.e2e['echo_per_s'] = 1.0\n"
        "    run.facts['echo'] = run.dims['d']\n")
    (here / "metrics" / "echo_width.py").write_text(
        "LAYER = 'echo'\nSOURCE = 'program_counter'\n"
        "MOVES = 'echo_per_s'\n\n\n"
        "def read(run):\n    return run.facts.get('echo')\n")
    bench["configs"].append({"name": "tiny-dense", "source":
                             "https://example.org/tiny", "file":
                             "portbench/configs/tiny-dense.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-dense-echo", "config":
                               "tiny-dense", "traffic": "echo", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "echo_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["tiny-dense-echo"]})
    bench["per_layer"].append({"name": "echo_width", "unit": "1",
                               "better": "higher",
                               "source": "program_counter", "layer": "echo",
                               "moves": "echo_per_s"})
    cell = harness.Cell(bench, "tiny-dense-echo", here=here)
    assert [m["name"] for m in cell.per_layer] == ["echo_width"]
    assert sorted(m["name"] for m in cell.end_to_end) == ["echo_per_s",
                                                          "setup_s"]
    run = harness.Run(cell, 1, 1.0, True, "cpu", 0.0)
    cell.driver().drive(run)
    run.setup_s = 0.5
    run.check("echo", 0.0, 1.0)
    line = harness.result(run, "cpu")
    assert line["metrics"] == {"echo_width": {"value": 64, "unit": "1"}}
    assert list(line)[-1] == "checks"
    run.trace = False
    line = harness.result(run, "cpu")
    assert line["metrics"] == {"echo_per_s": {"value": 1.0, "unit": "1/s"},
                               "setup_s": {"value": 0.5, "unit": "s"}}
    # a metric without "workloads" reaches every cell reporting its moves
    assert "echo_width" not in [m["name"] for m in harness.Cell(
        bench, "mixtral-8x7b-train-1k", here=here).per_layer]


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.Cell(harness.load_benchmark(), "no-such-cell")


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    assert "ray_tpu_torch" not in harness.FORBIDDEN
    monkeypatch.setitem(sys.modules, "ray_tpu_torchx", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "ray_tpu.serve", object())
    assert harness.forbidden_modules() == ["jax", "ray_tpu"]
