"""What every run shares: finding a cell's files by name, the run's state,
the card checks, the per-layer readers and the result line.

A cell in BENCHMARK.json names a configuration and a traffic mix; the
harness reads `configs/<config>.json` and `traffic/<traffic>.json`, runs
`drivers/<kind>.py` for the mix's `kind`, and reads each per-layer metric
with `metrics/<metric>.py`. A new cell, configuration, mix, metric or
driver is therefore new files and entries, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

from portbench.yardstick import model_dims

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


def load_benchmark(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(path.parents[2])}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _doc(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of the manifest with its files found by name."""

    def __init__(self, bench: Dict, name: str, here: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"unknown workload {name!r}; have {sorted(cells)}")
        self.here = here
        self.spec = cells[name]
        self.name = name
        self.chips = int(self.spec["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _doc(here.parent / configs[self.spec["config"]]["file"])
        self.traffic = _doc(here / "traffic" / f"{self.spec['traffic']}.json")
        self.kind = self.traffic["kind"]
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        e2e_names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if self._has(m) and m["moves"] in e2e_names]

    def _has(self, metric: Dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def driver(self) -> ModuleType:
        return _load_module(self.here / "drivers" / f"{self.kind}.py",
                            f"portbench_driver_{self.kind}")

    def reader(self, metric: str) -> ModuleType:
        return _load_module(self.here / "metrics" / f"{metric}.py",
                            "portbench_metric_" + metric.replace(".", "_"))


class Run:
    """The state of one run, filled in by its driver."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t0: float, control: Optional[str] = None):
        self.cell = cell
        self.dims = model_dims(cell.config)
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t0 = t0
        self.control = control
        self.setup_s: Optional[float] = None
        self.e2e: Dict[str, float] = {}
        self.facts: Dict = {}
        self.attempted = 0
        self.failed = 0
        self.checks: List[Dict] = []
        self.memory_peak_bytes = 0
        self.breakdown: Optional[Dict] = None
        self.notes: Dict = {}

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t0

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append({"name": name, "value": value, "limit": limit})

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in self.checks)


def forbidden_modules() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def card_notes() -> Dict:
    """The card's name and power limit as nvidia-smi prints them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return {"nvidia_smi": out.stdout.strip() or out.stderr.strip()}
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"nvidia_smi": f"not read ({type(e).__name__})"}


def per_layer_values(run: Run) -> Dict[str, Dict]:
    out = {}
    for m in run.cell.per_layer:
        value = run.cell.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(run: Run, device_kind: str) -> Dict:
    if run.trace:
        metrics = per_layer_values(run)
    else:
        e2e = dict(run.e2e, setup_s=run.setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in run.cell.end_to_end if m["name"] in e2e}
    device = {"platform": "gpu", "kind": device_kind,
              "count": run.cell.chips,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    trace = run.facts.get("trace")
    if run.trace and trace:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
    line = {"correct": run.correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace and run.breakdown:
        line["breakdown"] = run.breakdown
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in run.checks}
    return line
