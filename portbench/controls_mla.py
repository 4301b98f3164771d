"""The controls and faults of the latent-attention training cells
(`drivers/train_mla.py`), and the readings their limits are set from. The
benchmark's own runs never run this.

    python3 -m portbench.controls_mla --workload <name> --seeds 1,2,3 [--sound 4,5,6]

As `portbench.controls` does for the other training cells, for each of
--seeds: the program's own run (its set-up with the checked steps, one
window step, the comparison), the program with AdamW's step a no-op (a
state left unchanged), and, against the float32 reference's readings, the
float8 control put in the program's place and the reference fed the
first half of each batch. For each of --sound: the program's run alone.
Every one goes through the cell's own comparison and prints its numbers
beside their limits and whether it came out correct, one JSON line each.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch

from portbench import controls, harness, mla
from portbench.reference import mistral4 as reference


def train_controls(cell, seed: int, device) -> Dict:
    reference.strict_float32()
    dm, opt = mla.dims(cell.config), cell.traffic["optimizer"]
    out = {"seed": seed, "program": controls.program_run(cell, seed, device)}
    saved = torch.optim.AdamW.step
    torch.optim.AdamW.step = lambda self, *a, **k: None
    try:
        out["state_unchanged"] = controls.program_run(cell, seed, device)
    finally:
        torch.optim.AdamW.step = saved
    batches = controls._checked_batches(cell, seed, device)
    ref = reference.train_readings(dm, seed, batches, opt, device)
    for name, kw in (("float8", {"prec": reference.Precision("float8")}),
                     ("half_batch", {"rows": cell.traffic["batch"] // 2})):
        if device.type == "cuda":
            torch.cuda.empty_cache()
        got = reference.train_readings(dm, seed, batches, opt, device, **kw)
        out[name] = controls._compared(cell, seed, device, got, ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.controls_mla")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--sound", default="")
    args = ap.parse_args(argv)
    cell = harness.Cell(harness.load_benchmark(), args.workload)
    device = torch.device("cuda", 0)

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    def emit(make):
        t = time.perf_counter()
        rec = make()
        rec["seconds"] = time.perf_counter() - t
        print(json.dumps(rec, default=str), flush=True)

    for seed in seeds(args.seeds):
        emit(lambda: train_controls(cell, seed, device))
    for seed in seeds(args.sound):
        emit(lambda: {"seed": seed,
                      "program": controls.program_run(cell, seed, device)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
