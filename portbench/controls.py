"""The controls and faults that show a cell's comparison can fail, and the
readings its limits are set from. The benchmark's own runs never run this.

    python3 -m portbench.controls --workload <name> --seeds 1,2,3 [--sound 4,5,6] [--witness 1,2,3] [--seconds s]

Every control, fault and sound run below goes through the cell's own
comparison (a `harness.Run` with the cell's limits) and prints its numbers
beside their limits and whether it came out correct. One JSON line each.

Training cells, for each of --seeds: the program's own run (its set-up
with the checked steps, one window step, the comparison), then against
the float32 reference's readings (a) the float8 control put in the
program's place, (b) the reference fed the first half of each batch, its
mean taken over the rest, and (c) the program with AdamW's step a no-op,
a step that returns its state unchanged. For each of --sound: the
program's own run alone. For each of --witness: a diagnosis of the
bfloat16 program's gap, not a control: the share of tokens whose top-2
experts differ from the float32 reference's in each layer of the first
step, for the program (its router's choices, read as it makes them) and
for the reference with its products' inputs rounded to bfloat16; and the
first gradient's gaps of that bfloat16 reference, routed on its own and
made to follow the float32 reference's choices.

Serving cells: the cell runs for `--seconds` at its own load and the
float8 control is read over the same sample of served requests: at each
served position, the reference's gap of the token the control puts first.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch

from portbench import harness, yardstick
from portbench import traffic as traffic_gen


def _outcome(run) -> Dict:
    return {"correct": run.correct,
            "checks": {c["name"]: [c["value"], c["limit"]]
                       for c in run.checks},
            "noted": run.notes.get("not_compared", {})}


def _compared(cell, seed: int, device, got: Dict, ref: Dict) -> Dict:
    from portbench.drivers import train

    run = harness.Run(cell, seed, 0, False, device, time.perf_counter())
    train.compare(run, got, ref)
    return _outcome(run)


def program_run(cell, seed: int, device) -> Dict:
    """The cell's own run with a window of one step."""
    run = harness.Run(cell, seed, 0, False, device, time.perf_counter())
    cell.driver().drive(run)
    return _outcome(run)


def _checked_batches(cell, seed: int, device):
    dims = yardstick.model_dims(cell.config)
    job = cell.traffic
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    return list(traffic_gen.train_batches(
        gen, int(job["check"]["steps"]), job["batch"], job["seq"],
        dims["vocab"], device))


def train_controls(cell, seed: int, device) -> Dict:
    from portbench.reference import model as reference

    reference.strict_float32()
    dims, opt = yardstick.model_dims(cell.config), cell.traffic["optimizer"]
    out = {"seed": seed, "program": program_run(cell, seed, device)}
    saved = torch.optim.AdamW.step
    torch.optim.AdamW.step = lambda self, *a, **k: None
    try:
        out["state_unchanged"] = program_run(cell, seed, device)
    finally:
        torch.optim.AdamW.step = saved
    batches = _checked_batches(cell, seed, device)
    ref = reference.train_readings(dims, seed, batches, opt, device)
    for name, kw in (("float8", {"prec": reference.Precision("float8")}),
                     ("half_batch", {"rows": cell.traffic["batch"] // 2})):
        got = reference.train_readings(dims, seed, batches, opt, device,
                                       **kw)
        out[name] = _compared(cell, seed, device, got, ref)
    return out


def _program_routes(cell, seed: int, batch, device) -> Dict:
    """The program's top-2 choices in each MoE layer of the first step's
    forward, as its router makes them: the router's softmax in the
    program's type, the first maximum, then the first maximum of the rest."""
    import torch.nn.functional as F

    import ray_tpu_torch.parallel.moe as pmoe
    from portbench import weights
    from portbench.drivers import train
    from ray_tpu_torch.models import loss_fn

    dims = yardstick.model_dims(cell.config)
    routes: Dict = {}
    route = pmoe.top_k_routing

    def recording(logits, k, capacity):
        if len(routes) < dims["layers"]:
            probs = torch.softmax(logits.detach(), dim=-1)
            first = probs.argmax(-1)
            rest = probs * (1 - F.one_hot(first, probs.shape[-1])
                            .to(probs.dtype))
            routes[len(routes)] = (first, rest.argmax(-1))
        return route(logits, k, capacity)

    pmoe.top_k_routing = recording
    try:
        params = weights.make_weights(dims, seed, device)
        cfg = train.port_config(dims, cell.traffic)
        with torch.no_grad():
            loss_fn(params, batch, cfg, aux_weight=dims["aux_coef"])
    finally:
        pmoe.top_k_routing = route
    del params
    return routes


def _flips(a, b) -> float:
    """The share of tokens whose set of two choices differs."""
    sa = torch.stack(a, -1).sort(-1).values
    sb = torch.stack(b, -1).sort(-1).values
    return float((sa != sb).any(-1).float().mean())


def train_witness(cell, seed: int, device) -> Dict:
    from portbench.drivers import train
    from portbench.reference import model as reference

    reference.strict_float32()
    dims, opt = yardstick.model_dims(cell.config), cell.traffic["optimizer"]
    first = _checked_batches(cell, seed, device)[:1]
    prog = _program_routes(cell, seed, first[0], device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    r32: Dict = {}
    ref = reference.train_readings(
        dims, seed, first, opt, device,
        prec=reference.Precision("float32", routes=r32))
    rbf: Dict = {}
    bf = reference.train_readings(
        dims, seed, first, opt, device,
        prec=reference.Precision("bfloat16", routes=rbf))
    bf_follow = reference.train_readings(
        dims, seed, first, opt, device,
        prec=reference.Precision("bfloat16", routes=r32, follow=True))
    layers = range(dims["layers"])

    def pair(routes, i):
        return [routes[(i, 0)], routes[(i, 1)]]

    def first_gradient(got):
        g = train.gaps(got, ref)
        return {k: g[k] for k in ("grad_diff_gap", "embed_row_gap",
                                  "grad_norm_gap")}

    return {
        "seed": seed,
        "flips_program": [_flips(list(prog[i]), pair(r32, i))
                          for i in layers],
        "flips_bfloat16_reference": [_flips(pair(rbf, i), pair(r32, i))
                                     for i in layers],
        "bfloat16_reference": first_gradient(bf),
        "bfloat16_reference_routed_as_float32": first_gradient(bf_follow),
        "bfloat16_reference_by_leaf": train.sample_gaps(
            bf["grad_samples"], ref["grad_samples"]),
        "routed_as_float32_by_leaf": train.sample_gaps(
            bf_follow["grad_samples"], ref["grad_samples"]),
    }


def serve_controls(cell, seed: int, seconds: float, device) -> Dict:
    run = harness.Run(cell, seed, seconds, False, device,
                      time.perf_counter(), control="float8")
    cell.driver().drive(run)
    control = harness.Run(cell, seed, seconds, False, device, run.t0)
    control.check("served_logit_gap", run.facts["control_gap"],
                  cell.traffic["check"]["limits"]["served_logit_gap"])
    return {"seed": seed, "program": _outcome(run),
            "float8": _outcome(control),
            "checked_tokens": run.notes.get("checked_tokens"),
            "failed": run.failed, "e2e": run.e2e}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.controls")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--sound", default="")
    ap.add_argument("--witness", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
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
        if cell.kind == "train":
            emit(lambda: train_controls(cell, seed, device))
        else:
            emit(lambda: serve_controls(cell, seed, args.seconds, device))
    for seed in seeds(args.sound):
        emit(lambda: {"seed": seed,
                      "program": program_run(cell, seed, device)})
    for seed in seeds(args.witness):
        emit(lambda: train_witness(cell, seed, device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
