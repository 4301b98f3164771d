"""Find the highest rate a serving cell's replica sustains: one replica,
the cell's mix offered at each rate in turn for `--seconds`, each window
drained before the next. Prints one JSON line per rate: requests offered
and finished, TTFT p50 and p90 from due time, ITL p95, output tokens/s,
and the engine's queue at the close. The cell's rate is then written into
its mix file by hand, at about four fifths of the knee.

    python3 -m portbench.sweep --workload <name> --seed <n> --seconds 40 --rates 1.5,2,2.5,3,3.5
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import torch

from portbench import harness, yardstick
from portbench import traffic as traffic_gen
from portbench.drivers import serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    cell = harness.Cell(harness.load_benchmark(), args.workload)
    run = harness.Run(cell, args.seed, args.seconds, False,
                      torch.device("cuda", 0), time.perf_counter())
    replica = serve.build_replica(run)
    first = True
    for rate in (float(r) for r in args.rates.split(",")):
        mix = copy.deepcopy(cell.traffic)
        mix["arrivals"]["rate_per_s"] = rate
        sched = traffic_gen.chat_requests(mix, args.seconds, args.seed,
                                          run.dims["vocab"])
        if first:
            for prompt in sched["systems"]:
                list(replica.stream(prompt, 2, temperature=0.0))
            first = False
        reqs = sched["requests"]
        got = serve.offer(replica, reqs, args.seconds)
        m = serve.window_metrics(reqs, got["t0"], got["close"])
        ttft = [r["times"][0] - r["due_at"] if r["times"] else float("inf")
                for r in reqs]
        print(json.dumps({
            "rate": rate, "offered": len(reqs),
            "finished": sum(len(r["tokens"]) == r["max_new_tokens"]
                            for r in reqs),
            "ttft_p50_s": yardstick.percentile(ttft, 50),
            "ttft_p90_s": m["ttft_p90_s"], "itl_p95_ms": m["itl_p95_ms"],
            "output_tokens_per_s": m["output_tokens_per_s"],
            "waiting_at_close": got["after"]["waiting"],
            "active_at_close": got["after"]["active"]}), flush=True)
    replica.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
