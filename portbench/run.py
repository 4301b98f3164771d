"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `ray_tpu_torch`. The run sets up
(weights from the seed, the cell's shapes warmed), measures for
`--seconds`, checks what the timed path produced against the plain
reference, and prints one JSON line last: the end-to-end metrics with
`--trace 0`, the per-layer metrics and a breakdown with `--trace 1`.
Earlier lines carry what the run noted besides (launch counts, the
card's name and power limit, generator lateness). It exits non-zero,
printing no result, without enough CUDA devices, or when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from portbench import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = harness.Cell(harness.load_benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T0)
    cell.driver().drive(run)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules loaded that the port must not use: "
              f"{found}", file=sys.stderr)
        return 3
    run.notes.update(harness.card_notes())
    line = harness.result(run, torch.cuda.get_device_name(0))
    print(json.dumps({"notes": run.notes, "setup_s": run.setup_s},
                     default=str), flush=True)
    for c in run.checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
