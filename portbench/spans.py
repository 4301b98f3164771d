"""Device time that the program's own spans counted.

`ray_tpu_torch.util.profiling.device_span_totals()` holds, per span name,
the card's milliseconds in each pass (forward, remat's recompute,
backward). The spans are on while a torch profiler records, so in a
traced training run the totals cover exactly the traced steps. A program
without the counter reads as nothing.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from ray_tpu_torch.util import profiling

# The model's top-level spans: siblings that do not nest.
MODEL_SPANS = ("model.embed", "model.attention", "model.mlp", "model.head")
PASSES = ("forward", "recompute", "backward")


def totals() -> Optional[Dict[str, Dict]]:
    # A program from before the counter reads as nothing, and does not
    # raise.
    read = getattr(profiling, "device_span_totals", None)
    return read() if read is not None else None


def ms_per_step(run, names: Sequence[str],
                passes: Sequence[str] = PASSES) -> Optional[float]:
    """The spans `names`' device ms in `passes`, summed, per traced step of
    a training run; None outside one, or where a span counted nothing."""
    trace = run.facts.get("trace")
    if run.facts.get("kind") != "train" or not trace or not trace["steps"]:
        return None
    got = totals()
    if not got or any(n not in got for n in names):
        return None
    return sum(got[n][f"{p}_ms"] for n in names for p in passes) / \
        trace["steps"]
