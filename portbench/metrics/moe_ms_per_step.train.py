"""moe_ms_per_step.train: device ms per training step of the MoE layer
(parallel/moe.py): routing, dispatch, experts and combine, forward,
recompute and backward, attributed through the layer's own moe.* ranges
and autograd's sequence numbers (yardstick.moe_split_ms)."""

LAYER = "MoE (parallel/moe.py)"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(run):
    t = run.facts.get("trace")
    if run.facts.get("kind") != "train" or not t or not t.get("moe_ms"):
        return None
    total = sum(t["moe_ms"].values())
    return total / t["steps"] if total > 0 else None
