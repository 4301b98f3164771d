"""elementwise_ms_per_step.train: device ms per training step of the ops
that are neither matrix products, flash or RMSNorm kernels nor the
optimizer (yardstick.kernel_group's "other": elementwise, reductions,
indexing, the MoE's routing bookkeeping)."""

from portbench import yardstick

LAYER = "model (models/transformer.py)"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(run):
    t = run.facts.get("trace")
    if run.facts.get("kind") != "train" or not t:
        return None
    s = sum(v for k, v in t["by_name"].items()
            if yardstick.kernel_group(k) == "other")
    return s * 1e3 / t["steps"] if s > 0 else None
