"""moe_experts_ms_per_step.train: device ms per training step in the MoE
layer's expert products (parallel/moe.py, the `moe.experts` span): the
forward, its recompute and the backward, the f32 casts of the expert
weights included. Counted by the program's own device spans over the
traced steps."""

from portbench import spans

LAYER = "MoE (parallel/moe.py)"
SOURCE = "program_counter"
MOVES = "train_tokens_per_s"


def read(run):
    return spans.ms_per_step(run, ("moe.experts",))
