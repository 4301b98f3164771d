"""moe_routing_dispatch_ms_per_step.train: device ms per training step in
the MoE layer's routing, dense dispatch and combine (parallel/moe.py, the
`moe.routing`, `moe.dispatch` and `moe.combine` spans), all three passes.
Counted by the program's own device spans over the traced steps."""

from portbench import spans

LAYER = "MoE (parallel/moe.py)"
SOURCE = "program_counter"
MOVES = "train_tokens_per_s"


def read(run):
    return spans.ms_per_step(run, ("moe.routing", "moe.dispatch",
                                   "moe.combine"))
