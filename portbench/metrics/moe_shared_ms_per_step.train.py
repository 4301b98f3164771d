"""moe_shared_ms_per_step.train: device ms per training step in the MoE
layers' shared expert (models/transformer.py, the `moe.shared` span inside
`model.mlp`: its SwiGLU on every token), all three passes. Counted by the
program's own device spans over the traced steps."""

from portbench import spans

LAYER = "model (models/transformer.py)"
SOURCE = "program_counter"
MOVES = "train_tokens_per_s"


def read(run):
    return spans.ms_per_step(run, ("moe.shared",))
