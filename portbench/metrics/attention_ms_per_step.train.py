"""attention_ms_per_step.train: device ms per training step in the
layers' attention blocks (models/transformer.py, the `model.attention`
span: norm, q/k/v projections, rope, flash, out projection, residual
add), all three passes. Counted by the program's own device spans over
the traced steps."""

from portbench import spans

LAYER = "model (models/transformer.py)"
SOURCE = "program_counter"
MOVES = "train_tokens_per_s"


def read(run):
    return spans.ms_per_step(run, ("model.attention",))
