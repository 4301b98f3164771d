"""recompute_ms_per_step.train: device ms per training step that remat
spends recomputing the forward in the backward (models/transformer.py):
the recompute pass of the model's top-level spans. Counted by the
program's own device spans over the traced steps."""

from portbench import spans

LAYER = "model (models/transformer.py)"
SOURCE = "program_counter"
MOVES = "train_tokens_per_s"


def read(run):
    return spans.ms_per_step(run, spans.MODEL_SPANS, ("recompute",))
