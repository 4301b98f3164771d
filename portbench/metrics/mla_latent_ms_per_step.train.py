"""mla_latent_ms_per_step.train: device ms per training step in latent
attention's projections (models/transformer.py, the `mla.latent` span
inside `model.attention`: q_a, its norm and q_b; kv_a, its norm and kv_b;
rope; the assembly of q and k), all three passes. Counted by the
program's own device spans over the traced steps."""

from portbench import spans

LAYER = "model (models/transformer.py)"
SOURCE = "program_counter"
MOVES = "train_tokens_per_s"


def read(run):
    return spans.ms_per_step(run, ("mla.latent",))
