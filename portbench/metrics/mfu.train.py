"""mfu.train: model FLOPs of the training steps over the window, as a share
of the card's bf16 peak (989 TFLOP/s). Per step: 6 N_active per token
without the input embedding, plus the attention products forward and
backward over the kept causal keys (yardstick.train_step_flops);
recomputation is not counted. Steps run under the profiler are left out,
with their time."""

from portbench import yardstick

LAYER = "whole step"
SOURCE = "host_clock"
MOVES = "train_tokens_per_s"


def read(run):
    f = run.facts
    if f.get("kind") != "train" or not f.get("untraced_steps"):
        return None
    return 100.0 * f["step_flops"] * f["untraced_steps"] / (
        yardstick.BF16_FLOPS * f["untraced_s"])
