"""device_idle_share.train: the share of the traced window (whole training
steps) in which no operation ran on the card, from the profiler's
timeline."""

LAYER = "device"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(run):
    t = run.facts.get("trace")
    if run.facts.get("kind") != "train" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
