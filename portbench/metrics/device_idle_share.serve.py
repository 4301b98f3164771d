"""device_idle_share.serve: the share of the traced serving window in which
no operation ran on the card, from the profiler's timeline."""

LAYER = "device"
SOURCE = "device_trace"
MOVES = "itl_p95_ms"


def read(run):
    t = run.facts.get("trace")
    if run.facts.get("kind") != "serve" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
