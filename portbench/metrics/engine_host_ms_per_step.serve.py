"""engine_host_ms_per_step.serve: host ms per engine step (serve/llm.py
ContinuousBatchingEngine): the growth of the engine's dispatch and host
time totals over the growth of its timed steps, over the part of the
window the profiler did not cover (its callbacks on every launch slow the
host), or the whole window where nothing was traced."""

LAYER = "engine (serve/llm.py)"
SOURCE = "program_counter"
MOVES = "itl_p95_ms"


def read(run):
    f = run.facts
    if f.get("kind") != "serve":
        return None
    start = f["untraced"][1] if f.get("untraced") else f["before"]
    a, b = start["timing"], f["after"]["timing"]
    steps = b["steps_timed"] - a["steps_timed"]
    if steps <= 0:
        return None
    return (b["dispatch_ms_total"] + b["host_ms_total"]
            - a["dispatch_ms_total"] - a["host_ms_total"]) / steps
