"""flash_roofline.train: the flash kernels' (ops/flash_attention.py,
csrc/flash_attention.cu) roofline bound over their device time, summed
over the forward, dq and dk/dv launches in the traced steps. The bound of
a launch is yardstick.flash_cost at the cell's batch, sequence, query and
key-value heads and head size (kept causal pairs only; each input byte of
the attention function read once, each output byte written once),
whatever kernel runs it."""

from portbench import yardstick

LAYER = "flash kernels (ops/flash_attention.py)"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"
GROUPS = {"flash_fwd": "flash_fwd", "flash_dq": "flash_bwd_dq",
          "flash_dkv": "flash_bwd_dkv"}


def read(run):
    f, t = run.facts, run.facts.get("trace")
    if f.get("kind") != "train" or not t:
        return None
    d = run.dims
    cost = yardstick.flash_cost(f["batch"], f["seq"], d["heads"],
                                d["kv_heads"], d["head_dim"])
    bound = busy = 0.0
    for name, secs in t["by_name"].items():
        g = GROUPS.get(yardstick.kernel_group(name))
        if g is None:
            continue
        bound += t["counts"][name] * yardstick.roofline_s(*cost[g])
        busy += secs
    return 100.0 * bound / busy if busy > 0 else None
