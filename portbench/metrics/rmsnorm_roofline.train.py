"""rmsnorm_roofline.train: the RMSNorm kernels' (ops/rmsnorm.py,
csrc/rmsnorm.cu) roofline bound over their device time in the traced
training steps, forward and backward. Every norm of the step runs on
[batch * seq, d] rows; the forward's bound is x and w read and y written,
the backward's x, w and the cotangent read and dx and dw written, at the
card's bandwidth."""

from portbench import yardstick

LAYER = "RMSNorm kernels (ops/rmsnorm.py)"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(run):
    f, t = run.facts, run.facts.get("trace")
    if f.get("kind") != "train" or not t:
        return None
    rows, d = f["batch"] * f["seq"], run.dims["d"]
    fwd = yardstick.roofline_s(0.0, yardstick.rmsnorm_fwd_bytes(rows, d))
    bwd = yardstick.roofline_s(0.0, yardstick.rmsnorm_bwd_bytes(rows, d))
    bound = busy = 0.0
    for name, secs in t["by_name"].items():
        g = yardstick.kernel_group(name)
        if g == "rmsnorm_fwd":
            bound += t["counts"][name] * fwd
        elif g == "rmsnorm_bwd":
            bound += t["counts"][name] * bwd
        elif g != "rmsnorm_dw_reduce":
            continue
        busy += secs
    return 100.0 * bound / busy if busy > 0 else None
