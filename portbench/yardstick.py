"""The benchmark's arithmetic: the card's peaks, model sizes, the FLOPs and
bytes each kernel and step needs, percentiles, and the
reduction of a profiler trace to busy time, kernel time and idle gaps.

Nothing here imports the program. Several pieces are frozen copies of the
program's own measurement code, so that a later change to the program does
not move the yardstick:

* `causal_pairs` is `chip_smoke.py:835`;
* `kernel_group` is `_kernel_group`, `chip_smoke.py:1200`;
* `moe_split_ms` is `_moe_split`, `chip_smoke.py:1470`, and `MOE_RANGES`
  is `chip_smoke.py:1452`;
* `active_params` follows `_active_params`, `chip_smoke.py:1462`;
* `trace_kernels` leaves record_function ranges out of the device ops,
  as `_profile_step`'s device total does (`chip_smoke.py:1216`);
* the flash kernels' operation counts are `_flash_timed`'s
  (`chip_smoke.py:840-907`); their bytes count keys and values at the
  key-value heads, as the attention function takes them.
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional, Sequence, Tuple

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth.
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

MOE_RANGES = ("moe.routing", "moe.dispatch", "moe.experts", "moe.combine")


# -- model sizes -----------------------------------------------------------

def model_dims(doc: Dict) -> Dict:
    """The sizes a configuration file states, under short names."""
    d = int(doc["hidden_size"])
    heads = int(doc["num_attention_heads"])
    return {
        "d": d,
        "layers": int(doc["num_hidden_layers"]),
        "heads": heads,
        "kv_heads": int(doc["num_key_value_heads"]),
        "head_dim": int(doc.get("head_dim") or d // heads),
        "ff": int(doc["intermediate_size"]),
        "experts": int(doc.get("num_local_experts", 0)),
        "top_k": int(doc.get("num_experts_per_tok", 0)),
        "vocab": int(doc["vocab_size"]),
        "rope_theta": float(doc["rope_theta"]),
        "eps": float(doc["rms_norm_eps"]),
        "max_seq": int(doc["max_position_embeddings"]),
        "init_std": float(doc["initializer_range"]),
        "aux_coef": float(doc.get("router_aux_loss_coef", 0.0)),
        "capacity_factor": float(doc.get("capacity_factor", 0.0)),
    }


def leaf_shapes(dims: Dict) -> Dict[str, Tuple[Tuple[int, ...], Optional[float]]]:
    """Every weight leaf in the port's stacked layout, with the std of its
    normal draw (None: ones, the norm weights). Layer leaves lead with
    [layers]."""
    d, L, h, kvh, hd, ff = (dims["d"], dims["layers"], dims["heads"],
                            dims["kv_heads"], dims["head_dim"], dims["ff"])
    std = dims["init_std"]
    out = {
        "embed": ((dims["vocab"], d), std),
        "lm_head": ((d, dims["vocab"]), std),
        "final_norm": ((d,), None),
        "layers.attn_norm": ((L, d), None),
        "layers.wq": ((L, d, h * hd), std),
        "layers.wk": ((L, d, kvh * hd), std),
        "layers.wv": ((L, d, kvh * hd), std),
        "layers.wo": ((L, h * hd, d), std),
        "layers.mlp_norm": ((L, d), None),
    }
    E = dims["experts"]
    if E:
        out["layers.router"] = ((L, d, E), std)
        out["layers.w_gate"] = ((L, E, d, ff), std)
        out["layers.w_up"] = ((L, E, d, ff), std)
        out["layers.w_down"] = ((L, E, ff, d), std)
    else:
        out["layers.w_gate"] = ((L, d, ff), std)
        out["layers.w_up"] = ((L, d, ff), std)
        out["layers.w_down"] = ((L, ff, d), std)
    return out


def param_count(dims: Dict) -> int:
    return sum(math.prod(shape) for shape, _ in leaf_shapes(dims).values())


def expert_params(dims: Dict) -> int:
    return 3 * dims["experts"] * dims["d"] * dims["ff"] * dims["layers"]


def active_params(dims: Dict) -> int:
    """Parameters one token runs through: all but the experts, plus k/E of
    the experts."""
    experts = expert_params(dims)
    if not experts:
        return param_count(dims)
    return (param_count(dims) - experts
            + experts * dims["top_k"] // dims["experts"])


def embed_params(dims: Dict) -> int:
    return dims["vocab"] * dims["d"]


# -- FLOPs and bytes ---------------------------------------------------------

def causal_pairs(lq: int, lk: int) -> int:
    """(q, k) pairs a top-left causal mask keeps: q_pos >= k_pos."""
    return sum(min(i + 1, lk) for i in range(lq))


def attention_flops(dims: Dict, kept_keys: int) -> float:
    """Forward FLOPs of one query's attention in every layer: QK^T and PV
    over `kept_keys` keys, 2 FLOPs a multiply-add."""
    return 4.0 * dims["layers"] * dims["heads"] * dims["head_dim"] * kept_keys


def train_step_flops(dims: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 N_active per token without the
    input embedding, plus the attention products forward and backward
    (3x the forward's 4 L h d per kept key), recomputation not counted."""
    n = active_params(dims) - embed_params(dims)
    tokens = batch * seq
    return (6.0 * n * tokens
            + 3.0 * batch * attention_flops(dims, causal_pairs(seq, seq)))


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory bound."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def flash_cost(b: int, L: int, h: int, kvh: int,
               hd: int) -> Dict[str, Tuple[float, float]]:
    """(FLOPs, bytes) of each flash kernel on causal bf16 attention with
    queries [b, L, h, hd] and keys and values [b, L, kvh, hd], as the
    attention function takes them, whatever implements it.
    products: score-sized matrix products over the kept causal pairs;
    q-sized and kv-sized tensors read plus written (forward: q, k, v read,
    o written; dq: q, do, k, v read, dq written; dk/dv: q, do, k, v read,
    dk, dv written); stats: f32 [b, h, L] rows read or written."""
    q_bytes = b * L * h * hd * 2
    kv_bytes = b * L * kvh * hd * 2
    s_bytes = b * h * L * 4
    pairs = causal_pairs(L, L)
    out = {}
    for name, products, q_n, kv_n, stats in (("flash_fwd", 2, 2, 2, 1),
                                             ("flash_bwd_dq", 3, 3, 2, 2),
                                             ("flash_bwd_dkv", 4, 2, 4, 2)):
        out[name] = (2.0 * products * b * h * hd * pairs,
                     float(q_n * q_bytes + kv_n * kv_bytes + stats * s_bytes))
    return out


def rmsnorm_fwd_bytes(rows: int, d: int, itemsize: int = 2) -> float:
    """x read, w read, y written."""
    return float((2 * rows * d + d) * itemsize)


def rmsnorm_bwd_bytes(rows: int, d: int, itemsize: int = 2) -> float:
    """x, w and the cotangent read; dx and dw written."""
    return float((3 * rows * d + 2 * d) * itemsize)


# -- statistics ----------------------------------------------------------------

def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in 0-100); inf entries count as misses."""
    xs = sorted(values)
    if not xs:
        return math.inf
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


# -- trace reduction -------------------------------------------------------------

def kernel_group(name: str) -> str:
    n = name.lower()
    for key, group in (("flash_fwd", "flash_fwd"), ("flash_bwd_dq", "flash_dq"),
                       ("flash_bwd_dkv", "flash_dkv"),
                       ("rmsnorm_bwd", "rmsnorm_bwd"),
                       ("rmsnorm_dw", "rmsnorm_dw_reduce"),
                       ("rmsnorm_fwd", "rmsnorm_fwd")):
        if key in n:
            return group
    if any(t in n for t in ("gemm", "xmma", "cutlass", "sm90", "nvjet")):
        return "matmul"
    if "adam" in n or "multi_tensor" in n or "foreach" in n:
        return "optimizer"
    return "other"


def trace_kernels(prof) -> Tuple[List[Tuple[str, float, float]],
                                  List[Tuple[str, float, float]]]:
    """(device ops, host events) of a torch.profiler run, each as (name,
    start_s, end_s). Range annotations on the device side are left out,
    as they span kernels rather than run."""
    kernels, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        name = e.name()
        if e.device_type().name == "CUDA":
            if name in MOE_RANGES or name.startswith("portbench.") \
                    or getattr(e, "is_user_annotation", lambda: False)():
                continue
            kernels.append((name, start, end))
        else:
            host.append((name, start, end))
    kernels.sort(key=lambda k: k[1])
    return kernels, host


def busy_intervals(kernels, t0: float, t1: float) -> List[Tuple[float, float]]:
    """The union of the device ops' intervals, clipped to [t0, t1]."""
    out: List[List[float]] = []
    for _, s, e in kernels:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


SHORT_GAP_S = 5e-6


def short_name(kernel: str) -> str:
    """A kernel's name without its return type, namespaces and template or
    call arguments."""
    n = kernel[5:] if kernel.startswith("void ") else kernel
    n = n.split("<", 1)[0].split("(", 1)[0]
    return n.rsplit("::", 1)[-1]


def _labels(host, spans) -> List[str]:
    """What the host was doing in each idle span (ascending (start, end,
    next kernel)): the innermost benchmark range open at its middle, the
    innermost other host event open then on any thread, and the kernel
    that ended the span. One sweep over the host events."""
    host = sorted(host, key=lambda h: h[1])
    out, active, i = [], [], 0
    for s, e, nxt in spans:
        t = (s + e) / 2
        while i < len(host) and host[i][1] <= t:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[2] > t]
        rng = max((h for h in active if h[0].startswith("portbench.")),
                  key=lambda h: h[1], default=None)
        op = max((h for h in active if not h[0].startswith("portbench.")),
                 key=lambda h: h[1], default=None)
        parts = [h[0] for h in (rng, op) if h is not None]
        parts.append("before " + (short_name(nxt) if nxt else "the close"))
        out.append(" / ".join(parts)[:120])
    return out


def trace_summary(prof, window: str = "portbench.window") -> Dict:
    """busy_s, device time by op name and idle gaps by label over the
    traced window: the host range named `window`. Gaps under SHORT_GAP_S
    (back-to-back launches) are summed under one label."""
    kernels, host = trace_kernels(prof)
    _, t0, t1 = next(h for h in host if h[0] == window)
    busy = busy_intervals(kernels, t0, t1)
    by_name: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for name, s, e in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        counts[name] = counts.get(name, 0) + 1
    starts = [k[1] for k in kernels]
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps: Dict[str, float] = {}
    spans = []
    for i in range(0, len(edges), 2):
        s, e = edges[i], edges[i + 1]
        if e - s >= SHORT_GAP_S:
            j = bisect.bisect_left(starts, e)
            spans.append((s, e, kernels[j][0] if j < len(kernels) else None))
        elif e > s:
            gaps["gaps under 5 us"] = gaps.get("gaps under 5 us", 0.0) + e - s
    for (s, e, _), lab in zip(spans, _labels(host, spans)):
        gaps[lab] = gaps.get(lab, 0.0) + (e - s)
    return {
        "busy_s": sum(e - s for s, e in busy),
        "window_s": t1 - t0,
        "by_name": by_name,
        "counts": counts,
        "idle_by_label": gaps,
    }


def top(items: Dict[str, float], n: int = 10) -> List[List]:
    return [[k[:120], v] for k, v in
            sorted(items.items(), key=lambda kv: -kv[1])[:n]]


def moe_split_ms(prof) -> Dict[str, float]:
    """Device ms of the MoE layers' parts in a profiled run: the ops run
    inside each moe.* range (the forward and its recompute) and the
    backward ops that autograd links to them by sequence number."""
    def scoped(e):
        while e is not None:
            if e.name in MOE_RANGES:
                return e.name
            e = e.cpu_parent
        return None

    events = [e for e in prof.events() if e.device_type.name == "CPU"]
    by_seq = {}
    for e in events:
        g = scoped(e)
        if g is not None and e.sequence_nr >= 0:
            by_seq[e.sequence_nr] = g
    ms = dict.fromkeys(MOE_RANGES, 0.0)
    for e in events:
        us = e.self_device_time_total
        if not us:
            continue
        g = scoped(e)
        p = e
        while g is None and p is not None:
            if p.name.startswith("autograd::engine::evaluate_function"):
                g = by_seq.get(p.sequence_nr)
                break
            p = p.cpu_parent
        if g is not None:
            ms[g] += us / 1e3
    return ms
