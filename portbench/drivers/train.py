"""Training cells: the loop a TorchTrainer worker runs, in this process.

Set-up builds the step (`ray_tpu_torch.models.loss_fn`, `backward`,
`torch.optim.AdamW.step`) on the seed's weights and drives it through the
job's checked steps, which also warm every shape; the window runs the same
step on fresh batches, each step ending in a synchronize. After the
window the program's state is freed and the reference follows the checked
steps: each step's loss, each leaf's first gradient (read from AdamW's
first moment after one step), its embedding rows, and each leaf's change
over the checked steps are compared.
"""

from __future__ import annotations

import gc
import inspect
import math
import statistics
import time
from typing import Dict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import traffic as traffic_gen
from portbench import weights, yardstick
from portbench.reference import model as reference


def port_config(dims: Dict, job: Dict, dtype=torch.bfloat16):
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.parallel.moe import moe_layer

    cap = inspect.signature(moe_layer).parameters["capacity_factor"].default
    if dims["experts"] and dims["capacity_factor"] != cap:
        raise ValueError(f"the program routes with capacity factor {cap}; "
                         f"the configuration states "
                         f"{dims['capacity_factor']}")
    return TransformerConfig(
        vocab_size=dims["vocab"], d_model=dims["d"],
        n_layers=dims["layers"], n_heads=dims["heads"],
        n_kv_heads=dims["kv_heads"], d_ff=dims["ff"],
        max_seq=dims["max_seq"], rope_theta=dims["rope_theta"],
        norm_eps=dims["eps"], dtype=dtype, num_experts=dims["experts"],
        experts_per_token=dims["top_k"] or 2, remat=True,
        remat_policy=job["remat_policy"])


def leaf_gap(got: Dict[str, float], want: Dict[str, float], names) -> float:
    """The worst leaf's gap between two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    names = list(names)
    med = statistics.median(want[n] for n in names)
    return max(abs(got[n] - want[n]) / max(want[n], med) for n in names)


def moved_leaves(grad_norms: Dict[str, float]):
    """Leaves whose reference gradient is not nought to rounding: at least
    a thousandth of the median leaf's."""
    med = statistics.median(grad_norms.values())
    return [n for n, g in grad_norms.items() if g >= 1e-3 * med]


def sample_gaps(got: Dict, want: Dict) -> Dict[str, float]:
    """Each leaf's norm of the difference between two gradients on the
    seed's sampled elements, over the reference's norm there or the median
    leaf's, whichever is larger."""
    diff, norm = {}, {}
    for n in want:
        a, b = torch.cat(got[n]).double(), torch.cat(want[n]).double()
        diff[n], norm[n] = float((a - b).norm()), float(b.norm())
    med = statistics.median(norm.values())
    return {n: diff[n] / max(norm[n], med) for n in want}


def row_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each row's norm of the difference over the reference row's norm."""
    got, want = got.double(), want.double()
    return (got - want).norm(dim=1) / want.norm(dim=1)


def gaps(got: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared: the widest relative gap of a checked step's
    loss; the worst leaf's gap of the first gradient's norm and of the
    change's norm over the checked steps (leaves the reference's gradient
    leaves unmoved are left out of the change); the worst leaf's relative
    difference of the first gradient on sampled elements; and the median
    token id's relative difference of its embedding row's first gradient,
    the input gradient of that id's tokens.

    Rounding to bfloat16 flips some tokens' top-2 expert choices, and a
    flip changes that token's terms and, through attention and the later
    layers' routing, a little of every other token's: a leaf's gradient,
    a sum over all tokens, then differs by a large share even where the
    arithmetic is sound, and rounding below bfloat16 does not raise that
    share threefold. The median row is one token id's own gradient and
    reads past the tokens the flips changed most."""
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(got["losses"], ref["losses"])),
        "grad_norm_gap": leaf_gap(got["grad_norms"], ref["grad_norms"],
                                  ref["grad_norms"]),
        "update_norm_gap": leaf_gap(got["change_norms"],
                                    ref["change_norms"],
                                    moved_leaves(ref["grad_norms"])),
        "grad_diff_gap": max(sample_gaps(got["grad_samples"],
                                         ref["grad_samples"]).values()),
        "embed_row_gap": float(row_gaps(got["embed_rows"],
                                        ref["embed_rows"]).median()),
    }


def compare(run, prog: Dict, ref: Dict) -> None:
    """Check each number the job gives a limit; note the others (a number
    that no control or fault separates from sound runs has no limit)."""
    limits = run.traffic["check"]["limits"]
    for name, value in gaps(prog, ref).items():
        if name in limits:
            run.check(name, value, limits[name])
        else:
            run.notes.setdefault("not_compared", {})[name] = value


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launch_counters() -> Dict:
    from ray_tpu_torch.ops.flash_attention import (flash_bwd_dkv_cuda,
                                                   flash_bwd_dq_cuda,
                                                   flash_fwd_cuda)
    from ray_tpu_torch.ops.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda

    return {"rmsnorm_fwd": rmsnorm_cuda, "rmsnorm_bwd": rmsnorm_bwd_cuda,
            "flash_fwd": flash_fwd_cuda, "flash_bwd_dq": flash_bwd_dq_cuda,
            "flash_bwd_dkv": flash_bwd_dkv_cuda}


def drive(run) -> None:
    from ray_tpu_torch.models import loss_fn

    reference.strict_float32()
    job, dims, dev = run.traffic, run.dims, run.device
    B, S, V = job["batch"], job["seq"], dims["vocab"]
    opt_cfg = job["optimizer"]
    n_check = int(job["check"]["steps"])
    cfg = port_config(dims, job)
    params = weights.make_weights(dims, run.seed, dev)
    names = weights.leaf_names(dims)
    leaves = [weights.get_leaf(params, n).requires_grad_(True) for n in names]
    opt = torch.optim.AdamW(leaves, lr=opt_cfg["lr"],
                            betas=tuple(opt_cfg["betas"]), eps=opt_cfg["eps"],
                            weight_decay=opt_cfg["weight_decay"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(run.seed % (2 ** 63))
    checked = traffic_gen.train_batches(gen, n_check, B, S, V, dev)

    def step(tokens):
        with record_function("portbench.step"):
            opt.zero_grad(set_to_none=True)
            with record_function("portbench.forward"):
                loss = loss_fn(params, tokens, cfg,
                               aux_weight=dims["aux_coef"])
            with record_function("portbench.backward"):
                loss.backward()
            with record_function("portbench.optimizer"):
                opt.step()
        return loss.detach()

    prog = {"losses": []}
    for i in range(n_check):
        prog["losses"].append(float(step(checked[i])))
        if i == 0:
            b1 = opt_cfg["betas"][0]
            # A step that never reached the optimizer leaves no moment.
            moments = {n: opt.state[p]["exp_avg"] if "exp_avg" in
                       opt.state[p] else torch.zeros_like(p)
                       for n, p in zip(names, leaves)}
            prog["grad_norms"] = {
                n: float(m.float().norm()) / (1 - b1)
                for n, m in moments.items()}
            prog["grad_samples"] = {
                n: [x.reshape(-1)[weights.sample_index(dims, run.seed, n,
                                                       dev)].float().cpu()
                    / (1 - b1) for x in weights.slices(m, n)]
                for n, m in moments.items()}
            prog["embed_rows"] = (moments["embed"][reference.first_ids(
                checked[0])].float() / (1 - b1)).cpu()
            del moments
    with torch.no_grad():
        prog["change_norms"] = {
            n: weights.diff_norm(p, weights.make_leaf(dims, run.seed, n, dev))
            for n, p in zip(names, leaves)}
    gc.collect()
    _sync(dev)
    run.setup_done()

    counters = _launch_counters()
    launches0 = {k: f.launches for k, f in counters.items()}
    tr = job["trace"]
    first, n_traced = int(tr["first_step"]), int(tr["steps"])
    prof, traced, durations, losses = None, [], [], []
    flops = yardstick.train_step_flops(dims, B, S)
    t_w0 = time.perf_counter()
    while True:
        profiled = run.trace and first <= len(durations) < first + n_traced
        if profiled and prof is None:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
            window_range = record_function("portbench.window")
            window_range.__enter__()
        t = time.perf_counter()
        tokens = traffic_gen.train_batches(gen, 1, B, S, V, dev)[0]
        losses.append(step(tokens))
        _sync(dev)
        durations.append(time.perf_counter() - t)
        traced.append(profiled)
        if prof is not None and len(durations) == first + n_traced:
            window_range.__exit__(None, None, None)
            prof.stop()
        done_tracing = not run.trace or len(durations) >= first + n_traced
        if time.perf_counter() - t_w0 >= run.seconds and done_tracing:
            break
    window_s = time.perf_counter() - t_w0
    steps = len(durations)
    run.attempted = steps
    run.failed = sum(1 for x in losses if not math.isfinite(float(x)))
    run.e2e["train_tokens_per_s"] = steps * B * S / window_s
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else 0)
    run.notes["launches_per_step"] = {
        k: (f.launches - launches0[k]) / steps for k, f in counters.items()}
    plain = [d for d, p in zip(durations, traced) if not p]
    run.facts.update({
        "kind": "train", "steps": steps, "window_s": window_s,
        "step_flops": flops, "untraced_s": sum(plain),
        "untraced_steps": len(plain), "batch": B, "seq": S,
    })
    if prof is not None:
        _reduce_trace(run, prof, n_traced)

    del opt, leaves, params, losses, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference.train_readings(dims, run.seed, list(checked), opt_cfg, dev)
    for side, rec in (("program", prog), ("reference", ref)):
        run.notes[side] = {k: v for k, v in rec.items()
                           if k not in ("grad_samples", "embed_rows")}
    run.notes["grad_diff_by_leaf"] = sample_gaps(prog["grad_samples"],
                                                 ref["grad_samples"])
    compare(run, prog, ref)


def _reduce_trace(run, prof, n_traced: int) -> None:
    summary = yardstick.trace_summary(prof)
    summary["steps"] = n_traced
    summary["moe_ms"] = (yardstick.moe_split_ms(prof)
                         if run.dims["experts"] else None)
    run.facts["trace"] = summary
    run.breakdown = {"device_ops": yardstick.top(summary["by_name"]),
                     "idle_gaps": yardstick.top(summary["idle_by_label"])}
