"""Training cells of a latent-attention (MLA) model with DeepSeek-V3-style
experts: the loop a TorchTrainer worker runs, in this process, as
`drivers/train.py` runs it for the other training cells, with this
model's configuration, weights and plain reference
(`reference/mistral4.py`).

Set-up builds the step (`ray_tpu_torch.models.loss_fn`, `backward`,
`torch.optim.AdamW.step`) on the seed's weights and drives it through the
job's checked steps, which also warm every shape; the window runs the same
step on fresh batches, each step ending in a synchronize. After the
window the program's state is freed and the reference follows the checked
steps; the numbers compared and their names are `drivers/train.py`'s.
The run's facts carry train.py's names, so its readers read this cell.

A program without latent attention, shared experts or a card's share of
the experts refuses the configuration at once.
"""

from __future__ import annotations

import gc
import inspect
import math
import time
from typing import Dict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import mla
from portbench import traffic as traffic_gen
from portbench.drivers import train
from portbench.reference import mistral4 as reference
from portbench.reference.model import first_ids
from portbench.weights import diff_norm


def port_config(dm: Dict, job: Dict, dtype=torch.bfloat16):
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.parallel.moe import moe_layer

    cap = inspect.signature(moe_layer).parameters["capacity_factor"].default
    if dm["capacity_factor"] != cap:
        raise ValueError(f"the program routes with capacity factor {cap}; "
                         f"the configuration states "
                         f"{dm['capacity_factor']}")
    return TransformerConfig(
        vocab_size=dm["vocab"], d_model=dm["d"], n_layers=dm["layers"],
        n_heads=dm["heads"], n_kv_heads=dm["heads"],
        d_ff=dm["moe_ff"], max_seq=dm["max_seq"],
        rope_theta=dm["rope_theta"], norm_eps=dm["eps"], dtype=dtype,
        num_experts=dm["experts"], experts_per_token=dm["top_k"],
        remat=True, remat_policy=job["remat_policy"],
        q_lora_rank=dm["q_rank"], kv_lora_rank=dm["kv_rank"],
        qk_nope_dim=dm["nope"], qk_rope_dim=dm["rope"],
        v_head_dim=dm["v"], rope_type="yarn",
        rope_factor=dm["rope_factor"],
        rope_original_max=dm["rope_original_max"],
        beta_fast=dm["beta_fast"], beta_slow=dm["beta_slow"],
        mscale=dm["mscale"], mscale_all_dim=dm["mscale_all_dim"],
        rope_interleave=dm["interleave"],
        llama4_scaling_beta=dm["llama4_beta"],
        n_shared_experts=dm["shared"], moe_d_ff=dm["moe_ff"],
        router="sigmoid_bias", norm_topk_prob=dm["norm_topk"],
        routed_scaling_factor=dm["routed_scale"],
        experts_held=range(*dm["held"]))


def _routed_assignments():
    """The program's held-expert assignments counted in the traced steps;
    None where the program does not count them."""
    from ray_tpu_torch.parallel import moe

    read = getattr(moe, "routed_assignments", None)
    return read() if read is not None else None


def drive(run) -> None:
    from ray_tpu_torch.models import loss_fn

    reference.strict_float32()
    job, dev = run.traffic, run.device
    dm = mla.dims(run.cell.config)
    cfg = port_config(dm, job)
    B, S, V = job["batch"], job["seq"], dm["vocab"]
    opt_cfg = job["optimizer"]
    n_check = int(job["check"]["steps"])
    params = mla.make_weights(dm, run.seed, dev)
    names = mla.trained_leaves(dm)

    def leaf(name):
        return params["layers"][name[7:]] if name.startswith("layers.") \
            else params[name]

    leaves = [leaf(n).requires_grad_(True) for n in names]
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
                loss = loss_fn(params, tokens, cfg, aux_weight=0.0)
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
                n: [x.reshape(-1)[mla.sample_index(dm, run.seed, n, dev)]
                    .float().cpu() / (1 - b1)
                    for x in (list(m) if n.startswith("layers.") else [m])]
                for n, m in moments.items()}
            prog["embed_rows"] = (moments["embed"][first_ids(checked[0])]
                                  .float() / (1 - b1)).cpu()
            del moments
    with torch.no_grad():
        prog["change_norms"] = {
            n: diff_norm(p, mla.make_leaf(dm, run.seed, n, dev))
            for n, p in zip(names, leaves)}
    gc.collect()
    train._sync(dev)
    run.setup_done()

    counters = train._launch_counters()
    launches0 = {k: f.launches for k, f in counters.items()}
    tr = job["trace"]
    first, n_traced = int(tr["first_step"]), int(tr["steps"])
    prof, traced, durations, losses = None, [], [], []
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
        train._sync(dev)
        durations.append(time.perf_counter() - t)
        traced.append(profiled)
        if prof is not None and len(durations) == first + n_traced:
            window_range.__exit__(None, None, None)
            prof.stop()
            run.notes["moe_routed_assignments_total"] = \
                _routed_assignments()
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
    run.notes["memory_peak_bytes"] = run.memory_peak_bytes
    run.notes["launches_per_step"] = {
        k: (f.launches - launches0[k]) / steps for k, f in counters.items()}
    plain = [d for d, p in zip(durations, traced) if not p]
    run.facts.update({
        "kind": "train", "steps": steps, "window_s": window_s,
        "step_flops": mla.train_step_flops(dm, B, S),
        "untraced_s": sum(plain), "untraced_steps": len(plain),
        "batch": B, "seq": S,
    })
    if prof is not None:
        train._reduce_trace(run, prof, n_traced)

    del opt, leaves, params, losses, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference.train_readings(dm, run.seed, list(checked), opt_cfg, dev)
    for side, rec in (("program", prog), ("reference", ref)):
        run.notes[side] = {k: v for k, v in rec.items()
                           if k not in ("grad_samples", "embed_rows")}
    run.notes["grad_diff_by_leaf"] = train.sample_gaps(prog["grad_samples"],
                                                       ref["grad_samples"])
    train.compare(run, prog, ref)
