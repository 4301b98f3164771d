#!/usr/bin/env python3
"""Drive the PyTorch port (ray_tpu_torch) on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero and
prints no result line:

  device   the card's name, capability (must be 9.0) and power limit.
  build    builds every CUDA kernel in ray_tpu_torch/csrc (one nvcc per
           source, all at once); seconds counted as set-up.
  kernels  each kernel against its plain PyTorch version at the shapes the
           serving path gives it, in bf16 and f32, with the stated
           tolerance; times at the serving shapes (CUDA graphs of many
           launches, so the device time and not Python's launch rate is
           measured) beside the plain version, one PyTorch library call
           and the memory-bandwidth bound.
  slice    llama3-8b at full width and depth in bf16 (random weights from
           seed 0) behind LLMReplica, paged KV, serving 10 requests; every
           request must finish with its 32 tokens, and the rmsnorm kernel
           must have run 2 * n_layers + 1 times per engine forward pass.
  step     one llama3-8b decode step (8 slots) and one prefill chunk,
           eager (wall and enqueue time) against a CUDA graph replay of
           the same kernels (the card's own time).
  parity   llama3-8b at full width, 2 layers, f32: the engine's greedy
           tokens in paged and slotted mode equal generate()'s, and one
           prefill's logits on the card match the plain path on the CPU.

Then one JSON line of kernel records, the card's name and power limit as
nvidia-smi prints them, and last {"ok": true, "device": {...}}.

It imports nothing of JAX or of the ray_tpu package. It exits non-zero
without a card, and where ray_tpu_torch is not beside it.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
EPS = 1e-6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
KERNEL_ROWS = (1, 5, 8, 64, 2048)
KERNEL_DIMS = (4096, 128)
TIMED_SHAPES = ((8, 4096), (64, 4096))  # decode (8 slots), prefill chunk


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def bf16_ulp_diff(a, b) -> int:
    import torch

    def ordered(t):
        i = t.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def graph_ms(fn, calls: int = 200, reps: int = 5) -> float:
    """Device time of one call: `calls` calls captured in a CUDA graph,
    replayed `reps` times between CUDA events (the least of the reps)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    del graph
    return best


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    emit({"phase": "device", "name": name, "capability": list(cap),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    check(tuple(cap) == (9, 0), f"capability {cap} is not 9.0 (Hopper)")
    return name, smi


def phase_build():
    from ray_tpu_torch import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    secs = time.perf_counter() - t0
    emit({"phase": "build", "seconds": secs, "built": built,
          "kernels": _build.kernel_names()})


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.rmsnorm import _rmsnorm_plain, rmsnorm_cuda

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases, max_abs = [], 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for d in KERNEL_DIMS:
            for rows in KERNEL_ROWS:
                x = (torch.randn((rows, d), generator=gen, device=dev)
                     * 3).to(dtype)
                w = (torch.randn(d, generator=gen, device=dev) * 0.1
                     + 1).to(dtype)
                got = rmsnorm_cuda(x, w, EPS)
                want = _rmsnorm_plain(x, w, EPS)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                max_abs = max(max_abs, err)
                if dtype == torch.float32:
                    ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))
                    case = {"tol": "rtol=atol=1e-5"}
                else:
                    ulp = bf16_ulp_diff(got, want)
                    ok = ulp <= 1
                    case = {"tol": "1 bf16 ulp", "ulp": ulp}
                case.update({"dtype": str(dtype).split(".")[-1],
                             "rows": rows, "d": d, "max_abs_err": err,
                             "ok": ok})
                cases.append(case)
    timed = []
    lib_fn = getattr(F, "rms_norm", None)
    for rows, d in TIMED_SHAPES:
        x = torch.randn((rows, d), generator=gen, device=dev).to(
            torch.bfloat16)
        w = (torch.randn(d, generator=gen, device=dev) * 0.1 + 1).to(
            torch.bfloat16)
        itemsize = x.element_size()
        nbytes = 2 * rows * d * itemsize + d * itemsize
        rec = {
            "rows": rows, "d": d, "dtype": "bfloat16",
            "kernel_ms": graph_ms(lambda: rmsnorm_cuda(x, w, EPS)),
            "plain_ms": graph_ms(lambda: _rmsnorm_plain(x, w, EPS)),
            "library_ms": (graph_ms(lambda: lib_fn(x, (d,), w, EPS))
                           if lib_fn is not None else None),
            "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
        }
        timed.append(rec)
    emit({"phase": "kernels", "name": "rmsnorm_fwd",
          "all_ok": all(c["ok"] for c in cases), "max_abs_err": max_abs,
          "cases": cases, "timed": timed})
    bad = [c for c in cases if not c["ok"]]
    check(not bad, f"rmsnorm_fwd disagrees with its plain version: {bad}")
    return max_abs, timed


def _shared_prompts(rng, vocab):
    lengths = [5, 63, 64, 65, 200, 511, 1000, 1500]
    prompts = [rng.integers(0, vocab, size=n).tolist() for n in lengths]
    prefix = rng.integers(0, vocab, size=512).tolist()  # 32 full pages
    a = prefix + rng.integers(0, vocab, size=9).tolist()
    b = prefix + rng.integers(0, vocab, size=23).tolist()
    return prompts, a, b


def phase_slice():
    import torch

    from ray_tpu_torch.models import configs, init_params
    from ray_tpu_torch.ops.rmsnorm import rmsnorm_cuda
    from ray_tpu_torch.serve.llm import LLMReplica

    cfg = configs.llama3_8b
    new_tokens, num_slots, max_len, chunk, page = 32, 8, 2048, 64, 16
    sampling = {"temperature": 0.8, "top_k": 40, "top_p": 0.95}
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in params["layers"].values()) + sum(
        t.numel() for k, t in params.items() if k != "layers")
    t0 = time.perf_counter()
    rep = LLMReplica(lambda: (params, cfg), num_slots=num_slots,
                     max_len=max_len, prefill_chunk=chunk, kv_mode="paged",
                     page_size=page)
    engine_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts, shared_a, shared_b = _shared_prompts(rng, cfg.vocab_size)
    sampled = {1, 5}  # the 63- and 511-token prompts; shared_b too
    try:
        # The main path starts here: counts at 0 (warm-up counted apart).
        rmsnorm_cuda.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
        eng = rep.engine
        handles = [eng.submit(p, new_tokens, **(sampling if i in sampled
                                                 else {}))
                   for i, p in enumerate(prompts)]
        h_a = eng.submit(shared_a, new_tokens)
        it_a = iter(h_a)
        out_a = [next(it_a)]  # shared_a's prefill is done: pages published
        h_b = eng.submit(shared_b, new_tokens, **sampling)
        outs = [h.result(timeout=600) for h in handles]
        out_a += list(it_a)
        outs += [out_a, h_b.result(timeout=600)]
        window_s = time.perf_counter() - t_start
    finally:
        rep.shutdown()  # joins the engine thread: counts are final
    torch.cuda.synchronize()
    launches = rmsnorm_cuda.launches
    st = rep.stats()
    forwards = st["forward_passes"]
    per_pass = 2 * cfg.n_layers + 1
    all_prompts = prompts + [shared_a, shared_b]
    kv = st["kv"]
    steps_timed = max(1, st["timing"]["steps_timed"])
    step_ms = (st["timing"]["dispatch_ms_total"] + st["timing"][
        "fetch_ms_total"] + st["timing"]["host_ms_total"]) / steps_timed
    rec = {
        "phase": "slice", "model": "llama3-8b", "dtype": "bfloat16",
        "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab_size, "params": n_params,
        "init_params_s": init_s, "engine_build_s": engine_s,
        "kv_mode": kv["mode"], "num_slots": num_slots, "max_len": max_len,
        "prefill_chunk": chunk, "page_size": page,
        "kv_pages": kv["pages_total"] + 1,
        "requests": len(outs), "prompt_lengths": [len(p) for p in all_prompts],
        "finished": sum(len(o) == new_tokens for o in outs),
        "tokens_out": sum(len(o) for o in outs),
        "window_s": window_s,
        "output_tok_per_s": sum(len(o) for o in outs) / window_s,
        "ttft_p50_s": st["latency"]["ttft"]["p50"],
        "ttft_p99_s": st["latency"]["ttft"]["p99"],
        "tpot_p50_s": st["latency"]["tpot"]["p50"],
        "decode_tok_per_s_per_request": (1.0 / st["latency"]["tpot"]["p50"]
                                         if st["latency"]["tpot"]["p50"]
                                         else None),
        "engine_step_ms": step_ms,
        "decode_steps": st["steps"], "prefill_chunks": st["prefill_chunks"],
        "forward_passes": forwards, "rmsnorm_launches": launches,
        "rmsnorm_per_pass": launches / max(1, forwards),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "prefix_hits": kv["prefix_hits"],
        "prefill_tokens_skipped": kv["prefill_tokens_skipped"],
    }
    emit(rec)
    check(rec["finished"] == 10, f"only {rec['finished']}/10 finished")
    check(all(0 <= t < cfg.vocab_size for o in outs for t in o),
          "a token id is out of range")
    check(forwards > 0 and launches == per_pass * forwards,
          f"rmsnorm ran {launches} times in {forwards} passes, "
          f"not {per_pass} per pass")
    check(kv["prefix_hits"] >= 1, "the shared prefix never hit the cache")
    del params, rep, eng
    torch.cuda.empty_cache()
    return launches


def phase_step():
    """Where a serving step's time goes: one paged decode step of 8 slots
    (512 tokens of context each) and one 64-token prefill chunk of
    llama3-8b, each run eagerly back to back (wall time per step, and the
    host's time to enqueue it) and as a CUDA graph replay (the card's own
    time for the same kernels, no host in between). The graph is a
    measuring device only: the engine runs eagerly."""
    import torch

    from ray_tpu_torch.models import configs, init_params
    from ray_tpu_torch.serve import paged_kv

    cfg = configs.llama3_8b
    slots, max_len, page, chunk, ctx = 8, 2048, 16, 64, 512
    params = init_params(cfg, seed=SEED, device="cuda")
    weight_bytes = 2 * (sum(t.numel() for t in params["layers"].values())
                        + sum(t.numel() for k, t in params.items()
                              if k != "layers"))
    mp = max_len // page
    cache = paged_kv.init_paged_cache(cfg, slots, slots * mp + 1, page, mp,
                                      device="cuda")
    bt = torch.arange(1, slots * mp + 1, device="cuda").reshape(slots, mp)
    lengths = torch.full((slots,), ctx, dtype=torch.int64, device="cuda")
    active = torch.ones(slots, dtype=torch.bool, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (slots,), generator=gen,
                           device="cuda")
    chunk_tokens = torch.randint(0, cfg.vocab_size, (1, chunk),
                                 generator=gen, device="cuda")

    def decode():
        paged_kv.decode_paged(params, tokens, cache["k"], cache["v"],
                              lengths, active, bt, None, None, None, None,
                              cfg, max_len)

    def prefill():
        paged_kv.prefill_chunk_paged(params, chunk_tokens, chunk, 0, ctx,
                                     cache["k"], cache["v"],
                                     cache["lengths"], bt, cfg, max_len)

    def eager(fn, n=10):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return wall / n * 1e3, enqueue / n * 1e3

    rec = {"phase": "step", "model": "llama3-8b", "dtype": "bfloat16",
           "slots": slots, "context": ctx, "prefill_chunk": chunk,
           "weights_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3}
    for name, fn in (("decode", decode), ("prefill_chunk", prefill)):
        wall_ms, enqueue_ms = eager(fn)
        dev_ms = graph_ms(fn, calls=4, reps=3)
        rec[name] = {"eager_ms": wall_ms, "enqueue_ms": enqueue_ms,
                     "graph_ms": dev_ms, "device_share": dev_ms / wall_ms}
    emit(rec)
    del params, cache
    torch.cuda.empty_cache()


def phase_parity():
    import torch

    from ray_tpu_torch.models import configs, init_params
    from ray_tpu_torch.models.generate import generate, init_kv_cache, prefill
    from ray_tpu_torch.serve.llm import ContinuousBatchingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(configs.llama3_8b, n_layers=2,
                              dtype=torch.float32)
    params = init_params(cfg, seed=SEED + 1, device="cuda")
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (7, 70, 130)]
    new = 8
    refs = [generate(params, [p], cfg, max_new_tokens=new)[0].tolist()
            for p in prompts]
    outs = {}
    for mode in ("paged", "slotted"):
        eng = ContinuousBatchingEngine(params, cfg, num_slots=4, max_len=256,
                                       prefill_chunk=64, kv_mode=mode,
                                       page_size=16)
        try:
            hs = [eng.submit(p, new) for p in prompts]
            outs[mode] = [h.result(timeout=300) for h in hs]
        finally:
            eng.shutdown()
    p0 = prompts[2]
    tok = torch.tensor([p0], device="cuda")
    logits_gpu, _ = prefill(params, tok, init_kv_cache(
        cfg, 1, len(p0), device="cuda"), cfg)
    cpu_params = {k: (v.cpu() if k != "layers" else
                      {kk: vv.cpu() for kk, vv in v.items()})
                  for k, v in params.items()}
    del params
    torch.cuda.empty_cache()
    logits_cpu, _ = prefill(cpu_params, tok.cpu(), init_kv_cache(
        cfg, 1, len(p0), device="cpu"), cfg)
    g = logits_gpu.cpu()
    err = float((g - logits_cpu).abs().max())
    close = bool(torch.allclose(g, logits_cpu, rtol=1e-3, atol=1e-3))
    rec = {"phase": "parity", "model": "llama3-8b, 2 layers",
           "dtype": "float32", "prompt_lengths": [len(p) for p in prompts],
           "paged_equals_generate": outs["paged"] == refs,
           "slotted_equals_generate": outs["slotted"] == refs,
           "logits_max_abs_err_vs_cpu": err,
           "logits_tol": "rtol=atol=1e-3", "logits_close": close}
    emit(rec)
    check(rec["paged_equals_generate"], "paged engine != generate()")
    check(rec["slotted_equals_generate"], "slotted engine != generate()")
    check(close, f"card logits differ from the CPU's by {err}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import ray_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the ray_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    name, smi = phase_device()
    phase_build()
    max_abs, timed = phase_kernels()
    launches = phase_slice()
    phase_step()
    phase_parity()
    leaked = sorted(m for m in sys.modules
                    if m in ("jax", "ray_tpu") or m.startswith(("jax.",
                                                                "ray_tpu.")))
    check(not leaked, f"JAX or ray_tpu modules were loaded: {leaked}")
    decode = timed[0]
    emit({"kernels": [{
        "name": "rmsnorm_fwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/rmsnorm.cu",
        "replaces": "ray_tpu/ops/rmsnorm.py:49",
        "launches": launches, "max_abs_err": max_abs,
        "ms": decode["kernel_ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"],
        "shape": [decode["rows"], decode["d"]], "dtype": decode["dtype"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
