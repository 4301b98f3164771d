#!/usr/bin/env python3
"""Drive the PyTorch port (ray_tpu_torch) on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero and
prints no result line:

  device   the card's name, capability (must be 9.0) and power limit.
  build    builds every CUDA kernel in ray_tpu_torch/csrc (one nvcc per
           source, all at once); seconds counted as set-up; each flash
           kernel's registers, spills (ptxas -v) and shared memory.
  kernels  the RMSNorm forward against its plain PyTorch version at the
           shapes the serving and training paths give it, in bf16 and
           f32, with the stated tolerance; times at those shapes (CUDA
           graphs of many launches, so the device time and not Python's
           launch rate is measured) beside the plain version, one
           PyTorch library call and the memory-bandwidth bound.
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
  train_kernels
           the training kernels (rmsnorm backward; flash-attention
           forward, dq and dk/dv) against their plain versions at the
           training shapes and ragged ones, in bf16 and f32, with the
           stated tolerances; times at the training shapes beside the
           plain version, the bound and one PyTorch library call, and the
           rmsnorm backward's beside the library's at every checked
           shape; at the training shape, SDPA's own bf16 error against the
           f32 plain version beside the kernels' (a yardstick, not a
           gate).
  train    llama2-1b at full width and depth in bf16 (random weights from
           seed 0), dots_nobatch remat, batch 8 x seq 1024: loss_fn,
           backward and torch.optim.AdamW, 2 warm-up and 10 timed steps on
           fresh batches; step ms, tokens/s, MFU (6ND), peak memory, a
           device-time breakdown of one step, and each kernel's launches
           per step, which must equal what the code predicts.
  train_parity
           llama2-1b at full width, 2 layers, f32, batch 2 x seq 256: the
           loss and every gradient on the card against the same step on
           the CPU, and five AdamW steps on one batch lower its loss.
  runtime  the runtime core: the driver frees the card, ray_tpu_torch.init()
           detects the GPU (one, with its type label); tasks, a 256 MB
           put/get (zero-copy, bit-equal), an actor and a TaskError; the
           no-op task and actor-call round trips (median of 200) and the
           put/get rate. A num_gpus=1 actor builds LLMReplica in its worker
           (llama3-8b, full width and depth, bf16, seed 0, the slice
           phase's engine) and serves the slice phase's 10 requests,
           streamed through actor method calls: each returns its 32
           tokens, the worker's rmsnorm kernel runs 2 * n_layers + 1
           times per engine pass, the worker loads no JAX or ray_tpu, and
           TTFT and tokens/s as the driver sees them stand beside the
           slice phase's in-process figures. An actor serving llama3-8b
           at full width, 2 layers, f32 returns generate()'s greedy
           tokens on the same weights; while it lives the GPU is held (a
           num_gpus=1 task stays pending) and after kill() the task runs.
           After shutdown() no runtime process is left.
  serve    the Serve control plane: init(num_cpus=4), the HTTP proxy on
           port 0, and serve.run(llm_deployment(...)) of llama3-8b (full
           width and depth, bf16, seed 0, the slice phase's engine) from
           a replica that holds the card as GPU 1.0 (a subclass of
           LLMReplica that also reports its device and kernel counts).
           The slice phase's 10 requests go through the DeploymentHandle
           from 10 driver threads, streamed and unary (each round with
           an empty prefix cache), then one JSON and one SSE request over
           HTTP, one serve.call and one msgpack frame to the binary
           ingress: every answer has its 32 tokens and the replica's
           rmsnorm kernel runs 2 * n_layers + 1 times per pass. Then
           chaos.kill_replica: the replacement holds the GPU and serves
           (the seconds from the kill to that first success are printed);
           llama3-8b at 2 layers, f32, through llm_deployment gives
           generate()'s tokens; serve.shutdown() gives the GPU back; the
           controller, the proxy and the zygote mapped no torch (and the
           zygote no CUDA driver); no runtime process is left.

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
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
# serving's rows and widths, and the training step's 8192 x 2048
KERNEL_ROWS = (1, 5, 8, 64, 2048, 8192)
KERNEL_DIMS = (4096, 2048, 128)
# decode (8 slots), prefill chunk, the training step's rows
TIMED_SHAPES = ((8, 4096), (64, 4096), (8192, 2048))
# The training step: llama2-1b, batch 8 x seq 1024 (bench.py's shape).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = 8, 1024, 2, 10
# (causal, Lq, Lk, head_dim, batch, heads) for the flash kernels' checks;
# the (1024, 1024) case is the training step's shape; the last three stress
# the bf16 tensor-core tiling (causal Lq != Lk both ways, ragged tails).
FLASH_CASES = ((True, 1, 1, 128, 2, 3), (True, 7, 7, 64, 2, 3),
               (True, 129, 129, 128, 2, 3), (True, 129, 129, 256, 2, 3),
               (False, 129, 70, 256, 2, 3), (False, 7, 129, 64, 2, 3),
               (False, 1024, 129, 128, 1, 4), (True, 1024, 1024, 128, 8, 16),
               (True, 200, 1000, 128, 2, 3), (True, 1000, 200, 256, 2, 3),
               (False, 1000, 129, 64, 2, 3))
# How each flash pass multiplies, by dtype.
_TENSOR_CORES = "bf16: mma.sync tensor cores; f32: CUDA cores"
FLASH_DESIGN = {"flash_fwd": _TENSOR_CORES, "flash_bwd_dq": _TENSOR_CORES,
                "flash_bwd_dkv": _TENSOR_CORES}
RMS_BWD_ROWS = (1, 5, 8192)
RMS_BWD_DIMS = (128, 2048, 4096)


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


def fwd_bwd_minus_fwd_ms(fwd, fwd_bwd, calls: int = 20) -> dict:
    """A library backward's device time as (forward + backward) - forward,
    both through autograd and captured in CUDA graphs."""
    both = graph_ms(fwd_bwd, calls=calls, reps=3)
    f = graph_ms(fwd, calls=calls, reps=3)
    return {"ms": both - f, "fwd_bwd_ms": both, "fwd_ms": f,
            "method": "fwd+bwd minus fwd, autograd, CUDA graphs"}


def bf16_close(got, want) -> tuple:
    """(ok, rel_l2): a bf16 kernel output against its plain version in f32
    from the same bf16 inputs. One rounding to bf16 (unit roundoff 2^-9)
    gives a relative L2 error near 2e-3: allowed 4e-3, and no element
    further than 2^-6 of the largest reference magnitude. Where the
    reference vanishes (dq and dk of a one-key attention are exactly 0, and
    the kernel keeps only the f32 rounding of dp - delta), no element may
    exceed 1e-5 instead."""
    got, want = got.float(), want.float()
    rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
    worst = float((got - want).abs().max())
    ok = rel <= 4e-3 and worst <= 2 ** -6 * float(want.abs().max())
    return ok or worst <= 1e-5, rel


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
    from ray_tpu_torch.ops.flash_attention import kernel_report

    t0 = time.perf_counter()
    built = _build.build_all()
    store = _build.build_native("object_store")  # the runtime's g++ library
    secs = time.perf_counter() - t0
    emit({"phase": "build", "seconds": secs, "built": built,
          "object_store_library": store.name,
          "kernels": _build.kernel_names(), "flash_kernels": kernel_report()})


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
    # The per-launch floor: the device time of a one-element elementwise
    # op, timed the same way. No launch at the small serving shapes can
    # take less, whatever the bytes bound says.
    one = torch.zeros(1, device=dev)
    launch_floor_ms = graph_ms(lambda: one.add_(1.0))
    for rec in timed:
        rec["launch_floor_ms"] = launch_floor_ms
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
    return launches, rec


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


def causal_pairs(lq: int, lk: int) -> int:
    """(q, k) pairs a top-left causal mask keeps: q_pos >= k_pos."""
    return sum(min(i + 1, lk) for i in range(lq))


def phase_train_kernels():
    """K2-K5 against their plain versions and their times at the training
    shapes. Launches made here are comparisons, not the main path's."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.flash_attention import (_delta,
                                                   _flash_bwd_dkv_plain,
                                                   _flash_bwd_dq_plain,
                                                   _flash_bwd_plain,
                                                   _flash_fwd_plain,
                                                   flash_bwd_dkv_cuda,
                                                   flash_bwd_dq_cuda,
                                                   flash_fwd_cuda)
    from ray_tpu_torch.ops.rmsnorm import _rmsnorm_bwd_plain, rmsnorm_bwd_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    cases = []
    err = {"rmsnorm_bwd": 0.0, "flash_fwd": 0.0, "flash_bwd_dq": 0.0,
           "flash_bwd_dkv": 0.0}

    def judge(name, got, want, dtype, tol, case):
        e = float((got.float() - want.float()).abs().max())
        err[name] = max(err[name], e)
        if dtype == torch.float32:
            ok = bool(torch.allclose(got, want, rtol=tol, atol=tol))
            rec = {"tol": f"rtol=atol={tol}"}
        else:
            ok, rel = bf16_close(got, want)
            rec = {"tol": "bf16: rel L2 <= 4e-3 and max <= 2^-6 max|ref|, "
                          "or max <= 1e-5",
                   "rel_l2": rel}
        rec.update(case, kernel=name, max_abs_err=e, ok=ok)
        cases.append(rec)

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for d in RMS_BWD_DIMS:
            for rows in RMS_BWD_ROWS:
                x = (torch.randn((rows, d), generator=gen, device=dev)
                     * 3).to(dtype)
                w = (torch.randn(d, generator=gen, device=dev) * 0.1
                     + 1).to(dtype)
                g = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
                dx, dw = rmsnorm_bwd_cuda(x, w, g, EPS)
                torch.cuda.synchronize()
                want = _rmsnorm_bwd_plain(x.float(), w.float(), g.float(), EPS)
                case = {"dtype": dn, "rows": rows, "d": d}
                judge("rmsnorm_bwd", dx, want[0], dtype, 1e-4,
                      dict(case, out="dx"))
                judge("rmsnorm_bwd", dw, want[1], dtype, 1e-4,
                      dict(case, out="dw"))
        for causal, lq, lk, d, b, h in FLASH_CASES:
            def rand(n):
                return torch.randn((b, n, h, d), generator=gen,
                                   device=dev).to(dtype)
            q, k, v, do = rand(lq), rand(lk), rand(lk), rand(lq)
            o, lse = flash_fwd_cuda(q, k, v, causal)
            delta = _delta(o, do)
            dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal)
            dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal)
            torch.cuda.synchronize()
            f = [t.float() for t in (q, k, v, do)]
            o_ref, lse_ref = _flash_fwd_plain(f[0], f[1], f[2], causal)
            dq_ref = _flash_bwd_dq_plain(f[0], f[1], f[2], f[3], lse, delta,
                                         causal)
            dk_ref, dv_ref = _flash_bwd_dkv_plain(f[0], f[1], f[2], f[3],
                                                  lse, delta, causal)
            case = {"dtype": dn, "causal": causal, "b": b, "h": h, "lq": lq,
                    "lk": lk, "d": d}
            judge("flash_fwd", o, o_ref, dtype, 2e-4, dict(case, out="o"))
            judge("flash_fwd", lse, lse_ref, torch.float32, 2e-4,
                  dict(case, out="lse"))
            judge("flash_bwd_dq", dq, dq_ref, dtype, 2e-3,
                  dict(case, out="dq"))
            judge("flash_bwd_dkv", dk, dk_ref, dtype, 2e-3,
                  dict(case, out="dk"))
            judge("flash_bwd_dkv", dv, dv_ref, dtype, 2e-3,
                  dict(case, out="dv"))
            del q, k, v, do, o, lse, delta, dq, dk, dv, f, o_ref, dq_ref
            del dk_ref, dv_ref
            torch.cuda.empty_cache()
    bad = [c for c in cases if not c["ok"]]
    emit({"phase": "train_kernels", "all_ok": not bad, "max_abs_err": err,
          "cases": cases})
    check(not bad, f"training kernels disagree with their plain versions: "
          f"{bad}")

    # Times at the training shapes, bf16.
    bf = torch.bfloat16
    rows, d = TRAIN_BATCH * TRAIN_SEQ, 2048
    x = torch.randn((rows, d), generator=gen, device=dev).to(bf)
    w = (torch.randn(d, generator=gen, device=dev) * 0.1 + 1).to(bf)
    g = torch.randn((rows, d), generator=gen, device=dev).to(bf)
    nbytes = 3 * rows * d * 2 + 2 * d * 2
    xr = x.detach().requires_grad_(True)
    wr = w.detach().requires_grad_(True)
    timed = {"rmsnorm_bwd": {
        "shape": [rows, d], "dtype": "bfloat16",
        "ms": graph_ms(lambda: rmsnorm_bwd_cuda(x, w, g, EPS), calls=50),
        "plain_ms": graph_ms(lambda: _rmsnorm_bwd_plain(x, w, g, EPS),
                             calls=20),
        "library": fwd_bwd_minus_fwd_ms(
            lambda: F.rms_norm(xr, (d,), wr, EPS),
            lambda: torch.autograd.grad(F.rms_norm(xr, (d,), wr, EPS),
                                        (xr, wr), g), calls=50),
        "bytes": nbytes, "flops": 10.0 * rows * d,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }}
    del x, w, g, xr, wr
    # The RMSNorm backward beside autograd of F.rms_norm at every checked
    # shape (bf16), the training step's included.
    timed["rmsnorm_bwd"]["shapes"] = []
    for d in RMS_BWD_DIMS:
        for rows in RMS_BWD_ROWS:
            x = torch.randn((rows, d), generator=gen, device=dev).to(bf)
            w = (torch.randn(d, generator=gen, device=dev) * 0.1 + 1).to(bf)
            g = torch.randn((rows, d), generator=gen, device=dev).to(bf)
            xr = x.detach().requires_grad_(True)
            wr = w.detach().requires_grad_(True)
            nb = 3 * rows * d * 2 + 2 * d * 2
            timed["rmsnorm_bwd"]["shapes"].append({
                "shape": [rows, d],
                "ms": graph_ms(lambda: rmsnorm_bwd_cuda(x, w, g, EPS),
                               calls=50),
                "library_ms": fwd_bwd_minus_fwd_ms(
                    lambda: F.rms_norm(xr, (d,), wr, EPS),
                    lambda: torch.autograd.grad(
                        F.rms_norm(xr, (d,), wr, EPS), (xr, wr), g),
                    calls=50)["ms"],
                "bound_ms": nb / HBM_BYTES_PER_S * 1e3})
            del x, w, g, xr, wr

    b, L, h, hd = TRAIN_BATCH, TRAIN_SEQ, 16, 128

    def rand():
        return torch.randn((b, L, h, hd), generator=gen, device=dev).to(bf)

    q, k, v, do = rand(), rand(), rand(), rand()
    o, lse = flash_fwd_cuda(q, k, v, True)
    delta = _delta(o, do)
    t_bytes = b * L * h * hd * 2  # one [b, L, h, d] bf16 tensor
    s_bytes = b * h * L * 4  # one f32 [b, h, L] row statistic

    pairs = causal_pairs(L, L)

    def rec(name, kernel, plain, products, n_in, n_out, n_stats):
        """products: score-sized matrix products; n_in/n_out: [b, L, h, d]
        tensors read/written; n_stats: f32 [b, h, L] rows read or
        written."""
        flops = 2.0 * products * b * h * hd * pairs
        nb = (n_in + n_out) * t_bytes + n_stats * s_bytes
        t_ops = flops / BF16_FLOPS * 1e3
        t_bytes_ms = nb / HBM_BYTES_PER_S * 1e3
        timed[name] = {
            "shape": [b, L, h, hd], "dtype": "bfloat16", "causal": True,
            "ms": graph_ms(kernel, calls=10, reps=3),
            "plain_ms": graph_ms(plain, calls=2, reps=3),
            "bytes": nb, "flops": flops, "causal_pairs": pairs,
            "bound_ms": max(t_ops, t_bytes_ms),
            "bound_by": "operations" if t_ops > t_bytes_ms else "bytes",
        }

    rec("flash_fwd", lambda: flash_fwd_cuda(q, k, v, True),
        lambda: _flash_fwd_plain(q, k, v, True), 2, 3, 1, 1)
    rec("flash_bwd_dq",
        lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta, True),
        lambda: _flash_bwd_dq_plain(q, k, v, do, lse, delta, True), 3, 4, 1,
        2)
    rec("flash_bwd_dkv",
        lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True),
        lambda: _flash_bwd_dkv_plain(q, k, v, do, lse, delta, True), 4, 4, 2,
        2)
    # The library yardstick: scaled_dot_product_attention on [b, h, L, d].
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    sdpa = F.scaled_dot_product_attention
    timed["flash_fwd"]["library"] = {
        "ms": graph_ms(lambda: sdpa(qt, kt, vt, is_causal=True), calls=10,
                       reps=3),
        "method": "F.scaled_dot_product_attention(is_causal=True), "
                  "[8, 16, 1024, 128] bf16, CUDA graph"}
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
    lib_bwd = fwd_bwd_minus_fwd_ms(
        lambda: sdpa(qg, kg, vg, is_causal=True),
        lambda: torch.autograd.grad(sdpa(qg, kg, vg, is_causal=True),
                                    (qg, kg, vg), dot), calls=10)
    lib_bwd["covers"] = "dq, dk and dv together (K4 + K5)"
    timed["flash_bwd_dq"]["library"] = lib_bwd
    timed["flash_bwd_dkv"]["library"] = lib_bwd

    # A yardstick, not a gate: at the training shape, SDPA's bf16 outputs
    # and the kernels' against the plain version in f32 on the same bf16
    # inputs (the backward from the f32 o and lse).
    f = [t.float() for t in (q, k, v, do)]
    o32, lse32 = _flash_fwd_plain(f[0], f[1], f[2], True)
    want = dict(zip(("o", "dq", "dk", "dv"),
                    (o32, *_flash_bwd_plain(*f[:3], o32, lse32, f[3], True))))
    del f, o32, lse32
    out = sdpa(qg, kg, vg, is_causal=True)
    sdpa_got = [out] + list(torch.autograd.grad(out, (qg, kg, vg), dot))
    sdpa_got = dict(zip(want, (t.transpose(1, 2) for t in sdpa_got)))
    kern_got = {"o": o,
                "dq": flash_bwd_dq_cuda(q, k, v, do, lse, delta, True)}
    kern_got["dk"], kern_got["dv"] = flash_bwd_dkv_cuda(q, k, v, do, lse,
                                                        delta, True)

    def error(got, ref):
        got = got.detach().float()
        return {"max_abs_err": float((got - ref).abs().max()),
                "rel_l2": float((got - ref).norm() / ref.norm())}

    for name, outs in (("flash_fwd", ("o",)), ("flash_bwd_dq", ("dq",)),
                       ("flash_bwd_dkv", ("dk", "dv"))):
        timed[name]["error_vs_f32_plain"] = {
            x: {"kernel": error(kern_got[x], want[x]),
                "sdpa": error(sdpa_got[x], want[x])} for x in outs}
    emit({"phase": "train_kernels_timed", "flash_sdp_enabled":
          torch.backends.cuda.flash_sdp_enabled(), "timed": timed})
    del q, k, v, do, o, lse, delta, qt, kt, vt, dot, qg, kg, vg
    del want, out, sdpa_got, kern_got
    torch.cuda.empty_cache()
    return err, timed


def _train_launch_counters():
    from ray_tpu_torch.ops.flash_attention import (flash_bwd_dkv_cuda,
                                                   flash_bwd_dq_cuda,
                                                   flash_fwd_cuda)
    from ray_tpu_torch.ops.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda

    return {"rmsnorm_fwd": rmsnorm_cuda, "rmsnorm_bwd": rmsnorm_bwd_cuda,
            "flash_fwd": flash_fwd_cuda, "flash_bwd_dq": flash_bwd_dq_cuda,
            "flash_bwd_dkv": flash_bwd_dkv_cuda}


def _flat_params(params):
    return [params[k] for k in sorted(params) if k != "layers"] + [
        params["layers"][k] for k in sorted(params["layers"])]


def _kernel_group(name: str) -> str:
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


def _profile_step(step, tokens) -> dict:
    """Device time of one step by kernel group (torch.profiler). A failure
    of the step itself propagates; one of the profiler is reported as
    'not measured'."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step_error = []

    def run():
        try:
            loss = step(tokens)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(loss)),
                  f"the profiled step's loss {loss} is not finite")
        except BaseException as e:
            step_error.append(e)
            raise

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        wall = time.perf_counter() - t0
        events = list(prof.key_averages())
    except Exception as e:  # noqa: BLE001 - the profiler's own failure
        if step_error:
            raise
        return {"device_ms": f"not measured ({type(e).__name__}: {e})"}
    groups, other = {}, []
    total = 0.0
    for evt in events:
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if not us or evt.device_type.name != "CUDA":
            continue
        g = _kernel_group(evt.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        total += us / 1e3
        if g == "other":
            other.append((us / 1e3, evt.count, evt.key[:100]))
    if total == 0.0:
        return {"device_ms": "not measured (no device time in the trace)",
                "profiled_wall_ms": wall * 1e3}
    return {"device_ms": total, "profiled_wall_ms": wall * 1e3,
            "by_group_ms": dict(sorted(groups.items(),
                                       key=lambda kv: -kv[1])),
            "top_other": [{"ms": ms, "calls": n, "kernel": k}
                          for ms, n, k in sorted(other, reverse=True)[:10]]}


def phase_train():
    import torch

    from ray_tpu_torch.models import configs, init_params, loss_fn

    cfg = dataclasses.replace(configs.llama2_1b, max_seq=TRAIN_SEQ,
                              remat=True, remat_policy="dots_nobatch")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device="cuda")
    leaves = _flat_params(params)
    for t in leaves:
        t.requires_grad_(True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves)
    opt = torch.optim.AdamW(leaves, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    batches = torch.randint(0, cfg.vocab_size,
                            (TRAIN_WARMUP + TRAIN_STEPS + 1, TRAIN_BATCH,
                             TRAIN_SEQ + 1), generator=gen, device="cuda")

    def step(tokens):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens, cfg)
        loss.backward()
        opt.step()
        return loss

    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP):
        step(batches[i])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    counters = _train_launch_counters()
    # The main path starts here: counts at 0, peak memory reset.
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(batches[TRAIN_WARMUP + i])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = {n: fn.launches for n, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    # Per step, from the code: every layer's two norms and its attention
    # run forward once and again when dots_nobatch recomputes the layer in
    # the backward; the final norm runs once; each backward runs once.
    predicted = {"rmsnorm_fwd": 2 * L + 1 + 2 * L, "rmsnorm_bwd": 2 * L + 1,
                 "flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    per_step = {n: c / TRAIN_STEPS for n, c in launches.items()}
    profile_rec = _profile_step(step, batches[-1])
    step_ms = sorted(times)[len(times) // 2] * 1e3
    if isinstance(profile_rec.get("device_ms"), float):
        # The profiler slows the host; the busy share is taken against the
        # unprofiled median step.
        profile_rec["device_busy_share"] = profile_rec["device_ms"] / step_ms
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tok_s = tokens / (step_ms / 1e3)
    rec = {"phase": "train", "model": "llama2-1b", "dtype": "bfloat16",
           "n_layers": L, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": n_params, "remat_policy": cfg.remat_policy,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "warmup_steps": TRAIN_WARMUP, "steps": TRAIN_STEPS,
           "init_params_s": init_s, "warmup_s": warm_s,
           "step_ms_median": step_ms,
           "step_ms_all": [t * 1e3 for t in times],
           "tokens_per_s": tok_s,
           "mfu_6nd": tok_s * 6.0 * n_params / BF16_FLOPS,
           "max_memory_allocated": peak, "losses": losses,
           "final_loss": losses[-1], "launches": launches,
           "launches_per_step": per_step, "predicted_per_step": predicted,
           "profile_one_step": profile_rec}
    emit(rec)
    check(n_params == 940_640_256, f"llama2-1b has {n_params} parameters")
    check(all(np.isfinite(losses)), f"a loss is not finite: {losses}")
    check(per_step == {n: float(c) for n, c in predicted.items()},
          f"launches per step {per_step} != predicted {predicted}")
    del params, leaves, opt, batches
    torch.cuda.empty_cache()
    return rec


def phase_train_parity():
    import torch

    from ray_tpu_torch.models import configs, init_params, loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(configs.llama2_1b, n_layers=2,
                              dtype=torch.float32, remat=True,
                              remat_policy="dots_nobatch")
    cpu_params = init_params(cfg, seed=SEED + 3, device="cpu")
    rng = np.random.default_rng(SEED + 3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 257)))

    def step(params, device):
        leaves = _flat_params(params)
        for t in leaves:
            t.requires_grad_(True)
        loss = loss_fn(params, tokens.to(device), cfg)
        loss.backward()
        return loss.item(), [t.grad for t in leaves], leaves

    def to(params, device):
        return {k: ({kk: vv.to(device) for kk, vv in v.items()}
                    if k == "layers" else v.to(device))
                for k, v in params.items()}

    gpu_params = to(cpu_params, "cuda")
    loss_gpu, grads_gpu, _ = step(gpu_params, "cuda")
    t0 = time.perf_counter()
    loss_cpu, grads_cpu, _ = step(cpu_params, "cpu")
    cpu_s = time.perf_counter() - t0
    names = [k for k in sorted(cpu_params) if k != "layers"] + [
        f"layers/{k}" for k in sorted(cpu_params["layers"])]
    leaves = {}
    ok = abs(loss_gpu - loss_cpu) <= 2e-4 * abs(loss_cpu)
    for n, g, gc in zip(names, grads_gpu, grads_cpu):
        g = g.cpu()
        rel = float((g - gc).norm() / gc.norm().clamp_min(1e-30))
        close = bool(torch.allclose(g, gc, rtol=2e-3, atol=2e-3))
        leaves[n] = {"max_abs_err": float((g - gc).abs().max()),
                     "rel_l2": rel, "close": close}
        ok = ok and close and rel <= 1e-3
    del cpu_params, grads_cpu
    # Five AdamW steps on one repeated batch lower its loss.
    leaves_gpu = _flat_params(gpu_params)
    for t in leaves_gpu:
        t.grad = None
    opt = torch.optim.AdamW(leaves_gpu, lr=1e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    batch = tokens.cuda()
    losses = []
    for _ in range(5):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(gpu_params, batch, cfg)
        losses.append(loss.item())
        loss.backward()
        opt.step()
    with torch.no_grad():
        losses.append(loss_fn(gpu_params, batch, cfg).item())
    rec = {"phase": "train_parity", "model": "llama2-1b, 2 layers",
           "dtype": "float32", "batch": 2, "seq": 256,
           "loss_gpu": loss_gpu, "loss_cpu": loss_cpu,
           "loss_tol": "rtol 2e-4",
           "leaf_tol": "rtol=atol=2e-3 and rel L2 <= 1e-3",
           "leaves": leaves, "cpu_step_s": cpu_s,
           "adamw_losses_one_batch": losses,
           "adamw_lowers_loss": losses[-1] < losses[0]}
    emit(rec)
    check(ok, "the card's loss or gradients differ from the CPU's")
    check(rec["adamw_lowers_loss"], f"five AdamW steps did not lower the "
          f"loss: {losses}")
    del gpu_params, opt, leaves_gpu
    torch.cuda.empty_cache()


# -- the runtime core: a GPU actor serves llama3-8b -------------------------
# The actor classes below live in __main__, so the runtime ships them to
# the worker by value (cloudpickle); each method imports what it needs.
RUNTIME_STORE_PUT_BYTES = 256 * 1000 * 1000
RUNTIME_ROUND_TRIPS = 200


class _LLMServer:
    """Holds a model's weights on the card inside a worker; `start` builds
    a fresh LLMReplica over them (with the kernel's count at 0) and
    `finish` shuts it down and reports."""

    def __init__(self, cfg_name, dtype, n_layers, seed):
        import dataclasses
        import time

        import torch

        from ray_tpu_torch.models import configs, init_params

        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = getattr(configs, cfg_name)
        self.cfg = dataclasses.replace(cfg, dtype=getattr(torch, dtype),
                                       n_layers=n_layers or cfg.n_layers)
        t0 = time.perf_counter()
        self.params = init_params(self.cfg, seed=seed, device="cuda")
        torch.cuda.synchronize()
        self.init_params_s = time.perf_counter() - t0
        self.rep = None

    def info(self):
        import os
        import sys

        import torch

        return {"pid": os.getpid(), "device": torch.cuda.get_device_name(),
                "torch_threads": torch.get_num_threads(),
                "n_layers": self.cfg.n_layers,
                "checksum": _param_checksum(self.params),
                "init_params_s": self.init_params_s,
                "jax_or_ray_tpu_modules": sorted(
                    m for m in sys.modules if m in ("jax", "ray_tpu")
                    or m.startswith(("jax.", "ray_tpu.")))}

    def start(self, engine_kw):
        import time

        from ray_tpu_torch.ops.rmsnorm import rmsnorm_cuda
        from ray_tpu_torch.serve.llm import LLMReplica

        t0 = time.perf_counter()
        self.rep = LLMReplica(lambda: (self.params, self.cfg), **engine_kw)
        rmsnorm_cuda.launches = 0
        return time.perf_counter() - t0

    def stream(self, prompt, max_new_tokens, sampling):
        yield from self.rep.stream(prompt, max_new_tokens, **sampling)

    def generate(self, prompt, max_new_tokens, sampling):
        return self.rep(prompt, max_new_tokens, **sampling)

    def finish(self):
        import torch

        from ray_tpu_torch.ops.rmsnorm import rmsnorm_cuda

        self.rep.shutdown()  # joins the engine thread: counts are final
        torch.cuda.synchronize()
        st = self.rep.stats()
        return {"rmsnorm_launches": rmsnorm_cuda.launches,
                "forward_passes": st["forward_passes"],
                "engine_ttft_p50_s": st["latency"]["ttft"]["p50"],
                "engine_ttft_p99_s": st["latency"]["ttft"]["p99"],
                "max_memory_allocated": torch.cuda.max_memory_allocated()}


def _param_checksum(params) -> list:
    """Per-leaf float64 sums: equal weights give equal sums."""
    leaves = [v for k, v in sorted(params.items()) if k != "layers"]
    leaves += [v for _, v in sorted(params["layers"].items())]
    return [float(t.double().sum()) for t in leaves]


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def _runtime_procs() -> list:
    """Processes of the port's runtime, as (pid, parent pid, command line):
    the zygote, the workers forked from it (which keep its command line)
    and workers exec'd as worker_main. This process is left out."""
    import os

    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                args = f.read().decode(errors="replace").split("\0")
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(") ", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        if args[1:2] == ["-m"] and args[2].startswith("ray_tpu_torch._private."):
            out.append((int(pid), ppid, " ".join(a for a in args if a)))
    return out


def _runtime_workers() -> list:
    """The runtime's processes other than the zygote this process started:
    after shutdown() none may be left."""
    import os

    return [p for p in _runtime_procs()
            if not (p[1] == os.getpid() and "_private.zygote" in p[2])]


def _runtime_sanity(rt) -> dict:
    from ray_tpu_torch.exceptions import TaskError

    @rt.remote
    def square(x):
        return x * x

    @rt.remote
    def noop():
        return None

    @rt.remote
    def fail():
        raise ValueError("raised in a task")

    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def add(self, k):
            self.n += k
            return self.n

        def noop(self):
            return None

    check(rt.get([square.remote(i) for i in range(16)]) ==
          [i * i for i in range(16)], "tasks returned wrong values")
    rng = np.random.default_rng(SEED)
    arr = rng.integers(0, 255, size=RUNTIME_STORE_PUT_BYTES, dtype=np.uint8)
    # Three rounds: the first writes store pages never touched before
    # (page faults), the later ones reuse them once the free has landed.
    put_s, get_s, zero_copy, equal = [], [], True, True
    for _ in range(3):
        t0 = time.perf_counter()
        ref = rt.put(arr)
        put_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        out = rt.get(ref)
        get_s.append(time.perf_counter() - t0)
        zero_copy = zero_copy and not out.flags.owndata
        equal = equal and bool(np.array_equal(out, arr))
        del out, ref
        time.sleep(0.5)
    c = Counter.remote()
    counts = rt.get([c.add.remote(k) for k in range(1, 6)])
    try:
        rt.get(fail.remote())
        raised = None
    except TaskError as e:
        raised = e.cause_cls_name
    rt.get([noop.remote(), c.noop.remote()])

    def med_us(fn):
        ts = []
        for _ in range(RUNTIME_ROUND_TRIPS):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return _pct(ts, 0.5) * 1e6

    task_us = med_us(lambda: rt.get(noop.remote()))
    actor_us = med_us(lambda: rt.get(c.noop.remote()))
    rt.kill(c)
    rec = {"put_bytes": RUNTIME_STORE_PUT_BYTES, "put_s": put_s,
           "get_s": get_s,
           "put_GB_per_s": [arr.nbytes / t / 1e9 for t in put_s],
           "get_GB_per_s": [arr.nbytes / t / 1e9 for t in get_s],
           "get_zero_copy": zero_copy, "put_get_bit_equal": equal,
           "actor_counts": counts, "task_error_cause": raised,
           "noop_task_round_trip_us_p50": task_us,
           "actor_call_round_trip_us_p50": actor_us,
           "round_trips": RUNTIME_ROUND_TRIPS}
    check(zero_copy and equal, "put/get of 256 MB was not zero-copy and "
          "bit-equal")
    check(counts == [1, 3, 6, 10, 15], f"actor state went wrong: {counts}")
    check(raised == "ValueError", f"get() raised {raised}, not a TaskError "
          f"caused by ValueError")
    return rec


def _serve_round(rt, srv, engine_kw, prompts, shared_a, shared_b,
                 new_tokens, sampling, streamed) -> dict:
    """One pass of the slice phase's 10-request mix through actor method
    calls, each request from its own driver thread; shared_b goes in once
    shared_a's first token is back (so its prefix is published). Streamed:
    every request streams its tokens (one object a token) and TTFT is what
    the driver sees. Otherwise only shared_a streams and the rest are
    unary calls (the result at the end), and TTFT is the engine's."""
    import threading

    sampled = {1, 5}
    results, errors = {}, []
    a_first = threading.Event()

    def run(key, prompt, samp):
        try:
            t_sub = time.perf_counter()
            if not streamed and key != "shared_a":
                toks = rt.get(srv.generate.remote(prompt, new_tokens, samp),
                              timeout=900)
                results[key] = (toks, None)
                return
            gen = srv.stream.options(num_returns="dynamic").remote(
                prompt, new_tokens, samp)
            toks, ttft = [], None
            for item in gen:
                toks.append(rt.get(item, timeout=600))
                if ttft is None:
                    ttft = time.perf_counter() - t_sub
                    if key == "shared_a":
                        a_first.set()
            results[key] = (toks, ttft)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(f"{key}: {type(e).__name__}: {e}")
        finally:
            a_first.set()  # set already, or shared_a failed

    build_s = rt.get(srv.start.remote(engine_kw), timeout=300)
    t_start = time.perf_counter()
    threads = [threading.Thread(target=run, args=(
        i, p, sampling if i in sampled else {})) for i, p in enumerate(prompts)]
    threads.append(threading.Thread(target=run, args=("shared_a", shared_a, {})))
    for t in threads:
        t.start()
    a_first.wait(900)
    tb = threading.Thread(target=run, args=("shared_b", shared_b, sampling))
    tb.start()
    for t in threads + [tb]:
        t.join(900)
    window_s = time.perf_counter() - t_start
    fin = rt.get(srv.finish.remote(), timeout=300)
    check(not errors, f"requests through the actor failed: {errors}")
    keys = [*range(len(prompts)), "shared_a", "shared_b"]
    outs = [results[k][0] for k in keys]
    tokens_out = sum(len(o) for o in outs)
    rec = {"streamed": "all" if streamed else "shared_a only",
           "worker_engine_build_s": build_s, "requests": len(outs),
           "finished": sum(len(o) == new_tokens for o in outs),
           "tokens_out": tokens_out, "window_s": window_s,
           "output_tok_per_s": tokens_out / window_s, **fin,
           "rmsnorm_per_pass": fin["rmsnorm_launches"] /
           max(1, fin["forward_passes"])}
    if streamed:
        ttfts = [results[k][1] for k in keys]
        rec["ttft_p50_s"] = _pct(ttfts, 0.5)
        rec["ttft_p99_s"] = _pct(ttfts, 0.99)
    rec["_outs"] = outs
    return rec


def _runtime_serve(rt, slice_rec, device_name) -> dict:
    """The slice phase's 10-request mix, submitted through actor method
    calls to a num_gpus=1 actor serving llama3-8b at full width and depth;
    TTFT and tokens/s as the driver sees them through the runtime. The
    streamed round is the main path; the second round, unary calls, tells
    the per-token object path's cost from the worker's own."""
    from ray_tpu_torch.models import configs

    cfg = configs.llama3_8b
    new_tokens = 32
    sampling = {"temperature": 0.8, "top_k": 40, "top_p": 0.95}
    engine_kw = {"num_slots": 8, "max_len": 2048, "prefill_chunk": 64,
                 "kv_mode": "paged", "page_size": 16}
    server = rt.remote(num_gpus=1, max_concurrency=16)(_LLMServer)
    t0 = time.perf_counter()
    srv = server.remote("llama3_8b", "bfloat16", 0, SEED)
    info = rt.get(srv.info.remote(), timeout=900)
    actor_ready_s = time.perf_counter() - t0
    check(rt.available_resources().get("GPU", 0.0) == 0.0,
          "the GPU actor does not hold the GPU")
    rng = np.random.default_rng(SEED)
    prompts, shared_a, shared_b = _shared_prompts(rng, cfg.vocab_size)
    rounds = {}
    for name, streamed in (("streamed", True), ("unary", False)):
        rounds[name] = _serve_round(rt, srv, engine_kw, prompts, shared_a,
                                    shared_b, new_tokens, sampling, streamed)
    per_pass = 2 * cfg.n_layers + 1
    rec = {"model": "llama3-8b", "dtype": "bfloat16",
           "n_layers": info["n_layers"], "engine": engine_kw,
           "worker_pid": info["pid"], "worker_device": info["device"],
           "worker_jax_or_ray_tpu_modules": info["jax_or_ray_tpu_modules"],
           "actor_ready_s": actor_ready_s,
           "worker_init_params_s": info["init_params_s"],
           "worker_torch_threads": info["torch_threads"],
           "in_process_slice": {k: slice_rec[k] for k in (
               "output_tok_per_s", "ttft_p50_s", "ttft_p99_s", "window_s",
               "forward_passes")},
           **{name: {k: v for k, v in r.items() if k != "_outs"}
              for name, r in rounds.items()}}
    check(info["n_layers"] == cfg.n_layers, "the actor did not serve full depth")
    for name, r in rounds.items():
        check(r["finished"] == 10, f"{name}: only {r['finished']}/10 "
              f"requests through the actor returned {new_tokens} tokens")
        check(all(0 <= t < cfg.vocab_size for o in r["_outs"] for t in o),
              f"{name}: a token id through the actor is out of range")
        check(r["forward_passes"] > 0 and r["rmsnorm_launches"] ==
              per_pass * r["forward_passes"],
              f"{name}: the worker's rmsnorm ran {r['rmsnorm_launches']} "
              f"times in {r['forward_passes']} passes, not {per_pass} a pass")
    check(info["device"] == device_name,
          f"the actor ran on {info['device']}, not {device_name}")
    check(info["jax_or_ray_tpu_modules"] == [],
          f"the worker loaded {info['jax_or_ray_tpu_modules']}")
    rt.kill(srv)
    return rec


def _runtime_parity_and_resource(rt) -> dict:
    """An actor serves llama3-8b at full width, 2 layers, f32, greedy: its
    tokens equal generate() in the driver on the same weights. While it
    lives it holds the GPU: a num_gpus=1 task stays pending until the
    actor is killed, and the GPU is free again after."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import configs, init_params
    from ray_tpu_torch.models.generate import generate

    deadline = time.monotonic() + 120
    while rt.available_resources().get("GPU", 0.0) != 1.0:
        check(time.monotonic() < deadline, "the serving actor's GPU was "
              "never released")
        time.sleep(0.1)
    seed, new = SEED + 4, 8
    engine_kw = {"num_slots": 4, "max_len": 256, "prefill_chunk": 64,
                 "kv_mode": "paged", "page_size": 16}
    server = rt.remote(num_gpus=1, max_concurrency=4)(_LLMServer)
    srv = server.remote("llama3_8b", "float32", 2, seed)
    info = rt.get(srv.info.remote(), timeout=600)
    rt.get(srv.start.remote(engine_kw), timeout=300)
    cfg = dataclasses.replace(configs.llama3_8b, n_layers=2,
                              dtype=torch.float32)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (9, 130)]
    outs = rt.get([srv.generate.remote(p, new, {}) for p in prompts],
                  timeout=600)
    torch.backends.cuda.matmul.allow_tf32 = False
    params = init_params(cfg, seed=seed, device="cuda")
    same_weights = _param_checksum(params) == info["checksum"]
    refs = [generate(params, [p], cfg, max_new_tokens=new)[0].tolist()
            for p in prompts]
    del params
    torch.cuda.empty_cache()

    @rt.remote(num_gpus=1)
    def gpu_task():
        import torch

        return torch.cuda.get_device_name()

    held = rt.available_resources().get("GPU", 0.0)
    pending_ref = gpu_task.remote()
    ready, _ = rt.wait([pending_ref], timeout=2)
    stayed_pending = ready == []
    rt.kill(srv)
    ran_on = rt.get(pending_ref, timeout=600)
    deadline = time.monotonic() + 120
    while rt.available_resources().get("GPU", 0.0) != 1.0:
        check(time.monotonic() < deadline, "the GPU was never released")
        time.sleep(0.1)
    rec = {"parity_model": "llama3-8b, 2 layers", "parity_dtype": "float32",
           "parity_prompt_lengths": [len(p) for p in prompts],
           "parity_same_weights": same_weights,
           "parity_actor_equals_generate": outs == refs,
           "gpu_available_while_held": held,
           "gpu_task_pending_while_held": stayed_pending,
           "gpu_task_ran_after_kill_on": ran_on,
           "gpu_available_after_kill": rt.available_resources().get("GPU")}
    check(same_weights, "the actor's weights differ from the driver's")
    check(outs == refs, f"the actor's tokens {outs} != generate()'s {refs}")
    check(held == 0.0, f"{held} GPU available while the actor holds it")
    check(stayed_pending, "a num_gpus=1 task ran while the actor held the GPU")
    return rec


def phase_runtime(slice_rec, device_name):
    import gc

    import torch

    import ray_tpu_torch as rt

    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    rt.init(num_cpus=4)
    init_s = time.perf_counter() - t0
    try:
        res = rt.cluster_resources()
        labels = sorted(k for k in res if k.startswith("GPU-"))
        rec = {"phase": "runtime", "driver_memory_reserved": reserved,
               "init_s": init_s, "cluster_resources": res,
               "gpu_type_labels": labels}
        check(res.get("GPU") == 1.0, f"detected GPUs: {res.get('GPU')}")
        check(len(labels) == 1, f"GPU type labels: {labels}")
        rec["sanity"] = _runtime_sanity(rt)
        rec["serve"] = _runtime_serve(rt, slice_rec, device_name)
        rec.update(_runtime_parity_and_resource(rt))
        live = _runtime_workers()
        rec["workers_before_shutdown"] = len(live)
    finally:
        rt.shutdown()
    deadline = time.monotonic() + 30
    while _runtime_workers() and time.monotonic() < deadline:
        time.sleep(0.2)
    left = _runtime_workers()
    # The zygote serves every runtime this process starts and stops at
    # exit; stop it now so the phase leaves no process behind.
    from ray_tpu_torch._private import zygote_client

    if zygote_client._shared is not None:
        zygote_client._shared.stop()
    deadline = time.monotonic() + 30
    while _runtime_procs() and time.monotonic() < deadline:
        time.sleep(0.2)
    rec["workers_after_shutdown"] = left
    rec["runtime_procs_after_zygote_stop"] = _runtime_procs()
    emit(rec)
    check(live, "no worker process was found while the runtime ran")
    check(not left, f"workers outlived shutdown(): {left}")
    check(not rec["runtime_procs_after_zygote_stop"],
          f"runtime processes outlived the zygote's stop: "
          f"{rec['runtime_procs_after_zygote_stop']}")
    return rec["serve"]


SERVE_APP = "llm"


def _serve_replica_cls():
    """LLMReplica with the smoke's probes: where it runs, and the rmsnorm
    kernel's launches against the engine's passes, counted from a reset.
    A subclass defined here travels to the replica by value, sealed, so
    the controller never opens it."""
    from ray_tpu_torch.serve.llm import LLMReplica

    class CountingLLMReplica(LLMReplica):
        def info(self):
            import os
            import sys

            import torch

            return {"pid": os.getpid(),
                    "device": torch.cuda.get_device_name(),
                    "n_layers": self.engine.cfg.n_layers,
                    "dtype": str(self.engine.cfg.dtype),
                    "jax_or_ray_tpu_modules": sorted(
                        m for m in sys.modules if m in ("jax", "ray_tpu")
                        or m.startswith(("jax.", "ray_tpu.")))}

        def _settled(self, timeout_s=60.0):
            """(launches, engine stats) once the engine is idle: nothing
            queued or running and two reads 0.2 s apart agree."""
            import time as _time

            from ray_tpu_torch.ops.rmsnorm import rmsnorm_cuda

            prev, deadline = None, _time.monotonic() + timeout_s
            while _time.monotonic() < deadline:
                st = self.engine.stats()
                cur = (rmsnorm_cuda.launches, st["forward_passes"])
                if cur == prev and not (st["active"] or st["waiting"]
                                        or st["prefilling"]):
                    return cur[0], st
                prev = cur
                _time.sleep(0.2)
            raise RuntimeError("the engine never went idle")

        def flush_prefix_cache(self):
            """Each round starts without the last round's prompts in the
            prefix cache (the runtime phase builds a fresh engine for
            each round): pages held by no request go back to the pool."""
            self._settled()
            with self.engine._lock:
                self.engine._prefix_cache.flush()
                return self.engine._pool.in_use

        def reset_counts(self):
            from ray_tpu_torch.ops.rmsnorm import rmsnorm_cuda

            _, st = self._settled()
            rmsnorm_cuda.launches = 0
            self._passes0 = st["forward_passes"]
            return True

        def counts(self):
            from ray_tpu_torch.util import journal

            launches, st = self._settled()
            events = journal.snapshot()
            return {"rmsnorm_launches": launches,
                    "forward_passes": st["forward_passes"] - self._passes0,
                    "engine_ttft_p50_s": st["latency"]["ttft"]["p50"],
                    "engine_ttft_p99_s": st["latency"]["ttft"]["p99"],
                    "hol_events": sum(e.get("kind") == "serve.hol"
                                      for e in events),
                    "hol_postmortem_requests": sum(
                        e.get("kind") == "journal.trigger_requested"
                        and e.get("reason") == "hol_blocking"
                        for e in events),
                    "hol_blocked_slot_seconds":
                        st["hol"]["blocked_slot_seconds"]}

    return CountingLLMReplica


def _serve_app(loader, replica_cls, **engine_kw):
    """llm_deployment's application with its class swapped for the smoke's
    subclass (the deployment's name, options and init arguments stay)."""
    from ray_tpu_torch.serve.llm import llm_deployment

    app = llm_deployment(loader, ray_actor_options={"num_gpus": 1},
                         **engine_kw)
    return type(app)(app.deployment.options(func_or_class=replica_cls),
                     app.init_args, app.init_kwargs)


def _llama_loader(dtype: str, n_layers: int, seed: int):
    """A model loader that runs in the replica: llama3-8b, random weights
    from `seed`, built on the card there."""
    def load():
        import dataclasses

        import torch

        from ray_tpu_torch.models import configs, init_params

        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = dataclasses.replace(configs.llama3_8b,
                                  dtype=getattr(torch, dtype),
                                  n_layers=n_layers or
                                  configs.llama3_8b.n_layers)
        return init_params(cfg, seed=seed, device="cuda"), cfg
    return load


def _serve_handle_round(h, prompts, shared_a, shared_b, new_tokens,
                        sampling, streamed) -> dict:
    """The slice phase's 10-request mix through the DeploymentHandle, each
    request from its own driver thread; shared_b goes in once shared_a's
    first token is back. Streamed: every request streams
    (`method_name="stream"`) and TTFT is what the driver sees; unary:
    only shared_a streams, the rest return their tokens at the end."""
    import threading

    sampled = {1, 5}
    results, errors = {}, []
    a_first = threading.Event()
    stream_h = h.options(stream=True, method_name="stream")

    def run(key, prompt, samp):
        try:
            t_sub = time.perf_counter()
            if not streamed and key != "shared_a":
                toks = h.remote(prompt, new_tokens, **samp).result(
                    timeout=900)
                results[key] = (toks, None, None)
                return
            toks, ttft = [], None
            resp = stream_h.remote(prompt, new_tokens, **samp)
            for tok in resp:
                toks.append(tok)
                if ttft is None:
                    ttft = time.perf_counter() - t_sub
                    if key == "shared_a":
                        a_first.set()
            results[key] = (toks, ttft, resp.rid)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(f"{key}: {type(e).__name__}: {e}")
        finally:
            a_first.set()

    t_start = time.perf_counter()
    threads = [threading.Thread(target=run, args=(
        i, p, sampling if i in sampled else {})) for i, p in enumerate(prompts)]
    threads.append(threading.Thread(target=run, args=("shared_a", shared_a, {})))
    for t in threads:
        t.start()
    a_first.wait(900)
    tb = threading.Thread(target=run, args=("shared_b", shared_b, sampling))
    tb.start()
    for t in threads + [tb]:
        t.join(900)
    window_s = time.perf_counter() - t_start
    check(not errors, f"requests through the handle failed: {errors}")
    keys = [*range(len(prompts)), "shared_a", "shared_b"]
    outs = [results[k][0] for k in keys]
    tokens_out = sum(len(o) for o in outs)
    rec = {"streamed": "all" if streamed else "shared_a only",
           "requests": len(outs),
           "finished": sum(len(o) == new_tokens for o in outs),
           "tokens_out": tokens_out, "window_s": window_s,
           "output_tok_per_s": tokens_out / window_s}
    if streamed:
        ttfts = [results[k][1] for k in keys]
        rec["ttft_p50_s"] = _pct(ttfts, 0.5)
        rec["ttft_p99_s"] = _pct(ttfts, 0.99)
        rec["_ttft_by_rid"] = {results[k][2]: results[k][1] for k in keys}
    rec["_outs"] = outs
    return rec


def _serve_ingress(http_addr, binary_addr, prompt, new_tokens) -> dict:
    """One JSON request and one SSE stream over HTTP (urllib), one
    request through serve.call and one msgpack frame to the proxy's
    binary ingress."""
    import asyncio
    import urllib.request

    from ray_tpu_torch import serve
    from ray_tpu_torch._private.protocol import connect

    body = json.dumps({"prompt": prompt,
                       "max_new_tokens": new_tokens}).encode()
    t0 = time.perf_counter()
    req = urllib.request.Request(f"{http_addr}/{SERVE_APP}", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        json_status, json_out = r.status, json.loads(r.read())["result"]
    json_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    req = urllib.request.Request(f"{http_addr}/{SERVE_APP}?stream=1",
                                 data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        sse_status, sse_type = r.status, r.headers["Content-Type"]
        sse_body = r.read().decode()
    sse_s = time.perf_counter() - t0
    sse_out = [json.loads(ln[len("data: "):]) for ln in sse_body.splitlines()
               if ln.startswith("data: ")]
    t0 = time.perf_counter()
    call_out = serve.call(SERVE_APP, prompt, new_tokens)
    call_s = time.perf_counter() - t0

    async def frame():
        conn = await connect(*binary_addr)
        try:
            return await conn.call("serve_call", {
                "app": SERVE_APP, "args": [prompt, new_tokens]}, timeout=300)
        finally:
            await conn.close()

    t0 = time.perf_counter()
    loop = asyncio.new_event_loop()
    try:
        binary_out = loop.run_until_complete(frame())
    finally:
        loop.close()
    binary_s = time.perf_counter() - t0
    return {"http_json": {"status": json_status, "tokens": len(json_out),
                          "seconds": json_s, "_out": json_out},
            "http_sse": {"status": sse_status, "content_type": sse_type,
                         "data_events": len(sse_out),
                         "error_events": sse_body.count("event: error"),
                         "seconds": sse_s, "_out": sse_out},
            "serve_call": {"tokens": len(call_out), "seconds": call_s,
                           "_out": call_out},
            "binary_ingress": {"tokens": len(binary_out.get("result") or []),
                               "error": binary_out.get("error"),
                               "seconds": binary_s,
                               "_out": binary_out.get("result") or []}}


def _phase_summary(records) -> dict:
    """Per method the replica served ("stream": the streamed round and
    the unary round's shared_a; "__call__": the rest), the p50 of each
    observatory phase and of TTFT, in ms: where a request's time went,
    from the handle's enqueue to its last token."""
    out = {}
    for method in ("stream", "__call__"):
        recs = [r for r in records if r["method"] == method]
        row = {"n": len(recs)}
        for name in sorted({p for r in recs for p in r["phases"]}):
            row[name] = _pct([r["phases"].get(name, 0.0) for r in recs],
                             0.5) * 1e3
        ttfts = [r["ttft_s"] for r in recs if r["ttft_s"] is not None]
        row["ttft"] = _pct(ttfts, 0.5) * 1e3 if ttfts else None
        out[method] = row
    return out


def _delivery(records, ttft_by_rid) -> dict:
    """The streamed round, request by request: the TTFT the driver saw
    against the replica's own (the handle's enqueue to the engine's first
    token, on the replica's record of the same rid). Their difference is
    the first token's way back: the stream thread, the long poll and the
    reply."""
    by_rid = {r["rid"]: r for r in records}
    gaps, own = [], []
    for rid, seen in ttft_by_rid.items():
        rec = by_rid.get(rid)
        if rec is None or rec["ttft_s"] is None:
            continue
        own.append(rec["ttft_s"])
        gaps.append(seen - rec["ttft_s"])
    check(len(gaps) == len(ttft_by_rid),
          f"{len(gaps)} of {len(ttft_by_rid)} streamed requests have a "
          f"replica record")
    return {"n": len(gaps), "replica_ttft_p50": _pct(own, 0.5) * 1e3,
            "gap_p50": _pct(gaps, 0.5) * 1e3, "gap_max": max(gaps) * 1e3,
            "gap_min": min(gaps) * 1e3}


def _worker_pids() -> dict:
    """actor id (bytes) -> pid of the worker hosting it, from the raylet."""
    from ray_tpu_torch._private import worker as worker_mod

    client = worker_mod.get_client()
    info = client._run(client.raylet.call("get_info", {}), timeout=30)
    return {w["actor_id"]: w["pid"] for w in info["workers"]
            if w.get("actor_id")}


def _mapped(pid: int) -> dict:
    """What a process has mapped: torch's libraries (an `import torch`),
    the CUDA driver (a CUDA context), JAX's (an `import jax`)."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            maps = f.read()
    except OSError:
        return {"readable": False}
    return {"readable": True, "torch": "libtorch" in maps,
            "cuda_driver": "libcuda.so" in maps,
            "jax": "jaxlib" in maps or "xla_extension" in maps}


def _serve_kill_and_replace(rt, h, prompt, new_tokens, device_name) -> dict:
    """chaos.kill_replica, then one request a second until one succeeds:
    the fault is recorded once it has settled, the replacement (which can
    start only once the dead worker's GPU is released) serving."""
    from ray_tpu_torch._private import chaos

    chaos.enable()
    try:
        t0 = time.perf_counter()
        victim = chaos.kill_replica(SERVE_APP, 0)
        failures, out = [], None
        deadline = time.monotonic() + 600
        while out is None:
            check(time.monotonic() < deadline,
                  f"no request succeeded after kill_replica: {failures[-3:]}")
            try:
                out = h.remote(prompt, new_tokens).result(timeout=300)
            except Exception as e:  # noqa: BLE001 — the fault settling
                failures.append(type(e).__name__)
                time.sleep(1.0)
        kill_to_success_s = time.perf_counter() - t0
    finally:
        chaos.disable()
    info = h.options(method_name="info").remote().result(timeout=60)
    rec = {"killed_actor": victim, "kill_to_first_success_s": kill_to_success_s,
           "failures_before_success": failures, "tokens": len(out),
           "replacement_pid": info["pid"],
           "replacement_device": info["device"],
           "gpu_available_with_replacement":
               rt.available_resources().get("GPU", 0.0)}
    check(len(out) == new_tokens, f"the replacement returned {len(out)} "
          f"tokens, not {new_tokens}")
    check(info["device"] == device_name,
          f"the replacement ran on {info['device']}")
    check(rec["gpu_available_with_replacement"] == 0.0,
          "the replacement replica does not hold the GPU")
    return rec


def _serve_parity(replica_cls) -> dict:
    """llama3-8b at full width, 2 layers, f32, greedy, through
    llm_deployment on the card: its tokens equal generate()'s in the
    driver on the same weights."""
    import dataclasses

    import torch

    from ray_tpu_torch import serve
    from ray_tpu_torch.models import configs, init_params
    from ray_tpu_torch.models.generate import generate

    seed, new = SEED + 4, 8
    h = serve.run(_serve_app(_llama_loader("float32", 2, seed), replica_cls,
                             num_slots=4, max_len=256, prefill_chunk=64,
                             kv_mode="paged", page_size=16),
                  name="llm_f32")
    cfg = dataclasses.replace(configs.llama3_8b, n_layers=2,
                              dtype=torch.float32)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (9, 130)]
    outs = [r.result(timeout=600) for r in
            [h.remote(p, new) for p in prompts]]
    info = h.options(method_name="info").remote().result(timeout=60)
    torch.backends.cuda.matmul.allow_tf32 = False
    params = init_params(cfg, seed=seed, device="cuda")
    refs = [generate(params, [p], cfg, max_new_tokens=new)[0].tolist()
            for p in prompts]
    del params
    torch.cuda.empty_cache()
    serve.delete("llm_f32")
    rec = {"parity_model": "llama3-8b, 2 layers", "parity_dtype": info["dtype"],
           "parity_prompt_lengths": [len(p) for p in prompts],
           "parity_deployment_equals_generate": outs == refs}
    check(info["n_layers"] == 2, "the parity replica is not 2 layers deep")
    check(outs == refs, f"llm_deployment's tokens {outs} != generate()'s "
          f"{refs}")
    return rec


def _wait_gpu(rt, want: float, what: str) -> None:
    deadline = time.monotonic() + 120
    while rt.available_resources().get("GPU", 0.0) != want:
        check(time.monotonic() < deadline, what)
        time.sleep(0.1)


def phase_serve(slice_rec, runtime_rec, device_name):
    import gc
    import os

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME

    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.llama3_8b
    new_tokens = 32
    sampling = {"temperature": 0.8, "top_k": 40, "top_p": 0.95}
    engine_kw = {"num_slots": 8, "max_len": 2048, "prefill_chunk": 64,
                 "kv_mode": "paged", "page_size": 16}
    per_pass = 2 * cfg.n_layers + 1
    replica_cls = _serve_replica_cls()
    rng = np.random.default_rng(SEED)
    prompts, shared_a, shared_b = _shared_prompts(rng, cfg.vocab_size)
    rt.init(num_cpus=4)
    try:
        addrs = serve.start(port=0)
        http_addr = addrs["head"]["http"]
        proxy = serve._proxy
        binary_addr = tuple(rt.get(proxy.binary_address.remote(), timeout=60))
        t0 = time.perf_counter()
        h = serve.run(_serve_app(_llama_loader("bfloat16", 0, SEED),
                                 replica_cls, **engine_kw), name=SERVE_APP)
        info = h.options(method_name="info").remote().result(timeout=900)
        ready_s = time.perf_counter() - t0
        status = serve.status()
        gpu_held = rt.available_resources().get("GPU", 0.0)
        check(status.get(SERVE_APP, {}).get("running_replicas") == 1,
              f"serve.status() shows {status}")
        check(gpu_held == 0.0, f"{gpu_held} GPU available while the "
              f"replica holds it")
        check(info["device"] == device_name,
              f"the replica runs on {info['device']}, not {device_name}")
        check(info["n_layers"] == cfg.n_layers,
              "the replica does not serve full depth")
        check(info["jax_or_ray_tpu_modules"] == [],
              f"the replica loaded {info['jax_or_ray_tpu_modules']}")
        # The main path starts here: the replica's count at 0 (its
        # engine's warm-up is counted apart).
        h.options(method_name="reset_counts").remote().result(timeout=120)
        rounds = {}
        for name, streamed in (("streamed", True), ("unary", False)):
            pages = h.options(method_name="flush_prefix_cache").remote() \
                .result(timeout=120)
            check(pages == 0, f"{pages} KV pages in use before a round")
            rounds[name] = _serve_handle_round(
                h, prompts, shared_a, shared_b, new_tokens, sampling,
                streamed)
        ingress = _serve_ingress(http_addr, binary_addr, prompts[0],
                                 new_tokens)
        counts = h.options(method_name="counts").remote().result(timeout=120)
        # The main path ends here; the replacement below runs apart.
        replica = rt.get(serve.get_or_create_controller().get_replicas
                         .remote(SERVE_APP), timeout=60)["replicas"][0]
        records = rt.get(replica.observatory_records.remote(), timeout=60)
        phases = _phase_summary(records)
        phases["first_token_delivery"] = _delivery(
            records, rounds["streamed"].pop("_ttft_by_rid"))
        outs = [o for r in rounds.values() for o in r["_outs"]]
        outs += [v["_out"] for v in ingress.values()]
        for name, r in rounds.items():
            check(r["finished"] == 10, f"{name}: only {r['finished']}/10 "
                  f"requests through the handle returned {new_tokens} tokens")
        for name, v in ingress.items():
            check(len(v["_out"]) == new_tokens,
                  f"{name} returned {len(v['_out'])} tokens: {v}")
        check(ingress["http_json"]["status"] == 200
              and ingress["http_sse"]["status"] == 200, "HTTP status")
        check(ingress["http_sse"]["data_events"] == new_tokens
              and ingress["http_sse"]["error_events"] == 0,
              f"SSE: {ingress['http_sse']}")
        check(ingress["http_sse"]["content_type"].startswith(
            "text/event-stream"), "SSE content type")
        check(all(0 <= t < cfg.vocab_size for o in outs for t in o),
              "a token id through serve is out of range")
        check(counts["forward_passes"] > 0 and counts["rmsnorm_launches"] ==
              per_pass * counts["forward_passes"],
              f"the replica's rmsnorm ran {counts['rmsnorm_launches']} times "
              f"in {counts['forward_passes']} passes, not {per_pass} a pass")
        kill = _serve_kill_and_replace(rt, h, prompts[0], new_tokens,
                                       device_name)
        serve.delete(SERVE_APP)
        _wait_gpu(rt, 1.0, "the GPU was not released after delete")
        parity = _serve_parity(replica_cls)
        pids = _worker_pids()
        ctrl_pid = pids.get(rt.get_actor(CONTROLLER_NAME)._actor_id.binary())
        proxy_pid = pids.get(proxy._actor_id.binary())
        zygotes = [p for p, pp, cmd in _runtime_procs()
                   if pp == os.getpid() and "_private.zygote" in cmd]
        check(ctrl_pid and proxy_pid and zygotes,
              f"controller {ctrl_pid}, proxy {proxy_pid}, zygote {zygotes}")
        mapped = {"controller": _mapped(ctrl_pid),
                  "proxy": _mapped(proxy_pid),
                  "zygote": _mapped(zygotes[0])}
        live = _runtime_workers()
        client = worker_mod.get_client()
        postmortems = client._run(client._gcs_call("get_postmortems", {}),
                                  timeout=30)["postmortems"]
        serve.shutdown()
        _wait_gpu(rt, 1.0, "the GPU was not back at 1.0 after "
                  "serve.shutdown()")
        gpu_after = rt.available_resources().get("GPU", 0.0)
    finally:
        rt.shutdown()
    deadline = time.monotonic() + 30
    while _runtime_workers() and time.monotonic() < deadline:
        time.sleep(0.2)
    left = _runtime_workers()
    from ray_tpu_torch._private import zygote_client

    if zygote_client._shared is not None:
        zygote_client._shared.stop()
    deadline = time.monotonic() + 30
    while _runtime_procs() and time.monotonic() < deadline:
        time.sleep(0.2)
    reasons = {}
    for pm in postmortems:
        r = str(pm.get("reason", "")).split(":")[0]
        reasons[r] = reasons.get(r, 0) + 1
    rec = {"phase": "serve", "model": "llama3-8b", "dtype": "bfloat16",
           "n_layers": info["n_layers"], "engine": engine_kw,
           "replica_pid": info["pid"], "replica_device": info["device"],
           "replica_ready_s": ready_s, "status": status,
           "gpu_available_while_serving": gpu_held,
           "http": http_addr, "binary": list(binary_addr),
           **{name: {k: v for k, v in r.items() if k != "_outs"}
              for name, r in rounds.items()},
           "ingress": {n: {k: x for k, x in v.items() if k != "_out"}
                       for n, v in ingress.items()},
           **counts,
           "rmsnorm_per_pass": counts["rmsnorm_launches"] /
           max(1, counts["forward_passes"]),
           "observatory_p50_ms": phases,
           "kill_replica": kill, **parity,
           "postmortems_by_reason": reasons,
           "mapped": mapped, "workers_before_shutdown": len(live),
           "gpu_available_after_serve_shutdown": gpu_after,
           "workers_after_shutdown": left,
           "runtime_procs_after_zygote_stop": _runtime_procs(),
           "in_process_slice": {k: slice_rec[k] for k in (
               "output_tok_per_s", "ttft_p50_s", "ttft_p99_s")},
           "runtime_actor": {k: runtime_rec[k][m] for k, m in (
               ("streamed", "output_tok_per_s"), ("unary", "output_tok_per_s"))}}
    rec["runtime_actor"]["streamed_ttft_p50_s"] = runtime_rec["streamed"][
        "ttft_p50_s"]
    rec["runtime_actor"]["streamed_ttft_p99_s"] = runtime_rec["streamed"][
        "ttft_p99_s"]
    emit(rec)
    check(all(m["readable"] for m in mapped.values()),
          f"could not read a serve process's maps: {mapped}")
    check(not mapped["controller"]["torch"] and not mapped["proxy"]["torch"],
          f"the controller or the proxy imported torch: {mapped}")
    check(not mapped["zygote"]["torch"] and
          not mapped["zygote"]["cuda_driver"],
          f"the zygote imported torch or made a CUDA context: {mapped}")
    check(not any(m["jax"] for m in mapped.values()),
          f"a serve process loaded JAX: {mapped}")
    check(gpu_after == 1.0, f"GPU {gpu_after} after serve.shutdown()")
    check(live, "no worker process was found while serve ran")
    check(not left, f"workers outlived shutdown(): {left}")
    check(not rec["runtime_procs_after_zygote_stop"],
          f"runtime processes outlived the zygote's stop: "
          f"{rec['runtime_procs_after_zygote_stop']}")
    return counts["rmsnorm_launches"]


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
    seconds = {}

    def run(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__[len("phase_"):]] = time.perf_counter() - t0
        return out

    name, smi = run(phase_device)
    run(phase_build)
    max_abs, timed = run(phase_kernels)
    launches, slice_rec = run(phase_slice)
    run(phase_step)
    run(phase_parity)
    train_err, train_timed = run(phase_train_kernels)
    train = run(phase_train)
    run(phase_train_parity)
    runtime_rec = run(phase_runtime, slice_rec, name)
    runtime_launches = runtime_rec["streamed"]["rmsnorm_launches"]
    serve_launches = run(phase_serve, slice_rec, runtime_rec, name)
    emit({"phase": "timing", "seconds": seconds})
    leaked = sorted(m for m in sys.modules
                    if m in ("jax", "ray_tpu") or m.startswith(("jax.",
                                                                "ray_tpu.")))
    check(not leaked, f"JAX or ray_tpu modules were loaded: {leaked}")
    decode = timed[0]
    train_launches = train["launches"]
    records = [{
        "name": "rmsnorm_fwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/rmsnorm.cu",
        "replaces": "ray_tpu/ops/rmsnorm.py:49",
        "launches": (launches + train_launches["rmsnorm_fwd"]
                     + runtime_launches + serve_launches),
        "launches_by_path": {"serve": launches,
                             "train": train_launches["rmsnorm_fwd"],
                             "runtime_actor": runtime_launches,
                             "serve_deployment": serve_launches},
        "max_abs_err": max_abs,
        "ms": decode["kernel_ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"],
        "shape": [decode["rows"], decode["d"]], "dtype": decode["dtype"],
    }]
    sources = {"rmsnorm_bwd": ("ray_tpu_torch/csrc/rmsnorm.cu",
                               "ray_tpu/ops/rmsnorm.py:56"),
               "flash_fwd": ("ray_tpu_torch/csrc/flash_attention.cu",
                             "ray_tpu/ops/flash_attention.py:71"),
               "flash_bwd_dq": ("ray_tpu_torch/csrc/flash_attention.cu",
                                "ray_tpu/ops/flash_attention.py:124"),
               "flash_bwd_dkv": ("ray_tpu_torch/csrc/flash_attention.cu",
                                 "ray_tpu/ops/flash_attention.py:167")}
    for kname, (src, replaces) in sources.items():
        t = train_timed[kname]
        records.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": train_launches[kname],
            "launches_by_path": {"train": train_launches[kname]},
            "max_abs_err": train_err[kname], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library"]["ms"],
            "shape": t["shape"], "dtype": t["dtype"]})
        if kname in FLASH_DESIGN:
            records[-1]["design"] = FLASH_DESIGN[kname]
    missing = [r["name"] for r in records if r["launches"] == 0]
    check(not missing, f"kernels never launched on the main path: {missing}")
    emit({"kernels": records})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
