#!/usr/bin/env python3
"""Drive the PyTorch port (ray_tpu_torch) on one NVIDIA H100 and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --rmsnorm-fwd   # the RMSNorm forward alone

Phases, each printing one JSON line; any failure exits non-zero and
prints no result line:

  device   the card's name, capability (must be 9.0) and power limit.
  build    builds every CUDA kernel in ray_tpu_torch/csrc (one nvcc per
           source, all at once); seconds counted as set-up; each flash
           and RMSNorm kernel's registers, spills (ptxas -v) and shared
           memory.
  kernels  the RMSNorm forward against its plain PyTorch version at the
           shapes the serving and training paths give it, in bf16 and
           f32, with the stated tolerance; times at the serving shapes
           (CUDA graphs of many launches, so the device time and not
           Python's launch rate is measured) beside the plain version,
           one PyTorch library call, the memory-bandwidth bound and the
           per-launch floor.
  slice    llama3-8b at full width and depth in bf16 (random weights from
           seed 0) behind LLMReplica, paged KV, serving 10 requests; every
           request must finish with its 32 tokens, and the rmsnorm kernel
           must have run 2 * n_layers + 1 times per engine forward pass.
           Then the replica is dropped: the card memory this process still
           holds, after a garbage collection and again after torch's
           cuBLAS workspaces are cleared, is recorded (not gated).
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
           shape; the RMSNorm forward checked and timed as in `kernels`
           at the training shapes (8192 x 2048 in bf16 and f32, the MoE
           step's 4096 x 4096 and the DP step's 4096 x 2048); at the
           training shape, SDPA's own bf16 error against the
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
  moe_train
           the parallelism slice. First a narrow f32 MoE (mixtral's
           layout at d 256, 4 experts, 2 layers) on the card against the
           CPU: every routing call's dispatch mask equal, then the loss
           and every gradient (the router's included) within the
           train_parity tolerances. Then build_mesh(MeshConfig(), "cuda")
           on a one-rank NCCL group (file:// rendezvous) and, through it
           at axis size 1, ring_attention, ulysses_attention,
           pipeline_stages and moe_layer against their references,
           outputs and gradients. Then mixtral-8x7b at published widths
           (d 4096, 32 heads, 8 KV heads, d_ff 14336, 8 experts, top-2,
           vocab 32000), depth cut to 4 layers, bf16, remat full, random
           weights from seed 0, batch 4 x seq 1024: loss_fn, backward and
           AdamW as the train phase, 1 warm-up and 5 timed steps; step ms,
           tokens/s, MFU by 6ND over the active parameters (all but the
           experts, plus 2/8 of them), peak memory, one profiled step's
           device time by kernel group and by MoE part (routing,
           dispatch, expert products, combine: the moe.* profiler ranges
           and the backward ops autograd links to them), launches per
           step as predicted and a finite, falling loss. Last, all five
           kernels at this path's shapes (RMSNorm 4096 x 4096, flash
           [4, 1024, 32, 128]) against their plain versions, with their
           times beside the bound, the plain version and the library.
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
  trainer  train.torch.TorchTrainer with ScalingConfig(num_workers=1,
           use_gpu=True) on an NCCL group of one: the worker holds the
           GPU and runs the train phase's step (llama2-1b, full width and
           depth, bf16, seed 0, the same AdamW and the same 13 batches
           made on the card) inside the flight recorder's StepProfiler,
           reporting loss, step time and kernel launches each step. After
           step 4 it saves params and AdamW state through
           Checkpoint.from_pytree (5.6 GB); after step 6 it dies once
           (chaos.die); the gang restarts on the card, restores step 4
           and runs to step 13. Launches per step must equal the train
           phase's, steps 1-4 its losses, the repeated steps 5-6 their
           first run (TRAINER_LOSS_RTOL), the restored tensors the saved
           ones bit for bit; the worker sees one device and no JAX; the
           GPU is back after the fit and no process is left.
  job      JobSubmissionClient.submit_job of `python job_main.py` with a
           runtime_env of a working_dir (the script and a data file) and
           env_vars: the job's num_gpus=1 task reads both and runs the
           RMSNorm forward at the decode shape against its plain version
           (one launch); the job must end SUCCEEDED with the task's line
           in its logs.
  tune     (a) a Tuner of tune.with_resources(fn, {"CPU": 1, "GPU": 1})
           trials, one at a time, under ASHA (grace 2, reduction 2,
           max_t 6), over lr in (1e-4, 0): each trial trains
           the train phase's model (llama2-1b, full width and depth, bf16,
           seed 0, the same batches and AdamW) on the card and reports
           its loss and launches every step; the next trial is suggested
           only once the GPU is back at 1.0. The lr 1e-4 trial must repeat
           the train phase's losses bit for bit, ASHA must stop a trial
           before max_t, and every step must launch what the train phase
           predicts. (b) a Tuner over TorchTrainer(ScalingConfig(
           num_workers=1, use_gpu=True)) sweeping lr in (1e-4, 3e-4) with
           llama2-1b at full width, 2 layers: both trials train on the
           card through the gang's worker, the trial actors (one CPU
           each) never map the CUDA driver, and a best result is chosen.
  dag      a compiled two-stage DAG: a num_gpus=1 actor runs the RMSNorm
           forward at 8 x 4096 bf16, a CPU actor checksums its rows; 200
           execute() calls, each within 1 bf16 ulp of the plain version,
           as many kernel launches as executes, execute() p50 beside the
           same chain through actor calls (host time), no channel segment
           left after teardown() and the GPU back at 1.0.
  cluster  cluster_utils.Cluster: a head with 2 CPUs and a node with
           num_gpus=1; a num_gpus=1 task must land on the GPU node and
           runs the RMSNorm forward at 8192 x 2048, returning 64 MiB
           that the driver pulls across the raylets (GB/s printed; the
           bytes' digest equal, within 1 bf16 ulp of the plain version);
           after remove_node() the GPU leaves cluster_resources().
  cli      the operator's flow: probes for pyarrow and joblib, then
           `python -m ray_tpu_torch start --head` (the GPU detected, a
           512 MiB store); a driver joins and a num_gpus=1 actor trains
           the train phase's model (llama2-1b, full width and depth,
           bf16, seed 0, the same AdamW and batches) for 3 steps, the
           second inside a traced span, and samples its card memory
           (util.memory); meanwhile `status`, `list`, `summary`,
           `timeline`, `trace`, `logs`, `memory --devices`, `top` and
           `stack` run, each in a fresh interpreter. The losses must equal
           the train phase's steps 1-3 bit for bit, each step launch what
           it predicts, `memory --devices` show the actor's own
           memory_allocated, `stack` the actor's running call, `trace`
           the span tree; after kill() the GPU reading rises once. Then
           `rt job submit` of the job phase's working_dir job, a
           util.queue.Queue carrying 50 RMSNorm outputs from a GPU actor
           (bit-equal to what the actor sent, within 1 bf16 ulp of the
           driver's plain version), a util.multiprocessing.Pool and a
           ParallelIterator, 3 x 256 MiB of a GPU task's RMSNorm results
           spilled out of the store (through UriStorage to a file:// URI
           where pyarrow is present) and read back bit-equal; `rt stop`
           leaves no process.
  data     the Data library on the card, in one runtime. data_train: the
           train phase's first 12 batches made again on the card, as 96
           int64 rows of 1025 tokens with a `row` column, written by
           write_parquet to 4 files of 24 rows, read back by read_parquet
           through one map_batches stage into TorchTrainer(datasets=)
           with one GPU worker (NCCL of one), whose loop pulls each batch
           inside its step from get_dataset_shard("train")
           .iter_torch_batches(batch_size=8, prefetch_batches=2) onto its
           card and hands the iterator to StepProfiler.attach_feed: every
           row once, the 12 losses bit-equal to a bare loop on the same
           batches in the order they arrived (the train phase's own when
           that is the source order), launches a step as the train
           phase's, every read, write and map task FINISHED in
           list_tasks; step ms beside the train phase's, the feed's
           stalls and the flight recorder's data share. data_infer:
           512 x 1024 int32 tokens (seed + 2) in 64 blocks scored by
           map_batches on ActorPoolStrategy(size=1) with
           resources={"GPU": 1}, each actor building llama2-1b (bf16,
           full depth, seed 0) on its granted card: 512 rows once, 8
           rows' mean NLLs within 1e-3 of the driver's own forward, 33
           RMSNorm and 16 flash forwards a forward, the GPU back after
           the pool closes; rows/s and the pool's set-up. data_feed:
           7,000 224 x 224 x 3 uint8 images (1.05 GB) made in
           map_batches tasks from range(7000, parallelism=28) as a
           tensor column, with their byte sums, through the default
           256 MiB store (spilling) and iter_torch_batches(batch_size=256)
           onto the card: every row once, the byte sums computed on the
           card equal to the column; GB/s beside a pinned copy_ of the
           same bytes, stalls, h2d s and the bytes the raylet spilled.
  loadgen  `python -m ray_tpu_torch start --head --num-gpus 1` with its
           dashboard on a free port; serve.run of a deployment holding a
           ContinuousBatchingEngine of llama3-8b (full width and depth,
           bf16, seed 0; 8 slots, max_len 5120, prefill chunk 64, 16-token
           pages, no eos) on the card; `rt loadgen gen` writes the open-
           loop two-tenant trace (seed 0, 30 s, 1 qps, a 4x flash crowd at
           10-15 s, Poisson) twice, byte-identical; `rt loadgen run`
           replays it streaming. Every card ok, matched by rid and with as
           many chunks as its max_tokens; the CLI exits 0 exactly when the
           reconciler's gap gate passes; 2 * n_layers + 1 rmsnorm launches
           a pass in the replica; neither the run's process nor the
           dashboard's maps libtorch; the dashboard's /healthz, /api/nodes
           (GPU 1.0), /api/serve (one running replica) and /metrics
           (loadgen_requests_total summing to the trace, the engine's TTFT
           histogram, device_hbm_live_bytes equal to the replica's
           memory_allocated()); every exported loadgen_/serve_ metric on
           a curated panel or on a panel that generate_dashboard() makes
           from the replica's metric registry, typed in the exposition as
           that registry types it; a job POSTed to /api/jobs
           whose num_gpus=1 task runs the RMSNorm forward SUCCEEDED; `rt
           stop` leaves no process. Prints offered and achieved QPS,
           output tokens/s, client TTFB and e2e p50/p99 by tenant, the gap
           fraction, the server's phase medians and the /metrics scrape.
  collective
           util.collective on the card: the local group at world size 1
           through NCCL (each op's result on the card, equal to world size
           1's); four num_gpus=0.25 actors in a DCN group run allreduce
           (ring and recursive doubling, each forced by
           RT_COLLECTIVE_ALGO), allgather, reducescatter, broadcast,
           send/recv and barrier on 256 MiB of bf16 a rank (small
           integers: each result bit-equal to a ring-order sum made on the
           card and returned on the card), int8 and fp8 quantized
           allreduce of random values within n x the codec's radius x the
           inputs' absmax plus the bf16 rounding, the codes made on the
           card equal to the CPU's, and 200 one-element allreduces (alpha);
           every op reaches an observer with its record; two num_gpus=0.5
           actors in a hierarchical group give the flat sum. Prints each
           op's seconds, bus GB/s and alpha.
  train_dcn
           TorchTrainer with two num_gpus=0.5 workers on the card,
           TorchConfig(backend="gloo", dp_sync="dcn"): first a narrow f32
           llama's gradient, reduced over "train_dp", against one
           process's over the whole batch (rel L2 <= 1e-5); then llama2-1b
           (full width and depth, bf16, dots_nobatch, seed 0, AdamW), 4 x
           1024 rows a rank of one 8 x 1024 batch every step, gradients
           through allreduce_gradients(grads, "train_dp"): step 1's
           reduced gradient against one process's over the 8 x 1024 batch
           (rel L2 <= 2e-2), a checkpoint after step 2, rank 1's
           chaos.sever_dcn_peer at step 3 (rank 0's op must raise
           CollectiveTimeoutError within its deadline), the restart at
           gang epoch 1 from the checkpoint (an epoch-0 ident refused; the
           repeated step's loss within rtol 1e-5), steps to 4 with a
           falling loss; launches a step as train's, the flight
           recorder's collective share equal to the observed ops' wall;
           then all five kernels at the DP shape against their plain
           versions. Prints step ms, the collective share and DCN GB/s.
  serve_tp
           ten greedy requests (the slice phase's prompts) to a mesh-less
           llama3-8b engine in this process, then to llm_deployment with a
           loader that returns (params, cfg, mesh) on a one-rank NCCL mesh
           (full width and depth, bf16): the same tokens, 65 RMSNorms a
           pass; then a narrow f32 llama3 layout at tp=2 in two processes
           on the card over gloo (gloo on card tensors checked first)
           against the same model at tp=1: the same tokens. Prints the
           decode step ms of each.
  rl       the RL stack (ray_tpu_torch.rl) on Nature-CNN frames: a
           synthetic 84 x 84 x 4 env (FrameSideEnv, 6 actions; ale-py is
           not installed). The Nature-CNN policy (feature 128,
           hidden 64) on the card against the CPU, f32 with TF32 off,
           batch 32: logits, values, the PPO loss and every gradient
           within rtol = atol = 1e-4. PPO from one learner actor holding
           the card, 4 CPU env runners x 500 frames, minibatch 128, 10
           epochs, lr 1e-3, 2 to 8 iterations (none begun after 150 s,
           none once the return gate below holds): finite losses, the
           learner's tensors on the card, the runners' weights equal to
           the learner's after each broadcast, the best mean return at
           least 1 above a uniform policy's 3.33 (over 5 standard
           deviations of its 80-episode mean); prints the learner's
           throughput, the split of one learner call (shipping, the copy
           to the card, the update, the readback; the flight recorder in
           the learner), frames/s of sampling, seconds an iteration and
           the learner's peak memory. Two learners at num_gpus=0.5 over
           the DCN group: the reduced gradient and the updated weights
           within rel L2 1e-5 of one learner's on the same batch, both
           ranks' weights bit-equal; the collective's share of an update.
           One iteration of IMPALA and of DQN (double, PER) with the
           learner on the card: finite losses, the target network on the
           card. None of the five kernels launches (driver and learners).
  rl2      the RL stack's second half. First each update on the card
           against the CPU, f32 with TF32 off, batch 256, the same
           state, batch and draws: SAC and CQL (2 x 256 hidden, 10
           candidate actions), TD3 (400-300), R2D2 (a GRU of 512 over
           16-step windows with burn-in 2), recurrent PPO, BC and MARWIL;
           the losses and every gradient (10 x Adam's first moment after
           one step from zero) from the initial state, then one update's
           new parameters and targets from a state the CPU warmed by 3
           updates, each within rtol = atol = 1e-4; and 8 SAC updates
           replayed as a CUDA graph against the same 8 run eagerly on
           the card (the same tolerance). Then SAC at those
           widths (batch 256, lr 3e-4, tau 0.005, gamma 0.99) on a numpy
           Pendulum-v1 (gymnasium is not installed there): one CPU
           runner, the update on the card in this process (replayed as a
           CUDA graph after three eager ones), 400 env steps
           and 400 updates an iteration, until a best mean return above
           -400, 24 iterations or 90 s; the best must exceed -800 and the
           first (random) iteration's by 200; ms an update, samples/s and
           peak memory printed. Then one iteration each of TD3 and the
           DDPG preset on Pendulum and of recurrent PPO on CueRecallEnv,
           two of R2D2 there (the first fills its replay), Ape-X (2
           ladder runners, 2 replay shard actors, the Nature CNN on
           FrameSideEnv frames) and one of multi-agent PPO on
           MatchContextEnv with two policies; CQL offline from SAC's own
           transitions through episodes_to_dataset and train_on_dataset;
           BC and MARWIL from a dataset of multi-agent PPO's rollouts.
           Every loss finite, every learner and target tensor on the
           card, none of the five kernels launched (driver and
           learners), no process left.
  workflow a durable workflow of three steps whose middle step is a
           num_gpus=1 task running BC updates on its card; the last step
           fails once, resume() finishes without running the GPU step
           again (a run counter on disk reads 1); a virtual actor keeps
           its state across two driver processes; no process left.
  autoscaler
           `python -m ray_tpu_torch up` of a .json config (the local
           provider: a head with 1 CPU and no GPU, no dashboard); a
           StandardAutoscaler with make_node_provider({"type":
           "process"}) and one node type gpu-worker {CPU 1, GPU 1}
           (max_workers 1, idle timeout 2 s) scales a node up for a
           num_gpus=1 task that runs the RMSNorm forward at 8192 x 2048
           bf16 (the cluster phase's seed and function) on its card:
           the node must come up with GPU 1, the task run there on the
           card, once, within 1 bf16 ulp of the plain version. The C++
           client's rt_demo (built with g++ from cpp/) runs against the
           head with a named Counter actor (CPP CLIENT OK, CPP ACTOR OK,
           the counter at 42). The idle node is scaled down (GPU leaves
           cluster_resources(), the provider lists no node), then `rt
           exec` and `rt down` leave no process. Prints the seconds from
           the demand to the node ALIVE, to the result, and from the first
           update() after the result to termination.

After every phase one `left_behind` line records what the driver still
holds: its torch.cuda.memory_allocated(), its live threads (by name) and
its child processes. These lines gate nothing.

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
# serving's rows and widths, the training step's 8192 x 2048 and the MoE
# and DP steps' 4096 rows
KERNEL_ROWS = (1, 5, 8, 64, 2048, 4096, 8192)
KERNEL_DIMS = (4096, 2048, 128)
# The RMSNorm forward's timed shapes (rows, d, dtype): decode (8 slots)
# and a prefill chunk of llama3-8b; the training step (llama2-1b, 8 x
# 1024), in bf16 and f32; the MoE step (mixtral, 4 x 1024); the DP step
# (llama2-1b, 4 x 1024 a rank).
SERVE_FWD_SHAPES = ((8, 4096, "bfloat16"), (64, 4096, "bfloat16"))
TRAIN_FWD_SHAPES = ((8192, 2048, "bfloat16"), (4096, 4096, "bfloat16"),
                    (4096, 2048, "bfloat16"), (8192, 2048, "float32"))
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
# How each flash pass multiplies, by (dtype, head_dim): the design
# rt_flash_design names and flash_kernel_launches_total counts.
_BY_CLASS = {"bfloat16": {64: "wgmma", 128: "wgmma", 256: "mma_sync"},
             "float32": {64: "cuda_cores", 128: "cuda_cores",
                         256: "cuda_cores"}}
FLASH_DESIGN = {"flash_fwd": _BY_CLASS, "flash_bwd_dq": _BY_CLASS,
                "flash_bwd_dkv": _BY_CLASS}
RMS_BWD_ROWS = (1, 5, 8192)
RMS_BWD_DIMS = (128, 2048, 4096)
# The latent-attention training cell's shapes (mistral-small-4, batch 4 x
# 8192), checked in bf16: the RMSNorms of the latent q (1024 wide) and kv
# (256 wide) on 32,768 rows, and flash causal at 8192 with the model's
# softmax scale on a slice of the batch and heads (heads are independent;
# the plain version's f32 scores then take 1 GiB).
MLA_RMS_SHAPES = ((32768, 1024), (32768, 256))
MLA_FLASH_CASE = (True, 8192, 8192, 128, 1, 4)


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
          "kernels": _build.kernel_names(), "flash_kernels": kernel_report(),
          "rmsnorm_kernels": _build.ptxas_report("rmsnorm")})


def phase_kernels():
    import torch

    from ray_tpu_torch.ops.rmsnorm import _rmsnorm_plain, rmsnorm_cuda

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases, max_abs = [], 0.0
    shapes = [(dtype, rows, d) for dtype in (torch.bfloat16, torch.float32)
              for d in KERNEL_DIMS for rows in KERNEL_ROWS]
    shapes += [(torch.bfloat16, rows, d) for rows, d in MLA_RMS_SHAPES]
    for dtype, rows, d in shapes:
        x = (torch.randn((rows, d), generator=gen, device=dev) * 3).to(dtype)
        w = (torch.randn(d, generator=gen, device=dev) * 0.1 + 1).to(dtype)
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
        case.update({"dtype": str(dtype).split(".")[-1], "rows": rows,
                     "d": d, "max_abs_err": err, "ok": ok})
        cases.append(case)
    timed = rmsnorm_fwd_timed(SERVE_FWD_SHAPES)
    max_abs = max([max_abs] + [r["max_abs_err"] for r in timed])
    emit({"phase": "kernels", "name": "rmsnorm_fwd",
          "all_ok": all(c["ok"] for c in cases + timed),
          "max_abs_err": max_abs, "cases": cases, "timed": timed})
    bad = [c for c in cases + timed if not c["ok"]]
    check(not bad, f"rmsnorm_fwd disagrees with its plain version: {bad}")
    return max_abs, timed


def rmsnorm_fwd_timed(shapes) -> list:
    """The RMSNorm forward at each (rows, d, dtype): checked against its
    plain version (bf16 within 1 ulp, f32 within 1e-5) and timed (CUDA
    graphs) beside the plain version, F.rms_norm, the bytes bound, the
    per-launch floor (the device time of a one-element add_, timed the
    same way: no launch can take less, whatever the bytes bound says) and
    torch's copy_ of x into a tensor of its shape (the same bytes less w,
    moved by a kernel that computes nothing: what the card streams in
    practice, not a gate)."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.rmsnorm import _rmsnorm_plain, rmsnorm_cuda

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    one = torch.zeros(1, device=dev)
    launch_floor_ms = graph_ms(lambda: one.add_(1.0))
    timed = []
    for rows, d, dtype in shapes:
        dt = getattr(torch, dtype)
        x = (torch.randn((rows, d), generator=gen, device=dev) * 3).to(dt)
        w = (torch.randn(d, generator=gen, device=dev) * 0.1 + 1).to(dt)
        got = rmsnorm_cuda(x, w, EPS)
        want = _rmsnorm_plain(x, w, EPS)
        rec = {"rows": rows, "d": d, "dtype": dtype,
               "max_abs_err": float((got.float() - want.float()).abs().max())}
        if dt == torch.float32:
            rec.update(tol="rtol=atol=1e-5", ok=bool(torch.allclose(
                got, want, rtol=1e-5, atol=1e-5)))
        else:
            ulp = bf16_ulp_diff(got, want)
            rec.update(tol="1 bf16 ulp", ulp=ulp, ok=ulp <= 1)
        nbytes = (2 * rows * d + d) * x.element_size()
        rec.update({
            "kernel_ms": graph_ms(lambda: rmsnorm_cuda(x, w, EPS)),
            "plain_ms": graph_ms(lambda: _rmsnorm_plain(x, w, EPS),
                                 calls=20),
            "library_ms": graph_ms(lambda: F.rms_norm(x, (d,), w, EPS)),
            "copy_ms": graph_ms(lambda: got.copy_(x)),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "launch_floor_ms": launch_floor_ms})
        timed.append(rec)
        del x, w, got, want
    return timed


def _shared_prompts(rng, vocab):
    lengths = [5, 63, 64, 65, 200, 511, 1000, 1500]
    prompts = [rng.integers(0, vocab, size=n).tolist() for n in lengths]
    prefix = rng.integers(0, vocab, size=512).tolist()  # 32 full pages
    a = prefix + rng.integers(0, vocab, size=9).tolist()
    b = prefix + rng.integers(0, vocab, size=23).tolist()
    return prompts, a, b


def phase_slice():
    import gc
    import threading

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
    # What this process still holds with the replica dropped and its engine
    # joined, and again without torch's cuBLAS workspaces (one for each
    # stream that ran a product): recorded, not gated.
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
        torch.cuda.empty_cache()
    emit({"phase": "slice", "part": "after_drop",
          "cuda_memory_allocated": held,
          "without_cublas_workspaces": (torch.cuda.memory_allocated()
                                        if clear is not None else None),
          "llm_engine_threads": sum(t.name == "llm-engine"
                                    for t in threading.enumerate())})
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


def flash_launches_by_design() -> dict:
    """flash_kernel_launches_total's counts, {(pass, design): n}."""
    from ray_tpu_torch.ops.flash_attention import DESIGNS, launch_counter

    out = {}
    for p_ in FLASH_DESIGN:
        for d_ in DESIGNS:
            counter, key = launch_counter(p_, d_)
            out[(p_, d_)] = counter._deltas.get(key, 0.0)
    return out


def causal_pairs(lq: int, lk: int) -> int:
    """(q, k) pairs a top-left causal mask keeps: q_pos >= k_pos."""
    return sum(min(i + 1, lk) for i in range(lq))


def _flash_timed(q, k, v, do, plain: bool = True) -> tuple:
    """The three flash kernels' device times on causal bf16 [b, L, h, d]
    inputs beside the plain version (unless `plain` is False: its f32
    scores take 4 b h L^2 bytes), the bound and the library call
    (scaled_dot_product_attention; its backward as forward-and-backward
    minus forward). Returns (records, (o, lse, delta))."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.flash_attention import (_delta,
                                                   _flash_bwd_dkv_plain,
                                                   _flash_bwd_dq_plain,
                                                   _flash_fwd_plain,
                                                   flash_bwd_dkv_cuda,
                                                   flash_bwd_dq_cuda,
                                                   flash_fwd_cuda)

    b, L, h, hd = q.shape
    o, lse = flash_fwd_cuda(q, k, v, True)
    delta = _delta(o, do)
    t_bytes = b * L * h * hd * 2  # one [b, L, h, d] bf16 tensor
    s_bytes = b * h * L * 4  # one f32 [b, h, L] row statistic
    pairs = causal_pairs(L, L)
    timed = {}

    def rec(name, kernel, plain_fn, products, n_in, n_out, n_stats):
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
            "plain_ms": graph_ms(plain_fn, calls=2, reps=3) if plain
            else None,
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
        "method": f"F.scaled_dot_product_attention(is_causal=True), "
                  f"{[b, h, L, hd]} bf16, CUDA graph"}
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
    lib_bwd = fwd_bwd_minus_fwd_ms(
        lambda: sdpa(qg, kg, vg, is_causal=True),
        lambda: torch.autograd.grad(sdpa(qg, kg, vg, is_causal=True),
                                    (qg, kg, vg), dot), calls=10)
    lib_bwd["covers"] = "dq, dk and dv together (K4 + K5)"
    timed["flash_bwd_dq"]["library"] = lib_bwd
    timed["flash_bwd_dkv"]["library"] = lib_bwd
    return timed, (o, lse, delta)


def _kernels_at(rows: int, d: int, attn_shape) -> dict:
    """All five kernels at one path's shapes (bf16): each against its
    plain version (the RMSNorm forward within 1 bf16 ulp, the others by
    bf16_close against the plain version in f32), and its device time
    beside the plain version, the bound and the library call."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.flash_attention import (_flash_bwd_dkv_plain,
                                                   _flash_bwd_dq_plain,
                                                   _flash_fwd_plain,
                                                   flash_bwd_dkv_cuda,
                                                   flash_bwd_dq_cuda)
    from ray_tpu_torch.ops.rmsnorm import (_rmsnorm_bwd_plain,
                                           _rmsnorm_plain, rmsnorm_bwd_cuda,
                                           rmsnorm_cuda)

    dev, bf = torch.device("cuda", 0), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    x = torch.randn((rows, d), generator=gen, device=dev).to(bf)
    w = (torch.randn(d, generator=gen, device=dev) * 0.1 + 1).to(bf)
    g = torch.randn((rows, d), generator=gen, device=dev).to(bf)
    xr, wr = (t.detach().requires_grad_(True) for t in (x, w))
    out = {}
    y = rmsnorm_cuda(x, w, EPS)
    want = _rmsnorm_plain(x, w, EPS)
    ulp = bf16_ulp_diff(y, want)
    fwd_bytes = 2 * rows * d * 2 + d * 2
    out["rmsnorm_fwd"] = {
        "shape": [rows, d], "ok": ulp <= 1, "ulp": ulp,
        "max_abs_err": float((y.float() - want.float()).abs().max()),
        "ms": graph_ms(lambda: rmsnorm_cuda(x, w, EPS), calls=50),
        "plain_ms": graph_ms(lambda: _rmsnorm_plain(x, w, EPS), calls=20),
        "library_ms": graph_ms(lambda: F.rms_norm(x, (d,), w, EPS),
                               calls=50),
        "bound_ms": fwd_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    dx, dw = rmsnorm_bwd_cuda(x, w, g, EPS)
    want = _rmsnorm_bwd_plain(x.float(), w.float(), g.float(), EPS)
    oks = [bf16_close(a, b) for a, b in zip((dx, dw), want)]
    bwd_bytes = 3 * rows * d * 2 + 2 * d * 2
    out["rmsnorm_bwd"] = {
        "shape": [rows, d], "ok": all(ok for ok, _ in oks),
        "rel_l2": [rel for _, rel in oks],
        "max_abs_err": max(float((a.float() - b).abs().max())
                           for a, b in zip((dx, dw), want)),
        "ms": graph_ms(lambda: rmsnorm_bwd_cuda(x, w, g, EPS), calls=50),
        "plain_ms": graph_ms(lambda: _rmsnorm_bwd_plain(x, w, g, EPS),
                             calls=20),
        "library_ms": fwd_bwd_minus_fwd_ms(
            lambda: F.rms_norm(xr, (d,), wr, EPS),
            lambda: torch.autograd.grad(F.rms_norm(xr, (d,), wr, EPS),
                                        (xr, wr), g), calls=50)["ms"],
        "bound_ms": bwd_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    del x, w, g, xr, wr, y, dx, dw, want

    def rand():
        return torch.randn(attn_shape, generator=gen, device=dev).to(bf)

    q, k, v, do = rand(), rand(), rand(), rand()
    timed, (o, lse, delta) = _flash_timed(q, k, v, do)
    f = [t.float() for t in (q, k, v, do)]
    o_ref, _ = _flash_fwd_plain(f[0], f[1], f[2], True)
    dq_ref = _flash_bwd_dq_plain(*f, lse, delta, True)
    dk_ref, dv_ref = _flash_bwd_dkv_plain(*f, lse, delta, True)
    got = {"flash_fwd": [(o, o_ref)],
           "flash_bwd_dq": [(flash_bwd_dq_cuda(q, k, v, do, lse, delta, True),
                             dq_ref)],
           "flash_bwd_dkv": list(zip(flash_bwd_dkv_cuda(q, k, v, do, lse,
                                                        delta, True),
                                     (dk_ref, dv_ref)))}
    for name, pairs in got.items():
        t = timed[name]
        oks = [bf16_close(a, b) for a, b in pairs]
        out[name] = {
            "shape": t["shape"], "ok": all(ok for ok, _ in oks),
            "rel_l2": [rel for _, rel in oks],
            "max_abs_err": max(float((a.float() - b).abs().max())
                               for a, b in pairs),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "library_ms": t["library"]["ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"]}
    del q, k, v, do, o, lse, delta, f, o_ref, dq_ref, dk_ref, dv_ref, got
    torch.cuda.empty_cache()
    bad = [n for n, r in out.items() if not r["ok"]]
    check(not bad, f"kernels disagree with their plain versions at "
          f"{rows} x {d} / {list(attn_shape)}: {bad}")
    return out


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
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.models.transformer import mla_softmax_scale
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

    def rms_case(dtype, rows, d):
        x = (torch.randn((rows, d), generator=gen, device=dev) * 3).to(dtype)
        w = (torch.randn(d, generator=gen, device=dev) * 0.1 + 1).to(dtype)
        g = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
        dx, dw = rmsnorm_bwd_cuda(x, w, g, EPS)
        torch.cuda.synchronize()
        want = _rmsnorm_bwd_plain(x.float(), w.float(), g.float(), EPS)
        case = {"dtype": str(dtype).split(".")[-1], "rows": rows, "d": d}
        judge("rmsnorm_bwd", dx, want[0], dtype, 1e-4, dict(case, out="dx"))
        judge("rmsnorm_bwd", dw, want[1], dtype, 1e-4, dict(case, out="dw"))

    def flash_case(dtype, causal, lq, lk, d, b, h, scale=None):
        def rand(n):
            return torch.randn((b, n, h, d), generator=gen,
                               device=dev).to(dtype)
        q, k, v, do = rand(lq), rand(lk), rand(lk), rand(lq)
        before = flash_launches_by_design()
        o, lse = flash_fwd_cuda(q, k, v, causal, scale)
        delta = _delta(o, do)
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        design = {p_: FLASH_DESIGN[p_][name][d] for p_ in FLASH_DESIGN}
        after = flash_launches_by_design()
        served = {k_: after[k_] - before[k_] for k_ in after
                  if after[k_] != before[k_]}
        check(served == {(p_, design[p_]): 1.0 for p_ in design},
              f"flash launches by design at {name} d={d}: {served}, "
              f"expected {design}")
        f = [t.float() for t in (q, k, v, do)]
        o_ref, lse_ref = _flash_fwd_plain(f[0], f[1], f[2], causal, scale)
        dq_ref = _flash_bwd_dq_plain(f[0], f[1], f[2], f[3], lse, delta,
                                     causal, scale)
        dk_ref, dv_ref = _flash_bwd_dkv_plain(f[0], f[1], f[2], f[3], lse,
                                              delta, causal, scale)
        case = {"dtype": str(dtype).split(".")[-1], "causal": causal,
                "b": b, "h": h, "lq": lq, "lk": lk, "d": d}
        if scale is not None:
            case["scale"] = scale
        judge("flash_fwd", o, o_ref, dtype, 2e-4, dict(case, out="o"))
        judge("flash_fwd", lse, lse_ref, torch.float32, 2e-4,
              dict(case, out="lse"))
        judge("flash_bwd_dq", dq, dq_ref, dtype, 2e-3, dict(case, out="dq"))
        judge("flash_bwd_dkv", dk, dk_ref, dtype, 2e-3, dict(case, out="dk"))
        judge("flash_bwd_dkv", dv, dv_ref, dtype, 2e-3, dict(case, out="dv"))
        del q, k, v, do, o, lse, delta, dq, dk, dv, f, o_ref, dq_ref
        del dk_ref, dv_ref
        torch.cuda.empty_cache()

    for dtype in (torch.bfloat16, torch.float32):
        for d in RMS_BWD_DIMS:
            for rows in RMS_BWD_ROWS:
                rms_case(dtype, rows, d)
        for fc in FLASH_CASES:
            flash_case(dtype, *fc)
    for rows, d in MLA_RMS_SHAPES:
        rms_case(torch.bfloat16, rows, d)
    flash_case(torch.bfloat16, *MLA_FLASH_CASE,
               scale=mla_softmax_scale(configs.mistral_small_4))
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
    flash, (o, lse, delta) = _flash_timed(q, k, v, do)
    timed.update(flash)
    sdpa = F.scaled_dot_product_attention
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))

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
    del q, k, v, do, o, lse, delta, qt, kt, vt, dot, qg, kg, vg
    del want, out, sdpa_got, kern_got
    torch.cuda.empty_cache()
    # The latent-attention training cell's flash shape beside the moe_train
    # shape's [4, 1024, 32, 128] (phase_moe_train): [4, 8192, 32, 128]
    # causal, without the plain version (its f32 scores take 34 GB).
    q, k, v, do = (torch.randn((4, 8192, 32, 128), generator=gen,
                               device=dev).to(bf) for _ in range(4))
    timed["flash_at_8192"] = _flash_timed(q, k, v, do, plain=False)[0]
    del q, k, v, do
    torch.cuda.empty_cache()
    timed["rmsnorm_fwd"] = rmsnorm_fwd_timed(TRAIN_FWD_SHAPES)
    emit({"phase": "train_kernels_timed", "flash_sdp_enabled":
          torch.backends.cuda.flash_sdp_enabled(), "timed": timed})
    bad = [r for r in timed["rmsnorm_fwd"] if not r["ok"]]
    check(not bad, f"rmsnorm_fwd disagrees with its plain version at the "
          f"training shapes: {bad}")
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


def _profile_step(step, tokens, split=None) -> dict:
    """Device time of one step by kernel group (torch.profiler). A failure
    of the step itself propagates; one of the profiler is reported as
    'not measured'. split(prof), where given, adds a further breakdown
    ("moe_split_ms") read from the same trace."""
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
        if getattr(evt, "is_user_annotation", False) or evt.key in MOE_RANGES:
            continue  # a record_function range's span, not a kernel
        g = _kernel_group(evt.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        total += us / 1e3
        if g == "other":
            other.append((us / 1e3, evt.count, evt.key[:100]))
    if total == 0.0:
        return {"device_ms": "not measured (no device time in the trace)",
                "profiled_wall_ms": wall * 1e3}
    rec = {"device_ms": total, "profiled_wall_ms": wall * 1e3,
           "by_group_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
           "top_other": [{"ms": ms, "calls": n, "kernel": k}
                         for ms, n, k in sorted(other, reverse=True)[:10]]}
    if split is not None:
        try:
            rec["moe_split_ms"] = split(prof)
        except Exception as e:  # noqa: BLE001 - the trace's shape, not the step
            rec["moe_split_ms"] = f"not measured ({type(e).__name__}: {e})"
    return rec


def _predicted_launches(L: int) -> dict:
    """Kernel launches of one training step of an L-layer model, from the
    code: every layer's two norms and its attention run forward once and
    again when remat (full or dots_nobatch) recomputes the layer in the
    backward; the final norm runs once; each backward runs once."""
    return {"rmsnorm_fwd": 2 * L + 1 + 2 * L, "rmsnorm_bwd": 2 * L + 1,
            "flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}


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
    warm_losses = [step(batches[i]) for i in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_losses = [loss.item() for loss in warm_losses]
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
    predicted = _predicted_launches(L)
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
           "max_memory_allocated": peak, "warmup_losses": warm_losses,
           "losses": losses,
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


# -- the MoE training step: mixtral-8x7b at published widths ---------------
# Depth cut from 32 to 4 layers (6.07 B parameters: params, grads and bf16
# AdamW state about 48.5 GB); the whole model, 46.7 B, cannot fit one card.
MOE_LAYERS = 4
MOE_BATCH, MOE_SEQ, MOE_WARMUP, MOE_STEPS = 4, 1024, 1, 5
MOE_RANGES = ("moe.routing", "moe.dispatch", "moe.experts", "moe.combine")


def _moe_cfg():
    from ray_tpu_torch.models import configs

    return dataclasses.replace(configs.mixtral_8x7b, n_layers=MOE_LAYERS,
                               max_seq=MOE_SEQ)


def _active_params(cfg, n_params: int) -> int:
    """Parameters one token runs through: everything but the experts, plus
    k / E of the experts (bench.py's 6ND with N the active parameters)."""
    experts = 3 * cfg.num_experts * cfg.d_model * cfg.d_ff * cfg.n_layers
    return n_params - experts + experts * cfg.experts_per_token \
        // cfg.num_experts


def _moe_split(prof) -> dict:
    """Device ms of the MoE layers' parts in a profiled step: the ops run
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


class _DispatchLog:
    """Keeps each routing call's experts and slots on the host."""

    def __init__(self):
        from ray_tpu_torch.parallel import moe

        self.mod, self.orig, self.masks = moe, moe.route, []

    def __enter__(self):
        import torch

        def logged(logits, k, capacity, *args, **kwargs):
            out = self.orig(logits, k, capacity, *args, **kwargs)
            self.masks.append(torch.stack(out[:2]).cpu())
            return out
        self.mod.route = logged
        return self

    def __exit__(self, *exc):
        self.mod.route = self.orig


def _moe_parity() -> dict:
    """A narrow f32 MoE (mixtral's layout at d 256, 4 experts, 2 layers,
    head_dim 64, GQA) on the card against the CPU on the same parameters:
    the same expert assignment, then the loss and every gradient."""
    import torch

    from ray_tpu_torch.models import init_params, loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(_moe_cfg(), d_model=256, n_heads=4,
                              n_kv_heads=2, d_ff=512, num_experts=4,
                              n_layers=2, vocab_size=1024, max_seq=256,
                              dtype=torch.float32)
    cpu_params = init_params(cfg, seed=SEED + 4, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(SEED + 4).integers(
        0, cfg.vocab_size, size=(2, 129)))

    def step(device):
        params = {k: ({kk: vv.to(device) for kk, vv in v.items()}
                      if k == "layers" else v.to(device))
                  for k, v in cpu_params.items()}
        leaves = _flat_params(params)
        for t in leaves:
            t.requires_grad_(True)
        with _DispatchLog() as log:
            loss = loss_fn(params, tokens.to(device), cfg)
            loss.backward()
        return loss.item(), [t.grad.cpu() for t in leaves], log.masks

    loss_gpu, grads_gpu, masks_gpu = step("cuda")
    loss_cpu, grads_cpu, masks_cpu = step("cpu")
    same_routing = len(masks_gpu) == len(masks_cpu) and all(
        torch.equal(a, b) for a, b in zip(masks_gpu, masks_cpu))
    names = [k for k in sorted(cpu_params) if k != "layers"] + [
        f"layers/{k}" for k in sorted(cpu_params["layers"])]
    leaves, ok = {}, abs(loss_gpu - loss_cpu) <= 2e-4 * abs(loss_cpu)
    for n, g, gc in zip(names, grads_gpu, grads_cpu):
        rel = float((g - gc).norm() / gc.norm().clamp_min(1e-30))
        close = bool(torch.allclose(g, gc, rtol=2e-3, atol=2e-3))
        leaves[n] = {"max_abs_err": float((g - gc).abs().max()),
                     "rel_l2": rel, "close": close}
        ok = ok and close and rel <= 1e-3
    return {"model": "mixtral layout, d 256, 4 experts, 2 layers",
            "dtype": "float32", "batch": 2, "seq": 128,
            "routing_calls": len(masks_gpu), "same_routing": same_routing,
            "loss_gpu": loss_gpu, "loss_cpu": loss_cpu,
            "loss_tol": "rtol 2e-4",
            "leaf_tol": "rtol=atol=2e-3 and rel L2 <= 1e-3",
            "leaves": leaves, "ok": ok and same_routing}


def _moe_plain(x, router, w, k):
    """moe_layer's arithmetic written token by token from the routing:
    out[t] = sum over t's kept slots of gate * (x[t] @ w[e])."""
    import torch

    from ray_tpu_torch.parallel.moe import top_k_routing

    t_n, e_n = x.shape[0], router.shape[-1]
    cap = max(1, int(1.25 * t_n * k / e_n))
    dispatch, combine, aux = top_k_routing(x @ router, k, cap)
    out = torch.zeros_like(x)
    for t, e, c in dispatch.nonzero().tolist():
        out[t] += combine[t, e, c] * (x[t] @ w[e])
    return out, aux


def _nccl_one_rank(tmp: str) -> dict:
    """build_mesh(MeshConfig(), "cuda") on a one-rank NCCL group, and the
    four primitives through it at axis size 1 against their references,
    outputs and gradients (f32, TF32 off)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import (MeshConfig, build_mesh, moe_layer,
                                        pipeline_stages, ring_attention,
                                        ulysses_attention)
    from ray_tpu_torch.parallel import _comm
    from ray_tpu_torch.parallel.ring_attention import reference_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rdzv",
                            rank=0, world_size=1)
    errs = {}
    try:
        mesh = build_mesh(MeshConfig(), "cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 6)

        def rand(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device="cuda")
                    * scale).requires_grad_(True)

        def compare(name, got_fn, want_fn, inputs, tol):
            ct = torch.randn_like(got_fn(*inputs).detach())
            outs = []
            for fn in (got_fn, want_fn):
                for t in inputs:
                    t.grad = None
                o = fn(*inputs)
                (o * ct).sum().backward()
                outs.append([o.detach()] + [t.grad.clone() for t in inputs])
            errs[name] = max(float((a - b).abs().max())
                             for a, b in zip(*outs))
            check(errs[name] <= tol, f"{name} on the NCCL mesh differs from "
                  f"its reference by {errs[name]} (tol {tol})")

        q, k, v = rand(2, 256, 4, 64), rand(2, 256, 4, 64), rand(2, 256, 4, 64)
        for causal in (True, False):
            compare(f"ring_attention_causal_{causal}",
                    lambda q, k, v: ring_attention(q, k, v, mesh,
                                                   causal=causal),
                    lambda q, k, v: reference_attention(q, k, v, causal),
                    (q, k, v), 2e-4)
        compare("ulysses_attention",
                lambda q, k, v: ulysses_attention(q, k, v, mesh),
                lambda q, k, v: reference_attention(q, k, v, True),
                (q, k, v), 2e-4)
        ws, xs = rand(1, 64, 64, scale=0.1), rand(4, 8, 64)

        def stage(w, x):
            return torch.tanh(x @ w[0])
        compare("pipeline_stages",
                lambda w, x: pipeline_stages(stage, w, x, mesh),
                lambda w, x: torch.stack([stage(w, xi) for xi in x]),
                (ws, xs), 1e-5)
        x, router, w = rand(64, 32), rand(32, 4, scale=0.1), \
            rand(4, 32, 32, scale=0.1)
        compare("moe_layer",
                lambda x, r, w: moe_layer(
                    x, r, lambda w, xin: torch.einsum("ecd,edf->ecf", xin, w),
                    w, k=2, mesh=mesh)[0],
                lambda x, r, w: _moe_plain(x, r, w, 2)[0], (x, router, w),
                1e-5)
        # One collective through NCCL itself: a gather of one rank.
        y = torch.arange(8.0, device="cuda")
        got = _comm._gather(y, mesh.get_group("tp"), 1, 0)
        check(torch.equal(got, y), "NCCL's one-rank all-gather changed data")
        rec = {"backend": dist.get_backend(), "mesh": list(mesh.mesh.shape),
               "axes": list(mesh.mesh_dim_names), "max_abs_err": errs}
    finally:
        dist.destroy_process_group()
    return rec


def phase_moe_train(device_name):
    """mixtral-8x7b at published widths, 4 layers, bf16, remat full,
    batch 4 x 1024: loss_fn, backward and AdamW as the train phase."""
    import tempfile

    import torch

    from ray_tpu_torch.models import init_params, loss_fn

    parity = _moe_parity()
    emit({"phase": "moe_parity", **parity})
    check(parity["ok"], "the narrow MoE step on the card differs from the "
          "CPU's (routing, loss or a gradient)")
    with tempfile.TemporaryDirectory() as tmp:
        nccl = _nccl_one_rank(tmp)
    emit({"phase": "moe_nccl", **nccl})

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _moe_cfg()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device="cuda")
    leaves = _flat_params(params)
    for t in leaves:
        t.requires_grad_(True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves)
    n_active = _active_params(cfg, n_params)
    opt = torch.optim.AdamW(leaves, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    batches = torch.randint(0, cfg.vocab_size,
                            (MOE_WARMUP + MOE_STEPS + 1, MOE_BATCH,
                             MOE_SEQ + 1), generator=gen, device="cuda")

    def step(tokens):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens, cfg)
        loss.backward()
        opt.step()
        return loss

    t0 = time.perf_counter()
    warm = [step(batches[i]).item() for i in range(MOE_WARMUP)]
    warm_s = time.perf_counter() - t0
    counters = _train_launch_counters()
    # The main path starts here: counts at 0, peak memory reset.
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(MOE_STEPS):
        t0 = time.perf_counter()
        loss = step(batches[MOE_WARMUP + i])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = {n: fn.launches for n, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    predicted = _predicted_launches(L)
    per_step = {n: c / MOE_STEPS for n, c in launches.items()}
    with torch.no_grad():  # the first batch again, after the six steps
        first_again = loss_fn(params, batches[0], cfg).item()
    profile_rec = _profile_step(step, batches[-1], split=_moe_split)
    step_ms = sorted(times)[len(times) // 2] * 1e3
    if isinstance(profile_rec.get("device_ms"), float):
        profile_rec["device_busy_share"] = profile_rec["device_ms"] / step_ms
        split = profile_rec.get("moe_split_ms")
        if isinstance(split, dict):
            profile_rec["moe_split_share"] = {
                g: ms / profile_rec["device_ms"] for g, ms in split.items()}
    tokens = MOE_BATCH * MOE_SEQ
    tok_s = tokens / (step_ms / 1e3)
    rec = {"phase": "moe_train", "model": "mixtral-8x7b",
           "device": device_name, "dtype": "bfloat16", "n_layers": L,
           "depth_cut": "32 -> 4 layers", "d_model": cfg.d_model,
           "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
           "d_ff": cfg.d_ff, "experts": cfg.num_experts,
           "top_k": cfg.experts_per_token, "vocab": cfg.vocab_size,
           "params": n_params, "active_params": n_active,
           "remat_policy": cfg.remat_policy, "batch": MOE_BATCH,
           "seq": MOE_SEQ, "warmup_steps": MOE_WARMUP, "steps": MOE_STEPS,
           "init_params_s": init_s, "warmup_s": warm_s,
           "step_ms_median": step_ms, "step_ms_all": [t * 1e3 for t in times],
           "tokens_per_s": tok_s,
           "mfu_6nd_active": tok_s * 6.0 * n_active / BF16_FLOPS,
           "max_memory_allocated": peak, "warmup_losses": warm,
           "losses": losses, "first_batch_loss_after": first_again,
           "launches": launches,
           "launches_per_step": per_step, "predicted_per_step": predicted,
           "profile_one_step": profile_rec}
    emit(rec)
    check(n_params == 4 * 1_451_270_144 + 262_144_000 + cfg.d_model,
          f"mixtral at 4 layers has {n_params} parameters")
    check(all(np.isfinite(warm + losses)), f"a loss is not finite: {losses}")
    check(first_again < warm[0], f"the first batch's loss did not fall: "
          f"{warm[0]} -> {first_again}")
    check(per_step == {n: float(c) for n, c in predicted.items()},
          f"launches per step {per_step} != predicted {predicted}")
    del params, leaves, opt, batches
    torch.cuda.empty_cache()
    kernels = _kernels_at(MOE_BATCH * MOE_SEQ, cfg.d_model,
                          (MOE_BATCH, MOE_SEQ, cfg.n_heads, cfg.head_dim))
    emit({"phase": "moe_kernels", "kernels": kernels})
    rec["kernels"] = kernels
    return rec


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


def _stop_runtime() -> tuple:
    """After a runtime's shutdown: wait for its workers to exit, stop the
    zygote this process started, and return what is left of both. The
    zygote serves every runtime this process starts and stops at exit;
    stopping it now leaves no process of the phase behind."""
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
    return left, _runtime_procs()


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

    _wait_gpu(rt, 1.0, "the serving actor's GPU was never released")
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
    _wait_gpu(rt, 1.0, "the GPU was never released")
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
    left, procs = _stop_runtime()
    rec["workers_after_shutdown"] = left
    rec["runtime_procs_after_zygote_stop"] = procs
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
    if not maps:
        # A process that has exited and not yet been reaped (a zombie)
        # has no mappings left to read.
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


GPU_SETTLE_S = 1.5  # three of the raylet's heartbeats


def _wait_gpu(rt, want: float, what: str) -> None:
    """Wait until the GCS's view of the GPU reads `want` and holds it for
    GPU_SETTLE_S (three of the raylet's heartbeats). The GCS no longer
    credits a removed group's card before the raylet frees it (ROADMAP
    §C, fixed); the wait stays as a guard against a reading that does
    not hold."""
    deadline = time.monotonic() + 120
    since = None
    while True:
        now = time.monotonic()
        if rt.available_resources().get("GPU", 0.0) != want:
            since = None
        elif since is None:
            since = now
        elif now - since >= GPU_SETTLE_S:
            return
        check(now < deadline, what)
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
    left, procs = _stop_runtime()
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
           "runtime_procs_after_zygote_stop": procs,
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


# -- the trainer: llama2-1b through TorchTrainer from a GPU worker ----------
# The loop below runs in the training worker; it lives in __main__, so the
# runtime ships it (and the helpers and constants it names) by value.
TRAINER_STEPS = TRAIN_WARMUP + TRAIN_STEPS + 1  # phase_train's 13 batches
TRAINER_SAVE_AT, TRAINER_DIE_AT = 4, 6          # 1-based steps
# Step losses of the trainer against phase_train's (the same step on the
# same card) and against its own run before the death: measured equal,
# bit for bit (PERF.md §6). The bound leaves room for a reduction
# summed in another order, which moves an f32 loss of ~10.9 by ~1e-6.
TRAINER_LOSS_RTOL = 1e-5


def _bits_checksums(tensors) -> list:
    """Per tensor, the sum of its bit patterns and a position-weighted sum:
    equal for bit-equal tensors."""
    import torch

    out = []
    for t in tensors:
        v = t.detach().reshape(-1)
        v = v.view(torch.int16 if v.element_size() == 2 else torch.int32)
        v = v.to(torch.int64)
        w = torch.arange(v.numel(), device=v.device, dtype=torch.int64)
        out.append([int(v.sum()), int((v * (w % 65521 + 1)).sum())])
    return out


def _opt_tensors(opt, leaves) -> list:
    """AdamW's moments (and step counts) in the order of `leaves`."""
    out = []
    for p in leaves:
        st = opt.state[p]
        out += [st["exp_avg"], st["exp_avg_sq"], st["step"]]
    return out


def _dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def _trainer_loop(config):
    """phase_train's step (llama2-1b, seed, AdamW hyperparameters and
    batches alike) in a TorchTrainer worker: checkpointed after step
    TRAINER_SAVE_AT, killed once after step TRAINER_DIE_AT; every step
    reports its loss, time and kernel launches."""
    loop_start = time.time()
    import dataclasses
    import os
    import sys

    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch._private import chaos
    from ray_tpu_torch._private.accelerators.gpu import granted_gpu_ids
    from ray_tpu_torch.models import configs, init_params, loss_fn
    from ray_tpu_torch.train import Checkpoint
    from ray_tpu_torch.train.torch import get_device

    device = get_device()
    cfg = dataclasses.replace(configs.llama2_1b, max_seq=TRAIN_SEQ,
                              remat=True, remat_policy="dots_nobatch")
    counters = _train_launch_counters()
    info = {"pid": os.getpid(), "device": str(device),
            "loop_start_wall": loop_start,
            "device_name": torch.cuda.get_device_name(device),
            "device_count": torch.cuda.device_count(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "granted": granted_gpu_ids(),
            "backend": dist.get_backend(),
            "world_size": dist.get_world_size(),
            "jax_or_ray_tpu_modules": sorted(
                m for m in sys.modules if m in ("jax", "ray_tpu")
                or m.startswith(("jax.", "ray_tpu.")))}
    ckpt = train.get_checkpoint()
    t0 = time.perf_counter()
    if ckpt is None:
        params = init_params(cfg, seed=SEED, device=device)
        start, restored = 0, None
    else:
        # Each tensor back on the device type it was saved from: the
        # params and AdamW's moments on the card, its step counts on the
        # CPU, where phase_train's AdamW keeps them.
        state = ckpt.to_pytree()
        torch.cuda.synchronize()
        restored = {"s": time.perf_counter() - t0, "step": state["step"],
                    "bytes": _dir_bytes(ckpt.path)}
        params, start = state["params"], state["step"]
    leaves = _flat_params(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    if ckpt is not None:
        opt.load_state_dict(state["opt"])
        del state
        t1 = time.perf_counter()
        restored["checksums"] = _bits_checksums(
            leaves + _opt_tensors(opt, leaves))
        restored["checksum_s"] = time.perf_counter() - t1
    info["setup_s"] = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    batches = torch.randint(0, cfg.vocab_size,
                            (TRAINER_STEPS, TRAIN_BATCH, TRAIN_SEQ + 1),
                            generator=gen, device=device)
    n_params = sum(t.numel() for t in leaves)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    prof = train.StepProfiler(flops_per_step=6.0 * n_params * tokens)
    for i in range(start, TRAINER_STEPS):
        step_no = i + 1
        for fn in counters.values():
            fn.launches = 0
        saved, ck = None, None
        t0 = time.perf_counter()
        with prof.step(tokens=tokens) as s:
            with prof.phase("compute"):
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(params, batches[i], cfg)
                loss.backward()
                opt.step()
            s.fence(loss)
            step_s = time.perf_counter() - t0
            launches = {n: fn.launches for n, fn in counters.items()}
            if step_no == TRAINER_SAVE_AT:
                with prof.phase("checkpoint"):
                    t1 = time.perf_counter()
                    ck = Checkpoint.from_pytree(
                        {"params": params, "opt": opt.state_dict(),
                         "step": step_no},
                        os.path.join(train.get_trial_dir(),
                                     f"step_{step_no}"))
                    saved = {"s": time.perf_counter() - t1,
                             "bytes": _dir_bytes(ck.path)}
                saved["checksums"] = _bits_checksums(
                    leaves + _opt_tensors(opt, leaves))
        rec = prof.records()[-1]
        metrics = {"step": step_no, "loss": loss.item(), "step_s": step_s,
                   "wall": time.time(), "launches": launches,
                   "first_of_attempt": i == start,
                   "mfu": rec.get("mfu"),
                   "peak_memory": torch.cuda.max_memory_allocated(device)}
        if i == start:
            metrics.update(info=info, restored=restored)
        if saved is not None:
            metrics["saved"] = saved
        train.report(metrics, checkpoint=ck)
        if (step_no == TRAINER_DIE_AT
                and chaos.once(config["dir"], "trainer_death")):
            # Let the trainer's poll (every 50 ms) drain this report
            # first, then die as a preempted host does.
            time.sleep(1.0)
            with open(os.path.join(config["dir"], "died_at"), "w") as f:
                f.write(repr(time.time()))
            chaos.enable()
            chaos.die()


def phase_trainer(train_rec, device_name):
    import gc
    import os
    import shutil
    import tempfile
    import threading

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig,
                                     RunConfig, ScalingConfig, TorchTrainer)

    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="rt_trainer_")
    rt.init(num_cpus=4)
    try:
        trainer = TorchTrainer(
            _trainer_loop, train_loop_config={"dir": tmp},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(
                name="llama2_1b", storage_path=tmp,
                failure_config=FailureConfig(max_failures=1, backoff_s=0),
                checkpoint_config=CheckpointConfig(num_to_keep=1)))
        out = {}

        def fit():
            try:
                out["result"] = trainer.fit()
            except BaseException as e:  # noqa: BLE001 — raised below
                out["error"] = e

        t0 = time.time()
        th = threading.Thread(target=fit, daemon=True, name="trainer-fit")
        th.start()
        mapped = {}
        while th.is_alive():
            # Every training worker, read while it lives. A worker is read
            # many times, and what any read saw is kept: a read taken while
            # the dying worker is torn down sees less than it had mapped.
            for pid in _worker_pids().values():
                m = _mapped(pid)
                if m["readable"]:
                    seen = mapped.get(pid, {})
                    mapped[pid] = {k: v or seen.get(k, False)
                                   for k, v in m.items()}
            th.join(1.0)
        fit_s = time.time() - t0
        if "error" in out:
            raise out["error"]
        result = out["result"]
        _wait_gpu(rt, 1.0, "the GPU was not back at 1.0 after the fit")
        gpu_after = rt.available_resources().get("GPU", 0.0)
        live = _runtime_workers()
    finally:
        rt.shutdown()
    left, procs = _stop_runtime()
    died_at = None
    if os.path.exists(os.path.join(tmp, "died_at")):
        with open(os.path.join(tmp, "died_at")) as f:
            died_at = float(f.read())
    shutil.rmtree(tmp, ignore_errors=True)

    check(result.error is None, f"the fit failed: {result.error}")
    hist = result.metrics_history
    steps = [m["step"] for m in hist]
    want_steps = (list(range(1, TRAINER_DIE_AT + 1))
                  + list(range(TRAINER_SAVE_AT + 1, TRAINER_STEPS + 1)))
    check(steps == want_steps, f"steps {steps} != {want_steps}")
    before, after = hist[:TRAINER_DIE_AT], hist[TRAINER_DIE_AT:]
    predicted = train_rec["predicted_per_step"]
    bad = [(m["step"], m["launches"]) for m in hist
           if m["launches"] != predicted]
    ref = train_rec["warmup_losses"] + train_rec["losses"]
    vs_train = [{"step": m["step"], "trainer": m["loss"],
                 "phase_train": ref[m["step"] - 1],
                 "rel": abs(m["loss"] - ref[m["step"] - 1])
                 / abs(ref[m["step"] - 1])}
                for m in before[:TRAINER_SAVE_AT]]
    repeated = [{"step": a["step"], "before_death": a["loss"],
                 "after_restore": b["loss"],
                 "rel": abs(a["loss"] - b["loss"]) / abs(a["loss"])}
                for a in before[TRAINER_SAVE_AT:] for b in after
                if b["step"] == a["step"]]
    saved = next(m["saved"] for m in hist if "saved" in m)
    restored = after[0]["restored"]
    timed = [m for m in hist
             if not m["first_of_attempt"] and "saved" not in m]

    def median_ms(ms):
        return sorted(m["step_s"] for m in ms)[len(ms) // 2] * 1e3

    step_ms = median_ms(timed)
    timed_before = [m for m in timed if m in before]
    timed_after = [m for m in timed if m in after]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = train_rec["params"]
    breakdown = {}
    for m in timed:
        for k, v in m.get("train_step_breakdown", {}).items():
            breakdown[k] = breakdown.get(k, 0.0) + v / len(timed)
    launches = {n: sum(m["launches"][n] for m in hist) for n in predicted}
    info = hist[0]["info"]
    torch_pids = [p for p, m in mapped.items() if m["torch"]]
    rec = {"phase": "trainer", "model": "llama2-1b", "dtype": "bfloat16",
           "n_layers": train_rec["n_layers"], "params": n_params,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "remat_policy": train_rec["remat_policy"],
           "scaling": {"num_workers": 1, "use_gpu": True},
           "fit_s": fit_s, "fit_to_first_report_s": hist[0]["wall"] - t0,
           "steps": steps, "timed_steps": [m["step"] for m in timed],
           "step_ms_median": step_ms,
           "step_ms_median_before_death": median_ms(timed_before),
           "step_ms_median_after_restore": median_ms(timed_after),
           "step_ms_all": [m["step_s"] * 1e3 for m in hist],
           "phase_train_step_ms_median": train_rec["step_ms_median"],
           "tokens_per_s": tokens / (step_ms / 1e3),
           "mfu_6nd": tokens / (step_ms / 1e3) * 6.0 * n_params / BF16_FLOPS,
           "flight_recorder": {
               "mfu_median": sorted(m["mfu"] for m in timed)[len(timed) // 2],
               "phase_mean_s": breakdown},
           "checkpoint": {"write_s": saved["s"], "bytes": saved["bytes"],
                          "restore_s": restored["s"],
                          "checksum_s_after_restore": restored["checksum_s"],
                          "restore_bytes": restored["bytes"],
                          "restored_step": restored["step"],
                          "bit_equal": saved["checksums"]
                          == restored["checksums"]},
           "fit_to_loop_start_s": info["loop_start_wall"] - t0,
           "death_to_first_report_s": (after[0]["wall"] - died_at
                                       if died_at is not None else None),
           "death_to_loop_start_s": (
               after[0]["info"]["loop_start_wall"] - died_at
               if died_at is not None else None),
           "worker_setup_s": {"first": info["setup_s"],
                              "after_restore": after[0]["info"]["setup_s"]},
           "peak_memory": max(m["peak_memory"] for m in hist),
           "process_group": {"backend": info["backend"],
                             "world_size": info["world_size"]},
           "worker_device": {k: info[k] for k in (
               "device", "device_name", "device_count", "visible",
               "granted")},
           "losses_vs_phase_train": vs_train,
           "losses_repeated": repeated, "loss_rtol": TRAINER_LOSS_RTOL,
           "launches": launches, "launches_per_step_predicted": predicted,
           "mapped": {str(p): m for p, m in mapped.items()},
           "gpu_available_after_fit": gpu_after,
           "workers_before_shutdown": len(live),
           "workers_after_shutdown": left,
           "runtime_procs_after_zygote_stop": procs}
    emit(rec)
    check(not bad, f"launches per step differ from {predicted}: {bad}")
    check(all(v["rel"] <= TRAINER_LOSS_RTOL for v in vs_train),
          f"the trainer's losses differ from phase_train's: {vs_train}")
    check(len(repeated) == TRAINER_DIE_AT - TRAINER_SAVE_AT
          and all(v["rel"] <= TRAINER_LOSS_RTOL for v in repeated),
          f"the steps run again after the restore differ: {repeated}")
    check(all(np.isfinite(m["loss"]) for m in hist), "a loss is not finite")
    check(rec["checkpoint"]["bit_equal"],
          "the restored tensors differ from the saved ones")
    check(restored["step"] == TRAINER_SAVE_AT,
          f"restored step {restored['step']}")
    check(died_at is not None, "the worker never died")
    check(info["backend"] == "nccl" and info["world_size"] == 1,
          f"process group {info['backend']} of {info['world_size']}")
    check(info["device_count"] == 1 and info["device_name"] == device_name,
          f"the worker sees {info['device_count']} device(s), "
          f"{info['device_name']}")
    check(len(info["granted"]) == 1
          and info["visible"] == info["granted"][0]
          and after[0]["info"]["visible"] == info["visible"],
          f"the raylet did not confine the worker to the card it granted: "
          f"CUDA_VISIBLE_DEVICES {info['visible']!r}, granted "
          f"{info['granted']}, after the restart "
          f"{after[0]['info']['visible']!r}")
    check(info["jax_or_ray_tpu_modules"] == [],
          f"the worker loaded {info['jax_or_ray_tpu_modules']}")
    check(len(torch_pids) >= 2, f"no two training workers were seen on the "
          f"card (one dies): {mapped}")
    check(not any(m["jax"] for m in mapped.values()),
          f"a training worker mapped JAX: {mapped}")
    check(gpu_after == 1.0, f"GPU {gpu_after} after the fit")
    check(not left, f"workers outlived shutdown(): {left}")
    check(not rec["runtime_procs_after_zygote_stop"],
          f"runtime processes outlived the zygote's stop: "
          f"{rec['runtime_procs_after_zygote_stop']}")
    return launches


# -- job submission: a working_dir job runs the RMSNorm kernel in a GPU task
JOB_MAIN = r"""
import json, os
import ray_tpu_torch as rt

rt.init(address=os.environ["RT_GCS_ADDR"])


@rt.remote(num_gpus=1)
def rmsnorm_probe():
    import torch
    from ray_tpu_torch.ops.rmsnorm import _rmsnorm_plain, rmsnorm_cuda

    # from the job's working_dir, or a path its env_vars name
    with open(os.environ.get("RT_JOB_DATA", "job_data.json")) as f:
        data = json.load(f)
    gen = torch.Generator(device="cuda").manual_seed(data["seed"])
    rows, d = data["shape"]
    x = (torch.randn((rows, d), generator=gen, device="cuda") * 3).to(
        torch.bfloat16)
    w = (torch.randn(d, generator=gen, device="cuda") * 0.1 + 1).to(
        torch.bfloat16)
    rmsnorm_cuda.launches = 0
    got = rmsnorm_cuda(x, w, data["eps"])
    launches = rmsnorm_cuda.launches
    want = _rmsnorm_plain(x, w, data["eps"])

    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return {"marker": os.environ.get("RT_JOB_MARKER"),
            "token": data["token"], "launches": launches,
            "ulp": int((ordered(got) - ordered(want)).abs().max()),
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "device": torch.cuda.get_device_name(), "pid": os.getpid()}


print("JOB_TASK " + json.dumps(rt.get(rmsnorm_probe.remote(), timeout=600)),
      flush=True)
rt.shutdown()
"""


def phase_job(device_name):
    import os
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.job import JobSubmissionClient

    wd = tempfile.mkdtemp(prefix="rt_job_wd_")
    with open(os.path.join(wd, "job_main.py"), "w") as f:
        f.write(JOB_MAIN)
    token = f"seed-{SEED}-{os.getpid()}"
    with open(os.path.join(wd, "job_data.json"), "w") as f:
        json.dump({"seed": SEED + 7, "shape": [8, 4096], "eps": EPS,
                   "token": token}, f)
    marker = "rt-job-marker"
    rt.init(num_cpus=4)
    try:
        client = JobSubmissionClient(worker_mod._global_node.gcs_address)
        try:
            t0 = time.perf_counter()
            sid = client.submit_job(
                entrypoint=f"{sys.executable} job_main.py",
                runtime_env={"working_dir": wd,
                             "env_vars": {"RT_JOB_MARKER": marker}})
            state = client.wait_until_finished(sid, timeout=600, poll=0.1)
            submit_to_end_s = time.perf_counter() - t0
            logs = client.get_job_logs(sid)
            info = client.get_job_info(sid)
        finally:
            client.close()
        _wait_gpu(rt, 1.0, "the GPU was not back at 1.0 after the job")
    finally:
        rt.shutdown()
    shutil.rmtree(wd, ignore_errors=True)
    left, procs = _stop_runtime()
    lines = [ln for ln in logs.splitlines() if ln.startswith("JOB_TASK ")]
    task = json.loads(lines[-1][len("JOB_TASK "):]) if lines else {}
    rec = {"phase": "job", "state": state,
           "submit_to_succeeded_s": submit_to_end_s,
           "entrypoint": info.get("entrypoint"), "task": task,
           "log_tail": logs[-2000:], "workers_after_shutdown": left,
           "runtime_procs_after_zygote_stop": procs}
    emit(rec)
    check(state == "SUCCEEDED", f"the job ended {state}: {logs[-2000:]}")
    check(bool(lines), "the job's logs hold no task line")
    check(task.get("launches") == 1,
          f"the job's task launched rmsnorm_fwd {task.get('launches')} times")
    check(task.get("marker") == marker and task.get("token") == token,
          f"the task did not see its env_vars or working_dir: {task}")
    check(task.get("ulp", 99) <= 1,
          f"rmsnorm_fwd in the job is {task.get('ulp')} bf16 ulp off")
    check(task.get("device") == device_name, f"the task ran on "
          f"{task.get('device')}")
    check(not left, f"workers outlived shutdown(): {left}")
    check(not rec["runtime_procs_after_zygote_stop"],
          f"runtime processes outlived the zygote's stop: "
          f"{rec['runtime_procs_after_zygote_stop']}")
    return task["launches"]


# -- tune: llama2-1b trials under ASHA, and a Tuner over TorchTrainer ---------
# Part (a) trains phase_train's model in Tune trials that hold the card
# (tune.with_resources), one at a time (max_concurrent_trials=1), under
# ASHA; part (b) sweeps a TorchTrainer whose gang holds the card.
# 1e-4 is phase_train's; 0.0 gives ASHA its early stop. Two trials keep
# the whole script inside its time limit.
TUNE_LRS = (1e-4, 0.0)
TUNE_MAX_T = 6
TUNE_B_LRS = (1e-4, 3e-4)
TUNE_B_LAYERS, TUNE_B_STEPS = 2, 3


def _tune_trial(config):
    """phase_train's step (llama2-1b, seed, AdamW hyperparameters but the
    learning rate, batches) in a Tune trial on the card; reports its loss,
    time and kernel launches every step."""
    entry_wall = time.time()
    import dataclasses
    import os
    import sys
    import threading

    import torch

    from ray_tpu_torch import tune
    from ray_tpu_torch._private.accelerators.gpu import granted_gpu_ids
    from ray_tpu_torch.models import configs, init_params, loss_fn

    cfg = dataclasses.replace(configs.llama2_1b, max_seq=TRAIN_SEQ,
                              remat=True, remat_policy="dots_nobatch")
    counters = _train_launch_counters()
    imports_s = time.time() - entry_wall
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED)  # the card, or it raises
    leaves = _flat_params(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=config["lr"], betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    batches = torch.randint(0, cfg.vocab_size,
                            (TRAINER_STEPS, TRAIN_BATCH, TRAIN_SEQ + 1),
                            generator=gen, device="cuda")
    torch.cuda.synchronize()
    info = {"pid": os.getpid(), "entry_wall": entry_wall,
            "imports_s": imports_s, "setup_s": time.perf_counter() - t0,
            "thread": threading.current_thread().name,
            "device_name": torch.cuda.get_device_name(),
            "device_count": torch.cuda.device_count(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "granted": granted_gpu_ids(),
            "jax_or_ray_tpu_modules": sorted(
                m for m in sys.modules if m in ("jax", "ray_tpu")
                or m.startswith(("jax.", "ray_tpu.")))}
    for i in range(TUNE_MAX_T):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, batches[i], cfg)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        metrics = {"loss": loss.item(), "step_s": time.perf_counter() - t0,
                   "wall": time.time(),
                   "launches": {n: fn.launches for n, fn in counters.items()},
                   "peak_memory": torch.cuda.max_memory_allocated()}
        if i == 0:
            metrics["info"] = info
        tune.report(metrics)


def _tune_searchers(rt):
    """A grid searcher that suggests the next trial only once the GPU is
    back at 1.0 (the finished trial's worker gone), and an ASHA that
    records its decisions; both record when, for the phase's figures."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.search import PAUSED

    class GPUGate(tune.Searcher):
        def __init__(self, space):
            self.inner = tune.BasicVariantGenerator(space)
            self.launched, self.ended, self.gpu_back = {}, {}, []
            self._last_end = None

        def suggest(self, trial_id):
            if rt.available_resources().get("GPU", 0.0) != 1.0:
                return PAUSED
            if self._last_end is not None:
                self.gpu_back.append(time.time() - self._last_end)
                self._last_end = None
            config = self.inner.suggest(trial_id)
            if config is not None:
                self.launched[trial_id] = time.time()
            return config

        def on_trial_complete(self, trial_id, result=None):
            self.ended[trial_id] = self._last_end = time.time()

    class RecordingASHA(tune.ASHAScheduler):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.decisions = {}

        def on_result(self, trial_id, result):
            d = super().on_result(trial_id, result)
            self.decisions.setdefault(trial_id, []).append(
                [result.get("training_iteration"), d])
            return d

    return GPUGate, RecordingASHA


def _tune_trainer_loop(config):
    """phase_train's step at TUNE_B_LAYERS layers in a TorchTrainer
    worker; every report carries all the steps so far."""
    loop_start = time.time()
    import dataclasses
    import os

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import configs, init_params, loss_fn
    from ray_tpu_torch.train.torch import get_device

    device = get_device()
    cfg = dataclasses.replace(configs.llama2_1b, n_layers=TUNE_B_LAYERS,
                              max_seq=TRAIN_SEQ, remat=True,
                              remat_policy="dots_nobatch")
    counters = _train_launch_counters()
    params = init_params(cfg, seed=SEED, device=device)
    leaves = _flat_params(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=config["lr"], betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    batches = torch.randint(0, cfg.vocab_size,
                            (TRAINER_STEPS, TRAIN_BATCH, TRAIN_SEQ + 1),
                            generator=gen, device=device)
    losses, launches, step_ms = [], [], []
    for i in range(TUNE_B_STEPS):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, batches[i], cfg)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({n: fn.launches for n, fn in counters.items()})
        train.report({"step": i + 1, "loss": losses[-1], "losses": losses,
                      "launches_all": launches, "step_ms_all": step_ms,
                      "loop_start_wall": loop_start, "pid": os.getpid(),
                      "device_name": torch.cuda.get_device_name(device),
                      "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})


def _tune_a(rt, train_rec, device_name, tmp) -> dict:
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig

    GPUGate, RecordingASHA = _tune_searchers(rt)
    gate = GPUGate({"lr": tune.grid_search(list(TUNE_LRS))})
    asha = RecordingASHA(metric="loss", mode="min", grace_period=2,
                         reduction_factor=2, max_t=TUNE_MAX_T)
    t0 = time.time()
    grid = tune.Tuner(
        tune.with_resources(_tune_trial, {"CPU": 1, "GPU": 1}),
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    search_alg=gate, scheduler=asha,
                                    max_concurrent_trials=1),
        run_config=RunConfig(name="tune_a", storage_path=tmp)).fit()
    fit_s = time.time() - t0
    _wait_gpu(rt, 1.0, "the GPU was not back at 1.0 after the sweep")
    predicted = train_rec["predicted_per_step"]
    ref = train_rec["warmup_losses"] + train_rec["losses"]
    trials = []
    for trial, res in zip(grid._trials, grid):
        hist = res.metrics_history
        info = hist[0]["info"] if hist else {}
        losses = [m["loss"] for m in hist]
        stop_at = next((t for t, d in asha.decisions.get(trial.trial_id, [])
                        if d == "STOP"), None)
        times = sorted(m["step_s"] for m in hist[1:])
        trials.append({
            "lr": trial.config["lr"], "state": trial.state,
            "error": str(res.error)[:2000] if res.error else None,
            "steps": len(hist), "asha_stop_at": stop_at,
            "asha_decisions": asha.decisions.get(trial.trial_id),
            "losses": losses,
            "setup_s": (hist[0]["wall"] - gate.launched[trial.trial_id]
                        if hist else None),
            "launch_to_function_s": (info["entry_wall"]
                                     - gate.launched[trial.trial_id]
                                     if info else None),
            "function_imports_s": info.get("imports_s"),
            "function_setup_s": info.get("setup_s"),
            "first_step_ms": hist[0]["step_s"] * 1e3 if hist else None,
            "step_ms_median": (times[len(times) // 2] * 1e3
                               if times else None),
            "step_ms_all": [m["step_s"] * 1e3 for m in hist],
            "launches_per_step": [m["launches"] for m in hist],
            "peak_memory": max((m["peak_memory"] for m in hist), default=0),
            "worker": {k: info.get(k) for k in (
                "pid", "thread", "device_name", "device_count", "visible",
                "granted", "jax_or_ray_tpu_modules")},
            "bit_equal_to_phase_train": (losses == ref[:len(losses)]
                                         if trial.config["lr"] == 1e-4
                                         else None)})
    launches = {n: sum(m["launches"][n] for r in grid
                       for m in r.metrics_history) for n in predicted}
    rec = {"model": "llama2-1b", "dtype": "bfloat16",
           "n_layers": train_rec["n_layers"], "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "remat_policy": train_rec["remat_policy"],
           "trial_resources": {"CPU": 1, "GPU": 1},
           "scheduler": {"name": "ASHA", "grace_period": 2,
                         "reduction_factor": 2, "max_t": TUNE_MAX_T},
           "fit_s": fit_s, "trials": trials,
           "gpu_back_s_between_trials": gate.gpu_back,
           "phase_train_step_ms_median": train_rec["step_ms_median"],
           "launches": launches, "predicted_per_step": predicted,
           "best_lr": next(t["lr"] for t, r in zip(trials, grid)
                           if r is grid.get_best_result())}
    for t in trials:
        check(t["error"] is None, f"trial lr={t['lr']} failed: {t['error']}")
        check(all(lp == predicted for lp in t["launches_per_step"]),
              f"trial lr={t['lr']}: launches per step "
              f"{t['launches_per_step']} != {predicted}")
        check(all(np.isfinite(t["losses"])), f"trial lr={t['lr']}: a loss "
              f"is not finite: {t['losses']}")
        w = t["worker"]
        check(w["device_name"] == device_name and w["device_count"] == 1
              and len(w["granted"]) == 1 and w["visible"] == w["granted"][0],
              f"trial lr={t['lr']} was not confined to the card granted: {w}")
        check(w["jax_or_ray_tpu_modules"] == [],
              f"trial lr={t['lr']} loaded {w['jax_or_ray_tpu_modules']}")
    first = next(t for t in trials if t["lr"] == 1e-4)
    check(first["steps"] == TUNE_MAX_T and first["bit_equal_to_phase_train"],
          f"the lr 1e-4 trial's losses {first['losses']} differ from "
          f"phase_train's {ref[:TUNE_MAX_T]}")
    check(any(t["asha_stop_at"] is not None and t["asha_stop_at"] < TUNE_MAX_T
              for t in trials), f"ASHA stopped no trial before max_t: "
          f"{[t['asha_decisions'] for t in trials]}")
    check(len(gate.gpu_back) == len(TUNE_LRS),
          f"the GPU came back {len(gate.gpu_back)} times after "
          f"{len(TUNE_LRS)} trials")
    return rec


def _tune_b(rt, train_rec, device_name, tmp) -> dict:
    import threading

    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    class TimedTrainer(TorchTrainer):
        """TorchTrainer whose result carries the seconds of its fit."""

        def fit(self):
            t0 = time.time()
            result = super().fit()
            result.metrics = dict(result.metrics, fit_s=time.time() - t0)
            return result

    trainer = TimedTrainer(
        _tune_trainer_loop,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(name="tune_b_inner", storage_path=tmp))
    tuner = tune.Tuner(
        trainer, param_space={"lr": tune.grid_search(list(TUNE_B_LRS))},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=1),
        run_config=RunConfig(name="tune_b", storage_path=tmp))
    from ray_tpu_torch._private import worker as worker_mod

    raylet = worker_mod._global_node.raylet
    out, held = {}, {}

    def fit():
        try:
            out["grid"] = tuner.fit()
        except BaseException as e:  # noqa: BLE001 — raised below
            out["error"] = e

    t0 = time.time()
    th = threading.Thread(target=fit, daemon=True, name="tune-b-fit")
    th.start()
    while th.is_alive():
        # What the raylet granted each actor, read while it lives: the
        # trial actors and the trainers' workers.
        for w in list(raylet.workers.values()):
            if w.actor_id is not None:
                held.setdefault(w.actor_id, {
                    "pid": w.proc.pid if w.proc is not None else None,
                    "resources": dict(w.actor_resources),
                    "gpu_ids": list(w.actor_gpu_ids)})
        th.join(0.2)
    fit_s = time.time() - t0
    if "error" in out:
        raise out["error"]
    grid = out["grid"]
    _wait_gpu(rt, 1.0, "the GPU was not back at 1.0 after the trainer sweep")
    L = TUNE_B_LAYERS
    predicted = _predicted_launches(L)
    trial_held = [held.get(getattr(t.actor._actor_id, "binary",
                                   lambda a=t.actor._actor_id: a)())
                  for t in grid._trials]
    gang_held = [next((h for h in held.values()
                       if h["pid"] == r.metrics.get("pid")
                       and h["resources"].get("GPU")), None) for r in grid]
    trials = [{"lr": t.config["lr"], "state": t.state,
               "error": str(r.error)[:2000] if r.error else None,
               "loss": r.metrics.get("loss"), "losses": r.metrics.get("losses"),
               "fit_s": r.metrics.get("fit_s"),
               "step_ms_all": r.metrics.get("step_ms_all"),
               "launches_per_step": r.metrics.get("launches_all"),
               "trial_actor_held": th_, "gang_worker_held": gh,
               "gang_worker_device": r.metrics.get("device_name"),
               "gang_worker_visible": r.metrics.get("visible")}
              for t, r, th_, gh in zip(grid._trials, grid, trial_held,
                                       gang_held)]
    for t in trials:
        check(t["error"] is None, f"trainer trial lr={t['lr']} failed: "
              f"{t['error']}")
    best = grid.get_best_result()
    launches = {n: sum(lp[n] for r in grid
                       for lp in r.metrics.get("launches_all", []))
                for n in predicted}
    rec = {"model": "llama2-1b", "dtype": "bfloat16", "n_layers": L,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TUNE_B_STEPS,
           "scaling": {"num_workers": 1, "use_gpu": True},
           "trial_resources": {"CPU": 1}, "fit_s": fit_s, "trials": trials,
           "best": {"lr": next(t["lr"] for t, r in zip(trials, grid)
                               if r is best),
                    "loss": best.metrics.get("loss")},
           "launches": launches, "predicted_per_step": predicted}
    for t in trials:
        check(t["launches_per_step"] == [predicted] * TUNE_B_STEPS,
              f"trainer trial lr={t['lr']}: launches {t['launches_per_step']}"
              f" != {predicted} a step")
        check(t["gang_worker_device"] == device_name,
              f"trainer trial lr={t['lr']} trained on "
              f"{t['gang_worker_device']}")
        check(t["trial_actor_held"] is not None
              and not t["trial_actor_held"]["resources"].get("GPU")
              and not t["trial_actor_held"]["gpu_ids"],
              f"trainer trial lr={t['lr']}: the trial actor was granted "
              f"{t['trial_actor_held']}")
        check(t["gang_worker_held"] is not None
              and t["gang_worker_held"]["gpu_ids"] == [t["gang_worker_visible"]],
              f"trainer trial lr={t['lr']}: its gang worker was not granted "
              f"the card it trained on: {t['gang_worker_held']}")
        check(all(np.isfinite(t["losses"])), f"a loss is not finite: {t}")
    return rec


def phase_tune(train_rec, device_name):
    import gc
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch as rt

    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="rt_tune_")
    rt.init(num_cpus=4)
    try:
        t0 = time.perf_counter()
        rec_a = _tune_a(rt, train_rec, device_name, tmp)
        rec_a["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec_b = _tune_b(rt, train_rec, device_name, tmp)
        rec_b["seconds"] = time.perf_counter() - t0
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    left, procs = _stop_runtime()
    rec = {"phase": "tune", "asha_gpu_trials": rec_a,
           "tuner_over_torch_trainer": rec_b,
           "workers_after_shutdown": left,
           "runtime_procs_after_zygote_stop": procs}
    emit(rec)
    check(not left, f"workers outlived shutdown(): {left}")
    check(not procs, f"runtime processes outlived the zygote's stop: {procs}")
    return rec_a["launches"], rec_b["launches"]


# -- dag: a compiled two-stage chain, the RMSNorm kernel on a GPU actor ------
DAG_EXECUTES = 200
DAG_SHAPE = (8, 4096)


class _DagNorm:
    """Stage 1, on the card: the RMSNorm forward kernel. Arrays cross the
    channels as numpy (a CUDA tensor would pickle with its device)."""

    def __init__(self, seed, d):
        import torch

        from ray_tpu_torch.ops.rmsnorm import rmsnorm_cuda

        gen = torch.Generator(device="cuda").manual_seed(seed)
        self.w = (torch.randn(d, generator=gen, device="cuda") * 0.1
                  + 1).to(torch.bfloat16)
        rmsnorm_cuda.launches = 0

    def norm(self, x):
        import torch

        from ray_tpu_torch.ops.rmsnorm import rmsnorm

        xt = torch.from_numpy(x).to("cuda").to(torch.bfloat16)
        return rmsnorm(xt, self.w, EPS).float().cpu().numpy()

    def launches(self):
        from ray_tpu_torch.ops.rmsnorm import rmsnorm_cuda

        return rmsnorm_cuda.launches

    def info(self):
        import os

        import torch

        return {"pid": os.getpid(), "device_name": torch.cuda.get_device_name(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


class _DagChecksum:
    """Stage 2, on the CPU: a checksum of the normalised rows."""

    def checksum(self, y):
        import zlib

        return {"y": y, "crc": zlib.crc32(y.tobytes())}


def phase_dag(device_name):
    import gc
    import os
    import zlib

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.ops.rmsnorm import _rmsnorm_plain

    gc.collect()
    torch.cuda.empty_cache()
    rows, d = DAG_SHAPE
    rng = np.random.default_rng(SEED + 11)
    xs = [(rng.standard_normal(DAG_SHAPE) * 3).astype(np.float32)
          for _ in range(DAG_EXECUTES)]
    rt.init(num_cpus=4)
    try:
        norm = rt.remote(num_gpus=1)(_DagNorm).remote(SEED + 12, d)
        csum = rt.remote(num_cpus=1)(_DagChecksum).remote()
        info = rt.get(norm.info.remote(), timeout=600)
        check(rt.get(norm.launches.remote(), timeout=60) == 0,
              "the GPU stage launched before the DAG ran")
        with InputNode() as inp:
            chain = csum.checksum.bind(norm.norm.bind(inp))
        compiled = chain.experimental_compile()
        names = sorted(c.name for c in compiled._channels)
        exec_ms, outs = [], []
        try:
            for x in xs:  # the main path: counted from 0 on the actor
                t0 = time.perf_counter()
                outs.append(compiled.execute(x, timeout=120))
                exec_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            compiled.teardown()
        launches = rt.get(norm.launches.remote(), timeout=60)
        segments_left = sorted(f for f in os.listdir("/dev/shm")
                               if f.startswith("rtchan_"))
        call_ms = []
        for x in xs:
            t0 = time.perf_counter()
            rt.get(csum.checksum.remote(norm.norm.remote(x)), timeout=120)
            call_ms.append((time.perf_counter() - t0) * 1e3)
        rt.kill(norm)
        rt.kill(csum)
        _wait_gpu(rt, 1.0, "the GPU was not back at 1.0 after the DAG")
        gpu_after = rt.available_resources().get("GPU", 0.0)
    finally:
        rt.shutdown()
    left, procs = _stop_runtime()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    w = (torch.randn(d, generator=gen, device="cuda") * 0.1
         + 1).to(torch.bfloat16)
    ulps, crc_ok, max_abs = [], True, 0.0
    for x, o in zip(xs, outs):
        want = _rmsnorm_plain(torch.from_numpy(x).cuda().to(torch.bfloat16),
                              w, EPS)
        got = torch.from_numpy(o["y"]).cuda()
        ulps.append(bf16_ulp_diff(got, want))
        max_abs = max(max_abs, float((got - want.float()).abs().max()))
        crc_ok &= zlib.crc32(o["y"].tobytes()) == o["crc"]
    rec = {"phase": "dag", "stages": ["GPU actor: rmsnorm_fwd (bf16)",
                                      "CPU actor: crc32 checksum"],
           "shape": list(DAG_SHAPE), "executes": DAG_EXECUTES,
           "gpu_stage": info, "channels": len(names),
           "execute_ms_p50": _pct(exec_ms, 0.5),
           "execute_ms_p99": _pct(exec_ms, 0.99),
           "actor_calls_ms_p50": _pct(call_ms, 0.5),
           "actor_calls_ms_p99": _pct(call_ms, 0.99),
           "timing_note": "host wall on the chip machine",
           "gpu_stage_launches": launches, "max_ulp": max(ulps),
           "max_abs_err": max_abs, "checksums_ok": crc_ok,
           "segments_left_after_teardown": segments_left,
           "gpu_available_after": gpu_after,
           "workers_after_shutdown": left,
           "runtime_procs_after_zygote_stop": procs}
    emit(rec)
    check(info["device_name"] == device_name,
          f"the GPU stage ran on {info['device_name']}")
    check(len(outs) == DAG_EXECUTES, f"{len(outs)} results")
    check(max(ulps) <= 1, f"a DAG result is {max(ulps)} bf16 ulp off")
    check(crc_ok, "a checksum does not match the rows it came with")
    check(launches == DAG_EXECUTES,
          f"the GPU stage launched {launches} times in {DAG_EXECUTES} "
          f"executes")
    check(not segments_left, f"channel segments left: {segments_left}")
    check(gpu_after == 1.0, f"GPU {gpu_after} after the DAG")
    check(not left, f"workers outlived shutdown(): {left}")
    check(not procs, f"runtime processes outlived the zygote's stop: {procs}")
    return launches


# -- cluster: a GPU node beside a CPU head, a 64 MiB pull across raylets -----
CLUSTER_SHAPE = (8192, 2048)


def _cluster_rmsnorm(seed, rows, d):
    """The RMSNorm forward on the node's card; returns the rows as float32
    (64 MiB, each a bf16 value) with a digest of their bytes."""
    import hashlib
    import os

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_cuda

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((rows, d), generator=gen, device="cuda") * 3).to(
        torch.bfloat16)
    w = (torch.randn(d, generator=gen, device="cuda") * 0.1 + 1).to(
        torch.bfloat16)
    rmsnorm_cuda.launches = 0
    y = rmsnorm(x, w, EPS)
    launches = rmsnorm_cuda.launches
    out = y.float().cpu().numpy()
    return {"out": out, "sha256": hashlib.sha256(out.tobytes()).hexdigest(),
            "launches": launches,
            "node_id": rt.get_runtime_context().get_node_id(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_name": torch.cuda.get_device_name()}


def phase_cluster(device_name):
    import gc
    import hashlib

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.ops.rmsnorm import _rmsnorm_plain

    gc.collect()
    torch.cuda.empty_cache()
    rows, d = CLUSTER_SHAPE
    seed = SEED + 21
    cluster = Cluster()
    try:
        head = cluster.add_node(num_cpus=2)
        gpu_node = cluster.add_node(num_cpus=1, num_gpus=1)
        cluster.connect()
        resources = rt.cluster_resources()
        ref = rt.remote(num_gpus=1)(_cluster_rmsnorm).remote(seed, rows, d)
        ready, _ = rt.wait([ref], timeout=600, fetch_local=False)
        check(ready, "the GPU task did not finish")
        t0 = time.perf_counter()
        got = rt.get(ref, timeout=600)
        pull_s = time.perf_counter() - t0
        cluster.remove_node(gpu_node)
        deadline = time.monotonic() + 30
        while ("GPU" in rt.cluster_resources()
               and time.monotonic() < deadline):
            time.sleep(0.1)
        after = rt.cluster_resources()
    finally:
        cluster.shutdown()
    left, procs = _stop_runtime()
    out = got["out"]
    digest = hashlib.sha256(out.tobytes()).hexdigest()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((rows, d), generator=gen, device="cuda") * 3).to(
        torch.bfloat16)
    w = (torch.randn(d, generator=gen, device="cuda") * 0.1 + 1).to(
        torch.bfloat16)
    want = _rmsnorm_plain(x, w, EPS)
    got_t = torch.from_numpy(out).cuda()
    ulp = bf16_ulp_diff(got_t, want)
    max_abs = float((got_t - want.float()).abs().max())
    rec = {"phase": "cluster",
           "nodes": {"head": {"num_cpus": 2, "node_id": head.node_id.hex()},
                     "gpu": {"num_cpus": 1, "num_gpus": 1,
                             "node_id": gpu_node.node_id.hex()}},
           "cluster_resources": resources, "shape": list(CLUSTER_SHAPE),
           "task_node_id": got["node_id"], "task_visible": got["visible"],
           "task_device": got["device_name"], "launches": got["launches"],
           "bytes": out.nbytes, "pull_s": pull_s,
           "pull_gb_s": out.nbytes / pull_s / 1e9,
           "digest_equal": digest == got["sha256"], "max_ulp": ulp,
           "max_abs_err": max_abs, "cluster_resources_after_remove": after,
           "workers_after_shutdown": left,
           "runtime_procs_after_zygote_stop": procs}
    emit(rec)
    check(resources.get("GPU") == 1.0, f"cluster GPUs: {resources}")
    check(got["node_id"] == gpu_node.node_id.hex(),
          f"the GPU task ran on node {got['node_id']}, not the GPU node")
    check(got["device_name"] == device_name,
          f"the GPU task ran on {got['device_name']}")
    check(out.nbytes >= 64 * 10**6, f"the result is {out.nbytes} bytes")
    check(digest == got["sha256"], "the pulled bytes differ from the sent")
    check(ulp <= 1, f"the pulled rows are {ulp} bf16 ulp off the plain "
          f"version")
    check(got["launches"] == 1, f"the task launched {got['launches']} times")
    check("GPU" not in after, f"the GPU stayed after remove_node: {after}")
    check(not left, f"workers outlived shutdown(): {left}")
    check(not procs, f"runtime processes outlived the zygote's stop: {procs}")
    return got["launches"]


# -- cli: the operator's flow on a node started by `rt start` ----------------
# The training user's tools at full width: `python -m ray_tpu_torch start`
# brings up a GPU node, a driver joins it and a num_gpus=1 actor trains
# phase_train's model, while the CLI (each command a fresh interpreter)
# reads the node; then a job, a Queue, a Pool, a ParallelIterator, 4 x 256
# MiB of a GPU task's results spilled out of a 512 MiB store, `rt stop`.
CLI_STEPS = 3
CLI_STORE_BYTES = 512 * 2**20
CLI_SPILL_ROWS, CLI_SPILL_D, CLI_SPILLS = 32768, 4096, 3  # 256 MiB bf16 each
CLI_QUEUE_ITEMS = 50
# params and AdamW state of llama2-1b in bf16 (the trainer phase's checkpoint)
LLAMA2_1B_STATE_BYTES = 5_643_850_781


def _cli(env, *args, timeout=180):
    """One `python -m ray_tpu_torch ...` in a fresh interpreter: its
    output and wall seconds; a failing command fails the phase."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"rt {' '.join(args)} exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout, wall


def _probe_packages() -> dict:
    """Whether this machine has pyarrow (URI spilling, ROADMAP A6's data
    slice) and joblib (util.joblib), each probed in a fresh interpreter."""
    out = {}
    for mod in ("pyarrow", "joblib"):
        proc = subprocess.run(
            [sys.executable, "-c",
             f"import {mod}; print({mod}.__version__)"],
            capture_output=True, text=True, timeout=120)
        out[mod] = proc.stdout.strip() if proc.returncode == 0 else "absent"
    return out


def _spill_rmsnorm(seed, rows, d):
    """A num_gpus=1 task: the RMSNorm forward at rows x d bf16 on the
    card; its 256 MiB result (as int16 bits), their digest and the
    kernel's launches."""
    import hashlib

    import torch
    from ray_tpu_torch.ops.rmsnorm import rmsnorm_cuda

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((rows, d), generator=gen, device="cuda") * 3).to(
        torch.bfloat16)
    w = (torch.randn(d, generator=gen, device="cuda") * 0.1 + 1).to(
        torch.bfloat16)
    rmsnorm_cuda.launches = 0
    out = rmsnorm_cuda(x, w, EPS).view(torch.int16).cpu().numpy()
    return out, {"sha256": hashlib.sha256(out.tobytes()).hexdigest(),
                 "launches": rmsnorm_cuda.launches}


def _queue_inputs(i):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 100 + i)
    x = (torch.randn((8, 4096), generator=gen, device="cuda") * 3).to(
        torch.bfloat16)
    w = (torch.randn(4096, generator=gen, device="cuda") * 0.1 + 1).to(
        torch.bfloat16)
    return x, w


def phase_cli(train_rec, device_name):
    import gc
    import hashlib
    import os
    import re
    import shutil
    import tempfile

    import torch

    packages = _probe_packages()
    emit({"phase": "cli", "probe": packages})
    if packages["pyarrow"] == "absent":
        print(json.dumps({"pyarrow": "absent"}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="rt_cli_")
    spill_dir = os.path.join(tmp, "spill")
    env = {k: v for k, v in os.environ.items() if k != "RT_NUM_GPUS"}
    env["TMPDIR"] = tmp
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [os.path.dirname(os.path.abspath(__file__)),
                    env.get("PYTHONPATH", "")] if p)
    env["RT_SPILL_DIR"] = (("file://" + spill_dir)
                           if packages["pyarrow"] != "absent" else spill_dir)
    os.environ["TMPDIR"] = tmp  # the driver's own node logs there too
    walls = {}
    t0 = time.perf_counter()
    started, walls["start"] = _cli(
        env, "start", "--head", "--num-cpus", "4",
        "--object-store-memory", str(CLI_STORE_BYTES), "--no-dashboard")
    with open(os.path.join(tmp, "ray_tpu_torch", "session.json")) as f:
        session = json.load(f)
    addr = session["gcs_address"]
    from ray_tpu_torch.util.state import list_nodes

    while not any(n["resources_total"].get("GPU") for n in
                  list_nodes(address=addr)):
        check(time.perf_counter() - t0 < 120, "rt start's node shows no GPU")
        time.sleep(0.05)
    start_to_gpu_s = time.perf_counter() - t0
    status0, walls["status"] = _cli(env, "status")
    check("  1/1 GPU" in status0, f"rt status after rt start: {status0}")

    import ray_tpu_torch as rt
    from ray_tpu_torch.util import tracing

    # The driver's node: no card (rt start's node holds it) and a store
    # that takes a 256 MiB result.
    rt.init(address=addr, num_gpus=0, object_store_memory=2 * 2**30)
    try:
        @rt.remote(num_gpus=1)
        class CliTrainer:
            """phase_train's model, AdamW and batches in an actor on the
            card; each step reports its loss, time and launches."""

            def __init__(self):
                import dataclasses

                from ray_tpu_torch.models import configs, init_params

                self.cfg = dataclasses.replace(
                    configs.llama2_1b, max_seq=TRAIN_SEQ, remat=True,
                    remat_policy="dots_nobatch")
                self.params = init_params(self.cfg, seed=SEED)
                self.leaves = _flat_params(self.params)
                for t in self.leaves:
                    t.requires_grad_(True)
                self.opt = torch.optim.AdamW(
                    self.leaves, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                    weight_decay=1e-4)
                gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
                self.batches = torch.randint(
                    0, self.cfg.vocab_size,
                    (TRAINER_STEPS, TRAIN_BATCH, TRAIN_SEQ + 1),
                    generator=gen, device="cuda")

            def step(self, i):
                from ray_tpu_torch.models import loss_fn
                from ray_tpu_torch.util import tracing

                counters = _train_launch_counters()
                for fn in counters.values():
                    fn.launches = 0
                tracing.enable()  # this worker's spans, not just the task's
                t0 = time.perf_counter()
                with tracing.span("cli.train_step"):
                    self.opt.zero_grad(set_to_none=True)
                    loss = loss_fn(self.params, self.batches[i], self.cfg)
                    loss.backward()
                    self.opt.step()
                    torch.cuda.synchronize()
                return {"loss": loss.item(),
                        "step_s": time.perf_counter() - t0,
                        "launches": {n: fn.launches
                                     for n, fn in counters.items()}}

            def sample(self):
                import os

                from ray_tpu_torch.util import memory, metrics

                sample = memory.sample_once()
                allocated = torch.cuda.memory_allocated()
                metrics._flush_once()
                return {"sample": sample, "allocated": allocated,
                        "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                        "pid": os.getpid(),
                        "device_name": torch.cuda.get_device_name()}

            def hold(self, seconds, release):
                """In a call until `release` exists (at most `seconds`),
                so that `rt stack` finds the actor in one."""
                deadline = time.monotonic() + seconds
                while (not os.path.exists(release)
                       and time.monotonic() < deadline):
                    time.sleep(0.05)
                return True

        tracing.enable()
        trainer = CliTrainer.remote()
        steps = []
        for i in range(CLI_STEPS):
            if i == 1:
                with tracing.span("cli.driver_step"):
                    trace_id = tracing.current()["trace_id"]
                    steps.append(rt.get(trainer.step.remote(i), timeout=900))
            else:
                steps.append(rt.get(trainer.step.remote(i), timeout=900))
        tracing.disable()
        held = rt.get(trainer.sample.remote(), timeout=120)

        # The CLI on the live node, while the actor holds its state.
        out = {}
        for name, args in (
                ("status", ["status"]), ("list_nodes", ["list", "nodes"]),
                ("list_actors", ["list", "actors"]),
                ("list_tasks", ["list", "tasks"]),
                ("list_workers", ["list", "workers"]),
                ("list_objects", ["list", "objects"]),
                ("summary_tasks", ["summary", "tasks"]),
                ("timeline", ["timeline", "-o",
                              os.path.join(tmp, "timeline.json")]),
                ("trace", ["trace", trace_id]), ("logs", ["logs"]),
                ("memory_devices", ["memory", "--devices"]),
                ("top", ["top"])):
            out[name], walls[name] = _cli(env, *args)
        release = os.path.join(tmp, "hold_release")
        holding = trainer.hold.remote(30.0, release)
        time.sleep(1.0)
        out["stack"], walls["stack"] = _cli(env, "stack")
        from ray_tpu_torch.util.memory import memory_summary

        summary = memory_summary(address=addr)
        open(release, "w").close()
        check(rt.get(holding, timeout=120), "the hold call failed")
        with open(os.path.join(tmp, "timeline.json")) as f:
            timeline = json.load(f)

        rt.kill(trainer)
        t_kill = time.perf_counter()
        readings = []
        while time.perf_counter() - t_kill < 120:
            readings.append(rt.available_resources().get("GPU", 0.0))
            up = [i for i, r in enumerate(readings) if r >= 1.0]
            if up and (len(readings) - up[0]) * 0.05 >= GPU_SETTLE_S:
                break
            time.sleep(0.05)
        up = [i for i, r in enumerate(readings) if r >= 1.0]
        gpu_back_s = up[0] * 0.05 if up else None
        gpu_fell = bool(up) and min(readings[up[0]:]) < 1.0

        # rt job submit: phase_job's working_dir job on this node.
        wd = os.path.join(tmp, "job_wd")
        os.makedirs(wd)
        with open(os.path.join(wd, "job_main.py"), "w") as f:
            f.write(JOB_MAIN)
        token = f"cli-seed-{SEED}-{os.getpid()}"
        with open(os.path.join(wd, "job_data.json"), "w") as f:
            json.dump({"seed": SEED + 7, "shape": [8, 4096], "eps": EPS,
                       "token": token}, f)
        marker = "rt-cli-job-marker"
        t0 = time.perf_counter()
        said, walls["job_submit"] = _cli(
            env, "job", "submit", "--working-dir", wd, "--runtime-env-json",
            json.dumps({"env_vars": {"RT_JOB_MARKER": marker}}), "--",
            sys.executable, "job_main.py")
        sid = said.split()[-1]
        job_state = None
        while time.perf_counter() - t0 < 600:
            job_state, walls["job_status"] = _cli(env, "job", "status", sid)
            job_state = job_state.strip()
            if job_state in ("SUCCEEDED", "FAILED", "STOPPED"):
                break
            time.sleep(0.1)
        job_s = time.perf_counter() - t0
        job_logs, walls["job_logs"] = _cli(env, "job", "logs", sid)
        lines = [ln for ln in job_logs.splitlines()
                 if ln.startswith("JOB_TASK ")]
        job_task = json.loads(lines[-1][len("JOB_TASK "):]) if lines else {}

        # util.queue: 50 RMSNorm outputs from a GPU actor to the driver.
        from ray_tpu_torch.ops.rmsnorm import _rmsnorm_plain
        from ray_tpu_torch.util.queue import Queue

        q = Queue(maxsize=8)

        @rt.remote(num_gpus=1)
        class Producer:
            def run(self, q, n):
                import hashlib

                from ray_tpu_torch.ops.rmsnorm import rmsnorm_cuda

                rmsnorm_cuda.launches = 0
                digests = []
                for i in range(n):
                    x, w = _queue_inputs(i)
                    got = rmsnorm_cuda(x, w, EPS).view(torch.int16)
                    arr = got.cpu().numpy()
                    digests.append(hashlib.sha256(arr.tobytes()).hexdigest())
                    q.put(arr)
                return {"digests": digests,
                        "launches": rmsnorm_cuda.launches}

        producer = Producer.remote()
        produced = producer.run.remote(q, CLI_QUEUE_ITEMS)
        items = [q.get(timeout=300) for _ in range(CLI_QUEUE_ITEMS)]
        prod = rt.get(produced, timeout=300)
        rt.kill(producer)
        q.shutdown()
        queue_ulp, queue_digests_equal = 0, True
        for i, arr in enumerate(items):
            x, w = _queue_inputs(i)
            want = _rmsnorm_plain(x, w, EPS)
            got = torch.from_numpy(arr).cuda().view(torch.bfloat16)
            queue_ulp = max(queue_ulp, bf16_ulp_diff(got, want))
            queue_digests_equal &= (hashlib.sha256(arr.tobytes()).hexdigest()
                                    == prod["digests"][i])

        # util.multiprocessing.Pool and util.iter over CPU tasks.
        from ray_tpu_torch.util import iter as rt_iter
        from ray_tpu_torch.util.multiprocessing import Pool

        with Pool(processes=2) as pool:
            pool_out = pool.map(abs, range(-5, 5))
        it = rt_iter.from_range(12, num_shards=2)
        iter_out = sorted(it.for_each(lambda v: v * 3).gather_sync())
        for shard in it._shards:
            rt.kill(shard)

        # 3 x 256 MiB of a GPU task's results out of a 512 MiB store, which
        # holds one of them: two spill.
        spill_task = rt.remote(num_gpus=1, num_returns=2)(_spill_rmsnorm)
        t0 = time.perf_counter()
        pairs = [spill_task.remote(SEED + 200 + i, CLI_SPILL_ROWS,
                                   CLI_SPILL_D) for i in range(CLI_SPILLS)]
        infos = rt.get([p[1] for p in pairs], timeout=600)
        produce_s = time.perf_counter() - t0
        spilled = []
        for root, _, files in os.walk(spill_dir):
            spilled += [os.path.getsize(os.path.join(root, f))
                        for f in files]
        t0 = time.perf_counter()
        restored = [hashlib.sha256(rt.get(p[0], timeout=600).tobytes())
                    .hexdigest() for p in pairs]
        restore_s = time.perf_counter() - t0
        spill_bytes = CLI_SPILLS * CLI_SPILL_ROWS * CLI_SPILL_D * 2
        del pairs
    finally:
        rt.shutdown()
        os.environ.pop("TMPDIR", None)
    stopped, walls["stop"] = _cli(env, "stop")
    deadline = time.monotonic() + 30
    while _runtime_procs() and time.monotonic() < deadline:
        time.sleep(0.2)
    left_after_stop = _runtime_procs()
    left, procs = _stop_runtime()
    shutil.rmtree(tmp, ignore_errors=True)

    predicted = train_rec["predicted_per_step"]
    ref = (train_rec["warmup_losses"] + train_rec["losses"])[:CLI_STEPS]
    losses = [s["loss"] for s in steps]
    step_ms = sorted(s["step_s"] * 1e3 for s in steps)[CLI_STEPS // 2]
    (entry,) = held["sample"]
    mem_line = re.search(r"node \S+ (cuda:\S+): +([\d.]+) MB live",
                         out["memory_devices"])
    actors = json.loads(out["list_actors"])
    launches = {n: sum(s["launches"][n] for s in steps) for n in predicted}
    launches["rmsnorm_fwd"] += (job_task.get("launches", 0)
                                + prod["launches"]
                                + sum(i["launches"] for i in infos))
    rec = {"phase": "cli", "probe": packages, "gcs_address": addr,
           "start_output": started.splitlines(),
           "start_to_gpu_visible_s": start_to_gpu_s,
           "cli_wall_s": walls,
           "losses": losses, "train_losses": ref,
           "step_ms_all": [s["step_s"] * 1e3 for s in steps],
           "step_ms_median": step_ms,
           "train_step_ms_median": train_rec["step_ms_median"],
           "launches_per_step": [s["launches"] for s in steps],
           "sampled": entry, "actor_memory_allocated": held["allocated"],
           "cli_memory_line": mem_line.group(0) if mem_line else None,
           "summary_devices": summary["devices"],
           "gpu_back_after_kill_s": gpu_back_s,
           "gpu_readings_after_kill": readings,
           "job": {"state": job_state, "submit_to_succeeded_s": job_s,
                   "task": job_task},
           "queue": {"items": len(items), "max_ulp_vs_plain": queue_ulp,
                     "bit_equal_to_the_actors": queue_digests_equal,
                     "launches": prod["launches"]},
           "pool": pool_out, "iter": iter_out,
           "spill": {"backend": "UriStorage (file://)"
                     if packages["pyarrow"] != "absent" else "local files",
                     "results_bytes": spill_bytes,
                     "spilled_files": len(spilled),
                     "spilled_bytes": sum(spilled),
                     "produce_s": produce_s,
                     "produce_gb_s": spill_bytes / produce_s / 1e9,
                     "restore_s": restore_s,
                     "restore_gb_s": spill_bytes / restore_s / 1e9},
           "launches": launches,
           "processes_after_rt_stop": left_after_stop,
           "workers_after_shutdown": left,
           "runtime_procs_after_zygote_stop": procs}
    emit(rec)
    print(json.dumps({"cli_walls_s": walls}), flush=True)
    print(json.dumps({"cli_card_bytes": {"sampled": entry["live_bytes"],
                                         "actor_own": held["allocated"]}}),
          flush=True)
    check(losses == ref, f"the actor's losses {losses} != train's {ref}")
    bad = [s["launches"] for s in steps
           if s["launches"] != {n: int(c) for n, c in predicted.items()}]
    check(not bad, f"launches per step {bad} != predicted {predicted}")
    check(held["device_name"] == device_name,
          f"the actor ran on {held['device_name']}")
    check(entry["device"] == f"cuda:{held['visible']}",
          f"the sample names {entry['device']}, the actor holds card "
          f"{held['visible']}")
    check(entry["live_bytes"] == held["allocated"]
          > LLAMA2_1B_STATE_BYTES,
          f"sampled {entry['live_bytes']} B, the actor holds "
          f"{held['allocated']} B")
    check([d["live_bytes"] for d in summary["devices"]
           if d["device"] == entry["device"]] == [held["allocated"]],
          f"memory_summary: {summary['devices']}")
    check(mem_line is not None and mem_line.group(1) == entry["device"]
          and float(mem_line.group(2)) == round(held["allocated"] / 1e6, 1),
          f"rt memory --devices: {out['memory_devices']}")
    check([a["state"] for a in actors if a["class_name"] == "CliTrainer"]
          == ["ALIVE"], f"rt list actors: {actors}")
    check("  0/1 GPU" in out["status"], f"the actor did not hold the card: "
          f"{out['status']}")
    check(f"== actor pid={held['pid']}" in out["stack"]
          and "in hold" in out["stack"],
          f"rt stack shows no hold in the actor: {out['stack'][-3000:]}")
    check(f"trace {trace_id}: 3 spans" in out["trace"]
          and "cli.train_step" in out["trace"]
          and "cli.driver_step" in out["trace"],
          f"rt trace: {out['trace']}")
    check(sum(1 for e in timeline if e["name"] == "step") >= CLI_STEPS,
          "the timeline lacks the steps' events")
    check("hbm " in out["top"], f"rt top shows no card memory: {out['top']}")
    check(gpu_back_s is not None and not gpu_fell,
          f"the GPU after the kill: {readings}")
    check(job_state == "SUCCEEDED", f"the job ended {job_state}: "
          f"{job_logs[-2000:]}")
    check(job_task.get("launches") == 1 and job_task.get("ulp", 99) <= 1
          and job_task.get("marker") == marker
          and job_task.get("token") == token
          and job_task.get("device") == device_name,
          f"the job's task: {job_task}")
    check(len(items) == CLI_QUEUE_ITEMS and queue_digests_equal
          and queue_ulp <= 1 and prod["launches"] == CLI_QUEUE_ITEMS,
          f"the queue: {rec['queue']}")
    check(pool_out == [abs(v) for v in range(-5, 5)], f"Pool: {pool_out}")
    check(iter_out == [3 * v for v in range(12)], f"iter: {iter_out}")
    check(restored == [i["sha256"] for i in infos],
          "a restored result differs from what its task returned")
    check(len(spilled) >= 2, f"{len(spilled)} results spilled out of "
          f"the {CLI_STORE_BYTES} B store")
    check(all(i["launches"] == 1 for i in infos), f"spill tasks: {infos}")
    check(not left_after_stop, f"processes after rt stop: {left_after_stop}")
    check(not left and not procs, f"left after the phase: {left} {procs}")
    return launches


# -- data: the Data library feeding the card ---------------------------------
# (a) data_train: phase_train's first 12 batches as 96 rows of 1025 tokens,
# written to 4 parquet files, read back, through one map_batches stage and
# TorchTrainer(datasets=) onto the worker's card; (b) data_infer: batch
# scoring of 512 x 1024 tokens on a pool of one GPU actor; (c) data_feed:
# 7,000 ImageNet-shaped images (1.05 GB) through the default 256 MiB store
# onto the driver's card.
DATA_TRAIN_STEPS = TRAIN_WARMUP + TRAIN_STEPS   # phase_train's 12 batches
DATA_TRAIN_FILES = 4
DATA_INFER_ROWS, DATA_INFER_SEQ, DATA_INFER_BLOCKS = 512, 1024, 64
# A block's NLLs from the pool against the driver's own forward of the
# same rows on the same card.
DATA_INFER_RTOL = 1e-3
DATA_FEED_ROWS, DATA_FEED_BLOCKS, DATA_FEED_BATCH = 7000, 28, 256
IMAGE_SHAPE = (224, 224, 3)


def _train_cfg():
    from ray_tpu_torch.models import configs

    return dataclasses.replace(configs.llama2_1b, max_seq=TRAIN_SEQ,
                               remat=True, remat_policy="dots_nobatch")


def _token_windows(batch):
    """The map_batches stage after read_parquet: the list column of token
    rows becomes one fixed-shape tensor column."""
    return {"tokens": np.stack(list(batch["tokens"])).astype(np.int64),
            "row": batch["row"]}


def _data_train_loop(config):
    """phase_train's step in a TorchTrainer worker, each batch pulled from
    the dataset shard through iter_torch_batches onto the worker's card
    inside the step (so a wait for it is the step's data phase)."""
    import os
    import sys

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch._private.accelerators.gpu import granted_gpu_ids
    from ray_tpu_torch.models import init_params, loss_fn
    from ray_tpu_torch.train.torch import get_device

    device = get_device()
    cfg = _train_cfg()
    counters = _train_launch_counters()
    info = {"device": str(device),
            "device_name": torch.cuda.get_device_name(device),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "granted": granted_gpu_ids(),
            "jax_or_ray_tpu_modules": sorted(
                m for m in sys.modules if m in ("jax", "ray_tpu")
                or m.startswith(("jax.", "ray_tpu.")))}
    params = init_params(cfg, seed=SEED, device=device)
    leaves = _flat_params(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    n_params = sum(t.numel() for t in leaves)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    prof = train.StepProfiler(flops_per_step=6.0 * n_params * tokens)
    feed = train.get_dataset_shard("train").iter_torch_batches(
        batch_size=TRAIN_BATCH, prefetch_batches=2)
    prof.attach_feed(feed)
    for i in range(DATA_TRAIN_STEPS):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with prof.step(tokens=tokens) as s:
            batch = next(feed)
            with prof.phase("compute"):
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(params, batch["tokens"], cfg)
                loss.backward()
                opt.step()
            s.fence(loss)
        step_s = time.perf_counter() - t0
        rec = prof.records()[-1]
        metrics = {"step": i + 1, "loss": loss.item(), "step_s": step_s,
                   "launches": {n: fn.launches
                                for n, fn in counters.items()},
                   "rows": batch["row"].tolist(),
                   "batch": [str(batch["tokens"].device),
                             str(batch["tokens"].dtype),
                             list(batch["tokens"].shape)],
                   "wall_s": rec["wall_s"], "data_s": rec["data_s"],
                   "feed_wait_s": rec.get("feed_wait_s")}
        if i == 0:
            metrics["info"] = info
        train.report(metrics)
    leftover = next(feed, None)
    train.report({"final": True, "leftover": leftover is not None,
                  "feed": feed.stats.snapshot()})


def _bare_losses(tokens, order) -> list:
    """phase_train's step in this process on the batches `order` names
    (row ids per step), from the same weights and AdamW."""
    import torch

    from ray_tpu_torch.models import init_params, loss_fn

    cfg = _train_cfg()
    params = init_params(cfg, seed=SEED, device="cuda")
    leaves = _flat_params(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    losses = []
    for rows in order:
        batch = torch.from_numpy(tokens[rows]).cuda()
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch, cfg)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    del params, leaves, opt
    torch.cuda.empty_cache()
    return losses


def _task_states(rt, names) -> dict:
    """name -> {state: count} for the named tasks in list_tasks."""
    from ray_tpu_torch.util import state

    out = {n: {} for n in names}
    for t in state.list_tasks(limit=100_000):
        n = t["name"].rsplit(".", 1)[-1]
        if n in out:
            out[n][t["state"]] = out[n].get(t["state"], 0) + 1
    return out


def _data_train(rt, rd, train_rec, tmp) -> dict:
    import os

    import pyarrow.parquet as pq
    import torch

    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    cfg = _train_cfg()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    batches = torch.randint(0, cfg.vocab_size,
                            (TRAIN_WARMUP + TRAIN_STEPS + 1, TRAIN_BATCH,
                             TRAIN_SEQ + 1), generator=gen, device="cuda")
    tokens = batches[:DATA_TRAIN_STEPS].reshape(
        -1, TRAIN_SEQ + 1).cpu().numpy()
    del batches
    n_rows = len(tokens)
    t0 = time.perf_counter()
    out_dir = os.path.join(tmp, "tokens")
    files = rd.from_numpy({"tokens": tokens, "row": np.arange(n_rows)},
                          parallelism=DATA_TRAIN_FILES).write_parquet(out_dir)
    write_s = time.perf_counter() - t0
    file_rows = sorted(pq.read_metadata(f).num_rows for f in files)
    ds = rd.read_parquet(out_dir).map_batches(_token_windows)
    trainer = TorchTrainer(
        _data_train_loop,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(name="data_train", storage_path=tmp),
        datasets={"train": ds})
    t0 = time.time()
    result = trainer.fit()
    fit_s = time.time() - t0
    check(result.error is None, f"the fit failed: {result.error}")
    _wait_gpu(rt, 1.0, "the GPU was not back at 1.0 after the data fit")
    hist = [m for m in result.metrics_history if "step" in m]
    final = next(m for m in result.metrics_history if m.get("final"))
    order = [m["rows"] for m in hist]
    flat = sum(order, [])
    in_source_order = flat == list(range(n_rows))
    if in_source_order:
        bare = train_rec["warmup_losses"] + train_rec["losses"]
        bare_from = "phase_train"
    else:
        bare = _bare_losses(tokens, order)
        bare_from = "a bare loop in the driver, in the order received"
    losses = [m["loss"] for m in hist]
    # Tasks of the pipeline: the 4 reads of from_numpy and the 4 of
    # read_parquet, the 4 writes and the 4 map_batches tasks.
    names = ("_run_read_task", "_run_write_task", "_apply_fused")
    want_tasks = {"_run_read_task": {"FINISHED": 2 * DATA_TRAIN_FILES},
                  "_run_write_task": {"FINISHED": DATA_TRAIN_FILES},
                  "_apply_fused": {"FINISHED": DATA_TRAIN_FILES}}
    deadline = time.monotonic() + 30
    while True:
        tasks = _task_states(rt, names)
        if tasks == want_tasks or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    predicted = train_rec["predicted_per_step"]
    timed = hist[TRAIN_WARMUP:]
    step_ms = sorted(m["step_s"] for m in timed)[len(timed) // 2] * 1e3
    wall = sum(m["wall_s"] for m in timed)
    feed = final["feed"]
    rec = {"path": "data_train", "model": "llama2-1b", "dtype": "bfloat16",
           "n_layers": cfg.n_layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "rows": n_rows, "files": len(files), "file_rows": file_rows,
           "write_parquet_s": write_s, "fit_s": fit_s,
           "rows_in_arrival_order": order,
           "in_source_order": in_source_order,
           "losses": losses, "bare_losses": bare, "bare_from": bare_from,
           "bit_equal": losses == bare,
           "step_ms_median": step_ms,
           "phase_train_step_ms_median": train_rec["step_ms_median"],
           "step_ms_all": [m["step_s"] * 1e3 for m in hist],
           "feed": feed, "leftover_batch": final["leftover"],
           "flight_recorder_data_share": (
               sum(m["data_s"] for m in timed) / wall if wall else None),
           "flight_recorder_data_s": [m["data_s"] for m in hist],
           "batch_on_card": hist[0]["batch"],
           "worker": hist[0]["info"], "tasks": tasks,
           "launches": {n: sum(m["launches"][n] for m in hist)
                        for n in predicted}}
    emit({"phase": "data", **rec})
    print(f"data_train: {'bit-equal' if rec['bit_equal'] else 'DIFFERENT'}"
          f" losses against {bare_from}", flush=True)
    check(file_rows == [n_rows // DATA_TRAIN_FILES] * DATA_TRAIN_FILES,
          f"parquet files of {file_rows} rows")
    check(sorted(flat) == list(range(n_rows)),
          f"the rows did not arrive once each: {order}")
    check(rec["bit_equal"], f"the losses {losses} differ from {bare_from}'s"
          f" {bare}")
    check(all(np.isfinite(losses)), f"a loss is not finite: {losses}")
    bad = [(m["step"], m["launches"]) for m in hist
           if m["launches"] != predicted]
    check(not bad, f"launches per step differ from {predicted}: {bad}")
    check(hist[0]["batch"][:2] == ["cuda:0", "torch.int64"],
          f"the batch was not on the card: {hist[0]['batch']}")
    check(not final["leftover"] and feed["batches"] == DATA_TRAIN_STEPS,
          f"the feed: {feed}")
    check(tasks == want_tasks, f"list_tasks shows {tasks}, not {want_tasks}")
    info = hist[0]["info"]
    check(len(info["granted"]) == 1 and info["visible"] == info["granted"][0],
          f"the worker was not confined to its card: {info}")
    check(info["jax_or_ray_tpu_modules"] == [],
          f"the worker loaded {info['jax_or_ray_tpu_modules']}")
    return rec


class _Scorer:
    """map_batches' pool class: llama2-1b (bf16, full depth, init_params
    seed SEED) on the card this actor was granted; each block's rows get
    their mean next-token NLL in f32, and the kernel launches of the
    forward that scored them."""

    def __init__(self):
        import os

        import torch

        from ray_tpu_torch._private.accelerators.gpu import granted_gpu_ids
        from ray_tpu_torch.models import configs, init_params

        t0 = time.perf_counter()
        self.cfg = dataclasses.replace(configs.llama2_1b,
                                       max_seq=DATA_INFER_SEQ)
        self.params = init_params(self.cfg, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        self.init_s = time.perf_counter() - t0
        self.visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        self.granted = ",".join(granted_gpu_ids())
        self.device = torch.cuda.get_device_name(0)
        self.counters = _train_launch_counters()

    def __call__(self, batch):
        import torch

        t0 = time.time()
        for fn in self.counters.values():
            fn.launches = 0
        tok = torch.from_numpy(np.array(batch["tokens"])).cuda().long()
        nll = _score(self.params, tok, self.cfg).cpu().numpy()
        n = len(nll)
        return {"row": batch["row"], "nll": nll,
                "rms_launches": np.full(n, self.counters["rmsnorm_fwd"]
                                        .launches),
                "flash_launches": np.full(n, self.counters["flash_fwd"]
                                          .launches),
                "call_start": np.full(n, t0),
                "call_s": np.full(n, time.time() - t0),
                "init_s": np.full(n, self.init_s),
                "visible": [self.visible] * n,
                "granted": [self.granted] * n,
                "device": [self.device] * n}


def _score(params, tok, cfg):
    """Mean next-token NLL per row, in f32."""
    import torch

    from ray_tpu_torch.models import forward
    from ray_tpu_torch.ops.cross_entropy import softmax_cross_entropy

    with torch.no_grad():
        logits, _ = forward(params, tok, cfg)
        return softmax_cross_entropy(logits[:, :-1], tok[:, 1:]).mean(dim=1)


def _data_infer(rt, rd, device_name) -> dict:
    import dataclasses as dc

    import torch

    from ray_tpu_torch.models import configs, init_params

    rng = np.random.default_rng(SEED + 2)
    vocab = configs.llama2_1b.vocab_size
    tokens = rng.integers(0, vocab, (DATA_INFER_ROWS, DATA_INFER_SEQ),
                          dtype=np.int32)
    ds = rd.from_numpy({"tokens": tokens,
                        "row": np.arange(DATA_INFER_ROWS)},
                       parallelism=DATA_INFER_BLOCKS).map_batches(
        _Scorer, compute=rd.ActorPoolStrategy(size=1),
        resources={"GPU": 1})
    t0_wall = time.time()
    t0 = time.perf_counter()
    out = ds.take_all()
    wall = time.perf_counter() - t0
    _wait_gpu(rt, 1.0, "the GPU was not back at 1.0 after the pool closed")
    rows = [r["row"] for r in out]
    first_call = min(r["call_start"] for r in out)
    calls = {r["call_start"]: r["call_s"] for r in out}
    check_rows = list(range(8))
    by_row = {r["row"]: r for r in out}
    cfg = dc.replace(configs.llama2_1b, max_seq=DATA_INFER_SEQ)
    params = init_params(cfg, seed=SEED, device="cuda")
    want = _score(params, torch.from_numpy(tokens[check_rows]).cuda().long(),
                  cfg).cpu().numpy()
    del params
    torch.cuda.empty_cache()
    got = np.array([by_row[r]["nll"] for r in check_rows], dtype=np.float32)
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    infos = sorted({(r["visible"], r["granted"], r["device"]) for r in out})
    rms = sorted({r["rms_launches"] for r in out})
    flash = sorted({r["flash_launches"] for r in out})
    L = cfg.n_layers
    rec = {"path": "data_infer", "model": "llama2-1b", "dtype": "bfloat16",
           "rows": len(out), "seq": DATA_INFER_SEQ,
           "blocks": DATA_INFER_BLOCKS, "pool_size": 1,
           "wall_s": wall, "rows_per_s": len(out) / wall,
           "pool_setup_s": first_call - t0_wall,
           "actor_init_s": out[0]["init_s"],
           "rows_per_s_after_setup": (len(out) - 8) / max(
               1e-9, t0_wall + wall - first_call - calls[first_call]),
           "forwards": len(calls),
           "forward_ms_median": sorted(calls.values())[len(calls) // 2] * 1e3,
           "checked_rows": check_rows, "nll_pool": got.tolist(),
           "nll_driver": want.tolist(), "max_rel": rel,
           "rtol": DATA_INFER_RTOL, "actor": infos,
           "rms_launches_per_forward": rms,
           "flash_launches_per_forward": flash,
           "launches": {"rmsnorm_fwd": sum(rms) * len(calls),
                        "flash_fwd": sum(flash) * len(calls)},
           "gpu_after": rt.available_resources().get("GPU", 0.0)}
    emit({"phase": "data", **rec})
    check(sorted(rows) == list(range(DATA_INFER_ROWS)),
          f"{len(rows)} rows scored, not each of {DATA_INFER_ROWS} once")
    check(len(calls) == DATA_INFER_BLOCKS, f"{len(calls)} forwards")
    check(all(np.isfinite(r["nll"]) for r in out), "an NLL is not finite")
    check(rel <= DATA_INFER_RTOL, f"the pool's NLLs {got} differ from the "
          f"driver's {want} by {rel}")
    check(rms == [2 * L + 1] and flash == [L],
          f"launches per forward: rmsnorm {rms}, flash {flash}")
    check(len(infos) == 1 and infos[0][2] == device_name
          and infos[0][0] == infos[0][1] and infos[0][0],
          f"the pool actor's card (visible, granted, name): {infos}")
    return rec


def _feed_images(batch):
    """map_batches' stage of data_feed: ImageNet-shaped uint8 images made
    from the seed and the block's first row id, with each row's byte sum."""
    ids = np.asarray(batch["id"], dtype=np.int64)
    rng = np.random.default_rng(SEED + 3 + int(ids[0]))
    images = rng.integers(0, 256, (len(ids),) + IMAGE_SHAPE, dtype=np.uint8)
    return {"image": images, "id": ids,
            "sum": images.reshape(len(ids), -1).sum(axis=1, dtype=np.int64)}


def _raylet_spilled() -> dict:
    from ray_tpu_torch._private import worker as worker_mod

    client = worker_mod.get_client()
    return client._run(client.raylet.call("get_info", {}),
                       timeout=30)["spilled"]


def _pinned_copy_gb_s(nbytes: int, reps: int = 20) -> float:
    """A pinned host buffer copied onto the card: the H2D bound the feed
    is held against."""
    import torch

    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    host.fill_(1)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dev.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        dev.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    return nbytes * reps / (time.perf_counter() - t0) / 1e9


def _data_feed(rt, rd) -> dict:
    import torch

    from ray_tpu_torch._private.config import get_config

    spilled0 = _raylet_spilled()
    ds = rd.range(DATA_FEED_ROWS, parallelism=DATA_FEED_BLOCKS).map_batches(
        _feed_images)
    t0 = time.perf_counter()
    feed = ds.iter_torch_batches(batch_size=DATA_FEED_BATCH)
    ids, bad, n_batches, devices = [], 0, 0, set()
    first = None
    for b in feed:
        if first is None:
            first = time.perf_counter() - t0
        img = b["image"]
        sums = img.reshape(img.shape[0], -1).sum(dim=1, dtype=torch.int64)
        bad += int((sums != b["sum"]).sum())
        ids.append(b["id"])
        devices |= {str(t.device) for t in b.values()}
        n_batches += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ids = torch.cat(ids).cpu().numpy()
    stats = feed.stats.snapshot()
    spilled1 = _raylet_spilled()
    image_bytes = DATA_FEED_ROWS * int(np.prod(IMAGE_SHAPE))
    bound = _pinned_copy_gb_s(DATA_FEED_BATCH * int(np.prod(IMAGE_SHAPE)))
    rec = {"path": "data_feed", "rows": len(ids), "batches": n_batches,
           "image_shape": list(IMAGE_SHAPE), "image_bytes": image_bytes,
           "store_bytes": get_config().object_store_memory,
           "wall_s": wall, "first_batch_s": first,
           "feed_gb_s": stats["h2d_bytes"] / wall / 1e9,
           "feed_gb_s_after_first_batch": (
               stats["h2d_bytes"] * (n_batches - 1) / n_batches
               / (wall - first) / 1e9),
           "pinned_copy_gb_s": bound, "feed": stats,
           "h2d_gb_s_while_dispatching": (stats["h2d_bytes"] / stats["h2d_s"]
                                          / 1e9 if stats["h2d_s"] else None),
           "spilled": {"objects": spilled1["objects"] - spilled0["objects"],
                       "bytes": spilled1["bytes"] - spilled0["bytes"]},
           "devices": sorted(devices), "sum_mismatches": bad}
    emit({"phase": "data", **rec})
    check(sorted(ids.tolist()) == list(range(DATA_FEED_ROWS)),
          f"{len(ids)} rows arrived, not each of {DATA_FEED_ROWS} once")
    check(bad == 0, f"{bad} rows' byte sums on the card differ")
    check(devices == {"cuda:0"}, f"batches on {devices}")
    check(stats["batches"] == n_batches
          and stats["h2d_bytes"] >= image_bytes, f"the feed: {stats}")
    return rec


def phase_data(train_rec, device_name):
    import gc
    import os
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd

    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="rt_data_")
    os.environ["TMPDIR"] = tmp
    rt.init(num_cpus=4)
    try:
        seconds = {}
        t0 = time.perf_counter()
        trained = _data_train(rt, rd, train_rec, tmp)
        seconds["data_train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        inferred = _data_infer(rt, rd, device_name)
        seconds["data_infer"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fed = _data_feed(rt, rd)
        seconds["data_feed"] = time.perf_counter() - t0
    finally:
        rt.shutdown()
    left, procs = _stop_runtime()
    shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "data", "seconds": seconds, "card": device_name,
          "summary": {
              "data_train_step_ms_median": trained["step_ms_median"],
              "phase_train_step_ms_median": trained[
                  "phase_train_step_ms_median"],
              "data_train_feed": trained["feed"],
              "data_train_flight_recorder_data_share": trained[
                  "flight_recorder_data_share"],
              "data_infer_rows_per_s": inferred["rows_per_s"],
              "data_infer_pool_setup_s": inferred["pool_setup_s"],
              "data_feed_gb_s": fed["feed_gb_s"],
              "data_feed_pinned_copy_gb_s": fed["pinned_copy_gb_s"],
              "data_feed_stalls": fed["feed"]["stall_count"],
              "data_feed_h2d_s": fed["feed"]["h2d_s"],
              "data_feed_spilled_bytes": fed["spilled"]["bytes"]}})
    check(not left and not procs, f"left after the phase: {left} {procs}")
    return trained["launches"], inferred["launches"]


# -- loadgen: rt loadgen's open-loop trace against llama3-8b behind Serve ----
# A head from `rt start --head` with its dashboard; a user deployment that
# holds a ContinuousBatchingEngine of llama3-8b (full width and depth, bf16,
# seed 0) on the card; `rt loadgen gen` writes the trace twice and `rt
# loadgen run` replays it, streaming; the dashboard is read while the run's
# metrics are in the GCS; a job is POSTed to the dashboard's REST API.
LOADGEN_APP = "lg"
LOADGEN_TRACE = ("--seed", "0", "--duration", "30", "--qps", "1.0",
                 "--flash", "10:5:4", "--process", "poisson")
LOADGEN_DURATION_S = 30.0
# 8 slots x 5120 tokens: the default blend's longest prompt (4,096) and
# output (1,024) fit; a multiple of the 64-token chunk and 16-token page.
LOADGEN_ENGINE = {"num_slots": 8, "max_len": 5120, "prefill_chunk": 64,
                  "kv_mode": "paged", "page_size": 16, "eos_id": None}

# `rt loadgen run` as `python -m ray_tpu_torch` runs it, and the cards it
# stamped written to $RT_LOADGEN_CARDS (the CLI prints only their summary).
LOADGEN_RUN = r"""
import json, os, runpy, sys
import ray_tpu_torch.loadgen as lg

_run_trace = lg.run_trace


def run_trace(header, records, call_fn, **kw):
    result = _run_trace(header, records, call_fn, **kw)
    with open(os.environ["RT_LOADGEN_CARDS"], "w") as f:
        json.dump([c.to_doc() for c in result.cards], f)
    return result


lg.run_trace = run_trace
sys.argv = ["rt"] + sys.argv[1:]
runpy.run_module("ray_tpu_torch", run_name="__main__")
"""


def _loadgen_deployment_cls():
    """The trace's deployment: the serve phase's counting LLMReplica,
    whose `__call__(request)` takes a trace record, builds a prompt of
    `prompt_tokens` ids from a generator seeded by its index, and streams
    the engine's tokens. A generator's body runs in the replica's stream
    thread, where the request's observatory context is set, so the
    engine's stamps land on the request's card."""

    class TraceLLM(_serve_replica_cls()):
        def __call__(self, request):
            import numpy as np

            rng = np.random.default_rng(request["i"])
            yield from self.stream(
                rng.integers(0, self.engine.cfg.vocab_size,
                             request["prompt_tokens"]),
                request["max_tokens"])

        def counts(self):
            """Launches and passes since reset_counts(); the engine's
            step split and TPOT over its life (the warm-up included)."""
            out = super().counts()
            st = self.engine.stats()
            out.update(n_layers=self.engine.cfg.n_layers,
                       kv_pages=self.engine.kv_pages,
                       max_len=self.engine.max_len, steps=st["steps"],
                       prefill_chunks=st["prefill_chunks"],
                       timing=st["timing"], tpot_s=st["latency"]["tpot"])
            return out

        def sample(self):
            """Card bytes as util.memory publishes them, and this
            process's own memory_allocated() at the same moment."""
            import torch

            from ray_tpu_torch.util import memory, metrics

            self._settled()
            torch.cuda.synchronize()
            sample = memory.sample_once()
            allocated = torch.cuda.memory_allocated()
            metrics._flush_once()
            return {"sample": sample, "allocated": allocated}

        def board(self):
            """The expressions of generate_dashboard() as the serving
            process builds it from its own metric registry, and the type
            that registry gives each serve_/loadgen_ metric."""
            from ray_tpu_torch.dashboard.grafana import generate_dashboard
            from ray_tpu_torch.util import metrics

            with metrics._registry_lock:
                types = {m.info["name"]: type(m).__name__.lower()
                         for m in metrics._registry
                         if m.info["name"].startswith(("serve_",
                                                       "loadgen_"))}
            return {"exprs": [t["expr"] for p in
                              generate_dashboard()["panels"]
                              for t in p["targets"]],
                    "types": types}

    return TraceLLM


def _http(url, data=None, timeout=60):
    """(status, content type, body text, wall seconds) of one request."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"}
        if data is not None else {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body, status, ctype = r.read().decode(), r.status, \
                r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        body, status, ctype = e.read().decode(), e.code, \
            e.headers.get("Content-Type")
    return status, ctype, body, time.perf_counter() - t0


def _prom_samples(text, name):
    """{label text: value} of a metric's samples in an exposition."""
    import re

    out = {}
    for m in re.finditer(rf"^{re.escape(name)}(\{{[^}}]*\}})? (\S+)$", text,
                         re.M):
        out[m.group(1) or ""] = float(m.group(2))
    return out


def _pid_alive(pid) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(") ", 1)[1][0] != "Z"
    except OSError:
        return False


def phase_loadgen(device_name):
    import gc
    import os
    import pathlib
    import re
    import shutil
    import tempfile

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="rt_loadgen_")
    env = {k: v for k, v in os.environ.items() if k != "RT_NUM_GPUS"}
    env["TMPDIR"] = tmp
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [os.path.dirname(os.path.abspath(__file__)),
                    env.get("PYTHONPATH", "")] if p)
    walls = {}
    started, walls["start"] = _cli(env, "start", "--head", "--num-gpus", "1",
                                   "--num-cpus", "4", "--dashboard-port", "0")
    with open(os.path.join(tmp, "ray_tpu_torch", "session.json")) as f:
        session = json.load(f)
    addr, dash_port = session["gcs_address"], session.get("dashboard_port")
    check(bool(dash_port) and len(session["pids"]) == 3,
          f"rt start --head started no dashboard: {started} {session}")
    dash = f"http://127.0.0.1:{dash_port}"
    dash_pid = session["pids"][-1]
    os.environ["TMPDIR"] = tmp  # the driver's own node logs there too

    import ray_tpu_torch as rt
    from ray_tpu_torch import loadgen, serve
    from ray_tpu_torch.dashboard.grafana import generate_dashboard
    from ray_tpu_torch.serve.observatory import percentile
    from ray_tpu_torch.util.lifecycle import SERVE_PHASE_ORDER

    rt.init(address=addr, num_gpus=0)
    try:
        # -- deploy ----------------------------------------------------------
        t0 = time.perf_counter()
        dep = serve.deployment(_loadgen_deployment_cls(), name="TraceLLM",
                               max_ongoing_requests=64,
                               ray_actor_options={"num_gpus": 1})
        h = serve.run(dep.bind(_llama_loader("bfloat16", 0, SEED),
                               **LOADGEN_ENGINE), name=LOADGEN_APP)
        warm = list(h.options(stream=True).remote(
            {"i": 10**6, "prompt_tokens": 8, "max_tokens": 4}))
        deploy_s = time.perf_counter() - t0
        check(len(warm) == 4, f"the warm-up request streamed {warm}")
        h.options(method_name="reset_counts").remote().result(timeout=300)

        # -- the trace, twice ------------------------------------------------
        paths = [os.path.join(tmp, f"trace{k}.jsonl") for k in (1, 2)]
        for k, path in enumerate(paths):
            _, walls[f"gen{k + 1}"] = _cli(env, "loadgen", "gen", path,
                                           *LOADGEN_TRACE)
        blobs = [pathlib.Path(p).read_bytes() for p in paths]
        trace = [json.loads(ln) for ln in blobs[0].decode().splitlines()]
        records = trace[1:]
        by_idx = {r["i"]: r for r in records}

        # -- replay ----------------------------------------------------------
        cards_path = os.path.join(tmp, "cards.json")
        report_path = os.path.join(tmp, "report.json")
        run_env = dict(env, RT_LOADGEN_CARDS=cards_path)
        run_log = os.path.join(tmp, "loadgen_run.log")
        t0 = time.perf_counter()
        with open(run_log, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-c", LOADGEN_RUN, "loadgen", "run",
                 paths[0], "--app", LOADGEN_APP, "--address", addr,
                 "--out", report_path],
                env=run_env, stdout=log, stderr=subprocess.STDOUT)
        run_mapped_torch, reads = False, 0
        while proc.poll() is None:
            maps = _mapped(proc.pid)
            if maps["readable"]:
                run_mapped_torch |= maps["torch"]
                reads += 1
            check(time.perf_counter() - t0 < 600, "rt loadgen run hung")
            time.sleep(0.2)
        walls["run"] = time.perf_counter() - t0
        run_out = pathlib.Path(run_log).read_text()
        with open(report_path) as f:
            report = json.load(f)
        with open(cards_path) as f:
            cards = json.load(f)
        summary, recon = report["run"], report["reconciliation"]
        counts = h.options(method_name="counts").remote().result(timeout=300)
        server = loadgen.collect_server_records(LOADGEN_APP)
        matched = {r["rid"] for r in recon["requests"]}
        phases = {p: sorted(r["phases"].get(p, 0.0) for r in server
                            if r["rid"] in matched)
                  for p in SERVE_PHASE_ORDER}
        held = h.options(method_name="sample").remote().result(timeout=300)
        replica_board = h.options(method_name="board").remote().result(
            timeout=300)

        # -- the dashboard ---------------------------------------------------
        health = _http(dash + "/healthz")
        nodes = json.loads(_http(dash + "/api/nodes")[2])
        apps = json.loads(_http(dash + "/api/serve")[2])
        entry = held["sample"][0] if held["sample"] else {}
        deadline = time.monotonic() + 30
        while True:
            scrape = _http(dash + "/metrics")
            text = scrape[2]
            issued = _prom_samples(text, "loadgen_requests_total")
            live = {k: v for k, v in
                    _prom_samples(text, "device_hbm_live_bytes").items()
                    if f'device="{entry.get("device")}"' in k}
            if (sum(issued.values()) == len(records)
                    and held["allocated"] in live.values()) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        scrape_s = sorted(_http(dash + "/metrics")[3] for _ in range(5))
        exported = dict(re.findall(r"^# TYPE ((?:loadgen|serve)_\w+) (\w+)$",
                                   text, re.M))
        # The board an operator gets: the curated panels, and a panel for
        # each metric in the registry of the process that builds it (the
        # replica, which exports the serve_ metrics no curated panel shows).
        curated = generate_dashboard(user_metrics=[])
        curated_exprs = [t["expr"] for p in curated["panels"]
                         for t in p["targets"]]

        def in_exprs(name, pool):
            pat = re.compile(rf"\b{re.escape(name)}(_bucket|_sum|_count)?\b")
            return any(pat.search(e) for e in pool)

        uncurated = sorted(n for n in exported
                           if not in_exprs(n, curated_exprs))
        unboarded = [n for n in uncurated
                     if not in_exprs(n, replica_board["exprs"])]
        mistyped = {n: (t, replica_board["types"][n])
                    for n, t in exported.items()
                    if replica_board["types"].get(n, t) != t}
        dash_maps = _mapped(dash_pid)

        # -- a job through the REST API, once the replica gives the card back
        serve.shutdown()
        _wait_gpu(rt, 1.0, "the GPU was not back at 1.0 after serve")
        wd = os.path.join(tmp, "job")
        os.makedirs(wd)
        with open(os.path.join(wd, "job_main.py"), "w") as f:
            f.write(JOB_MAIN)
        token = f"rest-{SEED}-{os.getpid()}"
        with open(os.path.join(wd, "job_data.json"), "w") as f:
            json.dump({"seed": SEED + 7, "shape": [8, 4096], "eps": EPS,
                       "token": token}, f)
        t0 = time.perf_counter()
        posted = _http(dash + "/api/jobs", json.dumps({
            "entrypoint": f"{sys.executable} {wd}/job_main.py",
            "runtime_env": {"env_vars": {
                "RT_JOB_MARKER": "rt-rest-job",
                "RT_JOB_DATA": os.path.join(wd, "job_data.json")}},
        }).encode())
        check(posted[0] == 200, f"POST /api/jobs: {posted[:3]}")
        sid = json.loads(posted[2])["submission_id"]
        job = {}
        while job.get("state") not in ("SUCCEEDED", "FAILED", "STOPPED"):
            check(time.perf_counter() - t0 < 600, f"the job hung: {job}")
            time.sleep(0.1)
            job = json.loads(_http(dash + f"/api/jobs/{sid}")[2])
        job_s = time.perf_counter() - t0
        job_logs = _http(dash + f"/api/jobs/{sid}/logs")[2]
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
            os.environ.pop("TMPDIR", None)
    _, walls["stop"] = _cli(env, "stop")
    deadline = time.monotonic() + 30
    while (_runtime_procs() or any(_pid_alive(p) for p in session["pids"])) \
            and time.monotonic() < deadline:
        time.sleep(0.2)
    left = _runtime_procs() + [p for p in session["pids"] if _pid_alive(p)]
    shutil.rmtree(tmp, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase

    # -- what the run measured -----------------------------------------------
    ok = [c for c in cards if c["error"] is None]
    tenants = sorted({c["tenant"] for c in cards})

    def q(xs, p):
        return percentile(sorted(xs), p)

    by_tenant = {t: {k: {"p50": q([c[k] for c in ok if c["tenant"] == t],
                                  0.5),
                         "p99": q([c[k] for c in ok if c["tenant"] == t],
                                  0.99)}
                     for k in ("ttfb_s", "client_e2e_s")}
                 for t in tenants}
    out_tokens = sum(c["chunks"] for c in ok)
    bad_chunks = [(c["idx"], c["chunks"], by_idx[c["idx"]]["max_tokens"])
                  for c in cards
                  if c["chunks"] != by_idx[c["idx"]]["max_tokens"]]
    lines = [ln for ln in job_logs.splitlines() if ln.startswith("JOB_TASK ")]
    task = json.loads(lines[-1][len("JOB_TASK "):]) if lines else {}
    rec = {"phase": "loadgen", "card": device_name,
           "requests": len(records),
           "offered_qps": len(records) / LOADGEN_DURATION_S,
           "achieved_qps": summary["achieved_qps"],
           "run_duration_s": summary["duration_s"],
           "output_tokens": out_tokens,
           "output_tokens_per_s": out_tokens / summary["duration_s"],
           "client_by_tenant": by_tenant,
           "client_e2e_s": summary["client_e2e_s"],
           "client_ttfb_s": summary["client_ttfb_s"],
           "gap_fraction": recon["summary"]["gap_fraction"],
           "gap_s": recon["summary"]["gap_s"],
           "gate_pass": recon["summary"]["gate_pass"],
           "cli_rc": proc.returncode,
           "matched": recon["summary"]["matched"],
           "unmatched": recon["summary"]["unmatched"],
           "errors": recon["summary"]["errors"],
           "server_phase_p50_s": {p: q(v, 0.5) for p, v in phases.items()},
           "server_phase_p99_s": {p: q(v, 0.99) for p, v in phases.items()},
           "rmsnorm": counts,
           "metrics_scrape_s": {"p50": scrape_s[2], "min": scrape_s[0],
                                "max": scrape_s[-1],
                                "bytes": len(text.encode())},
           "card_bytes": {"sampled": entry.get("live_bytes"),
                          "replica_own": held["allocated"],
                          "dashboard": sorted(live.values())},
           "exported_metrics": len(exported),
           "curated_on_board": len(exported) - len(uncurated),
           "uncurated": uncurated,
           "job": {"state": job.get("state"), "submit_to_end_s": job_s,
                   "task": task},
           "deploy_s": deploy_s, "walls_s": walls, "phase_s": phase_s,
           "procs_left": left}
    emit(rec)
    print(json.dumps({"loadgen_numbers": {
        k: rec[k] for k in ("offered_qps", "achieved_qps",
                            "output_tokens_per_s", "client_by_tenant",
                            "gap_fraction", "gate_pass",
                            "server_phase_p50_s", "metrics_scrape_s",
                            "phase_s")}}), flush=True)
    check(blobs[0] == blobs[1], "rt loadgen gen wrote two different traces")
    check(summary["issued"] == len(records) and len(cards) == len(records),
          f"{summary['issued']} issued, {len(cards)} cards, "
          f"{len(records)} in the trace")
    check(not [c for c in cards if c["error"]],
          f"failed cards: {[c for c in cards if c['error']][:3]}")
    check(recon["summary"]["unmatched"] == 0 and
          recon["summary"]["matched"] == len(records),
          f"reconciliation: {recon['summary']}")
    check(not bad_chunks, f"chunks != max_tokens (idx, got, want): "
          f"{bad_chunks[:5]}")
    check((proc.returncode == 0) == bool(recon["summary"]["gate_pass"])
          and proc.returncode in (0, 1),
          f"rt loadgen run exited {proc.returncode} with gate_pass "
          f"{recon['summary']['gate_pass']}: {run_out[-2000:]}")
    per_pass = 2 * counts["n_layers"] + 1
    check(counts["forward_passes"] > 0 and counts["rmsnorm_launches"]
          == per_pass * counts["forward_passes"],
          f"rmsnorm launches in the replica: {counts}")
    check(reads > 0 and not run_mapped_torch,
          f"the loadgen run process mapped libtorch ({reads} reads)")
    check(dash_maps["readable"] and not dash_maps["torch"],
          f"the dashboard process's maps: {dash_maps}")
    check(health[0] == 200 and health[2] == "ok", f"/healthz: {health[:3]}")
    check([(n["is_head"], n["resources_total"].get("GPU", 0.0))
           for n in nodes if n["state"] == "ALIVE"]
          == [(True, 1.0), (False, 0.0)],
          f"/api/nodes (the head's and the driver's node): {nodes}")
    check([(a["app"], a["running_replicas"]) for a in apps]
          == [(LOADGEN_APP, 1)], f"/api/serve: {apps}")
    check(sum(issued.values()) == len(records),
          f"loadgen_requests_total {issued} against {len(records)}")
    check("serve_llm_ttft_seconds_bucket" in text,
          "/metrics lacks serve_llm_ttft_seconds_bucket")
    check(entry.get("live_bytes") == held["allocated"]
          and list(live.values()) == [held["allocated"]],
          f"device_hbm_live_bytes {live} against the replica's "
          f"{held['allocated']}")
    check(not unboarded, f"exported metrics on no Grafana panel: {unboarded}")
    check(not mistyped, "metrics whose exposition type is not their "
          f"registry's (exposition, registry): {mistyped}")
    check(job.get("state") == "SUCCEEDED", f"the REST job: {job} "
          f"{job_logs[-2000:]}")
    check(task.get("launches") == 1 and task.get("ulp", 99) <= 1
          and task.get("token") == token
          and task.get("marker") == "rt-rest-job"
          and task.get("device") == device_name, f"the REST job's task: {task}")
    check(not left, f"processes after rt stop: {left}")
    return counts["rmsnorm_launches"], task["launches"]


# -- the collective layer: DCN rings, the local and hierarchical groups -----
COLLECTIVE_RANKS = 4
COLLECTIVE_MIB = 256     # bf16 payload per rank
COLLECTIVE_ALPHA_OPS = 200
COLLECTIVE_GROUP = "smoke_dcn"


class _CollectiveRank:
    """One actor of the collective phase. Made a remote class with
    fractional GPUs in the phase, so that several share the one card."""

    def init_collective(self, world_size, rank, backend, group_name):
        import os

        from ray_tpu_torch.util import collective as col

        self.col, self.rank, self.world = col, rank, world_size
        self.group_name = group_name
        self.seen = []
        col.add_op_observer(
            lambda op, s, info=None: self.seen.append([op, s, info]))
        self.group = col.init_collective_group(world_size, rank, backend,
                                               group_name)
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    def _inputs(self, r, integer, n):
        import torch

        g = torch.Generator(device="cuda").manual_seed(
            SEED + 100 + r + (1000 if integer else 0))
        x = torch.randn(n, generator=g, device="cuda")
        if integer:  # small integers: every sum is exact in bf16
            x = torch.round(x * 4).clamp_(-16, 16)
        return x.to(torch.bfloat16)

    def _timed(self, name, fn, times):
        import time as _time

        import torch

        self.col.barrier(self.group_name)
        t0 = _time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = _time.perf_counter() - t0
        return out

    def run_dcn(self, mib):
        """Every DCN op on card tensors of `mib` MiB of bf16, each checked
        against a reference made on the card; op times; alpha; the
        observer's records."""
        import os
        import time as _time

        import torch

        from ray_tpu_torch.util.collective import quant

        col, g, n, r = self.col, self.group_name, self.world, self.rank
        numel = mib * 2 ** 20 // 2
        ints = [self._inputs(k, True, numel) for k in range(n)]
        mine = ints[r]
        # The ring's order: chunk c starts at rank c and each next rank
        # adds its own to what it received, in bf16 on the card.
        chunks = [x.tensor_split(n) for x in ints]
        ref = torch.cat([self._ring_sum(chunks, c, n) for c in range(n)])
        times, ok, bits = {}, {}, lambda t: t.view(torch.int16)
        for algo in ("ring", "rd"):  # connect each schedule's links
            col.allreduce(torch.ones(1), g, algo=algo)
        self.seen.clear()
        for algo in ("ring", "rd"):
            os.environ["RT_COLLECTIVE_ALGO"] = algo
            out = self._timed(f"allreduce_{algo}",
                              lambda: col.allreduce(mine, g), times)
            ok[f"allreduce_{algo}"] = bool(
                out.device == mine.device and torch.equal(bits(out),
                                                          bits(ref)))
            ok[f"allreduce_{algo}_algo"] = (
                col.last_op_info(g)["algo"] == algo)
        os.environ.pop("RT_COLLECTIVE_ALGO")
        outs = self._timed("allgather", lambda: col.allgather(mine, g),
                           times)
        ok["allgather"] = all(torch.equal(bits(a), bits(b))
                              and a.is_cuda for a, b in zip(outs, ints))
        del outs
        out = self._timed("reducescatter",
                          lambda: col.reducescatter(mine, g), times)
        ok["reducescatter"] = torch.equal(bits(out),
                                          bits(ref.tensor_split(n)[r]))
        out = self._timed("broadcast", lambda: col.broadcast(mine, 0, g),
                          times)
        ok["broadcast"] = torch.equal(bits(out), bits(ints[0]))

        def sendrecv():
            if r == 0:
                col.send(mine, 1, g)
                return None
            if r == 1:
                return col.recv(mine, 0, g)
            return None

        out = self._timed("send_recv", sendrecv, times)
        ok["send_recv"] = (r != 1 or (out.is_cuda and torch.equal(
            bits(out), bits(ints[0]))))
        self._timed("barrier", lambda: col.barrier(g), times)
        ops = [s[0] for s in self.seen]
        # Random inputs through the quantized ring: within the codec's
        # per-hop radius times the hops, plus the output's bf16 rounding.
        rands = [self._inputs(k, False, numel) for k in range(n)]
        exact = sum(x.float() for x in rands)
        peak_sum = sum(float(x.float().abs().max()) for x in rands)
        quant_rec = {}
        for scheme in ("int8", "fp8"):
            radius = max(quant.roundtrip_error(x, scheme) for x in rands)
            out = self._timed(f"allreduce_{scheme}", lambda: col.allreduce(
                rands[r], g, quant=scheme), times)
            err = (out.float() - exact).abs()
            bound = n * radius * peak_sum + exact.abs() * 2.0 ** -8
            quant_rec[scheme] = {
                "radius": radius, "max_abs_err": float(err.max()),
                "bound_at_max": float(bound.max()),
                "wire_bytes": col.last_op_info(g)["bytes"]}
            ok[f"allreduce_{scheme}"] = bool((err <= bound).all())
            ok[f"allreduce_{scheme}_record"] = (
                col.last_op_info(g)["quant"] == scheme)
        # Codes made on the card equal the CPU's, bit for bit.
        head = rands[r][: 1 << 20].float()
        for scheme in ("int8", "fp8"):
            a, b = quant.encode(head, scheme), quant.encode(head.cpu(),
                                                            scheme)
            ok[f"codes_{scheme}_on_card"] = bool(
                a.codes.is_cuda and torch.equal(a.codes.cpu(), b.codes)
                and torch.equal(a.scales.cpu().view(torch.int32),
                                b.scales.view(torch.int32)))
        del rands, exact, out
        # Alpha: one-element recursive-doubling allreduces (ceil(log2 n)
        # rounds, one message each way a round).
        one = torch.ones(1)
        lat = []
        for _ in range(COLLECTIVE_ALPHA_OPS):
            t0 = _time.perf_counter()
            col.allreduce(one, g, algo="rd")
            lat.append(_time.perf_counter() - t0)
        lat.sort()
        rounds = (n - 1).bit_length()
        seen_ok = all(info and info.get("tier") == "dcn"
                      and info.get("op") == op for op, _, info in self.seen)
        return {"rank": r, "times_s": times, "ok": ok,
                "bytes_per_rank": numel * 2, "quant": quant_rec,
                "alpha_us": lat[len(lat) // 2] / rounds * 1e6,
                "rd_one_element_p50_us": lat[len(lat) // 2] * 1e6,
                "observed_ops": ops, "observer_records_ok": seen_ok,
                "observed": len(self.seen), "bytes_sent": self.group.bytes_sent}

    @staticmethod
    def _ring_sum(chunks, c, n):
        acc = chunks[c][c].clone()
        for k in range(1, n):
            acc = chunks[(c + k) % n][c] + acc
        return acc

    def run_hier(self):
        """A hierarchical allreduce of one card tensor per process: equal
        to the flat sum of both processes' tensors."""
        import torch

        col = self.col
        xs = [self._inputs(k, True, 1 << 20) for k in range(self.world)]
        out = col.allreduce([xs[self.rank]], self.group_name)
        flat = xs[0] + xs[1]
        info = col.last_op_info(self.group_name)
        return {"n_local": self.group.local.world_size,
                "equal": bool(out[0].is_cuda and torch.equal(out[0], flat)),
                "info": info}

    def leave(self):
        self.col.destroy_collective_group(self.group_name)
        return True


def _local_group_on_card() -> dict:
    """The local group at world size 1 on the card: NCCL over one card;
    every result stays on the card and equals what world size 1 gives."""
    import torch

    from ray_tpu_torch.util.collective.local_group import LocalGroup
    from ray_tpu_torch.util.collective.types import ReduceOp

    g = LocalGroup(device="cuda")
    x = torch.arange(1 << 20, device="cuda", dtype=torch.float32)
    out = {"world_size": g.world_size}
    red = g.allreduce([x], ReduceOp.SUM)
    out["allreduce"] = red[0].is_cuda and torch.equal(red[0], x)
    out["record"] = dict(g.last_op_info)
    out["max"] = torch.equal(g.allreduce([x], ReduceOp.MAX)[0], x)
    gathered = g.allgather([x])
    out["allgather"] = torch.equal(gathered[0][0], x)
    out["broadcast"] = torch.equal(g.broadcast([x], 0)[0], x)
    out["reducescatter"] = torch.equal(g.reducescatter([x])[0], x)
    torch.cuda.synchronize()
    return out


def phase_collective(device_name):
    import gc

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.util import collective as col

    gc.collect()
    torch.cuda.empty_cache()
    local = _local_group_on_card()
    rt.init(num_cpus=4)
    try:
        Rank = rt.remote(num_gpus=1.0 / COLLECTIVE_RANKS)(_CollectiveRank)
        ranks = [Rank.remote() for _ in range(COLLECTIVE_RANKS)]
        t0 = time.perf_counter()
        col.create_collective_group(ranks, COLLECTIVE_RANKS,
                                    list(range(COLLECTIVE_RANKS)),
                                    backend="dcn",
                                    group_name=COLLECTIVE_GROUP)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dcn = rt.get([a.run_dcn.remote(COLLECTIVE_MIB) for a in ranks],
                     timeout=900)
        dcn_s = time.perf_counter() - t0
        rt.get([a.leave.remote() for a in ranks], timeout=60)
        for a in ranks:
            rt.kill(a)
        _wait_gpu(rt, 1.0, "the GPU was not back after the DCN ranks")
        Hier = rt.remote(num_gpus=0.5)(_CollectiveRank)
        hiers = [Hier.remote() for _ in range(2)]
        col.create_collective_group(hiers, 2, [0, 1], backend="hier",
                                    group_name="smoke_hier")
        hier = rt.get([a.run_hier.remote() for a in hiers], timeout=300)
        rt.get([a.leave.remote() for a in hiers], timeout=60)
        for a in hiers:
            rt.kill(a)
    finally:
        rt.shutdown()
    left, _ = _stop_runtime()
    n = COLLECTIVE_RANKS
    nbytes = COLLECTIVE_MIB * 2 ** 20
    slowest = {op: max(d["times_s"][op] for d in dcn)
               for op in dcn[0]["times_s"]}
    # Bus bandwidth as NCCL's tests define it: what each rank's link
    # carries over the op's time (2(n-1)/n of the payload for an
    # allreduce, (n-1)/n of the gathered bytes for a gather).
    bus = {
        "allreduce_ring": 2 * (n - 1) / n * nbytes / slowest["allreduce_ring"],
        "allreduce_rd": nbytes * (n - 1).bit_length()
        / slowest["allreduce_rd"],
        "allgather": (n - 1) * nbytes / slowest["allgather"],
        "reducescatter": (n - 1) / n * nbytes / slowest["reducescatter"],
        "broadcast": nbytes / slowest["broadcast"],
        "send_recv": nbytes / slowest["send_recv"],
        "allreduce_int8": 2 * (n - 1) / n * nbytes / slowest["allreduce_int8"],
        "allreduce_fp8": 2 * (n - 1) / n * nbytes / slowest["allreduce_fp8"],
    }
    alpha = sorted(d["alpha_us"] for d in dcn)
    rec = {"phase": "collective", "card": device_name,
           "ranks": n, "payload_mib_bf16_per_rank": COLLECTIVE_MIB,
           "op_s_slowest_rank": slowest,
           "bus_gb_s": {k: v / 1e9 for k, v in bus.items()},
           "alpha_us_median_rank": alpha[len(alpha) // 2],
           "alpha_us_by_rank": [d["alpha_us"] for d in dcn],
           "quant": dcn[0]["quant"],
           "checks_by_rank": [d["ok"] for d in dcn],
           "observed_ops_rank0": dcn[0]["observed_ops"],
           "group_setup_s": setup_s, "dcn_s": dcn_s,
           "local_group": local, "hier": hier, "procs_left": left}
    emit(rec)
    print(json.dumps({"collective_numbers": {
        "bus_gb_s": rec["bus_gb_s"], "alpha_us": rec["alpha_us_median_rank"],
        "op_s": slowest}}), flush=True)
    bad = [(d["rank"], k) for d in dcn for k, v in d["ok"].items() if not v]
    check(not bad, f"DCN ops that disagree with the card's reference: {bad}")
    want_ops = ["barrier", "allreduce", "barrier", "allreduce", "barrier",
                "allgather", "barrier", "reducescatter", "barrier",
                "broadcast", "barrier", "barrier", "barrier"]
    for d in dcn:
        got = d["observed_ops"]
        sr = [op for op in got if op in ("send", "recv")]
        check([op for op in got if op not in ("send", "recv")]
              == want_ops and d["observer_records_ok"]
              and len(sr) == (1 if d["rank"] in (0, 1) else 0),
              f"rank {d['rank']}'s observer saw {got}")
    check(local["world_size"] == 1 and all(
        local[k] for k in ("allreduce", "max", "allgather", "broadcast",
                           "reducescatter"))
          and local["record"]["tier"] == "local"
          and local["record"]["algo"] == "nccl",
          f"the local group on the card: {local}")
    check(all(h["equal"] and h["n_local"] == 1
              and h["info"]["tier"] == "local+dcn" for h in hier),
          f"the hierarchical allreduce: {hier}")
    check(not left, f"processes after the phase: {left}")
    return rec


# -- data-parallel llama2-1b over DCN, with a severed peer ------------------
DCN_WORKERS = 2
DCN_ROWS = TRAIN_BATCH // DCN_WORKERS     # 4 x 1024 a rank
DCN_STEPS, DCN_SAVE_AT, DCN_SEVER_AT = 4, 2, 3   # 1-based steps
DCN_BF16_REL_L2 = 2e-2   # the reduced mean against one process's gradient
DCN_F32_REL_L2 = 1e-5
DCN_LOSS_RTOL = 1e-5


def _rel_l2(got, want) -> float:
    num = sum(float((a.float() - b.float()).pow(2).sum())
              for a, b in zip(got, want))
    den = sum(float(b.float().pow(2).sum()) for b in want)
    return (num / den) ** 0.5


def _dcn_narrow_check(rank, device) -> dict:
    """A narrow f32 llama on the card: the mean of the ranks' reduced
    gradients against one process's gradient over the whole batch."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import configs, init_params, loss_fn

    cfg = dataclasses.replace(configs.llama2_1b, d_model=256, n_heads=2,
                              n_kv_heads=2, d_ff=688, n_layers=2,
                              vocab_size=4096, max_seq=256,
                              dtype=torch.float32, remat=False)
    params = init_params(cfg, seed=SEED + 3, device=device)
    leaves = _flat_params(params)
    for t in leaves:
        t.requires_grad_(True)
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    tokens = torch.randint(0, cfg.vocab_size, (8, 257), generator=gen,
                           device=device)
    rows = tokens[4 * rank:4 * rank + 4]
    grads = torch.autograd.grad(loss_fn(params, rows, cfg), leaves)
    reduced = train.allreduce_gradients(list(grads), "train_dp")
    out = {"devices": sorted({str(t.device) for t in reduced})}
    if rank == 0:
        full = torch.autograd.grad(loss_fn(params, tokens, cfg), leaves)
        out["rel_l2"] = _rel_l2(reduced, full)
        out["max_abs_err"] = max(float((a - b).abs().max())
                                 for a, b in zip(reduced, full))
    return out


def _train_dcn_loop(config):
    """phase_train's model (llama2-1b, bf16, dots_nobatch, seed, AdamW) on
    DCN_WORKERS ranks sharing the one card: each takes its 4 rows of one
    8 x 1024 batch, every step; gradients cross "train_dp" through
    allreduce_gradients(grads, "train_dp"). Checkpointed after step
    DCN_SAVE_AT; at step DCN_SEVER_AT of gang epoch 0 rank 1 severs its
    link to rank 0 before the allreduce. Every rank logs its losses and
    what its collective ops did to a file."""
    loop_start = time.time()
    import dataclasses
    import json
    import os
    import socket

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch._private import chaos
    from ray_tpu_torch.exceptions import CollectiveTimeoutError
    from ray_tpu_torch.models import configs, init_params, loss_fn
    from ray_tpu_torch.train import Checkpoint
    from ray_tpu_torch.train.torch import get_device
    from ray_tpu_torch.util import collective as col
    from ray_tpu_torch.util.collective import collective as col_mod
    from ray_tpu_torch.util.collective import dcn_group

    device = get_device()
    rank = train.get_world_rank()
    group = col_mod._manager.get("train_dp")
    epoch = group.epoch

    def log(rec):
        with open(os.path.join(config["dir"], f"rank{rank}.jsonl"), "a") as f:
            f.write(json.dumps(dict(rec, epoch=epoch, rank=rank)) + "\n")

    seen = []
    col.add_op_observer(lambda op, s, info=None: seen.append(
        (op, s, (info or {}).get("bytes", 0))))
    info = {"pid": os.getpid(), "device": str(device),
            "loop_start_wall": loop_start,
            "device_name": torch.cuda.get_device_name(device),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "world": group.world_size, "epoch": epoch,
            "op_timeout_s": group._op_timeout}
    ckpt = train.get_checkpoint()
    if ckpt is None:
        info["narrow_f32"] = _dcn_narrow_check(rank, device)
        torch.cuda.empty_cache()
    else:
        # The fence: an ident frame of the torn-down epoch is refused.
        s = socket.create_connection(tuple(group.addr), timeout=5)
        ident = dcn_group._IDENT.pack(1 - rank, epoch - 1, 0, 0)
        s.sendall(dcn_group._LEN.pack(len(ident)) + ident)
        s.settimeout(5)
        try:
            info["stale_ident_refused"] = s.recv(1) == b""
        except OSError:
            info["stale_ident_refused"] = True
        s.close()
    cfg = dataclasses.replace(configs.llama2_1b, max_seq=TRAIN_SEQ,
                              remat=True, remat_policy="dots_nobatch")
    counters = _train_launch_counters()
    if ckpt is None:
        params, start = init_params(cfg, seed=SEED, device=device), 0
    else:
        state = ckpt.to_pytree()
        params, start = state["params"], state["step"]
    leaves = _flat_params(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    if ckpt is not None:
        opt.load_state_dict(state["opt"])
        del state
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    batch = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                          generator=gen, device=device)
    rows = batch[DCN_ROWS * rank:DCN_ROWS * (rank + 1)]
    full = None
    if ckpt is None and rank == 0:
        # One process's gradient over the whole 8 x 1024 batch, from the
        # initial weights, before the first step.
        full = torch.autograd.grad(loss_fn(params, batch, cfg), leaves)
        torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves)
    tokens = DCN_ROWS * TRAIN_SEQ
    prof = train.StepProfiler(flops_per_step=6.0 * n_params * tokens)
    torch.cuda.reset_peak_memory_stats(device)
    for i in range(start, DCN_STEPS):
        step_no = i + 1
        for fn in counters.values():
            fn.launches = 0
        first = len(seen)
        ck, vs_full = None, None
        t0 = time.perf_counter()
        with prof.step(tokens=tokens) as s:
            with prof.phase("compute"):
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(params, rows, cfg)
                loss.backward()
            s.fence(loss)
            loss_v = loss.item()
            log({"step": step_no, "loss": loss_v})
            grads = [t.grad for t in leaves]
            if step_no == DCN_SEVER_AT and epoch == 0:
                if rank == 1:
                    chaos.enable()
                    chaos.sever_dcn_peer(0, "train_dp")
                    log({"severed": 0})
                t1 = time.perf_counter()
                try:
                    grads = train.allreduce_gradients(grads, "train_dp")
                except CollectiveTimeoutError as e:
                    log({"timeout_s": time.perf_counter() - t1,
                         "peer": e.peer_rank, "error": str(e)[:300],
                         "op_timeout_s": group._op_timeout})
                    raise
                raise RuntimeError("the allreduce after the sever completed")
            grads = train.allreduce_gradients(grads, "train_dp")
            with prof.phase("compute"):
                for t, g in zip(leaves, grads):
                    t.grad = g
                opt.step()
            s.fence(leaves[0])
            step_s = time.perf_counter() - t0
            launches = {n: fn.launches for n, fn in counters.items()}
            if full is not None:
                vs_full = {"rel_l2": _rel_l2(grads, full),
                           "max_abs_err": max(
                               float((a.float() - b.float()).abs().max())
                               for a, b in zip(grads, full))}
                full = None
            if step_no == DCN_SAVE_AT and rank == 0:
                with prof.phase("checkpoint"):
                    ck = Checkpoint.from_pytree(
                        {"params": params, "opt": opt.state_dict(),
                         "step": step_no},
                        os.path.join(train.get_trial_dir(),
                                     f"step_{step_no}"))
        rec = prof.records()[-1]
        ops = seen[first:]
        metrics = {"step": step_no, "loss": loss_v, "step_s": step_s,
                   "launches": launches, "epoch": epoch,
                   "first_of_attempt": i == start,
                   "collective_s": rec.get("collective_s"),
                   "observed_s": sum(o[1] for o in ops),
                   "observed_ops": len(ops),
                   "dcn_bytes": sum(o[2] for o in ops),
                   "wall_s": rec.get("wall_s"),
                   "peak_memory": torch.cuda.max_memory_allocated(device)}
        if vs_full is not None:
            metrics["vs_one_process"] = vs_full
        if i == start:
            metrics["info"] = info
        log({"metrics": metrics})
        train.report(metrics, checkpoint=ck)


def phase_train_dcn(train_rec, device_name):
    import gc
    import os
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig,
                                     RunConfig, ScalingConfig, TorchConfig,
                                     TorchTrainer)

    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="rt_train_dcn_")
    rt.init(num_cpus=4)
    try:
        trainer = TorchTrainer(
            _train_dcn_loop, train_loop_config={"dir": tmp},
            backend_config=TorchConfig(backend="gloo", dp_sync="dcn"),
            scaling_config=ScalingConfig(num_workers=DCN_WORKERS,
                                         use_gpu=True,
                                         gpus_per_worker=1.0 / DCN_WORKERS),
            run_config=RunConfig(
                name="llama2_1b_dcn", storage_path=tmp,
                failure_config=FailureConfig(max_failures=1, backoff_s=0),
                checkpoint_config=CheckpointConfig(num_to_keep=1)))
        t0 = time.time()
        result = trainer.fit()
        fit_s = time.time() - t0
        _wait_gpu(rt, 1.0, "the GPU was not back at 1.0 after the fit")
    finally:
        rt.shutdown()
    left, _ = _stop_runtime()
    logs = {}
    for r in range(DCN_WORKERS):
        with open(os.path.join(tmp, f"rank{r}.jsonl")) as f:
            logs[r] = [json.loads(ln) for ln in f]
    shutil.rmtree(tmp, ignore_errors=True)
    kernels = _kernels_at(DCN_ROWS * TRAIN_SEQ, 2048,
                          (DCN_ROWS, TRAIN_SEQ, 16, 128))

    check(result.error is None, f"the fit failed: {result.error}")
    steps = {r: [m["metrics"] for m in logs[r] if "metrics" in m]
             for r in logs}
    losses = {r: [(m["epoch"], m["step"], m["loss"]) for m in logs[r]
                  if "loss" in m] for r in logs}
    timeouts = [m for m in logs[0] if "timeout_s" in m]
    first = {r: steps[r][0]["info"] for r in steps}
    restarted = {r: next(m["info"] for m in steps[r]
                         if m["epoch"] == 1 and "info" in m) for r in steps}
    predicted = _predicted_launches(train_rec["n_layers"])
    bad = [(r, m["epoch"], m["step"], m["launches"]) for r in steps
           for m in steps[r] if m["launches"] != predicted]
    before = {s: l for e, s, l in losses[0] if e == 0}
    after = {s: l for e, s, l in losses[0] if e == 1}
    repeated = [{"step": s, "before_sever": before[s], "after_restart": l,
                 "rel": abs(l - before[s]) / abs(before[s])}
                for s, l in after.items() if s in before]
    timed = [m for m in steps[0] if not m["first_of_attempt"]]
    timed = timed or steps[0]

    def med(key):
        xs = sorted(m[key] for m in timed)
        return xs[len(xs) // 2]

    step_ms = med("step_s") * 1e3
    coll_s = med("collective_s")
    grad_bytes = 2 * train_rec["params"]
    vs_full = next(m["vs_one_process"] for m in steps[0]
                   if "vs_one_process" in m)
    rec = {"phase": "train_dcn", "card": device_name, "model": "llama2-1b",
           "dtype": "bfloat16", "workers": DCN_WORKERS,
           "rows_per_rank": DCN_ROWS, "seq": TRAIN_SEQ,
           "backend": "gloo process group + DCN group 'train_dp'",
           "fit_s": fit_s, "step_ms_median": step_ms,
           "phase_train_step_ms_median": train_rec["step_ms_median"],
           "collective_s_median": coll_s,
           "collective_share": coll_s / (step_ms / 1e3),
           "dcn_bytes_per_step_rank0": med("dcn_bytes"),
           "dcn_gb_s": med("dcn_bytes") / coll_s / 1e9,
           "gradient_bytes": grad_bytes,
           "gradient_bus_gb_s": grad_bytes / coll_s / 1e9,
           "peak_memory_by_rank": {r: max(m["peak_memory"] for m in steps[r])
                                   for r in steps},
           "steps": {r: [(m["epoch"], m["step"]) for m in steps[r]]
                     for r in steps},
           "losses_rank0": losses[0], "losses_repeated": repeated,
           "timeout": timeouts, "vs_one_process_bf16": vs_full,
           "narrow_f32": first[0]["narrow_f32"],
           "stale_ident_refused": restarted[0].get("stale_ident_refused"),
           "epochs": [first[0]["epoch"], restarted[0]["epoch"]],
           "launches_per_step": steps[0][0]["launches"],
           "launches": {k: sum(m["launches"][k] for r in steps
                               for m in steps[r]) for k in predicted},
           "kernels_at_dp_shape": kernels, "procs_left": left}
    emit(rec)
    print(json.dumps({"train_dcn_numbers": {
        k: rec[k] for k in ("step_ms_median", "collective_share",
                            "dcn_gb_s", "gradient_bus_gb_s",
                            "peak_memory_by_rank", "timeout")}}),
          flush=True)
    check(not bad, f"launches per step differ from {predicted}: {bad}")
    check(all(m["collective_s"] > 0 and m["collective_s"]
              == m["observed_s"] for r in steps for m in steps[r]),
          "the flight recorder's collective share differs from the ops "
          "the observer saw")
    check(timeouts and timeouts[0]["timeout_s"] <= timeouts[0]["op_timeout_s"]
          and timeouts[0]["peer"] == 1,
          f"rank 0's op after the sever: {timeouts}")
    check(rec["epochs"] == [0, 1], f"gang epochs {rec['epochs']}")
    check(rec["stale_ident_refused"] is True,
          "an ident frame of epoch 0 was not refused at epoch 1")
    check(len(repeated) == 1 and repeated[0]["step"] == DCN_SEVER_AT
          and all(v["rel"] <= DCN_LOSS_RTOL for v in repeated),
          f"the repeated step's loss differs: {repeated}")
    all_losses = [l for _, _, l in losses[0]]
    check(all(np.isfinite(all_losses)), f"a loss is not finite: {losses}")
    check(after[DCN_STEPS] < before[1],
          f"the loss did not fall on the batch trained on: {losses[0]}")
    check(vs_full["rel_l2"] <= DCN_BF16_REL_L2,
          f"the reduced bf16 gradient against one process's: {vs_full}")
    narrow = first[0]["narrow_f32"]
    check(narrow["rel_l2"] <= DCN_F32_REL_L2
          and narrow["devices"] == ["cuda:0"],
          f"the narrow f32 reduced gradient: {narrow}")
    check(not left, f"processes after the phase: {left}")
    return rec


# -- tensor-parallel serving ---------------------------------------------
SERVE_TP_APP = "llm_tp"
TP_NEW_TOKENS = 16


def _llama_mesh_loader(seed: int):
    """A loader that returns (params, cfg, mesh): llama3-8b at full width
    and depth on a one-rank NCCL mesh it builds in the replica."""
    def load():
        import tempfile

        import torch
        import torch.distributed as dist

        from ray_tpu_torch.models import configs, init_params
        from ray_tpu_torch.models.transformer import param_logical_axes
        from ray_tpu_torch.parallel import (MeshConfig, build_mesh,
                                            shard_params)

        torch.backends.cuda.matmul.allow_tf32 = False
        if not dist.is_initialized():
            torch.cuda.set_device(0)
            rdzv = tempfile.mkdtemp(prefix="rt_tp1_")
            dist.init_process_group("nccl", init_method=f"file://{rdzv}/r",
                                    rank=0, world_size=1)
        mesh = build_mesh(MeshConfig(tp=1), "cuda")
        cfg = configs.llama3_8b
        params = shard_params(init_params(cfg, seed=seed, device="cuda"),
                              param_logical_axes(cfg), mesh)
        return params, cfg, mesh
    return load


def _tp_cfg():
    """A narrow f32 model of llama3-8b's layout (GQA, 4 KV heads)."""
    import torch

    from ray_tpu_torch.models import configs

    return dataclasses.replace(configs.llama3_8b, d_model=512, n_heads=8,
                               n_kv_heads=4, d_ff=1536, n_layers=4,
                               vocab_size=8192, max_seq=512,
                               dtype=torch.float32)


TP_ENGINE_KW = {"num_slots": 4, "max_len": 256, "prefill_chunk": 64,
                "kv_mode": "paged", "page_size": 16}

TP_RANK_MAIN = r"""
import json, sys, time
import torch, torch.distributed as dist
sys.path.insert(0, sys.argv[5])
import chip_smoke as cs
from ray_tpu_torch.models import init_params
from ray_tpu_torch.models.transformer import param_logical_axes
from ray_tpu_torch.parallel import MeshConfig, build_mesh, shard_params
from ray_tpu_torch.serve.llm import ContinuousBatchingEngine

rank, world, rdzv, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                        world_size=world)
torch.cuda.set_device(0)
# gloo on card tensors, for each op the engine uses.
x = torch.full((4,), float(rank + 1), device="cuda")
dist.all_reduce(x)
b = torch.full((3,), float(rank), dtype=torch.float64, device="cuda")
dist.broadcast(b, src=0)
probe = {"all_reduce": x.tolist(), "broadcast": b.tolist(),
         "device": str(x.device)}
mesh = build_mesh(MeshConfig(tp=world), "cpu")
cfg = cs._tp_cfg()
params = shard_params(init_params(cfg, seed=cs.SEED, device="cuda"),
                      param_logical_axes(cfg), mesh)
eng = ContinuousBatchingEngine(params, cfg, mesh=mesh, **cs.TP_ENGINE_KW)
rec = {"probe": probe, "kv_heads": int(eng._k.shape[3]),
       "device": str(eng._k.device)}
if rank == 0:
    prompts = cs._tp_prompts(cfg)
    t0 = time.perf_counter()
    hs = [eng.submit(p, cs.TP_NEW_TOKENS) for p in prompts]
    rec["tokens"] = [h.result(timeout=600) for h in hs]
    rec["window_s"] = time.perf_counter() - t0
    st = eng.stats()
    eng.shutdown()
    rec["step_ms"] = cs._step_ms(st)
else:
    assert eng.wait(900), "the follower never saw STOP"
rec["forward_passes"] = eng._forward_passes
with open(out, "w") as f:
    json.dump(rec, f)
dist.destroy_process_group()
"""


def _tp_prompts(cfg):
    rng = np.random.default_rng(SEED + 9)
    return [rng.integers(0, cfg.vocab_size, size=n).tolist()
            for n in (5, 17, 64, 100, 130, 33)]


def _step_ms(st) -> float:
    t = st["timing"]
    return ((t["dispatch_ms_total"] + t["fetch_ms_total"]
             + t["host_ms_total"]) / max(1, t["steps_timed"]))


def _serve_tp_narrow(tmp) -> dict:
    """The narrow f32 model at tp=2: two processes on the one card over
    gloo, against the mesh-less engine in this process."""
    import os

    import torch

    from ray_tpu_torch.models import init_params
    from ray_tpu_torch.serve.llm import ContinuousBatchingEngine

    cfg = _tp_cfg()
    eng = ContinuousBatchingEngine(init_params(cfg, seed=SEED,
                                               device="cuda"),
                                   cfg, **TP_ENGINE_KW)
    try:
        t0 = time.perf_counter()
        hs = [eng.submit(p, TP_NEW_TOKENS) for p in _tp_prompts(cfg)]
        ref = [h.result(timeout=600) for h in hs]
        ref_window = time.perf_counter() - t0
        st = eng.stats()
    finally:
        eng.shutdown()
    del eng
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(tmp, "tp_rank.py")
    with open(script, "w") as f:
        f.write(TP_RANK_MAIN)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    procs = []
    for rank in range(2):
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, script, str(rank), "2",
                 os.path.join(tmp, "rdzv"),
                 os.path.join(tmp, f"rank{rank}.json"), here],
                cwd=here, env=env, stdout=subprocess.DEVNULL, stderr=err))
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        with open(os.path.join(tmp, f"rank{rank}.err")) as f:
            err = f.read()
        check(p.returncode == 0, f"tp rank {rank} exited {p.returncode}: "
              f"{err[-3000:]}")
    ranks = []
    for rank in range(2):
        with open(os.path.join(tmp, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    return {"ref_tokens": ref, "ref_window_s": ref_window,
            "ref_step_ms": _step_ms(st), "ranks": ranks}


def phase_serve_tp(slice_step_ms, device_name):
    import gc
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import configs, init_params
    from ray_tpu_torch.serve.llm import LLMReplica

    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.llama3_8b
    engine_kw = {"num_slots": 8, "max_len": 2048, "prefill_chunk": 64,
                 "kv_mode": "paged", "page_size": 16}
    new_tokens = 16
    per_pass = 2 * cfg.n_layers + 1
    rng = np.random.default_rng(SEED)
    prompts, shared_a, shared_b = _shared_prompts(rng, cfg.vocab_size)
    requests = prompts + [shared_a, shared_b]
    # The mesh-less engine's greedy tokens on the ten requests.
    params = init_params(cfg, seed=SEED, device="cuda")
    rep = LLMReplica(lambda: (params, cfg), **engine_kw)
    try:
        hs = [rep.engine.submit(p, new_tokens) for p in requests]
        ref = [h.result(timeout=600) for h in hs]
        ref_st = rep.engine.stats()
    finally:
        rep.shutdown()
    del params, rep, hs
    gc.collect()
    torch.cuda.empty_cache()
    replica_cls = _serve_replica_cls()
    rt.init(num_cpus=4)
    try:
        serve.start(port=0)
        t0 = time.perf_counter()
        h = serve.run(_serve_app(_llama_mesh_loader(SEED), replica_cls,
                                 **engine_kw), name=SERVE_TP_APP)
        info = h.options(method_name="info").remote().result(timeout=900)
        ready_s = time.perf_counter() - t0
        # The main path starts here: the replica's count at 0.
        h.options(method_name="reset_counts").remote().result(timeout=120)
        t0 = time.perf_counter()
        resps = [h.remote(p, new_tokens) for p in requests]
        outs = [r.result(timeout=600) for r in resps]
        window_s = time.perf_counter() - t0
        counts = h.options(method_name="counts").remote().result(timeout=120)
        st = h.options(method_name="stats").remote().result(timeout=60)
        serve.shutdown()
        _wait_gpu(rt, 1.0, "the GPU was not back after serve.shutdown()")
    finally:
        rt.shutdown()
    left, _ = _stop_runtime()
    tmp = tempfile.mkdtemp(prefix="rt_serve_tp_")
    try:
        narrow = _serve_tp_narrow(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0, r1 = narrow["ranks"]
    rec = {"phase": "serve_tp", "card": device_name, "model": "llama3-8b",
           "dtype": "bfloat16", "n_layers": cfg.n_layers,
           "tp1": {"requests": len(outs), "ready_s": ready_s,
                   "window_s": window_s,
                   "equal_to_meshless": outs == ref,
                   "finished": sum(len(o) == new_tokens for o in outs),
                   "decode_step_ms": _step_ms(st),
                   "meshless_step_ms": _step_ms(ref_st),
                   "slice_phase_step_ms": slice_step_ms,
                   "rmsnorm": counts, "device": info["device"]},
           "tp2_narrow": {"gloo_probe": [r0["probe"], r1["probe"]],
                          "kv_heads": [r0["kv_heads"], r1["kv_heads"]],
                          "devices": [r0["device"], r1["device"]],
                          "equal_to_tp1": r0["tokens"] == narrow[
                              "ref_tokens"],
                          "decode_step_ms": r0["step_ms"],
                          "tp1_step_ms": narrow["ref_step_ms"],
                          "window_s": r0["window_s"],
                          "tp1_window_s": narrow["ref_window_s"],
                          "forward_passes": [r0["forward_passes"],
                                             r1["forward_passes"]]},
           "procs_left": left}
    emit(rec)
    print(json.dumps({"serve_tp_numbers": {
        "tp1_decode_step_ms": rec["tp1"]["decode_step_ms"],
        "meshless_step_ms": rec["tp1"]["meshless_step_ms"],
        "slice_phase_step_ms": slice_step_ms,
        "tp2_narrow_step_ms": r0["step_ms"],
        "tp1_narrow_step_ms": narrow["ref_step_ms"]}}), flush=True)
    check(rec["tp1"]["finished"] == 10, f"tp=1: {rec['tp1']['finished']}/10")
    check(outs == ref, "tp=1 tokens differ from the mesh-less engine's")
    check(counts["forward_passes"] > 0 and counts["rmsnorm_launches"]
          == per_pass * counts["forward_passes"],
          f"rmsnorm launches in the tp=1 replica: {counts}")
    check(info["device"] == device_name and info["n_layers"] == cfg.n_layers
          and info["jax_or_ray_tpu_modules"] == [], f"the replica: {info}")
    check(r0["probe"]["all_reduce"] == [3.0] * 4
          and r1["probe"]["broadcast"] == [0.0] * 3
          and r0["probe"]["device"] == "cuda:0",
          f"gloo on card tensors: {rec['tp2_narrow']['gloo_probe']}")
    check(rec["tp2_narrow"]["kv_heads"] == [2, 2]
          and rec["tp2_narrow"]["devices"] == ["cuda:0", "cuda:0"],
          f"the tp=2 KV pools: {rec['tp2_narrow']}")
    check(rec["tp2_narrow"]["equal_to_tp1"],
          f"tp=2 tokens {r0['tokens']} differ from tp=1's "
          f"{narrow['ref_tokens']}")
    check(r0["forward_passes"] == r1["forward_passes"] > 0,
          f"the follower's passes {r1['forward_passes']} against the "
          f"leader's {r0['forward_passes']}")
    check(not left, f"processes after the phase: {left}")
    return counts["rmsnorm_launches"]


# -- rl: PPO on Nature-CNN frames from learner actors on the card ----------

RL_FRAME = (84, 84, 4)      # Atari's frame stack, the newest frame last
RL_ACTIONS = 6
RL_EPISODE = 20
RL_RANDOM_RETURN = RL_EPISODE / RL_ACTIONS  # a uniform policy's expectation
# The best mean return must beat the random expectation by this: a
# reported mean covers the last 20 episodes of each of 4 runners, 1,600
# steps, whose standard deviation under a uniform policy is
# sqrt(20 * (1/6) * (5/6) / 80) = 0.19, so 1.0 is over 5 of them. PPO's
# clip bounds how far one iteration moves the policy: at 1,000 frames a
# runner the second iteration's rollouts returned about 5.1-5.4, the
# third's about 6.5.
RL_MARGIN = 1.0
RL_ENOUGH = RL_RANDOM_RETURN + RL_MARGIN  # stop iterating once it holds
# 2,000 frames an iteration: 500 a runner (1,000 until the rl2 phase
# came; the depth cut that keeps the script inside its time limit).
RL_RUNNERS, RL_ROLLOUT = 4, 500
RL_MINIBATCH, RL_EPOCHS = 128, 10
RL_MIN_ITERS, RL_MAX_ITERS = 2, 8
RL_PPO_BUDGET_S = 150.0     # no new iteration once PPO's took this long
RL_LR = 1e-3
RL_PARITY_BATCH = 32
RL_PARITY_TOL = 1e-4        # rtol = atol, card against CPU, f32, TF32 off
RL_TWO_LEARNERS_REL_L2 = 1e-5
RL_TWO_LEARNER_UPDATES = 5
# A rollout is 500 f32 frame stacks (56 MB), four at once: the store
# holds an iteration's rollouts without spilling.
RL_STORE_BYTES = 2 * 2**30


class FrameSideEnv:
    """A synthetic Atari-shaped env (ale-py and its ROMs are not
    installed): 84 x 84 frames stacked 4 deep, the newest last. A
    bright bar, 12 pixels wide and the frame's height, lies in one of 6
    vertical strips of the newest frame (the older frames hold earlier
    bars) and the action must name the strip for +1. Episodes are 20
    steps: a uniform policy's expected return is 20/6 = 3.33, a policy
    that reads the newest frame earns up to 20.

    The background is dim noise, as a game's is never blank: on frames
    of exact zeros the card's f32 convolution (cuDNN's algorithms for the
    3 x 3 layer) returns rounding-sized values where the exact output is
    0, so a ReLU's gradient passes where the CPU's is cut, and the third
    layer's bias gradient moved by 0.046 of 0.15 (f64 agrees exactly)."""

    def __init__(self, seed=None):
        self._rng = np.random.default_rng(seed)
        self._stack = np.zeros(RL_FRAME, np.float32)
        self._t = 0
        self._strip = 0

    def _push(self):
        h, w, _ = RL_FRAME
        strip_w = w // RL_ACTIONS
        self._strip = int(self._rng.integers(RL_ACTIONS))
        col = self._strip * strip_w + int(self._rng.integers(
            0, strip_w - 12 + 1))
        frame = self._rng.uniform(0.0, 0.2, (h, w, 1)).astype(np.float32)
        frame[:, col:col + 12] = 1.0
        # A new array each step: runners keep the observations they ship.
        self._stack = np.concatenate([self._stack[..., 1:], frame], axis=-1)
        return self._stack

    def reset(self, *, seed=None, options=None):
        self._t = 0
        self._stack = np.zeros(RL_FRAME, np.float32)
        return self._push(), {}

    def step(self, action):
        reward = 1.0 if int(action) == self._strip else 0.0
        self._t += 1
        return self._push(), reward, self._t >= RL_EPISODE, False, {}


class StripEnv(FrameSideEnv):
    """FrameSideEnv's task with the strip as a one-hot vector: the MLP
    modules' observation (IMPALA's)."""

    def _push(self):
        self._strip = int(self._rng.integers(RL_ACTIONS))
        return np.eye(RL_ACTIONS, dtype=np.float32)[self._strip]


# -- rl2's envs: gymnasium is not installed on the card's machine ----------

PENDULUM_STEPS = 200          # Pendulum-v1's TimeLimit


class PendulumEnv:
    """Pendulum-v1 in numpy (gymnasium's classic-control dynamics: g 10,
    m 1, l 1, dt 0.05, max speed 8, max torque 2; reward -(theta^2 +
    0.1 theta_dot^2 + 0.001 u^2) on the normalized angle; truncated
    after 200 steps). The start state is uniform in [-pi, pi] x [-1, 1]
    from the env's generator, as gymnasium's np_random draws it."""

    g, m, l, dt = 10.0, 1.0, 1.0, 0.05
    max_speed, max_torque = 8.0, 2.0

    def __init__(self, seed=None):
        self._rng = np.random.default_rng(seed)
        self.state = np.zeros(2)
        self._t = 0

    def _obs(self):
        theta, thetadot = self.state
        return np.array([np.cos(theta), np.sin(theta), thetadot],
                        dtype=np.float32)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        high = np.array([np.pi, 1.0])
        self.state = self._rng.uniform(low=-high, high=high)
        self._t = 0
        return self._obs(), {}

    def step(self, u):
        th, thdot = self.state
        g, m, l, dt = self.g, self.m, self.l, self.dt
        u = np.clip(u, -self.max_torque, self.max_torque)[0]
        angle = ((th + np.pi) % (2 * np.pi)) - np.pi
        costs = angle ** 2 + 0.1 * thdot ** 2 + 0.001 * (u ** 2)
        newthdot = thdot + (3 * g / (2 * l) * np.sin(th)
                            + 3.0 / (m * l ** 2) * u) * dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * dt
        self.state = np.array([newth, newthdot])
        self._t += 1
        return self._obs(), -costs, False, self._t >= PENDULUM_STEPS, {}


class CueRecallEnv:
    """tests/test_rl.py's memory task: step 0 shows a cue (+1 or -1 in
    obs[0]); at the final step the action matching the cue earns +1. A
    memoryless policy cannot beat 0.5."""

    LEN = 4

    def __init__(self, seed=0):
        self._rng = np.random.default_rng(seed)
        self._t = 0
        self._cue = 1

    def _obs(self):
        o = np.zeros(3, dtype=np.float32)
        if self._t == 0:
            o[0] = float(self._cue)
        o[1] = (self.LEN - self._t) / self.LEN
        o[2] = 1.0 if self._t == self.LEN - 1 else 0.0
        return o

    def reset(self, *, seed=None, options=None):
        self._t = 0
        self._cue = 1 if self._rng.integers(2) else -1
        return self._obs(), {}

    def step(self, action):
        reward, done = 0.0, False
        if self._t == self.LEN - 1:
            reward = 1.0 if int(action) == (1 if self._cue > 0 else 0) else 0.0
            done = True
        self._t += 1
        return self._obs(), reward, done, False, {}


class MatchContextEnv:
    """tests/test_rl_extras.py's two-agent contextual bandit (a
    MultiAgentEnv by its interface): each agent sees a one-hot context
    and earns 1.0 for picking the hot index; episodes run 8 steps."""

    agent_ids = ("a0", "a1")

    def __init__(self, seed=0, horizon=8):
        self.rng = np.random.default_rng(seed)
        self.horizon = horizon
        self.t = 0

    def _obs(self):
        out = {}
        for aid in self.agent_ids:
            ctx = np.zeros(3, dtype=np.float32)
            ctx[self.rng.integers(0, 3)] = 1.0
            out[aid] = ctx
        self._current = out
        return out

    def reset(self):
        self.t = 0
        return self._obs(), {}

    def step(self, action_dict):
        rewards = {
            aid: float(action_dict[aid] == int(np.argmax(self._current[aid])))
            for aid in self.agent_ids
        }
        self.t += 1
        done = self.t >= self.horizon
        obs = self._obs() if not done else self._current
        terms = {aid: done for aid in self.agent_ids}
        terms["__all__"] = done
        truncs = {aid: False for aid in self.agent_ids}
        truncs["__all__"] = False
        return obs, rewards, terms, truncs, {}


def _rl_spec():
    from ray_tpu_torch.models.conv import ATARI_FILTERS
    from ray_tpu_torch.rl import ConvModuleSpec

    # ppo.py's conv module: feature 128, hidden = config.hidden[-1:].
    return ConvModuleSpec(RL_FRAME, RL_ACTIONS, conv_filters=ATARI_FILTERS,
                          feature_dim=128, hidden=(64,))


def _rl_frames(n, seed):
    env = FrameSideEnv(seed)
    obs, _ = env.reset()
    frames = []
    for _ in range(n):
        frames.append(obs)
        obs = env.step(0)[0]
    return np.stack(frames)


def _rl_batch(n, seed):
    """A PPO minibatch of real frames; the second half carries the first
    half's advantages reversed, so per-shard advantage normalisation over
    two halves equals the whole batch's."""
    rng = np.random.default_rng(seed)
    adv = rng.normal(size=n).astype(np.float32)
    adv[n // 2:] = adv[:n // 2][::-1]
    return {"obs": _rl_frames(n, seed),
            "actions": rng.integers(0, RL_ACTIONS, n).astype(np.int32),
            "logp": np.full(n, -np.log(RL_ACTIONS), np.float32),
            "advantages": adv,
            "returns": rng.normal(size=n).astype(np.float32)}


def _rl_close(got, want, tol) -> dict:
    got = got.detach().double().cpu()
    want = want.detach().double().cpu()
    err = (got - want).abs()
    return {"max_abs_err": float(err.max()),
            "ok": bool((err <= tol + tol * want.abs()).all())}


def _rl_parity() -> dict:
    """The Nature-CNN policy on the card against the CPU: logits, values,
    the PPO loss and every gradient (f32, TF32 off)."""
    import torch

    from ray_tpu_torch.rl import ConvPolicyModule, ppo_loss

    spec = _rl_spec()
    cpu = ConvPolicyModule(spec).init(SEED)
    card = ConvPolicyModule(spec).to("cuda")
    card.set_weights(cpu.get_weights())
    b = _rl_batch(RL_PARITY_BATCH, SEED)
    out = {}
    for name, mod, dev in (("cpu", cpu, "cpu"), ("card", card, "cuda")):
        tb = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        fwd = mod(tb["obs"])
        loss, _ = ppo_loss(mod, tb)
        grads = torch.autograd.grad(loss, list(mod.parameters()))
        out[name] = (fwd, loss, grads)
    (cf, cl, cg), (gf, gl, gg) = out["cpu"], out["card"]
    res = {"logits": _rl_close(gf["action_logits"], cf["action_logits"],
                               RL_PARITY_TOL),
           "values": _rl_close(gf["value"], cf["value"], RL_PARITY_TOL),
           "loss": _rl_close(gl, cl, RL_PARITY_TOL)}
    names = [k for k, _ in card.named_parameters()]
    res["grads"] = {n: _rl_close(g, c, RL_PARITY_TOL)
                    for n, g, c in zip(names, gg, cg)}
    return res


def _rl_learner_info(learner):
    """Runs in a learner's process: where its tensors live, its peak card
    memory, its precision flags and its kernel launch counts."""
    import torch

    devices = {str(p.device) for p in learner.module.parameters()}
    devices |= {str(v.device) for st in learner.optimizer.state.values()
                for v in st.values()
                if torch.is_tensor(v) and v.dim() > 0}
    cuda = learner.device.type == "cuda"
    return {"device": str(learner.device), "tensor_devices": sorted(devices),
            "peak_memory": (torch.cuda.max_memory_allocated(learner.device)
                            if cuda else 0),
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "launches": {k: fn.launches
                         for k, fn in _train_launch_counters().items()}}


def _rl_profile(learner):
    from ray_tpu_torch.train.flight_recorder import StepProfiler

    learner.profiler = StepProfiler(rank=0, emit_metrics=False)
    return True


def _rl_records(learner):
    return learner.profiler.drain_records()


def _rl_f32(learner):
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return True


def _rl_weights(learner):
    return learner.get_weights()


def _rl_reduced_grads(learner, batch):
    """Runs in each learner of a group: this rank's half of `batch`, its
    gradient, and the mean over the group through the DCN allreduce the
    update uses; the flat f64 vector."""
    from ray_tpu_torch.rl.core.learner_group import _split_batch
    from ray_tpu_torch.util import collective as col

    n = col.get_collective_group_size("learner_group")
    shard = _split_batch(batch, n)[col.get_rank("learner_group")]
    grads, _ = learner.compute_gradients(shard)
    return np.concatenate([
        (col.allreduce(g, "learner_group") / n).double().cpu().numpy().ravel()
        for g in grads])


def _flat_weights(tree) -> np.ndarray:
    from ray_tpu_torch.rl.core.convert import flatten

    flat = flatten(tree)
    return np.concatenate([np.asarray(flat[k], np.float64).ravel()
                           for k in sorted(flat)])


def _weights_equal(a, b) -> bool:
    from ray_tpu_torch.rl.core.convert import flatten

    fa, fb = flatten(a), flatten(b)
    return set(fa) == set(fb) and all(np.array_equal(fa[k], fb[k])
                                      for k in fa)


def _med(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def _rl_ppo(rt, device) -> dict:
    """PPO from one learner actor on `device` with RL_RUNNERS CPU runners:
    per iteration the losses, the weights the runners hold after the
    broadcast, the learner's call split, its throughput and sampling."""
    from ray_tpu_torch.models.conv import ATARI_FILTERS
    from ray_tpu_torch.rl import PPOConfig

    t0 = time.perf_counter()
    algo = (PPOConfig()
            .environment(lambda: FrameSideEnv(), obs_shape=RL_FRAME,
                         num_actions=RL_ACTIONS, conv_filters=ATARI_FILTERS)
            .env_runners(num_env_runners=RL_RUNNERS,
                         rollout_length=RL_ROLLOUT)
            .training(lr=RL_LR, num_epochs=RL_EPOCHS,
                      minibatch_size=RL_MINIBATCH, device=device)
            .build())
    build_s = time.perf_counter() - t0
    lg = algo.learner_group
    try:
        lg.foreach_learner(_rl_profile)
        walls = []
        update = lg.update_from_batch

        def timed(batch):
            t0 = time.perf_counter()
            out = update(batch)
            walls.append(time.perf_counter() - t0)
            return out

        lg.update_from_batch = timed
        iters, records, call_walls = [], [], []
        start = time.perf_counter()
        for i in range(RL_MAX_ITERS):
            walls.clear()
            t0 = time.perf_counter()
            result = algo.train()
            it_s = time.perf_counter() - t0
            recs = lg.foreach_learner(_rl_records)[0]
            learner_w = lg.get_weights()
            runner_w = rt.get([r.get_weights.remote()
                               for r in algo.env_runners], timeout=300)
            losses = {k: v for k, v in result.items()
                      if k.startswith("learner/")}
            iters.append({
                "iteration": result["training_iteration"],
                "seconds": it_s, "updates": len(walls),
                "update_wall_s": sum(walls),
                "episode_return_mean": result["episode_return_mean"],
                "episodes_total": result["episodes_total"],
                "losses": losses,
                "finite": all(np.isfinite(v) for v in losses.values()),
                "runners_hold_learner_weights": all(
                    _weights_equal(w, learner_w) for w in runner_w)})
            records += recs
            call_walls += list(walls)
            print(f"rl: PPO iteration {i + 1}: {it_s:.2f} s, mean return "
                  f"{result['episode_return_mean']:.2f}", file=sys.stderr,
                  flush=True)
            if i + 1 >= RL_MIN_ITERS and (
                    result["episode_return_mean"] >= RL_ENOUGH
                    or time.perf_counter() - start >= RL_PPO_BUDGET_S):
                break
        t0 = time.perf_counter()
        rt.get([r.sample.remote() for r in algo.env_runners], timeout=600)
        sample_s = time.perf_counter() - t0
        info = lg.foreach_learner(_rl_learner_info)[0]
    finally:
        algo.stop()
    ship = [w - r["wall_s"] for w, r in zip(call_walls, records)]
    samples = RL_MINIBATCH * len(call_walls)
    return {
        "build_s": build_s,
        "iterations": iters,
        "best_mean_return": max(it["episode_return_mean"] for it in iters),
        "learner": info,
        "calls": len(call_walls), "records": len(records),
        "learner_samples_per_s": samples / sum(call_walls),
        "learner_samples_per_s_in_actor": samples / sum(
            r["wall_s"] for r in records),
        "call_split_ms_median": {
            "call": _med(call_walls) * 1e3,
            "ship": _med(ship) * 1e3,
            "h2d": _med([r["h2d_s"] for r in records]) * 1e3,
            "update": _med([r["compute_s"] for r in records]) * 1e3,
            "readback": _med([r["readback_s"] for r in records]) * 1e3},
        "minibatch_bytes": RL_MINIBATCH * int(np.prod(RL_FRAME)) * 4,
        "sampling_frames_per_s": RL_RUNNERS * RL_ROLLOUT / sample_s,
        "iteration_s_median": _med([it["seconds"] for it in iters])}


def _rl_two_learners(rt) -> dict:
    """Two learner actors at num_gpus=0.5 on the one card over the DCN
    group against one learner in this process: the same update from the
    same weights on the same batch (f32, TF32 off)."""
    import torch

    from ray_tpu_torch.rl import ConvPolicyModule, Learner, ppo_loss
    from ray_tpu_torch.rl.core.learner_group import LearnerGroup

    spec = _rl_spec()
    factory = lambda: ConvPolicyModule(spec)  # noqa: E731
    two = LearnerGroup(factory, ppo_loss, num_learners=2, seed=SEED,
                       lr=RL_LR)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    _rl_f32(None)  # this process's reference learner too
    try:
        flags = two.foreach_learner(_rl_f32)
        w0 = two.get_weights()
        two.set_weights(w0)
        b = _rl_batch(2 * RL_MINIBATCH, SEED + 1)
        ref = Learner(factory(), ppo_loss, seed=SEED, lr=RL_LR,
                      device="cuda")
        ref.set_weights(w0)
        # The gradient the update applies: each rank's half reduced over
        # the DCN group, against one learner's over the whole batch.
        import functools

        reduced = two.foreach_learner(functools.partial(_rl_reduced_grads,
                                                        batch=b))
        full, _ = ref.compute_gradients(b)
        full = np.concatenate([g.double().cpu().numpy().ravel()
                               for g in full])
        grad_rel = float(np.linalg.norm(reduced[0] - full)
                         / np.linalg.norm(full))
        ref_m = ref.update_from_batch(b)
        two_m = two.update_from_batch(b)
        ws = two.foreach_learner(_rl_weights)
        base = _flat_weights(w0)
        w_ref = _flat_weights(ref.get_weights())
        w_two = _flat_weights(ws[0])
        rel = float(np.linalg.norm(w_two - w_ref) / np.linalg.norm(w_ref))
        # Adam's first step is lr * g / (|g| + eps): elements whose
        # gradient sits at rounding level move by a rounding-sized share
        # of lr, so the step's own rel L2 is printed, not gated.
        d_ref, d_two = w_ref - base, w_two - base
        step_rel = float(np.linalg.norm(d_two - d_ref)
                         / np.linalg.norm(d_ref))
        two.foreach_learner(_rl_profile)
        for i in range(RL_TWO_LEARNER_UPDATES):
            two.update_from_batch(_rl_batch(2 * RL_MINIBATCH, SEED + 2 + i))
        recs = two.foreach_learner(_rl_records)
        info = two.foreach_learner(_rl_learner_info)
        after = two.foreach_learner(_rl_weights)
    finally:
        two.shutdown()
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    del ref
    torch.cuda.empty_cache()
    shares = [r["collective_s"] / r["wall_s"] for rr in recs for r in rr]
    return {"f32_flags_set": flags, "grad_rel_l2": grad_rel,
            "ranks_reduced_equal": bool(np.array_equal(reduced[0],
                                                       reduced[1])),
            "weights_rel_l2": rel, "step_rel_l2": step_rel,
            "loss_ref": ref_m["total_loss"], "loss_two": two_m["total_loss"],
            "weights_bit_equal": _weights_equal(ws[0], ws[1]),
            "weights_bit_equal_after": _weights_equal(after[0], after[1]),
            "collective_share_median": _med(shares),
            "update_ms_median": _med([r["wall_s"] for rr in recs
                                      for r in rr]) * 1e3,
            "collective_ms_median": _med([r["collective_s"] for rr in recs
                                          for r in rr]) * 1e3,
            "learners": info}


def _rl_impala(rt) -> dict:
    from ray_tpu_torch.rl import IMPALAConfig

    algo = (IMPALAConfig()
            .environment(lambda: StripEnv(), obs_dim=RL_ACTIONS,
                         num_actions=RL_ACTIONS)
            .env_runners(num_env_runners=2, rollout_length=64)
            .training(updates_per_iteration=4, rollouts_per_update=2)
            .build())
    try:
        t0 = time.perf_counter()
        result = algo.train()
        secs = time.perf_counter() - t0
        info = algo.learner_group.foreach_learner(_rl_learner_info)[0]
    finally:
        algo.stop()
    losses = {k: v for k, v in result.items() if k.startswith("learner/")}
    return {"seconds": secs, "losses": losses, "learner": info,
            "finite": bool(losses) and all(np.isfinite(v)
                                           for v in losses.values())}


def _rl_dqn(rt) -> dict:
    from ray_tpu_torch.models.conv import ATARI_FILTERS
    from ray_tpu_torch.rl import DQNConfig

    algo = (DQNConfig()
            .environment(lambda: FrameSideEnv(), obs_shape=RL_FRAME,
                         num_actions=RL_ACTIONS, conv_filters=ATARI_FILTERS)
            .env_runners(num_env_runners=2, rollout_length=256)
            .training(train_batch_size=32, updates_per_iteration=16,
                      learning_starts=512, buffer_capacity=1024,
                      double_q=True, prioritized_replay=True)
            .build())
    try:
        t0 = time.perf_counter()
        result = algo.train()
        secs = time.perf_counter() - t0
        info = algo.learner_group.foreach_learner(_rl_learner_info)[0]
        target = sorted({str(p.device) for net in (algo._target_net,
                                                    algo._online_net)
                         for p in net.parameters()})
    finally:
        algo.stop()
    losses = {k: v for k, v in result.items() if k.startswith("learner/")}
    return {"seconds": secs, "losses": losses, "learner": info,
            "target_net_devices": target,
            "buffer_size": result["buffer_size"],
            "finite": bool(losses) and all(np.isfinite(v)
                                           for v in losses.values())}


def phase_rl(device_name, smi):
    import gc

    import torch

    import ray_tpu_torch as rt

    gc.collect()
    torch.cuda.empty_cache()
    counters = _train_launch_counters()
    for fn in counters.values():
        fn.launches = 0
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        parity = _rl_parity()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    parity_s = time.perf_counter() - t0
    rt.init(num_cpus=8, object_store_memory=RL_STORE_BYTES)
    try:
        t0 = time.perf_counter()
        ppo = _rl_ppo(rt, None)
        ppo["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        two = _rl_two_learners(rt)
        two["seconds"] = time.perf_counter() - t0
        print(f"rl: two learners {two['seconds']:.2f} s", file=sys.stderr,
              flush=True)
        impala = _rl_impala(rt)
        dqn = _rl_dqn(rt)
        _wait_gpu(rt, 1.0, "the GPU was not back at 1.0 after the rl phase")
    finally:
        rt.shutdown()
    left, _ = _stop_runtime()
    launches = {k: fn.launches for k, fn in counters.items()}
    in_learners = {k: sum(x["learner"]["launches"][k]
                          for x in (ppo, impala, dqn))
                   + sum(x["launches"][k] for x in two["learners"])
                   for k in counters}
    rec = {"phase": "rl", "card": smi, "model": "Nature CNN (ATARI_FILTERS)",
           "frames": list(RL_FRAME), "actions": RL_ACTIONS,
           "parity": {"batch": RL_PARITY_BATCH, "tol": RL_PARITY_TOL,
                      "seconds": parity_s, **parity},
           "ppo": ppo, "two_learners": two, "impala": impala, "dqn": dqn,
           "precision": {"parity_and_two_learners": "f32, TF32 off",
                         "timed_ppo": "convolutions "
                         + ("TF32" if ppo["learner"]["cudnn_tf32"] else "f32")
                         + ", matmuls "
                         + ("TF32" if ppo["learner"]["matmul_tf32"]
                            else "f32")},
           "random_return": RL_RANDOM_RETURN, "margin": RL_MARGIN,
           "launches_driver": launches, "launches_learners": in_learners,
           "procs_left": left}
    emit(rec)
    print(json.dumps({"rl_numbers": {
        "card": smi,
        "learner_samples_per_s": ppo["learner_samples_per_s"],
        "learner_samples_per_s_in_actor":
            ppo["learner_samples_per_s_in_actor"],
        "call_split_ms_median": ppo["call_split_ms_median"],
        "sampling_frames_per_s": ppo["sampling_frames_per_s"],
        "iteration_s_median": ppo["iteration_s_median"],
        "peak_memory_learner": ppo["learner"]["peak_memory"],
        "best_mean_return": ppo["best_mean_return"],
        "two_learner_collective_share": two["collective_share_median"],
        "two_learner_update_ms": two["update_ms_median"]}}), flush=True)
    bad = {k: parity[k] for k in ("logits", "values", "loss")
           if not parity[k]["ok"]}
    bad.update({k: v for k, v in parity["grads"].items() if not v["ok"]})
    check(not bad, f"card against CPU beyond {RL_PARITY_TOL}: {bad}")
    check(all(it["finite"] for it in ppo["iterations"]),
          "PPO losses not finite")
    check(ppo["learner"]["device"].startswith("cuda")
          and all(d.startswith("cuda")
                  for d in ppo["learner"]["tensor_devices"]),
          f"the PPO learner's tensors: {ppo['learner']}")
    check(all(it["runners_hold_learner_weights"] for it in ppo["iterations"]),
          "a runner's weights differ from the learner's after a broadcast")
    check(ppo["best_mean_return"] >= RL_RANDOM_RETURN + RL_MARGIN,
          f"PPO's best mean return {ppo['best_mean_return']} is not "
          f"{RL_MARGIN} above a random policy's {RL_RANDOM_RETURN:.2f}")
    check(ppo["calls"] == ppo["records"] > 0,
          f"{ppo['calls']} learner calls, {ppo['records']} records")
    check(two["grad_rel_l2"] <= RL_TWO_LEARNERS_REL_L2
          and two["weights_rel_l2"] <= RL_TWO_LEARNERS_REL_L2
          and two["ranks_reduced_equal"],
          f"two learners against one: reduced gradient rel L2 "
          f"{two['grad_rel_l2']}, weights {two['weights_rel_l2']}")
    check(two["weights_bit_equal"] and two["weights_bit_equal_after"],
          "the two learners' weights differ")
    check(all(i["device"].startswith("cuda") for i in two["learners"]),
          f"the two learners: {two['learners']}")
    check(impala["finite"] and impala["learner"]["device"].startswith("cuda"),
          f"IMPALA: {impala}")
    check(dqn["finite"] and dqn["learner"]["device"].startswith("cuda")
          and all(d.startswith("cuda") for d in dqn["target_net_devices"]),
          f"DQN: {dqn}")
    check(not any(launches.values()) and not any(in_learners.values()),
          f"kernels launched on the rl path: {launches}, {in_learners}")
    check(not left, f"processes after the phase: {left}")
    return {k: launches[k] + in_learners[k] for k in launches}


# -- rl2: the RL stack's second half, SAC at published widths ---------------

# SAC and CQL: Haarnoja et al. 2018, "Soft Actor-Critic Algorithms and
# Applications", Table 1 (2 x 256 hidden, batch 256, lr 3e-4, tau
# 0.005, gamma 0.99); TD3: Fujimoto et al. 2018 (400-300 hidden);
# R2D2: Kapturowski et al. 2019's recurrent state of 512 (an LSTM there,
# the port's GRU here); CQL: Kumar et al. 2020's 10 candidate actions.
RL2_SAC_HIDDEN = (256, 256)
RL2_TD3_HIDDEN = (400, 300)
RL2_GRU = 512
RL2_CQL_CANDIDATES = 10
RL2_BATCH = 256
RL2_LR = 3e-4
RL2_TAU = 0.005
RL2_GAMMA = 0.99
RL2_SAC_STEPS = 400          # env steps and updates an iteration
RL2_SAC_MAX_ITERS = 24
RL2_SAC_ENOUGH = -400.0      # stop iterating once the best mean exceeds it
# The gate of tests/test_rl_extras.py::test_sac_pendulum_improves: the
# best mean return above -800 and at least 200 above the first
# (random-action) iteration's; a random Pendulum policy returns about
# -1,200 to -1,600 an episode.
RL2_SAC_GATE, RL2_SAC_GAIN = -800.0, 200.0
RL2_SAC_BUDGET_S = 90.0      # no new SAC iteration once it took this long
RL2_WARM_UPDATES = 3         # CPU updates before the card-vs-CPU update
RL2_CQL_ROWS = 2048
RL2_ITERS = 1                # of each other algorithm: the time limit


def _rl2_transitions(n, seed):
    """n Pendulum transitions under uniform random torques, with the
    normalized actions the runners store."""
    env = PendulumEnv(seed)
    obs, _ = env.reset()
    rng = np.random.default_rng(seed)
    out = {k: [] for k in ("obs", "actions", "rewards", "next_obs",
                           "dones")}
    for _ in range(n):
        a = rng.uniform(-1.0, 1.0, 1).astype(np.float32)
        nxt, r, term, trunc, _ = env.step(2.0 * a.astype(np.float64))
        for k, v in (("obs", obs), ("actions", a), ("rewards", r),
                     ("next_obs", nxt), ("dones", float(term))):
            out[k].append(v)
        obs = env.reset()[0] if term or trunc else nxt
    return {k: np.asarray(np.stack(v) if k in ("obs", "actions", "next_obs")
                          else v, np.float32) for k, v in out.items()}


def _rl2_windows(n, T, seed, state_dim):
    """n CueRecallEnv windows of T steps under random actions, with the
    zero state each starts from and returns-to-go for PPO's fields."""
    env = CueRecallEnv(seed)
    rng = np.random.default_rng(seed)
    obs = env.reset()[0]
    w = {k: [] for k in ("obs", "actions", "rewards", "dones")}
    for _ in range(n * T):
        a = int(rng.integers(2))
        nxt, r, term, _, _ = env.step(a)
        w["obs"].append(obs)
        w["actions"].append(a)
        w["rewards"].append(r)
        w["dones"].append(float(term))
        obs = env.reset()[0] if term else nxt
    b = {"obs": np.asarray(w["obs"], np.float32).reshape(n, T, 3),
         "actions": np.asarray(w["actions"], np.int32).reshape(n, T),
         "rewards": np.asarray(w["rewards"], np.float32).reshape(n, T),
         "dones": np.asarray(w["dones"], np.float32).reshape(n, T),
         "state0": np.zeros((n, state_dim), np.float32)}
    b["logp"] = np.full((n, T), -np.log(2.0), np.float32)
    b["advantages"] = rng.normal(size=(n, T)).astype(np.float32)
    b["returns"] = rng.normal(size=(n, T)).astype(np.float32)
    return b


def _rl2_learner_state(learner):
    from ray_tpu_torch.rl.core import convert

    return {"params": learner.get_weights(),
            "opt_state": convert.adam_to_jax(
                learner.optimizer, convert.flatten(learner.module.tree()))}


def _rl2_load_learner(learner, state):
    from ray_tpu_torch.rl.core import convert

    learner.set_weights(state["params"])
    convert.load_adam(learner.optimizer,
                      convert.flatten(learner.module.tree()),
                      state["opt_state"])


def _rl2_cases():
    """Each checked update: (name, make_state(device), update(state,
    batch, draws) -> metrics, to_jax(state), load(state, jax_state),
    batch (numpy), draws() -> CPU tensors)."""
    import torch

    from ray_tpu_torch.rl import offline
    from ray_tpu_torch.rl.algorithms import cql, r2d2, recurrent_ppo, sac, td3
    from ray_tpu_torch.rl.core import convert
    from ray_tpu_torch.rl.core.learner import Learner, adam, step
    from ray_tpu_torch.rl.core.rl_module import (ContinuousModuleSpec,
                                                 ContinuousPolicyModule,
                                                 DiscretePolicyModule,
                                                 RecurrentModuleSpec,
                                                 RecurrentPolicyModule,
                                                 RecurrentQNetworkModule,
                                                 RLModuleSpec)

    gen = torch.Generator().manual_seed(SEED)
    B, K = RL2_BATCH, RL2_CQL_CANDIDATES

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    def cont(hidden):
        return ContinuousModuleSpec(3, 1, -2.0, 2.0, hidden)

    def sac_state(device, hidden=RL2_SAC_HIDDEN):
        return sac.init_sac_state(ContinuousPolicyModule(cont(hidden)).init(
            SEED).to(device), RL2_LR)

    def td3_state(device):
        return td3.init_td3_state(td3.DeterministicPolicyModule(
            cont(RL2_TD3_HIDDEN)).init(SEED).to(device), RL2_LR)

    rspec = RecurrentModuleSpec(3, 2, state_dim=RL2_GRU, hidden=(RL2_GRU,))
    r2d2_loss = r2d2.r2d2_update_fn(RL2_GAMMA, 2)

    def r2d2_state(device):
        m = RecurrentQNetworkModule(rspec).init(SEED).to(device)
        return {"module": m,
                "target": RecurrentQNetworkModule(rspec).init(SEED + 1).to(
                    device).requires_grad_(False),
                "opt": adam(m.parameters(), RL2_LR)}

    def r2d2_update(st, batch, _):
        loss, metrics = r2d2_loss(st["module"], st["target"], batch)
        step(st["opt"], st["module"].parameters(), loss, r2d2.GRAD_CLIP)
        return metrics

    def r2d2_to_jax(st):
        return {"params": st["module"].get_weights(),
                "target": st["target"].get_weights(),
                "opt_state": convert.adam_to_jax(
                    st["opt"], convert.flatten(st["module"].tree()))}

    def r2d2_load(st, js):
        st["module"].set_weights(js["params"])
        st["target"].set_weights(js["target"])
        convert.load_adam(st["opt"], convert.flatten(st["module"].tree()),
                          js["opt_state"])

    def learner(module_cls, spec, loss):
        return lambda device: Learner(module_cls(spec), loss, seed=SEED,
                                      lr=RL2_LR, device=device)

    def learner_update(lr, batch, _):
        return {k: torch.as_tensor(v) for k, v in
                lr.update_from_batch(batch).items()}

    pspec = RecurrentModuleSpec(3, 2, state_dim=RL2_GRU // 2, hidden=(64,))
    dspec = RLModuleSpec(3, 2, RL2_SAC_HIDDEN)
    flat = _rl2_transitions(B, SEED + 5)
    windows = _rl2_windows(32, 16, SEED + 6, RL2_GRU)
    seqs = _rl2_windows(8, 32, SEED + 7, RL2_GRU // 2)
    off = {"obs": seqs["obs"].reshape(-1, 3)[:B],
           "actions": seqs["actions"].reshape(-1)[:B],
           "returns": seqs["returns"].reshape(-1)[:B]}
    sac_update = sac.make_sac_update(RL2_GAMMA, RL2_TAU, -1.0)
    cql_update = cql.make_cql_update(RL2_GAMMA, RL2_TAU, -1.0, 5.0, K)
    td3_update = td3.make_td3_update(RL2_GAMMA, RL2_TAU, 0.2, 0.5, 2)
    return [
        ("sac", sac_state, sac_update, sac.sac_state_to_jax,
         sac.load_sac_state, flat,
         lambda: {"next": randn(B, 1), "pi": randn(B, 1)}),
        ("cql", sac_state, cql_update, sac.sac_state_to_jax,
         sac.load_sac_state, flat,
         lambda: {"next": randn(B, 1), "pi": randn(B, 1),
                  "rand": torch.rand((K, B, 1), generator=gen) * 2 - 1,
                  "cur": randn(K, B, 1), "nxt": randn(K, B, 1)}),
        ("td3", td3_state, td3_update, td3.td3_state_to_jax,
         td3.load_td3_state, flat, lambda: randn(B, 1)),
        ("r2d2", r2d2_state, r2d2_update, r2d2_to_jax, r2d2_load,
         {k: windows[k] for k in ("obs", "actions", "rewards", "dones",
                                  "state0")}, lambda: None),
        ("recurrent_ppo", learner(RecurrentPolicyModule, pspec,
                                  recurrent_ppo.recurrent_ppo_loss),
         learner_update, _rl2_learner_state, _rl2_load_learner, seqs,
         lambda: None),
        ("bc", learner(DiscretePolicyModule, dspec, offline.bc_loss),
         learner_update, _rl2_learner_state, _rl2_load_learner,
         {k: off[k] for k in ("obs", "actions")}, lambda: None),
        ("marwil", learner(DiscretePolicyModule, dspec,
                           offline.marwil_loss(1.0)),
         learner_update, _rl2_learner_state, _rl2_load_learner, off,
         lambda: None),
    ]


def _rl2_moved(draws, device):
    import torch

    if draws is None or isinstance(draws, torch.Tensor):
        return None if draws is None else draws.to(device)
    return {k: v.to(device) for k, v in draws.items()}


def _rl2_parity() -> dict:
    """Each update of the second half on the card against the CPU, f32
    with TF32 off, from the same state on the same batch and draws. From
    the initial state: the metrics (losses) and every gradient, read as
    10 x Adam's first moment after its first step from zero (each
    optimizer's, the actor's, the critics' and the temperature's
    apart). Then the CPU state after RL2_WARM_UPDATES more updates loads
    into the card and one update on each gives the new parameters (and
    targets): from warm moments, so no element's step hangs on the sign
    of a gradient at rounding level, as Adam's first step does."""
    import torch

    from ray_tpu_torch.rl.core import convert
    from ray_tpu_torch.rl.core.learner import to_tensors

    res = {}
    for name, make, update, to_jax, load, batch, draws in _rl2_cases():
        cpu, card = make("cpu"), make("cuda")
        load(card, to_jax(cpu))
        tb = {d: to_tensors(batch, d) for d in ("cpu", "cuda")}
        d = draws()
        mc = update(cpu, tb["cpu"], d)
        mg = update(card, tb["cuda"], _rl2_moved(d, "cuda"))
        sc, sg = to_jax(cpu), to_jax(card)
        out = {"losses": {k: _rl_close(mg[k], mc[k], RL_PARITY_TOL)
                          for k in mc}}
        grads = {}
        for part in sc:
            adam = convert.find_adam(sc[part])
            if adam is None:
                continue
            mine = convert.flatten(convert.find_adam(sg[part])["mu"])
            for k, v in convert.flatten(adam["mu"]).items():
                grads[f"{part}.{k}"] = _rl_close(
                    torch.as_tensor(np.asarray(mine[k]) * 10.0),
                    torch.as_tensor(np.asarray(v) * 10.0), RL_PARITY_TOL)
        out["grads"] = grads
        for i in range(RL2_WARM_UPDATES):
            update(cpu, tb["cpu"], draws())
        load(card, to_jax(cpu))
        d = draws()
        update(cpu, tb["cpu"], d)
        update(card, tb["cuda"], _rl2_moved(d, "cuda"))
        sc, sg = to_jax(cpu), to_jax(card)
        out["params"] = {
            f"{part}.{k}": _rl_close(
                torch.as_tensor(np.asarray(convert.flatten(sg[part])[k])),
                torch.as_tensor(np.asarray(v)), RL_PARITY_TOL)
            for part in ("params", "target") if part in sc
            for k, v in convert.flatten(sc[part]).items()}
        res[name] = out
    return res


def _rl2_graph_check(n=8) -> dict:
    """SAC's update replayed as a CUDA graph (GraphedUpdates, the path
    SAC takes on the card) against the same n updates run eagerly, from
    one state on the card, on the same minibatches and draws: every
    leaf of the two states afterwards and the last metrics."""
    import torch

    from ray_tpu_torch.rl.algorithms import sac
    from ray_tpu_torch.rl.core import convert
    from ray_tpu_torch.rl.core.learner import to_tensors
    from ray_tpu_torch.rl.core.rl_module import (ContinuousModuleSpec,
                                                 ContinuousPolicyModule)

    spec = ContinuousModuleSpec(3, 1, -2.0, 2.0, RL2_SAC_HIDDEN)
    update = sac.make_sac_update(RL2_GAMMA, RL2_TAU, -1.0)
    states = [sac.init_sac_state(ContinuousPolicyModule(spec).init(
        SEED).to("cuda"), RL2_LR) for _ in range(2)]
    flat = _rl2_transitions(RL2_BATCH * n, SEED + 8)
    batches = to_tensors({k: v.reshape(n, RL2_BATCH, *v.shape[1:])
                          for k, v in flat.items()}, "cuda")
    noise = torch.randn((n, 2, RL2_BATCH, 1), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED))

    def one(state):
        return lambda b, z: update(state, b, {"next": z[0], "pi": z[1]})

    eager = one(states[0])
    for i in range(n):
        m_eager = eager({k: v[i] for k, v in batches.items()}, noise[i])
    m_graph = sac.GraphedUpdates(one(states[1])).run(batches, noise)
    a, b = (convert.flatten(sac.sac_state_to_jax(st)) for st in states)
    err = max(float(np.abs(np.asarray(a[k], np.float64)
                           - np.asarray(b[k], np.float64)).max()) for k in a)
    return {"updates": n, "max_abs_err": err,
            "metrics_equal": all(torch.equal(m_eager[k], m_graph[k])
                                 for k in m_eager)}


def _rl2_bad(parity) -> dict:
    return {f"{name}.{kind}.{k}": v for name, out in parity.items()
            for kind in ("losses", "grads", "params")
            for k, v in out[kind].items() if not v["ok"]}


def _rl2_devices(*objs) -> list:
    """Where the modules', tensors' and optimizers' tensors live."""
    import torch

    out = set()
    for o in objs:
        if isinstance(o, torch.nn.Module):
            out |= {str(p.device) for p in o.parameters()}
        elif isinstance(o, torch.Tensor):
            out.add(str(o.device))
        elif isinstance(o, torch.optim.Optimizer):
            out |= {str(v.device) for st in o.state.values()
                    for v in st.values() if torch.is_tensor(v) and v.dim()}
    return sorted(out)


def _rl2_state_devices(state) -> list:
    return _rl2_devices(*[v for v in state.values()
                          if not isinstance(v, int)])


def _finite(metrics) -> bool:
    return bool(metrics) and all(np.isfinite(v) for v in metrics.values())


def _learner_metrics(result) -> dict:
    return {k: v for k, v in result.items() if k.startswith("learner/")
            and not isinstance(v, (list, dict))}


def _rl2_sac(rt) -> tuple:
    """SAC at published widths on the numpy Pendulum: one CPU runner, the
    update on the card in this process; RL2_SAC_STEPS env steps and
    updates an iteration."""
    import torch

    from ray_tpu_torch.rl import SACConfig

    algo = (SACConfig(hidden=RL2_SAC_HIDDEN)
            .environment(PendulumEnv, obs_dim=3, action_dim=1,
                         action_low=-2.0, action_high=2.0)
            .env_runners(num_env_runners=1, rollout_length=RL2_SAC_STEPS)
            .training(lr=RL2_LR, gamma=RL2_GAMMA, tau=RL2_TAU,
                      batch_size=RL2_BATCH,
                      updates_per_iteration=RL2_SAC_STEPS,
                      warmup_steps=RL2_SAC_STEPS)
            .build())
    walls = []
    run_updates = algo._run_updates

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = run_updates(n)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return m

    algo._run_updates = timed
    torch.cuda.reset_peak_memory_stats()
    iters = []
    try:
        start = time.perf_counter()
        for i in range(RL2_SAC_MAX_ITERS):
            t0 = time.perf_counter()
            r = algo.train()
            iters.append({"iteration": r["training_iteration"],
                          "seconds": time.perf_counter() - t0,
                          "episode_return_mean": r["episode_return_mean"],
                          "episodes_total": r["episodes_total"],
                          "losses": _learner_metrics(r)})
            print(f"rl2: SAC iteration {i + 1}: "
                  f"{iters[-1]['seconds']:.2f} s, mean return "
                  f"{r['episode_return_mean']:.1f}", file=sys.stderr,
                  flush=True)
            best = max((it["episode_return_mean"] for it in iters[1:]),
                       default=-1e9)
            if best > RL2_SAC_ENOUGH or (
                    time.perf_counter() - start >= RL2_SAC_BUDGET_S):
                break
        peak = torch.cuda.max_memory_allocated()
        devices = _rl2_state_devices(algo.state)
        n = len(algo.buffer)
        keep = slice(max(0, n - RL2_CQL_ROWS), n)
        transitions = {k: getattr(algo.buffer, k)[keep].copy()
                       for k in ("obs", "actions", "rewards", "next_obs",
                                 "dones")}
    finally:
        algo.stop()
    per_update = [w / RL2_SAC_STEPS for w in walls]
    return {
        "hidden": list(RL2_SAC_HIDDEN), "batch": RL2_BATCH, "lr": RL2_LR,
        "tau": RL2_TAU, "gamma": RL2_GAMMA, "iterations": iters,
        "first_mean_return": iters[0]["episode_return_mean"],
        "best_mean_return": max((it["episode_return_mean"]
                                 for it in iters[1:]), default=None),
        "update_ms_median": _med(per_update) * 1e3 if walls else None,
        "update_ms_each_iteration": [x * 1e3 for x in per_update],
        "samples_per_s": (RL2_BATCH * RL2_SAC_STEPS * len(walls)
                          / sum(walls)) if walls else None,
        "peak_memory": peak, "state_devices": devices,
        "finite": all(_finite(it["losses"]) for it in iters[1:]),
    }, transitions


def _rl2_td3(rt) -> dict:
    from ray_tpu_torch.rl import DDPGConfig, TD3Config

    out = {}
    for name, cfg in (("td3", TD3Config()), ("ddpg", DDPGConfig())):
        cfg.hidden = RL2_TD3_HIDDEN
        algo = (cfg.environment(PendulumEnv, obs_dim=3, action_dim=1,
                                action_low=-2.0, action_high=2.0)
                .env_runners(num_env_runners=1, rollout_length=200)
                .training(batch_size=RL2_BATCH, updates_per_iteration=64,
                          warmup_steps=200)
                .build())
        try:
            rs = [algo.train() for _ in range(RL2_ITERS)]
            out[name] = {"losses": [_learner_metrics(r) for r in rs],
                         "policy_delay": cfg.policy_delay,
                         "step": algo.state["step"],
                         "state_devices": _rl2_state_devices(algo.state)}
        finally:
            algo.stop()
        out[name]["finite"] = all(_finite(m) for m in out[name]["losses"])
    return out


def _rl2_cql(rt, transitions) -> dict:
    """CQL offline from SAC's own transitions through episodes_to_dataset
    and train_on_dataset, two epochs."""
    from ray_tpu_torch.rl import CQLConfig, episodes_to_dataset

    ds = episodes_to_dataset([transitions])
    algo = (CQLConfig(hidden=RL2_SAC_HIDDEN)
            .module(obs_dim=3, action_dim=1, action_low=-2.0,
                    action_high=2.0)
            .training(lr=RL2_LR, minibatch_size=RL2_BATCH,
                      num_candidate_actions=RL2_CQL_CANDIDATES)
            .build())
    t0 = time.perf_counter()
    m = algo.train_on_dataset(ds, num_epochs=2)
    return {"rows": ds.count(), "seconds": time.perf_counter() - t0,
            "metrics": m, "finite": _finite(m),
            "state_devices": _rl2_state_devices(algo.state)}


def _rl2_recurrent_ppo(rt) -> dict:
    from ray_tpu_torch.rl import RecurrentPPOConfig

    algo = (RecurrentPPOConfig(state_dim=RL2_GRU // 2)
            .environment(CueRecallEnv, obs_dim=3, num_actions=2)
            .env_runners(num_env_runners=2, rollout_length=128)
            .training(lr=5e-3, num_epochs=4)
            .build())
    try:
        rs = [algo.train() for _ in range(RL2_ITERS)]
        info = algo.learner_group.foreach_learner(_rl_learner_info)[0]
    finally:
        algo.stop()
    losses = [_learner_metrics(r) for r in rs]
    return {"losses": losses, "learner": info,
            "mean_returns": [r["episode_return_mean"] for r in rs],
            "finite": all(_finite(m) for m in losses)}


def _rl2_r2d2(rt) -> dict:
    from ray_tpu_torch.rl import R2D2Config

    algo = (R2D2Config(state_dim=RL2_GRU, hidden=(RL2_GRU,))
            .environment(CueRecallEnv, obs_dim=3, num_actions=2)
            .env_runners(num_env_runners=2, window_length=16)
            .training(learning_starts=4, updates_per_iteration=16,
                      train_batch_size=16, burn_in=2)
            .build())
    try:
        # two: the first iteration only fills the sequence replay
        rs = [algo.train() for _ in range(2)]
        devices = _rl2_devices(algo.module, algo.target, algo.optimizer)
    finally:
        algo.stop()
    losses = [_learner_metrics(r) for r in rs]
    return {"losses": losses, "state_devices": devices,
            "windows": rs[-1]["buffer_windows"],
            "finite": all(_finite(m) for m in losses[1:])}


def _rl2_apex(rt) -> dict:
    """Ape-X over the port's DQN: the Nature CNN Q-network on FrameSideEnv
    frames (DQN, in both packages, gives image observations the conv
    Q-network, not the dueling head), 2 CPU runners on the epsilon
    ladder, 2 replay shard actors, the learner and target net on the
    card."""
    from ray_tpu_torch.models.conv import ATARI_FILTERS
    from ray_tpu_torch.rl import APEXConfig

    cfg = APEXConfig()
    cfg.num_env_runners = 2
    algo = (cfg.environment(lambda: FrameSideEnv(), obs_shape=RL_FRAME,
                            num_actions=RL_ACTIONS,
                            conv_filters=ATARI_FILTERS)
            .env_runners(rollout_length=256)
            .training(train_batch_size=32, updates_per_iteration=16,
                      learning_starts=512, buffer_capacity=2048)
            .build())
    try:
        rs = []
        for _ in range(6):
            rs.append(algo.train())
            if len(rs) >= 2 and _learner_metrics(rs[-1]):
                break
        info = algo.learner_group.foreach_learner(_rl_learner_info)[0]
        target = _rl2_devices(algo._target_net, algo._online_net)
        sizes = rt.get([s.size.remote() for s in algo.shards], timeout=60)
    finally:
        algo.stop()
    losses = _learner_metrics(rs[-1])
    return {"iterations": len(rs), "losses": losses, "learner": info,
            "target_net_devices": target, "shard_sizes": sizes,
            "epsilons": rs[-1]["epsilon"], "finite": _finite(losses)}


def _rl2_multi_agent(rt) -> tuple:
    from ray_tpu_torch.rl import MultiAgentPPOConfig, RLModuleSpec

    spec = RLModuleSpec(obs_dim=3, num_actions=3)
    algo = (MultiAgentPPOConfig()
            .environment(lambda: MatchContextEnv(seed=SEED))
            .multi_agent(policies={"p0": spec, "p1": spec},
                         policy_mapping_fn=lambda aid: ("p0" if aid == "a0"
                                                        else "p1"))
            .env_runners(num_env_runners=2, rollout_length=64)
            .training(lr=1e-2, num_epochs=4, minibatch_size=64)
            .build())
    try:
        rs = [algo.train() for _ in range(RL2_ITERS)]
        devices = _rl2_devices(*[x for lr in algo.learners.values()
                                 for x in (lr.module, lr.optimizer)])
        rollouts = rt.get([r.sample.remote() for r in algo.env_runners],
                          timeout=300)
    finally:
        algo.stop()
    losses = [_learner_metrics(r) for r in rs]
    trajs = [t for r in rollouts for t in r["p0"] + r["p1"]]
    return {"losses": losses, "state_devices": devices,
            "mean_returns": [r["episode_return_mean"] for r in rs],
            "finite": all(_finite(m) for m in losses)}, trajs


def _rl2_offline(rt, trajs) -> dict:
    """BC and MARWIL on the card from a dataset of multi-agent PPO's
    rollouts (returns-to-go at gamma 0.99)."""
    from ray_tpu_torch.rl import (BCConfig, MARWILConfig,
                                  episodes_to_dataset)

    ds = episodes_to_dataset(trajs, gamma=RL2_GAMMA)
    out = {"rows": ds.count()}
    for name, cfg in (("bc", BCConfig()), ("marwil", MARWILConfig())):
        algo = cfg.module(obs_dim=3, num_actions=3).training(
            minibatch_size=64).build()
        m = algo.train_on_dataset(ds, num_epochs=3)
        out[name] = {"metrics": m, "finite": _finite(m),
                     "state_devices": _rl2_devices(algo.learner.module,
                                                   algo.learner.optimizer)}
    return out


def phase_rl2(device_name, smi):
    import gc

    import torch

    import ray_tpu_torch as rt

    gc.collect()
    torch.cuda.empty_cache()
    counters = _train_launch_counters()
    for fn in counters.values():
        fn.launches = 0
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        parity = _rl2_parity()
        graph = _rl2_graph_check()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    parity_s = time.perf_counter() - t0
    seconds = {}
    rt.init(num_cpus=8, object_store_memory=RL_STORE_BYTES)
    try:
        t0 = time.perf_counter()
        sac, transitions = _rl2_sac(rt)
        seconds["sac"] = time.perf_counter() - t0
        runs = {}
        for name, fn, args in (("td3", _rl2_td3, ()),
                               ("cql", _rl2_cql, (transitions,)),
                               ("recurrent_ppo", _rl2_recurrent_ppo, ()),
                               ("r2d2", _rl2_r2d2, ()),
                               ("apex", _rl2_apex, ())):
            t0 = time.perf_counter()
            runs[name] = fn(rt, *args)
            seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        runs["multi_agent"], trajs = _rl2_multi_agent(rt)
        seconds["multi_agent"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        runs["offline"] = _rl2_offline(rt, trajs)
        seconds["offline"] = time.perf_counter() - t0
        _wait_gpu(rt, 1.0, "the GPU was not back at 1.0 after the rl2 phase")
    finally:
        rt.shutdown()
    left, _ = _stop_runtime()
    launches = {k: fn.launches for k, fn in counters.items()}
    in_learners = {k: sum(runs[x]["learner"]["launches"][k]
                          for x in ("recurrent_ppo", "apex"))
                   for k in counters}
    rec = {"phase": "rl2", "card": smi,
           "parity": {"batch": RL2_BATCH, "tol": RL_PARITY_TOL,
                      "seconds": parity_s,
                      "worst": {n: max(v["max_abs_err"]
                                       for kind in ("losses", "grads",
                                                    "params")
                                       for v in out[kind].values())
                                for n, out in parity.items()},
                      "graph_against_eager": graph},
           "sac": sac, **runs, "seconds": seconds,
           "launches_driver": launches, "launches_learners": in_learners,
           "procs_left": left}
    emit(rec)
    print(json.dumps({"rl2_numbers": {
        "card": smi, "sac_update_ms_median": sac["update_ms_median"],
        "sac_samples_per_s": sac["samples_per_s"],
        "sac_peak_memory": sac["peak_memory"],
        "sac_first_mean_return": sac["first_mean_return"],
        "sac_best_mean_return": sac["best_mean_return"],
        "sac_iterations": len(sac["iterations"]),
        "seconds": seconds}}), flush=True)
    bad = _rl2_bad(parity)
    check(not bad, f"card against CPU beyond {RL_PARITY_TOL}: {bad}")
    check(graph["max_abs_err"] <= RL_PARITY_TOL,
          f"SAC's graphed updates against eager ones: {graph}")
    best = sac["best_mean_return"]
    check(best is not None and best > RL2_SAC_GATE
          and best >= sac["first_mean_return"] + RL2_SAC_GAIN,
          f"SAC's best mean return {best} is not above {RL2_SAC_GATE} and "
          f"{RL2_SAC_GAIN} above the first iteration's "
          f"{sac['first_mean_return']}")
    check(sac["finite"], "SAC losses not finite")
    on_card = {"sac": sac["state_devices"],
               "td3": runs["td3"]["td3"]["state_devices"],
               "ddpg": runs["td3"]["ddpg"]["state_devices"],
               "cql": runs["cql"]["state_devices"],
               "r2d2": runs["r2d2"]["state_devices"],
               "recurrent_ppo": runs["recurrent_ppo"]["learner"][
                   "tensor_devices"],
               "apex": runs["apex"]["learner"]["tensor_devices"]
               + runs["apex"]["target_net_devices"],
               "multi_agent": runs["multi_agent"]["state_devices"],
               "bc": runs["offline"]["bc"]["state_devices"],
               "marwil": runs["offline"]["marwil"]["state_devices"]}
    check(all(devs and all(d.startswith("cuda") for d in devs)
              for devs in on_card.values()),
          f"learner or target tensors off the card: {on_card}")
    finite = {"td3": runs["td3"]["td3"]["finite"],
              "ddpg": runs["td3"]["ddpg"]["finite"],
              "cql": runs["cql"]["finite"],
              "recurrent_ppo": runs["recurrent_ppo"]["finite"],
              "r2d2": runs["r2d2"]["finite"], "apex": runs["apex"]["finite"],
              "multi_agent": runs["multi_agent"]["finite"],
              "bc": runs["offline"]["bc"]["finite"],
              "marwil": runs["offline"]["marwil"]["finite"]}
    check(all(finite.values()), f"losses not finite: {finite}")
    check(runs["td3"]["ddpg"]["policy_delay"] == 1
          and runs["td3"]["td3"]["policy_delay"] == 2,
          "the DDPG preset is not TD3 without the delay")
    check(all(s > 0 for s in runs["apex"]["shard_sizes"]),
          f"Ape-X shards {runs['apex']['shard_sizes']}")
    check(not any(launches.values()) and not any(in_learners.values()),
          f"kernels launched on the rl2 path: {launches}, {in_learners}")
    check(not left, f"processes after the phase: {left}")
    return {k: launches[k] + in_learners[k] for k in launches}


# -- workflow: a durable workflow with a GPU step, and a virtual actor ----

VA_MAIN = r"""
import sys

from ray_tpu_torch import workflow


@workflow.virtual_actor
class Ledger:
    def __init__(self):
        self.entries = []

    def append(self, x):
        self.entries.append(x)
        return len(self.entries)

    @workflow.readonly
    def read(self):
        return list(self.entries)


storage, actor_id, value = sys.argv[1:4]
ledger = Ledger.get_or_create(actor_id, storage=storage)
n = ledger.append(value)
print("LEDGER", n, ledger.seq, ",".join(ledger.read()), flush=True)
"""


def _wf_rollouts(seed):
    """Expert rows of MatchContextEnv's agent a0 (the hot index)."""
    env = MatchContextEnv(seed=seed)
    obs, _ = env.reset()
    rows = {"obs": [], "actions": []}
    for _ in range(512):
        a = {aid: int(np.argmax(o)) for aid, o in obs.items()}
        rows["obs"].append(obs["a0"])
        rows["actions"].append(a["a0"])
        obs, _, terms, _, _ = env.step(a)
        if terms["__all__"]:
            obs, _ = env.reset()
    return {"obs": np.stack(rows["obs"]),
            "actions": np.asarray(rows["actions"], np.int32)}


def _wf_bc_on_card(batch, counter):
    """The workflow's GPU step: counts its runs on disk, then BC updates
    on the card it was granted."""
    import os

    import torch

    from ray_tpu_torch.rl import BCConfig

    n = int(open(counter).read()) + 1 if os.path.exists(counter) else 1
    with open(counter, "w") as f:
        f.write(str(n))
    bc = BCConfig().module(obs_dim=3, num_actions=3).training(
        lr=5e-3, minibatch_size=128).build()
    m = bc.train_on_batch(batch, num_epochs=5)
    return {"metrics": m, "device": str(bc.learner.device),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "launches": {k: fn.launches
                         for k, fn in _train_launch_counters().items()},
            "actions": bc.compute_actions(
                np.eye(3, dtype=np.float32)).tolist(),
            "cuda_params": all(p.is_cuda
                               for p in bc.learner.module.parameters())}


def _wf_report(result, flag):
    """The last step: fails on its first run, then passes the GPU step's
    result through."""
    import os

    if not os.path.exists(flag):
        open(flag, "w").close()
        raise RuntimeError("the report step fails once")
    return result


def phase_workflow(device_name):
    import os
    import subprocess
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow
    from ray_tpu_torch.dag import InputNode

    tmp = tempfile.mkdtemp(prefix="chip_smoke_wf_")
    storage = os.path.join(tmp, "store")
    counter, flag = os.path.join(tmp, "gpu_runs"), os.path.join(tmp, "flag")
    rt.init(num_cpus=4)
    try:
        data = rt.remote(_wf_rollouts)
        gpu = rt.remote(num_gpus=1)(_wf_bc_on_card)
        report = rt.remote(_wf_report)
        with InputNode() as inp:
            dag = report.bind(gpu.bind(data.bind(inp), counter), flag)
        t0 = time.perf_counter()
        first_error = None
        try:
            workflow.run(dag, SEED, workflow_id="bc", storage=storage,
                         max_step_retries=0)
        except workflow.WorkflowError as e:
            first_error = str(e)
        status_after_failure = workflow.get_status("bc", storage=storage)
        runs_after_failure = int(open(counter).read())
        out = workflow.resume("bc", storage=storage, max_step_retries=0)
        wall = time.perf_counter() - t0
        runs = int(open(counter).read())
        status = workflow.get_status("bc", storage=storage)
        steps = sorted(os.listdir(os.path.join(storage, "bc", "steps")))
        _wait_gpu(rt, 1.0, "the GPU was not back at 1.0 after the workflow")
    finally:
        rt.shutdown()
    left, _ = _stop_runtime()
    script = os.path.join(tmp, "ledger.py")
    with open(script, "w") as f:
        f.write(VA_MAIN)
    env = {**os.environ, "PYTHONPATH": os.path.dirname(
        os.path.abspath(__file__))}
    lines = []
    for value in ("first", "second"):
        p = subprocess.run([sys.executable, script, storage, "ledger", value],
                           capture_output=True, text=True, timeout=120,
                           env=env)
        check(p.returncode == 0, f"ledger driver failed: {p.stderr[-2000:]}")
        lines.append(next(ln for ln in p.stdout.splitlines()
                          if ln.startswith("LEDGER")))
    rec = {"phase": "workflow", "first_error": first_error,
           "status_after_failure": status_after_failure,
           "gpu_runs_after_failure": runs_after_failure,
           "gpu_runs": runs, "status": status, "steps": steps,
           "result": out, "seconds": wall, "ledger": lines,
           "procs_left": left}
    emit(rec)
    check(first_error is not None and "fails once" in first_error
          and status_after_failure == "FAILED",
          f"the first run did not fail at its last step: {rec}")
    check(runs_after_failure == 1 and runs == 1,
          f"the GPU step ran {runs} times across the resume")
    check(status == "SUCCEEDED" and len(steps) == 3, f"workflow: {rec}")
    check(out["device"].startswith("cuda") and out["cuda_params"]
          and out["visible"] is not None,
          f"the GPU step did not train on a granted card: {out}")
    check(_finite(out["metrics"]) and out["actions"] == [0, 1, 2],
          f"BC on the card: {out['metrics']}, {out['actions']}")
    check(not any(out["launches"].values()),
          f"kernels launched in the workflow's GPU step: {out['launches']}")
    check(lines == ["LEDGER 1 1 first", "LEDGER 2 2 first,second"],
          f"the virtual actor across two drivers: {lines}")
    check(not left, f"processes after the phase: {left}")
    return out["launches"]



# -- autoscaler: `rt up`, a GPU node scaled up for a kernel task, and down ----
# `python -m ray_tpu_torch up` brings a CPU head up from a .json config; a
# StandardAutoscaler with the process provider scales one gpu-worker node up
# for a num_gpus=1 task that runs the RMSNorm forward at CLUSTER_SHAPE (the
# cluster phase's seed and function), the C++ client's rt_demo runs against
# the head, the idle node is scaled down, then `rt exec` and `rt down`.
AUTOSCALER_IDLE_S = 2.0
AUTOSCALER_TYPES = {"gpu-worker": {"resources": {"CPU": 1, "GPU": 1},
                                   "max_workers": 1}}


# The C++ client's programs, each with its main source and the library
# sources it links (the targets of cpp/Makefile).
CPP_TARGETS = {"rt_demo": ("examples/demo.cc", ("src/msgpack.cc",
                                                "src/client.cc")),
               "msgpack_test": ("tests/msgpack_test.cc", ("src/msgpack.cc",))}


def start_cpp_build(out_dir: str, targets=("rt_demo",)) -> dict:
    """Start g++ with cpp/Makefile's flags on every source the targets need,
    one process per source, all at once, writing objects into out_dir;
    finish_cpp_build links the targets once they are done. cpp/ itself is
    only read."""
    import os

    cpp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp")
    cxx = ["g++", "-O2", "-std=c++17", "-Wall", "-Wextra",
           "-I" + os.path.join(cpp, "include")]
    srcs = []
    for t in targets:
        main_src, deps = CPP_TARGETS[t]
        srcs += [src for src in (main_src,) + deps if src not in srcs]
    objs = {src: os.path.join(out_dir, src.replace("/", "_") + ".o")
            for src in srcs}
    procs = [subprocess.Popen(cxx + ["-c", "-o", objs[src],
                                     os.path.join(cpp, src)],
                              stderr=subprocess.PIPE, text=True)
             for src in srcs]
    return {"out_dir": out_dir, "targets": tuple(targets), "objs": objs,
            "procs": procs}


def finish_cpp_build(build: dict) -> dict:
    """Wait for start_cpp_build's compiles and link each target; returns
    {target: path}."""
    import os

    for p in build["procs"]:
        _, err = p.communicate(timeout=300)
        check(p.returncode == 0, f"g++ on the C++ client failed: {err}")
    out = {}
    for t in build["targets"]:
        main_src, deps = CPP_TARGETS[t]
        out[t] = os.path.join(build["out_dir"], t)
        p = subprocess.run(["g++", "-O2", "-o", out[t]]
                           + [build["objs"][s] for s in (main_src,) + deps],
                           capture_output=True, text=True, timeout=300)
        check(p.returncode == 0, f"linking {t} failed: {p.stderr}")
    return out


def phase_autoscaler(device_name, smi):
    import gc
    import hashlib
    import os
    import re
    import socket
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import StandardAutoscaler, make_node_provider
    from ray_tpu_torch.ops.rmsnorm import _rmsnorm_plain

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="rt_as_")
    cpp_build = start_cpp_build(tmp)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg_path = os.path.join(tmp, "cluster.json")
    with open(cfg_path, "w") as f:
        json.dump({"cluster_name": "chip-autoscaler",
                   "provider": {"type": "local", "head_ip": "127.0.0.1"},
                   "port": port,
                   "head_start_commands": [
                       "{python} -m ray_tpu_torch start --head --port {port}"
                       " --num-cpus 1 --num-gpus 0 --no-dashboard"]}, f)
    env = {k: v for k, v in os.environ.items() if k != "RT_NUM_GPUS"}
    env["TMPDIR"] = tmp
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [os.path.dirname(os.path.abspath(__file__)),
                    env.get("PYTHONPATH", "")] if p)
    os.environ["TMPDIR"] = tmp  # the driver's node and the scaled node's logs
    rows, d = CLUSTER_SHAPE
    seed = SEED + 21
    up, up_s = _cli(env, "up", cfg_path)
    addr = f"127.0.0.1:{port}"
    check(addr in up, f"rt up: {up}")
    provider = autoscaler = None
    polls = 0
    try:
        rt.init(address=addr, num_gpus=0, num_cpus=2)
        resources_before = rt.cluster_resources()

        @rt.remote(num_cpus=0)
        class Counter:
            def __init__(self):
                self.n = 0

            def add(self, x):
                self.n += x
                return self.n

        counter = Counter.options(name="cpp-counter").remote()
        rt.get(counter.add.remote(0), timeout=120)
        provider = make_node_provider({"type": "process"},
                                      gcs_host="127.0.0.1", gcs_port=port)
        autoscaler = StandardAutoscaler(
            {"node_types": AUTOSCALER_TYPES,
             "idle_timeout_s": AUTOSCALER_IDLE_S}, provider, addr)
        t0 = time.perf_counter()
        ref = rt.remote(num_gpus=1)(_cluster_rmsnorm).remote(seed, rows, d)
        launched, node, alive_s, done_s = {}, None, None, None
        while done_s is None:
            for t, n in autoscaler.update().items():
                launched[t] = launched.get(t, 0) + n
            polls += 1
            now = time.perf_counter() - t0
            if node is None:
                ids = {provider.node_tags(p).get("rt-node-id")
                       for p in provider.non_terminated_nodes()}
                for n in rt.nodes():
                    nid = n["node_id"]
                    nid = nid.hex() if isinstance(nid, bytes) else nid
                    if n["state"] == "ALIVE" and nid in ids:
                        node = {"node_id": nid,
                                "resources_total": n["resources_total"]}
                        alive_s = now
            if rt.wait([ref], timeout=0.25, fetch_local=False)[0]:
                done_s = now
            check(now < 600, f"no result after {now:.0f} s: {launched}")
        t1 = time.perf_counter()
        got = rt.get(ref, timeout=600)
        result_s = time.perf_counter() - t0
        pull_s = time.perf_counter() - t1
        resources_up = rt.cluster_resources()
        check(len(provider.non_terminated_nodes()) == 1,
              f"provider nodes: {provider.non_terminated_nodes()}")

        demo = finish_cpp_build(cpp_build)["rt_demo"]
        t1 = time.perf_counter()
        demo_out = subprocess.run([demo, "127.0.0.1", str(port),
                                   "cpp-counter"], capture_output=True,
                                  text=True, timeout=300)
        demo_s = time.perf_counter() - t1
        counter_after = rt.get(counter.add.remote(0), timeout=120)
        rt.kill(counter)

        # Idle to terminated: from the first update() after the task's
        # result to the provider listing no node.
        t1 = time.perf_counter()
        while provider.non_terminated_nodes():
            autoscaler.update()
            polls += 1
            check(time.perf_counter() - t1 < 120, "the idle GPU node stayed")
            time.sleep(0.25)
        idle_to_term_s = time.perf_counter() - t1
        deadline = time.monotonic() + 30
        while ("GPU" in rt.cluster_resources()
               and time.monotonic() < deadline):
            time.sleep(0.1)
        resources_down = rt.cluster_resources()
        live_nodes = provider.non_terminated_nodes()
        scale_down_s = time.perf_counter() - t1
    finally:
        rt.shutdown()
        if autoscaler is not None:
            autoscaler.close()
        if provider is not None:
            provider.shutdown()
        os.environ.pop("TMPDIR", None)
        exec_out, exec_s = _cli(env, "exec", cfg_path, "echo",
                                "{cluster_name}")
        down, down_s = _cli(env, "down", cfg_path)
    deadline = time.monotonic() + 30
    while _runtime_procs() and time.monotonic() < deadline:
        time.sleep(0.2)
    left_after_down = _runtime_procs()
    left, procs = _stop_runtime()

    out = got["out"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((rows, d), generator=gen, device="cuda") * 3).to(
        torch.bfloat16)
    w = (torch.randn(d, generator=gen, device="cuda") * 0.1 + 1).to(
        torch.bfloat16)
    want = _rmsnorm_plain(x, w, EPS)
    got_t = torch.from_numpy(out).cuda()
    ulp = bf16_ulp_diff(got_t, want)
    max_abs = float((got_t - want.float()).abs().max())
    demo_lines = [re.sub(r"\b[0-9a-f]{16,}\b", "<id>", ln)
                  for ln in demo_out.stdout.splitlines()]
    rec = {"phase": "autoscaler", "nvidia_smi": smi, "gcs_address": addr,
           "up_s": up_s, "node_types": AUTOSCALER_TYPES,
           "idle_timeout_s": AUTOSCALER_IDLE_S, "launched": launched,
           "update_calls": polls,
           "cluster_resources_before": resources_before,
           "cluster_resources_up": resources_up,
           "scaled_node": node,
           "demand_to_alive_s": alive_s, "demand_to_done_s": done_s,
           "demand_to_result_s": result_s, "pull_s": pull_s,
           "idle_to_terminated_s": idle_to_term_s,
           "scale_down_s": scale_down_s,
           "task_node_id": got["node_id"], "task_visible": got["visible"],
           "task_device": got["device_name"], "launches": got["launches"],
           "shape": list(CLUSTER_SHAPE), "max_ulp": ulp,
           "max_abs_err": max_abs,
           "digest_equal": hashlib.sha256(out.tobytes()).hexdigest()
           == got["sha256"],
           "rt_demo": {"rc": demo_out.returncode, "lines": demo_lines,
                       "stderr": demo_out.stderr[-2000:], "seconds": demo_s,
                       "counter_after": counter_after},
           "cluster_resources_down": resources_down,
           "provider_nodes_after": live_nodes,
           "exec": exec_out.split(), "exec_s": exec_s, "down_s": down_s,
           "down_output": down.splitlines(),
           "left_after_down": left_after_down,
           "workers_after_shutdown": left,
           "runtime_procs_after_zygote_stop": procs,
           "phase_s": time.perf_counter() - t_phase}
    emit(rec)
    check(launched == {"gpu-worker": 1}, f"launched {launched}")
    check(node is not None and node["resources_total"].get("GPU") == 1.0,
          f"the scaled node's resources: {rec['scaled_node']}")
    check(resources_before.get("GPU") is None,
          f"a GPU before the scale-up: {resources_before}")
    check(resources_up.get("GPU") == 1.0, f"cluster GPUs: {resources_up}")
    check(got["node_id"] == node["node_id"],
          f"the GPU task ran on node {got['node_id']}, not the scaled one")
    check(got["device_name"] == device_name and got["visible"] == "0",
          f"the GPU task ran on {got['device_name']} ({got['visible']})")
    check(rec["digest_equal"], "the pulled bytes differ from the sent")
    check(ulp <= 1, f"the task's rows are {ulp} bf16 ulp off the plain "
          f"version")
    check(got["launches"] == 1, f"the task launched {got['launches']} times")
    check(demo_out.returncode == 0 and "CPP CLIENT OK" in demo_lines
          and "CPP ACTOR OK" in demo_lines and counter_after == 42,
          f"rt_demo: {rec['rt_demo']}")
    check("GPU" not in resources_down and not live_nodes,
          f"after scale-down: {resources_down}, {live_nodes}")
    check(rec["exec"] == ["chip-autoscaler"], f"rt exec: {exec_out}")
    check(not left_after_down, f"processes after rt down: {left_after_down}")
    check(not left and not procs, f"left after the phase: {left} {procs}")
    return got["launches"]


def _left_behind(after: str) -> dict:
    """What the driver holds after a phase: card memory, live threads (by
    name) and child processes. Recorded, not gated."""
    import collections
    import os
    import re
    import threading

    import torch

    me = os.getpid()
    children = []
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read().rsplit(") ", 1)
            if int(stat[1].split()[1]) != me:
                continue
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            children.append({"pid": int(pid), "state": stat[1].split()[0],
                             "cmd": cmd.strip()[:120]})
        except (OSError, IndexError, ValueError):
            continue
    names = collections.Counter(
        re.sub(r"[-_ ]?\d+$", "", t.name) for t in threading.enumerate())
    return {"phase": "left_behind", "after": after,
            "cuda_memory_allocated": torch.cuda.memory_allocated(),
            "threads": threading.active_count(),
            "thread_names": dict(sorted(names.items())),
            "children": children}


def rmsnorm_fwd_only() -> int:
    """The RMSNorm forward alone: its build and ptxas report, then the
    checks and times of `kernels` and `train_kernels` at all six shapes.
    Copied beside another tree's ray_tpu_torch, it times that tree's
    kernel the same way."""
    from ray_tpu_torch import _build

    _, smi = phase_device()
    t0 = time.perf_counter()
    _build.load("rmsnorm")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "rmsnorm_kernels": _build.ptxas_report("rmsnorm")})
    timed = rmsnorm_fwd_timed(SERVE_FWD_SHAPES + TRAIN_FWD_SHAPES)
    emit({"phase": "rmsnorm_fwd", "timed": timed})
    bad = [r for r in timed if not r["ok"]]
    check(not bad, f"rmsnorm_fwd disagrees with its plain version: {bad}")
    print(smi, flush=True)
    return 0


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
    if sys.argv[1:] == ["--rmsnorm-fwd"]:
        return rmsnorm_fwd_only()
    seconds = {}

    def run(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__[len("phase_"):]] = time.perf_counter() - t0
        emit(_left_behind(phase.__name__[len("phase_"):]))
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
    moe = run(phase_moe_train, name)
    runtime_rec = run(phase_runtime, slice_rec, name)
    runtime_launches = runtime_rec["streamed"]["rmsnorm_launches"]
    serve_launches = run(phase_serve, slice_rec, runtime_rec, name)
    trainer_launches = run(phase_trainer, train, name)
    job_launches = run(phase_job, name)
    tune_a_launches, tune_b_launches = run(phase_tune, train, name)
    dag_launches = run(phase_dag, name)
    cluster_launches = run(phase_cluster, name)
    cli_launches = run(phase_cli, train, name)
    data_train_launches, data_infer_launches = run(phase_data, train, name)
    loadgen_launches, rest_job_launches = run(phase_loadgen, name)
    run(phase_collective, name)
    dcn = run(phase_train_dcn, train, name)
    serve_tp_launches = run(phase_serve_tp, slice_rec["engine_step_ms"],
                            name)
    rl_launches = run(phase_rl, name, smi)
    rl2_launches = run(phase_rl2, name, smi)
    workflow_launches = run(phase_workflow, name)
    autoscaler_launches = run(phase_autoscaler, name, smi)
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
        "launches_by_path": {"serve": launches,
                             "train": train_launches["rmsnorm_fwd"],
                             "runtime_actor": runtime_launches,
                             "serve_deployment": serve_launches,
                             "trainer": trainer_launches["rmsnorm_fwd"],
                             "job": job_launches,
                             "tune_a": tune_a_launches["rmsnorm_fwd"],
                             "tune_b": tune_b_launches["rmsnorm_fwd"],
                             "dag": dag_launches,
                             "cluster": cluster_launches,
                             "cli": cli_launches["rmsnorm_fwd"],
                             "data_train": data_train_launches["rmsnorm_fwd"],
                             "data_infer": data_infer_launches["rmsnorm_fwd"],
                             "loadgen": loadgen_launches,
                             "dashboard_job": rest_job_launches,
                             "moe_train": moe["launches"]["rmsnorm_fwd"],
                             "train_dcn": dcn["launches"]["rmsnorm_fwd"],
                             "serve_tp": serve_tp_launches,
                             "autoscaler": autoscaler_launches},
        "max_abs_err": max([max_abs, moe["kernels"]["rmsnorm_fwd"][
            "max_abs_err"], dcn["kernels_at_dp_shape"]["rmsnorm_fwd"][
            "max_abs_err"]] + [r["max_abs_err"]
                               for r in train_timed["rmsnorm_fwd"]]),
        "ms": decode["kernel_ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"],
        "shape": [decode["rows"], decode["d"]], "dtype": decode["dtype"],
        "at_shapes": timed + train_timed["rmsnorm_fwd"],
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
            "replaces": replaces,
            "launches_by_path": {"train": train_launches[kname],
                                 "trainer": trainer_launches[kname],
                                 "tune_a": tune_a_launches[kname],
                                 "tune_b": tune_b_launches[kname],
                                 "cli": cli_launches[kname],
                                 "data_train": data_train_launches[kname],
                                 "moe_train": moe["launches"][kname],
                                 "train_dcn": dcn["launches"][kname]},
            "max_abs_err": max(train_err[kname],
                               moe["kernels"][kname]["max_abs_err"],
                               dcn["kernels_at_dp_shape"][kname][
                                   "max_abs_err"]),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library"]["ms"],
            "shape": t["shape"], "dtype": t["dtype"]})
        if kname in data_infer_launches:
            records[-1]["launches_by_path"]["data_infer"] = \
                data_infer_launches[kname]
        if kname in FLASH_DESIGN:
            records[-1]["design"] = FLASH_DESIGN[kname]
    for r in records:
        r["launches"] = sum(r["launches_by_path"].values())
        # The rl path runs no kernel of these five (convolutions and
        # dense layers only); phase_rl checked its count is 0.
        r["launches_rl"] = rl_launches[r["name"]]
        # Nor do the second half's paths (MLPs, the GRU, the Nature CNN)
        # or the workflow's BC step: phase_rl2 and phase_workflow checked.
        r["launches_rl2"] = rl2_launches[r["name"]]
        r["launches_workflow"] = workflow_launches[r["name"]]
        r["at_moe_train_shape"] = moe["kernels"][r["name"]]
        r["at_train_dcn_shape"] = dcn["kernels_at_dp_shape"][r["name"]]
    missing = [r["name"] for r in records
               if 0 in r["launches_by_path"].values()]
    check(not missing, f"kernels never launched on a path: {missing}")
    emit({"kernels": records})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
