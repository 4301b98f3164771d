"""Card-only tests of the PyTorch port: the CUDA kernels against their
plain versions, one training step through the kernels against the same
step on the CPU, the engine on the card, and the runtime core's GPU
resource (detection, and a num_gpus=1 actor that launches the RMSNorm
kernel in its own worker process), llm_deployment through serve.run
from a num_gpus=1 replica, a one-worker TorchTrainer on an NCCL group of
one, a checkpoint of CUDA bf16 tensors, Tune trials that hold the card
(and one that finds none and raises), a compiled DAG with a GPU
stage, and the data library's feed to the card (iter_torch_batches with
prefetch 0 and 2, bit-equal to the CPU's), a GPU actor pool's
map_batches, a closed-loop loadgen trace through a GPU replica, and the
collective layer on the card (the local group's NCCL allreduce, a DCN
round trip of a bf16 card tensor, int8/fp8 codes made on the card equal
to the CPU's), and the RL stack (the Nature-CNN policy against the CPU,
a learner on the card by default, a two-learner group sharing the card,
SAC's updates replayed as a CUDA graph against eager ones).
Each test skips without a
CUDA device. This file imports no JAX, so on a machine with a card and
without JAX it runs on its own:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerances. rmsnorm forward: f32 within 1e-5 (the kernel sums a row in
another order than PyTorch's mean), bf16 within 1 bf16 ulp (the same f32
result rounded after sums that differ in their last bits). rmsnorm
backward: f32 within 1e-4 (the reference's gradient tolerance). Flash
attention: f32 o within 2e-4 and gradients within 2e-3 (the reference's
interpret tolerances). bf16 kernels against the plain version computed in
f32 from the same bf16 inputs: relative L2 error at most 4e-3 (the
outputs are rounded once to bf16, whose unit roundoff is 2^-9 = 2e-3) and
no element further than 2^-6 of the largest reference magnitude (or,
where the reference vanishes, as dq and dk of a single key do, no
element above 1e-5). dq, dk, dv and the RMSNorm backward's dx and dw are
summed without atomics, so two calls on the same inputs give the same
bits. The training step: loss within rtol 2e-4, each gradient leaf
within rtol=atol=2e-3 and a relative L2 error of at most 1e-3. A bf16
MoE step with its expert products in bf16 against the same step with
f32 experts: loss within rtol 1e-3, each gradient leaf within a relative
L2 error of 2e-2 (the test's docstring gives the reason).
"""

import dataclasses
import os
import time

import pytest
import torch

from ray_tpu_torch.models import configs, init_params, loss_fn
from ray_tpu_torch.models.generate import generate
from ray_tpu_torch.ops import flash_attention, rmsnorm
from ray_tpu_torch.ops.flash_attention import (_delta, _flash_bwd_plain,
                                               _flash_fwd_plain,
                                               flash_bwd_dkv_cuda,
                                               flash_bwd_dq_cuda,
                                               flash_fwd_cuda)
from ray_tpu_torch.ops.rmsnorm import (_rmsnorm_bwd_plain, _rmsnorm_plain,
                                       rmsnorm_bwd_cuda, rmsnorm_cuda)
from ray_tpu_torch.serve.llm import ContinuousBatchingEngine

torch.set_num_threads(1)

EPS = 1e-6

pytestmark = pytest.mark.gpu


@pytest.fixture
def engines():
    made = []
    yield made
    for e in made:
        e.shutdown()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bf16_ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    def ordered(t):
        i = t.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _assert_close(got, want):
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _bf16_ulp_diff(got, want) <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 2048, 4096, 100])
@pytest.mark.parametrize("rows", [1, 5, 8, 64, 2048, 8192])
def test_rmsnorm_cuda_kernel_matches_plain(cuda_device, rows, d, dtype):
    """d=100 leaves a scalar tail after the 16-byte loads."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(rows + d)
    x = (torch.randn((rows, d), generator=gen, device=cuda_device) * 3).to(tdt)
    w = (torch.randn(d, generator=gen, device=cuda_device) * 0.1 + 1).to(tdt)
    before = rmsnorm_cuda.launches
    got = rmsnorm(x, w, EPS)
    torch.cuda.synchronize()
    assert rmsnorm_cuda.launches == before + 1
    _assert_close(got, _rmsnorm_plain(x, w, EPS))
    # A strided row view (every other row) and a misaligned one.
    _assert_close(rmsnorm(x[::2], w, EPS), _rmsnorm_plain(x[::2], w, EPS))
    xs = x[:, 1:]
    _assert_close(rmsnorm(xs, w[1:].contiguous(), EPS),
                  _rmsnorm_plain(xs, w[1:], EPS))


@pytest.mark.parametrize("rows,d,dtype", [
    (8, 4096, "bfloat16"), (64, 4096, "bfloat16"), (8192, 2048, "bfloat16"),
    (4096, 4096, "bfloat16"), (4096, 2048, "bfloat16"),
    (8192, 2048, "float32"), (2, 16384, "bfloat16"), (3, 12288, "float32"),
    (2, 32776, "bfloat16")])
def test_rmsnorm_fwd_at_the_path_shapes(cuda_device, rows, d, dtype):
    """The paths' shapes: llama3-8b's decode and prefill rows, the
    training step's (bf16 and f32), the MoE and the DP steps'; then the
    widest one-pass row (a 1024-thread group at 16384 in bf16) and rows
    past the one-pass budget, which take the two-pass kernel."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(rows * 7 + d)
    x = (torch.randn((rows, d), generator=gen, device=cuda_device) * 3).to(tdt)
    w = (torch.randn(d, generator=gen, device=cuda_device) * 0.1 + 1).to(tdt)
    before = rmsnorm_cuda.launches
    got = rmsnorm_cuda(x, w, EPS)
    torch.cuda.synchronize()
    assert rmsnorm_cuda.launches == before + 1
    _assert_close(got, _rmsnorm_plain(x, w, EPS))


def test_rmsnorm_cuda_refuses_bad_input(cuda_device):
    with pytest.raises(TypeError):
        rmsnorm(torch.ones(4, 128, device=cuda_device, dtype=torch.float16),
                torch.ones(128, device=cuda_device, dtype=torch.float16))
    with pytest.raises(ValueError):
        rmsnorm(torch.ones(4, 128, device=cuda_device).T,
                torch.ones(4, device=cuda_device))


def _assert_bf16_close(got, want):
    """bf16 kernel output against the plain version in f32; a reference
    that vanishes (dq, dk of one key) is held to 1e-5 absolute instead."""
    got, want = got.float(), want.float()
    worst = float((got - want).abs().max())
    if worst <= 1e-5:
        return
    rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
    assert rel <= 4e-3, rel
    assert worst <= 2 ** -6 * float(want.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 2048, 4096, 100, 12288])
@pytest.mark.parametrize("rows", [1, 5, 8192])
def test_rmsnorm_bwd_kernel_matches_plain(cuda_device, rows, d, dtype):
    """d = 128, 2048 and 4096 take the one-pass kernel; d = 100 (a scalar
    tail) and 12288 (the widest supported, 48 KB of shared memory) the
    two-pass one."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(rows + d)
    x = (torch.randn((rows, d), generator=gen, device=cuda_device) * 3).to(tdt)
    w = (torch.randn(d, generator=gen, device=cuda_device) * 0.1 + 1).to(tdt)
    g = torch.randn((rows, d), generator=gen, device=cuda_device).to(tdt)
    before = rmsnorm_bwd_cuda.launches
    dx, dw = rmsnorm_bwd_cuda(x, w, g)
    torch.cuda.synchronize()
    assert rmsnorm_bwd_cuda.launches == before + 1
    assert dx.dtype == tdt and dw.dtype == tdt
    want = _rmsnorm_bwd_plain(x.float(), w.float(), g.float(), EPS)
    for got, ref in zip((dx, dw), want):
        if dtype == "float32":
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        else:
            _assert_bf16_close(got, ref)
    again = rmsnorm_bwd_cuda(x, w, g)[1]
    assert torch.equal(again, dw)  # dw is reduced without atomics


def test_rmsnorm_autograd_runs_both_kernels(cuda_device):
    x = torch.randn(6, 7, 256, device=cuda_device, requires_grad=True)
    w = torch.ones(256, device=cuda_device, requires_grad=True)
    fwd, bwd = rmsnorm_cuda.launches, rmsnorm_bwd_cuda.launches
    rmsnorm(x, w).square().sum().backward()
    assert (rmsnorm_cuda.launches, rmsnorm_bwd_cuda.launches) == (fwd + 1,
                                                                  bwd + 1)
    xc = x.detach().cpu().requires_grad_(True)
    wc = w.detach().cpu().requires_grad_(True)
    rmsnorm(xc, wc).square().sum().backward()
    torch.testing.assert_close(x.grad.cpu(), xc.grad, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(w.grad.cpu(), wc.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,lq,lk,d", [
    (True, 1, 1, 128), (True, 7, 7, 64), (True, 129, 129, 128),
    (True, 1024, 1024, 128), (False, 129, 70, 256), (False, 7, 129, 128),
    (True, 129, 129, 256), (True, 70, 129, 64),
    # The bf16 tensor-core tiling: causal Lq != Lk both ways, ragged tails.
    (True, 200, 1000, 128), (True, 1000, 200, 256), (False, 1000, 129, 64),
])
def test_flash_kernels_match_plain(cuda_device, causal, lq, lk, d, dtype):
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(lq * 3 + lk + d)
    b, h = (2, 4) if lq < 1024 else (1, 2)

    def rand(n):
        return torch.randn((b, n, h, d), generator=gen,
                           device=cuda_device).to(tdt)

    q, k, v, do = rand(lq), rand(lk), rand(lk), rand(lq)
    launches = (flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches,
                flash_bwd_dkv_cuda.launches)
    o, lse = flash_fwd_cuda(q, k, v, causal)
    delta = _delta(o, do)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert (flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches,
            flash_bwd_dkv_cuda.launches) == tuple(n + 1 for n in launches)
    f = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = _flash_fwd_plain(f[0], f[1], f[2], causal)
    # The backward's reference takes the kernel's own o and lse, as the
    # kernels do.
    grads_ref = _flash_bwd_plain(f[0], f[1], f[2], o.float(), lse, f[3],
                                 causal)
    torch.testing.assert_close(lse, lse_ref, rtol=2e-4, atol=2e-4)
    if dtype == "float32":
        torch.testing.assert_close(o, o_ref, rtol=2e-4, atol=2e-4)
        for got, ref in zip((dq, dk, dv), grads_ref):
            torch.testing.assert_close(got, ref, rtol=2e-3, atol=2e-3)
    else:
        for got, ref in zip((o, dq, dk, dv), (o_ref, *grads_ref)):
            assert got.dtype == tdt
            _assert_bf16_close(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("backward", ["dq", "dkv"])
def test_flash_bwd_kernel_is_deterministic(cuda_device, backward, d, dtype):
    """dq, dk and dv are summed without atomics: two calls of either
    backward kernel on the same inputs give the same bits."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(d)

    def rand(n):
        return torch.randn((2, n, 4, d), generator=gen,
                           device=cuda_device).to(tdt)

    q, k, v, do = rand(300), rand(300), rand(300), rand(300)
    o, lse = flash_fwd_cuda(q, k, v, True)
    delta = _delta(o, do)
    kernel = {"dq": flash_bwd_dq_cuda, "dkv": flash_bwd_dkv_cuda}[backward]
    first = kernel(q, k, v, do, lse, delta, True)
    second = kernel(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    if backward == "dq":
        first, second = (first,), (second,)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_rmsnorm_bwd_kernel_is_deterministic(cuda_device):
    """At the training step's 8192 x 2048 bf16, dx and dw (partials summed
    in a fixed order, no atomics) repeat bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(8192)
    x = (torch.randn((8192, 2048), generator=gen, device=cuda_device)
         * 3).to(torch.bfloat16)
    w = (torch.randn(2048, generator=gen, device=cuda_device) * 0.1
         + 1).to(torch.bfloat16)
    g = torch.randn((8192, 2048), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    first = rmsnorm_bwd_cuda(x, w, g)
    second = rmsnorm_bwd_cuda(x, w, g)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_strided_and_gqa_on_card(cuda_device):
    """Strided [b, L, h, d] views reach the kernels without a transposing
    copy; GQA's repeated heads sum their gradients back."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    qkv = torch.randn((2, 40, 3 * 8, 64), generator=gen, device=cuda_device)
    q = qkv[:, :, :8].detach().requires_grad_(True)
    k = torch.randn((2, 40, 2, 64), generator=gen, device=cuda_device,
                    requires_grad=True)
    v = torch.randn((2, 40, 2, 64), generator=gen, device=cuda_device,
                    requires_grad=True)
    flash_attention(q, k, v).square().sum().backward()
    cpu = [t.detach().cpu().requires_grad_(True) for t in (q, k, v)]
    flash_attention(*cpu).square().sum().backward()
    for t, c in zip((q, k, v), cpu):
        torch.testing.assert_close(t.grad.cpu(), c.grad, rtol=2e-3,
                                   atol=2e-3)


def test_flash_cuda_refuses_unsupported_head_width(cuda_device):
    q = torch.zeros((1, 8, 2, 96), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    h = torch.zeros((1, 8, 2, 64), device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(h, h, h)


@pytest.mark.parametrize("remat", ["dots_nobatch", "full"])
def test_loss_and_grads_on_card_match_cpu(cuda_device, remat):
    """loss_fn and its backward through the kernels (head_dim 64, GQA)
    against the same f32 step on the CPU through the plain versions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.tiny_gqa, d_model=256, n_heads=4,
                              n_kv_heads=2, remat=True, remat_policy=remat)
    assert cfg.head_dim == 64
    tokens = torch.randint(0, cfg.vocab_size, (2, 70),
                           generator=torch.Generator().manual_seed(0))

    def step(device):
        params = init_params(cfg, seed=0, device="cpu")
        flat = [params["embed"], params["lm_head"], params["final_norm"],
                *params["layers"].values()]
        flat = [t.to(device).requires_grad_(True) for t in flat]
        keys = list(params["layers"])
        p = {"embed": flat[0], "lm_head": flat[1], "final_norm": flat[2],
             "layers": dict(zip(keys, flat[3:]))}
        loss = loss_fn(p, tokens.to(device), cfg)
        loss.backward()
        return loss, [t.grad for t in flat]

    counts = (flash_fwd_cuda.launches, rmsnorm_bwd_cuda.launches)
    loss, grads = step(cuda_device)
    torch.cuda.synchronize()
    # Forward plus its recompute in the backward: 2 per layer.
    assert flash_fwd_cuda.launches - counts[0] == 2 * cfg.n_layers
    assert rmsnorm_bwd_cuda.launches - counts[1] == 2 * cfg.n_layers + 1
    loss_cpu, grads_cpu = step("cpu")
    torch.testing.assert_close(loss.cpu(), loss_cpu, rtol=2e-4, atol=0)
    for g, gc in zip(grads, grads_cpu):
        torch.testing.assert_close(g.cpu(), gc, rtol=2e-3, atol=2e-3)
        assert float((g.cpu() - gc).norm() / gc.norm()) <= 1e-3


def _moe_step(cfg, device, seed, expert_dtype=None):
    """One MoE training step from init_params(cfg, seed), the expert
    weights held in `expert_dtype` where given: the loss, each leaf's
    gradient in f32 and each routing call's dispatch mask, on the host."""
    from ray_tpu_torch.parallel import moe

    tokens = torch.randint(0, cfg.vocab_size, (2, 129),
                           generator=torch.Generator().manual_seed(seed))
    params = init_params(cfg, seed=seed, device="cpu")
    if expert_dtype is not None:
        for k in ("w_gate", "w_up", "w_down"):
            params["layers"][k] = params["layers"][k].to(expert_dtype)
    keys = sorted(params["layers"])
    flat = [params["embed"], params["lm_head"], params["final_norm"],
            *(params["layers"][k] for k in keys)]
    flat = [t.to(device).requires_grad_(True) for t in flat]
    p = {"embed": flat[0], "lm_head": flat[1], "final_norm": flat[2],
         "layers": dict(zip(keys, flat[3:]))}
    masks, orig = [], moe.top_k_routing

    def logged(logits, k, capacity):
        out = orig(logits, k, capacity)
        masks.append(out[0].detach().cpu())
        return out

    moe.top_k_routing = logged
    try:
        loss = loss_fn(p, tokens.to(device), cfg)
        loss.backward()
    finally:
        moe.top_k_routing = orig
    assert float(p["layers"]["router"].grad.abs().sum()) > 0
    return (loss.detach().float().cpu(),
            [t.grad.float().cpu() for t in flat], masks)


def test_moe_step_on_card_matches_cpu(cuda_device):
    """One MoE training step (mixtral's layout narrowed: d 256, 4 experts,
    2 layers, head_dim 64, GQA) through the kernels against the same f32
    step on the CPU: the same expert assignment in every routing call,
    then the loss and every gradient, the router's included."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.mixtral_8x7b, d_model=256, n_heads=4,
                              n_kv_heads=2, d_ff=512, num_experts=4,
                              n_layers=2, vocab_size=1024, max_seq=256,
                              dtype=torch.float32)
    loss, grads, routed = _moe_step(cfg, cuda_device, 4)
    loss_cpu, grads_cpu, routed_cpu = _moe_step(cfg, "cpu", 4)
    # Each layer routes in the forward and again in remat's recompute.
    assert len(routed) == len(routed_cpu) == 2 * cfg.n_layers
    for a, b in zip(routed, routed_cpu):
        assert torch.equal(a, b)
    torch.testing.assert_close(loss, loss_cpu, rtol=2e-4, atol=0)
    for g, gc in zip(grads, grads_cpu):
        torch.testing.assert_close(g, gc, rtol=2e-3, atol=2e-3)
        assert float((g - gc).norm() / gc.norm()) <= 1e-3


def test_bf16_moe_step_on_card_matches_f32_experts(cuda_device):
    """A bf16 MoE step on the card (mixtral's layout narrowed as above, one
    layer) with the expert products in bf16 (f32 accumulation) against the
    same step with the expert weights held in f32, which takes the f32
    einsums. One layer, so the router reads the same activations in both
    and routes alike (asserted, the forward and remat's recompute). Both
    products see the same bf16 values; the bf16 path rounds the gated
    product before w_down and the incoming gradients in the backward to
    bf16, each within 2^-9 of its value, and these differences reach
    every leaf through the residual stream. So the loss is within rtol
    1e-3 and each gradient leaf within a relative L2 error of 2e-2, five
    units of bf16's roundoff 2^-8 (the same step on the CPU reads at most
    6.2e-3)."""
    cfg = dataclasses.replace(configs.mixtral_8x7b, d_model=256, n_heads=4,
                              n_kv_heads=2, d_ff=512, num_experts=4,
                              n_layers=1, vocab_size=1024, max_seq=256)
    loss, grads, routed = _moe_step(cfg, cuda_device, 21)
    loss_f32, grads_f32, routed_f32 = _moe_step(cfg, cuda_device, 21,
                                                torch.float32)
    assert len(routed) == len(routed_f32) == 2
    for a, b in zip(routed, routed_f32):
        assert torch.equal(a, b)
    torch.testing.assert_close(loss, loss_f32, rtol=1e-3, atol=0)
    for g, gf in zip(grads, grads_f32):
        assert float((g - gf).norm() / gf.norm()) <= 2e-2


def test_parallel_primitives_on_a_one_rank_nccl_mesh(cuda_device, tmp_path):
    """build_mesh(MeshConfig(), "cuda") on a one-rank NCCL group; ring and
    Ulysses attention, the GPipe schedule and moe_layer through it at axis
    size 1, outputs and gradients against the unsharded references (f32,
    TF32 off): attention within 2e-4, the others within 1e-5."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import (MeshConfig, build_mesh, moe_layer,
                                        pipeline_stages, ring_attention,
                                        ulysses_attention)
    from ray_tpu_torch.parallel._comm import _gather
    from ray_tpu_torch.parallel.ring_attention import reference_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        mesh = build_mesh(MeshConfig(), "cuda")
        assert dist.get_backend() == "nccl"
        assert mesh.mesh_dim_names == ("dp", "pp", "ep", "fsdp", "sp", "tp")
        gen = torch.Generator(device=cuda_device).manual_seed(6)

        def rand(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device=cuda_device)
                    * scale).requires_grad_(True)

        def check(got_fn, want_fn, inputs, tol):
            outs = []
            for fn in (got_fn, want_fn):
                for t in inputs:
                    t.grad = None
                o = fn(*inputs)
                (o * torch.cos(torch.arange(o.numel(), device=o.device)
                               .reshape(o.shape).float())).sum().backward()
                outs.append([o.detach()] + [t.grad.clone() for t in inputs])
            for a, b in zip(*outs):
                torch.testing.assert_close(a, b, rtol=tol, atol=tol)

        q, k, v = (rand(2, 256, 4, 64) for _ in range(3))
        for causal in (True, False):
            check(lambda q, k, v: ring_attention(q, k, v, mesh,
                                                 causal=causal),
                  lambda q, k, v: reference_attention(q, k, v, causal),
                  (q, k, v), 2e-4)
        check(lambda q, k, v: ulysses_attention(q, k, v, mesh),
              lambda q, k, v: reference_attention(q, k, v, True),
              (q, k, v), 2e-4)

        def stage(w, x):
            return torch.tanh(x @ w[0])
        check(lambda w, x: pipeline_stages(stage, w, x, mesh),
              lambda w, x: torch.stack([stage(w, xi) for xi in x]),
              (rand(1, 64, 64, scale=0.1), rand(4, 8, 64)), 1e-5)

        def experts(w, xin):
            return torch.einsum("ecd,edf->ecf", xin, w)
        check(lambda x, r, w: moe_layer(x, r, experts, w, k=2, mesh=mesh)[0],
              lambda x, r, w: moe_layer(x, r, experts, w, k=2)[0],
              (rand(64, 32), rand(32, 4, scale=0.1),
               rand(4, 32, 32, scale=0.1)), 1e-5)
        y = torch.arange(8.0, device=cuda_device)
        assert torch.equal(_gather(y, mesh.get_group("tp"), 1, 0), y)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["tiny", "tiny_qwen"])
def test_engine_on_card_equals_generate(cuda_device, engines, name):
    cfg = configs.NAMED_CONFIGS[name]
    params = init_params(cfg, seed=0, device=cuda_device)
    prompts = [[1, 2, 3], [5, 6, 7, 8, 9], list(range(10, 29))]
    refs = [generate(params, [p], cfg, max_new_tokens=6)[0].tolist()
            for p in prompts]
    for mode in ("paged", "slotted"):
        eng = ContinuousBatchingEngine(params, cfg, num_slots=2, max_len=64,
                                       prefill_chunk=8, kv_mode=mode,
                                       page_size=4)
        engines.append(eng)
        outs = [eng.submit(p, 6).result(120) for p in prompts]
        assert outs == refs, mode


def test_gpu_detection_counts_the_cards(cuda_device, monkeypatch):
    """nvidia-smi (or the driver's /proc entries) finds the cards that
    torch sees, and the type label names the card."""
    from ray_tpu_torch._private.accelerators.gpu import (GPUAcceleratorManager,
                                                         gpu_type_label)
    from ray_tpu_torch._private.node import resolve_resources

    monkeypatch.delenv("RT_NUM_GPUS", raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    n = torch.cuda.device_count()
    assert GPUAcceleratorManager.get_current_node_num_accelerators() == n
    label = gpu_type_label(torch.cuda.get_device_name(0))
    assert label is not None and label.startswith("GPU-")
    assert GPUAcceleratorManager.get_current_node_accelerator_type() == label
    res = resolve_resources(num_cpus=1)
    assert res["GPU"] == float(n) and res[label] == 1.0


@pytest.mark.parametrize("zygote", ["1", "0"], ids=["zygote", "popen"])
def test_gpu_actor_launches_rmsnorm_kernel_in_its_worker(cuda_device,
                                                         monkeypatch, zygote):
    """A num_gpus=1 actor holds the detected card, runs the hand-written
    RMSNorm kernel in its own process and matches the plain version; with
    workers forked from the zygote and exec'd directly alike."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import config

    monkeypatch.delenv("RT_NUM_GPUS", raising=False)
    monkeypatch.setenv("RT_ZYGOTE_ENABLED", zygote)
    config._config = None
    rt.init(num_cpus=2)
    try:
        assert rt.cluster_resources()["GPU"] == float(torch.cuda.device_count())

        @rt.remote(num_gpus=1)
        class Kernel:
            def run(self, rows, d, dtype):
                import os

                import torch

                from ray_tpu_torch.ops.rmsnorm import _rmsnorm_plain, rmsnorm_cuda

                tdt = getattr(torch, dtype)
                gen = torch.Generator(device="cuda").manual_seed(rows + d)
                x = (torch.randn((rows, d), generator=gen, device="cuda") * 3).to(tdt)
                w = (torch.randn(d, generator=gen, device="cuda") * 0.1 + 1).to(tdt)
                rmsnorm_cuda.launches = 0
                got = rmsnorm_cuda(x, w, 1e-6)
                torch.cuda.synchronize()
                want = _rmsnorm_plain(x, w, 1e-6)
                return {"launches": rmsnorm_cuda.launches, "pid": os.getpid(),
                        "device": torch.cuda.get_device_name(0),
                        "got": got.float().cpu(), "want": want.float().cpu()}

        k = Kernel.remote()
        for dtype in ("float32", "bfloat16"):
            out = rt.get(k.run.remote(64, 4096, dtype), timeout=600)
            assert out["launches"] == 1
            assert out["pid"] != os.getpid()
            assert out["device"] == torch.cuda.get_device_name(0)
            _assert_close(out["got"].to(getattr(torch, dtype)),
                          out["want"].to(getattr(torch, dtype)))
        assert rt.available_resources().get("GPU", 0.0) == \
            float(torch.cuda.device_count()) - 1.0
    finally:
        rt.shutdown()
        config._config = None


def test_llm_deployment_on_card_equals_generate(cuda_device, monkeypatch):
    """A 2-layer f32 model served through serve.run(llm_deployment(...))
    from a num_gpus=1 replica gives generate()'s greedy tokens, unary and
    streamed, and holds the card while it lives."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import config
    from ray_tpu_torch.serve.llm import llm_deployment

    cfg = dataclasses.replace(configs.llama3_8b, n_layers=2,
                              dtype=torch.float32)

    def loader():
        import torch

        from ray_tpu_torch.models import init_params

        torch.backends.cuda.matmul.allow_tf32 = False
        return init_params(cfg, seed=3, device="cuda"), cfg

    monkeypatch.delenv("RT_NUM_GPUS", raising=False)
    config._config = None
    prompts = [[1, 2, 3], list(range(10, 139))]
    rt.init(num_cpus=2)
    try:
        h = serve.run(llm_deployment(loader, num_slots=2, max_len=256,
                                     ray_actor_options={"num_gpus": 1}),
                      name="llm")
        unary = [h.remote(p, 6).result(timeout=600) for p in prompts]
        streamed = [list(h.options(stream=True, method_name="stream")
                         .remote(p, 6)) for p in prompts]
        held = rt.available_resources().get("GPU", 0.0)
        serve.shutdown()
    finally:
        rt.shutdown()
        config._config = None
    torch.backends.cuda.matmul.allow_tf32 = False
    params = init_params(cfg, seed=3, device=cuda_device)
    refs = [generate(params, [p], cfg, max_new_tokens=6)[0].tolist()
            for p in prompts]
    assert unary == refs
    assert streamed == refs
    assert held == float(torch.cuda.device_count()) - 1.0


def _tiny_bf16_loop(config):
    """Two steps of a tiny config in bf16 on the worker's card, each
    kernel's launches counted; the process group as the worker sees it."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models import configs, init_params, loss_fn
    from ray_tpu_torch.ops.flash_attention import (flash_bwd_dkv_cuda,
                                                   flash_bwd_dq_cuda,
                                                   flash_fwd_cuda)
    from ray_tpu_torch.ops.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda
    from ray_tpu_torch.train.torch import get_device

    device = get_device()
    # head_dim 64: a width the flash kernels take.
    cfg = dataclasses.replace(configs.tiny, d_model=256, n_heads=4,
                              n_kv_heads=4, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device=device)
    leaves = [v for k, v in sorted(params.items()) if k != "layers"]
    leaves += [v for _, v in sorted(params["layers"].items())]
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=1e-4, weight_decay=1e-4)
    counters = [rmsnorm_cuda, rmsnorm_bwd_cuda, flash_fwd_cuda,
                flash_bwd_dq_cuda, flash_bwd_dkv_cuda]
    tokens = torch.randint(0, cfg.vocab_size, (2, 2, 65), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(1))
    for step in range(2):
        for c in counters:
            c.launches = 0
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens[step], cfg)
        loss.backward()
        grads = train.allreduce_gradients([t.grad for t in leaves])
        for t, g in zip(leaves, grads):
            t.grad = g
        opt.step()
        train.report({"step": step, "loss": loss.item(),
                      "launches": [c.launches for c in counters],
                      "backend": dist.get_backend(),
                      "world": dist.get_world_size(), "device": str(device),
                      "devices": torch.cuda.device_count(),
                      "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})


def _fit_tiny_on_card(monkeypatch, tmp_path, backend_config=None):
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import config
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    monkeypatch.delenv("RT_NUM_GPUS", raising=False)
    config._config = None
    rt.init(num_cpus=2)
    try:
        result = TorchTrainer(
            _tiny_bf16_loop,
            backend_config=backend_config,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="gpu", storage_path=str(tmp_path)),
        ).fit()
        deadline = time.monotonic() + 60
        while rt.available_resources().get("GPU", 0.0) != \
                float(torch.cuda.device_count()):
            assert time.monotonic() < deadline
            time.sleep(0.1)
    finally:
        rt.shutdown()
        config._config = None
    assert result.error is None, result.error
    return result.metrics_history


def test_torch_trainer_on_card_with_nccl(cuda_device, monkeypatch, tmp_path):
    """A one-worker TorchTrainer with ScalingConfig(use_gpu=True) trains on
    the card over an NCCL group of one, its kernels launched in the
    worker, and hands the GPU back when the fit ends."""
    hist = _fit_tiny_on_card(monkeypatch, tmp_path)
    assert [m["step"] for m in hist] == [0, 1]
    L = configs.tiny.n_layers
    for m in hist:
        assert m["backend"] == "nccl" and m["world"] == 1
        assert m["device"] == "cuda:0"
        # Without remat: two norms a layer and the final one forward,
        # each backward once; attention once a layer.
        assert m["launches"] == [2 * L + 1, 2 * L + 1, L, L, L]
        assert torch.isfinite(torch.tensor(m["loss"]))


def test_torch_trainer_on_card_with_gloo(cuda_device, monkeypatch, tmp_path):
    """ScalingConfig(use_gpu=True) with TorchConfig(backend="gloo"): the
    worker still computes on the card it holds, and the raylet has
    confined it to that one card."""
    from ray_tpu_torch.train import TorchConfig

    hist = _fit_tiny_on_card(monkeypatch, tmp_path,
                             TorchConfig(backend="gloo"))
    assert [m["step"] for m in hist] == [0, 1]
    L = configs.tiny.n_layers
    first_card = (os.environ.get("CUDA_VISIBLE_DEVICES") or "0").split(",")[0]
    for m in hist:
        assert m["backend"] == "gloo" and m["world"] == 1
        assert m["device"] == "cuda:0"
        assert m["devices"] == 1 and m["visible"] == first_card
        assert m["launches"] == [2 * L + 1, 2 * L + 1, L, L, L]
        assert torch.isfinite(torch.tensor(m["loss"]))


def test_checkpoint_round_trip_of_cuda_bf16_tensors(cuda_device, tmp_path):
    """Checkpoint.from_pytree of CUDA bf16 tensors and AdamW-like state
    comes back on the card, bit for bit; AsyncCheckpointer's snapshot is
    taken before save() returns."""
    from ray_tpu_torch.train import AsyncCheckpointer, Checkpoint

    g = torch.Generator(device=cuda_device).manual_seed(0)
    tree = {"params": {"w": torch.randn(128, 64, generator=g,
                                        device=cuda_device)
                       .to(torch.bfloat16),
                       "b": torch.randn(64, generator=g, device=cuda_device)},
            "opt": [torch.zeros(3, device=cuda_device), torch.tensor(4.0)],
            "step": 4}
    back = Checkpoint.from_pytree(tree, str(tmp_path / "c")).to_pytree()
    assert back["params"]["w"].device.type == "cuda"
    assert back["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["w"].view(torch.int16),
                       tree["params"]["w"].view(torch.int16))
    assert torch.equal(back["params"]["b"], tree["params"]["b"])
    assert back["opt"][1].device.type == "cpu" and back["step"] == 4
    want = tree["params"]["b"].cpu()
    ck = AsyncCheckpointer()
    c = ck.save(str(tmp_path / "a"), tree)
    tree["params"]["b"].add_(1.0)
    ck.wait()
    got = Checkpoint(c.path).to_pytree(device="cpu")
    assert torch.equal(got["params"]["b"], want)


def _tune_on_card(monkeypatch, tmp_path, trainable, param_space):
    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig

    monkeypatch.delenv("RT_NUM_GPUS", raising=False)
    rt.init(num_cpus=2)
    try:
        grid = tune.Tuner(
            tune.with_resources(trainable, {"CPU": 1, "GPU": 1}),
            param_space=param_space,
            tune_config=tune.TuneConfig(metric="ulp", mode="min",
                                        max_concurrent_trials=1),
            run_config=RunConfig(name="gpu", storage_path=str(tmp_path))
        ).fit()
        deadline = time.monotonic() + 60
        while (rt.available_resources().get("GPU", 0.0)
               != float(torch.cuda.device_count())
               and time.monotonic() < deadline):
            time.sleep(0.1)
        gpu_after = rt.available_resources().get("GPU", 0.0)
    finally:
        rt.shutdown()
    return grid, gpu_after


def test_gpu_tune_trial_runs_the_kernel_on_its_card(cuda_device, monkeypatch,
                                                    tmp_path):
    """A {"CPU": 1, "GPU": 1} trial is granted a card and confined to it
    before its function makes a CUDA context (on the trial's own thread),
    runs the RMSNorm kernel there and matches the plain version; the GPU
    is back when the sweep ends."""

    def trial(config):
        import os
        import threading

        import torch

        from ray_tpu_torch import tune
        from ray_tpu_torch._private.accelerators.gpu import granted_gpu_ids
        from ray_tpu_torch.ops.rmsnorm import _rmsnorm_plain, rmsnorm_cuda

        gen = torch.Generator(device="cuda").manual_seed(config["seed"])
        x = (torch.randn((8, 4096), generator=gen, device="cuda") * 3).to(
            torch.bfloat16)
        w = (torch.randn(4096, generator=gen, device="cuda") * 0.1 + 1).to(
            torch.bfloat16)
        rmsnorm_cuda.launches = 0
        got = rmsnorm_cuda(x, w, 1e-6)
        want = _rmsnorm_plain(x, w, 1e-6)

        def ordered(t):
            i = t.view(torch.int16).to(torch.int32)
            return torch.where(i < 0, -(i & 0x7FFF), i)

        tune.report({"ulp": int((ordered(got) - ordered(want)).abs().max()),
                     "launches": rmsnorm_cuda.launches,
                     "device": torch.cuda.get_device_name(),
                     "devices": torch.cuda.device_count(),
                     "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                     "granted": granted_gpu_ids(),
                     "thread": threading.current_thread().name})

    from ray_tpu_torch.tune import grid_search

    grid, gpu_after = _tune_on_card(monkeypatch, tmp_path, trial,
                                    {"seed": grid_search([1, 2])})
    assert not grid.errors, grid.errors
    for r in grid:
        m = r.metrics
        assert m["ulp"] <= 1 and m["launches"] == 1
        assert m["device"] == torch.cuda.get_device_name(0)
        assert m["devices"] == 1 and m["visible"] == m["granted"][0]
        assert m["thread"] != "MainThread"
    assert gpu_after == float(torch.cuda.device_count())


def test_gpu_trial_without_a_card_raises(cuda_device, monkeypatch, tmp_path):
    """A trial whose process sees no card (CUDA_VISIBLE_DEVICES emptied
    before its CUDA context exists) fails with the port's error: the
    model's entry point does not fall back to the CPU."""

    def trial(config):
        import os

        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        from ray_tpu_torch import tune
        from ray_tpu_torch.models import configs, init_params

        init_params(configs.tiny, seed=0)  # no device given: the card
        tune.report({"ulp": 0})

    from ray_tpu_torch.tune import grid_search

    grid, gpu_after = _tune_on_card(monkeypatch, tmp_path, trial,
                                    {"x": grid_search([0])})
    assert len(grid.errors) == 1
    assert "no CUDA device is available" in str(grid.errors[0])
    assert grid[0].metrics == {}
    assert gpu_after == float(torch.cuda.device_count())


def test_compiled_dag_with_a_gpu_stage(cuda_device, monkeypatch):
    """A compiled two-stage chain: a num_gpus=1 actor runs the RMSNorm
    kernel, a CPU actor sums its rows; every output within 1 bf16 ulp of
    the plain version, one launch per execute, no channel left after
    teardown."""
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.ops.rmsnorm import _rmsnorm_plain

    monkeypatch.delenv("RT_NUM_GPUS", raising=False)
    rt.init(num_cpus=2)
    try:
        @rt.remote(num_gpus=1)
        class Norm:
            def __init__(self):
                import torch

                gen = torch.Generator(device="cuda").manual_seed(3)
                self.w = (torch.randn(4096, generator=gen, device="cuda")
                          * 0.1 + 1).to(torch.bfloat16)

            def norm(self, x):
                import torch

                from ray_tpu_torch.ops.rmsnorm import rmsnorm_cuda

                xt = torch.from_numpy(x).cuda().to(torch.bfloat16)
                return rmsnorm_cuda(xt, self.w, 1e-6).float().cpu().numpy()

            def launches(self):
                from ray_tpu_torch.ops.rmsnorm import rmsnorm_cuda

                return rmsnorm_cuda.launches

        @rt.remote
        class Sum:
            def rows(self, y):
                return y, y.astype(np.float64).sum(axis=1)

        norm, total = Norm.remote(), Sum.remote()
        with InputNode() as inp:
            dag = total.rows.bind(norm.norm.bind(inp))
        compiled = dag.experimental_compile()
        names = [c.name for c in compiled._channels]
        rng = np.random.default_rng(0)
        xs = [(rng.standard_normal((8, 4096)) * 3).astype(np.float32)
              for _ in range(20)]
        try:
            outs = [compiled.execute(x, timeout=300) for x in xs]
        finally:
            compiled.teardown()
        assert rt.get(norm.launches.remote(), timeout=60) == len(xs)
        assert not set(names) & set(os.listdir("/dev/shm"))
    finally:
        rt.shutdown()
    gen = torch.Generator(device="cuda").manual_seed(3)
    w = (torch.randn(4096, generator=gen, device="cuda") * 0.1
         + 1).to(torch.bfloat16)
    for x, (y, sums) in zip(xs, outs):
        want = _rmsnorm_plain(torch.from_numpy(x).cuda().to(torch.bfloat16),
                              w, 1e-6)
        assert _bf16_ulp_diff(torch.from_numpy(y).cuda(), want) <= 1
        np.testing.assert_allclose(sums, y.astype(np.float64).sum(axis=1))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_iter_torch_batches_onto_the_card_equal_to_the_cpu(cuda_device,
                                                           monkeypatch,
                                                           prefetch):
    """The feed to the card (pinned copy, the feed's own stream, the
    event handed to the consumer's stream) gives the CPU feed's batches
    bit for bit, every tensor on the card this process holds, and its
    FeedStats count the batches and the bytes copied."""
    import numpy as np

    import ray_tpu_torch as rt
    import ray_tpu_torch.data as rd

    monkeypatch.delenv("RT_NUM_GPUS", raising=False)
    rng = np.random.default_rng(0)
    arrays = {"tok": rng.integers(0, 32000, (100, 33), dtype=np.int64),
              "img": rng.integers(0, 255, (100, 8, 8, 3), dtype=np.uint8),
              "row": np.arange(100, dtype=np.int32)}
    rt.init(num_cpus=2)
    try:
        ds = rd.from_numpy(arrays, parallelism=7)
        cpu = list(ds.iter_torch_batches(batch_size=16, device="cpu",
                                         prefetch_batches=prefetch))
        card = []
        for b in ds.iter_torch_batches(batch_size=16,
                                       prefetch_batches=prefetch):
            # Work on the consumer's stream right away, as a step does.
            card.append({k: (v * 1).cpu() for k, v in b.items()})
            assert {v.device for v in b.values()} == {
                torch.device("cuda", torch.cuda.current_device())}
        stats = ds._last_feed_stats.snapshot() if prefetch else None
    finally:
        rt.shutdown()
    assert len(card) == len(cpu) == 7
    for a, b in zip(card, cpu):
        for k in b:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    if prefetch:
        assert stats["batches"] == 7
        assert stats["h2d_bytes"] == sum(v.nbytes for v in arrays.values())


def test_gpu_actor_pool_map_batches_runs_on_its_card(cuda_device,
                                                     monkeypatch):
    """map_batches(cls, compute=ActorPoolStrategy(size=1),
    resources={"GPU": 1}): the pool actor holds the card the raylet
    granted it (CUDA_VISIBLE_DEVICES), computes there, and the card is
    free again once the pool closes."""
    import numpy as np

    import ray_tpu_torch as rt
    import ray_tpu_torch.data as rd

    monkeypatch.delenv("RT_NUM_GPUS", raising=False)

    class OnCard:
        def __init__(self):
            import os

            from ray_tpu_torch._private.accelerators.gpu import (
                granted_gpu_ids)

            self.visible = os.environ.get("CUDA_VISIBLE_DEVICES")
            self.granted = ",".join(granted_gpu_ids())

        def __call__(self, batch):
            import torch

            x = torch.from_numpy(np.array(batch["x"])).cuda()
            n = len(x)
            return {"x": batch["x"], "sq": (x * x).cpu().numpy(),
                    "device": [str(x.device)] * n,
                    "visible": [self.visible] * n,
                    "granted": [self.granted] * n}

    rt.init(num_cpus=2)
    try:
        total = rt.cluster_resources()["GPU"]
        out = rd.from_numpy({"x": np.arange(40, dtype=np.float32)},
                            parallelism=5).map_batches(
            OnCard, compute=rd.ActorPoolStrategy(size=1),
            resources={"GPU": 1}).take_all()
        deadline = time.monotonic() + 30
        while (rt.available_resources().get("GPU", 0.0) != total
               and time.monotonic() < deadline):
            time.sleep(0.1)
        free = rt.available_resources().get("GPU", 0.0)
    finally:
        rt.shutdown()
    assert sorted(r["sq"] for r in out) == [float(i * i) for i in range(40)]
    assert {r["device"] for r in out} == {"cuda:0"}
    (pair,) = {(r["visible"], r["granted"]) for r in out}
    assert pair[0] == pair[1] and pair[0] != ""
    assert free == total


def test_loadgen_closed_loop_trace_through_a_gpu_replica(cuda_device,
                                                         monkeypatch):
    """A closed-loop trace of 8 requests (2 virtual users) streamed
    through a num_gpus=1 replica whose engine holds the tiny model on the
    card: every card ok, matched by rid to the replica's phase record,
    with as many chunks as its max_tokens."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import loadgen, serve
    from ray_tpu_torch.loadgen import trace as trace_mod

    class TraceTiny:
        def __init__(self):
            from ray_tpu_torch.models import configs, init_params

            cfg = configs.tiny
            self.engine = ContinuousBatchingEngine(
                init_params(cfg, seed=0, device="cuda"), cfg, num_slots=4,
                max_len=128)
            self.vocab = cfg.vocab_size

        def __call__(self, request):
            import numpy as np

            rng = np.random.default_rng(request["i"])
            yield from self.engine.submit(
                rng.integers(0, self.vocab, request["prompt_tokens"]),
                request["max_tokens"])

    blend = loadgen.TenantBlend([
        {"name": "a", "prompt": {"median": 16, "hi": 64, "tail_p": 0.0},
         "output": {"median": 8, "hi": 16, "tail_p": 0.0}},
        {"name": "b", "prompt": {"median": 32, "hi": 64, "tail_p": 0.0},
         "output": {"median": 4, "hi": 16, "tail_p": 0.0}}])
    header, records = trace_mod.generate(loadgen.TraceSpec(
        seed=0, duration_s=0.0, curve=loadgen.RateCurve(0.0), blend=blend,
        kind="closed", num_requests=8, concurrency=2))
    monkeypatch.delenv("RT_NUM_GPUS", raising=False)
    rt.init(num_cpus=2)
    try:
        serve.run(serve.deployment(TraceTiny, name="TraceTiny",
                                   ray_actor_options={"num_gpus": 1}).bind(),
                  name="tiny")
        result = loadgen.run_trace(header, records,
                                   loadgen.serve_call_fn("tiny"),
                                   emit_metrics=False)
        report = loadgen.reconcile(result.cards,
                                   loadgen.collect_server_records("tiny"))
        serve.shutdown()
    finally:
        rt.shutdown()
    assert [c.ok for c in result.cards] == [True] * 8
    assert [c.chunks for c in result.cards] == \
        [r["max_tokens"] for r in records]
    s = report["summary"]
    assert (s["matched"], s["unmatched"], s["errors"]) == (8, 0, 0)


# -- the collective layer (util.collective) ---------------------------------

def test_local_group_nccl_allreduce_on_the_card(cuda_device):
    """The local group over the visible cards reduces card tensors with
    NCCL and returns each result on its own card."""
    from ray_tpu_torch.util.collective.local_group import LocalGroup
    from ray_tpu_torch.util.collective.types import ReduceOp

    g = LocalGroup(device="cuda")
    n = g.world_size
    xs = [torch.full((4096,), float(i + 1), device=f"cuda:{i}")
          for i in range(n)]
    outs = g.allreduce(xs)
    for i, o in enumerate(outs):
        assert o.device == torch.device("cuda", i)
        assert torch.equal(o.cpu(), torch.full((4096,), n * (n + 1) / 2))
    assert g.last_op_info["tier"] == "local"
    assert g.last_op_info["algo"] == "nccl"
    assert torch.equal(g.allreduce(xs, ReduceOp.MAX)[0].cpu(),
                       torch.full((4096,), float(n)))


def test_dcn_round_trip_of_a_bf16_card_tensor(cuda_device):
    """A bf16 card tensor crosses a two-rank DCN ring (threads over an
    in-process KV) and comes back a bf16 tensor on its card, summed bit
    for bit as on the CPU."""
    import threading

    from ray_tpu_torch.util.collective.dcn_group import DcnGroup

    class KV:
        def __init__(self):
            self.d, self.lock = {}, threading.Lock()

        def kv_put(self, k, v, ns=None, overwrite=True):
            with self.lock:
                self.d[(ns, k)] = v

        def kv_get(self, k, ns=None):
            with self.lock:
                return self.d.get((ns, k))

        def kv_del(self, k, ns=None):
            with self.lock:
                self.d.pop((ns, k), None)

    kv = KV()
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(1 << 20, generator=gen).to(torch.bfloat16)
          for _ in range(2)]
    groups = [DcnGroup(kv, 2, r, "rt", timeout=30, op_timeout=30)
              for r in range(2)]
    outs = [None, None]

    def run(r):
        outs[r] = groups[r].allreduce(xs[r].to(cuda_device), algo="ring")

    try:
        ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
        [t.start() for t in ts]
        [t.join() for t in ts]
    finally:
        for g in groups:
            g.destroy()
    want = xs[0] + xs[1]
    for o in outs:
        assert o.device == cuda_device and o.dtype == torch.bfloat16
        assert torch.equal(o.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("scheme", ["int8", "fp8"])
def test_quant_codes_on_the_card_equal_the_cpu_codes(cuda_device, scheme):
    """encode() on the card gives the CPU's codes and scales bit for bit,
    over magnitudes from 1e-20 to 1e20 and a zero block."""
    from ray_tpu_torch.util.collective import quant

    gen = torch.Generator().manual_seed(1)
    for e in (-20, -3, 0, 3, 20):
        x = torch.randn(100_003, generator=gen) * 10.0 ** e
        x[:256] = 0.0
        a, b = quant.encode(x.to(cuda_device), scheme), quant.encode(x,
                                                                     scheme)
        assert a.codes.device == cuda_device
        assert torch.equal(a.codes.cpu(), b.codes)
        assert torch.equal(a.scales.cpu().view(torch.int32),
                           b.scales.view(torch.int32))
        assert torch.equal(quant.decode(a).cpu().view(torch.int32),
                           quant.decode(b).view(torch.int32))


# -- the RL stack (ray_tpu_torch.rl) on the card ------------------------------

def _nature_cnn_spec():
    from ray_tpu_torch.models.conv import ATARI_FILTERS
    from ray_tpu_torch.rl import ConvModuleSpec

    return ConvModuleSpec((84, 84, 4), 6, conv_filters=ATARI_FILTERS,
                          feature_dim=128, hidden=(64,))


def _ppo_batch(n, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    # Dense frames: on exact-zero regions the card's f32 3 x 3 convolution
    # returns rounding-sized values where the CPU's are 0, and a ReLU's
    # gradient then passes on one side only (chip_smoke.py FrameSideEnv).
    return {"obs": rng.uniform(size=(n, 84, 84, 4)).astype(np.float32),
            "actions": rng.integers(0, 6, n).astype(np.int32),
            "logp": np.full(n, -1.79, np.float32),
            "advantages": rng.normal(size=n).astype(np.float32),
            "returns": rng.normal(size=n).astype(np.float32)}


def test_rl_nature_cnn_on_the_card_matches_the_cpu(cuda_device):
    """The Nature-CNN policy's logits, values, PPO loss and every gradient
    on the card within rtol = atol = 1e-4 of the CPU's (f32, TF32 off)."""
    from ray_tpu_torch.rl import ConvPolicyModule, ppo_loss

    cpu = ConvPolicyModule(_nature_cnn_spec()).init(0)
    card = ConvPolicyModule(_nature_cnn_spec()).to(cuda_device)
    card.set_weights(cpu.get_weights())
    b = _ppo_batch(32)
    flags = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        outs = []
        for mod, dev in ((cpu, "cpu"), (card, cuda_device)):
            tb = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            out = mod(tb["obs"])
            loss, _ = ppo_loss(mod, tb)
            outs.append([out["action_logits"], out["value"], loss,
                         *torch.autograd.grad(loss, list(mod.parameters()))])
    finally:
        torch.backends.cudnn.allow_tf32 = flags
    for want, got in zip(*outs):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_rl_learner_computes_on_the_card_by_default(cuda_device):
    from ray_tpu_torch.rl import ConvPolicyModule, Learner, ppo_loss

    learner = Learner(ConvPolicyModule(_nature_cnn_spec()), ppo_loss, seed=0)
    assert learner.device.type == "cuda"
    b = _ppo_batch(64, seed=1)
    first = learner.update_from_batch(b)
    for _ in range(5):
        last = learner.update_from_batch(b)
    assert last["vf_loss"] < first["vf_loss"]
    assert all(p.is_cuda for p in learner.module.parameters())
    assert all(v.is_cuda for st in learner.optimizer.state.values()
               for v in st.values() if torch.is_tensor(v) and v.dim() > 0)


def test_rl_learner_group_holds_the_card(cuda_device):
    """A LearnerGroup with no device holds the GPU through the raylet (1/N
    each) and computes on the card its worker was granted."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rl import ConvPolicyModule, LearnerGroup, ppo_loss

    spec = _nature_cnn_spec()
    rt.init(num_cpus=4)
    try:
        group = LearnerGroup(lambda: ConvPolicyModule(spec), ppo_loss,
                             num_learners=2, seed=0)
        try:
            devices = group.foreach_learner(lambda lr: str(lr.device))
            assert devices == ["cuda:0", "cuda:0"]
            m = group.update_from_batch(_ppo_batch(64, seed=2))
            assert all(map(lambda v: v == v, m.values()))
            w = group.foreach_learner(lambda lr: lr.get_weights()["pi"][0]["w"])
            assert torch.equal(torch.from_numpy(w[0]), torch.from_numpy(w[1]))
        finally:
            group.shutdown()
    finally:
        rt.shutdown()


def test_rl_dqn_restore_loads_the_target_net_onto_each_device(cuda_device,
                                                               tmp_path):
    """A DQN checkpoint saved on the CPU restores into a DQN on the card,
    and one saved on the card into a DQN on the CPU: the target and the
    online snapshots and both of the algorithm's nets equal the saved
    trees, each net on its algorithm's device
    (tests/test_torch_rl_dqn_restore.py holds the same restore against
    the JAX package on the CPU)."""
    import numpy as np

    import chip_smoke
    import ray_tpu_torch as rt
    from ray_tpu_torch.rl import DQNConfig
    from ray_tpu_torch.rl.core import convert

    def build(device):
        return (DQNConfig()
                .environment(chip_smoke.CueRecallEnv, obs_dim=3,
                             num_actions=2)
                .env_runners(num_env_runners=1, rollout_length=32)
                .training(train_batch_size=16, updates_per_iteration=4,
                          learning_starts=32, target_update_freq=2,
                          device=device)
                .build())

    def same(a, b):
        fa, fb = convert.flatten(a), convert.flatten(b)
        return fa.keys() == fb.keys() and all(
            np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])) for k in fa)

    rt.init(num_cpus=4)
    try:
        for src, dst in (("cpu", None), (None, "cpu")):
            a = build(src)
            try:
                for _ in range(3):
                    a.train()
                saved = (a.target_params, a._online_params)
                a.save(str(tmp_path / str(src)))
            finally:
                a.stop()
            b = build(dst)
            try:
                assert b.device.type == ("cpu" if dst else "cuda")
                assert not same(b.target_params, saved[0])
                b.restore(str(tmp_path / str(src)))
                assert same(b.target_params, saved[0])
                assert same(b._online_params, saved[1])
                assert same(b._target_net.get_weights(), saved[0])
                assert same(b._online_net.get_weights(), saved[1])
                for net in (b._target_net, b._online_net):
                    assert all(p.device.type == b.device.type
                               for p in net.parameters())
            finally:
                b.stop()
    finally:
        rt.shutdown()


def test_rl_sac_updates_replayed_as_a_cuda_graph_equal_eager_ones(cuda_device):
    """SAC's update on the card (2 x 256 hidden, batch 256): ten updates
    replayed as a CUDA graph (GraphedUpdates: three eager, one captured,
    then replays) leave the state bit-equal to the same ten updates run
    eagerly from the same state, minibatches and draws."""
    from ray_tpu_torch.rl.algorithms import sac
    from ray_tpu_torch.rl.core import convert
    from ray_tpu_torch.rl.core.rl_module import (ContinuousModuleSpec,
                                                 ContinuousPolicyModule)

    spec = ContinuousModuleSpec(3, 1, -2.0, 2.0, (256, 256))
    update = sac.make_sac_update(0.99, 0.005, -1.0)
    states = [sac.init_sac_state(ContinuousPolicyModule(spec).init(0).to(
        cuda_device), 3e-4) for _ in range(2)]
    g = torch.Generator(cuda_device).manual_seed(0)
    n, B = 10, 256
    batches = {"obs": torch.randn((n, B, 3), generator=g, device=cuda_device),
               "actions": torch.rand((n, B, 1), generator=g,
                                     device=cuda_device) * 2 - 1,
               "rewards": torch.randn((n, B), generator=g, device=cuda_device),
               "next_obs": torch.randn((n, B, 3), generator=g,
                                       device=cuda_device),
               "dones": torch.zeros((n, B), device=cuda_device)}
    noise = torch.randn((n, 2, B, 1), generator=g, device=cuda_device)

    def one(state):
        return lambda b, z: update(state, b, {"next": z[0], "pi": z[1]})

    for i in range(n):
        want = one(states[0])({k: v[i] for k, v in batches.items()}, noise[i])
    got = sac.GraphedUpdates(one(states[1])).run(batches, noise)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    a, b = (convert.flatten(sac.sac_state_to_jax(st)) for st in states)
    for k in a:
        assert (a[k] == b[k]).all(), k
    assert int(a["pi_opt.count"]) == n
