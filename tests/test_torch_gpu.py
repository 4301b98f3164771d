"""Card-only tests of the PyTorch port: the CUDA kernels against their
plain versions, one training step through the kernels against the same
step on the CPU, and the engine on the card. Each test skips without a
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
element above 1e-5). dk and dv are summed without atomics, so two calls
on the same inputs give the same bits. The
training step: loss within rtol 2e-4, each gradient leaf within
rtol=atol=2e-3 and a relative L2 error of at most 1e-3.
"""

import dataclasses

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
@pytest.mark.parametrize("d", [128, 2048, 4096])
@pytest.mark.parametrize("rows", [1, 5, 8192])
def test_rmsnorm_bwd_kernel_matches_plain(cuda_device, rows, d, dtype):
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
def test_flash_dkv_kernel_is_deterministic(cuda_device, d, dtype):
    """dk and dv are summed without atomics: two calls on the same inputs
    give the same bits."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(d)

    def rand(n):
        return torch.randn((2, n, 4, d), generator=gen,
                           device=cuda_device).to(tdt)

    q, k, v, do = rand(300), rand(300), rand(300), rand(300)
    o, lse = flash_fwd_cuda(q, k, v, True)
    delta = _delta(o, do)
    first = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True)
    second = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True)
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
