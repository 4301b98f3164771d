"""Parity of the PyTorch port's ops (ray_tpu_torch.ops) with the JAX
package's, on the same numpy inputs.

rmsnorm: the port's plain version against JAX `_rmsnorm_ref` and against
the Pallas kernel in interpret mode. f32 agrees within 1e-5 (both sum the
row in f32, in different orders); bf16 within 1 bf16 ulp (the same f32
result can round to either neighbour when the sums differ in their last
bits). Gradients (the plain backward, `_rmsnorm_bwd_plain`, through the
autograd Function) within 1e-4 of the Pallas backward in interpret mode
and of the jnp custom VJP, the reference's own tolerance.

flash attention: the plain forward, lse and backward through
`_FlashAttention` against the Pallas kernels in interpret mode, and
`flash_attention_plain` against the jnp path: outputs within 2e-4 and
gradients within 2e-3, the reference's interpret tolerances.

cross-entropy: loss within rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 /
atol 1e-5, the chunked loss within rtol 1e-5 and its gradients within
rtol 2e-4 / atol 2e-5, as the reference's tests hold its own versions.

The bf16 tensor-core flash kernels round p (forward) and p^T, ds^T
(dk/dv) to bf16 before their products; their arithmetic, emulated on the
CPU, is held to the plain versions in f32 with the bf16 tolerance the
card's checks apply (relative L2 <= 4e-3, max <= 2^-6 max|ref|), so the
design meets the tolerance before any kernel runs.

The CUDA kernels themselves are held to the plain versions on the card
(tests/test_torch_gpu.py, and chip_smoke.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import cross_entropy as jax_ce
from ray_tpu.ops.flash_attention import _fwd_pallas
from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu.ops.rmsnorm import _rmsnorm_pallas, _rmsnorm_ref, _rmsnorm_xla
from ray_tpu.ops.rmsnorm import rmsnorm as jax_rmsnorm
from ray_tpu.ops.rope import apply_rope as jax_apply_rope
from ray_tpu.ops.rope import rope_frequencies as jax_rope_frequencies
from ray_tpu_torch.ops import (apply_rope, flash_attention, rmsnorm,
                               rope_frequencies, softmax_cross_entropy)
from ray_tpu_torch.ops.cross_entropy import chunked_lm_head_ce
from ray_tpu_torch.ops.flash_attention import (DESIGNS, _delta,
                                               _flash_bwd_dkv_plain,
                                               _flash_bwd_dq_plain,
                                               _flash_bwd_plain,
                                               _flash_fwd_plain,
                                               _FlashAttention, _valid,
                                               flash_attention_plain,
                                               flash_bwd_dkv_cuda,
                                               flash_bwd_dq_cuda,
                                               flash_fwd_cuda, launch_counter)
from ray_tpu_torch.ops.rmsnorm import (_rmsnorm_bwd_plain, _rmsnorm_plain,
                                       rmsnorm_bwd_cuda, rmsnorm_cuda)

torch.set_num_threads(1)

EPS = 1e-6


def _bf16_ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance between two bf16 tensors in units in the last
    place (adjacent representable values are 1 apart)."""
    def ordered(t):
        i = t.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _to_torch(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(arr).to(dtype)


def _jax_to_torch(out) -> torch.Tensor:
    """A JAX array (f32 or bf16) as a torch tensor, bits preserved."""
    arr = np.array(out)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("rows", [1, 7, 300])
def test_rmsnorm_plain_matches_jax(rows, d, dtype):
    rng = np.random.default_rng(rows * 1000 + d)
    x = rng.standard_normal((rows, d)).astype(np.float32) * 3.0
    w = (rng.standard_normal(d) * 0.1 + 1.0).astype(np.float32)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    xt, wt = _to_torch(x, tdt), _to_torch(w, tdt)
    got = _rmsnorm_plain(xt, wt, EPS)
    assert got.dtype == tdt and got.shape == (rows, d)
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    ref = _jax_to_torch(_rmsnorm_ref(xj, wj, EPS))
    # rows=300 crosses the kernel's 256-row block with a ragged tail.
    pallas = _jax_to_torch(jax_rmsnorm(xj, wj, EPS, use_pallas=True,
                                       interpret=True))
    for want in (ref, pallas):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-5)
        else:
            assert _bf16_ulp_diff(got, want) <= 1


def test_rmsnorm_dispatch_cpu_uses_plain_and_counts_nothing():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    before = rmsnorm_cuda.launches
    out = rmsnorm(x, w, EPS)
    assert torch.equal(out, _rmsnorm_plain(x, w, EPS))
    assert rmsnorm_cuda.launches == before


def test_rmsnorm_refuses_other_devices():
    x = torch.empty((2, 64), device="meta")
    with pytest.raises(ValueError):
        rmsnorm(x, torch.empty(64, device="meta"))
    with pytest.raises(ValueError):
        rmsnorm_cuda(torch.ones(2, 64), torch.ones(64))


@pytest.mark.parametrize("with_positions", [False, True])
def test_apply_rope_matches_jax(with_positions):
    b, l, h, d, max_seq = 2, 9, 3, 32, 40
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, l, h, d)).astype(np.float32)
    pos = rng.integers(0, max_seq, size=(b, l)).astype(np.int32)
    cos, sin = rope_frequencies(d, max_seq, 10000.0, device="cpu")
    jcos, jsin = jax_rope_frequencies(d, max_seq, 10000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    tpos = torch.from_numpy(pos).long() if with_positions else None
    jpos = jnp.asarray(pos) if with_positions else None
    got = apply_rope(torch.from_numpy(x), cos, sin, tpos)
    want = jax_apply_rope(jnp.asarray(x), jcos, jsin, jpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_apply_rope_clamps_positions_like_jax():
    """A JAX gather clamps an index past the table; the port clamps it
    explicitly (a CUDA gather would assert)."""
    d, max_seq = 16, 8
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 2, 1, d)).astype(np.float32)
    pos = np.array([[7, 12]], dtype=np.int32)
    cos, sin = rope_frequencies(d, max_seq, device="cpu")
    jcos, jsin = jax_rope_frequencies(d, max_seq)
    got = apply_rope(torch.from_numpy(x), cos, sin,
                     torch.from_numpy(pos).long())
    want = jax_apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 33, 64), (300, 32), (1, 128)])
def test_rmsnorm_grads_match_jax_pallas_and_xla(shape):
    """300 rows crosses the Pallas kernel's 256-row block with a ragged
    tail; the grads of sum(y * ct) for a random cotangent ct."""
    rng = np.random.default_rng(sum(shape))
    d = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32) * 2.0
    w = (rng.standard_normal(d) * 0.1 + 1.0).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    (rmsnorm(xt, wt, EPS) * torch.from_numpy(ct)).sum().backward()
    dx_direct, dw_direct = _rmsnorm_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(ct), EPS)
    assert torch.equal(xt.grad, dx_direct) and torch.equal(wt.grad, dw_direct)
    for impl in (
        lambda a, b: _rmsnorm_pallas(a, b, EPS, interpret=True),
        lambda a, b: _rmsnorm_xla(a, b, EPS),
    ):
        jdx, jdw = jax.grad(lambda a, b: (impl(a, b) * ct).sum(),
                            argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw),
                                   rtol=1e-4, atol=1e-4)


def test_rmsnorm_bf16_grads_keep_dtypes():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(
        np.float32)).bfloat16().requires_grad_(True)
    w = torch.ones(64, dtype=torch.bfloat16, requires_grad=True)
    rmsnorm(x, w, EPS).float().square().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.bfloat16
    assert torch.isfinite(x.grad.float()).all()


def _qkv(seed, b, lq, lk, h, hk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, hk, d)).astype(np.float32)
    ct = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    return q, k, v, ct


# (causal, lq, lk, heads, kv heads, head_dim): blocks of 16 leave ragged
# tails at 40 and 56; Lq != Lk only without the causal mask, as the
# reference's tests take it; 8 query heads over 2 kv heads is GQA.
_FLASH_CASES = [
    (True, 64, 64, 2, 2, 32),
    (False, 64, 64, 2, 2, 16),
    (True, 40, 40, 2, 2, 16),
    (False, 40, 56, 2, 2, 32),
    (False, 56, 24, 2, 2, 16),
    (True, 32, 32, 8, 2, 16),
]


@pytest.mark.parametrize("causal,lq,lk,h,hk,d", _FLASH_CASES)
def test_flash_attention_matches_jax_pallas(causal, lq, lk, h, hk, d):
    q, k, v, ct = _qkv(lq * 7 + lk + h, 2, lq, lk, h, hk, d)

    def jax_loss(impl):
        def f(a, b, c):
            return (jax_flash(a, b, c, causal=causal, block_q=16, block_k=16,
                              **impl) * ct).sum()
        return f

    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    pallas = {"interpret": True, "use_pallas": True}
    want_o = np.asarray(jax_flash(jq, jk, jv, causal=causal, block_q=16,
                                  block_k=16, **pallas))
    want_g = jax.grad(jax_loss(pallas), argnums=(0, 1, 2))(jq, jk, jv)
    xla_o = np.asarray(jax_flash(jq, jk, jv, causal=causal,
                                 use_pallas=False))

    # The kernels' plain versions through the autograd Function (the path
    # the kernels take on the card), GQA repeated outside as the public
    # function does.
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    kr, vr = (t.repeat_interleave(h // hk, dim=2) for t in ts[1:])
    out = _FlashAttention.apply(ts[0], kr, vr, causal, None)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_o, rtol=2e-4,
                               atol=2e-4)
    for t, g, name in zip(ts, want_g, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=2e-3,
                                   atol=2e-3, err_msg=f"d{name}")

    # The public function on the CPU: the jnp path's copy.
    ts2 = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out2 = flash_attention(*ts2, causal=causal)
    np.testing.assert_allclose(out2.detach().numpy(), xla_o, rtol=2e-5,
                               atol=2e-5)
    (out2 * torch.from_numpy(ct)).sum().backward()
    for t, g, name in zip(ts2, want_g, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=2e-3,
                                   atol=2e-3, err_msg=f"d{name}")


@pytest.mark.parametrize("causal,lq,lk", [(True, 40, 40), (False, 24, 56)])
def test_flash_fwd_plain_lse_matches_pallas(causal, lq, lk):
    """The lse the forward kernel writes (the backward's input), against
    `_fwd_pallas` in interpret mode on the [b*h, L, d] layout."""
    q, k, v, _ = _qkv(lq + lk, 1, lq, lk, 2, 2, 16)
    o, lse = _flash_fwd_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal)

    def bh(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(2, a.shape[1], 16))

    jo, jlse = _fwd_pallas(bh(q), bh(k), bh(v), causal, 16, 16,
                                      True)
    np.testing.assert_allclose(lse.reshape(2, lq).numpy(), np.asarray(jlse),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(o.permute(0, 2, 1, 3).reshape(2, lq, 16).numpy(),
                               np.asarray(jo), rtol=2e-4, atol=2e-4)


def test_flash_bwd_plain_matches_autograd_of_plain():
    """`_flash_bwd_plain` (what the two backward kernels compute) equals
    autograd through `flash_attention_plain`, f32 within 1e-5."""
    q, k, v, ct = _qkv(3, 1, 24, 24, 2, 2, 16)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention_plain(*ts, causal=True)
    (out * torch.from_numpy(ct)).sum().backward()
    o, lse = _flash_fwd_plain(*(t.detach() for t in ts), True)
    got = _flash_bwd_plain(*(t.detach() for t in ts), o, lse,
                           torch.from_numpy(ct), True)
    for t, g in zip(ts, got):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), rtol=1e-5,
                                   atol=1e-5)


def _assert_bf16_close(got, want):
    """The bf16 tolerance that tests/test_torch_gpu.py and chip_smoke.py
    hold the bf16 kernels to: relative L2 <= 4e-3 and no element further
    than 2^-6 of the largest reference magnitude, or, where the reference
    vanishes, no element above 1e-5."""
    got, want = got.float(), want.float()
    worst = float((got - want).abs().max())
    if worst <= 1e-5:
        return
    rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
    assert rel <= 4e-3, rel
    assert worst <= 2 ** -6 * float(want.abs().max()), worst


_LOG2E = 1.4426950408889634


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _tensor_core_fwd(q, k, v, causal):
    """The bf16 tensor-core forward's arithmetic, on the CPU: f32 scores of
    bf16 inputs, scaled by sm_scale * log2(e) and exponentiated with exp2
    against a running max over kv tiles (128 keys, 32 at d = 256); p
    rounded to bf16 before p v, its row sum l taken in f32; o rounded once.
    Returns (o in bf16, lse f32 [b, h, lq])."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    bk = 32 if d == 256 else 128
    valid = _valid(lq, lk, causal, "cpu")
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((b, h, lq, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, h, lq, d)
    for k0 in range(0, lk, bk):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, k0:k0 + bk])
        s = (s * (d ** -0.5 * _LOG2E)).masked_fill(~valid[:, k0:k0 + bk],
                                                   -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhqk,bkhd->bhqd", _bf16(p),
                                        vf[:, k0:k0 + bk])
        m = m_new
    l_safe = l.clamp_min(1e-20)
    o = (acc / l_safe).permute(0, 2, 1, 3).to(torch.bfloat16)
    return o, (m * math.log(2.0) + torch.log(l_safe))[..., 0]


def _tensor_core_dkv(q, k, v, do, lse, delta, causal):
    """The bf16 tensor-core dk/dv's arithmetic, on the CPU: p^T = exp(s -
    lse) and ds^T = p^T (dp^T - delta) in f32, each rounded to bf16 before
    its product (dv = p^T do, dk = sm_scale ds^T q), f32 sums, outputs
    rounded once."""
    lq, lk, d = q.shape[1], k.shape[1], q.shape[-1]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (d ** -0.5 * _LOG2E)
    p = torch.exp2(s - lse[..., None] * _LOG2E)
    p = p.masked_fill(~_valid(lq, lk, causal, "cpu"), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf16(p), dof)
    dk = d ** -0.5 * torch.einsum("bhqk,bqhd->bkhd", _bf16(ds), qf)
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def _tensor_core_dq(q, k, v, do, lse, delta, causal):
    """The bf16 tensor-core dq's arithmetic, on the CPU: scores scaled by
    sm_scale * log2(e) in f32, p = exp2(s - lse * log2(e)) and ds = p (dp -
    delta) in f32, ds rounded to bf16 before ds k, f32 sums, dq scaled by
    sm_scale and rounded once."""
    lq, lk, d = q.shape[1], k.shape[1], q.shape[-1]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (d ** -0.5 * _LOG2E)
    s = s.masked_fill(~_valid(lq, lk, causal, "cpu"), -1e30)
    p = torch.exp2(s - lse[..., None] * _LOG2E)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", _bf16(ds), kf) * d ** -0.5
    return dq.to(torch.bfloat16)


# chip_smoke.py's FLASH_CASES up to L = 129, and the training step's
# sequence at b = 1, h = 2: (causal, lq, lk, d, b, h).
@pytest.mark.parametrize("causal,lq,lk,d,b,h", [
    (True, 1, 1, 128, 2, 3), (True, 7, 7, 64, 2, 3),
    (True, 129, 129, 128, 2, 3), (True, 129, 129, 256, 2, 3),
    (False, 129, 70, 256, 2, 3), (False, 7, 129, 64, 2, 3),
    (True, 1024, 1024, 128, 1, 2),
])
def test_tensor_core_rounding_meets_bf16_tolerance(causal, lq, lk, d, b, h):
    """The bf16 forward, dq and dk/dv kernels round p, ds, p^T and ds^T to
    bf16 before their products (they feed the tensor cores from registers).
    Their arithmetic, emulated here on the CPU, stays within the bf16
    tolerance of the plain versions in f32 on the same bf16 inputs."""
    rng = np.random.default_rng(lq * 7 + lk + d)

    def rand(n):
        x = rng.standard_normal((b, n, h, d)).astype(np.float32)
        return torch.from_numpy(x).to(torch.bfloat16)

    q, k, v, do = rand(lq), rand(lk), rand(lk), rand(lq)
    f = [t.float() for t in (q, k, v, do)]
    o, lse = _tensor_core_fwd(q, k, v, causal)
    o_ref, lse_ref = _flash_fwd_plain(f[0], f[1], f[2], causal)
    _assert_bf16_close(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, rtol=2e-4, atol=2e-4)
    delta = _delta(o, do)
    dq = _tensor_core_dq(q, k, v, do, lse, delta, causal)
    _assert_bf16_close(dq, _flash_bwd_dq_plain(*f, lse, delta, causal))
    dk, dv = _tensor_core_dkv(q, k, v, do, lse, delta, causal)
    dk_ref, dv_ref = _flash_bwd_dkv_plain(*f, lse, delta, causal)
    _assert_bf16_close(dk, dk_ref)
    _assert_bf16_close(dv, dv_ref)


@pytest.mark.parametrize("fn,args", [
    (flash_fwd_cuda, ()),
    (flash_bwd_dq_cuda, ("do", "lse", "delta")),
    (flash_bwd_dkv_cuda, ("do", "lse", "delta")),
])
def test_flash_cuda_wrappers_refuse_unsupported_head_width(fn, args):
    q = torch.zeros(1, 8, 2, 96)
    extra = {"do": q, "lse": torch.zeros(1, 2, 8), "delta": torch.zeros(1, 2, 8)}
    with pytest.raises(ValueError, match=r"head_dim in \(64, 128, 256\)"):
        fn(q, q, q, *(extra[a] for a in args))
    # A supported width on a CPU tensor is refused for its device.
    q = torch.zeros(1, 8, 2, 64)
    extra["do"] = q
    with pytest.raises(ValueError, match="CUDA device"):
        fn(q, q, q, *(extra[a] for a in args))


@pytest.mark.parametrize("pass_", ["flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv"])
def test_flash_launch_counter_names_its_series(pass_):
    """flash_kernel_launches_total has one series a (pass, design): the
    pass's wrapper counts each launch under the design that served it."""
    for design in DESIGNS:
        counter, key = launch_counter(pass_, design)
        assert (counter.info["name"], counter.info["tag_keys"]) == (
            "flash_kernel_launches_total", ("pass", "design"))
        assert key == (("design", design), ("pass", pass_))
    assert DESIGNS == ("cuda_cores", "mma_sync", "wgmma")


def test_rmsnorm_bwd_cuda_refuses_cpu_and_wide_rows():
    x = torch.ones(2, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        rmsnorm_bwd_cuda(x, torch.ones(64), x)
    wide = torch.ones(2, 16384)
    with pytest.raises(ValueError, match="up to 12288"):
        rmsnorm_bwd_cuda(wide, torch.ones(16384), wide)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(10)
    logits = rng.standard_normal((3, 4, 100)).astype(np.float32) * 3
    labels = rng.integers(0, 100, size=(3, 4))
    ct = rng.standard_normal((3, 4)).astype(np.float32)
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = softmax_cross_entropy(lt, torch.from_numpy(labels))
    want = jax_ce.softmax_cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(labels))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    (got * torch.from_numpy(ct)).sum().backward()
    jg = jax.grad(lambda x: (jax_ce.softmax_cross_entropy(
        x, jnp.asarray(labels)) * ct).sum())(jnp.asarray(logits))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5)


def test_cross_entropy_bf16_grad_in_logits_dtype():
    rng = np.random.default_rng(12)
    logits = torch.from_numpy(rng.standard_normal((6, 50)).astype(
        np.float32)).bfloat16().requires_grad_(True)
    labels = torch.from_numpy(rng.integers(0, 50, size=6))
    loss = softmax_cross_entropy(logits, labels)
    assert loss.dtype == torch.float32
    loss.sum().backward()
    assert logits.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_chunked_lm_head_ce_matches_jax(softcap):
    rng = np.random.default_rng(int(softcap) + 20)
    b, s, d, vocab, chunk = 2, 16, 32, 64, 4
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    head = (rng.standard_normal((d, vocab)) * d ** -0.5).astype(np.float32)
    labels = rng.integers(0, vocab, size=(b, s))
    ht = torch.from_numpy(hidden).requires_grad_(True)
    wt = torch.from_numpy(head).requires_grad_(True)
    got = chunked_lm_head_ce(ht, wt, torch.from_numpy(labels), chunk,
                             softcap=softcap)
    got.backward()

    def jloss(hh, ww):
        return jax_ce.chunked_lm_head_ce(hh, ww, jnp.asarray(labels), chunk,
                                         softcap=softcap)

    want, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(head))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jgh), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw), rtol=2e-4,
                               atol=2e-5)
    with pytest.raises(ValueError):
        chunked_lm_head_ce(ht, wt, torch.from_numpy(labels), 5)
