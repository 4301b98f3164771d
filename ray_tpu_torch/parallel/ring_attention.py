"""Ring attention: context parallelism over a mesh axis.

Counterpart of ray_tpu/parallel/ring_attention.py. The sequence is
sharded over the "sp" axis: each rank holds a query block, key/value
blocks rotate around the ring rank to rank, and the softmax is
accumulated online in f32 (the flash recurrence), so the result is
exact. Causal masking uses global positions, and a block wholly in the
future is skipped, as the reference's `lax.cond` skips it.

torch's point-to-point sends carry no gradient, and autograd would call
each rotation's backward only where its output reached the loss — not on
a rank whose causal ring skipped the block — so the ranks' sends would no
longer pair. The whole ring is therefore one autograd Function whose
backward runs the ring again in step: each rank recomputes its blocks'
probabilities from the saved log-sum-exp and passes k, v and their
gradient accumulators on, and one last rotation brings each block's
dk, dv home. Technique: Liu et al., "Ring Attention with Blockwise
Transformers" (arXiv:2310.01889).
"""

from __future__ import annotations

import torch

from ray_tpu_torch.parallel import _comm
from ray_tpu_torch.parallel.mesh import axis_index, axis_size

NEG_INF = -1e30


def _block_scores(q, k, bias, scale):
    """q:[B,Lq,H,D] k:[B,Lk,H,D] -> [B,H,Lq,Lk] (f32)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    return s if bias is None else s + bias


def _causal_bias(q_idx, k_idx, block_q, block_k, device):
    """Bias for a q-block at ring position q_idx vs kv-block at k_idx,
    from global positions."""
    q_pos = q_idx * block_q + torch.arange(block_q, device=device)[:, None]
    k_pos = k_idx * block_k + torch.arange(block_k, device=device)[None, :]
    return torch.where(q_pos >= k_pos, 0.0, NEG_INF).to(torch.float32)[None,
                                                                       None]


def _steps(me, n, causal):
    """(step, kv block index, attend?) for each step of the ring."""
    for i in range(n):
        k_idx = (me - i) % n
        yield i, k_idx, (not causal) or k_idx <= me


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis_name, causal):
        n, me = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
        qf, kf, vf = q.float(), k.float(), v.float()
        b, lq, h, d = q.shape
        lk = k.shape[1]
        scale = d ** -0.5
        o = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, lq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
        k_cur, v_cur = kf, vf
        for i, k_idx, attend in _steps(me, n, causal):
            if attend:
                bias = (_causal_bias(me, k_idx, lq, lk, q.device) if causal
                        else None)
                s = _block_scores(qf, k_cur, bias, scale)
                m_new = torch.maximum(m, s.amax(dim=-1))
                p = torch.exp(s - m_new[..., None])
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(dim=-1)
                o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                       v_cur)
                m = m_new
            if i < n - 1:
                k_cur, v_cur = _comm.shift([k_cur, v_cur], mesh, axis_name)
        out = o / torch.clamp(l[..., None], min=1e-20)  # [B,H,Lq,D]
        lse = m + torch.log(torch.clamp(l, min=1e-20))
        out = out.transpose(1, 2)  # [B,Lq,H,D]
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.args = (mesh, axis_name, causal, q.dtype, k.dtype, v.dtype)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, out, lse = ctx.saved_tensors
        mesh, axis_name, causal, q_dt, k_dt, v_dt = ctx.args
        n, me = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
        lq, lk, d = qf.shape[1], kf.shape[1], qf.shape[-1]
        scale = d ** -0.5
        do = do.float()
        delta = (do * out).sum(dim=-1).transpose(1, 2)  # [B,H,Lq]
        dq = torch.zeros_like(qf)
        k_cur, v_cur = kf, vf
        dk_cur, dv_cur = torch.zeros_like(kf), torch.zeros_like(vf)
        for i, k_idx, attend in _steps(me, n, causal):
            if attend:
                bias = (_causal_bias(me, k_idx, lq, lk, qf.device) if causal
                        else None)
                s = _block_scores(qf, k_cur, bias, scale)
                p = torch.exp(s - lse[..., None])  # [B,H,Lq,Lk]
                dv_cur = dv_cur + torch.einsum("bhqk,bqhd->bkhd", p, do)
                dp = torch.einsum("bqhd,bkhd->bhqk", do, v_cur)
                ds = p * (dp - delta[..., None]) * scale
                dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, k_cur)
                dk_cur = dk_cur + torch.einsum("bhqk,bqhd->bkhd", ds, qf)
            if i < n - 1:
                k_cur, v_cur, dk_cur, dv_cur = _comm.shift(
                    [k_cur, v_cur, dk_cur, dv_cur], mesh, axis_name)
        # After n - 1 rotations rank r holds block r + 1's accumulators:
        # one more brings every block's gradient home.
        dk_cur, dv_cur = _comm.shift([dk_cur, dv_cur], mesh, axis_name)
        return (dq.to(q_dt), dk_cur.to(k_dt), dv_cur.to(v_dt), None, None,
                None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis_name: str = "sp", causal: bool = True) -> torch.Tensor:
    """Exact attention with the sequence sharded over `axis_name`.

    q, k, v: this rank's blocks [batch, seq/n, heads, head_dim] of the
    global sequence (rank i holds block i). Causal masking uses global
    positions. Returns this rank's block of the output, in q's dtype.
    """
    return _Ring.apply(q, k, v, mesh, axis_name, causal)


def reference_attention(q, k, v, causal: bool = True):
    """Unsharded reference for testing parity."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        keep = (torch.arange(lq, device=q.device)[:, None]
                >= torch.arange(lk, device=q.device)[None, :])
        s = torch.where(keep[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
