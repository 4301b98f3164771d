"""Memory-lean softmax cross-entropy over large vocabularies.

Counterpart of ray_tpu/ops/cross_entropy.py, which is plain jnp: so this
is plain PyTorch, not a kernel. The loss is computed in float32 whatever
the logits' dtype; `softmax_cross_entropy`'s backward recomputes the
softmax from the saved logsumexp instead of keeping it, and returns the
gradient in the logits' dtype. `chunked_lm_head_ce` computes the lm_head
logits a chunk of tokens at a time under activation checkpointing, so the
full [B, S, vocab] tensor never exists.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _ce_forward(logits: torch.Tensor, labels: torch.Tensor):
    """(loss [...], lse [...]) in f32."""
    lf = logits.float()
    m = lf.amax(dim=-1)
    lse = m + torch.log(torch.exp(lf - m[..., None]).sum(dim=-1))
    label_logit = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return lse - label_logit, lse


class _SoftmaxCrossEntropy(torch.autograd.Function):
    """The reference's custom_vjp: saves (logits, labels, lse)."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = _ce_forward(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        p = torch.exp(logits.float() - lse[..., None])
        onehot = F.one_hot(labels.long(), logits.shape[-1]).to(torch.float32)
        dlogits = (p - onehot) * g[..., None].float()
        return dlogits.to(logits.dtype), None


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """logits: [..., vocab]; labels: integer [...]. Returns [...] f32
    losses."""
    return _SoftmaxCrossEntropy.apply(logits, labels)


def chunked_lm_head_ce(hidden: torch.Tensor, lm_head: torch.Tensor,
                       labels: torch.Tensor, chunk: int,
                       softcap: float = 0.0) -> torch.Tensor:
    """Mean next-token loss computing lm_head logits CHUNK tokens at a
    time. hidden: [B, S, D]; lm_head: [D, V]; labels: [B, S].

    Each chunk's matmul and cross-entropy run under checkpoint: the
    backward recomputes that chunk's logits instead of keeping them, so
    peak logits memory is B * chunk * V.
    """
    b, s, _ = hidden.shape
    if s % chunk != 0:
        raise ValueError(f"seq {s} not divisible by ce_chunk {chunk}")

    def body(x, y):
        logits = x @ lm_head
        if softcap:
            logits = softcap * torch.tanh(logits.float() / softcap)
        return _ce_forward(logits, y)[0].sum()

    total = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, s, chunk):
        total = total + checkpoint(body, hidden[:, i:i + chunk],
                                   labels[:, i:i + chunk],
                                   use_reentrant=False)
    return total / (b * s)
