"""Ulysses-style sequence parallelism: all-to-all head/sequence reshard.

Counterpart of ray_tpu/parallel/ulysses.py, the alternative SP mode to
ring attention: activations arrive sequence-sharded; an all-to-all turns
them head-sharded with the whole sequence, attention runs locally, and a
second all-to-all turns the output back. Each all-to-all's backward is
the inverse all-to-all. Technique: Jacobs et al., "DeepSpeed Ulysses"
(arXiv:2309.14509).
"""

from __future__ import annotations

import torch

from ray_tpu_torch.parallel import _comm


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis_name: str = "sp", causal: bool = True,
                      attn_fn=None) -> torch.Tensor:
    """Attention with seq sharded over `axis_name` via all-to-all reshard.

    q, k, v: this rank's blocks [batch, seq/n, heads, head_dim]; heads
    must be divisible by the axis size. attn_fn(q, k, v, causal=...)
    defaults to reference_attention, as in the reference.
    """
    if attn_fn is None:
        from ray_tpu_torch.parallel.ring_attention import reference_attention

        attn_fn = reference_attention

    def scatter_heads(x):  # [B, L/n, H, D] -> [B, L, H/n, D]
        return _comm.all_to_all(x, mesh, axis_name, split_dim=2, concat_dim=1)

    def gather_heads(x):  # [B, L, H/n, D] -> [B, L/n, H, D]
        return _comm.all_to_all(x, mesh, axis_name, split_dim=1, concat_dim=2)

    out = attn_fn(scatter_heads(q), scatter_heads(k), scatter_heads(v),
                  causal=causal)
    return gather_heads(out)
