"""Self-Query-Layer cross-attention, plain PyTorch.

Counterpart of ``sfmnext_tpu/ops/sql_attention.py``: the FullQueryLayer
(energy maps + softmax-over-pixels summary) and the energy -> bins ->
depth head. These are the plain versions of the two Hopper kernels in
``ops/sql_kernel.py``: the CPU path of their wrappers, the unfused decoder
path (f32 models, ``return_energy``), and what the kernels are checked
against on the card.

bf16 numerics follow the JAX/XLA path exactly: products of bf16 values
are accumulated in float32 (the operands are upcast, which is exact), and
bf16 rounding happens at the JAX cast points only (``attn.astype(s.dtype)``,
``energy.astype(cd)``, ``p.astype(cd)``).
"""

from __future__ import annotations

import torch


def sql_energy(features: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Energy maps [B,H,W,Q] float32: <features[b,h,w,:], queries[b,q,:]>,
    the products taken in float32 over the features' dtype."""
    queries = queries.to(features.dtype).float()
    return torch.einsum("bhwe,bqe->bhwq", features.float(), queries)


def sql_full_query(features: torch.Tensor, queries: torch.Tensor):
    """FullQueryLayer: energy maps + softmax-over-pixel summary embeddings.

    Args:
      features: [B,H,W,E] per-pixel features.
      queries:  [B,Q,E] coarse queries.
    Returns:
      energy:  [B,H,W,Q] float32 dot-product energies.
      summary: [B,Q,E] float32, softmax normalised over the H*W pixels.
    """
    b, h, w, e = features.shape
    energy = sql_energy(features, queries)
    s = features.reshape(b, h * w, e).float()
    # softmax over the pixels, taken on the last axis: over a middle axis
    # this long PyTorch's softmax is ~600x slower (98.6 ms at B=4,
    # N=81,920, Q=128 on an H100)
    attn = torch.softmax(energy.reshape(b, h * w, -1).transpose(1, 2), dim=-1)
    attn = attn.to(features.dtype).float()  # [B,Q,N]
    # one 2D product per sample: cuBLAS splits the long pixel reduction of a
    # 2D GEMM across the card but not of the batched one (0.18 ms against
    # 2.8 ms for B=4 on an H100)
    summary = torch.stack([a @ x for a, x in zip(attn, s)])
    return energy, summary


def sql_bins_to_depth(energy, weight, bias, centers, compute_dtype=None):
    """Per-pixel depth from energies: softmax_D(energy @ W + b) . centers.

    Args:
      energy: [B,H,W,Q]; weight: [Q,D] (the prob 1x1 conv); bias: [D];
      centers: [B,D] depth-bin centers; compute_dtype: the model's dtype
        (the products' operand dtype), default ``energy.dtype``.
    Returns:
      depth [B,H,W,1] float32.
    """
    cd = compute_dtype or energy.dtype
    logits = torch.einsum(
        "bhwq,qd->bhwd", energy.to(cd).float(), weight.to(cd).float()
    ) + bias.float()
    logits = logits - logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits)
    num = torch.einsum(
        "bhwd,bd->bhw", p.to(cd).float(), centers.to(cd).float()
    )
    den = p.sum(dim=-1)
    return (num / den)[..., None]
