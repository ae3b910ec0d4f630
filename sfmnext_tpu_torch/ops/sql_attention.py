"""Self-Query-Layer cross-attention, plain PyTorch.

Counterpart of ``sfmnext_tpu/ops/sql_attention.py``: the FullQueryLayer
(energy maps + softmax-over-pixels summary) and the energy -> bins ->
depth head, the unfused decoder path (f32 models, ``return_energy``, the
plain step), and, below them, the fused ops as the Pallas kernels compute
them: the plain versions of the four Hopper kernels in
``ops/sql_kernel.py``, which their wrappers take for CPU tensors and the
kernels are checked against on the card.

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


# ---------------------------------------------------------------------------
# The fused ops as the Pallas kernels compute them (sfmnext_tpu/ops/pallas/
# sql_kernel.py): the plain versions of the Hopper kernels' forward
# residuals and backward passes. Operands are bf16 and products accumulate
# in float32; p, de and dl round to bf16 before each product (``_bf16``)
# where the Pallas kernels round them.
# ---------------------------------------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, carried in float32 (products stay float32)."""
    return x.to(torch.bfloat16).float()


def _flat(features: torch.Tensor) -> torch.Tensor:
    b, h, w, e = features.shape
    return features.reshape(b, h * w, e).float()


def sql_summary_fwd(features: torch.Tensor, queries: torch.Tensor):
    """Summary [B,Q,E] float32 with the residuals of its backward pass,
    the per-query max m [B,Q] and partition z [B,Q] of the energies over
    the pixels (``_fq_fwd_kernel``: the unnormalised p rounds to bf16 for
    the P.S product, z sums it in float32)."""
    s = _flat(features)
    energy = torch.einsum("bqe,bne->bqn", _bf16(queries), s)
    m = energy.amax(dim=-1)
    p = torch.exp(energy - m[..., None])
    z = p.sum(dim=-1)
    summary = torch.stack([a @ x for a, x in zip(_bf16(p), s)]) / z[..., None]
    return summary, m, z


def sql_depth_fwd(features, queries, w, bias, centers):
    """Depth [B,H,W,1] float32 of the bins head over recomputed energies
    (``_bins_fwd_kernel``): softmax_D(bf16(energy) @ W + bias) . centers,
    the exp-weighted sums in float32."""
    energy = torch.einsum("bhwe,bqe->bhwq", features.float(), _bf16(queries))
    logits = torch.einsum("bhwq,qd->bhwd", _bf16(energy), w.float()) + bias
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return ((p * centers[:, None, None, :]).sum(dim=-1) / p.sum(dim=-1))[..., None]


def sql_summary_bwd(features, queries, g, m, z, delta):
    """VJP of the summary (``_fq_bwd_kernel``).

    Args:
      features: [B,H,W,E] bf16; queries: [B,Q,E] bf16.
      g: [B,Q,E] float32 cotangent of the summary.
      m, z: [B,Q] float32 from ``sql_summary_fwd``.
      delta: [B,Q] float32, sum_e g * summary.
    Returns:
      (dfeatures [B,H,W,E] bf16, dqueries [B,Q,E] float32).
    """
    s, q = _flat(features), _bf16(queries)
    energy = torch.einsum("bqe,bne->bqn", q, s)
    p = torch.exp(energy - m[..., None]) / z[..., None]       # attention
    dattn = torch.einsum("bqe,bne->bqn", _bf16(g), s)
    de = p * (dattn - delta[..., None])
    ds = (torch.einsum("bqn,bqe->bne", _bf16(de), q)
          + torch.einsum("bqn,bqe->bne", _bf16(p), _bf16(g)))
    dq = torch.einsum("bqn,bne->bqe", _bf16(de), s)
    return ds.to(torch.bfloat16).reshape(features.shape), dq


def sql_depth_bwd(features, queries, w, bias, centers, g):
    """VJP of the bins head over recomputed energies (``_bins_bwd_kernel``).

    Args:
      features: [B,H,W,E] bf16; queries: [B,Q,E] bf16; w: [Q,D] bf16;
      bias: [D] float32; centers: [B,D] float32.
      g: [B,H,W,1] float32 cotangent of the depth.
    Returns:
      (dfeatures [B,H,W,E] bf16, dqueries [B,Q,E], dw [Q,D], dbias [D],
      dcenters [B,D]), all float32 but dfeatures.
    """
    b, h, wd, e = features.shape
    s, q = _flat(features), _bf16(queries)
    energy = torch.einsum("bne,bqe->bnq", s, q)
    logits = torch.einsum("bnq,qd->bnd", _bf16(energy), w.float()) + bias
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    pn = p / p.sum(dim=-1, keepdim=True)
    gg = g.reshape(b, h * wd, 1)
    dpn = gg * centers[:, None, :]
    dl = pn * (dpn - (pn * dpn).sum(dim=-1, keepdim=True))
    dc = (pn * gg).sum(dim=1)
    db = dl.sum(dim=(0, 1))
    dw = torch.einsum("bnq,bnd->qd", _bf16(energy), _bf16(dl))
    de = torch.einsum("bnd,qd->bnq", _bf16(dl), w.float())
    ds = torch.einsum("bnq,bqe->bne", _bf16(de), q)
    dq = torch.einsum("bnq,bne->bqe", _bf16(de), s)
    return ds.to(torch.bfloat16).reshape(features.shape), dq, dw, db, dc
