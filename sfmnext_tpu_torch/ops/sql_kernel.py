"""The SQL decoder's two fused ops as Hopper kernels, with their backward
passes, and their wrappers.

Counterpart of ``sfmnext_tpu/ops/pallas/sql_kernel.py``:

  * ``sql_summary``: forward ``sql_summary_fwd`` in ``csrc/sql_kernel.cu``
    (replaces ``_fq_fwd_kernel``, the flash softmax-over-pixels summary),
    backward ``sql_summary_bwd`` (replaces ``_fq_bwd_kernel``);
  * ``sql_depth``: forward ``sql_depth_fwd`` (replaces ``_bins_fwd_kernel``,
    the per-pixel bins head over recomputed energies), backward
    ``sql_depth_bwd`` (replaces ``_bins_bwd_kernel``).

``sql_summary`` and ``sql_depth`` are ``torch.autograd.Function``s, the
counterparts of ``flash_full_query`` and ``flash_bins_depth``. The
wrappers keep the JAX signatures (``[B,H,W,E]`` features) and check
device, dtype, shape, contiguity and alignment, raising ``ValueError`` on
anything the kernels do not take. A tensor on the CPU takes the plain
version in ``ops/sql_attention.py``; a CUDA tensor launches the kernel or
raises. Each launcher counts its launches: ``sql_summary.launches`` and
``sql_depth.launches`` for the forwards, ``sql_summary_bwd.launches`` and
``sql_depth_bwd.launches`` for the backwards.
"""

from __future__ import annotations

import functools

import torch

from sfmnext_tpu_torch.ops import _build, sql_attention
from sfmnext_tpu_torch.ops._build import check_tensor, require

MAX_Q = 128
MAX_D = 128
MAX_E = 128
_TILE = 64  # pixels per block step in the forward kernels
_BWD_STEP = 128  # pixels per block step in the backward kernels


def _check_features_queries(features, queries):
    require(features.dim() == 4, f"features must be [B,H,W,E], got {tuple(features.shape)}")
    require(queries.dim() == 3, f"queries must be [B,Q,E], got {tuple(queries.shape)}")
    b, h, w, e = features.shape
    q = queries.shape[1]
    require(0 < e <= MAX_E and e % 8 == 0, f"E={e}: the kernels take E % 8 == 0, E <= {MAX_E}")
    require(0 < q <= MAX_Q, f"Q={q}: the kernels take Q <= {MAX_Q}")
    check_tensor("features", features, torch.bfloat16, (b, h, w, e))
    check_tensor("queries", queries, torch.bfloat16, (b, q, e))
    return b, h * w, q, e


def _check_bins(features, queries, w, bias, centers):
    b, n, q, e = _check_features_queries(features, queries)
    require(w.dim() == 2 and w.shape[0] == q, f"w must be [Q={q},D], got {tuple(w.shape)}")
    d = w.shape[1]
    require(0 < d <= MAX_D, f"D={d}: the kernel takes D <= {MAX_D}")
    check_tensor("w", w, torch.bfloat16, (q, d))
    check_tensor("bias", bias, torch.float32, (d,))
    check_tensor("centers", centers, torch.float32, (b, d))
    return b, n, q, e, d


def _chunk(dev, b: int, n: int, blocks_per_sm: int, tile: int = _TILE) -> int:
    """Pixels per block, in whole tiles of ``tile`` pixels, for about
    ``blocks_per_sm`` blocks per SM over the B*N pixels."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunks = max(1, blocks_per_sm * sms // b)
    tiles = -(-n // tile)
    return tile * -(-tiles // chunks)


@functools.lru_cache(maxsize=None)
def _bwd_blocks_per_sm(device_index: int, depth: bool, e: int, d: int) -> int:
    """Blocks of a backward kernel (the bins head's with ``depth``) that
    one SM of the card holds at once, as the card reports it for the
    compiled kernel: one wave of blocks covers the card."""
    lib = _build.library()
    with torch.cuda.device(device_index):
        blocks = lib.sql_bwd_blocks_per_sm(int(depth), e, d)
    if blocks <= 0:
        _build.check_error(lib, -blocks or 1, "sql_bwd_blocks_per_sm")
    return blocks


def _bwd_chunk(dev, b: int, n: int, depth: bool, e: int, d: int) -> int:
    """Pixels per backward block: whole steps, one wave over the card."""
    return _chunk(dev, b, n, _bwd_blocks_per_sm(dev.index, depth, e, d), _BWD_STEP)


def sql_summary_fwd(features: torch.Tensor, queries: torch.Tensor):
    """The summary kernel: (summary [B,Q,E], m [B,Q], z [B,Q]) float32 of
    bf16 features [B,H,W,E] and queries [B,Q,E]; m and z are the
    per-query max and partition over the pixels (no autograd)."""
    b, n, q, e = _check_features_queries(features, queries)
    dev = _build.kernel_device(features, queries)
    if dev.type == "cpu":
        return sql_attention.sql_summary_fwd(features, queries)
    lib = _build.library()
    # about two blocks per SM over all B*N pixels, in whole tiles
    chunk = _chunk(dev, b, n, 2)
    n_chunks = -(-n // chunk)
    f32 = dict(device=dev, dtype=torch.float32)
    part_m = torch.empty((b, n_chunks, q), **f32)
    part_z = torch.empty((b, n_chunks, q), **f32)
    part_acc = torch.empty((b, n_chunks, q, e), **f32)
    out = torch.empty((b, q, e), **f32)
    m = torch.empty((b, q), **f32)
    z = torch.empty((b, q), **f32)
    with torch.cuda.device(dev):
        err = lib.sql_summary_fwd(
            features.data_ptr(), queries.data_ptr(), part_m.data_ptr(),
            part_z.data_ptr(), part_acc.data_ptr(), out.data_ptr(), m.data_ptr(),
            z.data_ptr(), b, n, q, e, chunk, _build.stream(dev),
        )
    _build.check_error(lib, err, "sql_summary_fwd")
    sql_summary.launches += 1
    return out, m, z


def sql_summary_bwd(features, queries, g, m, z, delta):
    """The summary's backward kernel: (dfeatures [B,H,W,E] bf16, dqueries
    [B,Q,E] float32) from the cotangent g [B,Q,E] float32, the forward's
    m, z [B,Q] and delta = sum_e g * summary [B,Q]."""
    b, n, q, e = _check_features_queries(features, queries)
    check_tensor("g", g, torch.float32, (b, q, e))
    for name, t in (("m", m), ("z", z), ("delta", delta)):
        check_tensor(name, t, torch.float32, (b, q))
    dev = _build.kernel_device(features, queries, g, m, z, delta)
    if dev.type == "cpu":
        return sql_attention.sql_summary_bwd(features, queries, g, m, z, delta)
    lib = _build.library()
    chunk = _bwd_chunk(dev, b, n, False, e, 1)
    n_chunks = -(-n // chunk)
    ds = torch.empty_like(features)
    part_dq = torch.empty((b, n_chunks, q, e), device=dev, dtype=torch.float32)
    dq = torch.empty((b, q, e), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = lib.sql_summary_bwd(
            features.data_ptr(), queries.data_ptr(), g.data_ptr(), m.data_ptr(),
            z.data_ptr(), delta.data_ptr(), ds.data_ptr(), part_dq.data_ptr(),
            dq.data_ptr(), b, n, q, e, chunk, _build.stream(dev),
        )
    _build.check_error(lib, err, "sql_summary_bwd")
    sql_summary_bwd.launches += 1
    return ds, dq


sql_summary_bwd.launches = 0


class _SQLSummary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, queries):
        out, m, z = sql_summary_fwd(features, queries)
        ctx.save_for_backward(features, queries, m, z, out)
        return out

    @staticmethod
    def backward(ctx, g):
        features, queries, m, z, out = ctx.saved_tensors
        g = g.float().contiguous()
        delta = (g * out).sum(dim=-1)
        ds, dq = sql_summary_bwd(features, queries, g, m, z, delta)
        return ds, dq.to(queries.dtype)


def sql_summary(features: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Softmax-over-pixels summary [B,Q,E] float32 of bf16 features
    [B,H,W,E] and queries [B,Q,E]: the summary half of sql_full_query,
    differentiable in both inputs."""
    return _SQLSummary.apply(features, queries)


sql_summary.launches = 0


def sql_depth_fwd(features, queries, w, bias, centers) -> torch.Tensor:
    """The bins-head kernel: depth [B,H,W,1] float32 (no autograd)."""
    b, n, q, e, d = _check_bins(features, queries, w, bias, centers)
    dev = _build.kernel_device(features, queries, w, bias, centers)
    _, h, wd, _ = features.shape
    if dev.type == "cpu":
        return sql_attention.sql_depth_fwd(features, queries, w, bias, centers)
    lib = _build.library()
    out = torch.empty((b, h, wd, 1), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = lib.sql_depth_fwd(
            features.data_ptr(), queries.data_ptr(), w.data_ptr(),
            bias.data_ptr(), centers.data_ptr(), out.data_ptr(),
            b, n, q, e, d, _build.stream(dev),
        )
    _build.check_error(lib, err, "sql_depth_fwd")
    sql_depth.launches += 1
    return out


def sql_depth_bwd(features, queries, w, bias, centers, g):
    """The bins head's backward kernel for the cotangent g [B,H,W,1]
    float32: (dfeatures [B,H,W,E] bf16, dqueries [B,Q,E], dw [Q,D],
    dbias [D], dcenters [B,D]) float32."""
    b, n, q, e, d = _check_bins(features, queries, w, bias, centers)
    check_tensor("g", g, torch.float32, (*features.shape[:3], 1))
    dev = _build.kernel_device(features, queries, w, bias, centers, g)
    if dev.type == "cpu":
        return sql_attention.sql_depth_bwd(features, queries, w, bias, centers, g)
    lib = _build.library()
    chunk = _bwd_chunk(dev, b, n, True, e, d)
    n_chunks = -(-n // chunk)
    f32 = dict(device=dev, dtype=torch.float32)
    ds = torch.empty_like(features)
    part_dq = torch.empty((b, n_chunks, q, e), **f32)
    part_dw = torch.empty((b, n_chunks, q, d), **f32)
    part_db = torch.empty((b, n_chunks, d), **f32)
    part_dc = torch.empty((b, n_chunks, d), **f32)
    dq = torch.empty((b, q, e), **f32)
    dw = torch.empty((q, d), **f32)
    db = torch.empty((d,), **f32)
    dc = torch.empty((b, d), **f32)
    with torch.cuda.device(dev):
        err = lib.sql_depth_bwd(
            features.data_ptr(), queries.data_ptr(), w.data_ptr(), bias.data_ptr(),
            centers.data_ptr(), g.data_ptr(), ds.data_ptr(), part_dq.data_ptr(),
            part_dw.data_ptr(), part_db.data_ptr(), part_dc.data_ptr(), dq.data_ptr(),
            dw.data_ptr(), db.data_ptr(), dc.data_ptr(), b, n, q, e, d, chunk,
            _build.stream(dev),
        )
    _build.check_error(lib, err, "sql_depth_bwd")
    sql_depth_bwd.launches += 1
    return ds, dq, dw, db, dc


sql_depth_bwd.launches = 0


class _SQLDepth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, queries, w, bias, centers):
        ctx.save_for_backward(features, queries, w, bias, centers)
        return sql_depth_fwd(features, queries, w, bias, centers)

    @staticmethod
    def backward(ctx, g):
        features, queries, w, bias, centers = ctx.saved_tensors
        ds, dq, dw, db, dc = sql_depth_bwd(
            features, queries, w, bias, centers, g.float().contiguous()
        )
        return ds, dq.to(queries.dtype), dw.to(w.dtype), db, dc


def sql_depth(features: torch.Tensor, queries: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Per-pixel depth [B,H,W,1] float32 from bf16 features [B,H,W,E] and
    queries [B,Q,E], the bins conv (w [Q,D] bf16, bias [D] float32) and the
    bin centers [B,D] float32: sql_bins_to_depth over the recomputed
    energies, in bf16 as the decoder computes it; differentiable in every
    input."""
    return _SQLDepth.apply(features, queries, w, bias, centers)


sql_depth.launches = 0
