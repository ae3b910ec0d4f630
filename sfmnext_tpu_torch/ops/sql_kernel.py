"""The SQL decoder's two fused ops as Hopper kernels, and their wrappers.

Counterpart of ``sfmnext_tpu/ops/pallas/sql_kernel.py`` (forward only):

  * ``sql_summary`` -> ``sql_summary_fwd`` in ``csrc/sql_kernel.cu``
    (replaces ``_fq_fwd_kernel``, the flash softmax-over-pixels summary);
  * ``sql_depth``   -> ``sql_depth_fwd`` (replaces ``_bins_fwd_kernel``,
    the per-pixel bins head over recomputed energies).

The wrappers keep the JAX signatures (``[B,H,W,E]`` features) and check
device, dtype, shape, contiguity and alignment, raising ``ValueError`` on
anything the kernels do not take. A tensor on the CPU takes the plain
version in ``ops/sql_attention.py``; a CUDA tensor launches the kernel or
raises. Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from sfmnext_tpu_torch.ops import _build, sql_attention

MAX_Q = 128
MAX_D = 128
MAX_E = 128
_SUMMARY_TILE = 64  # pixels per summary tile in the kernel


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_tensor(name: str, t: torch.Tensor, dtype, shape) -> None:
    _require(t.dtype == dtype, f"{name}: dtype {t.dtype}, expected {dtype}")
    _require(tuple(t.shape) == tuple(shape),
             f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def _check_features_queries(features, queries):
    _require(features.dim() == 4, f"features must be [B,H,W,E], got {tuple(features.shape)}")
    _require(queries.dim() == 3, f"queries must be [B,Q,E], got {tuple(queries.shape)}")
    b, h, w, e = features.shape
    q = queries.shape[1]
    _require(0 < e <= MAX_E and e % 8 == 0, f"E={e}: the kernels take E % 8 == 0, E <= {MAX_E}")
    _require(0 < q <= MAX_Q, f"Q={q}: the kernels take Q <= {MAX_Q}")
    _check_tensor("features", features, torch.bfloat16, (b, h, w, e))
    _check_tensor("queries", queries, torch.bfloat16, (b, q, e))
    return b, h * w, q, e


def _kernel_device(*tensors) -> torch.device:
    """The tensors' common device; the CPU or a CUDA card, nothing else."""
    dev = tensors[0].device
    _require(all(t.device == dev for t in tensors), "inputs lie on different devices")
    _require(dev.type in ("cpu", "cuda"), f"no kernel for device {dev}")
    return dev


def _raise_on_error(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.sql_kernel_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")


def sql_summary(features: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Softmax-over-pixels summary [B,Q,E] float32 of bf16 features
    [B,H,W,E] and queries [B,Q,E]: the summary half of sql_full_query."""
    b, n, q, e = _check_features_queries(features, queries)
    dev = _kernel_device(features, queries)
    if dev.type == "cpu":
        return sql_attention.sql_full_query(features, queries)[1]
    lib = _build.library()
    # about two blocks per SM over all B*N pixels, in whole tiles
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = -(-b * n // (2 * sms * _SUMMARY_TILE))
    chunk = _SUMMARY_TILE * max(1, tiles)
    n_chunks = -(-n // chunk)
    f32 = dict(device=dev, dtype=torch.float32)
    part_m = torch.empty((b, n_chunks, q), **f32)
    part_z = torch.empty((b, n_chunks, q), **f32)
    part_acc = torch.empty((b, n_chunks, q, e), **f32)
    out = torch.empty((b, q, e), **f32)
    with torch.cuda.device(dev):
        err = lib.sql_summary_fwd(
            features.data_ptr(), queries.data_ptr(), part_m.data_ptr(),
            part_z.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
            b, n, q, e, chunk, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error(lib, err, "sql_summary_fwd")
    sql_summary.launches += 1
    return out


sql_summary.launches = 0


def sql_depth(features: torch.Tensor, queries: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Per-pixel depth [B,H,W,1] float32 from bf16 features [B,H,W,E] and
    queries [B,Q,E], the bins conv (w [Q,D] bf16, bias [D] float32) and the
    bin centers [B,D] float32: sql_bins_to_depth over the recomputed
    energies, in bf16 as the decoder computes it."""
    b, n, q, e = _check_features_queries(features, queries)
    _require(w.dim() == 2 and w.shape[0] == q, f"w must be [Q={q},D], got {tuple(w.shape)}")
    d = w.shape[1]
    _require(0 < d <= MAX_D, f"D={d}: the kernel takes D <= {MAX_D}")
    _check_tensor("w", w, torch.bfloat16, (q, d))
    _check_tensor("bias", bias, torch.float32, (d,))
    _check_tensor("centers", centers, torch.float32, (b, d))
    dev = _kernel_device(features, queries, w, bias, centers)
    _, h, wd, _ = features.shape
    if dev.type == "cpu":
        return sql_attention.sql_bins_to_depth(
            sql_attention.sql_energy(features, queries), w, bias, centers,
            compute_dtype=torch.bfloat16,
        )
    lib = _build.library()
    out = torch.empty((b, h, wd, 1), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = lib.sql_depth_fwd(
            features.data_ptr(), queries.data_ptr(), w.data_ptr(),
            bias.data_ptr(), centers.data_ptr(), out.data_ptr(),
            b, n, q, e, d, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error(lib, err, "sql_depth_fwd")
    sql_depth.launches += 1
    return out


sql_depth.launches = 0
