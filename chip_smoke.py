#!/usr/bin/env python3
"""Drive the PyTorch port's SQLdepth inference path and its flagship
self-supervised training step on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, one line or a few each; any failure raises and exits non-zero:
  1. device: the card's name and power limit (nvidia-smi); TF32 off;
  2. build: the Hopper kernels from sfmnext_tpu_torch/csrc/ with nvcc, one
     process a source, in parallel;
  3. kernels: the two forward SQL kernels against their plain PyTorch
     versions on the card, at the flagship decoder's inference shapes
     (B=4, N=160*512, Q=128, E=32, D=128) and at a ragged N, with the max
     error and median times (CUDA events);
  4. serve: SQLdepth at the flagship config (args_files/hisfog/kitti/
     resnet_320x1024.txt: ResNet-50, 320x1024, bf16, seeded random weights)
     answers 4 requests at batch 1 and 1 at batch 4; every forward must
     launch both kernels exactly once; the fused decoder is held against
     its unfused twin (return_energy=True); forward latencies;
  5. training kernels: all ten kernels (the SQL forwards and backwards, the
     warp forward and coordinate backward, the SSIM forward, identity min
     and backward, the ColorJitter) against their plain versions at the
     training step's shapes (B=8, 320x1024, 2 warped and 2 identity
     sources, jitter on [8,3,320,1024,3]) and at ragged ones (an identity
     equal to a warped source there: it takes the ties), with median times
     of the kernel, the plain version and, where one PyTorch call computes
     the same function, that call (library_ms), and each kernel's bound (the
     larger of its bytes over 3.35 TB/s and its operations over the 989
     TFLOP/s bf16 peak, or the 67 TFLOP/s float32 one);
  6. train: the flagship training step (args_files/hisfog/kitti/
     resnet_320x1024.txt: batch 8, 320x1024, ResNet-50, bf16 autocast, SSIM
     weight 0.85, automasking; seeded weights, a fixed synthetic batch,
     flipped and colour-jittered on the card every step): 5 steps, each
     launching the SQL kernels and the SSIM forward, identity-min and
     backward kernels and the jitter once, the warp kernels twice; finite
     loss, parameters and BatchNorm statistics that move; one kernel step
     held against one plain step on the same weights and batch (augmented
     once with fixed draws), in the bf16 and in a float32 loss dtype;
     median step time, images/s and peak memory.
     Then one step with --no_ssim and no augmentation, which launches no
     SSIM or jitter kernel. With --profile, a torch.profiler breakdown of
     two flagship steps (top kernels, device idle share; the trace into
     runs/train_step_trace.json);
  7. one JSON line of kernel results, then the result line.
Without a visible CUDA card it exits 1 and prints no result. It imports
nothing of JAX and nothing of the JAX package (sfmnext_tpu).
"""

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from sfmnext_tpu_torch.config import parse_options
from sfmnext_tpu_torch.data import augment
from sfmnext_tpu_torch.data.synthetic import make_batch
from sfmnext_tpu_torch.device import cuda_device, disable_tf32
from sfmnext_tpu_torch.ops import (_build, jitter_kernel, sql_attention, sql_kernel, ssim_kernel,
                                   warp, warp_kernel)
from sfmnext_tpu_torch.sql_depth import SQLdepth
from sfmnext_tpu_torch.training import pipeline
from sfmnext_tpu_torch.training.builder import build_models
from sfmnext_tpu_torch.training.step import make_optimizer, make_train_step

ROOT = Path(__file__).resolve().parent
ARGFILE = ROOT / "args_files" / "hisfog" / "kitti" / "resnet_320x1024.txt"
B, Q, E, D = 4, 128, 32, 128
HW_MAIN = (160, 512)   # N = 81,920: the 1/2-resolution map of 320x1024
HW_RAGGED = (37, 53)   # N = 1,961: exercises the kernels' tail masks
# kernel vs plain: the JAX package's Pallas-vs-XLA tolerances
# (tests/test_sql_kernel.py): the two round to bf16 at different points
SUMMARY_TOL = dict(rtol=0.0, atol=2e-2)
DEPTH_TOL = dict(rtol=2e-2, atol=2e-2)
FUSED_TOL = dict(rtol=2e-2, atol=5e-2)  # fused vs unfused decoder
TIMING_RUNS = 25
LATENCY_RUNS = 20
SQL_SOURCE = "sfmnext_tpu_torch/csrc/sql_kernel.cu"
WARP_SOURCE = "sfmnext_tpu_torch/csrc/warp_kernel.cu"
SSIM_SOURCE = "sfmnext_tpu_torch/csrc/ssim_kernel.cu"
JITTER_SOURCE = "sfmnext_tpu_torch/csrc/jitter_kernel.cu"
# the device functions of sfmnext_tpu_torch/csrc/*.cu, as the profiler names them
PORT_KERNEL = re.compile(r"::(sql_\w+|sum_partials|warp_(fwd|bwd)_kernel|ssim_\w+_kernel|"
                         r"jitter_\w+_kernel)[(<]")
KERNELS = {  # counter name -> (source, the TPU kernel it replaces)
    "sql_summary": (SQL_SOURCE, "sfmnext_tpu/ops/pallas/sql_kernel.py:77"),     # _fq_fwd_kernel
    "sql_depth": (SQL_SOURCE, "sfmnext_tpu/ops/pallas/sql_kernel.py:237"),      # _bins_fwd_kernel
    "sql_summary_bwd": (SQL_SOURCE, "sfmnext_tpu/ops/pallas/sql_kernel.py:107"),  # _fq_bwd_kernel
    "sql_depth_bwd": (SQL_SOURCE, "sfmnext_tpu/ops/pallas/sql_kernel.py:245"),  # _bins_bwd_kernel
    "warp_border": (WARP_SOURCE, "sfmnext_tpu/ops/pallas/warp_kernel.py:167"),  # _fwd_kernel
    "warp_border_bwd": (WARP_SOURCE, "sfmnext_tpu/ops/pallas/warp_kernel.py:207"),  # _bwd_kernel
    "ssim_fwd": (SSIM_SOURCE, "sfmnext_tpu/ops/pallas/ssim_kernel.py:201"),  # _fwd_kernel
    # _ident_min_kernel
    "ssim_ident_min": (SSIM_SOURCE, "sfmnext_tpu/ops/pallas/ssim_kernel.py:441"),
    "ssim_bwd": (SSIM_SOURCE, "sfmnext_tpu/ops/pallas/ssim_kernel.py:231"),  # _bwd_kernel
    "color_jitter": (JITTER_SOURCE, "sfmnext_tpu/ops/pallas/jitter_kernel.py:86"),  # _kernel
}
COUNTERS = {
    "sql_summary": sql_kernel.sql_summary, "sql_depth": sql_kernel.sql_depth,
    "sql_summary_bwd": sql_kernel.sql_summary_bwd, "sql_depth_bwd": sql_kernel.sql_depth_bwd,
    "warp_border": warp_kernel.warp_border, "warp_border_bwd": warp_kernel.warp_border_bwd,
    "ssim_fwd": ssim_kernel.ssim_fwd, "ssim_ident_min": ssim_kernel.ssim_ident_min,
    "ssim_bwd": ssim_kernel.ssim_bwd, "color_jitter": jitter_kernel.color_jitter,
}
# launches a flagship training step makes: the jitter of its batch, one
# forward and one backward of each SQL op, two warps (frames -1 and +1),
# each with its coordinate backward, and the fused loss: the SSIM maps of
# the warped frames, the identity maps folded into the min, and their
# backward
STEP_LAUNCHES = {"sql_summary": 1, "sql_depth": 1, "sql_summary_bwd": 1,
                 "sql_depth_bwd": 1, "warp_border": 2, "warp_border_bwd": 2,
                 "ssim_fwd": 1, "ssim_ident_min": 1, "ssim_bwd": 1, "color_jitter": 1}
# the L1-only step (--no_ssim, no augmentation) launches no loss kernel
NO_SSIM_LAUNCHES = {**STEP_LAUNCHES, "ssim_fwd": 0, "ssim_ident_min": 0, "ssim_bwd": 0,
                    "color_jitter": 0}
TRAIN_ARGS = [str(ARGFILE)]  # batch 8, bf16, SSIM 0.85, automasking
TRAIN_STEPS = 5
B_TRAIN = 8
HW_TRAIN = (320, 1024)
# kernel vs plain at the training shapes. The SQL backward kernels round
# where their plain versions round but sum in another order, so a bf16
# rounding can fall the other way (bf16 is 2^-8 = 3.9e-3): each output
# within 1e-2 of its largest value. The warp kernels compute the plain
# float32 arithmetic, contracted into FMAs: 1e-5 of the largest value.
BWD_SCALED_TOL = 1e-2
WARP_SCALED_TOL = 1e-5
# kernel step vs plain step (same weights and batch, dropout and tie-break
# noise off): the two paths round the SQL ops to bf16 at different points,
# the plain SSIM stack rounds p*p, t*t and p*t to bf16 as the JAX package's
# XLA path does (the kernels keep them float32), and the bf16 network
# carries that through; loss to 1e-2 relative, each module's gradient to
# 5e-2 of its norm (read on an H100: loss 9.8e-4, pose 3.6e-2, encoder
# 1.1e-2, depth 4.3e-3)
STEP_LOSS_RTOL = 1e-2
STEP_GRAD_RTOL = {"encoder": 5e-2, "depth": 5e-2, "pose": 5e-2}
# with a float32 loss both sides compute the same loss arithmetic: the loss
# to 1e-5 (read 3.7e-7 to 4.5e-7) and the pose gradient, which the SQL ops
# barely reach, to 5e-3 (read 3.2e-4 to 4.4e-4), so a loss kernel that
# rounded to bf16 (3.6e-2, as above) fails; the encoder and the depth
# decoder carry the SQL kernels' bf16 rounding whatever the loss dtype
# (read 9.7e-3 to 1.1e-2 and 4.5e-3) and keep 5e-2
STEP_F32_LOSS_RTOL = 1e-5
STEP_F32_GRAD_RTOL = {"encoder": 5e-2, "depth": 5e-2, "pose": 5e-3}
# the SSIM kernels sum the 7x7 windows in another order than the plain
# average pool, with FMAs, and the variance E[p^2] - mu^2 cancels against
# the 9e-4 constant: maps and min to 1e-4, the argument where the winner
# leads by more than 2e-4; the backward divides by the squared SSIM
# denominator and rounds to bf16: 1e-2 of its largest value. The jitter
# computes the plain float32 formulas with FMAs: 1e-5.
SSIM_MAP_TOL = 1e-4
SSIM_BWD_SCALED_TOL = 1e-2
JITTER_TOL = 1e-5
# float32 operations per pixel, source and channel that the SSIM functions
# need, each counted once a pixel (no halo recomputed; a multiply-add
# counts 2): the window statistics are p*p, t*t and p*t (3), five
# separable 7-tap sums (5 x 12 adds), the moments (11) and SSIM's
# numerator and denominator (13). The forward adds the clipped distance,
# the L1 term, the weights and the channel mean (12); the backward adds
# the cotangents of numerator and denominator through the clip (25), the
# transposed 7-tap sums of three maps (3 x 12 adds), the product rules and
# the L1 term (10). The jitter: per pixel, the four ops (hue's HSV round
# trip most), an estimate.
SSIM_STATS_OPS = 3 + 5 * 12 + 11 + 13
SSIM_FWD_OPS = SSIM_STATS_OPS + 12
SSIM_BWD_OPS = SSIM_STATS_OPS + 25 + 3 * 12 + 10
JITTER_OPS = 60
# the card's published peaks (H100 SXM, NVIDIA's data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def synthetic_images(n, height, width, seed=0):
    """[n,H,W,3] in [0,1]: smooth random colour fields plus fine noise."""
    rng = np.random.RandomState(seed)
    coarse = torch.from_numpy(rng.rand(n, 3, height // 16, width // 16).astype(np.float32))
    smooth = torch.nn.functional.interpolate(coarse, size=(height, width), mode="bilinear")
    fine = rng.rand(n, height, width, 1).astype(np.float32)
    images = np.clip(0.8 * smooth.permute(0, 2, 3, 1).numpy() + 0.2 * fine, 0.0, 1.0)
    return np.ascontiguousarray(images)  # row-major [n,H,W,3], as decoded images are


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def median_ms(fn, runs=TIMING_RUNS, warmup=3):
    """Median device time of fn() over ``runs`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_inputs(dev, hw, seed):
    """Feats [B,H,W,E], queries, W, bias, sorted centers, as the decoder has them."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    feats = randn(B, *hw, E).to(torch.bfloat16)
    queries = randn(B, Q, E, scale=0.3).to(torch.bfloat16)
    w = randn(Q, D, scale=0.2).to(torch.bfloat16)
    bias = randn(D, scale=0.1)
    lo, hi = 0.001, 80.0
    centers = lo + (hi - lo) * torch.rand(B, D, generator=g, device=dev)
    return feats, queries, w, bias, torch.sort(centers, dim=1).values


def plain_summary(feats, queries):
    return sql_attention.sql_full_query(feats, queries)[1]


def plain_depth(feats, queries, w, bias, centers):
    return sql_attention.sql_bins_to_depth(
        sql_attention.sql_energy(feats, queries), w, bias, centers,
        compute_dtype=torch.bfloat16,
    )


def compare(got, want, rtol, atol):
    """(max abs error, all within atol + rtol*|want|)."""
    err = (got - want).abs()
    return float(err.max()), bool((err <= atol + rtol * want.abs()).all())


def check_kernels(dev):
    """Phase 3. Returns {name: {max_abs_err, ms, plain_ms}} at N=81,920."""
    results = {}
    cases = (
        ("sql_summary", sql_kernel.sql_summary, plain_summary, SUMMARY_TOL, 2),
        ("sql_depth", sql_kernel.sql_depth, plain_depth, DEPTH_TOL, 5),
    )
    for hw in (HW_MAIN, HW_RAGGED):
        inputs = kernel_inputs(dev, hw, seed=hw[0])
        n = hw[0] * hw[1]
        for name, kernel, plain, tol, n_args in cases:
            args = inputs[:n_args]
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            require(got.shape == want.shape, f"{name}: shape {got.shape} != {want.shape}")
            require(bool(torch.isfinite(got).all()), f"{name}: non-finite output at N={n}")
            err, ok = compare(got, want, **tol)
            line = f"[kernel] {name} N={n}: max_abs_err {err:.4e} ({tol})"
            if hw == HW_MAIN:
                plain_ms = median_ms(lambda: plain(*args))
                ms = median_ms(lambda: kernel(*args))
                results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
                line += f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of {TIMING_RUNS})"
            print(line, flush=True)
            require(ok, f"{name} disagrees with its plain version at N={n}")
    return results


def drive_slice(dev):
    """Phase 4. Returns the kernels' launch counts over the 5 requests."""
    opt = parse_options([str(ARGFILE)])  # bf16, seed 0, random weights
    model = SQLdepth(opt, dev)
    images = synthetic_images(4, opt.height, opt.width)

    def check(depth, b):
        require(tuple(depth.shape) == (b, opt.height, opt.width, 1),
                f"depth shape {tuple(depth.shape)}")
        require(bool(torch.isfinite(depth).all()), "non-finite depth")
        lo, hi = float(depth.min()), float(depth.max())
        require(opt.min_depth <= lo and hi <= opt.max_depth,
                f"depth [{lo}, {hi}] outside [{opt.min_depth}, {opt.max_depth}]")
        return lo, hi

    model(images[:1])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    counters = (sql_kernel.sql_summary, sql_kernel.sql_depth)
    for fn in counters:
        fn.launches = 0
    ranges = []
    for req in [images[i:i + 1] for i in range(4)] + [images]:
        before = [fn.launches for fn in counters]
        depth = model(req)
        torch.cuda.synchronize()
        ranges.append(check(depth, len(req)))
        raised = [fn.launches - n for fn, n in zip(counters, before)]
        require(raised == [1, 1], f"a forward launched the kernels {raised} times, not [1, 1]")
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"[slice] {opt.backbone}-{opt.num_layers} {opt.height}x{opt.width} "
          f"{opt.compute_dtype}: 4 requests at batch 1 + 1 at batch 4, depth in "
          f"[{min(r[0] for r in ranges):.4f}, {max(r[1] for r in ranges):.4f}], "
          f"launches {launches}", flush=True)

    with torch.inference_mode():
        x = torch.as_tensor(images, device=dev).permute(0, 3, 1, 2)
        feats = model.models.encoder(x)
        fused = model.models.depth(feats)["disp0"]
        unfused = model.models.depth(feats, return_energy=True)["disp0"]
    err, ok = compare(fused, unfused, **FUSED_TOL)
    print(f"[slice] fused vs unfused disp0 {tuple(fused.shape)}: max_abs_err "
          f"{err:.4e} ({FUSED_TOL})", flush=True)
    require(ok, "the fused decoder disagrees with its unfused twin")

    for b in (1, 4):
        for where, req in (("host", images[:b]),
                           ("device", torch.as_tensor(images[:b], device=dev))):
            times = []
            for _ in range(3 + LATENCY_RUNS):
                t0 = time.perf_counter()
                model(req)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            med = statistics.median(times[3:])
            print(f"[latency] batch {b}, images on {where}: median {med * 1e3:.3f} ms "
                  f"over {LATENCY_RUNS} forwards, {b / med:.2f} images/s", flush=True)
    return launches


def scaled_err(got, want):
    """(max abs error, max abs error over the largest |want|)."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30)


def bound_ms(nbytes, flops, peak_flops=BF16_FLOPS):
    """The least time for the work: bytes over the memory rate or products
    over the peak rate, whichever is larger; and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sql_bounds(b, n, q, e, d):
    """{kernel: (bytes, products)} of the four SQL kernels: each input read
    once and each output written once (bf16 2 bytes, float32 4)."""
    s_bytes, q_bytes = 2 * b * n * e, 2 * b * q * e
    bins_in = 2 * q * d + 4 * d + 4 * b * d
    return {
        "sql_summary": (s_bytes + q_bytes + 4 * b * q * e + 8 * b * q, 4 * b * n * q * e),
        "sql_depth": (s_bytes + q_bytes + bins_in + 4 * b * n,
                      2 * b * n * q * e + 2 * b * n * q * d),
        "sql_summary_bwd": (2 * s_bytes + q_bytes + 8 * b * q * e + 12 * b * q,
                            10 * b * n * q * e),
        "sql_depth_bwd": (2 * s_bytes + q_bytes + bins_in + 4 * b * n + 4 * b * q * e
                          + 4 * q * d + 4 * d + 4 * b * d,
                          6 * b * n * q * e + 6 * b * n * q * d),
    }


def warp_inputs(dev, b, h, w, seed):
    """A near-identity warp as the training step makes them, with samples
    past every border: image, pixel coordinates, an output cotangent."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    img = torch.rand(b, h, w, 3, device=dev, generator=gen)
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32), indexing="ij")
    fy = ys + 8 * (2 * torch.rand(b, h, w, device=dev, generator=gen) - 1)
    fx = xs + 40 * (2 * torch.rand(b, h, w, device=dev, generator=gen) - 1)
    g = torch.randn(b, h, w, 3, device=dev, generator=gen)
    return img, fy, fx, g


def plain_warp_bwd(img, fy, fx, g):
    fy, fx = fy.clone().requires_grad_(), fx.clone().requires_grad_()
    return torch.autograd.grad(warp.sample_border(img, fy, fx), (fy, fx), g)


def check_training_kernels(dev):
    """Phase 5. Returns {name: {max_abs_err, ms, plain_ms, library_ms,
    bound_ms, bound_by}} at the training step's shapes."""
    h, w = HW_TRAIN
    results = {}
    for b, hw, q, e, d in ((B_TRAIN, (h // 2, w // 2), Q, E, D), (2, HW_RAGGED, Q, E, D),
                           (2, (30, 50), 120, 56, 100)):
        main = b == B_TRAIN
        g = torch.Generator(device=dev).manual_seed(b + q)
        feats = torch.randn(b, *hw, e, generator=g, device=dev).to(torch.bfloat16)
        queries = (0.3 * torch.randn(b, q, e, generator=g, device=dev)).to(torch.bfloat16)
        wt = (0.2 * torch.randn(q, d, generator=g, device=dev)).to(torch.bfloat16)
        bias = 0.1 * torch.randn(d, generator=g, device=dev)
        centers = torch.sort(0.001 + 79.999 * torch.rand(b, d, generator=g, device=dev),
                             dim=1).values
        gsum = torch.randn(b, q, e, generator=g, device=dev)
        gdepth = torch.randn(b, *hw, 1, generator=g, device=dev)
        out, m, z = sql_attention.sql_summary_fwd(feats, queries)
        delta = (gsum * out).sum(-1)
        bins = (feats, queries, wt, bias, centers)
        cases = {
            "sql_summary": (lambda: sql_kernel.sql_summary_fwd(feats, queries)[0],
                            lambda: sql_attention.sql_summary_fwd(feats, queries)[0],
                            SUMMARY_TOL),
            "sql_depth": (lambda: sql_kernel.sql_depth_fwd(*bins),
                          lambda: plain_depth(*bins), DEPTH_TOL),
            "sql_summary_bwd": (
                lambda: sql_kernel.sql_summary_bwd(feats, queries, gsum, m, z, delta),
                lambda: sql_attention.sql_summary_bwd(feats, queries, gsum, m, z, delta),
                BWD_SCALED_TOL),
            "sql_depth_bwd": (lambda: sql_kernel.sql_depth_bwd(*bins, gdepth),
                              lambda: sql_attention.sql_depth_bwd(*bins, gdepth),
                              BWD_SCALED_TOL),
        }
        library = {}
        if main:
            # one PyTorch call computing the same function (never used by
            # the port): attention with scale 1 over the pixels as keys and
            # values, queries [B,1,Q,E], keys = values = features [B,1,N,E]
            sq = queries[:, None].clone().requires_grad_()
            sk = feats.reshape(b, 1, -1, e).clone().requires_grad_()
            sdpa_out = F.scaled_dot_product_attention(sq, sk, sk, scale=1.0)
            gout = gsum[:, None].to(torch.bfloat16)
            library["sql_summary"] = lambda: F.scaled_dot_product_attention(sq, sk, sk, scale=1.0)
            library["sql_summary_bwd"] = lambda: torch.autograd.grad(
                sdpa_out, (sq, sk), gout, retain_graph=True)
        for name, (kernel, plain, tol) in cases.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs = []
            for a, x in zip(got, want):
                require(a.shape == x.shape and a.dtype == x.dtype,
                        f"{name}: {a.shape} {a.dtype} != {x.shape} {x.dtype}")
                require(bool(torch.isfinite(a.float()).all()), f"{name}: non-finite output")
                if isinstance(tol, dict):
                    err, ok = compare(a, x, **tol)
                else:
                    err, rel = scaled_err(a, x)
                    ok = rel <= tol
                errs.append(err)
                require(ok, f"{name} disagrees with its plain version at B={b} N={feats.shape[1] * feats.shape[2]} "
                            f"Q={q} E={e} D={d}: max_abs_err {err:.4e} ({tol})")
            line = (f"[train-kernel] {name} B={b} N={hw[0] * hw[1]} Q={q} E={e} D={d}: "
                    f"max_abs_err {max(errs):.4e} ({tol})")
            if main:
                nbytes, flops = sql_bounds(b, hw[0] * hw[1], q, e, d)[name]
                bms, by = bound_ms(nbytes, flops)
                ms, plain_ms = median_ms(kernel), median_ms(plain)
                lib_ms = median_ms(library[name]) if name in library else None
                results[name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                                     bound_ms=bms, bound_by=by, library_ms=lib_ms)
                line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                         f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound {bms:.4f} ms "
                         f"({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
            print(line, flush=True)

    for b, (hh, ww) in ((B_TRAIN, HW_TRAIN), (2, HW_RAGGED)):
        main = b == B_TRAIN
        img, fy, fx, g = warp_inputs(dev, b, hh, ww, seed=hh)
        cases = {
            "warp_border": (lambda: warp_kernel.warp_border_fwd(img, fy, fx),
                            lambda: warp.sample_border(img, fy, fx)),
            "warp_border_bwd": (lambda: warp_kernel.warp_border_bwd(img, fy, fx, g),
                                lambda: plain_warp_bwd(img, fy, fx, g)),
        }
        library = {}
        if main:
            # F.grid_sample (border, align_corners=True) on the NCHW image at
            # the normalised grid, and its coordinate gradient alone
            img_nchw = img.permute(0, 3, 1, 2).contiguous()
            grid = torch.stack([fx / (ww - 1) * 2 - 1, fy / (hh - 1) * 2 - 1], dim=-1)
            g_nchw = g.permute(0, 3, 1, 2).contiguous()
            library["warp_border"] = lambda: F.grid_sample(
                img_nchw, grid, mode="bilinear", padding_mode="border", align_corners=True)
            library["warp_border_bwd"] = lambda: torch.ops.aten.grid_sampler_2d_backward(
                g_nchw, img_nchw, grid, 0, 1, True, (False, True))
        n_out = b * hh * ww
        nbytes = {"warp_border": 4 * (b * hh * ww * 3 + 2 * n_out + 3 * n_out),
                  "warp_border_bwd": 4 * (b * hh * ww * 3 + 2 * n_out + 3 * n_out + 2 * n_out)}
        flops = {"warp_border": 40 * n_out, "warp_border_bwd": 60 * n_out}
        for name, (kernel, plain) in cases.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs = []
            for a, x in zip(got, want):
                require(bool(torch.isfinite(a).all()), f"{name}: non-finite output")
                err, rel = scaled_err(a, x)
                errs.append(err)
                require(rel <= WARP_SCALED_TOL,
                        f"{name} disagrees with its plain version at {(b, hh, ww)}: {err:.4e}")
            line = (f"[train-kernel] {name} {b}x{hh}x{ww}x3: max_abs_err {max(errs):.4e} "
                    f"(scaled {WARP_SCALED_TOL})")
            if main:
                bms, by = bound_ms(nbytes[name], flops[name], F32_FLOPS)
                ms, plain_ms = median_ms(kernel), median_ms(plain)
                lib_ms = median_ms(library[name])
                results[name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                                     bound_ms=bms, bound_by=by, library_ms=lib_ms)
                line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
                         f"bound {bms:.4f} ms ({by}: {nbytes[name] / 1e6:.1f} MB)")
            print(line, flush=True)
    return results


def loss_inputs(dev, b, h, w, n, m, seed):
    """A target (smooth colour fields plus noise), n warped frames and m
    identity frames near it (float32, as the warp writes them; the nearest
    wins a pixel, so warped and identity frames both win some), and
    tie-break noise [1,H,W,m] (1e-5 * N(0,1), as the step draws it)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    target = torch.from_numpy(synthetic_images(b, h, w, seed)).to(dev)

    def near(scale):
        return (target + scale * torch.randn(b, h, w, 3, device=dev, generator=gen)).clamp(0, 1)

    preds = [near(0.05 * (k + 1)) for k in range(n)]
    idents = [near(0.05) for _ in range(m)]
    noise = 1e-5 * torch.randn(1, h, w, m, device=dev, generator=gen)
    return preds, idents, target, noise


def check_loss_kernels(dev):
    """Phase 5, the loss and augmentation kernels. Returns {name:
    {max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by}} at the
    flagship step's shapes; no single PyTorch call computes any of them."""
    results = {}
    weight, ldt = 0.85, torch.bfloat16  # the flagship step's loss
    for b, (hh, ww), n, m in ((B_TRAIN, HW_TRAIN, 2, 2), (2, HW_RAGGED, 3, 3)):
        main = b == B_TRAIN
        preds, idents, target, noise = loss_inputs(dev, b, hh, ww, n, m, seed=hh)
        if not main:  # an identity equal to a warped frame takes its ties (no noise)
            idents[0], noise = preds[0], None
        g = torch.randn(b, hh, ww, device=dev, generator=torch.Generator(device=dev).manual_seed(b))
        maps = ssim_kernel.ssim_fwd(preds, target, weight, ldt)
        out_min, arg = ssim_kernel.ssim_ident_min(idents, target, noise, maps, weight, ldt)
        dps = ssim_kernel.ssim_bwd(preds, target, g, arg, weight, ldt)
        want_maps = ssim_kernel.plain_maps(preds, target, weight, ldt)
        want_min, want_arg = ssim_kernel.plain_ident_min(idents, target, noise, want_maps,
                                                         weight, ldt)
        want_dps = ssim_kernel.plain_bwd(preds, target, g, arg, weight, ldt)
        torch.cuda.synchronize()
        for name, got in (("ssim_fwd", maps), ("ssim_ident_min", out_min), ("ssim_bwd", dps)):
            got = got if isinstance(got, tuple) else (got,)
            require(all(bool(torch.isfinite(x).all()) for x in got), f"{name}: non-finite output")
        err_maps, ok_maps = compare(maps, want_maps, 0.0, SSIM_MAP_TOL)
        err_min, ok_min = compare(out_min, want_min, 0.0, SSIM_MAP_TOL)
        ident_maps = ssim_kernel.plain_maps(idents, target, weight, ldt)
        cands = torch.cat([ident_maps if noise is None else ident_maps + noise, want_maps], dim=-1)
        top2 = cands.topk(2, dim=-1, largest=False).values
        clear = top2[..., 1] - top2[..., 0] > 2 * SSIM_MAP_TOL
        arg_off = int(((arg != want_arg) & clear).sum())
        bwd = [scaled_err(a, x) for a, x in zip(dps, want_dps)]
        err_bwd, rel_bwd = max(e for e, _ in bwd), max(r for _, r in bwd)
        shape = f"B={b} {hh}x{ww} N={n} M={m}"
        print(f"[train-kernel] ssim_fwd {shape}: max_abs_err {err_maps:.4e} (atol {SSIM_MAP_TOL})",
              flush=True)
        print(f"[train-kernel] ssim_ident_min {shape}: max_abs_err {err_min:.4e} (atol "
              f"{SSIM_MAP_TOL}); argument off at {arg_off} of {int(clear.sum())} pixels whose "
              f"winner leads by > {2 * SSIM_MAP_TOL}; automask share "
              f"{float((arg < n).float().mean()):.4f}", flush=True)
        print(f"[train-kernel] ssim_bwd {shape}: max_abs_err {err_bwd:.4e}, scaled {rel_bwd:.3e} "
              f"(scaled {SSIM_BWD_SCALED_TOL})", flush=True)
        require(ok_maps, f"ssim_fwd disagrees with its plain version at {shape}")
        require(ok_min and arg_off == 0,
                f"ssim_ident_min disagrees with its plain version at {shape}")
        require(rel_bwd <= SSIM_BWD_SCALED_TOL,
                f"ssim_bwd disagrees with its plain version at {shape}")
        if not main:
            require(not bool((arg == 0).any()), "a warped frame equal to an identity won a tie")
            require(not bool(dps[0].any()), "a warped frame that lost every tie got a gradient")
            # the identities win nearly every pixel here, so the routed
            # gradient is mostly zero: a per-source cotangent gives every
            # source a gradient at the tile tails and the reflect edges
            g_maps = torch.randn(b, hh, ww, n, device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(n))
            got = ssim_kernel.ssim_bwd(preds, target, g_maps, None, weight, ldt)
            want = ssim_kernel.plain_bwd(preds, target, g_maps, None, weight, ldt)
            torch.cuda.synchronize()
            bwd = [scaled_err(a, x) for a, x in zip(got, want)]
            err_bwd, rel_bwd = max(e for e, _ in bwd), max(r for _, r in bwd)
            print(f"[train-kernel] ssim_bwd {shape}, per-source cotangent: max_abs_err "
                  f"{err_bwd:.4e}, scaled {rel_bwd:.3e} (scaled {SSIM_BWD_SCALED_TOL})", flush=True)
            require(all(bool(x.any()) for x in want), "a per-source cotangent gave no gradient")
            require(rel_bwd <= SSIM_BWD_SCALED_TOL,
                    f"ssim_bwd disagrees with its plain version at {shape}, per-source cotangent")
            continue
        px = b * hh * ww
        work = {  # (bytes, float32 operations)
            "ssim_fwd": (4 * px * (3 * n + 3 + n), SSIM_FWD_OPS * px * n * 3),
            "ssim_ident_min": (4 * px * (3 * m + 3 + n + 2) + 4 * hh * ww * m,
                               SSIM_FWD_OPS * px * m * 3 + px * (n + m)),
            "ssim_bwd": (4 * px * (3 * n + 3 + 2 + 3 * n), SSIM_BWD_OPS * px * n * 3),
        }
        timed = {
            "ssim_fwd": (err_maps, lambda: ssim_kernel.ssim_fwd(preds, target, weight, ldt),
                         lambda: ssim_kernel.plain_maps(preds, target, weight, ldt)),
            "ssim_ident_min": (
                err_min,
                lambda: ssim_kernel.ssim_ident_min(idents, target, noise, maps, weight, ldt),
                lambda: ssim_kernel.plain_ident_min(idents, target, noise, maps, weight, ldt)),
            "ssim_bwd": (err_bwd, lambda: ssim_kernel.ssim_bwd(preds, target, g, arg, weight, ldt),
                         lambda: ssim_kernel.plain_bwd(preds, target, g, arg, weight, ldt)),
        }
        for name, (err, kernel, plain) in timed.items():
            results[name] = timed_result(name, err, kernel, plain, *work[name])

    for b, (hh, ww) in ((B_TRAIN, HW_TRAIN), (2, HW_RAGGED)):
        main = b == B_TRAIN
        frames = 3  # frames 0, -1, 1
        color = torch.from_numpy(synthetic_images(b * frames, hh, ww, seed=ww)).to(dev)
        color = color.reshape(b, frames, hh, ww, 3)
        order, factors, _ = augment.jitter_params(torch.Generator(device=dev).manual_seed(b), b)
        order[0] = torch.tensor([1, 0, 2, 3], device=dev, dtype=torch.int32)  # contrast first
        order[1] = torch.tensor([3, 2, 0, 1], device=dev, dtype=torch.int32)  # contrast last
        do_jit = torch.arange(b, device=dev) % 3 != 2
        got = jitter_kernel.color_jitter(color, order, factors, do_jit)
        want = jitter_kernel.plain_color_jitter(color, order, factors, do_jit)
        torch.cuda.synchronize()
        err, ok = compare(got, want, 0.0, JITTER_TOL)
        copied = bool(torch.equal(got[~do_jit], color[~do_jit]))
        print(f"[train-kernel] color_jitter {tuple(color.shape)}, {int(do_jit.sum())} of {b} "
              f"samples jittered: max_abs_err {err:.4e} (atol {JITTER_TOL}); the others copied "
              f"bit for bit: {copied}", flush=True)
        require(ok and copied,
                f"color_jitter disagrees with its plain version at {tuple(color.shape)}")
        if main:
            n_px = b * frames * hh * ww
            results["color_jitter"] = timed_result(
                "color_jitter", err,
                lambda: jitter_kernel.color_jitter(color, order, factors, do_jit),
                lambda: jitter_kernel.plain_color_jitter(color, order, factors, do_jit),
                2 * 4 * n_px * 3 + 4 * b * 9, JITTER_OPS * int(do_jit.sum()) * frames * hh * ww)
    return results


def timed_result(name, err, kernel, plain, nbytes, flops):
    """The kernel's and the plain version's median times and the bound
    (float32 operations), printed and returned as a kernels-line entry."""
    bms, by = bound_ms(nbytes, flops, F32_FLOPS)
    ms, plain_ms = median_ms(kernel), median_ms(plain)
    print(f"[train-kernel] {name} timed: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"n/a, bound {bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None)


def train_batch(dev, opt):
    """The fixed synthetic batch (data/synthetic.py) on the card."""
    batch = make_batch(opt.batch_size, opt.height, opt.width, tuple(opt.frame_ids), seed=0)
    batch.pop("depth_gt")
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def counts():
    return {name: fn.launches for name, fn in COUNTERS.items()}


def drive_training(dev, profile=False):
    """Phase 6. Returns the kernels' launch counts over the timed steps."""
    opt = parse_options(TRAIN_ARGS)
    require((opt.batch_size, opt.height, opt.width) == (B_TRAIN, *HW_TRAIN),
            f"unexpected training config {opt.batch_size}x{opt.height}x{opt.width}")
    batch = train_batch(dev, opt)
    models = build_models(opt, dev, train=True)
    adam, scheduler = make_optimizer(opt, models, steps_per_epoch=1000)
    step = make_train_step(opt, models, adam, scheduler, augment=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    watched = {
        "encoder.conv1": models.encoder.encoder.encoder.conv1.weight,
        "depth.conv3x3": models.depth.conv3x3.weight,
        "depth.prob": models.depth.convert_to_prob[0].weight,
        "pose.pose_conv": models.pose.pose_conv.weight,
    }
    bn = models.encoder.encoder.encoder.bn1
    before = {k: v.detach().clone() for k, v in watched.items()}
    bn_before = (bn.running_mean.clone(), bn.running_var.clone())

    step(batch, gen)  # warm-up: cuDNN plans, the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in COUNTERS.values():
        fn.launches = 0
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        start = counts()
        t0 = time.perf_counter()
        metrics = step(batch, gen)
        loss = float(metrics["loss"])  # syncs
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        made = {k: v - start[k] for k, v in counts().items()}
        require(made == STEP_LAUNCHES, f"a step launched {made}, not {STEP_LAUNCHES}")
        require(np.isfinite(loss), f"non-finite loss {loss}")
    launches = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    moved = {k: float((v.detach() - before[k]).abs().max()) for k, v in watched.items()}
    require(all(m > 0 for m in moved.values()), f"parameters did not move: {moved}")
    bn_moved = (float((bn.running_mean - bn_before[0]).abs().max()),
                float((bn.running_var - bn_before[1]).abs().max()))
    require(all(m > 0 for m in bn_moved), f"BatchNorm statistics did not move: {bn_moved}")
    depth = metrics["depth"]
    require(tuple(depth.shape) == (B_TRAIN, *HW_TRAIN, 1) and bool(torch.isfinite(depth).all()),
            f"depth {tuple(depth.shape)} not finite or misshapen")
    med = statistics.median(times)
    print(f"[train] {opt.backbone}-{opt.num_layers} {opt.height}x{opt.width} batch "
          f"{opt.batch_size} {opt.compute_dtype}, SSIM weight {opt.ssim_weight}, automasking, "
          f"flip + ColorJitter on the card: losses "
          f"{[round(x, 6) for x in losses]}; launches per step {STEP_LAUNCHES}", flush=True)
    print(f"[train] parameters moved by up to {moved}; encoder bn1 running mean/var moved "
          f"by up to {bn_moved}", flush=True)
    print(f"[train] median step {med * 1e3:.2f} ms over {TRAIN_STEPS} steps "
          f"({[round(t * 1e3, 2) for t in times]} ms), {B_TRAIN / med:.2f} images/s, "
          f"peak memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)", flush=True)
    if profile:
        profile_steps(dev, step, batch, gen)
    del models, adam, scheduler, step
    compare_steps(dev, opt, batch)
    drive_no_ssim_step(dev)
    return launches


def drive_no_ssim_step(dev):
    """One step of the L1-only loss (--no_ssim, no augmentation): finite,
    with the SQL and warp kernels' launches and none of the loss kernels'."""
    opt = parse_options(TRAIN_ARGS + ["--no_ssim"])
    models = build_models(opt, dev, train=True)
    step = make_train_step(opt, models, *make_optimizer(opt, models, steps_per_epoch=1000))
    batch = train_batch(dev, opt)
    for fn in COUNTERS.values():
        fn.launches = 0
    loss = float(step(batch, torch.Generator(device=dev).manual_seed(0))["loss"])
    made = counts()
    print(f"[train] --no_ssim, no augmentation: one step, loss {loss:.6f}, launches {made}",
          flush=True)
    require(np.isfinite(loss), f"non-finite --no_ssim loss {loss}")
    require(made == NO_SSIM_LAUNCHES, f"a --no_ssim step launched {made}, not {NO_SSIM_LAUNCHES}")


def compare_steps(dev, opt, batch):
    """One kernel step against one plain step on the same seeded weights
    and batch, augmented once with fixed draws, dropout and tie-break noise
    off: the loss, and each module's gradient by the relative norm of the
    difference. Once in the argfile's bf16 loss dtype, where the plain SSIM
    stack rounds its products to bf16, and once with a float32 loss, where
    both sides compute the same loss arithmetic."""
    b = opt.batch_size
    order, factors, _ = augment.jitter_params(torch.Generator(device=dev).manual_seed(1), b)
    batch = augment.apply_augmentation(batch, torch.arange(b, device=dev) % 2 == 0,
                                       torch.arange(b, device=dev) % 4 != 3, order, factors)
    for loss_dtype, loss_tol, grad_tol in (("auto", STEP_LOSS_RTOL, STEP_GRAD_RTOL),
                                           ("float32", STEP_F32_LOSS_RTOL, STEP_F32_GRAD_RTOL)):
        results = {}
        for use_kernels in (True, False):
            o = dataclasses.replace(opt, use_pallas=use_kernels, loss_dtype=loss_dtype)
            models = build_models(o, dev, train=True)
            for m in models.depth.modules():
                if isinstance(m, (torch.nn.Dropout, torch.nn.MultiheadAttention)):
                    m.eval()
            total, _ = pipeline.forward(models, batch, o)
            total.backward()
            grads = {name: torch.cat([p.grad.float().flatten() for p in mod.parameters()])
                     for name, mod in models.modules().items()}
            results[use_kernels] = (total.item(), grads)
            del models, total
        (loss_k, grads_k), (loss_p, grads_p) = results[True], results[False]
        loss_err = abs(loss_k - loss_p) / abs(loss_p)
        grad_err = {name: float((grads_k[name] - grads_p[name]).norm() / grads_p[name].norm())
                    for name in grads_p}
        print(f"[train] kernel step vs plain step, loss dtype {loss_dtype}: loss {loss_k:.6f} vs "
              f"{loss_p:.6f} (rel err {loss_err:.3e}, tol {loss_tol}); gradient rel-norm "
              f"errors { {k: float(f'{v:.3e}') for k, v in grad_err.items()} } "
              f"(tol {grad_tol})", flush=True)
        require(loss_err <= loss_tol,
                f"the kernel step's loss disagrees with the plain step's ({loss_dtype})")
        require(all(v <= grad_tol[k] for k, v in grad_err.items()),
                f"the kernel step's gradients disagree with the plain step's ({loss_dtype})")


def profile_steps(dev, step, batch, gen):
    """torch.profiler over two steps: device time by kernel and the
    device's idle share of the window; the trace into runs/."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(batch, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device time of every kernel, copy and fill (user annotations such as
    # the optimizer's span their kernels and are left out)
    spans = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    by_name = {}
    for e in spans:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    busy_us = sum(total for total, _ in by_name.values())
    print(f"[profile] 2 steps: wall {wall * 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms, "
          f"idle share {1 - busy_us / 1e6 / wall:.3f}, {len(spans) // 2} device ops a step",
          flush=True)
    for name, (total, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"[profile] {total / 2e3:9.3f} ms/step  {count // 2:4d}x  {name[:90]}", flush=True)
    ours = {name: v for name, v in by_name.items() if PORT_KERNEL.search(name)}
    print(f"[profile] the port's kernels: {sum(t for t, _ in ours.values()) / 2e3:.3f} ms/step",
          flush=True)
    for name, (total, count) in sorted(ours.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile]   {total / 2e3:9.3f} ms/step  {count // 2:4d}x  {name[:90]}", flush=True)
    out = ROOT / "runs"
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / "train_step_trace.json"))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    profile = "--profile" in sys.argv[1:]
    dev = cuda_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip())
    disable_tf32()
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; TF32 off", flush=True)

    t0 = time.perf_counter()
    _build.library()  # builds with nvcc, then loads
    print(f"[build] {time.perf_counter() - t0:.1f} s -> "
          f"{_build.LIB_PATH.relative_to(ROOT)}", flush=True)
    for line in _build.LOG_PATH.read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")

    check_kernels(dev)
    serve_launches = drive_slice(dev)
    kernels = {**check_training_kernels(dev), **check_loss_kernels(dev)}
    train_launches = drive_training(dev, profile)
    imported = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax", "sfmnext_tpu"))
    require(not imported, f"JAX or the JAX package was imported: {imported}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": train_launches[name],
         "launches_serve": serve_launches.get(name, 0), **kernels[name]}
        for name, (source, replaces) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
