#!/usr/bin/env python3
"""Drive the PyTorch port's SQLdepth inference path, its flagship
self-supervised training step, its --avg_reprojection variant and the
indoor training step on one CUDA card.

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
  5. training kernels: every kernel (the SQL forwards and backwards, the
     warp forward, coordinate and image backward in border and zeros
     padding, the SSIM forward, identity min and backward, the identity
     stack, the ColorJitter, the last also timed beside the two-pass
     kernel of tools/jitter_two_pass.cu, built alone, in turns, with its
     grid printed) against its plain version at the training
     steps' shapes (flagship B=8, 320x1024, 2 warped and 2 identity
     sources, jitter on [8,3,320,1024,3]; indoor B=8, 288x384, the SQL ops
     at N=144*192 with 64 bins, the warps on 3 and 1 channels with samples
     past the border), at the SQL ops of the resnet18_lite argfile (B=12,
     N=96*320, Q=120, E=128, D=128) and at ragged ones (an identity equal
     to a warped source there: it takes the ties), with median device
     times (the SQL kernels at the flagship, indoor and resnet18_lite
     shapes, the forwards also at the serving batch of 1; a sleep kernel
     queued ahead of the start event, so no host time counts) of
     the kernel, the plain version and, where one PyTorch call computes the
     same function, that call (library_ms, timed in turns with the kernel:
     kernel, library, library, kernel; the factor printed), and each
     kernel's bound (the larger of its bytes over 3.35 TB/s and its
     operations over the 989 TFLOP/s bf16 peak, or the 67 TFLOP/s float32
     one); the warp forward and coordinate gradient also on the smooth
     coordinates a step makes (warp_frame's geometry at 8x320x1024, the
     indoor rotation warp at 8x288x384), the image gradient on the indoor
     step's warps (warp_frame's geometry at 8x288x384, 3 and 1 channels),
     every kernel's registers and spills from the build log (phase 2), and
     the SSIM forwards' one-wave grids (blocks an SM, tiles);
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
     SSIM or jitter kernel, and two --avg_reprojection steps, whose
     identity stack goes through the SSIM forward without the min (twice
     the forward, no identity min), with their loss held against the plain
     route's. With --profile, a torch.profiler breakdown of two flagship
     steps (top kernels, device idle share; the trace into
     runs/train_step_trace.json), of the flip + ColorJitter alone by kernel,
     and of two indoor micro-steps;
  7. indoor: the indoor argfile's step (args_files/indoor/nyu_288x384.txt:
     batch 8, 288x384, ResNet-50, 64 bins, RectifyNet, occlusion-weighted
     loss, gradient accumulation over 2 micro-steps; seeded weights, a
     fixed synthetic batch, no augmentation): a warm-up cycle, then 6
     micro-steps, each launching the SQL kernels 3 times, the border warp
     and its coordinate backward 4 times, the zeros warp and its backward
     twice, the image backward 4 times and no loss or jitter kernel; the
     parameters move on every second micro-step only, the BatchNorm
     statistics on every one; one kernel micro-step held against one plain
     micro-step in bf16 and in float32; median micro-step time, images/s
     and peak memory;
  8. one JSON line of kernel results, then the result line.
Without a visible CUDA card it exits 1 and prints no result. It imports
nothing of JAX and nothing of the JAX package (sfmnext_tpu).
"""

import ctypes
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
from sfmnext_tpu_torch.ops import (_build, geometry, jitter_kernel, sql_attention, sql_kernel,
                                   ssim_kernel, warp, warp_kernel)
from sfmnext_tpu_torch.sql_depth import SQLdepth
from sfmnext_tpu_torch.training import pipeline
from sfmnext_tpu_torch.training.builder import build_models
from sfmnext_tpu_torch.training.indoor import forward_indoor
from sfmnext_tpu_torch.training.step import make_optimizer, make_train_step, select_pipeline

ROOT = Path(__file__).resolve().parent
ARGFILE = ROOT / "args_files" / "hisfog" / "kitti" / "resnet_320x1024.txt"
INDOOR_ARGFILE = ROOT / "args_files" / "indoor" / "nyu_288x384.txt"
B, Q, E, D = 4, 128, 32, 128
HW_MAIN = (160, 512)   # N = 81,920: the 1/2-resolution map of 320x1024
HW_RAGGED = (37, 53)   # N = 1,961: exercises the kernels' tail masks
# kernel vs plain: the JAX package's Pallas-vs-XLA tolerances
# (tests/test_sql_kernel.py): the two round to bf16 at different points
SUMMARY_TOL = dict(rtol=0.0, atol=2e-2)
DEPTH_TOL = dict(rtol=2e-2, atol=2e-2)
FUSED_TOL = dict(rtol=2e-2, atol=5e-2)  # fused vs unfused decoder
TIMING_RUNS = 25
SLEEP_CYCLES = 2_000_000  # about 1 ms of the card's clock: longer than a wrapper's host time
LATENCY_RUNS = 20
SQL_SOURCE = "sfmnext_tpu_torch/csrc/sql_kernel.cu"
WARP_SOURCE = "sfmnext_tpu_torch/csrc/warp_kernel.cu"
SSIM_SOURCE = "sfmnext_tpu_torch/csrc/ssim_kernel.cu"
JITTER_SOURCE = "sfmnext_tpu_torch/csrc/jitter_kernel.cu"
# the ColorJitter kernel before the one-pass design, built alone and timed beside it
TWO_PASS_JITTER = ROOT / "tools" / "jitter_two_pass.cu"
# the device functions of sfmnext_tpu_torch/csrc/*.cu, as the profiler names them
PORT_KERNEL = re.compile(r"::(sql_\w+|sum_partials|warp_\w+_kernel|ssim_\w+_kernel|"
                         r"jitter_kernel)[(<]")
KERNELS = {  # kernels-line name -> (source, the TPU kernel it replaces)
    "sql_summary": (SQL_SOURCE, "sfmnext_tpu/ops/pallas/sql_kernel.py:77"),     # _fq_fwd_kernel
    "sql_depth": (SQL_SOURCE, "sfmnext_tpu/ops/pallas/sql_kernel.py:237"),      # _bins_fwd_kernel
    "sql_summary_bwd": (SQL_SOURCE, "sfmnext_tpu/ops/pallas/sql_kernel.py:107"),  # _fq_bwd_kernel
    "sql_depth_bwd": (SQL_SOURCE, "sfmnext_tpu/ops/pallas/sql_kernel.py:245"),  # _bins_bwd_kernel
    # _fwd_kernel and _bwd_kernel, border and zeros padding (zeros=True)
    "warp_border": (WARP_SOURCE, "sfmnext_tpu/ops/pallas/warp_kernel.py:167"),
    "warp_border_bwd": (WARP_SOURCE, "sfmnext_tpu/ops/pallas/warp_kernel.py:207"),
    "warp_zeros": (WARP_SOURCE, "sfmnext_tpu/ops/pallas/warp_kernel.py:167"),
    "warp_zeros_bwd": (WARP_SOURCE, "sfmnext_tpu/ops/pallas/warp_kernel.py:207"),
    "warp_image_bwd": (WARP_SOURCE, "sfmnext_tpu/ops/pallas/warp_kernel.py:258"),  # _bwd_img_kernel
    "ssim_fwd": (SSIM_SOURCE, "sfmnext_tpu/ops/pallas/ssim_kernel.py:201"),  # _fwd_kernel
    # _ident_min_kernel
    "ssim_ident_min": (SSIM_SOURCE, "sfmnext_tpu/ops/pallas/ssim_kernel.py:441"),
    "ssim_bwd": (SSIM_SOURCE, "sfmnext_tpu/ops/pallas/ssim_kernel.py:231"),  # _bwd_kernel
    # _fwd_only_kernel: ssim_fwd without a gradient, counted by identity_losses
    "identity_losses": (SSIM_SOURCE, "sfmnext_tpu/ops/pallas/ssim_kernel.py:182"),
    "color_jitter": (JITTER_SOURCE, "sfmnext_tpu/ops/pallas/jitter_kernel.py:86"),  # _kernel
}
COUNTERS = {  # name -> (wrapper, padding mode of a per-mode count)
    "sql_summary": (sql_kernel.sql_summary, None), "sql_depth": (sql_kernel.sql_depth, None),
    "sql_summary_bwd": (sql_kernel.sql_summary_bwd, None),
    "sql_depth_bwd": (sql_kernel.sql_depth_bwd, None),
    "warp_border": (warp_kernel.warp_fwd, "border"),
    "warp_border_bwd": (warp_kernel.warp_bwd, "border"),
    "warp_zeros": (warp_kernel.warp_fwd, "zeros"),
    "warp_zeros_bwd": (warp_kernel.warp_bwd, "zeros"),
    "warp_image_bwd": (warp_kernel.warp_bwd_img, "border"),
    "warp_image_bwd_zeros": (warp_kernel.warp_bwd_img, "zeros"),
    "ssim_fwd": (ssim_kernel.ssim_fwd, None), "ssim_ident_min": (ssim_kernel.ssim_ident_min, None),
    "ssim_bwd": (ssim_kernel.ssim_bwd, None),
    "identity_losses": (ssim_kernel.identity_losses, None),
    "color_jitter": (jitter_kernel.color_jitter, None),
}


def launches(**made):
    """Every counter at 0 but those given."""
    return {name: made.get(name, 0) for name in COUNTERS}


# launches a flagship training step makes: the jitter of its batch, one
# forward and one backward of each SQL op, two warps (frames -1 and +1),
# each with its coordinate backward, and the fused loss: the SSIM maps of
# the warped frames, the identity maps folded into the min, and their
# backward
STEP_LAUNCHES = launches(sql_summary=1, sql_depth=1, sql_summary_bwd=1, sql_depth_bwd=1,
                         warp_border=2, warp_border_bwd=2, ssim_fwd=1, ssim_ident_min=1,
                         ssim_bwd=1, color_jitter=1)
# the L1-only step (--no_ssim, no augmentation) launches no loss kernel
NO_SSIM_LAUNCHES = launches(sql_summary=1, sql_depth=1, sql_summary_bwd=1, sql_depth_bwd=1,
                            warp_border=2, warp_border_bwd=2)
# --avg_reprojection (no augmentation): the SSIM forward for the warped
# maps and again, without a gradient, for the identity stack; no min kernel
AVG_LAUNCHES = {**NO_SSIM_LAUNCHES, "ssim_fwd": 2, "identity_losses": 1, "ssim_bwd": 1}
# an indoor micro-step: three depth passes (target, two references), the
# two RectifyNet warps (zeros padding, of raw frames: no image gradient),
# and the colour and depth warps of the two references (border padding,
# with the image gradient: the rectified frames and the reference depths
# carry one); the photometric loss is plain PyTorch
INDOOR_LAUNCHES = launches(sql_summary=3, sql_depth=3, sql_summary_bwd=3, sql_depth_bwd=3,
                           warp_border=4, warp_border_bwd=4, warp_zeros=2, warp_zeros_bwd=2,
                           warp_image_bwd=4)
TRAIN_ARGS = [str(ARGFILE)]  # batch 8, bf16, SSIM 0.85, automasking
TRAIN_STEPS = 5
B_TRAIN = 8
HW_TRAIN = (320, 1024)
INDOOR_MICRO_STEPS = 6  # three optimizer steps of --accumulation_steps 2
HW_INDOOR = (288, 384)
D_INDOOR = 64
# the SQL ops of args_files/hisfog/kitti/resnet18_lite_192x640.txt (batch
# 12, query_nums 120, model_dim 128, dim_out 128) at DecoderBN's half
# resolution of 192x640: (B, H x W, Q, E, D)
LITE_SQL = (12, (96, 320), 120, 128, 128)
# kernel vs plain at the training shapes. The SQL backward kernels round
# where their plain versions round but sum in another order, so a bf16
# rounding can fall the other way (bf16 is 2^-8 = 3.9e-3): each output
# within 1e-2 of its largest value. The warp kernels compute the plain
# float32 arithmetic, contracted into FMAs, and the image gradient adds with
# float32 atomics in another order on every run: 1e-5 of the largest value.
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
# an indoor kernel micro-step vs a plain one (compare_indoor_steps; its
# photometric loss is plain float32 either way). float32: only the warps
# differ; read on an H100: loss 6.1e-8, encoder 1.6e-3, depth 6.2e-6, pose
# 8.2e-5, rectify 4.2e-3, while two kernel micro-steps differ by 2.4e-6
# (atomics, cuDNN); limits about 5x the readings. bf16: loss 2.0e-5, depth
# 1.9e-3, pose 3.1e-3; the encoder (1.3e-1) and the RectifyNet (4.0e-1) are
# printed, not held (compare_indoor_steps)
INDOOR_F32_LOSS_RTOL = 1e-6
INDOOR_F32_GRAD_RTOL = {"encoder": 1e-2, "depth": 1e-4, "pose": 1e-3, "rectify": 2e-2}
INDOOR_LOSS_RTOL = 1e-3
INDOOR_GRAD_RTOL = {"depth": 1e-2, "pose": 1e-2}
# the SSIM kernels sum the 7x7 windows in another order than the plain
# average pool, with FMAs, and the variance E[p^2] - mu^2 cancels against
# the 9e-4 constant: maps and min to 1e-4, the argument where the winner
# leads by more than 2e-4; the backward divides by the squared SSIM
# denominator and rounds to bf16: 1e-2 of its largest value. The jitter
# computes the plain float32 formulas with FMAs, hue's quotients by the
# hardware's reciprocal: 1e-5.
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


def device_times(fn, runs=TIMING_RUNS, warmup=3):
    """Device times of fn() (ms, CUDA events), one a run. A sleep kernel is
    queued ahead of the start event, so that the host enqueues fn's work
    while the card sleeps and the events hold the device time alone: on an
    idle card they would also hold the host time between them (the Python
    wrapper's checks and the launch), which for a warp kernel of tens of
    microseconds was most of the reading."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def median_ms(fn, runs=TIMING_RUNS, warmup=3):
    """Median device time of fn() over ``runs`` launches (CUDA events)."""
    return statistics.median(device_times(fn, runs, warmup))


def turns_ms(kernel, library):
    """Median times of a kernel and of the library call beside it, taken in
    turns (kernel, library, library, kernel; ``TIMING_RUNS`` launches a
    turn), so that both see the same state of the card."""
    times = {kernel: [], library: []}
    for fn in (kernel, library, library, kernel):
        times[fn] += device_times(fn)
    return statistics.median(times[kernel]), statistics.median(times[library])


def start_alone_build(source, lib, defines=()):
    """nvcc for one kernel source with a plain C interface alone, into its
    own shared library ``lib``; started, not waited for: (command, process)."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-shared", "-o", str(lib), str(source)]
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_alone_build(cmd, proc, tag):
    """Wait for ``start_alone_build``'s nvcc, print its registers and
    spills, and load the library."""
    out, err = proc.communicate()
    require(proc.returncode == 0, f"nvcc failed for {cmd[-1]}:\n{err}")
    for line in (out + err).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build {tag}] {line.strip()}", flush=True)
    return ctypes.CDLL(cmd[cmd.index("-o") + 1])


def jitter_entry(lib, two_pass):
    """The ``color_jitter`` entry of a library built alone, as a function of
    the wrapper's arguments: the one-pass C interface, or the two-pass one
    with its partial sums (``two_pass``)."""
    fn = lib.color_jitter
    fn.argtypes = [ctypes.c_void_p] * (5 if two_pass else 4) + [ctypes.c_int] * (
        5 if two_pass else 4) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(color, order, factors, do_jit):
        b, f, h, w, _ = color.shape
        ops = torch.cat([order, do_jit.to(torch.int32)[:, None]], dim=1).contiguous()
        out = torch.empty_like(color)
        stream = _build.stream(color.device)
        if two_pass:
            n = b * f * -(-(h * w) // 1024)  # partial sums: one a 1024-pixel block
            partials = torch.empty(n, device=color.device, dtype=torch.float32)
            err = fn(color.data_ptr(), ops.data_ptr(), factors.data_ptr(), out.data_ptr(),
                     partials.data_ptr(), b, f, h, w, n, stream)
        else:
            err = fn(color.data_ptr(), ops.data_ptr(), factors.data_ptr(), out.data_ptr(),
                     b, f, h, w, stream)
        require(err == 0, f"color_jitter built alone failed: CUDA error {err}")
        return out

    return run


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


def warp_inputs(dev, b, h, w, c, seed):
    """A near-identity warp as the training steps make them, with samples
    past every border: image [B,H,W,C], pixel coordinates, an output
    cotangent. No coordinate lies exactly on the border, where the
    kernels' strict border mask (warp_kernel.py:246-253) and autograd's
    clamp give different gradients."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    img = torch.rand(b, h, w, c, device=dev, generator=gen)
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32), indexing="ij")
    fy = ys + 8 * (2 * torch.rand(b, h, w, device=dev, generator=gen) - 1)
    fx = xs + 40 * (2 * torch.rand(b, h, w, device=dev, generator=gen) - 1)
    fy = torch.where((fy == 0) | (fy == h - 1), fy + 0.25, fy)
    fx = torch.where((fx == 0) | (fx == w - 1), fx + 0.25, fx)
    g = torch.randn(b, h, w, c, device=dev, generator=gen)
    return img, fy, fx, g


def step_warp_inputs(dev, zeros, hw=HW_TRAIN, channels=3, seed=0):
    """Image, coordinates and cotangent of a warp as a training step makes
    it, smooth where warp_inputs jitters every pixel: in border padding,
    warp_frame's geometry (the synthetic batch's depth and intrinsics at
    ``hw``, a frame -1 with a small pose): at the flagship shape
    (8x320x1024) the flagship step's warps, at the indoor one (8x288x384)
    the indoor step's warps of the rectified frames (``channels`` 3) and of
    their depths (1), the two that take the image gradient; in zeros
    padding, the indoor RectifyNet's rotation warp (8x288x384, rotations of
    about 0.02 rad)."""
    hw = HW_INDOOR if zeros else hw
    batch = make_batch(B_TRAIN, *hw, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    small = lambda scale: scale * torch.randn(B_TRAIN, 3, device=dev, generator=gen)
    if zeros:
        grid = warp.rotation_grid(small(0.02), torch.from_numpy(batch["K3x3"]).to(dev), *hw)
    else:
        depth = torch.from_numpy(batch["depth_gt"]).to(dev)
        K, inv_K = (torch.from_numpy(batch[k]).to(dev) for k in ("K", "inv_K"))
        T = geometry.transformation_from_parameters(small(0.005), small(0.1), invert=True)
        grid = geometry.project_3d(geometry.backproject_depth(depth, inv_K), K, T, *hw)
    fx, fy = (t.contiguous() for t in warp.unnormalize(grid, *hw))
    img = torch.from_numpy(batch["color"][:, 1] if channels == 3 else batch["depth_gt"])
    img = img.to(dev).contiguous()
    g = torch.randn(img.shape, device=dev, generator=gen)
    return img, fy, fx, g


def plain_warp_grads(plain, img, fy, fx, g, which):
    """Autograd's gradients of the plain sample for the cotangent g, of
    (img, fy, fx)[i] for i in ``which``."""
    args = [t.clone().requires_grad_() for t in (img, fy, fx)]
    return torch.autograd.grad(plain(*args), [args[i] for i in which], g)


def check_training_kernels(dev):
    """Phase 5. Returns {name: {max_abs_err, ms, plain_ms, library_ms,
    bound_ms, bound_by}} at the training step's shapes."""
    h, w = HW_TRAIN
    hi, wi = HW_INDOOR
    results = {}
    every = ("sql_summary", "sql_depth", "sql_summary_bwd", "sql_depth_bwd")
    # (the kernels timed there, B, H x W, Q, E, D): the flagship step's
    # decoder (its times go into the kernels line), the indoor one, the
    # serving forward at batch 1, ragged shapes, and the resnet18_lite
    # argfile's decoder at the widest E
    cases = ((every, B_TRAIN, (h // 2, w // 2), Q, E, D),
             (every, B_TRAIN, (hi // 2, wi // 2), Q, E, D_INDOOR),
             (every[:2], 1, (h // 2, w // 2), Q, E, D),
             ((), 2, HW_RAGGED, Q, E, D), ((), 2, (30, 50), 120, 56, 100), (every, *LITE_SQL))
    for i, (timed, b, hw, q, e, d) in enumerate(cases):
        main = i == 0
        g = torch.Generator(device=dev).manual_seed(b + q + d)
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
        if timed:
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
            if name in timed:
                nbytes, flops = sql_bounds(b, hw[0] * hw[1], q, e, d)[name]
                bms, by = bound_ms(nbytes, flops)
                if name in library:
                    ms, lib_ms = turns_ms(kernel, library[name])
                else:
                    ms, lib_ms = median_ms(kernel), None
                plain_ms = median_ms(plain)
                if main:
                    results[name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                                         bound_ms=bms, bound_by=by, library_ms=lib_ms)
                line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                         f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound {bms:.4f} ms "
                         f"({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
            print(line, flush=True)

    results.update(check_warp_kernels(dev))
    return results


# (shape B, H, W, C; the kernels-line entries timed there, by padding mode)
WARP_CASES = (
    ((B_TRAIN, *HW_TRAIN, 3), {"border": ("warp_border", "warp_border_bwd", None)}),
    ((B_TRAIN, *HW_INDOOR, 3), {"border": (None, None, "warp_image_bwd"),
                                "zeros": ("warp_zeros", "warp_zeros_bwd", None)}),
    ((B_TRAIN, *HW_INDOOR, 1), {}),
    ((2, *HW_RAGGED, 3), {}),
    ((2, *HW_RAGGED, 1), {}),
)


def warp_parts(img, fy, fx, g, zeros):
    """{part: (kernel, plain)} of the three warp kernels on these inputs."""
    plain = warp.sample_zeros if zeros else warp.sample_border
    return {
        "fwd": (lambda: warp_kernel.warp_fwd(img, fy, fx, zeros), lambda: plain(img, fy, fx)),
        "bwd": (lambda: warp_kernel.warp_bwd(img, fy, fx, g, zeros),
                lambda: plain_warp_grads(plain, img, fy, fx, g, (1, 2))),
        "img": (lambda: warp_kernel.warp_bwd_img(fy, fx, g, img.shape, zeros),
                lambda: plain_warp_grads(plain, img, fy, fx, g, (0,))),
    }


def warp_err(part, mode, shape, kernel, plain_fn):
    """The kernel's largest error against autograd of the plain sample,
    held to WARP_SCALED_TOL of the plain values' largest."""
    got, want = kernel(), plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = []
    for a, x in zip(got, want):
        require(bool(torch.isfinite(a).all()), f"warp {part} {mode}: non-finite output")
        err, rel = scaled_err(a, x)
        errs.append(err)
        require(rel <= WARP_SCALED_TOL, f"warp {part} ({mode}) disagrees with its "
                                        f"plain version at {shape}: {err:.4e}")
    return max(errs)


def warp_timing(part, img, fy, fx, g, zeros, kernel):
    """Kernel and library times in turns, and the bound, of one warp part."""
    b, hh, ww, c = img.shape
    n = b * hh * ww
    work = {"fwd": (4 * n * (2 * c + 2), (10 + 10 * c) * n),
            "bwd": (4 * n * (2 * c + 4), (12 + 16 * c) * n),
            "img": (4 * n * (2 * c + 2), (10 + 8 * c) * n)}[part]
    bms, by = bound_ms(*work, F32_FLOPS)
    ms, lib_ms = turns_ms(kernel, library_warp(img, fy, fx, g, zeros, part))
    text = (f"kernel {ms:.4f} ms, library {lib_ms:.4f} ms (factor {ms / lib_ms:.2f}x), bound "
            f"{bms:.4f} ms ({by}: {work[0] / 1e6:.1f} MB)")
    return dict(ms=ms, bound_ms=bms, bound_by=by, library_ms=lib_ms), text


def check_warp_kernels(dev):
    """Phase 5, the warp kernels: forward, coordinate and image gradient in
    both paddings against autograd of the plain samples, on the flagship
    warps and the indoor ones (3 and 1 channels) and ragged shapes, samples
    past every border; the kernels-line entries timed where ``WARP_CASES``
    names them (kernel and library in turns), the image gradient at one
    channel printed beside it; then the forward and coordinate gradient on
    the smooth coordinates a step makes (step_warp_inputs), timed alike, and
    the image gradient on the indoor step's warps at 3 and 1 channels."""
    results, errs = {}, {}
    for (b, hh, ww, c), timed in WARP_CASES:
        img, fy, fx, g = warp_inputs(dev, b, hh, ww, c, seed=hh + c)
        for zeros in (False, True):
            mode = "zeros" if zeros else "border"
            fwd_name, bwd_name, img_name = timed.get(mode, (None, None, None))
            if (b, c) == (B_TRAIN, 1) and not zeros:
                img_name = "warp_image_bwd at C=1"
            names = {"fwd": fwd_name, "bwd": bwd_name, "img": img_name}
            for part, (kernel, plain_fn) in warp_parts(img, fy, fx, g, zeros).items():
                err = warp_err(part, mode, (b, hh, ww, c), kernel, plain_fn)
                key = {"fwd": "warp_zeros" if zeros else "warp_border",
                       "bwd": "warp_zeros_bwd" if zeros else "warp_border_bwd",
                       "img": "warp_image_bwd"}[part]
                errs[key] = max(errs.get(key, 0.0), err)
                line = (f"[train-kernel] warp {part} {mode} {b}x{hh}x{ww}x{c}: max_abs_err "
                        f"{err:.4e} (scaled {WARP_SCALED_TOL})")
                if names[part]:
                    entry, text = warp_timing(part, img, fy, fx, g, zeros, kernel)
                    entry["plain_ms"] = median_ms(plain_fn)
                    if names[part] in KERNELS:
                        results[names[part]] = entry
                    line += f"; {names[part]} {text}, plain {entry['plain_ms']:.4f} ms"
                print(line, flush=True)
    for zeros in (False, True):
        mode = "zeros" if zeros else "border"
        img, fy, fx, g = step_warp_inputs(dev, zeros)
        where = "rotation warp" if zeros else "warp_frame"
        for part in ("fwd", "bwd"):
            kernel, plain_fn = warp_parts(img, fy, fx, g, zeros)[part]
            err = warp_err(part, mode, tuple(img.shape), kernel, plain_fn)
            _, text = warp_timing(part, img, fy, fx, g, zeros, kernel)
            print(f"[train-kernel] warp {part} {mode} {'x'.join(map(str, img.shape))} as a step "
                  f"makes it ({where}): max_abs_err {err:.4e} (scaled {WARP_SCALED_TOL}); {text}",
                  flush=True)
    for c in (3, 1):  # the image gradient on the indoor step's warps (border)
        img, fy, fx, g = step_warp_inputs(dev, False, HW_INDOOR, c)
        kernel, plain_fn = warp_parts(img, fy, fx, g, False)["img"]
        err = warp_err("img", "border", tuple(img.shape), kernel, plain_fn)
        errs["warp_image_bwd"] = max(errs["warp_image_bwd"], err)
        _, text = warp_timing("img", img, fy, fx, g, False, kernel)
        print(f"[train-kernel] warp img border {'x'.join(map(str, img.shape))} as a step makes it "
              f"(the indoor warp of the rectified {'frames' if c == 3 else 'depths'}): max_abs_err "
              f"{err:.4e} (scaled {WARP_SCALED_TOL}); warp_image_bwd {text}", flush=True)
    for name, entry in results.items():  # the largest error over every shape and mode
        entry["max_abs_err"] = errs[name]
    return results


def library_warp(img, fy, fx, g, zeros, part):
    """The one PyTorch call that computes the same function (timed only,
    never used by the port): F.grid_sample on the NCHW image at the
    normalised grid, or its backward for the grid or the image alone."""
    _, hh, ww, _ = img.shape
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([fx / (ww - 1) * 2 - 1, fy / (hh - 1) * 2 - 1], dim=-1)
    g_nchw = g.permute(0, 3, 1, 2).contiguous()
    padding = "zeros" if zeros else "border"
    mask = {"bwd": (False, True), "img": (True, False)}
    if part == "fwd":
        return lambda: F.grid_sample(img_nchw, grid, mode="bilinear", padding_mode=padding,
                                     align_corners=True)
    return lambda: torch.ops.aten.grid_sampler_2d_backward(
        g_nchw, img_nchw, grid, 0, int(not zeros), True, mask[part])


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


def check_loss_kernels(dev, two_pass_jitter):
    """Phase 5, the loss and augmentation kernels. Returns {name:
    {max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by}} at the
    flagship step's shapes; no single PyTorch call computes any of them.
    The jitter is also timed beside ``two_pass_jitter`` (``jitter_entry``
    of the two-pass kernel), in turns."""
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
        rows, cols = ssim_kernel.FWD_TILE
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        per_sm = {name: ssim_kernel.blocks_per_sm(name, count, dev.index)
                  for name, count in (("ssim_fwd", n), ("ssim_ident_min", m))}
        print(f"[train-kernel] ssim forwards' grids: {b * -(-hh // rows) * -(-ww // cols)} tiles "
              f"of {rows}x{cols} walked by one wave of {per_sm} blocks an SM x {sms} SMs",
              flush=True)
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
        # the identity stack without the min (--avg_reprojection): the
        # forward kernel under no_grad, against the plain maps
        idents_maps = ssim_kernel.identity_losses(idents, target, weight, ldt)
        want_ident = ssim_kernel.plain_maps(idents, target, weight, ldt)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(idents_maps).all()), "identity_losses: non-finite output")
        err_ident, ok_ident = compare(idents_maps, want_ident, 0.0, SSIM_MAP_TOL)
        print(f"[train-kernel] identity_losses {shape}: max_abs_err {err_ident:.4e} "
              f"(atol {SSIM_MAP_TOL})", flush=True)
        require(ok_ident, f"identity_losses disagrees with plain_maps at {shape}")
        results["identity_losses"] = timed_result(
            "identity_losses", err_ident,
            lambda: ssim_kernel.identity_losses(idents, target, weight, ldt),
            lambda: ssim_kernel.plain_maps(idents, target, weight, ldt),
            4 * px * (3 * m + 3 + m), SSIM_FWD_OPS * px * m * 3)

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
            kernel = lambda: jitter_kernel.color_jitter(color, order, factors, do_jit)
            results["color_jitter"] = timed_result(
                "color_jitter", err, kernel,
                lambda: jitter_kernel.plain_color_jitter(color, order, factors, do_jit),
                2 * 4 * n_px * 3 + 4 * b * 9, JITTER_OPS * int(do_jit.sum()) * frames * hh * ww)
            earlier = lambda: two_pass_jitter(color, order, factors, do_jit)
            err_two, ok_two = compare(earlier(), want, 0.0, JITTER_TOL)
            require(ok_two, f"the two-pass jitter disagrees with the plain version: {err_two:.4e}")
            ms, two_ms = turns_ms(kernel, earlier)
            print(f"[train-kernel] color_jitter beside the two-pass kernel "
                  f"({TWO_PASS_JITTER.relative_to(ROOT)}, max_abs_err {err_two:.4e}), in turns: "
                  f"kernel {ms:.4f} ms, two-pass {two_ms:.4f} ms ({ms / two_ms:.3f}x), bound "
                  f"{results['color_jitter']['bound_ms']:.4f} ms", flush=True)
            clusters, kept, chunks = jitter_kernel.grid(hh, ww, dev.index)
            print(f"[train-kernel] color_jitter grid: one wave of {clusters} clusters of "
                  f"{jitter_kernel.CLUSTER} blocks over {b * frames} frames; {kept} of a block's "
                  f"{chunks} chunks of its frame's span kept in shared memory", flush=True)
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
    return {name: fn.launches if mode is None else fn.launches[mode]
            for name, (fn, mode) in COUNTERS.items()}


def zero_counts():
    for fn, mode in COUNTERS.values():
        if mode is None:
            fn.launches = 0
        else:
            fn.launches[mode] = 0


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
    zero_counts()
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
        profile_augmentation(batch, gen)
    del models, adam, scheduler, step
    compare_steps(dev, opt, batch)
    return launches


def drive_no_ssim_step(dev):
    """One step of the L1-only loss (--no_ssim, no augmentation): finite,
    with the SQL and warp kernels' launches and none of the loss kernels'."""
    opt = parse_options(TRAIN_ARGS + ["--no_ssim"])
    models = build_models(opt, dev, train=True)
    step = make_train_step(opt, models, *make_optimizer(opt, models, steps_per_epoch=1000))
    batch = train_batch(dev, opt)
    zero_counts()
    loss = float(step(batch, torch.Generator(device=dev).manual_seed(0))["loss"])
    made = counts()
    print(f"[train] --no_ssim, no augmentation: one step, loss {loss:.6f}, launches {made}",
          flush=True)
    require(np.isfinite(loss), f"non-finite --no_ssim loss {loss}")
    require(made == NO_SSIM_LAUNCHES, f"a --no_ssim step launched {made}, not {NO_SSIM_LAUNCHES}")


def one_step(dev, opt, batch, forward_fn, use_kernels):
    """One forward and backward on seeded weights, through the kernels or
    the plain ops, dropout and tie-break noise off: (loss, {module: its
    gradient as one float32 vector})."""
    o = dataclasses.replace(opt, use_pallas=use_kernels)
    models = build_models(o, dev, train=True)
    for m in models.depth.modules():
        if isinstance(m, (torch.nn.Dropout, torch.nn.MultiheadAttention)):
            m.eval()
    total, _ = forward_fn(models, batch, o)
    total.backward()
    return total.item(), {name: torch.cat([p.grad.float().flatten() for p in mod.parameters()])
                          for name, mod in models.modules().items()}


def rel_errors(a, b):
    """The loss's relative error and each module's gradient error by the
    relative norm of the difference, of step a against step b."""
    return (abs(a[0] - b[0]) / abs(b[0]),
            {name: float((a[1][name] - b[1][name]).norm() / b[1][name].norm()) for name in b[1]})


def kernel_vs_plain(dev, opt, batch, forward_fn):
    """One kernel step against one plain step on the same weights and
    batch: (kernel loss, plain loss, the loss's relative error, each
    module's gradient error)."""
    k = one_step(dev, opt, batch, forward_fn, True)
    p = one_step(dev, opt, batch, forward_fn, False)
    return (k[0], p[0], *rel_errors(k, p))


def check_step_agreement(tag, what, loss_k, loss_p, loss_err, grad_err, loss_tol, grad_tol):
    print(f"[{tag}] {what}: loss {loss_k:.6f} vs {loss_p:.6f} (rel err {loss_err:.3e}, tol "
          f"{loss_tol}); gradient rel-norm errors "
          f"{ {k: float(f'{v:.3e}') for k, v in grad_err.items()} } (tol {grad_tol})", flush=True)
    require(loss_err <= loss_tol, f"{what}: the kernel step's loss disagrees with the plain step's")
    require(all(grad_err[k] <= tol for k, tol in grad_tol.items()),
            f"{what}: the kernel step's gradients disagree with the plain step's")


def compare_steps(dev, opt, batch):
    """One kernel step against one plain step (``kernel_vs_plain``), the
    batch augmented once with fixed draws. Once in the argfile's bf16 loss
    dtype, where the plain SSIM stack rounds its products to bf16, and once
    with a float32 loss, where both sides compute the same loss
    arithmetic."""
    b = opt.batch_size
    order, factors, _ = augment.jitter_params(torch.Generator(device=dev).manual_seed(1), b)
    batch = augment.apply_augmentation(batch, torch.arange(b, device=dev) % 2 == 0,
                                       torch.arange(b, device=dev) % 4 != 3, order, factors)
    for loss_dtype, loss_tol, grad_tol in (("auto", STEP_LOSS_RTOL, STEP_GRAD_RTOL),
                                           ("float32", STEP_F32_LOSS_RTOL, STEP_F32_GRAD_RTOL)):
        o = dataclasses.replace(opt, loss_dtype=loss_dtype)
        check_step_agreement("train", f"kernel step vs plain step, loss dtype {loss_dtype}",
                             *kernel_vs_plain(dev, o, batch, pipeline.forward), loss_tol, grad_tol)


def drive_avg_step(dev):
    """Two --avg_reprojection steps (automasking on, no augmentation): the
    identity stack through the SSIM forward without the min; finite losses,
    the launches of AVG_LAUNCHES, and a kernel forward whose loss agrees with
    the plain route's (bf16 loss dtype, the flagship's limit)."""
    opt = parse_options(TRAIN_ARGS + ["--avg_reprojection"])
    batch = train_batch(dev, opt)
    loss_k, loss_p, loss_err, _ = kernel_vs_plain(dev, opt, batch, pipeline.forward)
    print(f"[avg] kernel forward vs plain route: loss {loss_k:.6f} vs {loss_p:.6f} (rel err "
          f"{loss_err:.3e}, tol {STEP_LOSS_RTOL})", flush=True)
    require(loss_err <= STEP_LOSS_RTOL, "--avg_reprojection: the kernel route's loss disagrees")
    models = build_models(opt, dev, train=True)
    step = make_train_step(opt, models, *make_optimizer(opt, models, steps_per_epoch=1000))
    gen = torch.Generator(device=dev).manual_seed(0)
    zero_counts()
    losses = []
    for _ in range(2):
        start = counts()
        losses.append(float(step(batch, gen)["loss"]))
        made = {k: v - start[k] for k, v in counts().items()}
        require(made == AVG_LAUNCHES, f"an --avg_reprojection step launched {made}, "
                                      f"not {AVG_LAUNCHES}")
        require(np.isfinite(losses[-1]), f"non-finite --avg_reprojection loss {losses[-1]}")
    launches = counts()
    print(f"[avg] --avg_reprojection, no augmentation: losses {[round(x, 6) for x in losses]}; "
          f"launches per step { {k: v for k, v in AVG_LAUNCHES.items() if v} }", flush=True)
    return launches


def drive_indoor(dev, profile=False):
    """Phase 7, the indoor argfile's step. Returns the kernels' launch
    counts over the timed micro-steps."""
    opt = parse_options([str(INDOOR_ARGFILE)])
    require((opt.batch_size, opt.height, opt.width, opt.accumulation_steps, opt.dim_out)
            == (B_TRAIN, *HW_INDOOR, 2, D_INDOOR) and opt.use_rectify_net,
            f"unexpected indoor config {opt}")
    require(select_pipeline(opt) is forward_indoor, "the indoor argfile took the outdoor pipeline")
    batch = train_batch(dev, opt)
    models = build_models(opt, dev, train=True)
    adam, scheduler = make_optimizer(opt, models, steps_per_epoch=1000)
    step = make_train_step(opt, models, adam, scheduler)
    gen = torch.Generator(device=dev).manual_seed(0)
    watched = {name: list(mod.parameters()) for name, mod in models.modules().items()}
    stats = {"encoder": models.encoder.encoder.encoder.bn1,
             "rectify": models.rectify.encoder.encoder.bn1}

    def snapshot():
        return ({k: [p.detach().clone() for p in ps] for k, ps in watched.items()},
                {k: (bn.running_mean.clone(), bn.running_var.clone()) for k, bn in stats.items()})

    for _ in range(opt.accumulation_steps):  # warm-up: one optimizer step
        step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    times, losses, first = [], [], snapshot()
    for i in range(INDOOR_MICRO_STEPS):
        params_before, stats_before = snapshot()
        start = counts()
        t0 = time.perf_counter()
        metrics = step(batch, gen)
        loss = float(metrics["loss"])  # syncs
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        made = {k: v - start[k] for k, v in counts().items()}
        require(made == INDOOR_LAUNCHES, f"an indoor micro-step launched {made}, "
                                         f"not {INDOOR_LAUNCHES}")
        require(np.isfinite(loss), f"non-finite indoor loss {loss}")
        update = (i + 1) % opt.accumulation_steps == 0
        moved = {k: any(not torch.equal(p, q) for p, q in zip(watched[k], params_before[k]))
                 for k in watched}
        require(all(m == update for m in moved.values()),
                f"micro-step {i + 1}: parameters moved {moved}, expected {update}")
        require(all(not torch.equal(bn.running_mean, stats_before[k][0])
                    and not torch.equal(bn.running_var, stats_before[k][1])
                    for k, bn in stats.items()), f"micro-step {i + 1}: BatchNorm statistics stuck")
    launches = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    moved = {k: max(float((p.detach() - q).abs().max()) for p, q in zip(watched[k], first[0][k]))
             for k in watched}
    depth = metrics["depth"]
    require(tuple(depth.shape) == (B_TRAIN, *HW_INDOOR, 1) and bool(torch.isfinite(depth).all()),
            f"indoor depth {tuple(depth.shape)} not finite or misshapen")
    med = statistics.median(times)
    print(f"[indoor] {opt.backbone}-{opt.num_layers} {opt.height}x{opt.width} batch "
          f"{opt.batch_size} {opt.compute_dtype}, {opt.dim_out} bins, RectifyNet, occlusion loss, "
          f"accumulation {opt.accumulation_steps}: losses {[round(x, 6) for x in losses]}; "
          f"launches per micro-step { {k: v for k, v in INDOOR_LAUNCHES.items() if v} }",
          flush=True)
    print(f"[indoor] parameters moved on micro-steps 2, 4, 6 only, by up to {moved}; encoder "
          f"and rectify BatchNorm statistics on every micro-step", flush=True)
    print(f"[indoor] median micro-step {med * 1e3:.2f} ms over {INDOOR_MICRO_STEPS} "
          f"({[round(t * 1e3, 2) for t in times]} ms), {B_TRAIN / med:.2f} images/s, peak memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)", flush=True)
    if profile:
        profile_steps(dev, step, batch, gen, "indoor micro-steps", "indoor_step_trace.json")
    del models, adam, scheduler, step
    compare_indoor_steps(dev, opt, batch)
    return launches


def compare_indoor_steps(dev, opt, batch):
    """One kernel micro-step against one plain micro-step, in float32 and
    in bf16. In float32 the SQL ops take their plain path on both sides,
    so only the warps differ (FMAs, the image gradient's atomics): held to
    fixed limits on every module. In bf16 the SQL kernels round where
    their plain versions do not, and the encoder's and the RectifyNet's
    gradients are differences of nearly equal terms at random weights
    (|depth(target) - depth(ref)|, |rot2| - |rot1|), which multiply any
    rounding: bf16 itself moves them from float32 by as much as they are
    (printed), so in bf16 only the loss and the depth and pose nets'
    gradients are held; the float32 comparison holds the other two."""
    steps = {}
    for dtype in ("float32", "bfloat16"):
        o = dataclasses.replace(opt, compute_dtype=dtype)
        for use_kernels in (True, False):
            steps[dtype, use_kernels] = one_step(dev, o, batch, forward_indoor, use_kernels)
    k32, p32 = steps["float32", True], steps["float32", False]
    check_step_agreement("indoor", "kernel micro-step vs plain micro-step, float32", k32[0], p32[0],
                         *rel_errors(k32, p32), INDOOR_F32_LOSS_RTOL, INDOOR_F32_GRAD_RTOL)
    k16, p16 = steps["bfloat16", True], steps["bfloat16", False]
    _, bf16_moves = rel_errors(p16, p32)
    print(f"[indoor] bf16 moves the plain micro-step's gradients from float32 by "
          f"{ {k: float(f'{v:.3e}') for k, v in bf16_moves.items()} }", flush=True)
    check_step_agreement("indoor", "kernel micro-step vs plain micro-step, bfloat16", k16[0],
                         p16[0], *rel_errors(k16, p16), INDOOR_LOSS_RTOL, INDOOR_GRAD_RTOL)


def profile_steps(dev, step, batch, gen, what="steps", trace="train_step_trace.json"):
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
    print(f"[profile] 2 {what}: wall {wall * 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms, "
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
    prof.export_chrome_trace(str(out / trace))


def profile_augmentation(batch, gen, calls=5):
    """torch.profiler over ``calls`` flips and jitters of the flagship batch
    (``augment_batch``, the step's draws): device time a call by kernel,
    the flip's ``color.flip(3)`` and ``torch.where`` beside the jitter."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            augment.augment_batch(batch, gen)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    busy = sum(total for total, _ in by_name.values())
    print(f"[profile] flip + ColorJitter of the flagship batch: {busy / calls / 1e3:.4f} ms of "
          f"device time a call ({calls} calls)", flush=True)
    for name, (total, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile]   {total / calls / 1e3:9.4f} ms/call  {count // calls:3d}x  {name[:90]}",
              flush=True)


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
    alone = start_alone_build(TWO_PASS_JITTER, _build.BUILD_DIR / "libjitter_two_pass.so")
    _build.library()  # builds with nvcc, then loads
    print(f"[build] {time.perf_counter() - t0:.1f} s -> "
          f"{_build.LIB_PATH.relative_to(ROOT)}", flush=True)
    for line in _build.LOG_PATH.read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")
    two_pass_jitter = jitter_entry(finish_alone_build(*alone, "two-pass jitter"), two_pass=True)

    check_kernels(dev)
    paths = {"serve": drive_slice(dev)}
    kernels = {**check_training_kernels(dev), **check_loss_kernels(dev, two_pass_jitter)}
    paths["train"] = drive_training(dev, profile)
    drive_no_ssim_step(dev)
    paths["avg"] = drive_avg_step(dev)
    paths["indoor"] = drive_indoor(dev, profile)
    imported = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax", "sfmnext_tpu"))
    require(not imported, f"JAX or the JAX package was imported: {imported}")

    def launched(path, name):  # the image backward counts both paddings
        made = paths[path]
        zeros = made.get("warp_image_bwd_zeros", 0) if name == "warp_image_bwd" else 0
        return made.get(name, 0) + zeros

    entries = []
    for name, (source, replaces) in KERNELS.items():
        per_path = {f"launches_{path}": launched(path, name) for path in paths}
        require(sum(per_path.values()) > 0, f"{name} was launched on no path")
        entries.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": sum(per_path.values()), **per_path, **kernels[name]})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
