#!/usr/bin/env python3
"""Drive the PyTorch port's SQLdepth inference path once on one CUDA card.

    python3 chip_smoke.py

Phases, one line or a few each; any failure raises and exits non-zero:
  1. device: the card's name and power limit (nvidia-smi); TF32 off;
  2. build: the Hopper kernels from sfmnext_tpu_torch/csrc/ with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the flagship decoder's shapes (B=4, N=160*512, Q=128, E=32, D=128)
     and at a ragged N, with the max error and median times (CUDA events);
  4. slice: SQLdepth at the flagship config (args_files/hisfog/kitti/
     resnet_320x1024.txt: ResNet-50, 320x1024, bf16, seeded random weights)
     answers 4 requests at batch 1 and 1 at batch 4; every forward must
     launch both kernels exactly once; the fused decoder is held against
     its unfused twin (return_energy=True); forward latencies;
  5. one JSON line of kernel results, then the result line.
Without a visible CUDA card it exits 1 and prints no result. It imports
nothing of JAX and nothing of the JAX package (sfmnext_tpu): it reads the
argfile itself and draws its images with numpy.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from sfmnext_tpu_torch.device import cuda_device, disable_tf32
from sfmnext_tpu_torch.ops import _build, sql_attention, sql_kernel
from sfmnext_tpu_torch.sql_depth import SQLdepth

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
KERNELS = {  # wrapper name -> the TPU kernel it replaces
    "sql_summary": "sfmnext_tpu/ops/pallas/sql_kernel.py:77",  # _fq_fwd_kernel
    "sql_depth": "sfmnext_tpu/ops/pallas/sql_kernel.py:237",   # _bins_fwd_kernel
}


def flagship_options():
    """SQLdepth's fields from the flagship argfile (``--flag value`` tokens;
    its training flags are not read), with KITTI's depth range and the
    repo's defaults: bf16 compute, seed 0, random weights."""
    tokens = ARGFILE.read_text().split()
    args = {tok[2:]: nxt for tok, nxt in zip(tokens, tokens[1:] + ["--"])
            if tok.startswith("--") and not nxt.startswith("--")}
    ints = ("num_layers", "num_features", "model_dim", "patch_size",
            "query_nums", "dim_out", "height", "width")
    return SimpleNamespace(
        backbone=args["backbone"], **{k: int(args[k]) for k in ints},
        min_depth=0.001, max_depth=80.0, compute_dtype="bfloat16", seed=0,
        load_pretrained_model=False, load_pt_folder=None,
    )


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
    opt = flagship_options()
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
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
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    kernels = check_kernels(dev)
    launches = drive_slice(dev)
    imported = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax", "sfmnext_tpu"))
    require(not imported, f"JAX or the JAX package was imported: {imported}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": "sfmnext_tpu_torch/csrc/sql_kernel.cu",
         "replaces": replaces, "launches": launches[name], **kernels[name]}
        for name, replaces in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
