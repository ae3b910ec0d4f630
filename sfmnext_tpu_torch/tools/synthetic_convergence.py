#!/usr/bin/env python
"""Learning validation on the PyTorch port: SSL training on synthetic
scenes must cut abs_rel. The port's twin of ``tools/synthetic_convergence.py``
(same configuration, scene pool, schedule and gate; it imports nothing of
JAX).

Trains the full photometric pipeline (ResNet-18 SQLdepth + PoseCNN, bf16,
the Hopper kernels live on the card) on the synthetic drive dataset for N
steps and reports GT abs_rel on a held-out batch every 200 steps and at
the last.

    python -m sfmnext_tpu_torch.tools.synthetic_convergence [steps]
        [--height H --width W] [--mode outdoor|indoor] [--seed N | --seeds 0,1,2]
        [--assert] [--no_cuda]

``--mode indoor`` drives the indoor pipeline (RectifyNet pre-warp +
occlusion-weighted min-reprojection) on the same scenes with synthetic
camera shake injected into the neighbour frames.

``--assert`` is the pinned convergence gate: the best abs_rel after warm-up
(step >= 1000) must not exceed 0.095, and must improve >= 10% over the
untrained metric; with ``--seeds 0,1,2`` the MEDIAN of the per-seed bests
is held instead (robust to the ~1-in-5 degenerate run). The threshold and
its band (seeds 0/1/2: 0.074 / 0.057 / 0.070, 3000 steps) were measured on
the JAX package on a TPU v5e (docs/convergence_band_r5.md); the port is held
to the same number. Indoor mode asserts stability only (on this rig the
indoor formulation collapses depth to near-flat; see that document). Exit
code 1 on a regression. Runs on the CUDA card, or on the CPU with
--no_cuda.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from sfmnext_tpu_torch.config import Options
from sfmnext_tpu_torch.data.synthetic import SyntheticDriveDataset
from sfmnext_tpu_torch.device import disable_tf32, opt_device
from sfmnext_tpu_torch.ops.warp import inverse_rotation_warp
from sfmnext_tpu_torch.training.builder import build_models
from sfmnext_tpu_torch.training.pipeline import train_depth_metrics
from sfmnext_tpu_torch.training.step import make_eval_step, make_optimizer, make_train_step
from sfmnext_tpu_torch.training.trainer import seed_step

# the gate of the JAX package's tool, measured there on a TPU v5e
# (docs/convergence_band_r5.md: seeds 0-4 best-after-warm-up abs_rel 0.074 /
# 0.057 / 0.070 / 0.137 / 0.091, median-of-3 0.070)
THRESHOLDS = {"outdoor": 0.095}
EVAL_EVERY = 200  # steps between evaluations of the held-out batch (and the last step)


def shake_batch(batch, rng: np.random.RandomState, max_rot: float = 0.02):
    """Rotate neighbour frames by small random (rx, ry): synthetic handheld
    shake for the rectification path (the rotation space of RectifyNet's
    zeroed third component, models/rectify.py)."""
    color = torch.from_numpy(batch["color"]).clone()
    k3 = torch.from_numpy(batch["K"][:, :3, :3]).contiguous()
    for f in range(1, color.shape[1]):
        rot = np.zeros((color.shape[0], 3), np.float32)
        rot[:, :2] = rng.uniform(-max_rot, max_rot, (color.shape[0], 2))
        color[:, f] = inverse_rotation_warp(color[:, f].contiguous(), torch.from_numpy(rot), k3,
                                            padding_mode="border")
    out = dict(batch)
    out["color"] = color.numpy()
    out["color_aug"] = np.concatenate([batch["color_aug"][:, :1], out["color"][:, 1:]], axis=1)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("steps", nargs="?", type=int, default=3000)
    # 3000, not 600: the healthy trajectory passes through a bad phase around
    # steps 400-800 before converging by ~step 1800
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--mode", choices=("outdoor", "indoor"), default="outdoor")
    p.add_argument("--assert", dest="assert_", action="store_true",
                   help="fail (exit 1) unless best-after-warmup abs_rel clears the pinned "
                        "threshold")
    p.add_argument("--threshold", type=float, default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="model-init + train rng seed (the scene pool stays fixed)")
    p.add_argument("--max_shake", type=float, default=0.02,
                   help="indoor neighbour-frame rotation shake in radians; 0 disables")
    p.add_argument("--seeds", type=str, default=None,
                   help="comma list, e.g. 0,1,2: run each seed and assert the MEDIAN of the "
                        "per-seed best abs_rel")
    p.add_argument("--no_cuda", action="store_true", help="train on the CPU")
    args = p.parse_args(argv)
    steps, h, w, bs = args.steps, args.height, args.width, 8
    dev = opt_device(args)
    disable_tf32()

    overrides = json.loads(os.environ.get("SFMNEXT_OPT_OVERRIDES", "{}"))
    if args.mode == "indoor":
        overrides.setdefault("use_rectify_net", True)
        overrides.setdefault("use_improved_mini_reproj_loss", True)
    kw = dict(
        backbone="resnet", num_layers=18, num_features=256, model_dim=32,
        patch_size=12, query_nums=128, dim_out=64, height=h, width=w,
        batch_size=bs, min_depth=0.1, max_depth=40.0, learning_rate=2e-4,
    )
    kw.update(overrides)  # SFMNEXT_OPT_OVERRIDES wins over the defaults
    opt = Options(**kw).validate()

    ds = SyntheticDriveDataset(h, w, seed=1)
    held = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch(bs).items()}
    # a pool of batches made once: rendering a scene takes far longer than a step
    shake_rng = np.random.RandomState(7)
    pool = []
    for _ in range(24):
        b = ds.batch(bs)
        b.pop("depth_gt")
        if args.mode == "indoor" and args.max_shake > 0:
            b = shake_batch(b, shake_rng, max_rot=args.max_shake)
        pool.append({k: torch.from_numpy(v).to(dev) for k, v in b.items()})

    def run_seed(seed):
        """Train from fresh weights of ``seed``; (first, best) records."""
        o = dataclasses.replace(opt, seed=seed)
        models = build_models(o, dev, train=True)
        step_fn = make_train_step(o, models, *make_optimizer(o, models, steps_per_epoch=10_000))
        eval_fn = make_eval_step(o, models)
        generator = torch.Generator(device=dev)
        history = []
        t0 = time.time()
        for step in range(steps + 1):
            if step % EVAL_EVERY == 0 or step == steps:
                m, outputs = eval_fn(held)
                dm = train_depth_metrics(outputs["depth"], held["depth_gt"])
                rec = {
                    "step": step,
                    "loss": float(m["loss"]),
                    "abs_rel": float(dm["de/abs_rel"]),
                    "rmse": float(dm["de/rms"]),
                    "a1": float(dm["da/a1"]),
                    "elapsed": round(time.time() - t0, 1),
                }
                history.append(rec)
                print(json.dumps(rec), flush=True)
            step_fn(pool[step % len(pool)], seed_step(generator, seed, step))

        first, last = history[0], history[-1]
        # SSL on these synthetic scenes oscillates hard, so the best solution
        # reached after warm-up is judged, not the endpoint sample
        settled = [r for r in history if r["step"] >= min(1000, steps // 2)]
        best = min(settled, key=lambda r: r["abs_rel"])
        print(f"\n[{args.mode} seed {seed}] abs_rel {first['abs_rel']:.3f} -> "
              f"{last['abs_rel']:.3f} (best {best['abs_rel']:.3f} @ step {best['step']}), "
              f"a1 {first['a1']:.3f} -> {last['a1']:.3f} over {steps} steps in "
              f"{time.time() - t0:.1f} s on {_device_name(dev)}", flush=True)
        return first, best

    if args.mode == "indoor":
        # indoor abs_rel is not a regression signal on this rig
        # (docs/convergence_band_r5.md): the gate is stability only
        first, best = run_seed(args.seed)
        if args.assert_:
            losses = [first["loss"], best["loss"]]
            if not all(np.isfinite(losses)):
                raise SystemExit("indoor loss went NaN")
            if not best["loss"] < 1.5 * first["loss"]:
                raise SystemExit(f"indoor training diverged: eval loss {first['loss']:.3f} -> "
                                 f"best-after-warmup {best['loss']:.3f}")
            print(f"ASSERT OK (indoor stability): loss {first['loss']:.3f} -> "
                  f"{best['loss']:.3f}, no divergence")
        return

    thresh = args.threshold or THRESHOLDS[args.mode]
    if args.seeds:
        seeds = [int(x) for x in args.seeds.split(",")]
        bests = {sd: run_seed(sd)[1]["abs_rel"] for sd in seeds}
        med = sorted(bests.values())[len(bests) // 2]
        print(f"\n[{args.mode}] per-seed best abs_rel: {bests}; median {med:.3f}", flush=True)
        if args.assert_:
            if not med <= thresh:
                raise SystemExit(f"convergence regression: median best abs_rel {med:.3f} > "
                                 f"pinned threshold {thresh} ({args.mode}, seeds {seeds})")
            print(f"ASSERT OK: median {med:.3f} <= {thresh}")
        return

    first, best = run_seed(args.seed)
    if args.assert_:
        if not best["abs_rel"] < first["abs_rel"] * 0.9:
            raise SystemExit("did not learn")
        if not best["abs_rel"] <= thresh:
            raise SystemExit(f"convergence regression: best-after-warmup abs_rel "
                             f"{best['abs_rel']:.3f} > pinned threshold {thresh} "
                             f"({args.mode}, seed {args.seed})")
        print(f"ASSERT OK: {best['abs_rel']:.3f} <= {thresh}")


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"


if __name__ == "__main__":
    main()
