#!/usr/bin/env python3
"""Drive the PyTorch port's SQLdepth inference path, its flagship
self-supervised training step, its --avg_reprojection variant, the
indoor training step, the Trainer, the evaluation, metric finetuning
with its evaluation, the ConvNeXt-L (stereo), EfficientNet-B5 and Lite
models, the pose networks and the predictive mask, and the Unet zoo's
ResNet family with --remat on one CUDA card.

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
     N=96*320, Q=120, E=128, D=128), of the ConvNeXt-L one (B=16,
     N=160*512, Q=64, E=32, D=64) and of the EfficientNet-B5 one (B=6, the
     flagship's widths), and at ragged ones (an identity equal
     to a warped source there: it takes the ties), with median device
     times (the SQL kernels at the flagship, indoor, resnet18_lite and
     ConvNeXt-L shapes, the forwards also at the serving batch of 1; a sleep kernel
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
  8. trainer: training/trainer.Trainer at the flagship argfile with
     --weights_init scratch, fed synthetic batches with ground-truth depth:
     2 epochs of 4 steps (a log and one val minibatch through the eval step
     on batches 0 and 2 of each epoch, PNG panels, a checkpoint after each
     epoch), then a second Trainer with --load_weights_folder latest and 3
     epochs, which resumes at step 8 and trains epoch 2; finite losses and
     de/abs_rel in the train and val jsonl, weights_0..2 read by
     load_reference_folder, the resumed step and Adam state, and exactly
     the launches of 12 train steps and 6 val steps; the Trainer's median
     step (beside the bare step of phase 6), val and checkpoint-write
     times, where a run's wall time went, and the parts of a val minibatch
     (upload, eval step, depth metrics, panels) timed alone;
  9. eval: the float32 evaluation (sfmnext_tpu_torch/evaluation.py) at the
     flagship argfile with --eval_mono: seed-0 weights saved as a
     reference-layout folder under runs/chip_smoke_eval/ and loaded by
     load_eval_variables; 64 synthetic 320x1024 frames in MonoDataset's
     item layout (the datasets' output after PIL decoding, which the
     card's machine lacks) through PrefetchLoader into predict_depths at
     --eval_batch_size 1 and 8, each with and without --post_process, and
     at 16 (the forward batch of 8 with --post_process): depths finite and
     inside [min_depth, max_depth], batches 8 and 16 equal to batch 1
     within 1e-5 of the largest depth, the first 2 images equal
     to the same folder's float32 forward on the CPU within 1e-4, and no
     kernel launch in the phase (the SQL decoder runs unfused in float32,
     as the JAX evaluation does); then evaluate() on the saved
     predictions against 64 synthetic 375x1242 ground-truth maps of an
     eigen split (its row equal to evaluate_predictions', all seven
     metrics finite) and the benchmark split's export (64 PNG files);
     eval images/s, the host's resize-and-metrics ms an image and the
     phase's wall time; with --profile, torch.profiler breakdowns of the
     float32 forward at batch 8 and 16;
 10. finetune: FinetuneTrainer at the flagship argfile and
     args_files/hisfog/ft/inc_kitti.txt (batch 16, 320x1024, bf16 autocast,
     AdamW lr 1e-4 wd 0.01, OneCycle, clip 0.1, max depth 80; seeded
     weights; a warm-up trainer first) on synthetic items in DepthDataset's
     layout (metric GT on 15% of the pixels, as KITTI's annotated maps; the
     card's machine has no PIL to decode files): one epoch of 6 steps and a
     batch without valid depth, which it skips, validate on 8 images at
     batch 1 (the flip-TTA in bf16), the best and latest checkpoints under
     runs/chip_smoke_finetune/, then evaluate_metric_depth.evaluate on the
     best folder over the same 8 images without a crop, its dict within
     1e-6 of validate's; a finite SILog, parameters and encoder BatchNorm
     statistics that move, the update count 6 in the schedule and in AdamW
     and the schedule's rate at 6, exactly the launches of 6 steps (each
     SQL kernel once a step) and of 8 images in validate and again in the
     CLI (the SQL forwards twice an image, no backward); one kernel step
     against one plain step (dropout off) within phase 6's limits; the
     median step, images/s, peak memory, validate images/s and the
     checkpoint writes; with --profile, a torch.profiler breakdown of two
     finetune steps;
 11. convnext: training/trainer.Trainer at args_files/hisfog/kitti/
     cvnXt_L_320x1024.txt (the ConvNeXt-L Unet, decoder channels 1024 512
     256 128, model_dim 32, patch 32, 64 queries, 64 bins, 320x1024, batch
     16, bf16, --use_stereo --diff_lr; --weights_init scratch) on a
     synthetic batch with a stereo frame and stereo_T, flip + ColorJitter
     on the card: a warm-up step and 5 more, each launching the SQL, SSIM
     and jitter kernels once and the border warp and its backward three
     times (two temporal sources and the stereo frame); finite losses,
     parameters and BatchNorm statistics that move; SQLdepth serving from
     the Trainer's epoch-0 checkpoint at batch 1 (both SQL forwards once a
     request, depth finite and in range, the fused decoder against its
     unfused twin, the latency); one kernel step held against one plain
     step as in phase 6 (in the bf16 loss the pose gradient against the
     float32-loss plain step: within 5e-2, or no farther than the bf16
     plain step); the median step, images/s and peak memory; with
     --profile, a torch.profiler breakdown of two steps;
 12. effb5: the same at args_files/hisfog/kitti/effb5_320x1024.txt
     (EfficientNet-B5 + DecoderBN, num_features 2048, batch 6, frames 0
     -1 1: a step launches as phase 6's);
 13. the ConvNeXt-L depthwise 7x7 convolutions (each stage's, bf16, batch
     16), timed in channels-last and in NCHW memory, and the whole
     encoder's forward + backward (channels-last);
 14. lite: the same as phase 11 at args_files/hisfog/kitti/
     resnet18_lite_192x640.txt (the paper's Lite model: ResNet-18 +
     DecoderBN(256), model_dim 128, patch 12, 120 queries, 128 bins, FFN
     512, 192x640, batch 12, PoseCNN pairs; a step launches as phase 6's);
 15. pose_mask: at the same argfile and batch, through make_train_step
     with augmentation, a warm-up and 3 steps of each route: the separate
     ResNet-18 pose net over pairs and over all frames, the shared
     PoseDecoder over pairs and over all frames (every temporal frame
     through the depth encoder in one batch), the PoseCNN over all frames,
     and --predictive_mask --disable_automasking; exact launches (the pose
     routes as phase 6's step; the mask route the SSIM forward and its
     backward once, no identity min or identity stack), finite losses, the
     pose net's, pose encoder's and mask's parameters moving, each route's
     median step; the mask route's kernel step held against its plain
     step as in phase 11 (the mask's gradient as the pose's); with
     --profile, a torch.profiler breakdown of two more steps of each route;
 16. zoo: (a) the backbone coverage tool over the Unet zoo's 430 names
     (162 build with the half-resolution output, 268 raise naming the
     ROADMAP item); (b) one Unet a ResNet-family option (OPTION_NAMES) with
     seeded weights, its float32 eval forward on the card within 1e-4 of
     the CPU's and a finite bf16 forward; (c) the same as phase 11 at the
     ConvNeXt-L argfile with --backbone ig_resnext101_32x8d (a step
     launches as phase 11's; in every model's phase the bf16 encoder
     gradient of the kernel step is held to 5e-2 or twice a second plain
     step's distance; with --profile also the grouped convolutions' share
     of the device time); (d) bare make_train_step steps of that config
     with and without --remat: the peak memory (lower with --remat) and
     the median step, and one --remat step against one plain step
     (networks and loss in float32, cuDNN deterministic: loss 1e-5, every
     gradient 1e-3 of its norm, the encoder's BatchNorm statistics 1e-5;
     in bf16, within twice a second plain step's distance); in float32 the
     kernel route against the plain route (1e-3 a module), and in bf16
     where the kernel step's gradients part from the plain route's
     (printed: the noise, and a step with the SQL kernels alone off);
 17. one JSON line of kernel results (launches per path, the Trainer's
     as launches_trainer, the evaluation's as launches_eval, finetuning's
     as launches_finetune, the models' as launches_convnext,
     launches_effb5, launches_lite and launches_zoo, the pose and mask
     routes' as launches_pose_mask), then the result line.
Without a visible CUDA card it exits 1 and prints no result. It imports
nothing of JAX and nothing of the JAX package (sfmnext_tpu).
"""

import argparse
import ctypes
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from sfmnext_tpu_torch import evaluate_metric_depth, evaluation, finetune_metric_depth
from sfmnext_tpu_torch.config import parse_options
from sfmnext_tpu_torch.data import augment
from sfmnext_tpu_torch.data.kitti import KITTIRAWDataset
from sfmnext_tpu_torch.data.loader import PrefetchLoader
from sfmnext_tpu_torch.data.synthetic import SyntheticDriveDataset, make_batch
from sfmnext_tpu_torch.device import cuda_device, disable_tf32
from sfmnext_tpu_torch.finetune import FinetuneTrainer
from sfmnext_tpu_torch.finetune.trainer import finetune_loss
from sfmnext_tpu_torch.models.convnext import ConvNeXt, convnext_cfg
from sfmnext_tpu_torch.ops import (_build, geometry, jitter_kernel, sql_attention, sql_kernel,
                                   ssim_kernel, warp, warp_kernel)
from sfmnext_tpu_torch.sql_depth import SQLdepth
from sfmnext_tpu_torch.training import pipeline
from sfmnext_tpu_torch.training.builder import build_models
from sfmnext_tpu_torch.training.indoor import forward_indoor
from sfmnext_tpu_torch.training.pipeline import train_depth_metrics
from sfmnext_tpu_torch.training.step import make_optimizer, make_train_step, select_pipeline
from sfmnext_tpu_torch.training.trainer import Trainer
from sfmnext_tpu_torch.utils.jax_weights import load_reference_folder

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
# a val step of the flagship eval step: the SQL forwards, the warps of the two
# sources, and the fused SSIM forward and identity min, with no backward and
# no jitter (the warps go through the kernel in eval too: the route is
# opt.use_pallas alone)
VAL_LAUNCHES = launches(sql_summary=1, sql_depth=1, warp_border=2, ssim_fwd=1, ssim_ident_min=1)
# a --use_stereo step (frames 0 -1 1 s): the stereo frame adds a third warp,
# with its coordinate backward, a third source to the SSIM stack and the
# identity min, and a fourth frame to the one jitter launch
STEREO_STEP_LAUNCHES = {**STEP_LAUNCHES, "warp_border": 3, "warp_border_bwd": 3}
# the paper's other three KITTI models, and the cvnXt argfile over a zoo
# backbone, each through the Trainer at its argfile's full width and batch
LITE_ARGFILE = ROOT / "args_files" / "hisfog" / "kitti" / "resnet18_lite_192x640.txt"
CVNXT_ARGFILE = ROOT / "args_files" / "hisfog" / "kitti" / "cvnXt_L_320x1024.txt"
ZOO_BACKBONE = "ig_resnext101_32x8d"  # ResNeXt-101 32x8d WSL, MiDaS v2's encoder
# tag -> (argfile, flags added to it, its (backbone, batch, patch, query_nums,
# dim_out, (height, width)), a step's launches)
BACKBONES = {
    "convnext": (CVNXT_ARGFILE, [], ("convnext_large", 16, 32, 64, 64, (320, 1024)),
                 STEREO_STEP_LAUNCHES),
    "effb5": (ROOT / "args_files" / "hisfog" / "kitti" / "effb5_320x1024.txt", [],
              ("eff_b5", 6, 20, 128, 128, (320, 1024)), STEP_LAUNCHES),
    # the paper's Lite model: ResNet-18 + DecoderBN(256), the 512-wide FFN
    "lite": (LITE_ARGFILE, [], ("resnet18_lite", 12, 12, 120, 128, (192, 640)), STEP_LAUNCHES),
    # the ConvNeXt-L argfile with its Unet encoder swapped for a ResNeXt
    "zoo": (CVNXT_ARGFILE, ["--backbone", ZOO_BACKBONE],
            (ZOO_BACKBONE, 16, 32, 64, 64, (320, 1024)), STEREO_STEP_LAUNCHES),
}
BACKBONE_STEPS = 5  # after one warm-up step
# the pose nets and the predictive mask at the Lite argfile, each route a
# warm-up and POSE_MASK_STEPS steps through make_train_step (augmentation on):
# route -> its flags. The pose routes launch as a flagship step; the mask
# route (--disable_automasking) takes the SSIM maps through
# ssim_kernel.reprojection_losses (#9 and its backward #10) and never the
# identity min (#11) or the identity stack (#8)
POSE_MASK_ROUTES = {
    "separate_resnet pairs": ["--pose_model_type", "separate_resnet"],
    "separate_resnet all": ["--pose_model_type", "separate_resnet", "--pose_model_input", "all"],
    "shared pairs": ["--pose_model_type", "shared"],
    "shared all": ["--pose_model_type", "shared", "--pose_model_input", "all"],
    "posecnn all": ["--pose_model_input", "all"],
    "predictive_mask": ["--predictive_mask", "--disable_automasking"],
}
POSE_MASK_STEPS = 3
MASK_STEP_LAUNCHES = {**STEP_LAUNCHES, "ssim_ident_min": 0}
LAYOUT_RUNS = 5  # the ConvNeXt encoder's forward and backward, timed
TRAIN_ARGS = [str(ARGFILE)]  # batch 8, bf16, SSIM 0.85, automasking
# the Trainer at the flagship argfile: 2 epochs of 4 steps, a log (and one val
# minibatch) on batches 0 and 2 of each epoch, then a second Trainer resumed
# from the latest checkpoint for a third epoch
TRAINER_DIR = ROOT / "runs" / "chip_smoke_trainer"
TRAINER_ARGS = TRAIN_ARGS + ["--weights_init", "scratch", "--steps_per_epoch", "4",
                             "--log_frequency", "2", "--log_dir", str(TRAINER_DIR)]
TRAINER_EPOCHS = (2, 3)  # the first run's epochs, the resumed run's
TRAINER_STEPS = 4 * TRAINER_EPOCHS[1]
TRAINER_VALS = 2 * TRAINER_EPOCHS[1]
# the evaluation at the flagship argfile: 64 frames (the Eigen split has 697),
# their ground truth at KITTI's 375x1242
EVAL_DIR = ROOT / "runs" / "chip_smoke_eval"
EVAL_ARGS = [str(ARGFILE), "--eval_mono", "--num_workers", "2",
             "--eval_out_dir", str(EVAL_DIR / "out")]
EVAL_IMAGES = 64
EVAL_GT_HW = (375, 1242)
EVAL_RUNS = ((1, False), (1, True), (8, False), (8, True), (16, False))  # batch, post_process
EVAL_BATCH_TOL = 1e-5  # batch 8 vs batch 1, of the largest depth (cuDNN may pick other kernels)
EVAL_CPU_TOL = 1e-4  # the card vs the CPU in float32, of the largest depth
# metric finetuning at the flagship argfile with the reference's KITTI finetune
# argfile (batch 16, 320x1024, lr 1e-4, wd 0.01, max depth 80): one epoch of
# 6 steps and a batch without valid depth, which the trainer skips, then
# validation, the checkpoints and the metric-eval CLI on 8 images
FT_ARGFILE = ROOT / "args_files" / "hisfog" / "ft" / "inc_kitti.txt"
FT_DIR = ROOT / "runs" / "chip_smoke_finetune"
FT_STEPS = 6
FT_VAL_IMAGES = 8
FT_VALID_SHARE = 0.15  # KITTI's annotated depth maps hold about 15% of the pixels
FT_EVAL_TOL = 1e-6  # the metric-eval CLI's dict against validate's, relative
# a finetune step: one forward and one backward of each SQL op; a validated or
# evaluated image: the forwards of the frame and of its flip
FT_STEP_LAUNCHES = launches(sql_summary=1, sql_depth=1, sql_summary_bwd=1, sql_depth_bwd=1)
FT_IMAGE_LAUNCHES = launches(sql_summary=2, sql_depth=2)
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
# the SQL ops of the ConvNeXt-L argfile (batch 16, query_nums 64, dim_out
# 64) and of the EfficientNet-B5 one (batch 6, the flagship's widths) at the
# 1/2 resolution of 320x1024
CVNXT_SQL = (16, (160, 512), 64, 32, 64)
EFFB5_SQL = (6, (160, 512), 128, 32, 128)
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
# the bf16 encoder's gradient also carries the card's noise (the Unet
# decoder's bilinear resizes add their gradients with atomics): two plain
# steps of the ResNeXt-101 Unet lie 2.8e-2 to 2.9e-2 of its norm apart on
# an H100. The kernel step's encoder gradient is held to 5e-2 or to this
# many times a second plain step's distance, whichever is larger, and the
# bf16 --remat step's worst gradient to this many times a second plain
# step's (drive_remat)
NOISE_FACTOR = 2
# the predictive mask, like the pose net, is reached by the photometric loss
# alone: in a float32 loss its gradient to the pose's 5e-3 (read 1.96e-4 on
# an H100 at the lite argfile), in the bf16 loss held as the pose's
# (compare_backbone_steps)
MASK_F32_GRAD_RTOL = 5e-3
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
    # serving forward at batch 1, ragged shapes, the resnet18_lite
    # argfile's decoder at the widest E, the ConvNeXt-L argfile's (Q and D
    # 64) in training and serving, and the EfficientNet-B5 one's batch
    cases = ((every, B_TRAIN, (h // 2, w // 2), Q, E, D),
             (every, B_TRAIN, (hi // 2, wi // 2), Q, E, D_INDOOR),
             (every[:2], 1, (h // 2, w // 2), Q, E, D),
             ((), 2, HW_RAGGED, Q, E, D), ((), 2, (30, 50), 120, 56, 100), (every, *LITE_SQL),
             (every, *CVNXT_SQL), (every[:2], 1, *CVNXT_SQL[1:]), ((), *EFFB5_SQL))
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
    return launches, med


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


def one_step(dev, opt, batch, forward_fn, use_kernels, depth_only=False):
    """One forward and backward on seeded weights, through the kernels or
    the plain ops, dropout and tie-break noise off: (loss, {module: its
    gradient as one float32 vector})."""
    o = dataclasses.replace(opt, use_pallas=use_kernels)
    models = build_models(o, dev, train=True, depth_only=depth_only)
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


def kernel_vs_plain(dev, opt, batch, forward_fn, depth_only=False):
    """One kernel step against one plain step on the same weights and
    batch: (kernel loss, plain loss, the loss's relative error, each
    module's gradient error)."""
    k = one_step(dev, opt, batch, forward_fn, True, depth_only)
    p = one_step(dev, opt, batch, forward_fn, False, depth_only)
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


def compare_backbone_steps(dev, opt, batch, tag):
    """``compare_steps`` for the models' phases: the kernel and the plain
    step, in the bf16 and the float32 loss dtype, on the batch augmented
    once with fixed draws, held to the flagship's limits (the predictive
    mask's gradient, where the bundle has one, to the pose's), but for the
    bf16 gradients of the pose net and the mask. There the plain route
    rounds the SSIM products to bf16 where the kernels keep float32
    (ROADMAP.md §3, "bf16 SSIM products"), and the nets that only the
    photometric loss reaches carry that rounding most: the kernel step's
    gradient must lie within the flagship's 5e-2 of the float32-loss plain
    step's, or no farther from it than the bf16 plain step's own. A second
    plain step in each loss dtype measures the card's noise in the
    encoder's gradient, whose limit is the larger of 5e-2 and
    NOISE_FACTOR times that noise."""
    b = opt.batch_size
    order, factors, _ = augment.jitter_params(torch.Generator(device=dev).manual_seed(1), b)
    batch = augment.apply_augmentation(batch, torch.arange(b, device=dev) % 2 == 0,
                                       torch.arange(b, device=dev) % 4 != 3, order, factors)
    steps = {}
    for loss_dtype in ("float32", "auto"):
        o = dataclasses.replace(opt, loss_dtype=loss_dtype)
        for route in ("kernel", "plain", "plain again"):
            steps[route, loss_dtype] = one_step(dev, o, batch, pipeline.forward, route == "kernel")
            torch.cuda.empty_cache()
    photometric = [k for k in ("pose", "predictive_mask") if k in steps["plain", "float32"][1]]
    f32_tol = {**STEP_F32_GRAD_RTOL, "predictive_mask": MASK_F32_GRAD_RTOL}
    for loss_dtype, loss_tol, tol in (
            ("float32", STEP_F32_LOSS_RTOL, {k: f32_tol[k] for k in ("encoder", "depth",
                                                                      *photometric)}),
            ("auto", STEP_LOSS_RTOL, {k: STEP_GRAD_RTOL[k] for k in ("encoder", "depth")})):
        noise = rel_errors(steps["plain again", loss_dtype], steps["plain", loss_dtype])[1]
        tol["encoder"] = max(tol["encoder"], NOISE_FACTOR * noise["encoder"])
        print(f"[{tag}] loss dtype {loss_dtype}: a second plain step's gradients lie "
              f"{ {k: float(f'{v:.3e}') for k, v in noise.items()} } of their norms from the "
              f"first's", flush=True)
        check_step_agreement(tag, f"kernel step vs plain step, loss dtype {loss_dtype}",
                             steps["kernel", loss_dtype][0], steps["plain", loss_dtype][0],
                             *rel_errors(steps["kernel", loss_dtype], steps["plain", loss_dtype]),
                             loss_tol, tol)
    reference = steps["plain", "float32"]
    for name in photometric:
        err_k = rel_errors(steps["kernel", "auto"], reference)[1][name]
        err_p = rel_errors(steps["plain", "auto"], reference)[1][name]
        limit = max(STEP_GRAD_RTOL["pose"], err_p)
        print(f"[{tag}] the bf16 steps' {name} gradient against the float32-loss plain "
              f"step's: kernel {err_k:.3e}, plain {err_p:.3e} (the kernel's limit {limit:.3e})",
              flush=True)
        require(err_k <= limit, f"the kernel step's bf16 {name} gradient is farther from the "
                                "float32 step's than the flagship's limit and the plain step's")


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


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def drive_trainer(dev, smi, bare_step):
    """Phase 8: the Trainer at the flagship argfile, fed synthetic batches
    (two training batches in turn, one validation batch, all with their
    ground-truth depth): 2 epochs of 4 steps with a log and a val
    minibatch on batches 0 and 2 of each epoch and a checkpoint after each
    epoch, then a second Trainer with --load_weights_folder latest and 3
    epochs, which resumes at step 8 (epoch 2) and trains one more epoch.
    Requires finite losses and depth metrics in both jsonl streams, the
    weights_0/1/2 folders readable by load_reference_folder, the resumed
    step count and Adam state, and exactly the launches of 12 train steps
    and 6 val steps. Prints the Trainer's step, val and checkpoint times.
    Returns the launch counts of the two runs."""
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    ds = SyntheticDriveDataset(*HW_TRAIN, seed=0)
    train_batches = [ds.batch(B_TRAIN) for _ in range(2)]
    loader = train_batches * 2  # an epoch's 4 batches
    val_loader = [ds.batch(B_TRAIN)]
    zero_counts()
    walls, trainers, trainer = [], [], None
    for epochs, extra in zip(TRAINER_EPOCHS, ([], ["--load_weights_folder", "latest"])):
        del trainer
        torch.cuda.empty_cache()
        opt = parse_options(TRAINER_ARGS + ["--num_epochs", str(epochs), *extra])
        trainer = Trainer(opt, loader, val_loader)
        if extra:
            require(trainer.step == 4 * TRAINER_EPOCHS[0], f"resumed at step {trainer.step}")
            adam_steps = {float(st["step"]) for st in trainer.adam.state_dict()["state"].values()}
            require(adam_steps == {4.0 * TRAINER_EPOCHS[0]},
                    f"adam.pth not restored: Adam steps {adam_steps}")
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        trainers.append((trainer.step, trainer.timings))
    made = counts()
    want = {k: TRAINER_STEPS * STEP_LAUNCHES[k] + TRAINER_VALS * VAL_LAUNCHES[k] for k in made}
    require(made == want, f"the Trainer launched {made}, not {want}")
    require(trainers[-1][0] == TRAINER_STEPS, f"the resumed Trainer ended at step {trainers[-1][0]}")

    run = TRAINER_DIR / opt.model_name
    for mode in ("train", "val"):
        recs = read_jsonl(run / mode / "metrics.jsonl")
        require(len(recs) == TRAINER_VALS, f"{mode}: {len(recs)} records, not {TRAINER_VALS}")
        require(all(np.isfinite(r["loss"]) and np.isfinite(r["de/abs_rel"]) for r in recs),
                f"{mode}: a non-finite loss or de/abs_rel in {recs}")
        print(f"[trainer] {mode} jsonl: steps {[r['step'] for r in recs]}, loss "
              f"{[round(r['loss'], 6) for r in recs]}, de/abs_rel "
              f"{[round(r['de/abs_rel'], 4) for r in recs]}", flush=True)
    serving = build_models(opt, dev)
    for epoch in range(TRAINER_EPOCHS[1]):
        load_reference_folder(str(run / "models" / f"weights_{epoch}"), serving)
    del serving
    panels = len(list((run / "val" / "images").iterdir()))

    timings = {k: [t for _, tm in trainers for t in tm[k]] for k in ("step", "val", "save")}
    step_ms, val_ms = (statistics.median(timings[k]) * 1e3 for k in ("step", "val"))
    print(f"[trainer] {opt.backbone}-{opt.num_layers} {opt.height}x{opt.width} batch "
          f"{opt.batch_size} {opt.compute_dtype}: {TRAINER_STEPS} steps and {TRAINER_VALS} val "
          f"minibatches over 2 runs (resumed at step {4 * TRAINER_EPOCHS[0]}, epoch "
          f"{TRAINER_EPOCHS[0]}); weights_0..{TRAINER_EPOCHS[1] - 1} read by "
          f"load_reference_folder; {panels} PNG panels; launches "
          f"{ {k: v for k, v in made.items() if v} }", flush=True)
    print(f"[trainer] median train step {step_ms:.2f} ms as the Trainer sees it (its "
          f"{len(timings['step'])} log steps: batch upload to the losses' host read) beside the "
          f"bare make_train_step's {bare_step * 1e3:.2f} ms ([train]); {smi}", flush=True)
    print(f"[trainer] median val {val_ms:.2f} ms (eval step, depth metrics, "
          f"{2 * 7} PNG panels; {[round(t * 1e3, 2) for t in timings['val']]}); {smi}",
          flush=True)
    print(f"[trainer] checkpoint write {statistics.median(timings['save']):.3f} s median "
          f"({[round(t, 3) for t in timings['save']]} s); {smi}", flush=True)
    print(f"[trainer] wall {[round(w, 3) for w in walls]} s a run: steps "
          f"{sum(walls) - sum(timings['val']) - sum(timings['save']):.3f} s (with the logs' "
          f"metrics), val {sum(timings['val']):.3f} s, checkpoints {sum(timings['save']):.3f} s; "
          f"{smi}", flush=True)

    # the parts of a val minibatch, each timed alone (host clock to a sync)
    batch = trainer._device_batch(val_loader[0])
    _, outputs = trainer.eval_step(batch)
    parts = {
        "upload": lambda: trainer._device_batch(val_loader[0]),
        "eval step": lambda: trainer.eval_step(batch),
        "depth metrics": lambda: train_depth_metrics(outputs["depth"], batch["depth_gt"]),
        "panels": lambda: trainer._log_images("val", batch, outputs),
    }
    print(f"[trainer] a val minibatch's parts, median of 3 ms: "
          f"{ {k: round(host_ms(fn), 2) for k, fn in parts.items()} }; {smi}", flush=True)
    return made


class FrameItems:
    """Decoded frames in MonoDataset's item layout ('color' [1,H,W,3], 'K',
    'inv_K' of the KITTI datasets): what the datasets yield after PIL's
    decode and LANCZOS resize."""

    def __init__(self, images):
        self.images = images
        self.K, self.inv_K = KITTIRAWDataset("", [], *images.shape[1:3], [0]).intrinsics()

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"color": self.images[i:i + 1], "K": self.K, "inv_K": self.inv_K}


def drive_eval(dev, smi, profile=False):
    """Phase 9: the float32 evaluation at the flagship argfile. Returns the
    kernels' launch counts over the phase (all 0)."""
    t_phase = time.perf_counter()
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    opt = parse_options(EVAL_ARGS)
    folder = EVAL_DIR / "weights"  # seed-0 weights, the reference's layout
    folder.mkdir(parents=True)
    seeded = build_models(dataclasses.replace(opt, compute_dtype="float32"), "cpu")
    for name in ("encoder", "depth"):
        torch.save(getattr(seeded, name).state_dict(), folder / f"{name}.pth")
    del seeded
    opt = dataclasses.replace(opt, load_weights_folder=str(folder))
    images = synthetic_images(EVAL_IMAGES, opt.height, opt.width, seed=5)
    zero_counts()
    models = evaluation.load_eval_variables(opt, dev)

    def predict(batch_size, post_process, n=EVAL_IMAGES):
        loader = PrefetchLoader(FrameItems(images[:n]), batch_size, shuffle=False,
                                num_workers=opt.num_workers, drop_last=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluation.predict_depths(
            dataclasses.replace(opt, eval_batch_size=batch_size), models, loader, post_process)
        return out, time.perf_counter() - t0

    preds = {}
    h2, w2 = opt.height // 2, opt.width // 2
    for batch_size, post_process in EVAL_RUNS:
        predict(batch_size, post_process, n=2 * batch_size)  # warm-up: cuDNN plans
        out, wall = predict(batch_size, post_process)
        require(out.shape == (EVAL_IMAGES, h2, w2), f"predictions {out.shape}")
        require(bool(np.isfinite(out).all()), "a non-finite depth")
        lo, hi = float(out.min()), float(out.max())
        require(opt.min_depth <= lo and hi <= opt.max_depth,
                f"depth [{lo}, {hi}] outside [{opt.min_depth}, {opt.max_depth}]")
        preds[batch_size, post_process] = out
        print(f"[eval] {opt.backbone}-{opt.num_layers} {opt.height}x{opt.width} float32, "
              f"--eval_batch_size {batch_size}{' --post_process' if post_process else ''}: "
              f"{EVAL_IMAGES / wall:.2f} images/s ({EVAL_IMAGES} images in {wall:.3f} s, "
              f"loader to host predictions), depth [{lo:.4f}, {hi:.4f}]; {smi}", flush=True)
    for (batch_size, post_process), got in preds.items():
        one = preds[1, post_process]
        if batch_size > 1:
            err, limit = float(np.abs(got - one).max()), EVAL_BATCH_TOL * float(np.abs(one).max())
            print(f"[eval] batch {batch_size} vs batch 1"
                  f"{' (--post_process)' if post_process else ''}: max_abs_err {err:.3e}, "
                  f"limit {limit:.3e} ({EVAL_BATCH_TOL} of the largest depth)", flush=True)
            require(err <= limit, f"batch {batch_size} disagrees with batch 1")

    cpu_models = evaluation.load_eval_variables(opt, "cpu")
    want = evaluation.predict_depths(opt, cpu_models, [{"color": images[:2, None]}], False)
    del cpu_models
    err, limit = float(np.abs(preds[1, False][:2] - want).max()), EVAL_CPU_TOL * float(
        np.abs(want).max())
    print(f"[eval] the card vs the CPU, float32, first 2 images: max_abs_err {err:.3e}, limit "
          f"{limit:.3e} ({EVAL_CPU_TOL} of the largest depth; TF32 off)", flush=True)
    require(err <= limit, "the card disagrees with the CPU")
    if profile:  # kernel breakdowns of the float32 forward at batch 8 and 16
        with torch.inference_mode():
            for b in (8, 16):
                x = torch.as_tensor(images[:b], device=dev).permute(0, 3, 1, 2)
                profile_steps(dev, lambda x, _: models.depth(models.encoder(x)), x, None,
                              what=f"float32 eval forwards at batch {b}",
                              trace=f"eval_b{b}_trace.json")

    # scoring: an eigen split of synthetic ground truth (velodyne-like: 5%
    # of the pixels), the predictions through evaluate(), and the benchmark
    # split's PNG export
    rng = np.random.RandomState(6)
    gts = np.empty(EVAL_IMAGES, object)
    for i in range(EVAL_IMAGES):
        gts[i] = ((rng.rand(*EVAL_GT_HW) * 70 + 2)
                  * (rng.rand(*EVAL_GT_HW) < 0.05)).astype(np.float32)
    (EVAL_DIR / "splits" / "eigen").mkdir(parents=True)
    np.savez_compressed(EVAL_DIR / "splits" / "eigen" / "gt_depths.npz", data=gts)
    ext = EVAL_DIR / "disps.npy"
    np.save(ext, preds[1, False])
    before = os.environ.get("SFMNEXT_SPLITS")
    os.environ["SFMNEXT_SPLITS"] = str(EVAL_DIR / "splits")
    try:
        row = evaluation.evaluate(dataclasses.replace(opt, ext_disp_to_eval=str(ext),
                                                      save_pred_disps=True))
        t0 = time.perf_counter()
        direct = evaluation.evaluate_predictions(opt, preds[1, False], gts, "eigen")
        metrics_ms = (time.perf_counter() - t0) * 1e3 / EVAL_IMAGES
        t0 = time.perf_counter()
        evaluation.evaluate(dataclasses.replace(opt, ext_disp_to_eval=str(ext),
                                                eval_split="benchmark"))
        export_ms = (time.perf_counter() - t0) * 1e3 / EVAL_IMAGES
    finally:
        if before is None:
            os.environ.pop("SFMNEXT_SPLITS")
        else:
            os.environ["SFMNEXT_SPLITS"] = before
    require(row == direct, f"evaluate()'s row {row} is not evaluate_predictions' {direct}")
    require(all(np.isfinite(row[k]) for k in evaluation.METRIC_KEYS), f"a non-finite metric {row}")
    saved = np.load(EVAL_DIR / "out" / "disps_eigen_split.npy")
    require(np.array_equal(saved, preds[1, False]), "--save_pred_disps saved other predictions")
    pngs = sorted((EVAL_DIR / "out" / "benchmark_predictions").glob("*.png"))
    require(len(pngs) == EVAL_IMAGES, f"{len(pngs)} benchmark PNG files, not {EVAL_IMAGES}")
    made = counts()
    require(not any(made.values()), f"the float32 evaluation launched kernels: {made}")
    print(f"[eval] evaluate() on the batch-1 predictions against {EVAL_IMAGES} synthetic "
          f"{EVAL_GT_HW[0]}x{EVAL_GT_HW[1]} maps: "
          f"{ {k: round(float(v), 4) for k, v in row.items()} }; {len(pngs)} benchmark PNGs; "
          f"launches {made}", flush=True)
    print(f"[eval] host, an image: resize to {EVAL_GT_HW[0]}x{EVAL_GT_HW[1]} and metrics "
          f"{metrics_ms:.2f} ms, benchmark export (352x1216 resize, 16-bit PNG) {export_ms:.2f} "
          f"ms; phase wall {time.perf_counter() - t_phase:.3f} s; {smi}", flush=True)
    return made


class CountedLoader:
    """The batches in order; the kernels' launches over each whole pass."""

    def __init__(self, batches):
        self.batches, self.made = batches, []

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        start = counts()
        yield from self.batches
        self.made.append({k: v - start[k] for k, v in counts().items()})


def depth_items(n, hw, seed, valid=True):
    """A batch of n items in DepthDataset's layout (its output after PIL's
    decode, which the card's machine lacks): synthetic frames and metric GT
    in [1, 79] m on FT_VALID_SHARE of the pixels; ``valid=False`` is the
    dataset's item for a record without GT (zeros, has_valid_depth False)."""
    rng = np.random.RandomState(seed)
    if not valid:
        return {"image": np.zeros((n, *hw, 3), np.float32),
                "depth": np.zeros((n, *hw, 1), np.float32),
                "focal": np.full(n, 721.5377, np.float32),
                "has_valid_depth": np.zeros(n, bool)}
    depth = (rng.rand(n, *hw, 1) * 78 + 1) * (rng.rand(n, *hw, 1) < FT_VALID_SHARE)
    return {"image": synthetic_images(n, *hw, seed=seed), "depth": depth.astype(np.float32),
            "focal": np.full(n, 721.5377, np.float32), "has_valid_depth": np.ones(n, bool)}


def ft_forward(models, batch, opt):
    """finetune_loss in the shape kernel_vs_plain takes."""
    return finetune_loss(models, batch["image"], batch["depth"], max_depth=opt.max_depth), None


def drive_finetune(dev, smi, profile=False):
    """Phase 10: metric finetuning at the flagship argfile and inc_kitti.txt
    (batch 16, 320x1024, bf16). Returns the kernels' launch counts over the
    training, the validation and the metric-eval CLI."""
    t_phase = time.perf_counter()
    shutil.rmtree(FT_DIR, ignore_errors=True)
    ft_args, rest = finetune_metric_depth.parse_ft([str(ARGFILE), str(FT_ARGFILE)])
    opt = parse_options(rest + ["--log_dir", str(FT_DIR)])
    b, hw = ft_args.ft_batch_size, (ft_args.ft_input_height, ft_args.ft_input_width)
    require((b, *hw, ft_args.ft_lr, ft_args.ft_wd, opt.max_depth) == (16, *HW_TRAIN, 1e-4, 0.01, 80),
            f"unexpected finetune config {b}x{hw}, lr {ft_args.ft_lr}, wd {ft_args.ft_wd}")
    batches = [depth_items(b, hw, seed) for seed in (11, 12)]
    loader = [batches[0], batches[1], batches[0], depth_items(b, hw, 0, valid=False),
              batches[1], batches[0], batches[1]]  # 6 steps and a skipped batch
    val_items = depth_items(FT_VAL_IMAGES, hw, 13)
    val_batches = [{k: v[i:i + 1] for k, v in val_items.items()} for i in range(FT_VAL_IMAGES)]

    def trainer(loader, val_loader=None):
        return FinetuneTrainer(opt, loader, val_loader, lr=ft_args.ft_lr,
                               weight_decay=ft_args.ft_wd, epochs=1)

    warm = trainer(loader[:1])  # warm-up: cuDNN plans, the allocator, the kernels
    warm.train(log_every=1)
    del warm
    torch.cuda.empty_cache()

    val_loader = CountedLoader(val_batches)
    tr = trainer(loader, val_loader)
    enc = tr.models.encoder.encoder.encoder
    watched = {"encoder.conv1": enc.conv1.weight, "depth.conv3x3": tr.models.depth.conv3x3.weight,
               "depth.prob": tr.models.depth.convert_to_prob[0].weight}
    before = {k: v.detach().clone() for k, v in watched.items()}
    bn_before = (enc.bn1.running_mean.clone(), enc.bn1.running_var.clone())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    val = tr.train(log_every=1)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    made = counts()
    val_made = val_loader.made[0]
    step_made = {k: made[k] - val_made[k] for k in made}
    want_steps = {k: FT_STEPS * v for k, v in FT_STEP_LAUNCHES.items()}
    want_images = {k: FT_VAL_IMAGES * v for k, v in FT_IMAGE_LAUNCHES.items()}
    require(len(val_loader.made) == 1, f"validated {len(val_loader.made)} times, not once")
    require(step_made == want_steps, f"{FT_STEPS} finetune steps launched {step_made}, "
                                     f"not {want_steps}")
    require(val_made == want_images, f"validate launched {val_made}, not {want_images}")
    require(len(tr.losses) == FT_STEPS and all(np.isfinite(tr.losses)),
            f"finetune losses {tr.losses}")
    moved = {k: float((v.detach() - before[k]).abs().max()) for k, v in watched.items()}
    require(all(m > 0 for m in moved.values()), f"parameters did not move: {moved}")
    bn_moved = (float((enc.bn1.running_mean - bn_before[0]).abs().max()),
                float((enc.bn1.running_var - bn_before[1]).abs().max()))
    require(all(m > 0 for m in bn_moved), f"BatchNorm statistics did not move: {bn_moved}")
    adam_steps = {float(st["step"]) for st in tr.optimizer.state.values()}
    lr = tr.optimizer.param_groups[0]["lr"]
    require(tr.step == tr.scheduler.last_epoch == FT_STEPS and adam_steps == {float(FT_STEPS)},
            f"update count {tr.step}, schedule {tr.scheduler.last_epoch}, AdamW {adam_steps}")
    require(lr == tr.schedule(FT_STEPS), f"lr {lr}, not the schedule's {tr.schedule(FT_STEPS)}")
    require(all(np.isfinite(v) for v in val.values()), f"a non-finite metric {val}")
    best = FT_DIR / opt.model_name / "finetune" / "weights_best"
    require(all((best.parent / f"weights_{tag}" / f"{name}.pth").exists()
                for tag in ("best", "latest") for name in ("encoder", "depth", "adam")),
            "the best and latest checkpoints are incomplete")
    step_ms = statistics.median(tr.timings["step"]) * 1e3
    val_s = tr.timings["val"][0]
    print(f"[finetune] {opt.backbone}-{opt.num_layers} {hw[0]}x{hw[1]} batch {b} "
          f"{opt.compute_dtype}, AdamW lr {ft_args.ft_lr} wd {ft_args.ft_wd}, OneCycle over "
          f"{len(loader)} batches (clamped to 10): losses {[round(x, 6) for x in tr.losses]}; "
          f"the batch without valid depth skipped; update count {tr.step}, lr {lr:.6e} = the "
          f"schedule's; launches per step { {k: v for k, v in FT_STEP_LAUNCHES.items() if v} }",
          flush=True)
    print(f"[finetune] parameters moved by up to {moved}; encoder bn1 running mean/var moved by "
          f"up to {bn_moved}", flush=True)
    print(f"[finetune] median step {step_ms:.2f} ms over {FT_STEPS} steps "
          f"({[round(x * 1e3, 2) for x in tr.timings['step']]} ms, upload to the loss's host "
          f"read), {b / step_ms * 1e3:.2f} images/s, peak memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated); {smi}", flush=True)
    print(f"[finetune] validate: {FT_VAL_IMAGES} images at batch 1 with the flip-TTA in "
          f"{opt.compute_dtype}, {val_s:.3f} s, {FT_VAL_IMAGES / val_s:.2f} images/s (upload to "
          f"the host metrics); launches { {k: v for k, v in val_made.items() if v} }; "
          f"{ {k: round(v, 4) for k, v in val.items()} }; {smi}", flush=True)
    print(f"[finetune] checkpoint writes (best, latest) "
          f"{[round(x, 3) for x in tr.timings['save']]} s; train() wall {wall:.3f} s; {smi}",
          flush=True)
    batch = {k: torch.from_numpy(batches[0][k]).to(dev) for k in ("image", "depth")}
    if profile:  # two more steps of the trained state, after every check above
        profile_steps(dev, lambda batch, _: tr.step_fn(batch), batch, None,
                      what="finetune steps", trace="finetune_step_trace.json")
    del tr, val_loader
    torch.cuda.empty_cache()

    # the metric-eval CLI's evaluate() on the saved best folder, same 8 images, no crop
    eval_args = argparse.Namespace(**{**vars(ft_args), "checkpoint_path": str(best),
                                      "garg_crop": False, "eigen_crop": False})
    start = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = evaluate_metric_depth.evaluate(opt, eval_args, val_batches)
    eval_s = time.perf_counter() - t0
    eval_made = {k: v - start[k] for k, v in counts().items()}
    require(eval_made == want_images, f"evaluate launched {eval_made}, not {want_images}")
    diff = {k: abs(got[k] - val[k]) / max(1.0, abs(val[k])) for k in val}
    print(f"[finetune] evaluate_metric_depth on weights_best: largest difference from validate "
          f"{max(diff.values()):.3e} (limit {FT_EVAL_TOL}, relative above 1); {eval_s:.3f} s with "
          f"the model's build and load; launches { {k: v for k, v in eval_made.items() if v} }",
          flush=True)
    require(sorted(got) == sorted(val) and max(diff.values()) <= FT_EVAL_TOL,
            f"evaluate's {got} is not validate's {val}")

    check_step_agreement("finetune", "kernel step vs plain step",
                         *kernel_vs_plain(dev, opt, batch, ft_forward, depth_only=True),
                         STEP_LOSS_RTOL, {k: STEP_GRAD_RTOL[k] for k in ("encoder", "depth")})
    print(f"[finetune] phase wall {time.perf_counter() - t_phase:.3f} s; {smi}", flush=True)
    return {k: made[k] + eval_made[k] for k in made}


def backbone_batch(opt):
    """A synthetic batch at the argfile's size, its ground-truth depth
    kept (the Trainer's log steps score it); with --use_stereo the stereo
    frame is a render two steps along x, and stereo_T carries the 0.1
    baseline of the KITTI datasets."""
    ids = tuple(2 if f == "s" else f for f in opt.all_frame_ids)
    batch = SyntheticDriveDataset(opt.height, opt.width, ids, seed=0).batch(opt.batch_size)
    if opt.use_stereo:
        stereo_T = np.broadcast_to(np.eye(4, dtype=np.float32), (opt.batch_size, 4, 4)).copy()
        stereo_T[:, 0, 3] = 0.1
        batch["stereo_T"] = stereo_T
    return batch


def drive_backbone(dev, smi, tag, profile=False):
    """Phases 11, 12, 14 and 16(c): the ConvNeXt-L Unet (stereo), the
    EfficientNet-B5 model, the Lite model or the cvnXt argfile over
    ZOO_BACKBONE at its argfile's full width and batch (--weights_init
    scratch), through training/trainer.Trainer on a synthetic batch, augmentation on:
    a warm-up step and BACKBONE_STEPS more, each with its losses read; the
    loss finite, parameters and BatchNorm statistics moved, exactly the
    launches of a step each; then SQLdepth serving from the Trainer's
    epoch-0 checkpoint at batch 1 (both SQL forwards once a request, depth
    finite and in range, the fused decoder against its unfused twin,
    latency), and the kernel step against the plain step
    (``compare_backbone_steps``). Returns the launch counts of the
    Trainer's steps and the serving forwards. ``profile``: a
    torch.profiler breakdown of two more steps after the counted ones."""
    argfile, flags, (backbone, b, patch, q, d, hw), step_launches = BACKBONES[tag]
    run_dir = ROOT / "runs" / f"chip_smoke_{tag}"
    shutil.rmtree(run_dir, ignore_errors=True)
    opt = parse_options([str(argfile), *flags, "--weights_init", "scratch", "--log_dir", str(run_dir),
                         "--num_epochs", "1", "--steps_per_epoch", str(1 + BACKBONE_STEPS),
                         "--log_frequency", "1", "--save_frequency", "1000"])
    got = (opt.backbone, opt.batch_size, opt.patch_size, opt.query_nums, opt.dim_out,
           opt.height, opt.width)
    require(got == (backbone, b, patch, q, d, *hw), f"unexpected {tag} config {got}")
    batch = backbone_batch(opt)
    torch.cuda.empty_cache()
    trainer = Trainer(opt, [batch] * (1 + BACKBONE_STEPS), None)
    models = trainer.models
    n_params = sum(p.numel() for m in models.modules().values() for p in m.parameters())
    watched = {f"{name}.{pname}": p for name, m in models.modules().items()
               for pname, p in (list(m.named_parameters())[0], list(m.named_parameters())[-1])}
    bn = next(m for m in models.encoder.modules() if isinstance(m, torch.nn.BatchNorm2d))
    before = {k: v.detach().clone() for k, v in watched.items()}
    bn_before = (bn.running_mean.clone(), bn.running_var.clone())
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    made = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    want = {k: (1 + BACKBONE_STEPS) * v for k, v in step_launches.items()}
    require(made == want, f"[{tag}] the Trainer launched {made}, not {want}")
    recs = read_jsonl(run_dir / opt.model_name / "train" / "metrics.jsonl")
    losses = [r["loss"] for r in recs]
    require(len(losses) == 1 + BACKBONE_STEPS and all(np.isfinite(losses)),
            f"[{tag}] losses {losses}")
    moved = {k: float((v.detach() - before[k]).abs().max()) for k, v in watched.items()}
    require(all(m > 0 for m in moved.values()), f"[{tag}] parameters did not move: {moved}")
    bn_moved = (float((bn.running_mean - bn_before[0]).abs().max()),
                float((bn.running_var - bn_before[1]).abs().max()))
    require(all(m > 0 for m in bn_moved), f"[{tag}] BatchNorm statistics did not move")
    steps = trainer.timings["step"][1:]
    med = statistics.median(steps)
    print(f"[{tag}] {backbone} {opt.height}x{opt.width} batch {b} {opt.compute_dtype}, patch "
          f"{patch}, Q {q}, D {d}, {n_params:,} parameters, frames {opt.all_frame_ids}"
          f"{', --diff_lr' if opt.diff_lr else ''}: the Trainer's {1 + BACKBONE_STEPS} steps "
          f"(the first a warm-up), losses {[round(x, 6) for x in losses]}; launches per step "
          f"{ {k: v for k, v in step_launches.items() if v} }", flush=True)
    print(f"[{tag}] parameters moved by up to {moved}; a BatchNorm's running mean/var by up "
          f"to {bn_moved}", flush=True)
    print(f"[{tag}] median step {med * 1e3:.2f} ms over {BACKBONE_STEPS} steps "
          f"({[round(t * 1e3, 2) for t in steps]} ms; batch upload to the losses' read), "
          f"{b / med:.2f} images/s, peak memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated), the Trainer's wall {wall:.2f} s; {smi}",
          flush=True)
    if profile:
        profile_steps(dev, trainer.train_step, trainer._device_batch(batch), trainer.generator,
                      f"{tag} steps", f"{tag}_step_trace.json", grouped=tag == "zoo")
    del trainer, models, watched, before
    torch.cuda.empty_cache()

    # serving from the epoch-0 checkpoint, in the argfile's bf16
    folder = run_dir / opt.model_name / "models" / "weights_0"
    model = SQLdepth(dataclasses.replace(opt, load_pretrained_model=True,
                                         load_pt_folder=str(folder)), dev)
    image = synthetic_images(1, opt.height, opt.width, seed=1)
    model(image)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    times = []
    for _ in range(LATENCY_RUNS):
        t0 = time.perf_counter()
        depth = model(image)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    served = counts()
    require(served == launches(sql_summary=LATENCY_RUNS, sql_depth=LATENCY_RUNS),
            f"[{tag}] {LATENCY_RUNS} requests launched {served}")
    lo, hi = float(depth.min()), float(depth.max())
    require(tuple(depth.shape) == (1, opt.height, opt.width, 1)
            and bool(torch.isfinite(depth).all()) and opt.min_depth <= lo
            and hi <= opt.max_depth, f"[{tag}] depth {tuple(depth.shape)} in [{lo}, {hi}]")
    with torch.inference_mode():
        x = torch.as_tensor(image, device=dev).permute(0, 3, 1, 2)
        feats = model.models.encoder(x)
        fused = model.models.depth(feats)["disp0"]
        unfused = model.models.depth(feats, return_energy=True)["disp0"]
    err, ok = compare(fused, unfused, **FUSED_TOL)
    med_serve = statistics.median(times)
    print(f"[{tag}] serving from {folder.relative_to(ROOT)} (load_reference_folder): depth in "
          f"[{lo:.4f}, {hi:.4f}]; fused vs unfused disp0 max_abs_err {err:.4e} ({FUSED_TOL}); "
          f"batch-1 latency median {med_serve * 1e3:.3f} ms over {LATENCY_RUNS} requests "
          f"({1 / med_serve:.2f} images/s); {smi}", flush=True)
    require(ok, f"[{tag}] the fused decoder disagrees with its unfused twin")
    del model
    shutil.rmtree(run_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    dev_batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items() if k != "depth_gt"}
    compare_backbone_steps(dev, opt, dev_batch, tag)
    return {k: made[k] + served[k] for k in made}


def drive_pose_mask(dev, smi, profile=False):
    """Phase 15: every route of POSE_MASK_ROUTES at the Lite argfile's full
    width and batch (seeded weights, the synthetic batch, flip + ColorJitter
    on the card): a warm-up step and POSE_MASK_STEPS more through
    make_train_step, each with exactly its launches; finite losses; the
    pose net's, the pose encoder's and the mask's first and last
    parameters moved, where the bundle has them; the median step. Then the
    mask route's kernel step against its plain step
    (``compare_backbone_steps``). Returns the launch counts of the steps.
    ``profile``: a torch.profiler breakdown of two more steps of each route
    after its counted ones."""
    made = launches()
    batch = None
    for route, flags in POSE_MASK_ROUTES.items():
        opt = parse_options([str(LITE_ARGFILE), "--weights_init", "scratch", *flags])
        if batch is None:
            batch = {k: torch.from_numpy(v).to(dev) for k, v in backbone_batch(opt).items()
                     if k != "depth_gt"}
        models = build_models(opt, dev, train=True)
        step = make_train_step(opt, models, *make_optimizer(opt, models, steps_per_epoch=1000),
                               augment=True)
        watched = {f"{name}.{pname}": p for name in ("pose_encoder", "pose", "predictive_mask")
                   if name in models.modules()
                   for pname, p in (list(models.modules()[name].named_parameters())[0],
                                    list(models.modules()[name].named_parameters())[-1])}
        before = {k: v.detach().clone() for k, v in watched.items()}
        gen = torch.Generator(device=dev).manual_seed(0)
        step(batch, gen)  # warm-up
        torch.cuda.synchronize()
        want = MASK_STEP_LAUNCHES if opt.predictive_mask else STEP_LAUNCHES
        times, losses = [], []
        for _ in range(POSE_MASK_STEPS):
            zero_counts()
            t0 = time.perf_counter()
            losses.append(float(step(batch, gen)["loss"]))  # syncs
            times.append(time.perf_counter() - t0)
            got = counts()
            require(got == want, f"[pose_mask] a {route} step launched {got}, not {want}")
            made = {k: made[k] + got[k] for k in made}
        require(all(np.isfinite(losses)), f"[pose_mask] {route}: losses {losses}")
        moved = {k: float((v.detach() - before[k]).abs().max()) for k, v in watched.items()}
        require(all(m > 0 for m in moved.values()),
                f"[pose_mask] {route}: parameters did not move: {moved}")
        med = statistics.median(times)
        print(f"[pose_mask] {route} ({' '.join(flags)}; modules {list(models.modules())}): "
              f"losses {[round(x, 6) for x in losses]}, median step {med * 1e3:.2f} ms over "
              f"{POSE_MASK_STEPS} steps ({[round(t * 1e3, 2) for t in times]} ms), "
              f"{opt.batch_size / med:.2f} images/s; launches per step "
              f"{ {k: v for k, v in want.items() if v} }; moved by up to {moved}; {smi}",
              flush=True)
        if profile:
            profile_steps(dev, step, batch, gen, f"{route} steps",
                          f"pose_mask_{route.replace(' ', '_')}_trace.json")
        del models, step, watched, before
        torch.cuda.empty_cache()
        if opt.predictive_mask:
            compare_backbone_steps(dev, opt, batch, "pose_mask")
    return made


ZOO_DEC = (64, 48, 32, 16)
ZOO_INPUT = (2, 3, 64, 96)
ZOO_CPU_TOL = 1e-4  # the card's float32 forward against the CPU's, of the largest value
ZOO_COVERAGE = (162, 268)  # names that build, names that raise
REMAT_STEPS = 3  # after a warm-up
REMAT_LOSS_RTOL = 1e-5
REMAT_GRAD_RTOL = 1e-3  # of each gradient's norm
REMAT_STATS_TOL = 1e-5  # of each BatchNorm statistic's largest value
# float32 networks and loss, cuDNN deterministic: the kernel route against
# the plain route, each module's gradient over its norm
ROUTE_F32_GRAD_RTOL = 1e-3


def zoo_coverage():
    """Phase 16(a): the backbone coverage tool over the zoo's 430 names."""
    from sfmnext_tpu_torch.tools import backbone_coverage

    t0 = time.perf_counter()
    result = backbone_coverage.coverage()
    built = sum(v == "builds" for v in result.values())
    raised = sum(v == "raises" for v in result.values())
    wrong = {k: v for k, v in result.items() if v not in ("builds", "raises")}
    print(f"[zoo] coverage of {len(result)} names: {built} build with the half-resolution "
          f"output, {raised} raise naming {backbone_coverage.ITEM} "
          f"({time.perf_counter() - t0:.1f} s, meta device)", flush=True)
    require(not wrong and (built, raised) == ZOO_COVERAGE, f"[zoo] coverage {wrong or (built, raised)}")


def zoo_forwards(dev, smi):
    """Phase 16(b): one name per option of the ResNet family (the coverage
    tool's OPTION_NAMES) as a Unet with seeded weights, an
    eval-mode float32 forward on the card within ZOO_CPU_TOL of the CPU's,
    and a finite bf16 forward."""
    from sfmnext_tpu_torch.models.unet import Unet
    from sfmnext_tpu_torch.tools.backbone_coverage import OPTION_NAMES

    x = torch.from_numpy(synthetic_images(ZOO_INPUT[0], *ZOO_INPUT[2:], seed=3)).permute(0, 3, 1, 2)
    for name in OPTION_NAMES:
        with torch.device("meta"):
            model = Unet(name, ZOO_DEC[-1], ZOO_DEC)
            half = Unet(name, ZOO_DEC[-1], ZOO_DEC, dtype=torch.bfloat16)
        model.to_empty(device="cpu").init_weights(torch.Generator().manual_seed(0))
        model.eval()
        with torch.inference_mode():
            want = model(x)
        model.to(dev)
        with torch.inference_mode():
            got = model(x.to(dev)).cpu()
        _, err = scaled_err(got, want)
        half.to_empty(device=dev).load_state_dict(model.state_dict())
        with torch.inference_mode():
            y16 = half.eval()(x.to(dev))
        n = sum(p.numel() for p in model.parameters())
        print(f"[zoo] {name}: {n:,} parameters, float32 forward {tuple(got.shape)} on the card "
              f"vs the CPU: scaled err {err:.3e} (tol {ZOO_CPU_TOL}); bf16 forward finite "
              f"{bool(torch.isfinite(y16).all())}", flush=True)
        require(tuple(got.shape) == (ZOO_INPUT[0], ZOO_DEC[-1], ZOO_INPUT[2] // 2,
                                     ZOO_INPUT[3] // 2), f"[zoo] {name}: shape {got.shape}")
        require(err <= ZOO_CPU_TOL, f"[zoo] {name}: the card's forward disagrees with the CPU's")
        require(bool(torch.isfinite(y16).all()), f"[zoo] {name}: non-finite bf16 forward")
        del model, half
    torch.cuda.empty_cache()


def _remat_step(dev, opt, batch, sql_kernels=True):
    """One forward and backward on seeded weights, dropout and tie-break
    noise off: (loss, {parameter: gradient}, {encoder buffer: value}).
    ``sql_kernels`` off: the SQL decoder unfused while the warps and the
    SSIM run as ``opt.use_pallas`` says."""
    models = build_models(opt, dev, train=True)
    models.depth.use_kernels = models.depth.use_kernels and sql_kernels
    for m in models.depth.modules():
        if isinstance(m, (torch.nn.Dropout, torch.nn.MultiheadAttention)):
            m.eval()
    total, _ = pipeline.forward(models, batch, opt)
    total.backward()
    grads = {f"{name}.{k}": p.grad.float() for name, m in models.modules().items()
             for k, p in m.named_parameters()}
    return total.item(), grads, {k: b.float().clone() for k, b in models.encoder.named_buffers()}


def module_gaps(a, b):
    """Each module's gradient distance of ``_remat_step`` a from b, over
    the norm of b's."""
    out = {}
    for mod in sorted({k.split(".")[0] for k in b[1]}):
        keys = [k for k in b[1] if k.split(".")[0] == mod]
        diff = sum(float((a[1][k] - b[1][k]).square().sum()) for k in keys)
        out[mod] = float(f"{(diff / sum(float(b[1][k].square().sum()) for k in keys)) ** 0.5:.3e}")
    return out


def route_gaps(dev, o16, batch, kernel, again):
    """Where the bf16 kernel step's gradients part from the plain route's,
    cuDNN deterministic and the loss in float32 (``kernel`` and ``again``:
    two kernel steps of ``o16``), printed: the card's noise (kernel against
    again), the kernel route against the plain route, and a step with the
    SQL kernels alone off (the warps and the SSIM kernels on) against
    each."""
    plain = _remat_step(dev, dataclasses.replace(o16, use_pallas=False), batch)
    no_sql = _remat_step(dev, o16, batch, sql_kernels=False)
    print(f"[zoo] bf16 networks, float32 loss, gradients over their norms: two kernel steps "
          f"{module_gaps(again, kernel)}; kernel vs plain route {module_gaps(kernel, plain)}; "
          f"SQL kernels off vs plain route {module_gaps(no_sql, plain)}; kernel vs SQL "
          f"kernels off {module_gaps(kernel, no_sql)}", flush=True)


def drive_remat(dev, smi):
    """Phase 16(d): --remat at the zoo's argfile. Bare make_train_step
    steps with and without it (augmentation on): the peak memory of the
    steps after a warm-up (reset_peak_memory_stats) and the median step,
    the peak required lower with --remat; then, cuDNN deterministic and the
    loss in float32, one --remat step against one plain step on the same
    weights and batch with the networks in float32: the loss, every
    gradient and the encoder's BatchNorm statistics and counts, and the
    kernel route against the plain route (ROUTE_F32_GRAD_RTOL; the SQL
    decoder runs unfused in float32, so the warps and the SSIM kernels
    differ). In the argfile's bf16 two plain steps differ already: there
    the --remat step's worst gradient is held to NOISE_FACTOR times
    a second plain step's, and ``route_gaps`` is printed."""
    argfile, flags, _, _ = BACKBONES["zoo"]
    opt = parse_options([str(argfile), *flags, "--weights_init", "scratch"])
    batch = {k: torch.from_numpy(v).to(dev) for k, v in backbone_batch(opt).items()
             if k != "depth_gt"}
    result = {}
    for remat in (False, True):
        o = dataclasses.replace(opt, remat=remat)
        models = build_models(o, dev, train=True)
        step = make_train_step(o, models, *make_optimizer(o, models, steps_per_epoch=1000),
                               augment=True)
        gen = torch.Generator(device=dev).manual_seed(0)
        step(batch, gen)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            loss = float(step(batch, gen)["loss"])  # syncs
            times.append(time.perf_counter() - t0)
        require(np.isfinite(loss), f"[zoo] --remat {remat}: loss {loss}")
        result[remat] = (torch.cuda.max_memory_allocated(dev) / 2**30, statistics.median(times))
        print(f"[zoo] bare make_train_step{' --remat' if remat else ''}: median step "
              f"{result[remat][1] * 1e3:.2f} ms over {REMAT_STEPS} "
              f"({[round(t * 1e3, 2) for t in times]} ms), {opt.batch_size / result[remat][1]:.2f} "
              f"images/s, peak memory {result[remat][0]:.2f} GiB; {smi}", flush=True)
        del models, step
        torch.cuda.empty_cache()
    saved = result[False][0] - result[True][0]
    print(f"[zoo] --remat saves {saved:.2f} GiB of peak memory ({saved / result[False][0]:.3f}) "
          f"for {result[True][1] / result[False][1]:.3f}x the step time", flush=True)
    require(result[True][0] < result[False][0], "[zoo] --remat did not lower the peak memory")

    def worst(a, b):  # (parameter, its gradient's distance of a from b over its norm)
        errs = {k: float((a[1][k] - g).norm() / g.norm()) for k, g in b[1].items() if g.norm() > 0}
        k = max(errs, key=errs.get)
        return k, errs[k]

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # in the argfile's bf16 two plain steps already differ: the Unet
        # decoder's bilinear resizes add their gradients with atomics
        o16 = dataclasses.replace(opt, loss_dtype="float32")
        plain = _remat_step(dev, o16, batch)
        again = _remat_step(dev, o16, batch)
        remat = _remat_step(dev, dataclasses.replace(o16, remat=True), batch)
        noise, gap = worst(again, plain), worst(remat, plain)
        print(f"[zoo] bf16 networks, float32 loss: the worst gradient of a second plain step "
              f"{noise}, of a --remat step {gap} (tol {NOISE_FACTOR}x the first); "
              f"losses {plain[0]:.6f} / {again[0]:.6f} / {remat[0]:.6f}", flush=True)
        require(gap[1] <= NOISE_FACTOR * noise[1],
                "[zoo] the bf16 --remat step's gradients lie farther from the plain step's "
                "than the card's noise allows")
        del remat
        torch.cuda.empty_cache()
        route_gaps(dev, o16, batch, plain, again)
        del plain, again
        torch.cuda.empty_cache()
        o32 = dataclasses.replace(opt, compute_dtype="float32", loss_dtype="float32")
        plain = _remat_step(dev, o32, batch)
        remat = _remat_step(dev, dataclasses.replace(o32, remat=True), batch)
        route = _remat_step(dev, dataclasses.replace(o32, use_pallas=False), batch)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    gaps = module_gaps(plain, route)
    loss_err = abs(plain[0] - route[0]) / abs(route[0])
    print(f"[zoo] float32 networks and loss: kernel vs plain route, loss {plain[0]:.6f} vs "
          f"{route[0]:.6f} (rel err {loss_err:.3e}, tol {REMAT_LOSS_RTOL}), gradients over "
          f"their norms {gaps} (tol {ROUTE_F32_GRAD_RTOL})", flush=True)
    require(loss_err <= REMAT_LOSS_RTOL and max(gaps.values()) <= ROUTE_F32_GRAD_RTOL,
            "[zoo] in float32 the kernel route's step disagrees with the plain route's")
    del route
    loss_err = abs(remat[0] - plain[0]) / abs(plain[0])
    grad_at, grad_err = worst(remat, plain)
    stats_err = {k: float((remat[2][k] - b).abs().max() / b.abs().max().clamp_min(1e-12))
                 for k, b in plain[2].items()}
    stats_at = max(stats_err, key=stats_err.get)
    print(f"[zoo] --remat step vs plain step, float32 networks and loss: loss {remat[0]:.6f} vs "
          f"{plain[0]:.6f} (rel err {loss_err:.3e}, tol {REMAT_LOSS_RTOL}); worst gradient "
          f"{grad_at} {grad_err:.3e} of its norm (tol {REMAT_GRAD_RTOL}); worst BatchNorm "
          f"statistic {stats_at} {stats_err[stats_at]:.3e} (tol {REMAT_STATS_TOL})", flush=True)
    require(loss_err <= REMAT_LOSS_RTOL, "[zoo] the --remat step's loss disagrees")
    require(grad_err <= REMAT_GRAD_RTOL, "[zoo] the --remat step's gradients disagree")
    require(stats_err[stats_at] <= REMAT_STATS_TOL,
            "[zoo] the --remat step's BatchNorm statistics disagree")


def convnext_layouts(dev, smi):
    """ConvNeXt-L's depthwise 7x7 convolutions (bf16, batch 16 at 320x1024:
    each stage's first block) in channels-last and in NCHW memory, and the
    whole encoder's forward and backward under bf16 autocast (it runs
    channels-last); device times. Weights random, not initialised as the
    model's: only the times count."""
    opt = parse_options([str(BACKBONES["convnext"][0])])
    b, (h, w) = opt.batch_size, HW_TRAIN
    with torch.device("meta"):
        enc = ConvNeXt(*convnext_cfg(opt.backbone))
    enc = enc.to_empty(device=dev)
    with torch.no_grad():
        for p in enc.parameters():
            p.normal_(0.0, 0.02)
    layouts = {"channels_last": torch.channels_last, "NCHW": torch.contiguous_format}
    for si, stage in enumerate(enc.stages):
        conv = stage.blocks[0].dwconv
        x = torch.randn(b, conv.in_channels, h // 2 ** (si + 2), w // 2 ** (si + 2), device=dev)
        line = []
        for name, fmt in layouts.items():
            xi = x.to(torch.bfloat16).contiguous(memory_format=fmt).requires_grad_()
            g = torch.randn_like(xi)

            def fwd():
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    return conv(xi)

            fb = lambda: torch.autograd.grad(fwd(), (xi, conv.weight), g)  # noqa: E731
            line.append(f"{name} forward {median_ms(fwd):.4f} ms, forward+backward "
                        f"{median_ms(fb):.4f} ms")
        print(f"[convnext] depthwise 7x7 of stage {si} ({tuple(x.shape)}, bf16): "
              f"{'; '.join(line)}; {smi}", flush=True)
    x = torch.rand(b, 3, h, w, device=dev)

    def fb():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            feats = enc(x)
        sum(f.float().mean() for f in feats).backward()

    print(f"[convnext] the encoder's forward + backward, batch {b} {h}x{w} bf16 autocast, "
          f"channels-last: {median_ms(fb, runs=LAYOUT_RUNS, warmup=1):.2f} ms; {smi}",
          flush=True)
    del enc
    torch.cuda.empty_cache()


def host_ms(fn, runs=3):
    """Median host time of fn() to a synchronize, ms."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def profile_steps(dev, step, batch, gen, what="steps", trace="train_step_trace.json",
                  grouped=False):
    """torch.profiler over two steps: device time by kernel and the
    device's idle share of the window; the trace into runs/. ``grouped``:
    also the share of the grouped convolutions (forward and backward, by
    the ops' input shapes) in the device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=grouped) as prof:
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
    if grouped:
        conv_us = grouped_us = 0.0
        for e in prof.key_averages(group_by_input_shape=True):
            # input, weight (cudnn forward); grad_output, input, weight (backward)
            at = {"aten::cudnn_convolution": 0, "aten::convolution_backward": 1}.get(e.key)
            shapes = e.input_shapes
            if at is None or len(shapes) < at + 2 or len(shapes[at + 1]) != 4:
                continue
            us = getattr(e, "device_time_total", None) or e.cuda_time_total
            conv_us += us
            if shapes[at][1] != shapes[at + 1][1]:  # input channels != the weight's: groups
                grouped_us += us
        print(f"[profile] convolutions {conv_us / 2e3:.3f} ms/step of device time, the grouped "
              f"ones {grouped_us / 2e3:.3f} ms/step ({grouped_us / busy_us:.3f} of the device "
              f"time)", flush=True)
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
    smi = smi.stdout.strip()
    print(smi)
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
    paths["train"], bare_step = drive_training(dev, profile)
    drive_no_ssim_step(dev)
    paths["avg"] = drive_avg_step(dev)
    paths["indoor"] = drive_indoor(dev, profile)
    paths["trainer"] = drive_trainer(dev, smi, bare_step)
    paths["eval"] = drive_eval(dev, smi, profile)
    paths["finetune"] = drive_finetune(dev, smi, profile)
    for tag in ("convnext", "effb5"):
        paths[tag] = drive_backbone(dev, smi, tag, profile)
    convnext_layouts(dev, smi)
    paths["lite"] = drive_backbone(dev, smi, "lite", profile)
    paths["pose_mask"] = drive_pose_mask(dev, smi, profile)
    zoo_coverage()
    zoo_forwards(dev, smi)
    paths["zoo"] = drive_backbone(dev, smi, "zoo", profile)
    drive_remat(dev, smi)
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
