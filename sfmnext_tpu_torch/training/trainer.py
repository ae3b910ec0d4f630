"""Trainer: the epoch and step loop around the train step. Counterpart of
``sfmnext_tpu/training/trainer.py``.

Behavioral reference: trainer.py:30-688 (outdoor Trainer) — dataset switch
(:144-148), split file lists (:150-157), per-epoch StepLR (:222-226),
early/late-phase logging cadence (:252-262), one-val-minibatch-per-log
(:363-384), per-epoch checkpoints (:225-226, 638-660).

The models, optimizer and steps live in builder.py / step.py; this class
owns the data feed, the log cadence and checkpoint IO. It runs on one
device: the CUDA card, or the CPU with ``--no_cuda``.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Optional

import numpy as np
import torch

from sfmnext_tpu_torch.device import disable_tf32, opt_device
from sfmnext_tpu_torch.training.builder import build_models
from sfmnext_tpu_torch.training.pipeline import train_depth_metrics
from sfmnext_tpu_torch.training.step import make_eval_step, make_optimizer, make_train_step
from sfmnext_tpu_torch.utils import checkpoint as ckpt
from sfmnext_tpu_torch.utils.imagenet_init import apply_weights_init
from sfmnext_tpu_torch.utils.logging import MetricWriter, ThroughputLogger, dump_options


def find_splits_dir() -> str:
    """Locate the split file lists (env override, repo-local, none)."""
    for cand in (
        os.environ.get("SFMNEXT_SPLITS", ""),
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                     "splits"),
        "splits",
    ):
        if cand and os.path.isdir(cand):
            return cand
    return "splits"


def make_dataset(opt, filenames, is_train: bool):
    """The dataset of ``opt.dataset`` over ``filenames`` at the training
    resolution and ``opt.all_frame_ids`` (the JAX trainer's switch,
    reference trainer.py:144-148, trainer_indoor.py for NYU and
    MannequinChallenge)."""
    from sfmnext_tpu_torch.data import cityscapes, kitti, mannequin, nyu

    datasets = {
        "kitti": kitti.KITTIRAWDataset,
        "kitti_odom": kitti.KITTIOdomDataset,
        "kitti_depth": kitti.KITTIDepthDataset,
        "cityscapes_preprocessed": cityscapes.CityscapesPreprocessedDataset,
        "nyu_raw": nyu.NYURawDataset,
        "mc_dataset": mannequin.MCDataset,
        "mc_mini_dataset": mannequin.MCDataset,
    }
    if opt.dataset not in datasets:
        raise ValueError(f"dataset {opt.dataset!r}: one of {sorted(datasets)}")
    cls = datasets[opt.dataset]
    extra = {}
    if cls is mannequin.MCDataset:  # reference trainer_indoor.py reads --intrinsics_file_path
        extra["intrinsics_file"] = opt.intrinsics_file_path or None
    return cls(opt.data_path, filenames, opt.height, opt.width, opt.all_frame_ids,
               is_train=is_train, img_ext=opt.img_ext, **extra)


def seed_step(generator: torch.Generator, seed: int, step: int) -> torch.Generator:
    """Seed step ``step`` of a run seeded ``seed``, as the JAX package folds
    the step into its key (``fold_in(rng, step)``): ``generator`` (the
    augmentation and the tie-break noise) and torch's default generators
    (the transformer's dropout) from two independent draws of (seed, step).
    A resumed run draws what the unbroken run draws, and no generator state
    needs saving. Returns ``generator``."""
    gen_seed, dropout_seed = np.random.SeedSequence([seed, step]).generate_state(2, np.uint64)
    torch.manual_seed(int(dropout_seed))
    return generator.manual_seed(int(gen_seed))


def _host(values):
    """{name: 0-d tensor} -> {name: float}, one device-to-host copy."""
    names = list(values)
    return dict(zip(names, torch.stack([values[k].float() for k in names]).tolist()))


class Trainer:
    """``Trainer(opt, train_loader=None, val_loader=None).train()``.

    The loaders yield batches of numpy arrays or tensors in the pipeline's
    layout (``data/synthetic.py``'s keys; ``depth_gt`` [B,H,W,1], when
    present, adds the ``de/*`` and ``da/*`` depth metrics to the log). The
    Trainer keeps host-clock timings in ``timings``: ``step`` (the steps
    whose loss it reads, from the batch's upload to the read), ``val`` (a
    whole ``val``: the eval step, the metrics, the panels) and ``save`` (a
    checkpoint write).
    """

    def __init__(self, opt, train_loader=None, val_loader=None):
        self.opt = opt.validate()
        disable_tf32()
        self.device = opt_device(opt)
        if opt.mesh_shape is not None and opt.mesh_shape > 1:
            raise NotImplementedError(
                f"mesh_shape {opt.mesh_shape}: the port trains on one device; data parallel "
                "is ROADMAP queue 1, item 6")
        self.log_path = os.path.join(opt.log_dir, opt.model_name)
        self.models = build_models(opt, self.device, train=True)

        # ImageNet trunk init (reference resnet_encoder.py:44,57), skipped
        # when a checkpoint will overwrite the encoder anyway
        if not (opt.load_pretrained_model or opt.load_weights_folder):
            apply_weights_init(opt, self.models)
        if opt.load_pretrained_model and opt.load_pt_folder:
            self._warm_start(opt.load_pt_folder)
        if opt.pretrained_pose:  # with the separate_resnet pose encoder where there is one
            self._load_named("pose", opt.pose_net_path, "--pretrained_pose")
            if self.models.pose_encoder is not None:
                self._load_named("pose_encoder", opt.pose_net_path, "--pretrained_pose")
        if opt.pretrained_rectify:
            self._load_named("rectify", opt.pose_net_path, "--pretrained_rectify")

        # data ------------------------------------------------------------
        if train_loader is None:
            from sfmnext_tpu_torch.data.loader import PrefetchLoader
            from sfmnext_tpu_torch.data.mono_dataset import read_lines

            fpath = os.path.join(find_splits_dir(), opt.split, "{}_files.txt")
            train_loader = PrefetchLoader(
                make_dataset(opt, read_lines(fpath.format("train")), True),
                opt.batch_size, shuffle=True, num_workers=opt.num_workers, seed=opt.seed)
            val_loader = PrefetchLoader(
                make_dataset(opt, read_lines(fpath.format("val")), False),
                opt.batch_size, shuffle=True, num_workers=max(1, opt.num_workers // 2),
                seed=opt.seed + 1, infinite=True)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.val_iter = iter(val_loader) if val_loader is not None else None

        self.steps_per_epoch = opt.steps_per_epoch or max(1, len(train_loader))
        self.num_total_steps = self.steps_per_epoch * opt.num_epochs

        # optimizer / steps -----------------------------------------------
        self.adam, self.scheduler = make_optimizer(opt, self.models, self.steps_per_epoch)
        self.train_step = make_train_step(opt, self.models, self.adam, self.scheduler,
                                          augment=True)
        self.eval_step = make_eval_step(opt, self.models)
        self.generator = torch.Generator(device=self.device)

        # observability ---------------------------------------------------
        self.writers = {mode: MetricWriter(self.log_path, mode, use_jsonl=opt.log_jsonl)
                        for mode in ("train", "val")}
        self.throughput = ThroughputLogger(opt.batch_size, self.num_total_steps)
        self.timings = {"step": [], "val": [], "save": []}
        dump_options(opt, self.log_path)
        n_params = sum(p.numel() for m in self.models.modules().values() for p in m.parameters())
        print(f"Training {opt.model_name}: {n_params:,} params, {self.steps_per_epoch} "
              f"steps/epoch x {opt.num_epochs} epochs, device {self.device}", flush=True)

        self.epoch = 0
        self.step = 0
        self._interrupted = None

        # resume (reference load_model, trainer.py:662-688). ``--load_weights_folder
        # latest`` resumes from this run's newest checkpoint if one exists, else
        # starts fresh: one command line for the first launch and every relaunch
        folder = opt.load_weights_folder
        self._resumed_latest = False
        if folder == "latest":
            folder = self._latest_checkpoint()
            self._resumed_latest = folder is not None
            if folder is None:
                print("-> no checkpoint yet; starting fresh", flush=True)
        if folder:
            self.load_model(folder, restore_all=self._resumed_latest)
        elif opt.load_adam:
            if not (opt.load_pretrained_model and opt.load_pt_folder):
                raise ValueError("--load_adam needs --load_pretrained_model with "
                                 "--load_pt_folder (reference trainer_indoor.py:157-166)")
            self._load_adam(opt.load_pt_folder)
        if opt.multi_gpu:
            # the reference parses this and never reads it (options.py:205-207)
            print(f"-> --multi_gpu: one device ({self.device}); data parallel is not ported",
                  flush=True)

    # -------------------------------------------------------------- warm start
    def _warm_start(self, folder):
        """Pretrained encoder and depth from ``encoder.pth`` / ``depth.pth``
        (reference trainer.py:66-90)."""
        ckpt.load_encoder_depth(folder, self.models)
        print(f"-> warm-started encoder/depth from {folder}", flush=True)

    def _load_named(self, name, folder, flag):
        """``--pretrained_pose`` / ``--pretrained_rectify``: ``<pose_net_path>/
        <name>.pth`` (reference trainer.py:100-104, trainer_indoor.py:101-107)."""
        if not folder:
            raise ValueError(f"{flag} requires --pose_net_path")
        module = self.models.modules().get(name)
        if module is None:
            raise ValueError(f"{flag}: this configuration has no {name} network")
        ckpt.load_module(folder, name, module)
        print(f"-> loaded pretrained {name} from {folder}/{name}.pth", flush=True)

    # ------------------------------------------------------------------ train
    def train(self):
        """Run the epoch loop, preemption-aware.

        A ``--load_weights_folder latest`` resume fast-forwards to the
        epoch its restored step count implies (an explicit folder keeps
        reference semantics: the epoch schedule restarts, trainer.py:662-688).
        SIGTERM/SIGINT set a flag that run_epoch checks once a step: the
        trainer writes a ``weights_interrupt`` checkpoint at the next step
        boundary and returns.
        """
        self._interrupted = None
        self._interrupt_saved = False
        prev = {s: signal.signal(s, self._on_interrupt) for s in (signal.SIGTERM, signal.SIGINT)}
        try:
            start_epoch = 0
            if self._resumed_latest:
                start_epoch = min(self.step // max(self.steps_per_epoch, 1), self.opt.num_epochs)
            if start_epoch == 0:
                self.save_model()  # epoch-0 snapshot (reference trainer.py:221)
            for self.epoch in range(start_epoch, self.opt.num_epochs):
                self.run_epoch()
                if self._interrupted is not None:
                    self._checkpoint_interrupt()
                    return
                if (self.epoch + 1) % self.opt.save_frequency == 0:
                    self.save_model()
        finally:
            for s, h in prev.items():
                signal.signal(s, h)

    def _on_interrupt(self, signum, frame):
        print(f"-> caught signal {signum}; checkpointing at next step boundary", flush=True)
        self._interrupted = signum

    def _checkpoint_interrupt(self):
        if self._interrupt_saved:
            return
        self._interrupt_saved = True
        self.save_model(tag="interrupt")
        print(f"-> interrupted at step {self.step}; resume with --load_weights_folder latest",
              flush=True)

    def run_epoch(self):
        print("Training", flush=True)
        for batch_idx, batch in enumerate(self.train_loader):
            if batch_idx >= self.steps_per_epoch:
                break
            if self._interrupted is not None:
                self._checkpoint_interrupt()
                return
            t0 = time.perf_counter()
            batch = self._device_batch(batch)
            metrics = self.train_step(batch, seed_step(self.generator, self.opt.seed, self.step))
            depth = metrics.pop("depth")
            early = batch_idx % self.opt.log_frequency == 0 and self.step < 2000
            late = self.step % 1000 == 0
            if early or late:
                vals = _host(metrics)  # the one sync of a step
                duration = time.perf_counter() - t0
                self.timings["step"].append(duration)
                self.throughput.log(self.epoch, batch_idx, self.step, duration, vals["loss"])
                if "depth_gt" in batch:
                    vals.update(_host(train_depth_metrics(depth, batch["depth_gt"])))
                self.writers["train"].scalars(self.step, vals)
                self.val()
            self.step += 1
            # step-periodic checkpoints (reference trainer_indoor.py:317, 327-328)
            if self.opt.save_step_frequency and self.step % self.opt.save_step_frequency == 0:
                self.save_model(tag=f"step_{self.step}")

    def val(self):
        """One validation minibatch through the eval step, its losses and
        depth metrics logged, and its panels."""
        if self.val_iter is None:
            return
        t0 = time.perf_counter()
        try:
            batch = next(self.val_iter)
        except StopIteration:
            self.val_iter = iter(self.val_loader)
            batch = next(self.val_iter)
        batch = self._device_batch(batch)
        metrics, outputs = self.eval_step(batch)
        vals = _host(metrics)
        if "depth_gt" in batch:
            vals.update(_host(train_depth_metrics(outputs["depth"], batch["depth_gt"])))
        self.writers["val"].scalars(self.step, vals)
        if self.opt.log_images:
            self._log_images("val", batch, outputs)
        self.timings["val"].append(time.perf_counter() - t0)

    def _log_images(self, mode, batch, outputs, max_n: int = 2):
        """Visual-debug panels: input / warped / disp / automask / the
        predictive mask of each source (reference trainer.py:593-625, JAX
        trainer.py:439-444), downsampled 2x for IO."""

        def ds(a):  # device -> host, 2x downsampled
            return a[::2, ::2].float().cpu().numpy()

        panels = {}
        color = batch["color"]  # [B,F,H,W,3]
        for j in range(min(max_n, color.shape[0])):
            for idx, f_i in enumerate(self.opt.all_frame_ids):
                panels[f"color_{f_i}_0/{j}"] = ds(color[j, idx])
                key = f"warped_{f_i}"
                if f_i != 0 and key in outputs:
                    panels[f"color_pred_{f_i}_0/{j}"] = ds(outputs[key][j])
            disp = 1.0 / outputs["depth"][j, ..., 0].clamp(min=1e-6)
            disp = (disp - disp.min()) / (disp.max() - disp.min() + 1e-7)
            panels[f"disp_0/{j}"] = ds(disp)
            if "automask" in outputs:
                panels[f"automask_0/{j}"] = ds(outputs["automask"][j])
            mask = outputs.get("predictive_mask")  # [B,H,W,n_sources]
            for f in range(0 if mask is None else mask.shape[-1]):
                panels[f"predictive_mask_{f}_0/{j}"] = ds(mask[j, ..., f])
        self.writers[mode].images(self.step, panels)

    def _device_batch(self, batch):
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    # ------------------------------------------------------------ checkpoints
    def _latest_checkpoint(self) -> Optional[str]:
        """Newest ``weights_*`` checkpoint folder of this run (mtime order),
        or None if the run has never checkpointed."""
        root = os.path.join(self.log_path, "models")
        if not os.path.isdir(root):
            return None
        cands = [os.path.join(root, d) for d in os.listdir(root)
                 if d.startswith("weights_") and os.path.isdir(os.path.join(root, d))]
        return max(cands, key=os.path.getmtime) if cands else None

    def save_model(self, tag: Optional[str] = None):
        folder = os.path.join(self.log_path, "models", f"weights_{self.epoch if tag is None else tag}")
        t0 = time.perf_counter()
        ckpt.save_checkpoint(folder, self.models, self.opt, self.adam, self.scheduler,
                             self.train_step.accumulation, self.step)
        self.timings["save"].append(time.perf_counter() - t0)
        print(f"-> saved checkpoint {folder}", flush=True)

    def load_model(self, folder: Optional[str] = None, restore_all: bool = False):
        """Resume: the modules, the optimizer, the schedule, the
        accumulation and the step count.

        Only the modules named in ``--models_to_load`` are restored, as in
        the reference (trainer.py:671-678); the rest keep their fresh init.
        ``adam.pth`` loads whenever present (:680-688). ``restore_all=True``
        (the ``latest`` path) restores every module.
        """
        folder = folder or self.opt.load_weights_folder
        names = [n for n in self.models.modules() if restore_all or n in self.opt.models_to_load]
        ckpt.load_modules(folder, self.models, names)
        step = ckpt.load_training_state(folder, self.adam, self.scheduler,
                                        self.train_step.accumulation)
        if step is None:
            print("Cannot find Adam weights so Adam is randomly initialized", flush=True)
        else:
            self.step = step
        skipped = sorted(set(self.models.modules()) - set(names))
        msg = f" (models_to_load skipped: {', '.join(skipped)})" if skipped else ""
        print(f"-> loaded checkpoint {folder} at step {self.step}{msg}", flush=True)

    def _load_adam(self, folder: str):
        """``--load_adam`` with ``--load_pt_folder`` (indoor warm start,
        reference trainer_indoor.py:157-166): the optimizer, schedule and
        accumulation of the port's own ``adam.pth``, not the step count."""
        if ckpt.load_training_state(folder, self.adam, self.scheduler,
                                    self.train_step.accumulation) is None:
            raise FileNotFoundError(f"--load_adam: no adam.pth in {folder}")
        print(f"-> loaded Adam state from {folder}/adam.pth", flush=True)
