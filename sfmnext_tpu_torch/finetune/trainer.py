"""Metric finetuning: AdamW + OneCycle + SILog with the median-rescale
quirk. Counterpart of ``sfmnext_tpu/finetune/trainer.py``.

Behavioral reference: finetune/train_ft_SQLdepth.py:80-378 —
  - forward, bilinear-resize pred to GT (align_corners=True)      :235
  - per-sample median rescale of pred toward GT *during training*
    (garg-crop masked; applied to the first half of the batch)    :236-266
  - SILog on mask = depth > min_depth                             :272-276
  - global grad-norm clip 0.1                                      :284
  - AdamW(wd) + OneCycleLR(div_factor, final_div_factor)           :189-205
  - validation: flip-TTA average, 9 metrics, best-abs_rel ckpt     :295-378

The optimizer follows the JAX package's ``optax.chain(clip_by_global_norm,
adamw(cosine_onecycle_schedule))``, not torch's ``OneCycleLR`` (whose phase
ends fall one step earlier and which cycles Adam's beta1). The bundle holds
the encoder and the depth decoder only: the JAX package also builds a
PoseCNN, whose gradients are zero and which nothing reads. It runs on one
device, the CUDA card or, with ``--no_cuda``, the CPU.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from sfmnext_tpu_torch.device import disable_tf32, opt_device
from sfmnext_tpu_torch.evaluation import resize_np_bilinear
from sfmnext_tpu_torch.ops.image import resize_bilinear
from sfmnext_tpu_torch.ops.losses import silog_loss
from sfmnext_tpu_torch.ops.metrics import compute_metric_depth_errors
from sfmnext_tpu_torch.training.builder import build_models
from sfmnext_tpu_torch.training.pipeline import autocast
from sfmnext_tpu_torch.training.step import eval_mode
from sfmnext_tpu_torch.training.trainer import seed_step
from sfmnext_tpu_torch.utils import checkpoint as ckpt

CLIP_NORM = 0.1  # the global gradient-norm clip (reference :284)
MIN_DEPTH = 1e-3  # GT at or below this is no measurement


def onecycle_schedule(lr: float, total_steps: int, div_factor: float = 25.0,
                      final_div_factor: float = 100.0, pct_start: float = 0.3):
    """``optax.cosine_onecycle_schedule`` over ``max(total_steps, 10)``
    steps (the JAX package's clamp: shorter cycles have empty phases) as a
    function of the update count: a cosine from lr / div_factor up to lr at
    ``int(pct_start * T)``, then down to lr / (div_factor * final_div_factor)
    at T, flat after. optax's own arithmetic in float64 (it runs in float32,
    which leaves up to ~1.4e-7 of lr of rounding in its anneal)."""
    steps = max(int(total_steps), 10)
    bounds = (0, int(pct_start * steps), steps)
    values = np.cumprod([lr / div_factor, div_factor, 1.0 / (div_factor * final_div_factor)])

    def schedule(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return float(end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1))
        return float(values[-1])

    return schedule


def make_finetune_optimizer(params, lr: float, total_steps: int, weight_decay: float = 0.1):
    """(``torch.optim.AdamW`` over ``params`` in one group, its OneCycle
    schedule as a ``LambdaLR``): the learning rate of update k (counted from
    0) is ``onecycle_schedule(lr, total_steps)(k)``, read before the update
    as optax reads it. b1 0.9, b2 0.999, eps 1e-8, the decay applied to
    every parameter (``optax.adamw`` has no mask). Call the scheduler once
    after every optimizer step; ``finetune_update`` does both, after the
    clip."""
    schedule = onecycle_schedule(lr, total_steps)
    adamw = torch.optim.AdamW(list(params), lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=weight_decay)
    return adamw, torch.optim.lr_scheduler.LambdaLR(adamw, schedule)


def finetune_update(optimizer, scheduler) -> None:
    """One update after a backward: the global-norm clip as optax clips
    (gradients scaled by CLIP_NORM / norm when norm >= CLIP_NORM, no epsilon;
    ``clip_grad_norm_`` adds 1e-6 to the norm), then AdamW and the schedule.
    A parameter without a gradient gets zeros, as JAX's gradient of a
    parameter the loss does not reach: AdamW still decays it."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.where(norm < CLIP_NORM, 1.0, CLIP_NORM / norm))
    optimizer.step()
    scheduler.step()


def _masked_median_per_sample(x, mask):
    """The lower masked median of each sample of [B,...]: the sorted masked
    values' entry (n - 1) // 2, masked-out entries set to +inf; an empty
    mask gives entry 0 (+inf), as in the JAX package."""
    b = x.shape[0]
    flat = torch.where(mask, x, torch.full((), math.inf, dtype=x.dtype, device=x.device))
    flat = flat.reshape(b, -1)
    n = mask.reshape(b, -1).sum(dim=1)
    idx = torch.div(n - 1, 2, rounding_mode="floor").clamp(0, flat.shape[1] - 1)
    return flat.sort(dim=1).values.gather(1, idx[:, None])[:, 0]


def garg_mask(gt, min_d: float, max_d: float):
    """[B,H,W,1] GT inside (min_d, max_d) and inside the Garg crop."""
    _, h, w, _ = gt.shape
    crop = torch.zeros((h, w), dtype=torch.bool, device=gt.device)
    crop[int(0.40810811 * h):int(0.99189189 * h), int(0.03594771 * w):int(0.96405229 * w)] = True
    return (gt > min_d) & (gt < max_d) & crop[None, :, :, None]


def finetune_loss(models, images, gt, max_depth: float = 80.0):
    """SILog of the models' depth on ``images`` [B,H,W,3] against ``gt``
    [B,H',W',1] (JAX ``make_finetune_step``'s ``loss_fn``, :107-128): the
    decoder's ``disp0`` resized to the GT's size (align_corners=True); the
    first b // 2 samples scaled by their garg-masked median ratio of GT to
    prediction (no gradient through the ratio); SILog on gt > MIN_DEPTH.
    The networks run under autocast in the compute dtype, the loss in
    float32."""
    with autocast(models, images.device):
        disp0 = models.depth(models.encoder(images.permute(0, 3, 1, 2)))["disp0"]
    pred = resize_bilinear(disp0.float(), gt.shape[1:3], align_corners=True).permute(0, 2, 3, 1)
    with torch.no_grad():
        m = garg_mask(gt, MIN_DEPTH, max_depth)
        ratio = _masked_median_per_sample(gt, m) / (_masked_median_per_sample(pred, m) + 1e-7)
        b = pred.shape[0]
        sel = (torch.arange(b, device=pred.device) < b // 2).to(pred.dtype)
        ratio = ratio * sel + (1.0 - sel)
    pred = pred * ratio[:, None, None, None]
    mask = gt > MIN_DEPTH
    one = torch.ones((), dtype=pred.dtype, device=pred.device)
    return silog_loss(torch.where(mask, pred, one), torch.where(mask, gt, one), mask)


def make_finetune_step(models, optimizer, scheduler, max_depth: float = 80.0):
    """The supervised step: ``step(batch) -> {"loss": 0-d tensor}`` on a
    batch of ``image`` [B,H,W,3] and ``depth`` [B,H',W',1] on the models'
    device: ``finetune_loss``, its backward and ``finetune_update``. The
    encoder's BatchNorm statistics update in the forward (the SQL decoder
    has none); its dropout draws from torch's default generator (the
    Trainer seeds it per step, ``training/trainer.seed_step``). Turns TF32
    off."""
    disable_tf32()

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = finetune_loss(models, batch["image"], batch["depth"], max_depth)
        loss.backward()
        finetune_update(optimizer, scheduler)
        return {"loss": loss.detach()}

    return step


def predict_tta(infer_fn, images):
    """Flip-TTA average of NCHW ``images``: the prediction and the
    prediction of the flipped images flipped back, over the width axis (3)
    (reference finetune/evaluate_metric_depth.py:47-62)."""
    pred = infer_fn(images)
    pred_f = infer_fn(images.flip(3))
    return 0.5 * (pred + pred_f.flip(3))


def score(infer, loader, device, min_d: float, max_d: float, crop=None) -> dict:
    """The 9-metric dict averaged over the images of ``loader`` (batches of
    ``DepthDataset`` items), the policy of the reference's
    evaluate_metric_depth.py: a batch whose ``has_valid_depth`` is not all
    true is skipped; the flip-TTA of ``infer`` resized to each GT on the
    host and clipped to [min_d, max_d], NaN to min_d; the mask GT in
    (min_d, max_d), and ``crop(gh, gw)`` when given; an image with an empty
    mask is skipped. The JAX finetune validation scores the same way, bar
    the skip and the NaN cleanup, which change nothing on finite
    predictions of batches that all hold GT."""
    all_metrics = []
    for batch in loader:
        if not np.all(np.asarray(batch.get("has_valid_depth", True))):
            continue
        img = torch.as_tensor(batch["image"]).to(device).permute(0, 3, 1, 2)
        gt = np.asarray(batch["depth"])
        pred = predict_tta(infer, img)[:, 0].cpu().numpy()
        for i in range(len(gt)):
            g = gt[i, ..., 0]
            p = np.clip(resize_np_bilinear(pred[i], g.shape), min_d, max_d)
            p[np.isnan(p)] = min_d
            mask = (g > min_d) & (g < max_d)
            if crop is not None:
                mask &= crop(*g.shape)
            if mask.sum() == 0:
                continue
            all_metrics.append(compute_metric_depth_errors(g[mask], p[mask]))
    return {k: float(np.mean([m[k] for m in all_metrics])) for k in all_metrics[0]}


def make_disp_fn(models):
    """``infer(images NCHW) -> disp0 [B,1,H/2,W/2]`` float32: the decoder's
    depth with the models in eval mode, under autocast in their compute
    dtype, as the JAX validation runs its eval models at ``compute_dtype``."""

    def infer(images):
        with eval_mode(models), autocast(models, images.device):
            return models.depth(models.encoder(images))["disp0"].float()

    return infer


class FinetuneTrainer:
    """``FinetuneTrainer(opt, train_loader, test_loader=None, lr, weight_decay,
    epochs).train()``: supervised finetuning to metric depth.

    The loaders yield batches of ``DepthDataset`` items (``image``,
    ``depth``, ``has_valid_depth``), numpy or tensors. The losses it reads
    (every ``log_every``-th step) go to ``losses``; host-clock timings to
    ``timings``: ``step`` (those steps, upload to the read), ``val`` (a
    whole ``validate``) and ``save`` (a checkpoint write).
    """

    def __init__(self, opt, train_loader, test_loader=None, lr: float = 1.6e-4,
                 weight_decay: float = 0.1, epochs: int = 25):
        self.opt = opt.validate()
        disable_tf32()
        self.device = opt_device(opt)
        if opt.mesh_shape is not None and opt.mesh_shape > 1:
            raise NotImplementedError(
                f"mesh_shape {opt.mesh_shape}: the port trains on one device; data parallel "
                "is ROADMAP queue 1, item 6")
        self.models = build_models(opt, self.device, train=True, depth_only=True)
        self._warm_start()
        total_steps = max(1, len(train_loader)) * epochs
        self.schedule = onecycle_schedule(lr, total_steps)
        params = [p for m in self.models.modules().values() for p in m.parameters()]
        self.optimizer, self.scheduler = make_finetune_optimizer(params, lr, total_steps,
                                                                 weight_decay)
        self.step_fn = make_finetune_step(self.models, self.optimizer, self.scheduler,
                                          max_depth=opt.max_depth)
        self.train_loader = train_loader
        self.test_loader = test_loader
        self.epochs = epochs
        self.best_abs_rel = np.inf
        self.step = 0
        self.generator = torch.Generator(device=self.device)
        self.losses = []
        self.timings = {"step": [], "val": [], "save": []}

    def _warm_start(self):
        """The SSL-trained encoder and depth the finetune starts from
        (reference SQLdepth.py:32-45 via --load_pt_folder, and
        inc_kitti.txt's --load_weights_folder)."""
        folder = None
        if self.opt.load_pretrained_model and self.opt.load_pt_folder:
            folder = self.opt.load_pt_folder
        elif self.opt.load_weights_folder:
            folder = self.opt.load_weights_folder
        if folder:
            ckpt.load_encoder_depth(folder, self.models)
            print(f"-> finetune warm start from {folder} (.pth)", flush=True)

    def train(self, log_every: int = 50):
        """The epoch loop. A batch whose ``has_valid_depth`` is not all true
        is skipped and does not advance the update count. After each epoch
        with a test loader: ``validate``, a ``best`` checkpoint when abs_rel
        improved, and ``latest``. Returns the last validation's metrics
        (None without a test loader)."""
        metrics = None
        for epoch in range(self.epochs):
            for batch in self.train_loader:
                if not np.all(np.asarray(batch.get("has_valid_depth", True))):
                    continue
                t0 = time.perf_counter()
                b = {k: torch.as_tensor(batch[k]).to(self.device, non_blocking=True)
                     for k in ("image", "depth")}
                seed_step(self.generator, self.opt.seed, self.step)
                loss = self.step_fn(b)["loss"]
                if self.step % log_every == 0:
                    loss = float(loss)  # the one sync of a step
                    self.timings["step"].append(time.perf_counter() - t0)
                    self.losses.append(loss)
                    print(f"ft epoch {epoch} step {self.step} silog={loss:.4f}", flush=True)
                self.step += 1
            if self.test_loader is not None:
                metrics = self.validate(max_depth=self.opt.max_depth)
                print(f"ft epoch {epoch} val: {metrics}", flush=True)
                if metrics["abs_rel"] < self.best_abs_rel:
                    self.best_abs_rel = metrics["abs_rel"]
                    self.save("best")
                self.save("latest")
        return metrics

    def save(self, tag: str):
        """``<log_dir>/<model_name>/finetune/weights_<tag>``: the modules,
        AdamW, the schedule and the update count (``utils/checkpoint``)."""
        folder = os.path.join(self.opt.log_dir, self.opt.model_name, "finetune", f"weights_{tag}")
        t0 = time.perf_counter()
        ckpt.save_checkpoint(folder, self.models, self.opt, self.optimizer, self.scheduler,
                             None, self.step)
        self.timings["save"].append(time.perf_counter() - t0)
        print(f"-> saved finetune checkpoint {folder}", flush=True)

    def validate(self, max_depth: float = 80.0) -> dict:
        """``score`` of the models' flip-TTA over the test loader on GT in
        (MIN_DEPTH, max_depth), without a crop."""
        t0 = time.perf_counter()
        metrics = score(make_disp_fn(self.models), self.test_loader, self.device, MIN_DEPTH,
                        max_depth)
        self.timings["val"].append(time.perf_counter() - t0)
        return metrics
