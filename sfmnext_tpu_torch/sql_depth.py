"""SQLdepth: encoder + SQL decoder inference wrapper. Counterpart of
``sfmnext_tpu/sql_depth.py``."""

from __future__ import annotations

import torch

from sfmnext_tpu_torch.ops.image import resize_bilinear
from sfmnext_tpu_torch.training.builder import build_models
from sfmnext_tpu_torch.utils.jax_weights import load_reference_folder


class SQLdepth:
    """Callable depth model: images [B,H,W,3] in [0,1] -> depth [B,H,W,1].

    ``opt`` is a ``sfmnext_tpu_torch.config.Options`` or any object with its
    model fields (backbone, num_layers, num_features, model_dim,
    patch_size, query_nums, dim_out, min_depth, max_depth, compute_dtype,
    seed, load_pretrained_model, load_pt_folder); the decoder itself
    rejects token counts the model cannot take. Computes in
    ``opt.compute_dtype``; in bf16 on a CUDA card the SQL decoder runs its
    two Hopper kernels. Loads ``opt.load_pt_folder`` when
    ``opt.load_pretrained_model`` is set, else keeps the seeded init.
    """

    def __init__(self, opt, device):
        self.opt = opt
        self.device = torch.device(device)
        self.models = build_models(opt, self.device)
        if opt.load_pretrained_model and opt.load_pt_folder:
            load_reference_folder(opt.load_pt_folder, self.models)

    def __call__(self, images, out_hw=None) -> torch.Tensor:
        """Depth [B,H',W',1] float32 on the model's device, resized from
        the decoder's 1/2 resolution to ``out_hw`` (default: the input's)."""
        with torch.inference_mode():
            x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
            x = x.permute(0, 3, 1, 2)
            out = self.models.depth(self.models.encoder(x))
            depth = resize_bilinear(
                out["disp0"], out_hw or tuple(x.shape[-2:]), align_corners=False
            )
            return depth.permute(0, 2, 3, 1)
