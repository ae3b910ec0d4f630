"""Weights into the port: from the JAX package's variables, or from a
reference-style folder of ``.pth`` files.

Both go through the reference's state-dict names, which the port's own
``utils/torch_export.py`` (numpy only) produces from the JAX parameter
trees; nothing of the JAX package is imported.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from sfmnext_tpu_torch.utils import torch_export

_NON_TENSOR_KEYS = ("height", "width", "use_stereo")


def _to_torch(sd) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}


def from_jax_variables(variables) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX ``{"params", "batch_stats"}`` (arrays or numpy) -> the port's
    state dicts ``{"encoder", "depth"[, "pose"]}``, BatchNorm running
    statistics included; ``"pose"`` when the tree holds a PoseCNN."""
    params, stats = variables["params"], variables["batch_stats"]
    out = {
        "encoder": _to_torch(torch_export.export_resnet_encoder_decoder(
            params["encoder"], stats["encoder"])),
        "depth": _to_torch(torch_export.export_sql_decoder(params["depth"])),
    }
    if "pose" in params:
        out["pose"] = _to_torch(torch_export.export_pose_cnn(params["pose"]))
    return out


def load_reference_folder(folder: str, models) -> None:
    """Load ``encoder.pth`` / ``depth.pth`` (the layout
    ``torch_export.save_reference_style_checkpoint`` writes) into
    ``models.encoder`` / ``models.depth``, strictly."""
    for name in ("encoder", "depth"):
        sd = torch.load(os.path.join(folder, f"{name}.pth"), map_location="cpu",
                        weights_only=True)
        for key in _NON_TENSOR_KEYS:
            sd.pop(key, None)
        getattr(models, name).load_state_dict(sd, strict=True)
