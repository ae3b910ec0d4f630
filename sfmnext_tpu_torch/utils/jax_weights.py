"""Weights into the port: from the JAX package's variables, or from a
reference-style folder of ``.pth`` files.

Both go through the reference's state-dict names, which
``sfmnext_tpu.utils.torch_export`` (numpy only, no JAX) produces from the
JAX parameter trees. That module is imported inside ``from_jax_variables``
only, so loading weights for inference imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

_NON_TENSOR_KEYS = ("height", "width", "use_stereo")


def _to_torch(sd) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}


def from_jax_variables(variables) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """JAX ``{"params", "batch_stats"}`` (arrays or numpy) -> the port's
    (encoder state dict, depth state dict)."""
    from sfmnext_tpu.utils import torch_export

    params, stats = variables["params"], variables["batch_stats"]
    enc = torch_export.export_resnet_encoder_decoder(params["encoder"], stats["encoder"])
    dep = torch_export.export_sql_decoder(params["depth"])
    return _to_torch(enc), _to_torch(dep)


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
