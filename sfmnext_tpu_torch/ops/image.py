"""Image ops. Counterpart of ``sfmnext_tpu/ops/image.py`` (resize only).

The JAX package expresses the resize as interpolation-matrix matmuls, a
TPU layout workaround; here it is ``F.interpolate`` itself, which is the
semantics the JAX version was written to match.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = False):
    """Bilinear resize of NCHW ``x`` to ``out_hw`` (no antialiasing).

    Unlike the JAX counterpart (NHWC) this takes the port's internal NCHW
    layout. ``align_corners=True`` is DecoderBN's upsample, ``False`` the
    final depth resize.
    """
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(
        x, size=tuple(out_hw), mode="bilinear", align_corners=align_corners,
        antialias=False,
    )
