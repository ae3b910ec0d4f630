"""Single-image depth inference CLI on the PyTorch port.

Counterpart of ``test_simple_SQL_config.py``: load image(s) from
--image_path, resize to the model's feed size, forward, bilinear-resize the
1/2-resolution depth to the original resolution, save a uint16 png
(depth*1000) and a plasma-colormap jpeg next to the input.

    python -m sfmnext_tpu_torch.test_simple <argfile> --image_path img.png \
        [--load_weights_folder DIR] [--compute_dtype float32] [--no_cuda]

It runs through the port's ``SQLdepth``, so its dtype follows
--compute_dtype: bfloat16 by default (on a CUDA card, the fused Hopper
kernels), while the JAX CLI always evaluates in float32; with
--compute_dtype float32 it computes what the JAX CLI computes.
--load_weights_folder takes a reference-style folder of encoder.pth /
depth.pth. It runs on the CUDA card, or on the CPU with --no_cuda.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from sfmnext_tpu_torch.config import parse_options
from sfmnext_tpu_torch.device import cuda_device, disable_tf32
from sfmnext_tpu_torch.sql_depth import SQLdepth


def colormap_plasma(x: np.ndarray) -> np.ndarray:
    """[H,W] -> uint8 RGB via matplotlib plasma (vmax = 95th percentile)."""
    import matplotlib

    vmax = np.percentile(x, 95)
    norm = np.clip(x / max(vmax, 1e-9), 0, 1)
    return (matplotlib.colormaps["plasma"](norm)[..., :3] * 255).astype(np.uint8)


def test_simple(opt, device) -> None:
    from PIL import Image

    if opt.image_path is None:
        raise SystemExit("--image_path is required")
    if os.path.isdir(opt.image_path):
        paths = sorted(
            os.path.join(opt.image_path, f)
            for f in os.listdir(opt.image_path)
            if f.lower().endswith(("." + opt.ext, ".jpg", ".jpeg", ".png"))
        )
        out_dir = opt.image_path
    else:
        paths = [opt.image_path]
        out_dir = os.path.dirname(opt.image_path) or "."

    model = SQLdepth(opt, device)
    print(f"-> Predicting on {len(paths)} test images")
    for idx, path in enumerate(paths):
        img = Image.open(path).convert("RGB")
        ow, oh = img.size
        feed = img.resize((opt.width, opt.height), Image.LANCZOS)
        x = np.asarray(feed, np.float32)[None] / 255.0
        depth = model(x, out_hw=(oh, ow))[0, :, :, 0].cpu().numpy()

        stem = os.path.splitext(os.path.basename(path))[0]
        png16 = (np.clip(depth, 0, 65.535) * 1000).astype(np.uint16)
        Image.fromarray(png16).save(os.path.join(out_dir, f"{stem}_depth.png"))
        Image.fromarray(colormap_plasma(depth)).save(
            os.path.join(out_dir, f"{stem}_disp.jpeg")
        )
        print(f"   Processed {idx + 1} of {len(paths)} images - saved to {out_dir}")
    print("-> Done!")


def main(argv=None) -> None:
    opt = parse_options(argv if argv is not None else sys.argv[1:])
    if opt.load_weights_folder:
        opt = dataclasses.replace(
            opt, load_pretrained_model=True, load_pt_folder=opt.load_weights_folder
        )
    device = torch.device("cpu") if opt.no_cuda else cuda_device()
    disable_tf32()
    test_simple(opt, device)


if __name__ == "__main__":
    main()
