"""Observability: metrics jsonl, optional TensorBoard, image panels as PNG
files, and the throughput line. Counterpart of
``sfmnext_tpu/utils/logging.py``.

Behavioral reference: trainer.py:173-175 (train/val SummaryWriters),
:581-591 (console examples/s + ETA line), :593-625 (scalar + image panels),
:627-636 (opt.json config dump).

The jsonl stream is the canonical record (``--log_jsonl``). TensorBoard
gets the scalars and panels too when ``torch.utils.tensorboard`` imports.
The panels are always written as PNG files, by ``write_png`` (zlib and
struct, no imaging library), so they exist on a machine without PIL or
TensorBoard.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Dict

import numpy as np


def sec_to_hm_str(t: float) -> str:
    t = int(t)
    s, t = t % 60, t // 60
    m, h = t % 60, t // 60
    return f"{h:02d}h{m:02d}m{s:02d}s"


def write_png(path: str, image: np.ndarray) -> None:
    """A PNG of ``image``: [H,W,3] uint8 as 8-bit RGB, or [H,W] uint16 as
    16-bit grayscale (big-endian samples); one IDAT chunk of filter-0 rows."""
    if image.ndim == 3 and image.shape[2] == 3 and image.dtype == np.uint8:
        h, w, _ = image.shape
        depth, color_type, rows = 8, 2, image.reshape(h, w * 3)
    elif image.ndim == 2 and image.dtype == np.uint16:
        h, w = image.shape
        depth, color_type, rows = 16, 0, image.astype(">u2").view(np.uint8).reshape(h, w * 2)
    else:
        raise ValueError(f"write_png takes [H,W,3] uint8 or [H,W] uint16, got "
                         f"{image.shape} {image.dtype}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)  # no interlace
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


class MetricWriter:
    """Per-mode (train/val) metric sink: jsonl, PNG panels, and TensorBoard
    when it imports."""

    def __init__(self, log_dir: str, mode: str, use_tb: bool = True,
                 use_jsonl: bool = True):
        self.mode = mode
        self.dir = os.path.join(log_dir, mode)
        os.makedirs(self.dir, exist_ok=True)
        self.jsonl = (
            open(os.path.join(self.dir, "metrics.jsonl"), "a")
            if use_jsonl else None
        )
        self.tb = None
        if use_tb:
            try:
                from torch.utils.tensorboard.writer import SummaryWriter
            except ImportError:
                pass
            else:
                self.tb = SummaryWriter(self.dir)

    def scalars(self, step: int, values: Dict[str, float]):
        if self.jsonl is not None:
            rec = {"step": int(step), "time": time.time()}
            rec.update({k: float(v) for k, v in values.items()})
            self.jsonl.write(json.dumps(rec) + "\n")
            self.jsonl.flush()
        if self.tb is not None:
            for k, v in values.items():
                self.tb.add_scalar(k, float(v), step)

    def images(self, step: int, images: Dict[str, np.ndarray]):
        """images: name -> [H,W] or [H,W,C] float in [0,1] (C 1 or 3), as
        ``<dir>/images/step<step>_<name>.png`` (the reference's visual-debug
        panels, trainer.py:593-625) and to TensorBoard when present."""
        img_dir = os.path.join(self.dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        for name, img in images.items():
            arr = np.clip(np.asarray(img, np.float32), 0, 1)
            if arr.ndim == 2:
                arr = arr[..., None]
            if self.tb is not None:
                self.tb.add_image(name, np.transpose(arr, (2, 0, 1)), step)
            if arr.shape[-1] == 1:
                arr = np.repeat(arr, 3, axis=-1)
            fname = f"step{step:08d}_{name.replace('/', '_')}.png"
            write_png(os.path.join(img_dir, fname), (arr * 255).astype(np.uint8))

    def close(self):
        if self.jsonl is not None:
            self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


class ThroughputLogger:
    """Console examples/s + ETA (reference log_time, trainer.py:581-591)."""

    def __init__(self, batch_size: int, num_total_steps: int):
        self.batch_size = batch_size
        self.num_total_steps = num_total_steps
        self.start_time = time.time()

    def log(self, epoch: int, batch_idx: int, step: int, duration: float,
            loss: float):
        samples_per_sec = self.batch_size / max(duration, 1e-9)
        elapsed = time.time() - self.start_time
        left = (
            (self.num_total_steps / step - 1.0) * elapsed if step > 0 else 0
        )
        print(
            f"epoch {epoch:>3} | batch {batch_idx:>6} | "
            f"examples/s: {samples_per_sec:5.1f} | loss: {loss:.5f} | "
            f"elapsed: {sec_to_hm_str(elapsed)} | left: {sec_to_hm_str(left)}",
            flush=True,
        )


def dump_options(opt, log_path: str):
    """Persist run config (reference save_opts, trainer.py:627-636)."""
    models_dir = os.path.join(log_path, "models")
    os.makedirs(models_dir, exist_ok=True)
    with open(os.path.join(models_dir, "opt.json"), "w") as f:
        f.write(opt.to_json())
