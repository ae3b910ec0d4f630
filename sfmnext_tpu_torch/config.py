"""Configuration: typed dataclass + reference-compatible argfile CLI.

The port's own copy of ``sfmnext_tpu/config.py`` (the same fields, defaults
and parser), so that the port imports nothing of the JAX package. The
reference drives everything through ~80 argparse flags loaded from
argfiles (``python train.py args_files/....txt`` with
``fromfile_prefix_chars='@'`` and per-line token splitting, train.py:9-19,
options.py:15-345). We keep that public surface — the same argfiles parse
here — but internally everything reads one ``Options`` dataclass.
``tests/test_torch_slice.py`` holds the two copies to the same fields.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass
class Options:
    """Flat option namespace, field names matching the reference flags."""

    # paths
    data_path: str = "data/kitti"
    eval_data_path: str = "data/CS_RAW/"
    intrinsics_file_path: str = "splits/mc_dataset/KV_intrinsics.txt"
    log_dir: str = "runs"
    model_name: str = "mdp"

    # training
    split: str = "eigen_zhou"
    num_features: int = 512
    num_layers: int = 50
    dec_channels: Tuple[int, ...] = (1024, 512, 256, 128)
    backbone: str = "resnet"
    dataset: str = "kitti"
    png: bool = True
    dim_out: int = 128
    query_nums: int = 128
    patch_size: int = 20
    model_dim: int = 32
    height: int = 320
    width: int = 1024
    reg_wt: float = 0.01
    feat_wt: float = 0.01
    l1_weight: float = 0.15
    ssim_weight: float = 0.85
    use_mini_reprojection_loss: bool = False
    use_improved_mini_reproj_loss: bool = False
    use_photo_geo_loss: bool = False
    use_flow_pose: bool = False
    loss_geo_weight: float = 1.0
    loss_photo_weight: float = 1.0
    loss_rt_weight: float = 1.0
    loss_rc_weight: float = 1.0
    disparity_smoothness: float = 1e-3
    scales: Tuple[int, ...] = (0,)
    min_depth: float = 0.001
    max_depth: float = 80.0
    use_optical_flow: bool = False
    use_rectify_net: bool = False
    use_stereo: bool = False
    frame_ids: Tuple[int, ...] = (0, -1, 1)

    # optimization
    pretrained_flow: bool = False
    pretrained_rectify: bool = False
    load_adam: bool = False
    load_pretrained_model: bool = False
    load_pt_folder: Optional[str] = None
    pose_net_path: Optional[str] = None
    pretrained_pose: bool = False
    log_attn: bool = False
    multi_gpu: bool = False
    diff_lr: bool = False
    accumulation_steps: int = 1
    batch_size: int = 12
    learning_rate: float = 1e-4
    num_epochs: int = 20
    scheduler_step_size: int = 15

    # ablation
    v1_multiscale: bool = False
    avg_reprojection: bool = False
    disable_automasking: bool = False
    predictive_mask: bool = False
    no_ssim: bool = False
    weights_init: str = "pretrained"
    pose_model_input: str = "pairs"
    pose_model_type: str = "posecnn"

    # system
    no_cuda: bool = False
    num_workers: int = 8

    # loading
    pred_metric_depth: bool = False
    ext: str = "png"
    image_path: Optional[str] = None
    # checkpoint dir to resume from; the special value "latest" resumes
    # from this run's newest weights_* checkpoint if one exists (else
    # starts fresh) — the preemption-friendly form: one command line for
    # first launch and every relaunch
    load_weights_folder: Optional[str] = None
    models_to_load: Tuple[str, ...] = ("encoder", "depth", "pose_encoder", "pose")

    # logging
    log_frequency: int = 10
    save_frequency: int = 1
    save_step_frequency: int = 0  # checkpoint every N steps (indoor: 1000,
    # reference trainer_indoor.py:317-328); 0 = per-epoch only
    log_images: bool = True  # input/warped/disp/automask panels on log steps

    # evaluation
    eval_stereo: bool = False
    eval_mono: bool = False
    disable_median_scaling: bool = False
    pred_depth_scale_factor: float = 1.0
    ext_disp_to_eval: Optional[str] = None
    eval_split: str = "eigen"
    save_pred_disps: bool = False
    no_eval: bool = False
    eval_eigen_to_benchmark: bool = False
    eval_out_dir: Optional[str] = None
    post_process: bool = False

    # --- TPU-native additions (not in the reference) ---
    eval_batch_size: int = 1  # eval forward batch; 1 = reference protocol
    # (batch-1 loader, evaluate_depth_config.py:90); N>1 pads the last
    # batch and trims, metrics unchanged, ~Nx fewer dispatches
    compute_dtype: str = "bfloat16"  # model compute dtype on TPU
    loss_dtype: str = "auto"  # photometric-stack dtype: auto|float32|bfloat16
                              # (auto follows compute_dtype)
    seed: int = 0
    mesh_shape: Optional[int] = None  # data-parallel degree; None = all devices
    use_pallas: bool = True  # fused SQL kernels where profitable
    remat: bool = False  # rematerialize the encoder (memory for FLOPs)
    log_jsonl: bool = True  # metrics to <log_dir>/<model_name>/metrics.jsonl
    steps_per_epoch: Optional[int] = None  # override (synthetic/testing)

    # derived helpers -----------------------------------------------------
    @property
    def all_frame_ids(self) -> List:
        """frame_ids plus the stereo frame when enabled (trainer.py:52-53)."""
        ids: List = list(self.frame_ids)
        if self.use_stereo:
            ids.append("s")
        return ids

    @property
    def use_pose_net(self) -> bool:
        return not (self.use_stereo and tuple(self.frame_ids) == (0,))

    @property
    def num_pose_frames(self) -> int:
        """2 for pairs mode, all temporal frames for 'all' (trainer.py:46)."""
        return 2 if self.pose_model_input == "pairs" else len(self.frame_ids)

    @property
    def img_ext(self) -> str:
        return ".png" if self.png else ".jpg"

    def validate(self):
        assert self.frame_ids[0] == 0, "frame_ids must start with 0"
        if tuple(self.scales) != (0,):
            # the reference default is single-scale (options.py:149-153,
            # multi-scale commented out); its generic multi-scale loop
            # (trainer.py:386-439) is not implemented here — fail loudly
            # instead of silently training single-scale.
            raise ValueError(
                f"scales={tuple(self.scales)}: only the reference default "
                "(0,) is supported; the multi-scale loss loop is not "
                "implemented"
            )
        if self.weights_init not in ("pretrained", "scratch"):
            raise ValueError(
                f"weights_init must be 'pretrained' or 'scratch', "
                f"got {self.weights_init!r}"
            )
        h2, w2 = self.height // 2, self.width // 2
        n_tokens = (h2 // self.patch_size) * (w2 // self.patch_size)
        if n_tokens > 500:
            raise ValueError(
                f"{n_tokens} transformer tokens > positional table (500); "
                "reduce resolution or increase patch_size"
            )
        if n_tokens < self.query_nums:
            raise ValueError(
                f"query_nums ({self.query_nums}) exceeds token count ({n_tokens})"
            )
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def _build_parser() -> argparse.ArgumentParser:
    """argparse mirror of the dataclass, argfile-compatible."""

    class ArgfileParser(argparse.ArgumentParser):
        def convert_arg_line_to_args(self, line):
            # one or more tokens per line (reference train.py:9-13)
            return line.split()

    p = ArgfileParser(description="sfmnext_tpu options", fromfile_prefix_chars="@")
    for f in dataclasses.fields(Options):
        name = "--" + f.name
        default = f.default
        if f.type in ("bool", bool) or isinstance(default, bool):
            p.add_argument(name, action="store_true", default=default)
        elif isinstance(default, tuple):
            elem = int if (default and isinstance(default[0], int)) else str
            p.add_argument(name, nargs="+", type=elem, default=list(default))
        elif isinstance(default, float):
            p.add_argument(name, type=float, default=default)
        elif isinstance(default, int):
            p.add_argument(name, type=int, default=default)
        elif "int" in str(f.type):  # Optional[int] fields (default None)
            p.add_argument(name, type=int, default=default)
        elif "float" in str(f.type):
            p.add_argument(name, type=float, default=default)
        else:
            p.add_argument(name, type=str, default=default)
    return p


def parse_options(argv: Optional[Sequence[str]] = None) -> Options:
    """Parse CLI args / @argfiles into Options.

    Accepts the reference launch style: a bare positional path is treated
    as an argfile (``python train.py args_files/foo.txt``).
    """
    argv = list(argv) if argv is not None else None
    if argv:
        # bare positional argfiles: .txt and .config (the reference ships
        # both extensions, e.g. args_kitti_320x1024_evaluate.config)
        argv = [
            ("@" + a)
            if (not a.startswith("-") and a.endswith((".txt", ".config")))
            else a
            for a in argv
        ]
    ns, unknown = _build_parser().parse_known_args(argv)
    if unknown:
        # fail loudly like the reference's argparse: a typo'd flag must not
        # silently train with defaults. --ignore_unknown is the escape hatch.
        if "--ignore_unknown" in unknown:
            unknown = [u for u in unknown if u != "--ignore_unknown"]
            if unknown:
                print(f"[config] ignoring unknown flags: {unknown}")
        else:
            raise SystemExit(
                f"error: unrecognized arguments: {' '.join(map(str, unknown))} "
                "(pass --ignore_unknown to proceed anyway)"
            )
    kw = vars(ns)
    for key in ("dec_channels", "scales", "frame_ids", "models_to_load"):
        kw[key] = tuple(kw[key])
    # argparse store_true can't turn defaults off; accept "--png" semantics
    return Options(**kw)
