"""The port's Trainer (``sfmnext_tpu_torch/training/trainer.py``) on the
CPU, torch only: ResNet-18 at 64x96, batch 2, float32, ``--weights_init
scratch``, ``--accumulation_steps 2``, lists of synthetic batches
(``data/synthetic.py``) as loaders, 3 steps an epoch.

  * end to end: train and val metrics (with ``de/abs_rel``) in the jsonl
    streams, ``opt.json``, PNG panels that PIL decodes, and ``weights_0`` /
    ``weights_1`` folders that ``load_reference_folder`` reads;
  * the loop adds no numerics: its parameters after 6 steps equal 6 calls
    of ``make_train_step`` on the same batches and per-step seeds;
  * a run with ``--accumulation_steps 2`` stopped by SIGTERM after step
    3, in the middle of an accumulation cycle, and resumed with
    ``--load_weights_folder latest`` ends with the unbroken run's
    parameters, BatchNorm statistics and Adam state, bit for bit (the stop
    comes at an epoch's end: a stop inside an epoch replays that epoch from
    its start, as the JAX trainer does);
  * ``--models_to_load`` restores only the modules named; the warm start
    (``--load_pretrained_model``, ``--pretrained_pose``, ``--load_adam``)
    takes a saved folder's modules and optimizer;
  * ``--weights_init pretrained`` without the weights file raises with its
    path; with a torchvision ``resnet18.pth`` written for the test, the
    encoder and RectifyNet's 2-image trunk take it (the stem tiled and
    divided by 2);
  * ``PrefetchLoader``: order, ``drop_last``, ``infinite``.
"""

import json
import os
import re
import signal

import numpy as np
import pytest
import torch
from PIL import Image

from sfmnext_tpu_torch.config import parse_options
from sfmnext_tpu_torch.data.loader import PrefetchLoader
from sfmnext_tpu_torch.data.synthetic import SyntheticDriveDataset
from sfmnext_tpu_torch.models.resnet import ResNet
from sfmnext_tpu_torch.training.builder import build_models
from sfmnext_tpu_torch.training.step import make_optimizer, make_train_step
from sfmnext_tpu_torch.training.trainer import Trainer, seed_step
from sfmnext_tpu_torch.utils.jax_weights import load_reference_folder
from test_torch_models import _one_thread  # noqa: F401

ARGS = ["--num_layers", "18", "--num_features", "64", "--model_dim", "16",
        "--patch_size", "4", "--query_nums", "16", "--dim_out", "16",
        "--height", "64", "--width", "96", "--batch_size", "2",
        "--compute_dtype", "float32", "--weights_init", "scratch", "--no_cuda",
        "--steps_per_epoch", "3", "--num_epochs", "2", "--log_frequency", "2",
        "--scheduler_step_size", "1"]
STEPS = 6


@pytest.fixture(scope="module")
def batches():
    ds = SyntheticDriveDataset(64, 96, seed=0)
    return [ds.batch(2) for _ in range(4)]


def _opt(log_dir, *flags):
    return parse_options(ARGS + ["--log_dir", str(log_dir), *flags])


class _Stopping:
    """The batches, sending SIGTERM to this process as the first epoch's
    iteration reaches ``stop_at``."""

    def __init__(self, batches, stop_at):
        self.batches, self.stop_at, self.sent = batches, stop_at, False

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for i, b in enumerate(self.batches):
            if i == self.stop_at and not self.sent:
                self.sent = True
                os.kill(os.getpid(), signal.SIGTERM)
            yield b


def _end_state(trainer):
    params = {f"{n}.{k}": v.clone() for n, m in trainer.models.modules().items()
              for k, v in m.state_dict().items()}
    adam = trainer.adam.state_dict()["state"]
    return params, adam


def _assert_same(a, b):
    (params_a, adam_a), (params_b, adam_b) = a, b
    assert sorted(params_a) == sorted(params_b)
    assert all(torch.equal(params_a[k], params_b[k]) for k in params_a)
    assert sorted(adam_a) == sorted(adam_b)
    for i in adam_a:
        assert sorted(adam_a[i]) == sorted(adam_b[i])
        assert all(torch.equal(adam_a[i][k], adam_b[i][k]) for k in adam_a[i])


@pytest.fixture(scope="module")
def unbroken(batches, tmp_path_factory):
    log_dir = tmp_path_factory.mktemp("unbroken")
    opt = _opt(log_dir, "--accumulation_steps", "2")
    trainer = Trainer(opt, batches, batches)
    trainer.train()
    return dict(trainer=trainer, opt=opt, log_dir=log_dir)


def test_run_writes_logs_panels_and_checkpoints(unbroken):
    trainer, opt = unbroken["trainer"], unbroken["opt"]
    run = os.path.join(opt.log_dir, opt.model_name)
    assert trainer.step == STEPS
    for mode, n in (("train", 4), ("val", 4)):  # batches 0 and 2 of each epoch log
        with open(os.path.join(run, mode, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        assert [r["step"] for r in recs] == [0, 2, 3, 5] and len(recs) == n
        assert all(np.isfinite(r["loss"]) and np.isfinite(r["de/abs_rel"]) for r in recs)
    with open(os.path.join(run, "models", "opt.json")) as f:
        assert json.load(f)["accumulation_steps"] == 2
    panels = os.listdir(os.path.join(run, "val", "images"))
    for name in ("color_0_0_0", "color_pred_-1_0_1", "disp_0_0", "automask_0_1"):
        path = os.path.join(run, "val", "images", f"step00000005_{name}.png")
        with Image.open(path) as img:
            assert img.size == (48, 32) and img.mode == "RGB"
            if name.startswith("color"):
                assert np.asarray(img).std() > 0
    # 4 val calls x 2 samples x (3 frames, 2 warped, disp, automask)
    assert len(panels) == 4 * 2 * 7
    models = build_models(opt, "cpu")
    for epoch in (0, 1):
        folder = os.path.join(run, "models", f"weights_{epoch}")
        assert sorted(os.listdir(folder)) == ["adam.pth", "depth.pth", "encoder.pth", "pose.pth"]
        load_reference_folder(folder, models)
    assert torch.equal(models.depth.conv3x3.weight, trainer.models.depth.conv3x3.weight)
    assert len(trainer.timings["save"]) == 3 and len(trainer.timings["val"]) == 4


def test_loop_equals_the_bare_train_step(unbroken, batches):
    opt = unbroken["opt"]
    models = build_models(opt, "cpu", train=True)
    adam, scheduler = make_optimizer(opt, models, steps_per_epoch=3)
    step = make_train_step(opt, models, adam, scheduler, augment=True)
    generator = torch.Generator()
    for i in range(STEPS):
        step({k: torch.from_numpy(v) for k, v in batches[i % 3].items()},
             seed_step(generator, opt.seed, i))
    for name, module in models.modules().items():
        got = getattr(unbroken["trainer"].models, name).state_dict()
        assert all(torch.equal(v, got[k]) for k, v in module.state_dict().items()), name


def test_interrupt_and_latest_resume_equal_the_unbroken_run(unbroken, batches, tmp_path):
    flags = ["--accumulation_steps", "2", "--load_weights_folder", "latest"]
    first = Trainer(_opt(tmp_path, *flags), _Stopping(batches, stop_at=3), batches)
    first.train()  # the first epoch's end reads the 4th batch: SIGTERM, then a checkpoint
    assert first._interrupted == signal.SIGTERM and first.step == 3
    folder = os.path.join(tmp_path, "mdp", "models", "weights_interrupt")
    state = torch.load(os.path.join(folder, "adam.pth"), weights_only=True)
    assert state["step"] == 3
    assert state["accumulation"]["micro_step"] == 1  # the second cycle half done
    assert all(g is not None for g in state["accumulation"]["mean"])

    resumed = Trainer(_opt(tmp_path, *flags), batches, batches)
    assert resumed.step == 3
    resumed.train()
    assert resumed.step == STEPS
    _assert_same(_end_state(resumed), _end_state(unbroken["trainer"]))


def test_models_to_load(unbroken, tmp_path):
    saved = os.path.join(unbroken["opt"].log_dir, "mdp", "models", "weights_1")
    trainer = Trainer(_opt(tmp_path, "--load_weights_folder", saved,
                           "--models_to_load", "encoder"), [], [])
    fresh = build_models(trainer.opt, "cpu", train=True)
    trained = unbroken["trainer"].models
    for name, want in (("encoder", trained), ("depth", fresh), ("pose", fresh)):
        got = getattr(trainer.models, name).state_dict()
        assert all(torch.equal(v, got[k]) for k, v in getattr(want, name).state_dict().items()), name
    assert trainer.step == STEPS and trainer.adam.state_dict()["state"]


def test_warm_start_pose_and_adam(unbroken, tmp_path):
    """``--load_pretrained_model`` with ``--load_pt_folder`` (encoder and
    depth), ``--pretrained_pose`` with ``--pose_net_path`` and
    ``--load_adam`` (the optimizer, not the step) from a saved folder."""
    saved = os.path.join(unbroken["opt"].log_dir, "mdp", "models", "weights_1")
    trainer = Trainer(_opt(tmp_path, "--load_pretrained_model", "--load_pt_folder", saved,
                           "--pretrained_pose", "--pose_net_path", saved, "--load_adam"), [], [])
    trained = unbroken["trainer"]
    for name in ("encoder", "depth", "pose"):
        got = getattr(trainer.models, name).state_dict()
        assert all(torch.equal(v, got[k])
                   for k, v in getattr(trained.models, name).state_dict().items()), name
    assert trainer.step == 0
    _assert_same(_end_state(trainer), _end_state(trained))


def test_no_loader_and_no_dataset_raise(tmp_path):
    """Without loaders the Trainer builds the ``--dataset``'s loaders
    (``tests/test_torch_data.py`` trains on files); a name the dataset
    switch does not know raises, as data parallel does."""
    with pytest.raises(ValueError, match="dataset 'nope'"):
        Trainer(_opt(tmp_path, "--dataset", "nope"))
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        Trainer(_opt(tmp_path, "--mesh_shape", "2"), [], [])


def test_pretrained_init_without_weights_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("SFMNEXT_WEIGHTS", str(tmp_path))
    opt = _opt(tmp_path, "--weights_init", "pretrained")
    with pytest.raises(FileNotFoundError, match=re.escape(str(tmp_path / "resnet18.pth"))):
        Trainer(opt, [], [])


def test_pretrained_init_takes_torchvision_resnet18(tmp_path, monkeypatch):
    """A torchvision-format file (``fc`` head, no ``num_batches_tracked``)
    into the depth encoder's trunk and RectifyNet's 2-image trunk."""
    g = torch.Generator().manual_seed(9)
    sd = {k: torch.randn(v.shape, generator=g) for k, v in ResNet(18).state_dict().items()
          if not k.endswith("num_batches_tracked")}
    sd["fc.weight"], sd["fc.bias"] = torch.randn(1000, 512), torch.randn(1000)
    torch.save(sd, tmp_path / "resnet18.pth")
    monkeypatch.setenv("SFMNEXT_WEIGHTS", str(tmp_path))
    trainer = Trainer(_opt(tmp_path, "--weights_init", "pretrained", "--use_rectify_net"), [], [])
    encoder = trainer.models.encoder.encoder.encoder.state_dict()
    rectify = trainer.models.rectify.encoder.encoder.state_dict()
    for k, v in sd.items():
        if k.startswith("fc."):
            continue
        assert torch.equal(encoder[k], v), k
        want = torch.cat([v, v], 1) / 2 if k == "conv1.weight" else v
        assert torch.equal(rectify[k], want), k


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.array([i])}


def test_prefetch_loader_order_drop_last_infinite():
    loader = PrefetchLoader(_Items(7), 2, shuffle=False, num_workers=1)
    assert len(loader) == 3
    assert [b["x"][:, 0].tolist() for b in loader] == [[0, 1], [2, 3], [4, 5]]
    keep = PrefetchLoader(_Items(7), 2, shuffle=False, num_workers=1, drop_last=False)
    assert len(keep) == 4
    assert [b["x"][:, 0].tolist() for b in keep] == [[0, 1], [2, 3], [4, 5], [6]]
    shuffled = PrefetchLoader(_Items(7), 2, shuffle=True, num_workers=3, seed=1)
    seen = sorted(i for b in shuffled for i in b["x"][:, 0])
    assert len(seen) == 6 and len(set(seen)) == 6
    endless = iter(PrefetchLoader(_Items(3), 2, shuffle=False, num_workers=1, infinite=True))
    assert [next(endless)["x"][:, 0].tolist() for _ in range(4)] == [[0, 1], [2, 0], [1, 2],
                                                                     [0, 1]]
