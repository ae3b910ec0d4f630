"""The port's Lite model, its pose networks and the predictive mask against
the JAX package's, on the CPU in float32.

A tiny ``resnet18_lite`` (ResNet-18 + DecoderBN(256), model_dim 16,
patch 4, 16 queries, 16 bins, 64x96, batch 2): weights drawn with numpy
in the JAX trees' shapes (``numpy_variables``) and carried to the port by
``from_jax_variables``; the batch is ``data/synthetic.py``'s; dropout and
the tie-break noise off. All the JAX numbers come from one jitted
function (one compile):

  * ``jax.value_and_grad(pipeline.forward)`` at ``--pose_model_type
    separate_resnet --predictive_mask --disable_automasking``: the loss
    and its terms to 1e-5 relative, every gradient (encoder, depth,
    pose_encoder, pose, predictive_mask) to 1e-3 of its norm, and the
    encoder's and pose encoder's BatchNorm running statistics (the pose
    encoder's after its two pair forwards, in order) to 1e-5;
  * forwards only: ``predict_poses`` of the PoseCNN and of the separate
    ResNet-18 over all frames, and of the shared PoseDecoder over pairs
    and over all frames (the depth encoder's features drawn with numpy),
    to 1e-6; the total loss of a ``shared`` forward (every temporal frame
    through the depth encoder as one batch) to 1e-5 relative; the
    predictive mask's maps at scales 0-3 to 1e-5.

Without JAX: a ``separate_resnet`` step's translations reach the
transform unscaled (only the PoseCNN's scale by the mean inverse depth);
the ImageNet init of ``resnet18_lite`` (ResNet-18 whatever
``--num_layers`` says) and of the pose encoder (its stem tiled over the
frames and divided by their count) from a torchvision file the test
writes equals the JAX init; the Trainer's checkpoint round trip of
``pose_encoder.pth``, ``pose.pth`` and ``predictive_mask.pth``, and
``--pretrained_pose`` with ``separate_resnet``; ``build_models``' three
raises on ``--predictive_mask``; the indoor step's raise where the JAX
indoor step fails; the ResNet variants' raise, naming their ROADMAP item.
"""

import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

from sfmnext_tpu.config import parse_options as jax_parse_options
from sfmnext_tpu.data.synthetic import make_batch
from sfmnext_tpu.models.predictive_mask import PredictiveMask as JaxPredictiveMask
from sfmnext_tpu.training import pipeline as jax_pipeline
from sfmnext_tpu.training.builder import build_models as jax_build_models, init_params
from sfmnext_tpu.utils import imagenet_init as jax_imagenet_init
from sfmnext_tpu_torch.config import parse_options
from sfmnext_tpu_torch.models import PredictiveMask
from sfmnext_tpu_torch.models.resnet import ResNet
from sfmnext_tpu_torch.ops import geometry
from sfmnext_tpu_torch.training import pipeline
from sfmnext_tpu_torch.training.builder import build_models
from sfmnext_tpu_torch.training.indoor import forward_indoor
from sfmnext_tpu_torch.training.trainer import Trainer
from sfmnext_tpu_torch.utils import imagenet_init, torch_export
from sfmnext_tpu_torch.utils.jax_weights import from_jax_variables
from test_torch_models import _one_thread, numpy_variables  # noqa: F401

H, W = 64, 96
ARGS = ["--backbone", "resnet18_lite", "--model_dim", "16", "--patch_size", "4",
        "--query_nums", "16", "--dim_out", "16", "--height", str(H), "--width", str(W),
        "--batch_size", "2", "--compute_dtype", "float32"]
MASK_ARGS = ARGS + ["--pose_model_type", "separate_resnet", "--predictive_mask",
                    "--disable_automasking"]
POSE_ROUTES = {
    "posecnn-all": ["--pose_model_input", "all"],
    "separate_resnet-all": ["--pose_model_type", "separate_resnet", "--pose_model_input", "all"],
    "shared-pairs": ["--pose_model_type", "shared"],
    "shared-all": ["--pose_model_type", "shared", "--pose_model_input", "all"],
}
MASK_SCALES = (0, 1, 2, 3)
EXPORTS = {
    "encoder": lambda p, s: torch_export.export_resnet_encoder_decoder(p, s["encoder"]),
    "depth": lambda p, s: torch_export.export_sql_decoder(p),
    "pose_encoder": lambda p, s: torch_export.export_pose_encoder(p, s["pose_encoder"]),
    "pose": lambda p, s: torch_export.export_pose_decoder(p),
    "predictive_mask": lambda p, s: torch_export.export_predictive_mask(p),
}


def _jax_models(args):
    jax_opt = jax_parse_options(args)
    models = jax_build_models(jax_opt, train=True)
    return jax_opt, dataclasses.replace(models, depth=models.depth.clone(deterministic=True))


def _batch():
    batch = make_batch(2, H, W, seed=3)
    batch.pop("depth_gt")
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _route_variables(mask_vars, jax_opt, jax_models, seed):
    """The mask route's encoder and depth decoder with the route's own pose
    networks, drawn with numpy."""
    pose = numpy_variables(lambda key: init_params(jax_opt, jax_models, key), seed)
    params = {k: mask_vars["params"][k] for k in ("encoder", "depth")}
    stats = {k: mask_vars["batch_stats"][k] for k in ("encoder", "depth")}
    for name in ("pose_encoder", "pose"):
        if name in pose["params"]:
            params[name], stats[name] = pose["params"][name], pose["batch_stats"][name]
    return {"params": params, "batch_stats": stats}


def _port_models(variables, opt):
    models = build_models(opt, "cpu", train=True)
    for name, sd in from_jax_variables(variables).items():
        getattr(models, name).load_state_dict(sd, strict=True)
    for m in models.depth.modules():  # dropout off, BatchNorm still on batch stats
        if isinstance(m, (torch.nn.Dropout, torch.nn.MultiheadAttention)):
            m.eval()
    return models


@pytest.fixture(scope="module")
def jax_run():
    """Every JAX number of the module from one jitted function."""
    jax_opt, jax_models = _jax_models(MASK_ARGS)
    variables = numpy_variables(lambda key: init_params(jax_opt, jax_models, key), 7)
    batch = _batch()
    routes = {}
    for i, (route, flags) in enumerate(POSE_ROUTES.items()):
        r_opt, r_models = _jax_models(ARGS + flags)
        routes[route] = (r_opt, r_models,
                         _route_variables(variables, r_opt, r_models, 11 + i))
    rng = np.random.RandomState(5)
    # the depth encoder's features of each temporal frame, NHWC
    shared_feats = {f: rng.rand(2, H // 2, W // 2, 16).astype(np.float32) for f in (0, -1, 1)}
    chans = (64, 64, 128, 256, 512)
    pyramid = [rng.rand(2, H // s, W // s, c).astype(np.float32)
               for s, c in zip((2, 4, 8, 16, 32), chans)]
    jax_mask = JaxPredictiveMask(num_output_channels=2, scales=MASK_SCALES)
    mask_vars = numpy_variables(lambda key: jax_mask.init(key, pyramid), 13)
    route_vars = {k: v[2] for k, v in routes.items()}

    def run(variables, route_vars, batch, shared_feats, pyramid, mask_vars):
        def loss_fn(params):
            return jax_pipeline.forward(jax_models, params, variables["batch_stats"], batch,
                                        None, jax_opt)

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
        poses = {}
        for route, (r_opt, r_models, _) in routes.items():
            v = route_vars[route]
            poses[route] = jax_pipeline.predict_poses(
                r_models, v["params"], batch, r_opt.all_frame_ids, dict(v["batch_stats"]),
                opt=r_opt, shared_feats=shared_feats)
        r_opt, r_models, _ = routes["shared-pairs"]
        v = route_vars["shared-pairs"]
        shared_loss, _ = jax_pipeline.forward(r_models, v["params"], v["batch_stats"], batch,
                                              None, r_opt)
        masks = jax_mask.apply(mask_vars, pyramid)
        return dict(metrics=aux["metrics"], grads=grads, batch_stats=aux["batch_stats"],
                    mask=aux["outputs"]["predictive_mask"],
                    poses={r: {f: (a, t) for f, (a, t, _) in p.items()}
                           for r, p in poses.items()},
                    shared_loss=shared_loss, masks=[masks[("disp", s)] for s in MASK_SCALES])

    out = jax.jit(run)(variables, route_vars, batch, shared_feats, pyramid, mask_vars)
    out = jax.tree_util.tree_map(np.asarray, out)

    opt = parse_options(MASK_ARGS)
    models = _port_models(variables, opt)
    total, port_aux = pipeline.forward(models, _torch_batch(batch), opt)
    total.backward()
    return dict(out, variables=variables, routes=routes, batch=batch,
                shared_feats=shared_feats, pyramid=pyramid, mask_vars=mask_vars,
                models=models, port_aux=port_aux)


@pytest.mark.parametrize("key", ["loss", "loss/reprojection", "loss/smooth"])
def test_mask_step_loss_matches_jax(jax_run, key):
    got = jax_run["port_aux"]["metrics"][key].item()
    np.testing.assert_allclose(got, float(jax_run["metrics"][key]), rtol=1e-5)


def test_mask_matches_jax(jax_run):
    got = jax_run["port_aux"]["outputs"]["predictive_mask"].detach().numpy()
    assert got.shape == jax_run["mask"].shape == (2, H, W, 2)
    np.testing.assert_allclose(got, jax_run["mask"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(EXPORTS))
def test_mask_step_gradients_match_jax(jax_run, name):
    stats = jax_run["variables"]["batch_stats"]
    expect = {k: np.asarray(v) for k, v in EXPORTS[name](jax_run["grads"][name], stats).items()
              if ".running_" not in k}
    got = {k: p.grad for k, p in getattr(jax_run["models"], name).named_parameters()}
    assert sorted(got) == sorted(expect)
    for k, g in got.items():
        e = expect[k]
        err = np.linalg.norm(g.numpy() - e)
        # + 1e-9: a convolution bias ahead of a BatchNorm has a gradient that
        # is zero but for rounding
        assert err <= 1e-3 * np.linalg.norm(e) + 1e-9, (k, err, np.linalg.norm(e))


@pytest.mark.parametrize("name", ["encoder", "pose_encoder"])
def test_mask_step_batchnorm_statistics_match_jax(jax_run, name):
    new_stats = jax_run["batch_stats"]
    expect = EXPORTS[name](jax_run["variables"]["params"][name], new_stats)
    got = getattr(jax_run["models"], name).state_dict()
    keys = [k for k in expect if ".running_" in k]
    assert len(keys) == 2 * (28 if name == "encoder" else 20)
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), expect[k], rtol=1e-5, atol=1e-6, err_msg=k)
    if name == "pose_encoder":  # two pair forwards: momentum 0.1 twice from the drawn stats
        old = EXPORTS[name](jax_run["variables"]["params"][name],
                            jax_run["variables"]["batch_stats"])
        k = "encoder.bn1.running_mean"
        assert not np.allclose(old[k], expect[k], rtol=1e-3)


@pytest.mark.parametrize("route", list(POSE_ROUTES))
def test_predict_poses_match_jax(jax_run, route):
    r_opt, _, variables = jax_run["routes"][route]
    opt = parse_options(ARGS + POSE_ROUTES[route])
    models = _port_models(variables, opt)
    feats = {f: torch.from_numpy(v).permute(0, 3, 1, 2)
             for f, v in jax_run["shared_feats"].items()}
    with torch.no_grad():
        got = pipeline.predict_poses(models, _torch_batch(jax_run["batch"]), opt.all_frame_ids,
                                     opt, shared_feats=feats)
    expect = jax_run["poses"][route]
    assert sorted(got) == sorted(expect) == [-1, 1]
    for f, (a, t, inv) in got.items():
        np.testing.assert_allclose(a.numpy(), expect[f][0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(t.numpy(), expect[f][1], rtol=0, atol=1e-6)
        # pairs invert the past frame; all frames invert none (the reference
        # quirk, JAX pipeline.py:171-173)
        assert inv == (f < 0 and route.endswith("pairs"))


def test_shared_forward_loss_matches_jax(jax_run):
    """Every temporal frame through the depth encoder as one batch of 3B;
    the depth decoder on the target's part; PoseDecoder over the pairs."""
    _, _, variables = jax_run["routes"]["shared-pairs"]
    opt = parse_options(ARGS + POSE_ROUTES["shared-pairs"])
    models = _port_models(variables, opt)
    with torch.no_grad():
        total, _ = pipeline.forward(models, _torch_batch(jax_run["batch"]), opt)
    np.testing.assert_allclose(total.item(), float(jax_run["shared_loss"]), rtol=1e-5)


def test_mask_maps_at_every_scale_match_jax(jax_run):
    mask = PredictiveMask((64, 64, 128, 256, 512), 2, MASK_SCALES)
    mask.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                          torch_export.export_predictive_mask(
                              jax_run["mask_vars"]["params"]).items()}, strict=True)
    with torch.no_grad():
        out = mask([torch.from_numpy(x).permute(0, 3, 1, 2) for x in jax_run["pyramid"]])
    for s, expect in zip(MASK_SCALES, jax_run["masks"]):
        got = out[("disp", s)].permute(0, 2, 3, 1).numpy()
        assert got.shape == expect.shape == (2, H >> s, W >> s, 2)
        np.testing.assert_allclose(got, expect, rtol=0, atol=1e-5, err_msg=str(s))


@pytest.mark.parametrize("pose_type", ["separate_resnet", "posecnn"])
def test_only_posecnn_translations_scale(pose_type, monkeypatch):
    """The mean-inverse-depth scaling applies to the PoseCNN alone (JAX
    pipeline.py:310): a separate_resnet step's translations reach the
    transform as predict_poses gives them."""
    opt = parse_options(ARGS + ["--pose_model_type", pose_type])
    models = build_models(opt, "cpu", train=True)
    batch = _torch_batch(_batch())
    seen = []
    make_transform = geometry.transformation_from_parameters

    def recorded(axisangle, translation, invert=False):
        seen.append(translation)
        return make_transform(axisangle, translation, invert=invert)

    monkeypatch.setattr(geometry, "transformation_from_parameters", recorded)
    with torch.no_grad():
        pipeline.forward(models, batch, opt)
        poses = pipeline.predict_poses(models, batch, opt.all_frame_ids, opt)
    for got, (_, translation, _) in zip(seen, poses.values(), strict=True):
        assert torch.equal(got, translation) == (pose_type == "separate_resnet")


def test_imagenet_init_matches_jax(jax_run, tmp_path, monkeypatch):
    """``resnet18_lite`` at ``--num_layers 50`` takes resnet18.pth (no
    resnet50.pth is written), and so does the 2-image pose encoder, its
    stem tiled and halved: both packages' inits agree."""
    g = torch.Generator().manual_seed(9)
    sd = {k: torch.randn(v.shape, generator=g) for k, v in ResNet(18).state_dict().items()
          if not k.endswith("num_batches_tracked")}
    sd["fc.weight"], sd["fc.bias"] = torch.randn(1000, 512), torch.randn(1000)
    torch.save(sd, tmp_path / "resnet18.pth")
    monkeypatch.setenv("SFMNEXT_WEIGHTS", str(tmp_path))
    args = MASK_ARGS + ["--weights_init", "pretrained", "--num_layers", "50"]
    jax_opt, jax_models = _jax_models(args)
    expect = jax_imagenet_init.apply_weights_init(jax_opt, jax_models, jax_run["variables"])
    models = _port_models(jax_run["variables"], parse_options(args))
    imagenet_init.apply_weights_init(parse_options(args), models)
    for name in ("encoder", "pose_encoder"):
        want = EXPORTS[name](expect["params"][name], expect["batch_stats"])
        got = getattr(models, name).state_dict()
        differ = [k for k, v in want.items() if not np.array_equal(got[k].numpy(), v)]
        assert not differ, (name, differ)
    stem = models.pose_encoder.encoder.conv1.weight
    assert torch.equal(stem, torch.cat([sd["conv1.weight"]] * 2, 1) / 2)


def _trainer(tmp_path, *flags):
    opt = parse_options(MASK_ARGS + ["--weights_init", "scratch", "--no_cuda", "--log_dir",
                                     str(tmp_path), "--steps_per_epoch", "1", "--num_epochs",
                                     "1", *flags])
    return Trainer(opt, [make_batch(2, H, W, seed=3)], None)


def test_trainer_checkpoints_pose_encoder_and_mask(tmp_path, monkeypatch):
    """A trained step's ``pose_encoder.pth``, ``pose.pth`` and
    ``predictive_mask.pth`` load back through ``--models_to_load`` and
    ``--pretrained_pose`` (pose and pose encoder from ``--pose_net_path``)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    trainer = _trainer(tmp_path / "run")
    fresh = {n: {k: v.clone() for k, v in m.state_dict().items()}
             for n, m in trainer.models.modules().items()}
    trainer.train()
    folder = tmp_path / "run" / trainer.opt.model_name / "models" / "weights_0"
    for name in ("pose_encoder", "pose", "predictive_mask"):
        assert (folder / f"{name}.pth").exists(), name
        moved = trainer.models.modules()[name].state_dict()
        assert any(not torch.equal(v, fresh[name][k]) for k, v in moved.items()), name

    def same(a, b):
        return all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())

    loaded = _trainer(tmp_path / "load", "--load_weights_folder", str(folder),
                      "--models_to_load", "encoder", "depth", "pose_encoder", "pose",
                      "predictive_mask")
    assert all(same(m, loaded.models.modules()[n]) for n, m in trainer.models.modules().items())
    warm = _trainer(tmp_path / "warm", "--pretrained_pose", "--pose_net_path", str(folder))
    for name, module in warm.models.modules().items():
        assert same(module, trainer.models.modules()[name]) == (name in ("pose_encoder",
                                                                         "pose")), name


@pytest.mark.parametrize("flags, words", [
    (["--predictive_mask"], "please disable automasking"),
    (["--predictive_mask", "--disable_automasking", "--backbone", "eff_b5"],
     "needs a ResNet pyramid backbone"),
    (["--predictive_mask", "--disable_automasking", "--pose_model_type", "shared"],
     "predictive_mask \\+ shared pose unsupported"),
], ids=["automasking", "backbone", "shared"])
def test_predictive_mask_conditions_raise(flags, words):
    with pytest.raises(ValueError, match=words):
        build_models(parse_options(ARGS + flags), "cpu", train=True)


def test_resnet_variants_raise_naming_their_item():
    """The JAX ResNetEncoder's options are ported on the trunk
    (tests/test_torch_resnet_zoo.py); an option it does not have raises."""
    with pytest.raises(TypeError, match="bogus"):
        ResNet(50, bogus=True)


@pytest.mark.parametrize("flags", [["--pose_model_type", "separate_resnet"],
                                   ["--pose_model_type", "shared"],
                                   ["--pose_model_input", "all"]], ids=" ".join)
def test_indoor_step_raises_where_the_jax_one_fails(flags):
    """The JAX indoor step calls predict_poses without opt or BatchNorm
    statistics and fails with these pose options; the port's says so."""
    opt = parse_options(ARGS + ["--dataset", "nyu_raw"] + flags)
    models = build_models(opt, "cpu", train=True)
    batch = _torch_batch(_batch())
    with pytest.raises(NotImplementedError, match="forward_indoor fails there too"):
        forward_indoor(models, batch, opt)
