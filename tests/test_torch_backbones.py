"""The port's EfficientNet-B5 and ConvNeXt-Unet encoders and stereo
training against the JAX package's, on the CPU in float32.

Weights are drawn with numpy in the JAX trees' shapes
(``numpy_variables``) and carried to the port by ``from_jax_variables``.
All the JAX numbers come from one jitted function (one compile):

  * ``Unet(convnext_atto)`` (decoder channels 64 48 32 24) forward at
    64x128, batch 2, to 1e-4 of the largest value;
  * the ``eff_b5`` ``BaseEncoderDecoder`` at B5's full widths
    (num_features 2048, model_dim 32): a train-mode forward at 64x128 to
    1e-4 of the largest value and its BatchNorm running statistics to
    1e-5; an eval-mode forward at 90x160, whose maps turn odd from 1/8
    down (TF "SAME" padding pads the odd pixel below and right), to 1e-4;
  * a ``--use_stereo`` training step of ``convnext_atto`` (frames 0 -1 1
    s, a 4th frame and ``stereo_T`` with baseline 0.1, no augmentation,
    dropout and tie-break noise off) against
    ``jax.value_and_grad(pipeline.forward)``: the loss and its terms to
    1e-5 relative and every gradient to 1e-3 of its norm, the limits of
    ``tests/test_torch_train_step.py``.

Without JAX: the ``encoder.pth`` keys and values of both encoders equal
the JAX package's ``export_convnext_unet`` / ``export_base_encoder_decoder``,
and a checkpoint loads back to the same forward; the ImageNet init of
both families from state dicts the test writes (timm's and
gen-efficientnet's names, with heads the trunks lack) equals the JAX
init carried across; the JAX package's initialisers from the seed's
generator; ``--frame_ids 0 --use_stereo`` builds no pose net
and takes a finite augmented step; an unported backbone raises naming
its ROADMAP item; the SQL
decoder's FFN width follows the JAX builder's rule.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmnext_tpu.config import parse_options as jax_parse_options
from sfmnext_tpu.data.synthetic import make_batch
from sfmnext_tpu.models.efficientnet import BaseEncoderDecoder as JaxB5
from sfmnext_tpu.models.unet import Unet as JaxUnet
from sfmnext_tpu.training import pipeline as jax_pipeline
from sfmnext_tpu.training.builder import build_models as jax_build_models, init_params
from sfmnext_tpu.utils import imagenet_init as jax_imagenet_init
from sfmnext_tpu.utils import torch_export as jax_export
from sfmnext_tpu_torch.config import parse_options
from sfmnext_tpu_torch.models import SQLDecoder
from sfmnext_tpu_torch.models.efficientnet import BaseEncoderDecoder, EfficientNet
from sfmnext_tpu_torch.models.unet import Unet
from sfmnext_tpu_torch.training import pipeline
from sfmnext_tpu_torch.training.builder import ModelBundle, build_models, sql_ffn_dim
from sfmnext_tpu_torch.training.step import make_optimizer, make_train_step
from sfmnext_tpu_torch.utils import checkpoint, imagenet_init, torch_export
from sfmnext_tpu_torch.utils.jax_weights import from_jax_variables
from test_torch_models import _one_thread, numpy_variables  # noqa: F401

DEC = (64, 48, 32, 24)
HW, HW_ODD = (64, 128), (90, 160)
ARGS = ["--backbone", "convnext_atto", "--dec_channels", *map(str, DEC), "--model_dim", "16",
        "--patch_size", "4", "--query_nums", "16", "--dim_out", "16", "--height", "64",
        "--width", "128", "--batch_size", "2", "--compute_dtype", "float32",
        "--use_stereo", "--frame_ids", "0", "-1", "1"]
EXPORTS = {
    "encoder": lambda tree, stats: torch_export.export_convnext_unet(tree, stats["encoder"]),
    "depth": lambda tree, stats: torch_export.export_sql_decoder(tree),
    "pose": lambda tree, stats: torch_export.export_pose_cnn(tree),
}
JAX_UNET = JaxUnet(backbone="convnext_atto", num_classes=16, decoder_channels=DEC)
JAX_B5 = JaxB5(num_features=2048, model_dim=32)


def _images(seed, hw):
    return np.random.RandomState(seed).rand(2, *hw, 3).astype(np.float32)


def _stereo_batch():
    batch = make_batch(2, *HW, frame_ids=(0, -1, 1, 2), seed=3)  # the 4th frame is "s"
    batch.pop("depth_gt")
    stereo_T = np.broadcast_to(np.eye(4, dtype=np.float32), (2, 4, 4)).copy()
    stereo_T[:, 0, 3] = 0.1
    batch["stereo_T"] = stereo_T
    return batch


def _torch(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _empty(cls, *args):
    """A module without an init of its own (the test loads every weight)."""
    with torch.device("meta"):
        module = cls(*args)
    return module.to_empty(device="cpu")


def _port(module, variables, export):
    module.load_state_dict(_torch(export(variables["params"], variables["batch_stats"])))
    return module


@pytest.fixture(scope="module")
def jax_run():
    """Every JAX number of the module from one jitted function."""
    jax_opt = jax_parse_options(ARGS)
    jax_models = jax_build_models(jax_opt, train=True)
    jax_models = dataclasses.replace(
        jax_models, depth=jax_models.depth.clone(deterministic=True))
    variables = numpy_variables(lambda key: init_params(jax_opt, jax_models, key), 7)
    b5_vars = numpy_variables(lambda key: JAX_B5.init(key, jnp.zeros((1, *HW, 3))), 1)
    batch = _stereo_batch()
    x, x_odd = _images(0, HW), _images(1, HW_ODD)

    # the bundle's encoder is Unet(convnext_atto, model_dim 16, DEC)
    unet_vars = {"params": variables["params"]["encoder"],
                 "batch_stats": variables["batch_stats"]["encoder"]}

    def run(params, unet_vars, b5_vars, batch, x, x_odd):
        def loss_fn(p):
            return jax_pipeline.forward(jax_models, p, variables["batch_stats"], batch, None,
                                        jax_opt)

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        b5, b5_stats = JAX_B5.clone(train=True).apply(b5_vars, x, mutable=["batch_stats"])
        return dict(unet=JAX_UNET.apply(unet_vars, x), b5=b5,
                    b5_odd=JAX_B5.apply(b5_vars, x_odd), b5_stats=b5_stats["batch_stats"],
                    metrics=aux["metrics"], grads=grads)

    out = jax.jit(run)(variables["params"], unet_vars, b5_vars, batch, x, x_odd)
    out = jax.tree_util.tree_map(np.asarray, out)
    return dict(out, jax_opt=jax_opt, jax_models=jax_models, variables=variables,
                unet_vars=unet_vars, b5_vars=b5_vars, batch=batch, x=x, x_odd=x_odd)


def _assert_same(got, expect):
    """Every tensor of ``expect`` (numpy) equal in ``got`` (torch), bit for bit."""
    differ = [k for k, v in expect.items() if not np.array_equal(got[k].numpy(), v)]
    assert not differ, differ


def _scaled(got, expect):
    return np.abs(got - expect).max() / np.abs(expect).max()


def test_unet_convnext_forward_matches_jax(jax_run):
    model = _port(_empty(Unet, "convnext_atto", 16, DEC), jax_run["unet_vars"],
                  torch_export.export_convnext_unet).eval()
    with torch.no_grad():
        got = model(_nchw(jax_run["x"])).permute(0, 2, 3, 1).numpy()
    assert got.shape == jax_run["unet"].shape == (2, 32, 64, 16)
    assert _scaled(got, jax_run["unet"]) <= 1e-4


def _b5(jax_run):
    return _port(_empty(BaseEncoderDecoder, 2048, 32), jax_run["b5_vars"],
                 torch_export.export_base_encoder_decoder)


def test_efficientnet_b5_train_forward_matches_jax(jax_run):
    """A train-mode forward (BatchNorm on the batch's statistics) at
    64x128: the features, and the running statistics it leaves."""
    model = _b5(jax_run).train()
    with torch.no_grad():
        got = model(_nchw(jax_run["x"])).permute(0, 2, 3, 1).numpy()
    assert got.shape == jax_run["b5"].shape == (2, 32, 64, 32)
    assert _scaled(got, jax_run["b5"]) <= 1e-4
    expect = torch_export.export_base_encoder_decoder(jax_run["b5_vars"]["params"],
                                                      jax_run["b5_stats"])
    got = model.state_dict()
    keys = [k for k in expect if ".running_" in k]
    # the stem's, 2 in each of stage 0's 3 blocks, 3 in each of the other
    # 36, and the decoder's 8
    assert len(keys) == 2 * (1 + 2 * 3 + 3 * 36 + 8)
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), expect[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # momentum 0.01 (flax 0.99), not the ResNet's 0.1: a trunk mean moved by a hundredth
    k = "encoder.original_model.bn1.running_mean"
    old = torch_export.export_base_encoder_decoder(
        jax_run["b5_vars"]["params"], jax_run["b5_vars"]["batch_stats"])[k]
    assert not np.allclose(old, expect[k], rtol=1e-3)


def test_efficientnet_b5_forward_at_odd_maps_matches_jax(jax_run):
    """90x160: the maps are 45x80, 23x40, 12x20, 6x10 and 3x5 from the stem
    down, so every stride-2 convolution from 1/4 down meets an odd size."""
    model = _b5(jax_run).eval()
    with torch.no_grad():
        got = model(_nchw(jax_run["x_odd"])).permute(0, 2, 3, 1).numpy()
    assert got.shape == jax_run["b5_odd"].shape == (2, 45, 80, 32)
    assert _scaled(got, jax_run["b5_odd"]) <= 1e-4


@pytest.fixture(scope="module")
def stereo_step(jax_run):
    opt = parse_options(ARGS)
    models = build_models(opt, "cpu", train=True)
    for name, sd in from_jax_variables(jax_run["variables"]).items():
        getattr(models, name).load_state_dict(sd, strict=True)
    for m in models.depth.modules():  # dropout off, BatchNorm still on batch statistics
        if isinstance(m, (torch.nn.Dropout, torch.nn.MultiheadAttention)):
            m.eval()
    batch = {k: torch.from_numpy(v) for k, v in jax_run["batch"].items()}
    total, aux = pipeline.forward(models, batch, opt)
    total.backward()
    return models, aux


@pytest.mark.parametrize("key", ["loss", "loss/reprojection", "loss/smooth"])
def test_stereo_loss_matches_jax(jax_run, stereo_step, key):
    got = stereo_step[1]["metrics"][key].item()
    np.testing.assert_allclose(got, float(jax_run["metrics"][key]), rtol=1e-5)


@pytest.mark.parametrize("name", ["encoder", "depth", "pose"])
def test_stereo_gradients_match_jax(jax_run, stereo_step, name):
    stats = jax_run["variables"]["batch_stats"]
    expect = {k: v for k, v in EXPORTS[name](jax_run["grads"][name], stats).items()
              if ".running_" not in k}
    got = {k: p.grad for k, p in getattr(stereo_step[0], name).named_parameters()}
    assert sorted(got) == sorted(expect)
    for k, g in got.items():
        e = np.asarray(expect[k])
        err = np.linalg.norm(g.numpy() - e)
        assert err <= 1e-3 * np.linalg.norm(e) + 1e-9, (k, err, np.linalg.norm(e))


def test_stereo_warp_uses_stereo_T(jax_run, stereo_step):
    """The stereo frame's warp is the batch's transform: a step with the
    baseline negated gives another loss."""
    opt = parse_options(ARGS)
    batch = {k: torch.from_numpy(v) for k, v in jax_run["batch"].items()}
    batch["stereo_T"] = batch["stereo_T"].clone()
    batch["stereo_T"][:, 0, 3] *= -1
    with torch.no_grad():
        total, aux = pipeline.forward(stereo_step[0], batch, opt)
    assert "warped_s" in aux["outputs"]
    assert abs(total.item() - stereo_step[1]["metrics"]["loss"].item()) > 1e-6


@pytest.mark.parametrize("family", ["convnext", "eff_b5"])
def test_encoder_checkpoint_matches_jax_export(jax_run, family, tmp_path):
    """The port's ``encoder.pth`` holds the JAX export's keys and values,
    and a bundle built afresh reads it back to the same forward."""
    if family == "convnext":
        opt = parse_options(ARGS)
        variables = jax_run["variables"]
        params, stats = variables["params"]["encoder"], variables["batch_stats"]["encoder"]
        expect = jax_export.export_convnext_unet(params, stats, "convnext_atto")
    else:
        opt = parse_options(["--backbone", "eff_b5", "--num_features", "2048", "--model_dim",
                             "32", "--patch_size", "4", "--query_nums", "16", "--dim_out", "16",
                             "--height", "64", "--width", "128", "--compute_dtype", "float32"])
        params, stats = jax_run["b5_vars"]["params"], jax_run["b5_vars"]["batch_stats"]
        expect = jax_export.export_base_encoder_decoder(params, stats)
    encoder_args = ("convnext_atto", 16, DEC) if family == "convnext" else (2048, 32)
    depth_args = (opt.model_dim, opt.patch_size, 4, opt.query_nums, opt.dim_out)
    if family == "convnext":
        models = build_models(opt, "cpu", train=True)
    else:  # build_models' eff_b5 init takes seconds on a CPU; the weights are loaded anyway
        models = ModelBundle(_empty(BaseEncoderDecoder, *encoder_args),
                             _empty(SQLDecoder, *depth_args))
        models.depth.init_weights(torch.Generator().manual_seed(0))
    models.encoder.load_state_dict(_torch(torch_export.export_encoder(params, stats)))
    adam, scheduler = make_optimizer(opt, models, 10)
    checkpoint.save_checkpoint(str(tmp_path / "w"), models, opt, adam, scheduler, None, 0)
    saved = torch.load(tmp_path / "w" / "encoder.pth", weights_only=True)
    tensors = {k: v for k, v in saved.items()
               if k not in checkpoint.NON_TENSOR_KEYS and not k.endswith("num_batches_tracked")}
    assert sorted(tensors) == sorted(expect)
    _assert_same(tensors, expect)

    fresh = ModelBundle(_empty(type(models.encoder), *encoder_args),
                        _empty(type(models.depth), *depth_args))
    checkpoint.load_encoder_depth(str(tmp_path / "w"), fresh)
    x = _nchw(jax_run["x"])
    with torch.no_grad():
        got, expect = fresh.encoder.eval()(x), models.encoder.eval()(x)
    np.testing.assert_array_equal(got.numpy(), expect.numpy())


def _write(path, shapes, rng, rename=lambda k: k):
    torch.save({rename(k): torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                for k, s in shapes.items()}, path)


@pytest.mark.parametrize("family", ["convnext", "eff_b5"])
def test_imagenet_init_matches_jax(jax_run, family, tmp_path, monkeypatch):
    """A timm convnext file (``conv_dw``, ``mlp.fc1``, a head) and a
    gen-efficientnet file (its ``bn2`` and classifier, no
    ``num_batches_tracked``), each loaded by both packages."""
    monkeypatch.setenv("SFMNEXT_WEIGHTS", str(tmp_path))
    rng = np.random.default_rng(5)
    args = ARGS + ["--weights_init", "pretrained"] if family == "convnext" else [
        "--backbone", "eff_b5", "--weights_init", "pretrained"]
    opt, jax_opt = parse_options(args), jax_parse_options(args)
    if family == "convnext":
        variables, jax_models = jax_run["variables"], jax_run["jax_models"]
        models = build_models(opt, "cpu", train=True)
        trunk = models.encoder.encoder
        shapes = {k: tuple(v.shape) for k, v in trunk.state_dict().items()}
        shapes.update({"head.norm.weight": (320,), "head.fc.weight": (1000, 320)})
        _write(tmp_path / "convnext_atto.pth", shapes, rng, lambda k: k.replace(
            ".dwconv.", ".conv_dw.").replace(".pwconv1.", ".mlp.fc1.").replace(
            ".pwconv2.", ".mlp.fc2."))
    else:
        b5 = jax_run["b5_vars"]
        variables = {"params": {"encoder": b5["params"]},
                     "batch_stats": {"encoder": b5["batch_stats"]}}
        jax_models = types.SimpleNamespace(pose_encoder=None, rectify=None)
        models = types.SimpleNamespace(encoder=_empty(BaseEncoderDecoder, 2048, 32),
                                         rectify=None)
        trunk = models.encoder.encoder.original_model
        shapes = {k: tuple(v.shape) for k, v in trunk.state_dict().items()
                  if not k.endswith("num_batches_tracked")}
        shapes.update({"bn2.weight": (2048,), "bn2.running_var": (2048,),
                       "classifier.weight": (1000, 2048)})
        _write(tmp_path / "tf_efficientnet_b5_ap.pth", shapes, rng)
    before = torch_export.export_encoder(variables["params"]["encoder"],
                                         variables["batch_stats"]["encoder"])
    models.encoder.load_state_dict(_torch(before))
    expect = jax_imagenet_init.apply_weights_init(jax_opt, jax_models, variables)
    expect = torch_export.export_encoder(expect["params"]["encoder"],
                                         expect["batch_stats"]["encoder"])
    imagenet_init.apply_weights_init(opt, models)
    _assert_same(models.encoder.state_dict(), expect)
    # the trunk took the file's values, the decoder kept its own
    changed = {k.split(".")[0] for k in expect if not np.array_equal(expect[k], before[k])}
    assert changed == {"encoder"}


def test_imagenet_init_raises_without_the_file(tmp_path, monkeypatch):
    monkeypatch.setenv("SFMNEXT_WEIGHTS", str(tmp_path))
    opt = parse_options(ARGS + ["--weights_init", "pretrained"])
    with pytest.raises(FileNotFoundError, match="convnext_atto.pth"):
        imagenet_init.apply_weights_init(opt, build_models(opt, "cpu", train=True))


def test_stereo_without_temporal_frames_has_no_pose_net():
    """``--frame_ids 0 --use_stereo``: no pose net; the augmented step
    (flip and jitter of the two frames, the flipped baseline) is finite."""
    opt = parse_options(ARGS[:-3] + ["0"])
    assert opt.all_frame_ids == [0, "s"] and not opt.use_pose_net
    models = build_models(opt, "cpu", train=True)
    assert models.pose is None and sorted(models.modules()) == ["depth", "encoder"]
    step = make_train_step(opt, models, *make_optimizer(opt, models, 10), augment=True)
    batch = {k: torch.from_numpy(v) for k, v in _stereo_batch().items()}
    batch = {k: v[:, [0, 3]] if k in ("color", "color_aug") else v for k, v in batch.items()}
    metrics = step(batch, torch.Generator().manual_seed(0))
    assert np.isfinite(metrics["loss"].item())


def _std_ok(w, scale, fan):
    """A truncated normal of variance scale / fan: its spread within 5% and
    nothing past the two deviations of the untruncated normal it cuts."""
    std = np.sqrt(scale / fan)
    w = w.detach().numpy()
    return abs(w.std() / std - 1) < 0.05 and np.abs(w).max() <= 2 * std / 0.87962566103423978


def test_init_follows_the_jax_initialisers():
    """The JAX package's init, drawn from the seed's generator: ConvNeXt's
    kernels lecun_normal with zero biases and the layer scale at 1e-6, the
    Unet decoder's and EfficientNet's bias-free convs kaiming_normal_fanout,
    the squeeze-excite lecun_normal; the same seed gives the same weights."""
    opt = parse_options(ARGS)
    unet = build_models(opt, "cpu").encoder
    again = build_models(opt, "cpu").encoder
    assert all(torch.equal(a, b) for a, b in zip(unet.state_dict().values(),
                                                 again.state_dict().values()))
    block = unet.encoder.stages[2].blocks[0]
    assert torch.all(block.gamma == 1e-6) and torch.all(block.pwconv1.bias == 0)
    assert _std_ok(block.pwconv1.weight, 1.0, 160) and _std_ok(block.dwconv.weight, 1.0, 49)
    conv = unet.decoder.blocks[0].conv1.conv.weight  # 64 outputs, 3x3
    assert _std_ok(conv, 2.0, 64 * 9) and torch.all(unet.decoder.final_conv.bias == 0)

    trunk = _empty(EfficientNet, "efficientnet_b0")
    trunk.init_weights(torch.Generator().manual_seed(0))
    mb = trunk.blocks[5][0]  # 112 -> 672 -> 192, kernel 5
    assert _std_ok(mb.conv_pw.weight, 2.0, 672) and _std_ok(mb.conv_dw.weight, 2.0, 672 * 25)
    assert _std_ok(mb.conv_pwl.weight, 2.0, 192)
    assert _std_ok(mb.se.conv_expand.weight, 1.0, 28) and torch.all(mb.se.conv_expand.bias == 0)
    assert mb.bn2.momentum == 0.01 and mb.bn2.eps == 1e-3


@pytest.mark.parametrize("backbone", ["resnet33ts", "gluon_xception65", "densenet121",
                                      "efficientnet_b3", "regnety_040"])
def test_unported_backbone_raises(backbone):
    """The Unet zoo but the ConvNeXt and ResNet families raises naming its
    ROADMAP item: a bring-your-own-blocks ResNet (``resnet33ts``) and
    ``gluon_xception65``, which the JAX dispatch takes before the ResNet
    family their prefixes would reach, among it."""
    opt = parse_options(["--backbone", backbone])
    with pytest.raises(NotImplementedError,
                       match=f"Unet backbone '{backbone}'.*ROADMAP.md queue 1 item 12"):
        build_models(opt, "cpu")


@pytest.mark.parametrize("backbone", ["resnet", "resnet_lite", "resnet18_lite", "eff_b5",
                                      "convnext_large", "convnext_atto"])
def test_sql_ffn_width_follows_the_jax_rule(backbone):
    """The rule against the JAX builder's decoder for every backbone, and
    in a built bundle (``convnext_atto``, the test's small one)."""
    jax_models = jax_build_models(jax_parse_options(["--backbone", backbone]), train=False)
    assert sql_ffn_dim(backbone) == jax_models.depth.ffn_dim
    if backbone == "convnext_atto":
        layer = build_models(parse_options(ARGS), "cpu").depth.transformer_encoder.layers[0]
        assert layer.linear1.out_features == sql_ffn_dim(backbone) == 1024
