"""The port's ResNet-family Unet surface and ``--remat``, without JAX
numbers (``tests/test_torch_resnet_zoo.py`` holds the modules and a
``--remat`` step against the JAX package's).

  * ``--remat``: a step through the activation checkpoint equals the plain
    step on the same weights and batch (the loss to 1e-6 relative, every
    gradient to 1e-5 of its norm, the BatchNorm running statistics and
    counts equal, so they move once a step), and the encoder runs again in
    the backward (its recompute), on the plain and the shared-pose routes;
    the predictive-mask route is not checkpointed, as in JAX;
  * the zoo's coverage: 162 names build with the half-resolution output
    on the meta device (the 134 of the ResNet family and the 28
    ConvNeXts), the other 268 raise naming the ROADMAP item;
  * the ``encoder.pth`` keys and values that ``export_encoder`` makes of a
    JAX tree (its shapes from ``jax.eval_shape``) equal the port's
    ``state_dict`` for one name per family and option group, and a
    ResNet-variant Unet's checkpoint loads back to the same forward;
  * the ImageNet init of four families from timm-named files the test
    writes (with the heads the trunks lack) equals the JAX init carried
    across, and Res2Net, SK-ResNet and SENet-154 raise as in JAX;
  * the JAX package's initialisers, from the seed's generator;
  * a bf16 Unet takes float32 images and returns float32 features.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from sfmnext_tpu.config import parse_options as jax_parse_options
from sfmnext_tpu.models.unet import Unet as JaxUnet
from sfmnext_tpu.utils import imagenet_init as jax_imagenet_init
from sfmnext_tpu_torch.config import parse_options
from sfmnext_tpu_torch.data.synthetic import make_batch
from sfmnext_tpu_torch.models import resnest, resnetv2, sknet
from sfmnext_tpu_torch.models.common import BatchNorm2d, EcaModule, jax_init_
from sfmnext_tpu_torch.models.resnet import ResNet
from sfmnext_tpu_torch.models.unet import Unet
from sfmnext_tpu_torch.tools import backbone_coverage
from sfmnext_tpu_torch.training import pipeline
from sfmnext_tpu_torch.training.builder import ModelBundle, build_models
from sfmnext_tpu_torch.training.step import make_optimizer
from sfmnext_tpu_torch.utils import checkpoint, imagenet_init, torch_export
from test_torch_backbones import _empty
from test_torch_models import _one_thread  # noqa: F401

DEC = (32, 24, 16, 16)
HW = (64, 128)
RESNEXT = "seresnext26t_32x4d"


def _drawn(name, seed):
    """A JAX Unet's variables in the shapes of its init, drawn with numpy."""
    model = JaxUnet(backbone=name, num_classes=16, decoder_channels=DEC)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3))))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape, dtype=np.float32),
                                  shapes)


def _torch(sd):
    return {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}


REMAT_ROUTES = {  # route -> (its flags, the encoder's forwards in a --remat step)
    "plain": ([], 2),
    "shared": (["--pose_model_type", "shared"], 2),
    "predictive_mask": (["--predictive_mask", "--disable_automasking"], 1),
}


def _flagship_step(flags, remat):
    opt = parse_options(["--num_layers", "18", "--num_features", "64", "--model_dim", "16",
                         "--patch_size", "4", "--query_nums", "16", "--dim_out", "16",
                         "--height", "64", "--width", "96", "--batch_size", "2",
                         "--compute_dtype", "float32"] + flags + (["--remat"] if remat else []))
    models = build_models(opt, "cpu", train=True)
    for m in models.depth.modules():
        if isinstance(m, (nn.Dropout, nn.MultiheadAttention)):
            m.eval()
    calls = []
    models.encoder.register_forward_pre_hook(lambda *_: calls.append(1))
    batch = make_batch(2, 64, 96, frame_ids=(0, -1, 1), seed=3)
    batch = {k: torch.from_numpy(v) for k, v in batch.items() if k != "depth_gt"}
    total, _ = pipeline.forward(models, batch, opt)
    total.backward()
    return total.item(), models, len(calls)


@pytest.mark.parametrize("route", list(REMAT_ROUTES))
def test_remat_step_equals_the_plain_step(route):
    """The checkpointed encoder runs again in the backward, and the step
    equals the plain one: its BatchNorm statistics move once."""
    flags, forwards = REMAT_ROUTES[route]
    loss, plain, plain_calls = _flagship_step(flags, False)
    loss_r, remat, remat_calls = _flagship_step(flags, True)
    assert (plain_calls, remat_calls) == (1, forwards)
    assert abs(loss_r - loss) <= 1e-6 * abs(loss)
    for name, module in plain.modules().items():
        other = dict(remat.modules()[name].named_parameters())
        for k, p in module.named_parameters():
            g = other[k].grad
            assert (g is None) == (p.grad is None), (name, k)
            if g is not None:
                err = (g - p.grad).norm()
                assert err <= 1e-5 * p.grad.norm() + 1e-12, (name, k, float(err))
        buffers = dict(remat.modules()[name].named_buffers())
        for k, b in module.named_buffers():
            assert torch.equal(buffers[k], b), (name, k)
    bn = next(m for m in remat.encoder.modules() if isinstance(m, BatchNorm2d))
    assert int(bn.num_batches_tracked) == 1


def test_zoo_coverage():
    """Every name of the zoo builds with the half-resolution output on the
    meta device, or raises naming the ROADMAP item: the ConvNeXts and the
    ResNet family build. Four processes share the names (about 40 s in
    one)."""
    result = backbone_coverage.coverage(workers=4)
    assert len(result) == 430
    wrong = {k: v for k, v in result.items() if v not in ("builds", "raises")}
    assert not wrong, wrong
    built = sorted(k for k, v in result.items() if v == "builds")
    assert len(built) == 162
    assert sum(k.startswith("convnext") for k in built) == 28
    for name in ("resnet33ts", "resnet51q", "gluon_xception65", "densenet121", "regnety_040"):
        assert result[name] == "raises", name


# one name per family and option group
EXPORT_NAMES = ("ecaresnet26t", "seresnext26d_32x4d", "resnetrs50", "resnet50_gn", "resnetaa50",
                "gluon_resnet50_v1s", "resnest14d", "resnetv2_50x1_bitm", "resnetv2_50",
                "resnetv2_50d_evos", "res2net50_26w_4s", "skresnext50_32x4d", "legacy_senet154")


@pytest.mark.parametrize("name", EXPORT_NAMES)
def test_encoder_export_matches_the_port(name):
    """``export_encoder`` of the JAX tree holds exactly the port's keys
    (but the counts) and the JAX values."""
    v = _drawn(name, 3)
    sd = _torch(torch_export.export_encoder(v["params"], v.get("batch_stats", {}), name))
    model = _empty(Unet, name, 16, DEC)
    own = [k for k in model.state_dict() if not k.endswith("num_batches_tracked")]
    assert sorted(own) == sorted(sd)
    model.load_state_dict(sd, strict=False)
    got = model.state_dict()
    assert all(torch.equal(got[k], t) for k, t in sd.items())


def test_checkpoint_round_trip(tmp_path):
    """A ResNet-variant Unet's ``encoder.pth`` reads back to the same forward."""
    opt = parse_options(["--backbone", RESNEXT, "--dec_channels", *map(str, DEC),
                         "--model_dim", "16", "--patch_size", "4", "--query_nums", "16",
                         "--dim_out", "16", "--height", "64", "--width", "128",
                         "--use_stereo", "--frame_ids", "0", "--compute_dtype", "float32"])
    models = build_models(opt, "cpu", train=True)
    adam, scheduler = make_optimizer(opt, models, 10)
    checkpoint.save_checkpoint(str(tmp_path / "w"), models, opt, adam, scheduler, None, 0)
    fresh = ModelBundle(_empty(Unet, RESNEXT, 16, DEC),
                        _empty(type(models.depth), 16, 4, 4, 16, 16))
    checkpoint.load_encoder_depth(str(tmp_path / "w"), fresh)
    x = torch.rand(2, 3, *HW, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got, expect = fresh.encoder.eval()(x), models.encoder.eval()(x)
    np.testing.assert_array_equal(got.numpy(), expect.numpy())


def _write(path, shapes, rng):
    torch.save({k: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                for k, s in shapes.items()}, path)


# name -> the head its ImageNet file carries (the trunk has none)
IMAGENET = {"resnet26d": {"fc.weight": (1000, 2048), "fc.bias": (1000,)},
            "seresnext26d_32x4d": {"fc.weight": (1000, 2048), "fc.bias": (1000,)},
            "resnest14d": {"fc.weight": (1000, 2048), "fc.bias": (1000,)},
            "resnetv2_50x1_bitm": {"head.fc.weight": (1000, 2048, 1, 1),
                                   "head.fc.bias": (1000,)}}


@pytest.mark.parametrize("name", list(IMAGENET))
def test_imagenet_init_matches_jax(name, tmp_path, monkeypatch):
    monkeypatch.setenv("SFMNEXT_WEIGHTS", str(tmp_path))
    args = ["--backbone", name, "--dec_channels", *map(str, DEC), "--weights_init", "pretrained"]
    opt, jax_opt = parse_options(args), jax_parse_options(args)
    v = _drawn(name, 4)
    variables = {"params": {"encoder": v["params"]}, "batch_stats": {"encoder": v["batch_stats"]}}
    before = torch_export.export_unet(v["params"], v["batch_stats"], name)
    models = types.SimpleNamespace(encoder=_empty(Unet, name, 16, DEC), rectify=None)
    models.encoder.load_state_dict(_torch(before), strict=False)
    trunk = models.encoder.encoder
    shapes = {k: tuple(t.shape) for k, t in trunk.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    _write(tmp_path / f"{name}.pth", {**shapes, **IMAGENET[name]}, np.random.default_rng(5))
    jax_models = types.SimpleNamespace(pose_encoder=None, rectify=None)
    expect = jax_imagenet_init.apply_weights_init(jax_opt, jax_models, variables)
    expect = torch_export.export_unet(expect["params"]["encoder"],
                                      expect["batch_stats"]["encoder"], name)
    imagenet_init.apply_weights_init(opt, models)
    got = models.encoder.state_dict()
    differ = [k for k, e in expect.items() if not np.array_equal(got[k].numpy(), e)]
    assert not differ, differ
    changed = {k.split(".")[0] for k in expect if not np.array_equal(expect[k], before[k])}
    assert changed == {"encoder"}


@pytest.mark.parametrize("name", ["res2net50_26w_4s", "skresnet18", "legacy_senet154"])
def test_imagenet_init_raises_as_in_jax(name, tmp_path, monkeypatch):
    monkeypatch.setenv("SFMNEXT_WEIGHTS", str(tmp_path))
    args = ["--backbone", name, "--weights_init", "pretrained"]
    with pytest.raises(NotImplementedError, match="no ImageNet-init converter.*scratch"):
        jax_imagenet_init._imagenet_encoder_backbone(jax_parse_options(args))
    models = types.SimpleNamespace(encoder=types.SimpleNamespace(encoder=None), rectify=None)
    with pytest.raises(NotImplementedError, match="no ImageNet-init converter.*scratch"):
        imagenet_init.apply_weights_init(parse_options(args), models)


def _std_ok(w, scale, fan):
    """A truncated normal of variance scale / fan: its spread within 10% and
    nothing past the two deviations of the untruncated normal it cuts."""
    std = np.sqrt(scale / fan)
    w = w.detach().numpy()
    return abs(w.std() / std - 1) < 0.1 and np.abs(w).max() <= 2 * std / 0.87962566103423978


def test_init_follows_the_jax_initialisers():
    """kaiming_normal_fanout convs (ResNeSt's fc1 too); flax's default
    (lecun_normal, zero bias) for SE, ECA, the SK attention and ResNeSt's
    fc2; norms and EvoNorm 1 / 0; the same seed gives the same weights."""
    gen = torch.Generator().manual_seed(0)
    trunk = ResNet(50, se_reduction=16)
    trunk.init_weights(gen)
    blk = trunk.layer3[0]  # 256 -> 1024
    assert _std_ok(blk.conv2.weight, 2.0, 256 * 9) and _std_ok(blk.conv3.weight, 2.0, 1024)
    assert _std_ok(blk.se.fc1.weight, 1.0, 1024) and torch.all(blk.se.fc1.bias == 0)
    assert _std_ok(blk.se.fc2.weight, 1.0, 64) and torch.all(blk.se.fc2.bias == 0)
    assert torch.all(blk.bn1.weight == 1) and torch.all(blk.bn1.running_var == 1)
    eca = nn.ModuleList(EcaModule(1024) for _ in range(100))  # k 5 from 1024 channels
    jax_init_(eca, gen)
    assert _std_ok(torch.cat([m.conv.weight.flatten() for m in eca]), 1.0, 5)
    sa = resnest.SplitAttnConv(256, 256, 2, 1)
    resnest.ResNeSt.init_weights(sa, gen)
    assert _std_ok(sa.fc1.weight, 2.0, 128) and torch.all(sa.fc1.bias == 0)
    assert _std_ok(sa.fc2.weight, 1.0, 128) and torch.all(sa.fc2.bias == 0)
    sk = sknet.SelectiveKernel(256, 256, groups=32, rd_ratio=1.0 / 4, split_input=False)
    sknet.SKNet.init_weights(sk, gen)
    assert _std_ok(sk.paths[1].conv.weight, 2.0, 256 * 9)
    assert _std_ok(sk.attn.fc_select.weight, 1.0, 64)
    evo = resnetv2.PreactBottleneck(256, 1024, 1, "evos", True)
    resnetv2.ResNetV2.init_weights(evo, gen)
    assert torch.all(evo.norm2.v == 1) and torch.all(evo.norm2.bias == 0)
    assert _std_ok(evo.conv2.weight, 2.0, 256 * 9)
    opt = parse_options(["--backbone", "resnet10t", "--dec_channels", *map(str, DEC)])
    a, b = build_models(opt, "cpu").encoder, build_models(opt, "cpu").encoder
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))


@pytest.mark.parametrize("name", ["convnext_atto", "resnet10t"])
def test_bf16_unet_serves(name):
    """A bf16 Unet (its parameters in bf16, no autocast, as serving builds
    it) takes float32 images and returns float32 features."""
    with torch.device("meta"):
        model = Unet(name, 16, DEC, dtype=torch.bfloat16)
    model.to_empty(device="cpu").init_weights(torch.Generator().manual_seed(0))
    with torch.inference_mode():
        out = model.eval()(torch.rand(1, 3, *HW, generator=torch.Generator().manual_seed(1)))
    assert out.dtype == torch.float32 and out.shape == (1, 16, HW[0] // 2, HW[1] // 2)
    assert torch.isfinite(out).all()

