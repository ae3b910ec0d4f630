"""The port's ResNet family of Unet encoders, and ``--remat``, against the
JAX package's, on the CPU in float32.

Weights are drawn with numpy in the JAX trees' shapes (``numpy_variables``)
and carried to the port by the port's ``torch_export``. All the JAX numbers
come from one jitted function (one compile):

  * each option of the JAX ``ResNetEncoder`` (SE, ECA, avg-down, blur and
    average anti-aliasing, GroupNorm, the deep and the deep tiered stem,
    ResNet-RS's stem pool, ResNeXt widths) on the ``ResNet`` trunk at
    depth 10 or 14 (one block a stage), 64x64, batch 2, in train mode: the
    five taps to 1e-4 of their largest value and the running statistics
    to 1e-5;
  * the same for SENet-154's stem with an ``SEBottleneck``, the ResNeSt
    bottleneck (radix 2, radix 4 in 2 groups, radix 1), two Res2Net
    bottlenecks (a stage's first, and a cascading one) and a Res2NeXt one,
    the selective-kernel basic and ResNeXt blocks, and the pre-activation
    bottleneck with BatchNorm, GroupNorm and EvoNorm-S0 (avg-down);
  * the whole eval-mode Unet of ``resnest14d`` and of ``skresnet18`` at
    64x128, to 1e-4;
  * a ``--use_stereo --remat`` training step of a ``seresnext26t_32x4d``
    Unet (decoder channels 32 24 16 16, frames 0 -1 1 s, no augmentation,
    dropout and tie-break noise off) against
    ``jax.value_and_grad(pipeline.forward)`` with ``--remat``, in float32
    and again in float64 (below).

The float32 gradients of this step are ill-conditioned: BatchNorm over a
few pixels in the deep stages and the Unet decoder amplifies rounding.
The float64 step is the witness. The JAX package under x64 and the port in
float64 (the same float32 casts on both sides) agree on every gradient to
5.2e-5 of its norm (the encoder's to 5.5e-6), and are held to 1e-4. Against
that step, JAX's own float32 encoder gradients lie up to 6.6e-3 of their
norms away and the port's up to 6.3e-3. So the float32 step holds the loss
to 1e-5 relative and each gradient to 1e-3 of its norm, the limits of
``tests/test_torch_train_step.py``, or to twice the distance of JAX's own
float32 gradient from its float64 one where that is larger (148 of the
encoder's 151 gradients; the port reads at most 0.51 of its limit).
``pytest -s`` prints these readings.

``tests/test_torch_zoo_surface.py`` holds the rest without JAX numbers.
"""

import contextlib
import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from sfmnext_tpu.config import parse_options as jax_parse_options
from sfmnext_tpu.models import res2net as jax_res2net
from sfmnext_tpu.models import resnest as jax_resnest
from sfmnext_tpu.models import resnetv2 as jax_resnetv2
from sfmnext_tpu.models import senet as jax_senet
from sfmnext_tpu.models import sknet as jax_sknet
from sfmnext_tpu.models.resnet import ResNetEncoder as JaxResNetEncoder
from sfmnext_tpu.models.unet import Unet as JaxUnet
from sfmnext_tpu.training import pipeline as jax_pipeline
from sfmnext_tpu.training.builder import build_models as jax_build_models, init_params
from sfmnext_tpu_torch.config import parse_options
from sfmnext_tpu_torch.models import res2net, resnest, resnetv2, senet, sknet
from sfmnext_tpu_torch.models.resnet import ResNet
from sfmnext_tpu_torch.models.unet import Unet
from sfmnext_tpu_torch.ops import geometry
from sfmnext_tpu_torch.training import pipeline
from sfmnext_tpu_torch.training.builder import build_models
from sfmnext_tpu_torch.utils import torch_export
from sfmnext_tpu_torch.utils.jax_weights import from_jax_variables
from test_torch_backbones import _empty, _stereo_batch
from test_torch_models import _one_thread, numpy_variables  # noqa: F401

DEC = (32, 24, 16, 16)
HW = (64, 128)
# option -> (depth, ResNetEncoder keywords)
RESNET_OPTIONS = {
    "se": (10, dict(se_reduction=16)),
    "eca": (10, dict(attn="eca")),
    "avg_down": (10, dict(avg_down=True)),
    "blur": (14, dict(aa="blur")),
    "avg_aa": (14, dict(aa="avg")),
    "gn": (14, dict(norm="gn")),
    "deep": (10, dict(stem_type="deep")),
    "deep_tiered": (14, dict(stem_type="deep_tiered", avg_down=True)),
    "rs_stem_pool": (10, dict(stem_type="deep", replace_stem_pool=True, se_reduction=4,
                              avg_down=True)),
    "groups": (14, dict(groups=32, base_width=4)),
}
STEREO_REMAT = "seresnext26t_32x4d"
REMAT_ARGS = ["--backbone", STEREO_REMAT, "--dec_channels", *map(str, DEC), "--model_dim", "16",
              "--patch_size", "4", "--query_nums", "16", "--dim_out", "16", "--height", "64",
              "--width", "128", "--batch_size", "2", "--compute_dtype", "float32",
              "--use_stereo", "--frame_ids", "0", "-1", "1", "--remat"]
UNETS = ("resnest14d", "skresnet18")


class _SENetStem(fnn.Module):
    """SENet154's stem (the lines of ``SENet154.__call__``, with the JAX
    package's ``_conv`` and ``BatchNorm``) and a stride-2 ``SEBottleneck``."""

    @fnn.compact
    def __call__(self, x):
        y = x
        for i, (c, s) in enumerate(zip((64, 64, 128), (2, 1, 1))):
            y = jax_senet._conv(c, 3, s, name=f"stem{i}")(y)
            y = fnn.relu(jax_senet.BatchNorm(False, name=f"stem{i}_bn")(y))
        return jax_senet.SEBottleneck(32, 2, True, name="layer1_0")(y)


class _Block(fnn.Module):
    """One JAX block under the name its trunk gives it."""

    make: object
    block_name: str = "layer1_0"

    @fnn.compact
    def __call__(self, x):
        return self.make(name=self.block_name)(x)


class _Layer1(nn.Module):
    """A port block where its trunk puts it (``layer1.0``)."""

    def __init__(self, block):
        super().__init__()
        self.layer1 = nn.Sequential(block)

    def forward(self, x):
        return self.layer1(x)


class _SENetStemPort(_Layer1):
    def __init__(self):
        super().__init__(senet.SEBottleneck(128, 32, 2))
        self.layer0 = senet._Stem()

    def forward(self, x):
        return self.layer1(self.layer0(x))


class _Stage0(nn.Module):
    """A pre-activation block where ResNetV2 puts it (``stages.0.blocks.0``)."""

    def __init__(self, block):
        super().__init__()
        self.stages = nn.ModuleList([resnetv2._Stage([block])])

    def forward(self, x):
        return self.stages[0](x)


# block -> (JAX module, its input channels, the port module)
BLOCKS = {
    "senet154_stem_se_bottleneck": (_SENetStem(), 3, _SENetStemPort),
    "resnest_radix2": (_Block(functools.partial(jax_resnest.ResNeStBottleneck, 16, 2, 2, 1, 64,
                                                True)), 32,
                       lambda: _Layer1(resnest.ResNeStBottleneck(32, 16, 2, 2, 1, 64))),
    "resnest_radix4_card2": (_Block(functools.partial(jax_resnest.ResNeStBottleneck, 32, 2, 4, 2,
                                                      40, True)), 32,
                             lambda: _Layer1(resnest.ResNeStBottleneck(32, 32, 2, 4, 2, 40))),
    "resnest_radix1": (_Block(functools.partial(jax_resnest.ResNeStBottleneck, 16, 1, 1, 4, 24,
                                                True)), 64,
                       lambda: _Layer1(resnest.ResNeStBottleneck(64, 16, 1, 1, 4, 24))),
    "res2net_first": (_Block(functools.partial(jax_res2net.Bottle2neck, 16, 26, 4, 1, 2, True)),
                      32, lambda: _Layer1(res2net.Bottle2neck(32, 16, 26, 4, 1, 2))),
    "res2net_cascade": (_Block(functools.partial(jax_res2net.Bottle2neck, 16, 26, 4, 1, 1,
                                                 True)), 64,
                        lambda: _Layer1(res2net.Bottle2neck(64, 16, 26, 4, 1, 1))),
    "res2next_first": (_Block(functools.partial(jax_res2net.Bottle2neck, 16, 4, 4, 8, 1, True)),
                       32, lambda: _Layer1(res2net.Bottle2neck(32, 16, 4, 4, 8, 1))),
    "sk_basic": (_Block(functools.partial(jax_sknet.SKBasicBlock, 32, 2, True)), 16,
                 lambda: _Layer1(sknet.SKBasicBlock(16, 32, 2))),
    "sk_bottleneck": (_Block(functools.partial(jax_sknet.SKBottleneck, 16, 2, 32, 4, True)), 32,
                      lambda: _Layer1(sknet.SKBottleneck(32, 16, 2, 32, 4))),
    "preact_bn": (_Block(functools.partial(jax_resnetv2.PreactBottleneck, 128, 2, "bn", False,
                                           False, True), "stage0_block0"), 64,
                  lambda: _Stage0(resnetv2.PreactBottleneck(64, 128, 2, "bn", False))),
    "preact_gn_ws": (_Block(functools.partial(jax_resnetv2.PreactBottleneck, 128, 2, "gn", True,
                                              False, True), "stage0_block0"), 64,
                     lambda: _Stage0(resnetv2.PreactBottleneck(64, 128, 2, "gn", True))),
    "preact_evos_avg_down": (_Block(functools.partial(jax_resnetv2.PreactBottleneck, 128, 2,
                                                      "evos", True, True, True),
                                    "stage0_block0"), 64,
                             lambda: _Stage0(resnetv2.PreactBottleneck(64, 128, 2, "evos", True,
                                                                       True))),
}
BLOCK_HW = {"senet154_stem_se_bottleneck": (32, 32)}


def _images(seed, shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _jax_resnet(option):
    depth, kw = RESNET_OPTIONS[option]
    return JaxResNetEncoder(num_layers=depth, normalize_input=False, train=True, **kw)


def _torch(sd):
    return {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _scaled(got, expect):
    return np.abs(got - expect).max() / np.abs(expect).max()


def _unet_vars(name, seed):
    model = JaxUnet(backbone=name, num_classes=16, decoder_channels=DEC)
    return numpy_variables(lambda key: model.init(key, jnp.zeros((1, *HW, 3))), seed)


def _jax_step(jax_models, jax_opt, params, batch_stats, batch):
    """``jax.value_and_grad(pipeline.forward)``: (metrics, gradients)."""
    def loss_fn(p):
        return jax_pipeline.forward(jax_models, p, batch_stats, batch, None, jax_opt)

    (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return aux["metrics"], grads


@pytest.fixture(scope="module")
def jax_run():
    """Every float32 JAX number of the module from one jitted function."""
    jax_opt = jax_parse_options(REMAT_ARGS)
    jax_models = jax_build_models(jax_opt, train=True)
    jax_models = dataclasses.replace(
        jax_models, depth=jax_models.depth.clone(deterministic=True))
    step = functools.partial(_jax_step, jax_models, jax_opt)
    variables = numpy_variables(lambda key: init_params(jax_opt, jax_models, key), 7)
    batch = _stereo_batch()
    x64 = _images(0, (2, 64, 64, 3))
    resnet_vars = {o: numpy_variables(lambda key, o=o: _jax_resnet(o).init(key, x64), i)
                   for i, o in enumerate(RESNET_OPTIONS)}
    block_x = {b: _images(i, (2, *BLOCK_HW.get(b, (16, 16)), cin))
               for i, (b, (_, cin, _)) in enumerate(BLOCKS.items())}
    block_vars = {b: numpy_variables(lambda key, b=b: BLOCKS[b][0].init(key, block_x[b]), 20 + i)
                  for i, b in enumerate(BLOCKS)}
    unet_vars = {n: _unet_vars(n, 40 + i) for i, n in enumerate(UNETS)}
    x_unet = _images(1, (2, *HW, 3))

    def run(params, resnet_vars, block_vars, unet_vars):
        metrics, grads = step(params, variables["batch_stats"], batch)
        resnets = {o: _jax_resnet(o).apply(v, x64, mutable=["batch_stats"])
                   for o, v in resnet_vars.items()}
        blocks = {b: BLOCKS[b][0].apply(v, block_x[b], mutable=["batch_stats"])
                  for b, v in block_vars.items()}
        unets = {n: JaxUnet(backbone=n, num_classes=16, decoder_channels=DEC).apply(v, x_unet)
                 for n, v in unet_vars.items()}
        return dict(metrics=metrics, grads=grads, unets=unets,
                    resnets={o: (f, s.get("batch_stats", {})) for o, (f, s) in resnets.items()},
                    blocks={b: (y, s.get("batch_stats", {})) for b, (y, s) in blocks.items()})

    out = jax.jit(run)(variables["params"], resnet_vars, block_vars, unet_vars)
    out = jax.tree_util.tree_map(np.asarray, out)
    return dict(out, variables=variables, batch=batch, x64=x64, resnet_vars=resnet_vars,
                block_x=block_x, block_vars=block_vars, unet_vars=unet_vars, x_unet=x_unet,
                step=step)


def _float64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else a, tree)


@pytest.fixture(scope="module")
def jax_run64(jax_run):
    """The ``--remat`` step of ``jax_run`` with the JAX package under x64:
    the weights and the batch in float64 (a second compile)."""
    variables = jax_run["variables"]
    with jax.enable_x64(True):
        out = jax.jit(jax_run["step"])(_float64(variables["params"]),
                                       _float64(variables["batch_stats"]),
                                       _float64(jax_run["batch"]))
        return jax.tree_util.tree_map(np.asarray, out)


def _check_stats(module, expect):
    got = module.state_dict()
    keys = [k for k in expect if ".running_" in k]
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), expect[k], rtol=1e-5, atol=1e-6, err_msg=k)
    return keys


@pytest.mark.parametrize("option", list(RESNET_OPTIONS))
def test_resnet_option_matches_jax(jax_run, option):
    depth, kw = RESNET_OPTIONS[option]
    avg_down = kw.get("avg_down", False)
    v = jax_run["resnet_vars"][option]
    model = ResNet(depth, **kw)
    model.load_state_dict(_torch(torch_export.export_trunk(v["params"], v.get("batch_stats", {}),
                                                           avg_down)), strict=False)
    missing = [k for k in model.state_dict() if not k.endswith("num_batches_tracked")
               and k not in torch_export.export_trunk(v["params"], v.get("batch_stats", {}),
                                                      avg_down)]
    assert not missing, missing
    with torch.no_grad():
        feats = model.train()(_nchw(jax_run["x64"]))
    expect_feats, expect_stats = jax_run["resnets"][option]
    assert len(feats) == len(expect_feats) == 5
    for got, want in zip(feats, expect_feats):
        assert _nhwc(got).shape == want.shape
        assert _scaled(_nhwc(got), want) <= 1e-4
    keys = _check_stats(model, torch_export.export_trunk(v["params"], expect_stats, avg_down))
    assert bool(keys) == (option != "gn")


@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_matches_jax(jax_run, block):
    v = jax_run["block_vars"][block]
    model = BLOCKS[block][2]()
    sd = torch_export.export_trunk(v["params"], v.get("batch_stats", {}))
    own = [k for k in model.state_dict() if not k.endswith("num_batches_tracked")]
    assert sorted(own) == sorted(sd)
    model.load_state_dict(_torch(sd), strict=False)
    with torch.no_grad():
        got = _nhwc(model.train()(_nchw(jax_run["block_x"][block])))
    want, stats = jax_run["blocks"][block]
    assert got.shape == want.shape and _scaled(got, want) <= 1e-4
    keys = _check_stats(model, torch_export.export_trunk(v["params"], stats))
    assert bool(keys) == (block not in ("preact_gn_ws", "preact_evos_avg_down"))


@pytest.mark.parametrize("name", UNETS)
def test_unet_forward_matches_jax(jax_run, name):
    model = _empty(Unet, name, 16, DEC)
    v = jax_run["unet_vars"][name]
    model.load_state_dict(_torch(torch_export.export_unet(v["params"], v["batch_stats"])))
    with torch.no_grad():
        got = _nhwc(model.eval()(_nchw(jax_run["x_unet"])))
    assert got.shape == jax_run["unets"][name].shape == (2, 32, 64, 16)
    assert _scaled(got, jax_run["unets"][name]) <= 1e-4


def _up(*tensors):
    """float32 tensors upcast to float64 (exact), as jnp promotes them."""
    return [t.double() if torch.is_tensor(t) and t.dtype == torch.float32 else t
            for t in tensors]


@contextlib.contextmanager
def _float64_port(models, opt):
    """The port's step as the JAX package runs under x64: the networks in
    float64, the plain route (the XLA one JAX takes on the CPU), and the
    float32 values that the port's casts leave meeting float64 ones, as
    jnp's promotion does (a module's input, the pixel grid, K @ T)."""
    opt.use_pallas = False
    for name in ("encoder", "depth", "pose"):
        for m in getattr(models, name).double().modules():
            if getattr(m, "dtype", None) == torch.float32:
                m.dtype = torch.float64
            m.register_forward_pre_hook(lambda m, args: tuple(_up(*args)))
    grid, matmul, einsum = geometry.pixel_grid, torch.matmul, torch.einsum
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(geometry, "pixel_grid",
                   lambda h, w, dtype=None, device=None: grid(h, w, torch.float64, device))
        mp.setattr(torch, "matmul", lambda a, b, **kw: matmul(*_up(a, b), **kw))
        mp.setattr(torch, "einsum", lambda eq, *ops: einsum(eq, *_up(*ops)))
        yield


def _remat_step(jax_run, float64=False):
    """The port's step on the JAX weights and batch: (models, aux)."""
    opt = parse_options(REMAT_ARGS)
    assert opt.remat
    models = build_models(opt, "cpu", train=True)
    for name, sd in from_jax_variables(jax_run["variables"], opt.backbone).items():
        getattr(models, name).load_state_dict(sd, strict=True)
    for m in models.depth.modules():  # dropout off, BatchNorm still on batch statistics
        if isinstance(m, (nn.Dropout, nn.MultiheadAttention)):
            m.eval()
    batch = {k: torch.from_numpy(v) for k, v in jax_run["batch"].items()}
    with _float64_port(models, opt) if float64 else contextlib.nullcontext():
        if float64:
            batch = dict(zip(batch, _up(*batch.values())))
        total, aux = pipeline.forward(models, batch, opt)
        total.backward()
    return models, aux


@pytest.fixture(scope="module")
def remat_step(jax_run):
    """The port's step in float32 and in float64."""
    return {"float32": _remat_step(jax_run), "float64": _remat_step(jax_run, float64=True)}


def _gradients(jax_run, jax_grads, models, name):
    """{parameter: (JAX's gradient, the port's)}, by the port's names."""
    stats = jax_run["variables"]["batch_stats"]["encoder"]
    exports = {
        "encoder": lambda g: torch_export.export_unet(g, stats, STEREO_REMAT),
        "depth": torch_export.export_sql_decoder,
        "pose": torch_export.export_pose_cnn,
    }
    expect = {k: np.asarray(v, np.float64) for k, v in exports[name](jax_grads[name]).items()
              if ".running_" not in k}
    got = {k: p.grad.double().numpy() for k, p in getattr(models, name).named_parameters()}
    assert sorted(got) == sorted(expect)
    return {k: (expect[k], got[k]) for k in got}


@pytest.mark.parametrize("dtype, rtol", [("float32", 1e-5), ("float64", 1e-6)])
@pytest.mark.parametrize("key", ["loss", "loss/reprojection", "loss/smooth"])
def test_stereo_remat_loss_matches_jax(jax_run, jax_run64, remat_step, key, dtype, rtol):
    """The float64 loss keeps the float32 casts of both packages' losses."""
    expect = (jax_run["metrics"] if dtype == "float32" else jax_run64[0])[key]
    got = remat_step[dtype][1]["metrics"][key].item()
    np.testing.assert_allclose(got, float(expect), rtol=rtol)


@pytest.mark.parametrize("name", ["encoder", "depth", "pose"])
def test_stereo_remat_gradients_match_jax_in_float64(jax_run, jax_run64, remat_step, name):
    """The witness: every gradient to 1e-4 of its norm (``pytest -s``
    prints the largest reading)."""
    rel = {k: np.linalg.norm(g - e) / np.linalg.norm(e)
           for k, (e, g) in _gradients(jax_run, jax_run64[1], remat_step["float64"][0],
                                       name).items()}
    print(f"\n{name} float64: JAX vs the port, worst {max(rel.values()):.2e} of the norm")
    for k, r in rel.items():
        assert r <= 1e-4, (k, r)


@pytest.mark.parametrize("name", ["encoder", "depth", "pose"])
def test_stereo_remat_gradients_match_jax(jax_run, jax_run64, remat_step, name):
    """Each gradient to 1e-3 of its norm, or to twice the distance of JAX's
    own float32 gradient from its float64 one where that is larger (the
    module docstring; ``pytest -s`` prints the readings)."""
    float64 = _gradients(jax_run, jax_run64[1], remat_step["float64"][0], name)
    rows = []
    for k, (e, g) in _gradients(jax_run, jax_run["grads"], remat_step["float32"][0],
                                name).items():
        n = np.linalg.norm(e)
        own, err = np.linalg.norm(e - float64[k][0]), np.linalg.norm(g - e)
        rows.append((k, err / n, own / n, np.linalg.norm(g - float64[k][1]) / n,
                     err / max(1e-3 * n, 2 * own)))
    worst = [max(r[i] for r in rows) for i in range(1, 5)]
    far = max(rows, key=lambda r: r[1])
    print(f"\n{name} float32, worst of the norm: port vs JAX {worst[0]:.2e}; JAX vs its "
          f"float64 step {worst[1]:.2e}; the port vs its own {worst[2]:.2e}; "
          f"{sum(2 * r[2] > 1e-3 for r in rows)} of {len(rows)} widened; {worst[3]:.2f} of the "
          f"limit; the farthest, {far[0]}: JAX's own {far[2]:.2e}, the port's {far[3]:.2e}")
    for k, err, own, _, share in rows:
        assert share <= 1, (k, err, own)
