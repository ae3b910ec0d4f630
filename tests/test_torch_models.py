"""The port's models against the JAX package's, on the same weights.

Every weight, including the BatchNorm running statistics, is drawn with
numpy into the shapes of the JAX model's variable tree, and goes to the
port through ``sfmnext_tpu.utils.torch_export``'s reference state-dict
names, loaded ``strict=True``. float32 models agree to 1e-4 of each
output's largest value. The bf16 SQL decoder, which runs the fused
kernels' plain versions on CPU, is held to the JAX decoder's Pallas path
(interpret mode) at rtol 2e-2, atol 5e-2, the tolerance of the JAX
package's own fused-vs-unfused test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sfmnext_tpu.models.decoder_bn import ResnetEncoderDecoder as JaxEncoderDecoder
from sfmnext_tpu.models.pose_cnn import PoseCNN as JaxPoseCNN
from sfmnext_tpu.models.resnet import ResNetEncoder as JaxResNetEncoder
from sfmnext_tpu.models.sql_decoder import SQLDecoder as JaxSQLDecoder
from sfmnext_tpu.utils import torch_export
from sfmnext_tpu_torch.models import PoseCNN, ResNetEncoder, ResnetEncoderDecoder, SQLDecoder
from sfmnext_tpu_torch.utils.jax_weights import from_jax_variables


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on a few cores, where torch's default thread pool per worker only
    oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


H, W = 64, 192
SQL_KW = dict(embedding_dim=16, patch_size=8, query_nums=16, dim_out=32)


def numpy_variables(init_fn, seed, *args):
    """Variables shaped like ``init_fn(key, *args)``, drawn with numpy:
    kernels U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as torch initialises them,
    small biases, norm scales and BN statistics around 1 and 0, and a
    U[0,1) positional table."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)
    rng = np.random.RandomState(seed)

    def draw(name, shape):
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, shape)
        if name == "mean":
            return rng.randn(*shape) * 0.1
        if name == "positional_encodings":
            return rng.rand(*shape)
        if name.endswith("kernel"):
            return rng.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1]))
        return rng.randn(*shape) * 0.05

    def walk(tree):
        return {k: walk(v) if hasattr(v, "items") else
                draw(k, v.shape).astype(np.float32) for k, v in tree.items()}

    return walk(shapes)


def _assert_close(got, expect, rtol):
    got, expect = np.asarray(got), np.asarray(expect)
    assert got.shape == expect.shape
    err = np.abs(got - expect).max()
    assert err <= rtol * np.abs(expect).max(), (err, np.abs(expect).max())


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


def _images(seed):
    return np.random.RandomState(seed).rand(2, H, W, 3).astype(np.float32)


def _to_torch(sd):
    return {k: torch.tensor(v) for k, v in sd.items()}


@pytest.mark.parametrize("num_layers", [18, 50])
def test_resnet_encoder_matches_jax(num_layers):
    x = _images(num_layers)
    jax_model = JaxResNetEncoder(num_layers=num_layers)
    variables = numpy_variables(jax_model.init, num_layers, x)
    expect = jax.jit(jax_model.apply)(variables, x)

    model = ResNetEncoder(num_layers).eval()
    sd = torch_export.export_resnet_encoder(
        variables["params"], variables["batch_stats"], prefix="encoder."
    )
    model.load_state_dict(_to_torch(sd), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 5
    for g, e in zip(got, expect):
        _assert_close(_nhwc(g), e, 1e-4)


def test_resnet_encoder_decoder_matches_jax():
    x = _images(2)
    jax_model = JaxEncoderDecoder(num_layers=18, num_features=64, model_dim=16)
    variables = numpy_variables(jax_model.init, 3, x)
    expect = jax.jit(jax_model.apply)(variables, x)

    model = ResnetEncoderDecoder(18, 64, 16).eval()
    sd = torch_export.export_resnet_encoder_decoder(
        variables["params"], variables["batch_stats"]
    )
    model.load_state_dict(_to_torch(sd), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 16, H // 2, W // 2)
    _assert_close(_nhwc(got), expect, 1e-4)


def _sql_setup(seed):
    # features in [0,1), as the JAX package's fused-vs-unfused test draws
    # them: with N(0,1) features the bins softmax is sharp enough that bf16
    # rounding at the frameworks' different points moves a few depths by
    # more than the bf16 tolerance (the float32 paths agree either way)
    feats = np.random.RandomState(seed).rand(2, H // 2, W // 2, 16).astype(np.float32)
    params = numpy_variables(JaxSQLDecoder(**SQL_KW).init, seed, feats)["params"]
    return feats, params


def _port_sql_decoder(params, dtype):
    model = SQLDecoder(**SQL_KW, dtype=dtype).eval()
    sd = _to_torch(torch_export.export_sql_decoder(params))
    model.load_state_dict(sd, strict=True)
    return model


def test_sql_decoder_matches_jax_f32():
    feats, params = _sql_setup(4)
    expect = jax.jit(JaxSQLDecoder(**SQL_KW).apply)({"params": params}, feats)
    with torch.inference_mode():
        got = _port_sql_decoder(params, torch.float32)(
            torch.from_numpy(feats).permute(0, 3, 1, 2)
        )
    _assert_close(_nhwc(got["disp0"]), expect["disp0"], 1e-4)
    _assert_close(got["bin_centers"].numpy(), expect["bin_centers"], 1e-4)


def test_sql_decoder_bf16_matches_jax_pallas():
    feats, params = _sql_setup(5)
    jax_model = JaxSQLDecoder(**SQL_KW, dtype=jnp.bfloat16, use_pallas=True)
    with pltpu.force_tpu_interpret_mode():
        expect = jax_model.apply({"params": params}, feats)["disp0"]
    with torch.inference_mode():
        got = _port_sql_decoder(params, torch.bfloat16)(
            torch.from_numpy(feats).permute(0, 3, 1, 2)
        )["disp0"]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), np.asarray(expect), rtol=2e-2, atol=5e-2)


def test_from_jax_variables_names_match_the_port():
    """from_jax_variables gives state dicts the port loads strictly, the
    PoseCNN's included, with the JAX package's name maps."""
    enc = JaxEncoderDecoder(num_layers=18, num_features=64, model_dim=16)
    enc_vars = numpy_variables(enc.init, 6, _images(6))
    _, dep_params = _sql_setup(6)
    pose_params = numpy_variables(JaxPoseCNN().init, 6, np.zeros((1, H, W, 6), np.float32))
    sds = from_jax_variables({
        "params": {"encoder": enc_vars["params"], "depth": dep_params,
                   "pose": pose_params["params"]},
        "batch_stats": {"encoder": enc_vars["batch_stats"]},
    })
    ResnetEncoderDecoder(18, 64, 16).load_state_dict(sds["encoder"], strict=True)
    SQLDecoder(**SQL_KW).load_state_dict(sds["depth"], strict=True)
    PoseCNN().load_state_dict(sds["pose"], strict=True)
    expect = torch_export.export_resnet_encoder_decoder(enc_vars["params"], enc_vars["batch_stats"])
    assert sorted(sds["encoder"]) == sorted(expect)
    for k, v in expect.items():
        np.testing.assert_array_equal(sds["encoder"][k].numpy(), v, err_msg=k)


def test_pose_cnn_matches_jax():
    """The port's plain strided convolutions against the JAX PoseCNN's
    space-to-depth ones, on the same weights."""
    x = np.random.RandomState(15).rand(2, H, W, 6).astype(np.float32)
    jax_model = JaxPoseCNN()
    variables = numpy_variables(jax_model.init, 15, x)
    expect = jax.jit(jax_model.apply)(variables, x)
    model = PoseCNN()
    model.load_state_dict(_to_torch(torch_export.export_pose_cnn(variables["params"])),
                          strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, e in zip(got, expect):
        assert g.shape == (2, 1, 1, 3)
        _assert_close(g.numpy(), e, 1e-4)
