"""The port's inference slice end to end, against the JAX package.

  * JAX models from ``build_models`` + ``init_params`` (ResNet-50, small
    shape, float32; weights drawn with numpy into the JAX tree), written as
    a reference-style ``.pth`` folder, loaded by the port's ``SQLdepth``
    through ``load_pt_folder``: its depth matches the JAX forward of
    ``sfmnext_tpu/sql_depth.py`` to 1e-4 of the largest depth;
  * the port's CLI writes both output images;
  * the port imports neither JAX nor the JAX package, in its source or at
    run time: serving (``SQLdepth``) and a training step with the SSIM
    loss and on-device augmentation run in a subprocess with none of them
    in ``sys.modules``;
  * its own copy of the options matches the JAX package's.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
from PIL import Image

from sfmnext_tpu.config import parse_options
from sfmnext_tpu.ops.image import resize_bilinear as jax_resize_bilinear
from sfmnext_tpu.training.builder import build_models, init_params
from sfmnext_tpu.utils.torch_export import save_reference_style_checkpoint
from sfmnext_tpu_torch import test_simple
from sfmnext_tpu_torch.sql_depth import SQLdepth
from test_torch_models import numpy_variables

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--height", "64", "--width", "192", "--num_features", "64",
         "--model_dim", "16", "--patch_size", "8", "--query_nums", "16",
         "--dim_out", "32", "--compute_dtype", "float32"]


def test_sqldepth_matches_jax_forward(tmp_path):
    opt = parse_options(SMALL + ["--num_layers", "50"])
    models = build_models(opt, train=False)
    variables = numpy_variables(lambda key: init_params(opt, models, key), 0)
    params, stats = variables["params"], variables["batch_stats"]
    save_reference_style_checkpoint(str(tmp_path), params, stats, opt)

    images = np.random.RandomState(1).rand(2, 64, 192, 3).astype(np.float32)

    @jax.jit
    def forward(params, stats, images):  # sfmnext_tpu/sql_depth.py:37-46
        feats = models.encoder.apply(
            {"params": params["encoder"], "batch_stats": stats["encoder"]}, images
        )
        out = models.depth.apply({"params": params["depth"]}, feats)
        return jax_resize_bilinear(out["disp0"], (64, 192), align_corners=False)

    expect = np.asarray(forward(params, stats, images))

    port = SQLdepth(dataclasses.replace(
        opt, load_pretrained_model=True, load_pt_folder=str(tmp_path)), "cpu")
    got = port(images).numpy()
    assert got.shape == (2, 64, 192, 1)
    err = np.abs(got - expect).max()
    assert err <= 1e-4 * np.abs(expect).max(), err


def test_cli_writes_depth_png_and_colormap(tmp_path):
    png = tmp_path / "frame.png"
    rgb = np.random.RandomState(2).randint(0, 256, (50, 90, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(png)
    test_simple.main(SMALL + ["--num_layers", "18", "--image_path", str(png), "--no_cuda"])
    depth_png = tmp_path / "frame_depth.png"
    assert depth_png.exists() and (tmp_path / "frame_disp.jpeg").exists()
    assert Image.open(depth_png).size == (90, 50)


def test_port_runs_without_jax():
    """Serving, and one augmented training step with the SSIM loss, import
    nothing of JAX or the JAX package."""
    script = (
        "import sys, types, numpy as np, torch\n"
        "from sfmnext_tpu_torch.config import parse_options\n"
        "from sfmnext_tpu_torch.data.synthetic import make_batch\n"
        "from sfmnext_tpu_torch.sql_depth import SQLdepth\n"
        "from sfmnext_tpu_torch.training.builder import build_models\n"
        "from sfmnext_tpu_torch.training.step import make_optimizer, make_train_step\n"
        "opt = types.SimpleNamespace(\n"
        "    backbone='resnet', num_layers=18, num_features=64, model_dim=16,\n"
        "    patch_size=8, query_nums=16, dim_out=32, min_depth=0.001,\n"
        "    max_depth=80.0, compute_dtype='float32', seed=0,\n"
        "    load_pretrained_model=False, load_pt_folder=None)\n"
        "depth = SQLdepth(opt, 'cpu')(np.zeros((1, 64, 192, 3), np.float32))\n"
        "assert tuple(depth.shape) == (1, 64, 192, 1)\n"
        "opt = parse_options(['--num_layers', '18', '--num_features', '64',\n"
        "    '--model_dim', '16', '--patch_size', '4', '--query_nums', '16',\n"
        "    '--dim_out', '16', '--height', '64', '--width', '96',\n"
        "    '--compute_dtype', 'float32'])\n"
        "models = build_models(opt, 'cpu', train=True)\n"
        "step = make_train_step(opt, models, *make_optimizer(opt, models, 10), augment=True)\n"
        "batch = {k: torch.from_numpy(v) for k, v in make_batch(2, 64, 96).items()\n"
        "         if k != 'depth_gt'}\n"
        "loss = float(step(batch, torch.Generator().manual_seed(0))['loss'])\n"
        "assert np.isfinite(loss), loss\n"
        "loaded = [m for m in sys.modules\n"
        "          if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'sfmnext_tpu')]\n"
        "assert not loaded, loaded\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_port_source_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports JAX or the JAX
    package (``sfmnext_tpu``; ``sfmnext_tpu_torch`` is the port itself)."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|sfmnext_tpu)\b", re.M)
    files = [*(ROOT / "sfmnext_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    offenders = [str(p.relative_to(ROOT)) for p in files if pattern.search(p.read_text())]
    assert not offenders, offenders


def test_port_config_is_a_copy_of_the_jax_one():
    """The port's Options has the JAX package's fields and defaults, and
    parses the flagship argfile to the same values."""
    import sfmnext_tpu.config as jax_config

    from sfmnext_tpu_torch import config

    fields = [(f.name, f.default) for f in dataclasses.fields(config.Options)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(jax_config.Options)]
    argv = [str(ROOT / "args_files" / "hisfog" / "kitti" / "resnet_320x1024.txt"), "--no_ssim"]
    assert (dataclasses.asdict(config.parse_options(argv))
            == dataclasses.asdict(jax_config.parse_options(argv)))
