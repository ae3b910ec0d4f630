#!/usr/bin/env python
"""The JAX package's own gap between its two SSIM loss routes, on the CPU.

On a TPU the JAX pipeline takes the fused Pallas SSIM route
(``sfmnext_tpu/training/pipeline.py:279-281``: the kernels round p*p, t*t,
p*t and the vertical window sums to bf16); elsewhere its XLA route (only
the products rounded, under a bf16 loss). This script runs one
``jax.value_and_grad(pipeline.forward)`` through each route on the same
numpy-drawn weights and synthetic batch: the Pallas kernels in interpret
mode, with the backend check of the SSIM route alone answered "tpu" (the
warp and the SQL decoder stay on XLA). It prints the loss gap and each
module's gradient gap as the relative norm of the difference, for a bf16
and a float32 network and two draws of weights and batch. It imports the
JAX package and changes none of its files.

    JAX_PLATFORMS=cpu python tools/jax_ssim_route_gap.py

Tiny config: ResNet-18, num_features 64, model_dim 16, patch 4, 16
queries, 16 bins, 64x128 (the Pallas SSIM kernels need W % 128 == 0),
batch 2, SSIM 0.85, automasking, dropout and tie-break noise off.
About two minutes on a CPU.
"""

import dataclasses
import os
import sys
import types

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sfmnext_tpu.config import parse_options  # noqa: E402
from sfmnext_tpu.data.synthetic import make_batch  # noqa: E402
from sfmnext_tpu.training import pipeline  # noqa: E402
from sfmnext_tpu.training.builder import build_models, init_params  # noqa: E402

ARGS = ["--num_layers", "18", "--num_features", "64", "--model_dim", "16",
        "--patch_size", "4", "--query_nums", "16", "--dim_out", "16",
        "--height", "64", "--width", "128", "--batch_size", "2"]
FUSED_SSIM_CHECK = 280  # the line of pipeline.forward that picks the Pallas SSIM route


class _SsimOnTpu(types.ModuleType):
    """``jax``, but ``default_backend()`` reads "tpu" at the fused-SSIM
    check alone."""

    def __getattr__(self, name):
        return getattr(jax, name)

    def default_backend(self):
        return "tpu" if sys._getframe(1).f_lineno == FUSED_SSIM_CHECK else jax.default_backend()


def numpy_variables(init_fn, seed):
    """Variables shaped like ``init_fn(key)``, drawn with numpy (kernels
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), norm scales and BN statistics
    around 1 and 0, small biases)."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
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
        return {k: walk(v) if hasattr(v, "items") else draw(k, v.shape).astype(np.float32)
                for k, v in tree.items()}

    return walk(shapes)


def route_gap(dtype, seed_weights, seed_batch):
    opt = parse_options(ARGS + ["--compute_dtype", dtype])
    models = build_models(opt, train=True)
    models = dataclasses.replace(models, depth=models.depth.clone(deterministic=True))
    variables = numpy_variables(lambda key: init_params(opt, models, key), seed_weights)
    batch = make_batch(2, 64, 128, seed=seed_batch)
    batch.pop("depth_gt")

    def loss_fn(params):
        return pipeline.forward(models, params, variables["batch_stats"], batch, None, opt)

    results = {}
    for route in ("xla", "pallas"):
        if route == "pallas":
            pipeline.jax = _SsimOnTpu("jax")
        try:
            with pltpu.force_tpu_interpret_mode():
                (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                    variables["params"])
        finally:
            pipeline.jax = jax
        results[route] = float(loss), {
            name: np.concatenate([np.asarray(x, np.float64).ravel()
                                  for x in jax.tree_util.tree_leaves(tree)])
            for name, tree in grads.items()}
    (loss_x, grads_x), (loss_p, grads_p) = results["xla"], results["pallas"]
    gaps = {k: float(np.linalg.norm(grads_p[k] - grads_x[k]) / np.linalg.norm(grads_x[k]))
            for k in grads_x}
    print(f"{dtype}, weights seed {seed_weights}, batch seed {seed_batch}: loss XLA "
          f"{loss_x:.7f}, Pallas {loss_p:.7f} (rel {abs(loss_p - loss_x) / abs(loss_x):.3e}); "
          f"gradient rel-norm gaps { {k: float(f'{v:.4e}') for k, v in gaps.items()} }",
          flush=True)


if __name__ == "__main__":
    for dtype in ("bfloat16", "float32"):
        for seeds in ((7, 3), (8, 4)):
            route_gap(dtype, *seeds)
