"""Gradient accumulation (``training/step.Accumulation``) against
``optax.MultiSteps(optax.adam)`` when a parameter has no gradient.

A toy model of two parameters, ``a`` and ``b``, over two accumulation
cycles of k = 2 micro-steps: ``b`` is missing from the first micro-step
(PyTorch leaves its ``.grad`` None, JAX gives it zeros) and from the whole
second cycle. optax averages from zeros, so ``b`` gets g / 2 in the first
cycle, and its Adam still decays the moments and moves ``b`` in the
second. The same numpy values drive both; float32 on both sides, so the
parameters agree to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import optax
import torch

from sfmnext_tpu_torch.training.step import Accumulation
from test_torch_models import _one_thread  # noqa: F401


LR = 1e-2
EVERY = 2


def test_missing_gradient_matches_optax_multisteps():
    rng = np.random.RandomState(0)
    init = {"a": rng.randn(3).astype(np.float32), "b": rng.randn(2).astype(np.float32)}
    # per micro-step: the loss's inputs for a and b (None: not in the loss)
    inputs = [(rng.randn(3), None), (rng.randn(3), rng.randn(2)),
              (rng.randn(3), None), (rng.randn(3), None)]
    inputs = [tuple(None if x is None else x.astype(np.float32) for x in pair)
              for pair in inputs]

    params = {k: torch.tensor(v, requires_grad=True) for k, v in init.items()}
    adam = torch.optim.Adam(list(params.values()), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    scheduler = torch.optim.lr_scheduler.LambdaLR(adam, lambda _: 1.0)
    accumulation = Accumulation(adam, scheduler, every=EVERY)

    tx = optax.MultiSteps(optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8), every_k_schedule=EVERY)
    ref = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(ref)

    for i, (xa, xb) in enumerate(inputs):
        accumulation.zero_grad()
        loss = (params["a"] * torch.from_numpy(xa)).sum()
        if xb is not None:
            loss = loss + (params["b"] * torch.from_numpy(xb)).sum()
        loss.backward()
        assert (params["b"].grad is None) == (xb is None)
        moved = accumulation.step()
        assert moved == ((i + 1) % EVERY == 0)

        # d loss / d a = xa, d loss / d b = xb, or zeros where b is absent
        grads = {"a": jnp.asarray(xa),
                 "b": jnp.asarray(xb if xb is not None else np.zeros(2, np.float32))}
        updates, state = tx.update(grads, state, ref)
        ref = optax.apply_updates(ref, updates)

        for k in params:
            np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(ref[k]),
                                       rtol=0, atol=1e-6, err_msg=f"{k} after micro-step {i}")
    # the second cycle moved b on zero gradients alone, through Adam's moments
    assert not np.allclose(params["b"].detach().numpy(), init["b"])
