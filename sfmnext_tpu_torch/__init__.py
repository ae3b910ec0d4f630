"""sfmnext_tpu_torch — the SQLdepth port to PyTorch and CUDA (NVIDIA H100).

The JAX package ``sfmnext_tpu`` is the reference this package is held
against; the file layout mirrors it, so each counterpart sits where the
JAX module does (``models/resnet.py``, ``ops/sql_attention.py``, ...).

What is ported so far is the bf16 single-image inference path
(``sql_depth.SQLdepth``): ResNet encoder + DecoderBN + the SQL decoder,
whose two fused ops run as hand-written Hopper kernels
(``csrc/sql_kernel.cu``, wrapped by ``ops/sql_kernel.py``).

Conventions:
  * public entry points keep the JAX layout: images ``[B,H,W,3]`` in
    [0,1], depth ``[B,H,W,1]``; modules run NCHW inside;
  * ``nn.Module`` state-dict names are the reference's (the ``.pth``
    files ``sfmnext_tpu.utils.torch_export`` writes load ``strict=True``);
  * weights initialise from a ``torch.Generator`` seeded from ``opt.seed``;
  * the package imports ``torch`` and never ``jax``; of the JAX package it
    imports only the JAX-free ``sfmnext_tpu.config`` and
    ``sfmnext_tpu.utils.torch_export``.
"""
