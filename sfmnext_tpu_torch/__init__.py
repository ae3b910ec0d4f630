"""sfmnext_tpu_torch — the SQLdepth port to PyTorch and CUDA (NVIDIA H100).

The JAX package ``sfmnext_tpu`` is the reference this package is held
against; the file layout mirrors it, so each counterpart sits where the
JAX module does (``models/resnet.py``, ``ops/sql_attention.py``, ...).

Ported so far:
  * the bf16 single-image inference path (``sql_depth.SQLdepth``): ResNet
    encoder + DecoderBN + the SQL decoder;
  * the self-supervised training step without SSIM and without on-device
    augmentation (``training/{builder,pipeline,step}.py``): PoseCNN,
    geometry, the border warp, the L1 min-reprojection loss with
    automasking, edge-aware smoothness, Adam with the step schedule.
Their TPU kernels run as hand-written Hopper kernels, forward and
backward: the SQL decoder's two fused ops (``csrc/sql_kernel.cu``, wrapped
by ``ops/sql_kernel.py``) and the warp (``csrc/warp_kernel.cu``,
``ops/warp_kernel.py``).

Conventions:
  * public entry points keep the JAX layout: images ``[B,H,W,3]`` in
    [0,1], depth ``[B,H,W,1]``; modules run NCHW inside;
  * ``nn.Module`` state-dict names are the reference's (the ``.pth``
    files of the reference and of ``utils/torch_export.py``'s name maps
    load ``strict=True``);
  * weights initialise from a ``torch.Generator`` seeded from ``opt.seed``;
  * the package imports ``torch`` and never ``jax``, and nothing of the
    JAX package ``sfmnext_tpu``: it keeps its own copies of what it needs
    from there (``config.py``, ``utils/torch_export.py``,
    ``data/synthetic.py``).
"""
