"""sfmnext_tpu_torch — the SQLdepth port to PyTorch and CUDA (NVIDIA H100).

The JAX package ``sfmnext_tpu`` is the reference this package is held
against; the file layout mirrors it, so each counterpart sits where the
JAX module does (``models/resnet.py``, ``ops/sql_attention.py``, ...).

Ported so far:
  * the bf16 single-image inference path (``sql_depth.SQLdepth``): ResNet
    encoder + DecoderBN + the SQL decoder;
  * the outdoor and indoor self-supervised training steps
    (``training/{builder,pipeline,indoor,step}.py``) with on-device
    augmentation, the eval step and depth inference;
  * the trainer surface (``training/trainer.py``, ``train.py``,
    ``train_indoor.py``: the epoch loop, validation, depth metrics,
    logging, checkpoints and resume) and the synthetic-convergence gate
    (``tools/synthetic_convergence.py``);
  * the datasets (``data/``: KITTI, NYU, MannequinChallenge, Cityscapes)
    and the evaluation (``evaluation.py``, ``evaluate_depth_config.py``,
    ``export_gt_depth.py``, ``tools/evaluate_depth_cityscapes_config.py``),
    float32 as in the JAX package, so it runs none of the kernels below.
Their TPU kernels run as hand-written Hopper kernels (``csrc/*.cu``,
wrapped by ``ops/*_kernel.py``), forward and backward: the SQL decoder's
two fused ops, the warp, the SSIM loss and the ColorJitter.

Conventions:
  * public entry points keep the JAX layout: images ``[B,H,W,3]`` in
    [0,1], depth ``[B,H,W,1]``; modules run NCHW inside;
  * ``nn.Module`` state-dict names are the reference's (the ``.pth``
    files of the reference and of ``utils/torch_export.py``'s name maps
    load ``strict=True``);
  * weights initialise from a ``torch.Generator`` seeded from ``opt.seed``;
  * the package imports ``torch`` and never ``jax``, and nothing of the
    JAX package ``sfmnext_tpu``: it keeps its own copies of what it needs
    from there (``config.py``, ``utils/torch_export.py``, ``data/*``).
"""
