"""Name maps from the JAX package's parameter trees to the reference's
state-dict keys, in numpy only.

The port's own copy of the maps it needs from
``sfmnext_tpu/utils/torch_export.py`` (the ResNet, EfficientNet-B5 and
ConvNeXt-Unet encoder-decoders, SQL decoder, PoseCNN, RectifyNet), with
maps of its own for the trees that file does not export (the PoseDecoder,
the separate ResNet-18 pose encoder, the predictive mask), so that loading
JAX-trained weights imports nothing of the JAX package. The trees are nested dicts of arrays (anything ``np.asarray``
takes); flax's ``HWIO`` convolution kernels become ``OIHW`` and dense
kernels are transposed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _conv_w(k) -> np.ndarray:
    return np.transpose(np.asarray(k), (3, 2, 0, 1))  # HWIO -> OIHW


def _lin_w(k) -> np.ndarray:
    return np.transpose(np.asarray(k), (1, 0))


def _put_conv(sd, dst, node):
    sd[dst + ".weight"] = _conv_w(node["kernel"])
    if "bias" in node:
        sd[dst + ".bias"] = np.asarray(node["bias"])


def _put_bn(sd, dst, pnode, snode):
    sd[dst + ".weight"] = np.asarray(pnode["scale"])
    sd[dst + ".bias"] = np.asarray(pnode["bias"])
    sd[dst + ".running_mean"] = np.asarray(snode["mean"])
    sd[dst + ".running_var"] = np.asarray(snode["var"])


def _put_ln(sd, dst, node):
    sd[dst + ".weight"] = np.asarray(node["scale"])
    sd[dst + ".bias"] = np.asarray(node["bias"])


def _put_decoder_bn(sd, dec_p, dec_s) -> None:
    """A DecoderBN tree under ``decoder.``."""
    _put_conv(sd, "decoder.conv2", dec_p["conv2"]["Conv_0"])
    _put_conv(sd, "decoder.conv3", dec_p["conv3"]["Conv_0"])
    for u in range(1, 5):
        up_p, up_s = dec_p[f"up{u}"], dec_s[f"up{u}"]
        _put_conv(sd, f"decoder.up{u}._net.0", up_p["conv_a"]["Conv_0"])
        _put_bn(sd, f"decoder.up{u}._net.1", up_p["bn_a"]["BatchNorm_0"],
                up_s["bn_a"]["BatchNorm_0"])
        _put_conv(sd, f"decoder.up{u}._net.3", up_p["conv_b"]["Conv_0"])
        _put_bn(sd, f"decoder.up{u}._net.4", up_p["bn_b"]["BatchNorm_0"],
                up_s["bn_b"]["BatchNorm_0"])


def _blocks(tree, prefix):
    """{stage: number of blocks} of the tree's ``<prefix><si>_block<bi>`` names."""
    depths: Dict[int, int] = {}
    for name in tree:
        if name.startswith(prefix) and "_block" in name:
            si, bi = name[len(prefix):].split("_block")
            depths[int(si)] = max(depths.get(int(si), 0), int(bi) + 1)
    return [depths[si] for si in sorted(depths)]


def _put_resnet(sd, prefix, params, batch_stats) -> None:
    """A ResNetEncoder tree under torchvision's names after ``prefix``."""
    _put_conv(sd, prefix + "conv1", params["conv1"])
    _put_bn(sd, prefix + "bn1", params["bn1"]["BatchNorm_0"],
            batch_stats["bn1"]["BatchNorm_0"])
    for name, blk in params.items():
        if not name.startswith("layer"):
            continue
        stage, idx = name.replace("layer", "").split("_")
        dst = f"{prefix}layer{stage}.{idx}"
        for c in ("conv1", "conv2", "conv3"):
            if c in blk:
                _put_conv(sd, f"{dst}.{c}", blk[c])
        for b in ("bn1", "bn2", "bn3"):
            if b in blk:
                _put_bn(sd, f"{dst}.{b}", blk[b]["BatchNorm_0"],
                        batch_stats[name][b]["BatchNorm_0"])
        if "down_conv" in blk:
            _put_conv(sd, f"{dst}.downsample.0", blk["down_conv"])
            _put_bn(sd, f"{dst}.downsample.1", blk["down_bn"]["BatchNorm_0"],
                    batch_stats[name]["down_bn"]["BatchNorm_0"])


def export_resnet_encoder_decoder(params, batch_stats) -> Dict[str, np.ndarray]:
    """ResnetEncoderDecoder tree -> reference state-dict keys."""
    sd: Dict[str, np.ndarray] = {}
    _put_resnet(sd, "encoder.encoder.", params["encoder"], batch_stats["encoder"])
    _put_decoder_bn(sd, params["decoder"], batch_stats["decoder"])
    return sd


def _put_efficientnet(sd, prefix, params, batch_stats) -> None:
    """An EfficientNet tree under gen-efficientnet's names (``conv_stem``,
    ``bn1``, ``blocks.<stage>.<block>.*``, ``conv_head``) after ``prefix``;
    the blocks are read off the tree's ``stage<i>_block<j>`` names."""
    _put_conv(sd, prefix + "conv_stem", params["conv_stem"])
    _put_bn(sd, prefix + "bn1", params["bn1"]["BatchNorm_0"],
            batch_stats["bn1"]["BatchNorm_0"])
    for si, depth in enumerate(_blocks(params, "stage")):
        for bi in range(depth):
            p = params[f"stage{si}_block{bi}"]
            s = batch_stats[f"stage{si}_block{bi}"]
            dst = f"{prefix}blocks.{si}.{bi}"
            if "expand_conv" not in p:
                names = [("conv_dw", "dw_conv", "bn1", "dw_bn"),
                         ("conv_pw", "project_conv", "bn2", "project_bn")]
            else:
                names = [("conv_pw", "expand_conv", "bn1", "expand_bn"),
                         ("conv_dw", "dw_conv", "bn2", "dw_bn"),
                         ("conv_pwl", "project_conv", "bn3", "project_bn")]
            for t_conv, f_conv, t_bn, f_bn in names:
                _put_conv(sd, f"{dst}.{t_conv}", p[f_conv])
                _put_bn(sd, f"{dst}.{t_bn}", p[f_bn]["BatchNorm_0"], s[f_bn]["BatchNorm_0"])
            _put_conv(sd, f"{dst}.se.conv_reduce", p["se_reduce"])
            _put_conv(sd, f"{dst}.se.conv_expand", p["se_expand"])
    _put_conv(sd, prefix + "conv_head", params["conv_head"])


def export_base_encoder_decoder(params, batch_stats) -> Dict[str, np.ndarray]:
    """BaseEncoderDecoder (eff_b5) tree -> reference ``encoder.pth`` keys."""
    sd: Dict[str, np.ndarray] = {}
    _put_efficientnet(sd, "encoder.original_model.", params["encoder"], batch_stats["encoder"])
    _put_decoder_bn(sd, params["decoder"], batch_stats["decoder"])
    return sd


def export_convnext_unet(params, batch_stats) -> Dict[str, np.ndarray]:
    """Unet(convnext_*) tree -> reference ``encoder.pth`` keys (timm
    ``encoder.*``, ``decoder.blocks.<i>.conv<j>.{conv,bn}``,
    ``decoder.final_conv``); the encoder's blocks are read off the tree's
    ``stage<i>_block<j>`` names."""
    sd: Dict[str, np.ndarray] = {}
    enc = params["encoder"]
    _put_conv(sd, "encoder.stem.0", enc["stem_conv"])
    _put_ln(sd, "encoder.stem.1", enc["stem_norm"])
    for si, depth in enumerate(_blocks(enc, "stage")):
        if si > 0:
            _put_ln(sd, f"encoder.stages.{si}.downsample.0", enc[f"down{si}_norm"])
            _put_conv(sd, f"encoder.stages.{si}.downsample.1", enc[f"down{si}_conv"])
        for bi in range(depth):
            blk = enc[f"stage{si}_block{bi}"]
            dst = f"encoder.stages.{si}.blocks.{bi}"
            _put_conv(sd, f"{dst}.dwconv", blk["dwconv"])
            _put_ln(sd, f"{dst}.norm", blk["norm"])
            for pw in ("pwconv1", "pwconv2"):
                sd[f"{dst}.{pw}.weight"] = _lin_w(blk[pw]["kernel"])
                sd[f"{dst}.{pw}.bias"] = np.asarray(blk[pw]["bias"])
            sd[f"{dst}.gamma"] = np.asarray(blk["gamma"])
    dec_p, dec_s = params["decoder"], batch_stats["decoder"]
    for i in range(sum(1 for k in dec_p if k.startswith("block"))):
        for c in (1, 2):
            node = dec_p[f"block{i}"][f"conv{c}"]
            dst = f"decoder.blocks.{i}.conv{c}"
            _put_conv(sd, f"{dst}.conv", node["conv"])
            _put_bn(sd, f"{dst}.bn", node["bn"]["BatchNorm_0"],
                    dec_s[f"block{i}"][f"conv{c}"]["bn"]["BatchNorm_0"])
    _put_conv(sd, "decoder.final_conv", dec_p["final_conv"])
    return sd


def export_encoder(params, batch_stats) -> Dict[str, np.ndarray]:
    """Any depth encoder-decoder tree the port builds, by its trunk's names:
    a ResNet (``conv1``), an EfficientNet (``conv_stem``) or a ConvNeXt
    (``stem_conv``)."""
    trunk = params["encoder"]
    if "conv_stem" in trunk:
        return export_base_encoder_decoder(params, batch_stats)
    if "stem_conv" in trunk:
        return export_convnext_unet(params, batch_stats)
    return export_resnet_encoder_decoder(params, batch_stats)


def export_sql_decoder(params) -> Dict[str, np.ndarray]:
    """SQLDecoder tree -> reference ``depth.pth`` keys (4 heads packed
    into torch's ``in_proj``)."""
    sd: Dict[str, np.ndarray] = {}
    _put_conv(sd, "embedding_convPxP", params["embedding_convPxP"]["Conv_0"])
    sd["positional_encodings"] = np.asarray(params["positional_encodings"])
    _put_conv(sd, "conv3x3", params["conv3x3"]["Conv_0"])

    for i in range(4):
        lp = params[f"tf_layer{i}"]
        dst = f"transformer_encoder.layers.{i}"
        attn = lp["self_attn"]
        e = np.asarray(attn["query"]["kernel"]).shape[0]

        def unproj(node):
            w = np.asarray(node["kernel"]).reshape(e, e)  # [E_in, E_out]
            return np.transpose(w, (1, 0)), np.asarray(node["bias"]).reshape(e)

        qw, qb = unproj(attn["query"])
        kw, kb = unproj(attn["key"])
        vw, vb = unproj(attn["value"])
        sd[f"{dst}.self_attn.in_proj_weight"] = np.concatenate([qw, kw, vw], 0)
        sd[f"{dst}.self_attn.in_proj_bias"] = np.concatenate([qb, kb, vb], 0)
        ow = np.asarray(attn["out"]["kernel"]).reshape(e, e)
        sd[f"{dst}.self_attn.out_proj.weight"] = np.transpose(ow, (1, 0))
        sd[f"{dst}.self_attn.out_proj.bias"] = np.asarray(attn["out"]["bias"])
        for name in ("linear1", "linear2"):
            sd[f"{dst}.{name}.weight"] = _lin_w(lp[name]["Dense_0"]["kernel"])
            sd[f"{dst}.{name}.bias"] = np.asarray(lp[name]["Dense_0"]["bias"])
        for norm in ("norm1", "norm2"):
            sd[f"{dst}.{norm}.weight"] = np.asarray(lp[norm]["scale"])
            sd[f"{dst}.{norm}.bias"] = np.asarray(lp[norm]["bias"])

    for j, name in ((0, "bins_reg1"), (2, "bins_reg2"), (4, "bins_reg3")):
        sd[f"bins_regressor.{j}.weight"] = _lin_w(params[name]["Dense_0"]["kernel"])
        sd[f"bins_regressor.{j}.bias"] = np.asarray(params[name]["Dense_0"]["bias"])

    w = np.asarray(params["prob_kernel"])  # [Q,D]
    sd["convert_to_prob.0.weight"] = np.transpose(w, (1, 0))[:, :, None, None]
    sd["convert_to_prob.0.bias"] = np.asarray(params["prob_bias"])
    return sd


def export_pose_cnn(params) -> Dict[str, np.ndarray]:
    """PoseCNN tree -> reference ``pose.pth`` keys (``net.<i>``, ``pose_conv``)."""
    sd: Dict[str, np.ndarray] = {}
    for i in range(7):
        _put_conv(sd, f"net.{i}", params[f"conv{i}"]["Conv_0"])
    _put_conv(sd, "pose_conv", params["pose_conv"]["Conv_0"])
    return sd


def export_pose_decoder(params) -> Dict[str, np.ndarray]:
    """PoseDecoder tree -> reference ``pose.pth`` keys (monodepth2's
    ``net.<i>``: squeeze, pose_0, pose_1, pose_2)."""
    sd: Dict[str, np.ndarray] = {}
    for i, name in enumerate(("squeeze", "pose_0", "pose_1", "pose_2")):
        _put_conv(sd, f"net.{i}", params[name]["Conv_0"])
    return sd


def export_pose(params) -> Dict[str, np.ndarray]:
    """Either pose head by its tree's names: a PoseCNN (``pose_conv``) or
    a PoseDecoder (``squeeze``)."""
    return export_pose_cnn(params) if "pose_conv" in params else export_pose_decoder(params)


def export_pose_encoder(params, batch_stats) -> Dict[str, np.ndarray]:
    """The separate_resnet pose encoder (a ResNetEncoder over the stacked
    pose frames) -> reference ``pose_encoder.pth`` keys (``encoder.*``)."""
    sd: Dict[str, np.ndarray] = {}
    _put_resnet(sd, "encoder.", params, batch_stats)
    return sd


def export_predictive_mask(params) -> Dict[str, np.ndarray]:
    """PredictiveMask tree -> ``predictive_mask.pth`` keys (monodepth2's
    decoder layout: ``decoder.<i>.conv.conv`` for the blocks upconv_4_0 ..
    upconv_0_1, then ``decoder.<10+j>.conv`` for the heads, scales
    ascending)."""
    sd: Dict[str, np.ndarray] = {}
    for j, i in enumerate(range(4, -1, -1)):
        for k in (0, 1):
            _put_conv(sd, f"decoder.{2 * j + k}.conv.conv",
                      params[f"upconv_{i}_{k}"]["TorchConv_0"]["Conv_0"])
    scales = sorted(int(name.split("_")[1]) for name in params if name.startswith("maskconv_"))
    for j, scale in enumerate(scales):
        _put_conv(sd, f"decoder.{10 + j}.conv", params[f"maskconv_{scale}"]["Conv_0"])
    return sd


def export_rectify_net(params, batch_stats) -> Dict[str, np.ndarray]:
    """RectifyNet tree -> reference ``rectify.pth`` keys
    (networks/rectify_net.py: ``encoder.encoder.*``,
    ``decoder.conv_squeeze``, ``decoder.convs_pose.<i>``)."""
    sd: Dict[str, np.ndarray] = {}
    _put_resnet(sd, "encoder.encoder.", params["encoder"], batch_stats["encoder"])
    dec = params["decoder"]
    _put_conv(sd, "decoder.conv_squeeze", dec["squeeze"]["Conv_0"])
    for i in range(3):
        _put_conv(sd, f"decoder.convs_pose.{i}", dec[f"pose_{i}"]["Conv_0"])
    return sd
