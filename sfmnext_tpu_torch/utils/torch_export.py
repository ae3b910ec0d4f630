"""Name maps from the JAX package's parameter trees to the reference's
state-dict keys, in numpy only.

The port's own copy of the maps it needs from
``sfmnext_tpu/utils/torch_export.py`` (ResNet encoder-decoder, SQL decoder,
PoseCNN, RectifyNet), so that loading JAX-trained weights imports nothing of the JAX
package. The trees are nested dicts of arrays (anything ``np.asarray``
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

    dec_p, dec_s = params["decoder"], batch_stats["decoder"]
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
    return sd


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
