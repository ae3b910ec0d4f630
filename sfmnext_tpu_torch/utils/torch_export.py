"""Name maps from the JAX package's parameter trees to the reference's
state-dict keys, in numpy (a ResNet variant's name is read by
``models/unet.parse_resnet_variant``).

The port's own copy of the maps it needs from
``sfmnext_tpu/utils/torch_export.py`` (the ResNet, EfficientNet-B5 and
ConvNeXt-Unet encoder-decoders, SQL decoder, PoseCNN, RectifyNet), with
maps of its own for the trees that file does not export (the Unet's
ResNet-family trunks, the PoseDecoder, the separate ResNet-18 pose
encoder, the predictive mask), so that loading
JAX-trained weights imports nothing of the JAX package. The trees are nested dicts of arrays (anything ``np.asarray``
takes); flax's ``HWIO`` convolution kernels become ``OIHW`` and dense
kernels are transposed.
"""

from __future__ import annotations

import re
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


def _put_unet_decoder(sd, dec_p, dec_s) -> None:
    """The Unet's decoder under ``decoder.blocks.<i>.conv<j>.{conv,bn}`` and
    ``decoder.final_conv``."""
    for i in range(sum(1 for k in dec_p if k.startswith("block"))):
        for c in (1, 2):
            node = dec_p[f"block{i}"][f"conv{c}"]
            dst = f"decoder.blocks.{i}.conv{c}"
            _put_conv(sd, f"{dst}.conv", node["conv"])
            _put_bn(sd, f"{dst}.bn", node["bn"]["BatchNorm_0"],
                    dec_s[f"block{i}"][f"conv{c}"]["bn"]["BatchNorm_0"])
    _put_conv(sd, "decoder.final_conv", dec_p["final_conv"])


def _put_convnext(sd, prefix, enc) -> None:
    """A ConvNeXt trunk under timm's names; the blocks are read off the
    tree's ``stage<i>_block<j>`` names."""
    _put_conv(sd, prefix + "stem.0", enc["stem_conv"])
    _put_ln(sd, prefix + "stem.1", enc["stem_norm"])
    for si, depth in enumerate(_blocks(enc, "stage")):
        if si > 0:
            _put_ln(sd, f"{prefix}stages.{si}.downsample.0", enc[f"down{si}_norm"])
            _put_conv(sd, f"{prefix}stages.{si}.downsample.1", enc[f"down{si}_conv"])
        for bi in range(depth):
            blk = enc[f"stage{si}_block{bi}"]
            dst = f"{prefix}stages.{si}.blocks.{bi}"
            _put_conv(sd, f"{dst}.dwconv", blk["dwconv"])
            _put_ln(sd, f"{dst}.norm", blk["norm"])
            for pw in ("pwconv1", "pwconv2"):
                sd[f"{dst}.{pw}.weight"] = _lin_w(blk[pw]["kernel"])
                sd[f"{dst}.{pw}.bias"] = np.asarray(blk[pw]["bias"])
            sd[f"{dst}.gamma"] = np.asarray(blk["gamma"])


def export_convnext_unet(params, batch_stats) -> Dict[str, np.ndarray]:
    """Unet(convnext_*) tree -> reference ``encoder.pth`` keys (timm
    ``encoder.*``, ``decoder.blocks.<i>.conv<j>.{conv,bn}``,
    ``decoder.final_conv``)."""
    sd: Dict[str, np.ndarray] = {}
    _put_convnext(sd, "encoder.", params["encoder"])
    _put_unet_decoder(sd, params["decoder"], batch_stats["decoder"])
    return sd


def _put_norm(sd, dst, pnode, snode) -> None:
    """A BatchNorm (``{"BatchNorm_0": ...}``, statistics in ``snode``), a
    GroupNorm (``scale`` / ``bias``) or an EvoNorm-S0 (and ``v``)."""
    if "BatchNorm_0" in pnode:
        _put_bn(sd, dst, pnode["BatchNorm_0"], snode["BatchNorm_0"])
        return
    _put_ln(sd, dst, pnode)
    if "v" in pnode:
        sd[dst + ".v"] = np.asarray(pnode["v"])


def _layers(tree):
    """The tree's ``layer<s>_<i>`` blocks as (name, "layer<s>.<i>")."""
    out = []
    for name in tree:
        m = re.fullmatch(r"layer(\d+)_(\d+)", name)
        if m:
            out.append((int(m.group(1)), int(m.group(2)), name))
    return [(name, f"layer{s}.{i}") for s, i, name in sorted(out)]


def _put_shortcut(sd, dst, p, s, after_pool) -> None:
    if "down_conv" in p:
        j = 1 if after_pool else 0
        _put_conv(sd, f"{dst}.downsample.{j}", p["down_conv"])
        _put_norm(sd, f"{dst}.downsample.{j + 1}", p["down_bn"], s.get("down_bn"))


def _put_resnet(sd, prefix, enc, stats, avg_down=False) -> None:
    """A ``ResNet`` trunk of any variant under torchvision's and timm's names
    after ``prefix``; ``avg_down``: the shortcut after its pool
    (``downsample.{1,2}``), which the tree does not show."""
    if "conv1_0" in enc:  # the deep stem: conv1.{0,3,6} with conv1.{1,4} and bn1
        for i, (c, b) in enumerate((("conv1.0", "conv1.1"), ("conv1.3", "conv1.4"),
                                    ("conv1.6", "bn1"))):
            _put_conv(sd, prefix + c, enc[f"conv1_{i}"])
            _put_norm(sd, prefix + b, enc[f"bn1_{i}"], stats.get(f"bn1_{i}"))
    else:
        _put_conv(sd, prefix + "conv1", enc["conv1"])
        _put_norm(sd, prefix + "bn1", enc["bn1"], stats.get("bn1"))
    if "stem_pool_conv" in enc:
        _put_conv(sd, prefix + "maxpool.0", enc["stem_pool_conv"])
        _put_norm(sd, prefix + "maxpool.1", enc["stem_pool_bn"], stats.get("stem_pool_bn"))
    for name, dst in _layers(enc):
        p, s = enc[name], stats.get(name, {})
        dst = prefix + dst
        for k in (1, 2, 3):
            if f"conv{k}" in p:
                _put_conv(sd, f"{dst}.conv{k}", p[f"conv{k}"])
                _put_norm(sd, f"{dst}.bn{k}", p[f"bn{k}"], s.get(f"bn{k}"))
        if "se_fc1" in p:
            _put_conv(sd, f"{dst}.se.fc1", p["se_fc1"])
            _put_conv(sd, f"{dst}.se.fc2", p["se_fc2"])
        if "eca_conv" in p:  # flax [k, 1, 1] -> Conv1d [1, 1, k]
            sd[f"{dst}.se.conv.weight"] = np.transpose(np.asarray(p["eca_conv"]["kernel"]),
                                                       (2, 1, 0))
        _put_shortcut(sd, dst, p, s, avg_down)


def _put_senet154(sd, prefix, enc, stats) -> None:
    for i in range(3 if "stem0" in enc else 0):
        _put_conv(sd, f"{prefix}layer0.conv{i + 1}", enc[f"stem{i}"])
        _put_norm(sd, f"{prefix}layer0.bn{i + 1}", enc[f"stem{i}_bn"], stats[f"stem{i}_bn"])
    for name, dst in _layers(enc):
        p, s = enc[name], stats[name]
        dst = prefix + dst
        for k in (1, 2, 3):
            _put_conv(sd, f"{dst}.conv{k}", p[f"conv{k}"])
            _put_norm(sd, f"{dst}.bn{k}", p[f"bn{k}"], s[f"bn{k}"])
        _put_conv(sd, f"{dst}.se_module.fc1", p["se_fc1"])
        _put_conv(sd, f"{dst}.se_module.fc2", p["se_fc2"])
        _put_shortcut(sd, dst, p, s, False)


def _put_resnest(sd, prefix, enc, stats) -> None:
    stem = (("conv1.0", "conv1.1"), ("conv1.3", "conv1.4"), ("conv1.6", "bn1"))
    for i, (c, b) in enumerate(stem if "conv1_0" in enc else ()):
        _put_conv(sd, prefix + c, enc[f"conv1_{i}"])
        _put_norm(sd, prefix + b, enc[f"bn1_{i}"], stats[f"bn1_{i}"])
    for name, dst in _layers(enc):
        p, s = enc[name], stats[name]
        dst = prefix + dst
        _put_conv(sd, f"{dst}.conv1", p["conv1"])
        _put_norm(sd, f"{dst}.bn1", p["bn1"], s["bn1"])
        sa_p, sa_s = p["conv2"], s["conv2"]
        for c in ("conv", "fc1", "fc2"):
            _put_conv(sd, f"{dst}.conv2.{c}", sa_p[c])
        for b in ("bn0", "bn1"):
            _put_norm(sd, f"{dst}.conv2.{b}", sa_p[b], sa_s[b])
        _put_conv(sd, f"{dst}.conv3", p["conv3"])
        _put_norm(sd, f"{dst}.bn3", p["bn3"], s["bn3"])
        _put_shortcut(sd, dst, p, s, True)


def _put_res2net(sd, prefix, enc, stats) -> None:
    if "conv1" in enc:
        _put_conv(sd, prefix + "conv1", enc["conv1"])
        _put_norm(sd, prefix + "bn1", enc["bn1"], stats["bn1"])
    for name, dst in _layers(enc):
        p, s = enc[name], stats[name]
        dst = prefix + dst
        for k in (1, 3):
            _put_conv(sd, f"{dst}.conv{k}", p[f"conv{k}"])
            _put_norm(sd, f"{dst}.bn{k}", p[f"bn{k}"], s[f"bn{k}"])
        i = 0
        while f"conv2_{i}" in p:
            _put_conv(sd, f"{dst}.convs.{i}", p[f"conv2_{i}"])
            _put_norm(sd, f"{dst}.bns.{i}", p[f"bn2_{i}"], s[f"bn2_{i}"])
            i += 1
        _put_shortcut(sd, dst, p, s, False)


def _put_sknet(sd, prefix, enc, stats) -> None:
    if "conv1" in enc:
        _put_conv(sd, prefix + "conv1", enc["conv1"])
        _put_norm(sd, prefix + "bn1", enc["bn1"], stats["bn1"])
    for name, dst in _layers(enc):
        p, s = enc[name], stats[name]
        dst = prefix + dst
        basic = "conv2" in p  # the basic block: SK in place of conv1, then conv2/bn2
        sk = f"{dst}.conv1" if basic else f"{dst}.conv2"
        for j in (0, 1):
            _put_conv(sd, f"{sk}.paths.{j}.conv", p["sk"][f"path{j}_conv"])
            _put_norm(sd, f"{sk}.paths.{j}.bn", p["sk"][f"path{j}_bn"], s["sk"][f"path{j}_bn"])
        _put_conv(sd, f"{sk}.attn.fc_reduce", p["sk"]["attn_reduce"])
        _put_norm(sd, f"{sk}.attn.bn", p["sk"]["attn_bn"], s["sk"]["attn_bn"])
        _put_conv(sd, f"{sk}.attn.fc_select", p["sk"]["attn_select"])
        for k in ((2,) if basic else (1, 3)):
            _put_conv(sd, f"{dst}.conv{k}.conv", p[f"conv{k}"])
            _put_norm(sd, f"{dst}.conv{k}.bn", p[f"bn{k}"], s[f"bn{k}"])
        _put_shortcut(sd, dst, p, s, False)


def _put_resnetv2(sd, prefix, enc, stats) -> None:
    def conv(dst, node):  # a WSConv holds its kernel, a plain conv one under "conv"
        _put_conv(sd, dst, node.get("conv", node))

    if "stem0" in enc:
        for i in range(3):
            conv(f"{prefix}stem.conv{i + 1}", enc[f"stem{i}"])
    elif "stem" in enc:
        conv(prefix + "stem.conv", enc["stem"])

    def norm(dst, pnode, snode):  # _NormAct's norm under "norm", EvoNorm's params bare
        _put_norm(sd, dst, pnode.get("norm", pnode), (snode or {}).get("norm"))

    for si, depth in enumerate(_blocks(enc, "stage")):
        for bi in range(depth):
            name = f"stage{si}_block{bi}"
            p, s = enc[name], stats.get(name, {})
            dst = f"{prefix}stages.{si}.blocks.{bi}"
            for k, jax_norm in ((1, "preact"), (2, "na1"), (3, "na2")):
                norm(f"{dst}.norm{k}", p[jax_norm], s.get(jax_norm))
                conv(f"{dst}.conv{k}", p[f"conv{k}"])
            if "down_conv" in p:
                conv(f"{dst}.downsample.conv", p["down_conv"])
    if "norm" in enc:
        norm(prefix + "norm", enc["norm"], stats.get("norm"))


def _resnet_family_avg_down(backbone) -> bool:
    from sfmnext_tpu_torch.models.unet import parse_resnet_variant, strip_weight_alias

    return parse_resnet_variant(strip_weight_alias(backbone))["avg_down"]


def _family(enc) -> str:
    """The family of a Unet trunk's tree, by its names."""
    first = next(iter(_layers(enc)), (None,))[0]
    block = enc.get(first, {})
    if "stem_conv" in enc:
        return "convnext"
    if "stage0_block0" in enc:
        return "resnetv2"
    if "stem0_bn" in enc:
        return "senet154"
    if isinstance(block.get("conv2"), dict) and "fc1" in block["conv2"]:
        return "resnest"
    if "conv2_0" in block:
        return "res2net"
    if "sk" in block:
        return "sknet"
    return "resnet"


def export_trunk(params, batch_stats, avg_down=None, prefix: str = "") -> Dict[str, np.ndarray]:
    """A Unet trunk's tree (any family the port builds, or a part of one:
    a stem is optional) -> timm's names after ``prefix``, the family told
    by the tree's names. A ResNet variant's shortcut layout, which its tree
    does not show, is ``avg_down``, a bool for such a tree."""
    sd: Dict[str, np.ndarray] = {}
    family = _family(params)
    if family == "convnext":
        _put_convnext(sd, prefix, params)
    elif family == "resnet":
        if avg_down is None:
            raise ValueError("a ResNet variant's export needs avg_down (its backbone's name)")
        _put_resnet(sd, prefix, params, batch_stats, avg_down)
    else:
        {"resnetv2": _put_resnetv2, "senet154": _put_senet154, "resnest": _put_resnest,
         "res2net": _put_res2net, "sknet": _put_sknet}[family](sd, prefix, params, batch_stats)
    return sd


def export_unet(params, batch_stats, backbone: str = None) -> Dict[str, np.ndarray]:
    """A Unet tree of any family the port builds -> reference ``encoder.pth``
    keys (timm's ``encoder.*`` names, the decoder's); ``backbone`` names a
    ResNet variant's shortcut layout."""
    enc = params["encoder"]
    avg_down = None
    if _family(enc) == "resnet" and backbone is not None:
        avg_down = _resnet_family_avg_down(backbone)
    sd = export_trunk(enc, batch_stats.get("encoder", {}), avg_down, "encoder.")
    _put_unet_decoder(sd, params["decoder"], batch_stats["decoder"])
    return sd


def export_encoder(params, batch_stats, backbone: str = None) -> Dict[str, np.ndarray]:
    """Any depth encoder-decoder tree the port builds, by its names: an
    EfficientNet (``conv_stem``) or a ResNet (``conv1``) under DecoderBN, or
    a Unet (its decoder's ``final_conv``) of any family (``export_unet``,
    which takes ``backbone`` for a ResNet variant)."""
    if "final_conv" in params["decoder"]:
        return export_unet(params, batch_stats, backbone)
    if "conv_stem" in params["encoder"]:
        return export_base_encoder_decoder(params, batch_stats)
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
