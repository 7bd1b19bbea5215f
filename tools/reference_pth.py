"""The reference's `.pth` state-dict layout of a flax-layout tree: the
inverse of the converters in `if_defense_tpu_torch/convert/` (and of the
JAX package's, which give the same trees).

`reference_state_dict(kind, variables)` maps `{"params": ...,
"batch_stats": ...}` back onto the reference's key names and tensor
layouts (Linear [out, in], Conv1d [out, in, 1], 1x1 Conv2d [out, in, 1, 1],
3x3 Conv2d [out, in, 3, 3], ConvTranspose2d [in, out, 2, 2] unflipped,
BatchNorm weight / bias / running stats), so a converter applied to the
result gives `variables` back leaf for leaf. The tests and `chip_smoke.py`
build reference checkpoints from seeded trees with it, since no reference
`.pth` ships with the repository. numpy and torch only.
"""

from __future__ import annotations

import numpy as np
import torch


def _put(sd, key, w, bias):
    sd[f"{key}.weight"] = np.ascontiguousarray(w, np.float32)
    if bias is not None:
        sd[f"{key}.bias"] = np.asarray(bias, np.float32)


def _linear(sd, key, leaf):
    _put(sd, key, np.asarray(leaf["kernel"]).T, leaf.get("bias"))


def _conv1d(sd, key, leaf):
    _put(sd, key, np.asarray(leaf["kernel"]).T[:, :, None], leaf.get("bias"))


def _conv1x1(sd, key, leaf):
    _put(sd, key, np.asarray(leaf["kernel"]).T[:, :, None, None],
         leaf.get("bias"))


def _conv2d(sd, key, leaf):
    _put(sd, key, np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1),
         leaf.get("bias"))


def _convtranspose2d(sd, key, leaf):
    w = np.asarray(leaf["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    _put(sd, key, w, leaf.get("bias"))


def _bn(sd, key, params, stats):
    sd[f"{key}.weight"] = np.asarray(params["scale"], np.float32)
    sd[f"{key}.bias"] = np.asarray(params["bias"], np.float32)
    sd[f"{key}.running_mean"] = np.asarray(stats["mean"], np.float32)
    sd[f"{key}.running_var"] = np.asarray(stats["var"], np.float32)
    sd[f"{key}.num_batches_tracked"] = np.asarray(0, np.int64)


def _resblock_fc(sd, key, leaf):
    for name in ("fc_0", "fc_1", "shortcut"):
        if name in leaf:
            _linear(sd, f"{key}.{name}", leaf[name])


def _cbn(sd, key, params, stats):
    _conv1d(sd, f"{key}.conv_gamma", params["conv_gamma"])
    _conv1d(sd, f"{key}.conv_beta", params["conv_beta"])
    sd[f"{key}.bn.running_mean"] = np.asarray(stats["bn"]["mean"], np.float32)
    sd[f"{key}.bn.running_var"] = np.asarray(stats["bn"]["var"], np.float32)


def _onet(sd, params, stats):
    enc, dec = params["encoder"], params["decoder"]
    dstats = stats["decoder"]
    _linear(sd, "encoder.fc_pos", enc["fc_pos"])
    _linear(sd, "encoder.fc_c", enc["fc_c"])
    for i in range(5):
        _resblock_fc(sd, f"encoder.block_{i}", enc[f"block_{i}"])
    _conv1d(sd, "decoder.fc_p", dec["fc_p"])
    _conv1d(sd, "decoder.fc_out", dec["fc_out"])
    for i in range(5):
        key, p, s = f"decoder.block{i}", dec[f"block{i}"], dstats[f"block{i}"]
        _cbn(sd, f"{key}.bn_0", p["bn_0"], s["bn_0"])
        _cbn(sd, f"{key}.bn_1", p["bn_1"], s["bn_1"])
        for name in ("fc_0", "fc_1", "shortcut"):
            if name in p:
                _conv1d(sd, f"{key}.{name}", p[name])
    _cbn(sd, "decoder.bn", dec["bn"], dstats["bn"])


def _convonet(sd, params, stats):
    enc, dec = params["encoder"], params["decoder"]
    _linear(sd, "encoder.fc_pos", enc["fc_pos"])
    _linear(sd, "encoder.fc_c", enc["fc_c"])
    blocks = sorted(k for k in enc if k.startswith("blocks_"))
    for i in range(len(blocks)):
        _resblock_fc(sd, f"encoder.blocks.{i}", enc[f"blocks_{i}"])
    unet = enc["unet"]
    depth = len([k for k in unet if k.startswith("down_")])
    for i in range(depth):
        for c in ("conv1", "conv2"):
            _conv2d(sd, f"encoder.unet.down_convs.{i}.{c}",
                    unet[f"down_{i}"][c])
    for i in range(depth - 1):
        up = unet[f"up_{i}"]
        _convtranspose2d(sd, f"encoder.unet.up_convs.{i}.upconv",
                         up["upconv"])
        for c in ("conv1", "conv2"):
            _conv2d(sd, f"encoder.unet.up_convs.{i}.{c}", up[c])
    _conv2d(sd, "encoder.unet.conv_final", unet["conv_final"])
    _linear(sd, "decoder.fc_p", dec["fc_p"])
    _linear(sd, "decoder.fc_out", dec["fc_out"])
    for i in range(len(blocks)):
        _linear(sd, f"decoder.fc_c.{i}", dec[f"fc_c_{i}"])
        _resblock_fc(sd, f"decoder.blocks.{i}", dec[f"blocks_{i}"])


def _punet(sd, params, stats):
    for k in range(4):
        layers = params[f"PUNetSA_{k}"]["SharedMLP_0"]
        for i in range(3):
            _conv1x1(sd, f"SA_modules.{k}.mlps.0.layer{i}.conv",
                     layers[f"Dense_{i}"])
    for k in range(3):
        _conv1x1(sd, f"FP_Modules.{k}.mlp.layer0.conv",
                 params[f"PUNetFP_{k}"]["SharedMLP_0"]["Dense_0"])
    up = len([k for k in params if k.startswith("SharedMLP_")]) - 2
    for k in range(up):
        for i in range(2):
            _conv1x1(sd, f"FC_Modules.{k}.layer{i}.conv",
                     params[f"SharedMLP_{k}"][f"Dense_{i}"])
    for j in range(2):
        _conv1x1(sd, f"pcd_layer.{j}.layer0.conv",
                 params[f"SharedMLP_{up + j}"]["Dense_0"])


def _mlp(sd, conv_keys, bn_keys, params, stats, conv=_conv1d):
    for i, (ck, bk) in enumerate(zip(conv_keys, bn_keys)):
        conv(sd, ck, params[f"Dense_{i}"])
        _bn(sd, bk, params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"])


def _dense_bn(sd, dense_key, bn_key, params, stats):
    _linear(sd, dense_key, params["Dense_0"])
    _bn(sd, bn_key, params["BatchNorm_0"], stats["BatchNorm_0"])


def _head(sd, params, stats):
    for i, (fc, bn) in enumerate([("fc1", "bn1"), ("fc2", "bn2")]):
        _dense_bn(sd, fc, bn, params[f"DenseBN_{i}"], stats[f"DenseBN_{i}"])
    _linear(sd, "fc3", params["Dense_0"])


def _pointnet(sd, params, stats):
    feat, fstats = params["PointNetFeat_0"], stats["PointNetFeat_0"]
    stn, sstats = feat["STN_0"], fstats["STN_0"]
    _mlp(sd, [f"feat.stn.conv{i}.0" for i in (1, 2, 3)],
         [f"feat.stn.conv{i}.1" for i in (1, 2, 3)],
         stn["PointwiseMLP_0"], sstats["PointwiseMLP_0"])
    for i, fc in enumerate(["feat.stn.fc1", "feat.stn.fc2"]):
        _dense_bn(sd, f"{fc}.0", f"{fc}.1", stn[f"DenseBN_{i}"],
                  sstats[f"DenseBN_{i}"])
    _linear(sd, "feat.stn.fc3", stn["Dense_0"])
    for i, conv in enumerate(["feat.conv1", "feat.conv2", "feat.conv3"]):
        _mlp(sd, [f"{conv}.0"], [f"{conv}.1"], feat[f"PointwiseMLP_{i}"],
             fstats[f"PointwiseMLP_{i}"])
    _dense_bn(sd, "fc1.0", "fc1.1", params["DenseBN_0"], stats["DenseBN_0"])
    _linear(sd, "fc2", params["Dense_0"])
    _bn(sd, "bn2", params["BatchNorm_0"], stats["BatchNorm_0"])
    _linear(sd, "fc3", params["Dense_1"])


def _dgcnn(sd, params, stats):
    for i in range(5):
        _mlp(sd, [f"conv{i + 1}.0"], [f"bn{i + 1}"],
             params[f"PointwiseMLP_{i}"], stats[f"PointwiseMLP_{i}"],
             conv=_conv1x1)
    _dense_bn(sd, "linear1.0", "bn6", params["DenseBN_0"], stats["DenseBN_0"])
    _dense_bn(sd, "linear2.0", "bn7", params["DenseBN_1"], stats["DenseBN_1"])
    _linear(sd, "linear3", params["Dense_0"])


def _sa_mlp(sd, prefix, params, stats):
    _mlp(sd, [f"{prefix}.mlp_convs.{j}" for j in range(3)],
         [f"{prefix}.mlp_bns.{j}" for j in range(3)], params, stats,
         conv=_conv1x1)


def _pointnet2(sd, params, stats):
    for i in range(3):
        _sa_mlp(sd, f"sa{i + 1}",
                params[f"SetAbstraction_{i}"]["PointwiseMLP_0"],
                stats[f"SetAbstraction_{i}"]["PointwiseMLP_0"])
    _head(sd, params, stats)


def _pointconv(sd, params, stats):
    for i in range(3):
        sa = f"sa{i + 1}"
        p = params[f"PointConvSetAbstraction_{i}"]
        s = stats[f"PointConvSetAbstraction_{i}"]
        _sa_mlp(sd, sa, p["PointwiseMLP_0"], s["PointwiseMLP_0"])
        for name, sub in (("WeightNet_0", "weightnet"),
                          ("DensityNet_0", "densitynet")):
            _sa_mlp(sd, f"{sa}.{sub}", p[name]["PointwiseMLP_0"],
                    s[name]["PointwiseMLP_0"])
        _dense_bn(sd, f"{sa}.linear", f"{sa}.bn_linear", p["DenseBN_0"],
                  s["DenseBN_0"])
    _head(sd, params, stats)


_INVERSE = {"onet": _onet, "convonet": _convonet, "punet": _punet,
            "pointnet": _pointnet, "dgcnn": _dgcnn, "pointnet2": _pointnet2,
            "pointconv": _pointconv}


def reference_state_dict(kind: str, variables: dict,
                         module_prefix: bool = False) -> dict:
    """The reference state dict ({key: CPU tensor}) whose conversion gives
    `variables`; `module_prefix` adds `nn.DataParallel`'s `module.`."""
    sd: dict = {}
    _INVERSE[kind](sd, variables["params"], variables.get("batch_stats", {}))
    pre = "module." if module_prefix else ""
    return {pre + k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
