"""Convert reference victim-classifier `.pth` checkpoints to flax variables
(port of `if_defense_tpu/convert/victim_weights.py`).

Carries PyTorch-trained victims (the reference's BEST_WEIGHTS checkpoints,
`baselines/model/*`) into the JAX package's variable tree, which
`utils.checkpoint.save_eval_checkpoint` writes as a victim npz and
`utils.params_io.params_from_jax` loads into the port's `models.*`.
Covers PointNet (feature_transform off, the shipped training default),
DGCNN, PointNet++ (SSG) and PointConv.

Conventions: Linear/1x1-conv weight [out, in(,1,1)] -> Dense kernel
[in, out]; BatchNorm affine+running stats -> flax params + batch_stats.
State dicts saved under nn.DataParallel carry a `module.` prefix
(stripped, like `attack_scripts/*.py:120-125`).
"""

from __future__ import annotations

import numpy as np

from if_defense_tpu_torch.convert._pth import load_state_dict


def _load(pth_path_or_sd) -> dict:
    return load_state_dict(pth_path_or_sd, strip_module=True)


def _dense(sd, key):
    w = sd[f"{key}.weight"]
    if w.ndim >= 3:
        w = w.reshape(w.shape[0], w.shape[1])
    out = {"kernel": np.ascontiguousarray(w.T.astype(np.float32))}
    if f"{key}.bias" in sd:
        out["bias"] = sd[f"{key}.bias"].astype(np.float32)
    return out


def _bn(sd, key):
    params = {
        "scale": sd[f"{key}.weight"].astype(np.float32),
        "bias": sd[f"{key}.bias"].astype(np.float32),
    }
    stats = {
        "mean": sd[f"{key}.running_mean"].astype(np.float32),
        "var": sd[f"{key}.running_var"].astype(np.float32),
    }
    return params, stats


def _mlp(sd, conv_keys, bn_keys):
    """Sequential conv+bn pairs -> PointwiseMLP params/stats."""
    p, s = {}, {}
    for i, (ck, bk) in enumerate(zip(conv_keys, bn_keys)):
        p[f"Dense_{i}"] = _dense(sd, ck)
        bp, bs = _bn(sd, bk)
        p[f"BatchNorm_{i}"] = bp
        s[f"BatchNorm_{i}"] = bs
    return p, s


def _dense_bn(sd, dense_key, bn_key):
    """Linear + BatchNorm1d -> DenseBN (params, stats)."""
    bp, bs = _bn(sd, bn_key)
    return ({"Dense_0": _dense(sd, dense_key), "BatchNorm_0": bp},
            {"BatchNorm_0": bs})


def _head(sd, params, stats):
    """fc1+bn1 -> DenseBN_0, fc2+bn2 -> DenseBN_1, fc3 -> Dense_0."""
    for i, (fc, bn) in enumerate([("fc1", "bn1"), ("fc2", "bn2")]):
        params[f"DenseBN_{i}"], stats[f"DenseBN_{i}"] = _dense_bn(sd, fc, bn)
    params["Dense_0"] = _dense(sd, "fc3")
    return {"params": params, "batch_stats": stats}


def convert_pointnet_pth(pth_path_or_sd) -> dict:
    """PointNetCls (use_bn=True, feature_transform=False) -> flax variables."""
    sd = _load(pth_path_or_sd)

    params: dict = {}
    stats: dict = {}

    def put(path, p, s=None):
        node_p, node_s = params, stats
        parts = path.split("/")
        for part in parts[:-1]:
            node_p = node_p.setdefault(part, {})
            node_s = node_s.setdefault(part, {})
        node_p[parts[-1]] = p
        if s is not None:
            node_s[parts[-1]] = s

    # STN3d: conv1-3 (Sequential conv+bn), fc1/fc2 (Sequential linear+bn), fc3
    stn = "PointNetFeat_0/STN_0"
    mp, ms = _mlp(
        sd,
        ["feat.stn.conv1.0", "feat.stn.conv2.0", "feat.stn.conv3.0"],
        ["feat.stn.conv1.1", "feat.stn.conv2.1", "feat.stn.conv3.1"],
    )
    put(f"{stn}/PointwiseMLP_0", mp, ms)
    for i, fc in enumerate(["feat.stn.fc1", "feat.stn.fc2"]):
        bp, bs = _bn(sd, f"{fc}.1")
        put(f"{stn}/DenseBN_{i}/Dense_0", _dense(sd, f"{fc}.0"))
        put(f"{stn}/DenseBN_{i}/BatchNorm_0", bp, bs)
    put(f"{stn}/Dense_0", _dense(sd, "feat.stn.fc3"))

    # shared MLPs 64 / 128 / 1024
    for i, conv in enumerate(["feat.conv1", "feat.conv2", "feat.conv3"]):
        mp, ms = _mlp(sd, [f"{conv}.0"], [f"{conv}.1"])
        put(f"PointNetFeat_0/PointwiseMLP_{i}", mp, ms)

    # head: fc1(Sequential linear+bn) -> DenseBN_0; fc2 -> Dense_0;
    # bn2 -> BatchNorm_0; fc3 -> Dense_1
    bp, bs = _bn(sd, "fc1.1")
    put("DenseBN_0/Dense_0", _dense(sd, "fc1.0"))
    put("DenseBN_0/BatchNorm_0", bp, bs)
    put("Dense_0", _dense(sd, "fc2"))
    bp, bs = _bn(sd, "bn2")
    put("BatchNorm_0", bp, bs)
    put("Dense_1", _dense(sd, "fc3"))

    return {"params": params, "batch_stats": stats}


def convert_dgcnn_pth(pth_path_or_sd) -> dict:
    """DGCNN (use_bn=True) -> flax variables."""
    sd = _load(pth_path_or_sd)

    params: dict = {}
    stats: dict = {}
    # conv1-4 (EdgeConv blocks) + conv5 (embedding): Sequential(conv, bn, act)
    for i in range(5):
        params[f"PointwiseMLP_{i}"], stats[f"PointwiseMLP_{i}"] = _mlp(
            sd, [f"conv{i+1}.0"], [f"bn{i+1}"])
    # linear1(Sequential linear+bn6) -> DenseBN_0; linear2+bn7 -> DenseBN_1
    params["DenseBN_0"], stats["DenseBN_0"] = _dense_bn(sd, "linear1.0", "bn6")
    params["DenseBN_1"], stats["DenseBN_1"] = _dense_bn(sd, "linear2.0", "bn7")
    params["Dense_0"] = _dense(sd, "linear3")
    return {"params": params, "batch_stats": stats}


def convert_pointnet2_pth(pth_path_or_sd) -> dict:
    """PointNet2ClsSsg -> flax variables."""
    sd = _load(pth_path_or_sd)

    params: dict = {}
    stats: dict = {}
    for i, sa in enumerate(["sa1", "sa2", "sa3"]):
        mp, ms = _mlp(
            sd,
            [f"{sa}.mlp_convs.{j}" for j in range(3)],
            [f"{sa}.mlp_bns.{j}" for j in range(3)],
        )
        params[f"SetAbstraction_{i}"] = {"PointwiseMLP_0": mp}
        stats[f"SetAbstraction_{i}"] = {"PointwiseMLP_0": ms}
    return _head(sd, params, stats)


def convert_pointconv_pth(pth_path_or_sd) -> dict:
    """PointConvDensityClsSsg -> flax variables."""
    sd = _load(pth_path_or_sd)

    params: dict = {}
    stats: dict = {}
    for i in range(3):
        sa = f"sa{i + 1}"
        node_p, node_s = {}, {}
        for name, sub in (("PointwiseMLP_0", sa),
                          ("WeightNet_0", f"{sa}.weightnet"),
                          ("DensityNet_0", f"{sa}.densitynet")):
            mp, ms = _mlp(
                sd,
                [f"{sub}.mlp_convs.{j}" for j in range(3)],
                [f"{sub}.mlp_bns.{j}" for j in range(3)],
            )
            if name == "PointwiseMLP_0":
                node_p[name], node_s[name] = mp, ms
            else:
                node_p[name] = {"PointwiseMLP_0": mp}
                node_s[name] = {"PointwiseMLP_0": ms}
        node_p["DenseBN_0"], node_s["DenseBN_0"] = _dense_bn(
            sd, f"{sa}.linear", f"{sa}.bn_linear")
        params[f"PointConvSetAbstraction_{i}"] = node_p
        stats[f"PointConvSetAbstraction_{i}"] = node_s
    return _head(sd, params, stats)
