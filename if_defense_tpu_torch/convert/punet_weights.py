"""Convert the pretrained PU-Net `.pth` (DUP-Net) to the flax tree (port of
`if_defense_tpu/convert/punet_weights.py`).

Maps `baselines/defense/DUP_Net/pu_net.py` state-dict names (SA_modules /
FP_Modules / FC_Modules / pcd_layer, each a stack of 1x1 Conv2d) onto the
JAX package's `PUNet` tree, which `utils.params_io.params_from_jax` loads
into the port's `defense.punet.PUNet`. 1x1 convs become Dense:
kernel = weight[:, :, 0, 0].T.
"""

from __future__ import annotations

import numpy as np

from if_defense_tpu_torch.convert._pth import load_state_dict


def _dense(weight: np.ndarray, bias: np.ndarray) -> dict:
    return {
        "kernel": np.ascontiguousarray(weight[:, :, 0, 0].T.astype(np.float32)),
        "bias": bias.astype(np.float32),
    }


def convert_punet_pth(pth_path: str, up_ratio: int = 4) -> dict:
    """Load the torch checkpoint and return flax-style params for PUNet."""
    sd = load_state_dict(pth_path)

    def conv(prefix):
        return _dense(sd[f"{prefix}.weight"], sd[f"{prefix}.bias"])

    params: dict = {}
    # 4 SA modules, each SharedMLP of 3 conv layers
    for k in range(4):
        params[f"PUNetSA_{k}"] = {"SharedMLP_0": {
            f"Dense_{i}": conv(f"SA_modules.{k}.mlps.0.layer{i}.conv")
            for i in range(3)}}
    # 3 FP modules, single conv layer each
    for k in range(3):
        params[f"PUNetFP_{k}"] = {"SharedMLP_0": {
            "Dense_0": conv(f"FP_Modules.{k}.mlp.layer0.conv")}}
    # up_ratio expansion MLPs (2 layers each) -> SharedMLP_0..r-1
    for k in range(up_ratio):
        params[f"SharedMLP_{k}"] = {
            f"Dense_{i}": conv(f"FC_Modules.{k}.layer{i}.conv")
            for i in range(2)}
    # coordinate head: SharedMLP_r (64), SharedMLP_r+1 (3)
    for j in range(2):
        params[f"SharedMLP_{up_ratio + j}"] = {
            "Dense_0": conv(f"pcd_layer.{j}.layer0.conv")}
    return {"params": params}
