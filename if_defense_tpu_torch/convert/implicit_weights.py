"""Convert pretrained ONet / ConvONet `.pth` checkpoints to the flax tree
(port of `if_defense_tpu/convert/implicit_weights.py`).

Maps the reference state-dict layouts (`ONet/im2mesh/onet/models`,
`ConvONet/src/conv_onet/models`) onto the JAX package's
`if_defense_tpu.implicit.*` tree, which `utils.params_io.params_from_jax`
loads into the port's modules:
- Linear / 1x1 Conv1d -> Dense (kernel = W.T)
- 3x3 Conv2d -> flax Conv (kernel = W.transpose(2, 3, 1, 0))
- 2x2-stride-2 ConvTranspose2d -> flax ConvTranspose (spatially flipped,
  W.transpose(2, 3, 0, 1)); `params_from_jax` flips it back for the port's
  `nn.ConvTranspose2d`, so the reference tensor arrives bit for bit
- BatchNorm running stats -> the `batch_stats` collection
"""

from __future__ import annotations

import numpy as np

from if_defense_tpu_torch.convert._pth import load_state_dict


def _kernel(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.astype(np.float32))


def _with_bias(sd, key, kernel) -> dict:
    out = {"kernel": _kernel(kernel)}
    if f"{key}.bias" in sd:
        out["bias"] = sd[f"{key}.bias"].astype(np.float32)
    return out


def _linear(sd, key):
    return _with_bias(sd, key, sd[f"{key}.weight"].T)


def _conv1d(sd, key):
    return _with_bias(sd, key, sd[f"{key}.weight"][:, :, 0].T)


def _conv2d(sd, key):
    return _with_bias(sd, key, sd[f"{key}.weight"].transpose(2, 3, 1, 0))


def _convtranspose2d(sd, key):
    # torch [in, out, kh, kw] -> flax [kh, kw, in, out]; flax's
    # conv_transpose does NOT flip the kernel while torch's gradient-of-conv
    # does, so flip the spatial dims
    w = sd[f"{key}.weight"][:, :, ::-1, ::-1]
    return _with_bias(sd, key, w.transpose(2, 3, 0, 1))


def _resblock_fc(sd, key):
    out = {"fc_0": _linear(sd, f"{key}.fc_0"),
           "fc_1": _linear(sd, f"{key}.fc_1")}
    if f"{key}.shortcut.weight" in sd:
        out["shortcut"] = _linear(sd, f"{key}.shortcut")
    return out


def _cbn(sd, key):
    """CBatchNorm1d -> params (gamma/beta convs) + batch stats."""
    params = {
        "conv_gamma": _conv1d(sd, f"{key}.conv_gamma"),
        "conv_beta": _conv1d(sd, f"{key}.conv_beta"),
    }
    stats = {
        "bn": {
            "mean": sd[f"{key}.bn.running_mean"].astype(np.float32),
            "var": sd[f"{key}.bn.running_var"].astype(np.float32),
        }
    }
    return params, stats


def _cresblock(sd, key):
    """CResnetBlockConv1d -> (params, batch_stats)."""
    p0, s0 = _cbn(sd, f"{key}.bn_0")
    p1, s1 = _cbn(sd, f"{key}.bn_1")
    params = {
        "bn_0": p0,
        "bn_1": p1,
        "fc_0": _conv1d(sd, f"{key}.fc_0"),
        "fc_1": _conv1d(sd, f"{key}.fc_1"),
    }
    if f"{key}.shortcut.weight" in sd:
        params["shortcut"] = _conv1d(sd, f"{key}.shortcut")
    return params, {"bn_0": s0, "bn_1": s1}


def convert_onet_pth(pth_path_or_sd) -> dict:
    """ONet checkpoint -> {"params": ..., "batch_stats": ...}."""
    sd = load_state_dict(pth_path_or_sd)
    enc = {
        "fc_pos": _linear(sd, "encoder.fc_pos"),
        "fc_c": _linear(sd, "encoder.fc_c"),
    }
    for i in range(5):
        enc[f"block_{i}"] = _resblock_fc(sd, f"encoder.block_{i}")

    dec, dec_stats = {
        "fc_p": _conv1d(sd, "decoder.fc_p"),
        "fc_out": _conv1d(sd, "decoder.fc_out"),
    }, {}
    for i in range(5):
        p, s = _cresblock(sd, f"decoder.block{i}")
        dec[f"block{i}"] = p
        dec_stats[f"block{i}"] = s
    p, s = _cbn(sd, "decoder.bn")
    dec["bn"] = p
    dec_stats["bn"] = s

    return {
        "params": {"encoder": enc, "decoder": dec},
        "batch_stats": {"decoder": dec_stats},
    }


def convert_convonet_pth(pth_path_or_sd, n_blocks: int = 5,
                         unet_depth: int = 4) -> dict:
    """ConvONet checkpoint -> {"params": ...} (no batch norm anywhere)."""
    sd = load_state_dict(pth_path_or_sd)
    enc = {
        "fc_pos": _linear(sd, "encoder.fc_pos"),
        "fc_c": _linear(sd, "encoder.fc_c"),
    }
    for i in range(n_blocks):
        enc[f"blocks_{i}"] = _resblock_fc(sd, f"encoder.blocks.{i}")
    unet = {}
    for i in range(unet_depth):
        unet[f"down_{i}"] = {
            "conv1": _conv2d(sd, f"encoder.unet.down_convs.{i}.conv1"),
            "conv2": _conv2d(sd, f"encoder.unet.down_convs.{i}.conv2"),
        }
    for i in range(unet_depth - 1):
        unet[f"up_{i}"] = {
            "upconv": _convtranspose2d(
                sd, f"encoder.unet.up_convs.{i}.upconv"),
            "conv1": _conv2d(sd, f"encoder.unet.up_convs.{i}.conv1"),
            "conv2": _conv2d(sd, f"encoder.unet.up_convs.{i}.conv2"),
        }
    unet["conv_final"] = _conv2d(sd, "encoder.unet.conv_final")
    enc["unet"] = unet

    dec = {
        "fc_p": _linear(sd, "decoder.fc_p"),
        "fc_out": _linear(sd, "decoder.fc_out"),
    }
    for i in range(n_blocks):
        dec[f"fc_c_{i}"] = _linear(sd, f"decoder.fc_c.{i}")
        dec[f"blocks_{i}"] = _resblock_fc(sd, f"decoder.blocks.{i}")

    return {"params": {"encoder": enc, "decoder": dec}}
