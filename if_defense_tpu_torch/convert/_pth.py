"""Reading a reference `.pth` state dict as numpy arrays."""

from __future__ import annotations

import numpy as np
import torch


def load_state_dict(pth_path_or_sd, strip_module: bool = False) -> dict:
    """{key: numpy array} from a `.pth` path (read on the CPU, tensors
    only: `weights_only=True`) or from a dict of tensors or arrays. With
    `strip_module`, the `module.` prefix of a state dict saved under
    `nn.DataParallel` is dropped (`attack_scripts/*.py:120-125`)."""
    sd = pth_path_or_sd
    if not isinstance(sd, dict):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    out = {}
    for k, v in sd.items():
        if strip_module and k.startswith("module."):
            k = k[len("module."):]
        out[k] = (v.detach().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v))
    return out
