"""YAML config system with recursive inheritance and method dispatch (port
of `if_defense_tpu/utils/config.py`).

Equivalent of `ONet/im2mesh/config.py:12-86` / `ConvONet/src/config.py:
10-40`: configs may name a parent via `inherit_from` (resolved recursively),
then a default file, then the file's own values — later levels override
recursively. `get_model(cfg)` dispatches on `method` (onet / conv_onet) and
builds the port's module with the config's hyperparameters.

PyYAML is imported by `load_config` alone, so this module (and
`if_defense_tpu_torch.utils`) imports where PyYAML is not installed; only
reading a YAML file needs it.
"""

from __future__ import annotations

import os


def update_recursive(dst: dict, src: dict) -> dict:
    """Recursively merge src into dst (in place)."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            update_recursive(dst[k], v)
        else:
            dst[k] = v
    return dst


def _read_yaml(path: str) -> dict:
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs PyYAML (`import yaml` failed); install "
            "it, or pass the config as a dict to get_model and "
            "defense_kwargs_from_config") from e
    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_config(path: str, default_path: str | None = None) -> dict:
    """Load a YAML config, resolving `inherit_from` chains."""
    cfg_special = _read_yaml(path)

    inherit_from = cfg_special.get("inherit_from")
    if inherit_from is not None:
        base = os.path.join(os.path.dirname(path), inherit_from) \
            if not os.path.isabs(inherit_from) else inherit_from
        cfg = load_config(base, default_path)
    elif default_path is not None:
        cfg = _read_yaml(default_path)
    else:
        cfg = {}
    return update_recursive(cfg, cfg_special)


def get_model(cfg: dict):
    """Build the implicit model named by cfg['method'].

    Returns the port's module (CPU, fresh weights); weights load separately
    (`utils.params_io.params_from_jax` of `load_params_npz` or of the .pth
    converters' trees).
    """
    from if_defense_tpu_torch.implicit import (
        ConvOccupancyNetwork,
        OccupancyNetwork,
    )

    method = cfg.get("method", "conv_onet")
    mcfg = cfg.get("model", {})
    if method == "onet":
        ek = mcfg.get("encoder_kwargs", {}) or {}
        return OccupancyNetwork(
            c_dim=mcfg.get("c_dim", 512),
            hidden_dim=ek.get("hidden_dim", 512),
            decoder_hidden=(mcfg.get("decoder_kwargs", {}) or {}).get(
                "hidden_size", 256),
        )
    if method == "conv_onet":
        ek = mcfg.get("encoder_kwargs", {}) or {}
        return ConvOccupancyNetwork(
            c_dim=mcfg.get("c_dim", 32),
            hidden_dim=ek.get("hidden_dim", 32),
            plane_resolution=ek.get("plane_resolution", 64),
            padding=cfg.get("data", {}).get("padding", 0.1),
        )
    raise ValueError(f"unknown method {method!r}")


def defense_kwargs_from_config(cfg: dict) -> dict:
    """Extract the opt/remesh-defense hyperparameters a config carries."""
    out = {}
    test = cfg.get("test", {})
    data = cfg.get("data", {})
    if "threshold" in test:
        out["threshold"] = test["threshold"]
    if "pointcloud_n" in data:
        out["input_npoint"] = data["pointcloud_n"]
    return out
