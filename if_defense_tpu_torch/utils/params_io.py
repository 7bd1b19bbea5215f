"""Flat-npz params, the flax-to-PyTorch layout map, and seeded weights.

The npz format is the JAX package's (`if_defense_tpu/utils/params_io.py`):
a nested flax variable tree flattened with '/'-joined keys. `params_from_jax`
turns such a tree into a PyTorch state dict for the port's modules, whose
submodule names follow the flax names. It inverts
`if_defense_tpu/convert/implicit_weights.py`:
- Dense kernel `[in, out]` -> `Linear.weight = kernel.T`;
- Conv kernel HWIO -> OIHW;
- ConvTranspose kernel `[kh, kw, in, out]` -> `[in, out, kh, kw]`, with the
  spatial flip that the converter applies undone;
- the `batch_stats` collection (ONet's batch norms: `mean`, `var`) -> the
  running buffers of the same names and paths.
`params_to_jax` is its exact inverse, so weights trained by the port save
as a JAX npz that both packages load.

`init_params(seed)` writes, with numpy alone, a flax-layout ConvONet tree
with the keys and shapes that `ConvOccupancyNetwork().init` gives and every
tensor nonzero (flax zero-initialises each block's `fc_1`, which would hide
half of every ResNet block from a test). `flax_init_params(seed, variant)`
draws, with numpy alone, from the distributions that flax's `init` draws
from, with its zeros and ones; it is where training starts.
"""

from __future__ import annotations

import numpy as np
import torch


def flatten_params(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_params(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_params(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_params_npz(path: str, tree: dict) -> str:
    np.savez_compressed(path, **flatten_params(tree))
    return path


def load_params_npz(path: str) -> dict:
    with np.load(path) as npz:
        return unflatten_params({k: npz[k] for k in npz.files})


def _to_torch_layout(path: list[str], value: np.ndarray) -> np.ndarray:
    value = np.asarray(value, dtype=np.float32)
    if path[-1] != "kernel":
        return value
    if value.ndim == 2:                                   # Dense
        return value.T
    if value.ndim == 4 and path[-2] == "upconv":          # ConvTranspose
        return value.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    if value.ndim == 4:                                   # Conv HWIO
        return value.transpose(3, 2, 0, 1)
    raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")


def _to_flax_layout(path: list[str], value: np.ndarray) -> np.ndarray:
    if path[-1] != "kernel":
        return value
    if value.ndim == 2:                                   # Dense
        return value.T
    if value.ndim == 4 and path[-2] == "upconv":          # ConvTranspose
        return value[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    if value.ndim == 4:                                   # Conv OIHW
        return value.transpose(2, 3, 1, 0)
    raise ValueError(f"unexpected weight rank at {'/'.join(path)}")


_STATS = ("mean", "var")                  # batch-norm leaves of batch_stats


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Flax variables (`{"params": ...}`, optionally with `"batch_stats"`,
    or a bare param tree) -> PyTorch state dict of the port's modules."""
    if "params" in tree and set(tree) <= {"params", "batch_stats"}:
        flat = flatten_params(tree["params"])
        flat.update(flatten_params(tree.get("batch_stats", {})))
    else:
        flat = flatten_params(tree)
    out = {}
    for key, value in flat.items():
        path = key.split("/")
        name = ".".join(path[:-1] + ["weight" if path[-1] == "kernel"
                                     else path[-1]])
        out[name] = torch.from_numpy(
            np.array(_to_torch_layout(path, value), order="C"))
    return out


def params_to_jax(state_dict: dict[str, torch.Tensor]) -> dict:
    """PyTorch state dict of the port's modules -> flax variables
    `{"params": ...}`, with `"batch_stats"` where the modules keep running
    statistics; the exact inverse of `params_from_jax`."""
    params, stats = {}, {}
    for name, tensor in state_dict.items():
        path = name.split(".")
        value = tensor.detach().cpu().numpy()
        if path[-1] in _STATS:
            stats["/".join(path)] = value.copy()
            continue
        if path[-1] == "weight":
            path[-1] = "kernel"
        params["/".join(path)] = np.ascontiguousarray(
            _to_flax_layout(path, value))
    out = {"params": unflatten_params(params)}
    if stats:
        out["batch_stats"] = unflatten_params(stats)
    return out


def convonet_param_shapes(c_dim: int = 32,
                          hidden_dim: int = 32) -> dict[str, tuple]:
    """Flat '/'-keyed shapes of the flax ConvOccupancyNetwork's params
    (plane type, 5 ResNet blocks each side, UNet of depth 4 with
    start_filts = c_dim)."""
    h, c = hidden_dim, c_dim
    n_blocks, unet_depth = 5, 4
    shapes = {}

    def dense(key, fan_in, fan_out, bias=True):
        shapes[f"{key}/kernel"] = (fan_in, fan_out)
        if bias:
            shapes[f"{key}/bias"] = (fan_out,)

    def conv(key, k, cin, cout):
        shapes[f"{key}/kernel"] = (k, k, cin, cout)
        shapes[f"{key}/bias"] = (cout,)

    dense("encoder/fc_pos", 3, 2 * h)
    for i in range(n_blocks):
        dense(f"encoder/blocks_{i}/fc_0", 2 * h, h)
        dense(f"encoder/blocks_{i}/fc_1", h, h)
        dense(f"encoder/blocks_{i}/shortcut", 2 * h, h, bias=False)
    dense("encoder/fc_c", h, c)
    cin = c
    for i in range(unet_depth):
        f = c * 2**i
        conv(f"encoder/unet/down_{i}/conv1", 3, cin, f)
        conv(f"encoder/unet/down_{i}/conv2", 3, f, f)
        cin = f
    for i in range(unet_depth - 1):
        f = c * 2 ** (unet_depth - 2 - i)
        conv(f"encoder/unet/up_{i}/upconv", 2, cin, f)
        conv(f"encoder/unet/up_{i}/conv1", 3, 2 * f, f)
        conv(f"encoder/unet/up_{i}/conv2", 3, f, f)
        cin = f
    conv("encoder/unet/conv_final", 1, cin, c)
    dense("decoder/fc_p", 3, h)
    for i in range(n_blocks):
        dense(f"decoder/fc_c_{i}", c, h)
        dense(f"decoder/blocks_{i}/fc_0", h, h)
        dense(f"decoder/blocks_{i}/fc_1", h, h)
    dense("decoder/fc_out", h, 1)
    return shapes


def onet_param_shapes(c_dim: int = 512, hidden_dim: int = 512,
                      decoder_hidden: int = 256) -> dict[str, tuple]:
    """Flat '/'-keyed shapes of the flax OccupancyNetwork's variables
    (z_dim 0), each key led by its collection: `params/...` and
    `batch_stats/...` (the conditional batch norms' running mean and
    variance)."""
    h, H = hidden_dim, decoder_hidden
    shapes = {}

    def dense(key, fan_in, fan_out, bias=True):
        shapes[f"params/{key}/kernel"] = (fan_in, fan_out)
        if bias:
            shapes[f"params/{key}/bias"] = (fan_out,)

    def cbn(key, f):
        dense(f"{key}/conv_gamma", c_dim, f)
        dense(f"{key}/conv_beta", c_dim, f)
        for stat in _STATS:
            shapes[f"batch_stats/{key}/bn/{stat}"] = (f,)

    dense("encoder/fc_pos", 3, 2 * h)
    for i in range(5):
        dense(f"encoder/block_{i}/fc_0", 2 * h, h)
        dense(f"encoder/block_{i}/fc_1", h, h)
        dense(f"encoder/block_{i}/shortcut", 2 * h, h, bias=False)
    dense("encoder/fc_c", h, c_dim)
    dense("decoder/fc_p", 3, H)
    for i in range(5):
        cbn(f"decoder/block{i}/bn_0", H)
        dense(f"decoder/block{i}/fc_0", H, H)
        cbn(f"decoder/block{i}/bn_1", H)
        dense(f"decoder/block{i}/fc_1", H, H)
    cbn("decoder/bn", H)
    dense("decoder/fc_out", H, 1)
    return shapes


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """Standard normal truncated to [-2, 2], as `jax.random.truncated_normal`."""
    v = rng.normal(size=shape)
    out = np.abs(v) > 2
    while out.any():
        v[out] = rng.normal(size=int(out.sum()))
        out = np.abs(v) > 2
    return v


def flax_init_params(seed: int, variant: str, **config) -> dict:
    """Seeded flax-layout variables of `variant` ("convonet" or "onet"),
    numpy only, drawn as flax's `init` draws them (`jax.random` itself
    cannot be reproduced): `lecun_normal` kernels (normal truncated to 2
    std, variance 1/fan_in, fan_in the product of all but the last axis),
    zero biases, zero `fc_1` kernels, the conditional batch norms'
    `conv_gamma` kernel 0 with bias 1 and `conv_beta` 0, batch-norm scales
    1, and running means 0 and variances 1. `config` takes the arguments of
    `convonet_param_shapes` or `onet_param_shapes`."""
    if variant == "convonet":
        shapes = {f"params/{k}": v
                  for k, v in convonet_param_shapes(**config).items()}
    elif variant == "onet":
        shapes = onet_param_shapes(**config)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in shapes.items():
        path = key.split("/")
        if path[-1] == "kernel" and path[-2] not in ("fc_1", "conv_gamma",
                                                      "conv_beta"):
            # truncated to 2 std, whose std is 0.8796: rescale to 1/fan_in
            std = np.sqrt(1.0 / np.prod(shape[:-1])) / .87962566103423978
            v = _truncated_normal(rng, shape) * std
        elif path[-1] in ("scale", "var") or path[-2:] == ["conv_gamma",
                                                           "bias"]:
            v = np.ones(shape)
        else:
            v = np.zeros(shape)
        flat[key] = v.astype(np.float32)
    return unflatten_params(flat)


def init_params(seed: int, **config) -> dict:
    """Seeded flax-layout ConvONet params `{"params": {...}}`, numpy only.

    Kernels are normal with variance 1/fan_in (lecun normal, as flax), and
    biases normal with std 0.1, so no tensor is zero. `config` takes the
    arguments of `convonet_param_shapes`.
    """
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in convonet_param_shapes(**config).items():
        if key.endswith("kernel"):
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(size=shape) / np.sqrt(fan_in)
        else:
            v = rng.normal(size=shape) * 0.1
        flat[f"params/{key}"] = v.astype(np.float32)
    return unflatten_params(flat)
