"""Flat-npz params, the flax-to-PyTorch layout map, and seeded weights.

The npz format is the JAX package's (`if_defense_tpu/utils/params_io.py`):
a nested flax variable tree flattened with '/'-joined keys. `params_from_jax`
turns such a tree into a PyTorch state dict for the port's modules, whose
submodule names follow the flax names. It inverts
`if_defense_tpu/convert/implicit_weights.py`:
- Dense kernel `[in, out]` -> `Linear.weight = kernel.T`;
- Conv kernel HWIO -> OIHW, and `[kd, kh, kw, in, out]` -> `[out, in, kd,
  kh, kw]`;
- ConvTranspose kernel `[kh, kw, in, out]` -> `[in, out, kh, kw]` (and its
  3-D form), with the spatial flip that the converter applies undone. A
  kernel is transposed where the module that holds it is
  (`transposed_convs(model)`), whatever its name;
- the `batch_stats` collection (ONet's batch norms: `mean`, `var`) -> the
  running buffers of the same names and paths.
`params_to_jax` is its exact inverse, so weights trained by the port save
as a JAX npz that both packages load.

`init_params(seed)` writes, with numpy alone, a flax-layout ConvONet tree
with the keys and shapes that `ConvOccupancyNetwork().init` gives and every
tensor nonzero (flax zero-initialises each block's `fc_1`, which would hide
half of every ResNet block from a test). `flax_init_params(seed, variant)`
draws, with numpy alone, from the distributions that flax's `init` draws
from, with its zeros and ones, for ConvONet, ONet and the five victims; it
is where training starts.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


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


def save_params_npz(path: str, tree: dict, compress: bool = True) -> str:
    """`tree` flattened into the npz at `path`; `compress=False` writes it
    uncompressed (trained weights and Adam's moments hardly compress, and
    zlib takes seconds for PointConv's 20M floats)."""
    (np.savez_compressed if compress else np.savez)(
        path, **flatten_params(tree))
    return path


def load_params_npz(path: str) -> dict:
    with np.load(path) as npz:
        return unflatten_params({k: npz[k] for k in npz.files})


def transposed_convs(model: nn.Module) -> set[str]:
    """Flax paths ('/'-joined module names) of `model`'s transposed
    convolutions."""
    return {name.replace(".", "/") for name, m in model.named_modules()
            if isinstance(m, nn.modules.conv._ConvTransposeNd)}


def _to_torch_layout(path: list[str], value: np.ndarray, dtype,
                     transposed: set[str]) -> np.ndarray:
    value = np.asarray(value, dtype=dtype)
    if path[-1] != "kernel":
        return value
    if value.ndim == 2:                                   # Dense
        return value.T
    if value.ndim in (4, 5):
        s = value.ndim - 2                                # spatial axes
        spatial = tuple(range(s))
        if "/".join(path[:-1]) in transposed:     # ConvTranspose
            flip = (slice(None),) * 2 + (slice(None, None, -1),) * s
            return value.transpose(s, s + 1, *spatial)[flip]
        return value.transpose(s + 1, s, *spatial)        # Conv -> O I ...
    raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")


def _to_flax_layout(path: list[str], value: np.ndarray,
                    transposed: set[str]) -> np.ndarray:
    if path[-1] != "kernel":
        return value
    if value.ndim == 2:                                   # Dense
        return value.T
    if value.ndim in (4, 5):
        s = value.ndim - 2
        spatial = tuple(range(2, 2 + s))
        if "/".join(path[:-1]) in transposed:     # ConvTranspose
            flip = (slice(None),) * 2 + (slice(None, None, -1),) * s
            return value[flip].transpose(*spatial, 0, 1)
        return value.transpose(*spatial, 1, 0)            # Conv O I ... -> ... I O
    raise ValueError(f"unexpected weight rank at {'/'.join(path)}")


_STATS = ("mean", "var")                  # batch-norm leaves of batch_stats


def params_from_jax(tree: dict, model: nn.Module,
                    dtype=np.float32) -> dict[str, torch.Tensor]:
    """Flax variables (`{"params": ...}`, optionally with `"batch_stats"`,
    or a bare param tree) -> PyTorch state dict of `model`, the port module
    whose tree it is (it says which kernels are transposed convolutions),
    in `dtype` (None keeps each array's own)."""
    transposed = transposed_convs(model)
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
            np.array(_to_torch_layout(path, value, dtype, transposed),
                     order="C"))
    return out


def params_to_jax(state_dict: dict[str, torch.Tensor],
                  model: nn.Module) -> dict:
    """PyTorch state dict of `model` (or tensors under its parameters'
    names) -> flax variables `{"params": ...}`, with `"batch_stats"` where
    the modules keep running statistics; the exact inverse of
    `params_from_jax`."""
    transposed = transposed_convs(model)
    params, stats = {}, {}
    for name, tensor in state_dict.items():
        path = name.split(".")
        value = tensor.detach().cpu().numpy()
        if path[-1] in _STATS:
            stats["/".join(path)] = value.copy()
            continue
        if path[-1] == "weight":
            path[-1] = "kernel"
        # a copy: a CPU tensor's .numpy() shares its memory
        params["/".join(path)] = np.array(
            _to_flax_layout(path, value, transposed), order="C")
    out = {"params": unflatten_params(params)}
    if stats:
        out["batch_stats"] = unflatten_params(stats)
    return out


def adam_state_to_jax(optimizer_state: dict, model: torch.nn.Module) -> dict:
    """torch Adam's `state_dict()` over `model.parameters()` -> optax's
    `ScaleByAdamState` in the flax layout: {"count": int, "mu": ..., "nu":
    ...}, the moments as flax param trees (`params_to_jax`); zeros before
    the first step."""
    state = optimizer_state["state"]
    count = int(state[0]["step"]) if state else 0
    out = {"count": np.asarray(count, np.int32)}
    for key, moment in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        out[key] = params_to_jax({
            n: state[i][moment] if i in state else torch.zeros_like(p)
            for i, (n, p) in enumerate(model.named_parameters())
        }, model)["params"]
    return out


def adam_state_from_jax(opt_state: dict, model: torch.nn.Module,
                        optimizer_state: dict) -> dict:
    """The inverse of `adam_state_to_jax`: optax's {"count", "mu", "nu"} in
    the flax layout -> a torch Adam `state_dict()` for
    `model.parameters()`, with `optimizer_state`'s param groups (rate,
    betas, eps, weight decay), to pass to `optimizer.load_state_dict`."""
    count = float(np.asarray(opt_state["count"]))
    mu = params_from_jax({"params": opt_state["mu"]}, model, dtype=None)
    nu = params_from_jax({"params": opt_state["nu"]}, model, dtype=None)
    names = {n for n, _ in model.named_parameters()}
    if set(mu) != names or set(nu) != names:
        raise ValueError("Adam moments hold other parameters than the model")
    state = {}
    for i, (n, p) in enumerate(model.named_parameters()):
        if mu[n].shape != p.shape or nu[n].shape != p.shape:
            raise ValueError(f"Adam moments of {n}: {tuple(mu[n].shape)}, "
                             f"{tuple(nu[n].shape)}; want {tuple(p.shape)}")
        state[i] = {"step": torch.tensor(count),
                    "exp_avg": mu[n].to(p.device, p.dtype),
                    "exp_avg_sq": nu[n].to(p.device, p.dtype)}
    return {"state": state, "param_groups": optimizer_state["param_groups"]}


def convonet_param_shapes(c_dim: int = 32, hidden_dim: int = 32,
                          plane_type=("xz", "xy", "yz"),
                          grid_resolution: int = 32,
                          unet3d_depth: int = 3) -> dict[str, tuple]:
    """Flat '/'-keyed shapes of the flax ConvOccupancyNetwork's params: 5
    ResNet blocks each side, a UNet of depth 4 with start_filts = c_dim
    where `plane_type` has a plane, a 3D UNet of depth `unet3d_depth` where
    it has "grid" (`grid_resolution` changes no shape)."""
    h, c = hidden_dim, c_dim
    n_blocks, unet_depth = 5, 4
    shapes = {}

    def dense(key, fan_in, fan_out, bias=True):
        shapes[f"{key}/kernel"] = (fan_in, fan_out)
        if bias:
            shapes[f"{key}/bias"] = (fan_out,)

    def conv(key, k, cin, cout, dims=2):
        shapes[f"{key}/kernel"] = (k,) * dims + (cin, cout)
        shapes[f"{key}/bias"] = (cout,)

    def unet(key, depth, dims):
        cin = c
        for i in range(depth):
            f = c * 2**i
            conv(f"{key}/down_{i}/conv1", 3, cin, f, dims)
            conv(f"{key}/down_{i}/conv2", 3, f, f, dims)
            cin = f
        for i in range(depth - 1):
            f = c * 2 ** (depth - 2 - i)
            conv(f"{key}/up_{i}/upconv", 2, cin, f, dims)
            conv(f"{key}/up_{i}/conv1", 3, 2 * f, f, dims)
            conv(f"{key}/up_{i}/conv2", 3, f, f, dims)
            cin = f
        conv(f"{key}/conv_final", 1, cin, c, dims)

    dense("encoder/fc_pos", 3, 2 * h)
    for i in range(n_blocks):
        dense(f"encoder/blocks_{i}/fc_0", 2 * h, h)
        dense(f"encoder/blocks_{i}/fc_1", h, h)
        dense(f"encoder/blocks_{i}/shortcut", 2 * h, h, bias=False)
    dense("encoder/fc_c", h, c)
    if any(pl != "grid" for pl in plane_type):
        unet("encoder/unet", unet_depth, 2)
    if "grid" in plane_type:
        unet("encoder/unet3d", unet3d_depth, 3)
    dense("decoder/fc_p", 3, h)
    for i in range(n_blocks):
        dense(f"decoder/fc_c_{i}", c, h)
        dense(f"decoder/blocks_{i}/fc_0", h, h)
        dense(f"decoder/blocks_{i}/fc_1", h, h)
    dense("decoder/fc_out", h, 1)
    return shapes


def pointconvonet_param_shapes(c_dim: int = 32,
                               hidden_dim: int = 32) -> dict[str, tuple]:
    """Flat '/'-keyed shapes of the flax PointConvONet's params, read off
    the port's module."""
    from if_defense_tpu_torch.implicit.pointnetpp_encoder import PointConvONet

    model = PointConvONet(c_dim, hidden_dim)
    tree = params_to_jax(model.state_dict(), model)
    return {k: v.shape for k, v in flatten_params(tree["params"]).items()}


def onet_param_shapes(c_dim: int = 512, hidden_dim: int = 512,
                      decoder_hidden: int = 256,
                      z_dim: int = 0) -> dict[str, tuple]:
    """Flat '/'-keyed shapes of the flax OccupancyNetwork's variables, each
    key led by its collection: `params/...` and `batch_stats/...` (the
    conditional batch norms' running mean and variance). z_dim > 0 adds
    the decoder's `fc_z` and the posterior encoder `encoder_latent`."""
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
    if z_dim:
        dense("decoder/fc_z", z_dim, H)
    for i in range(5):
        cbn(f"decoder/block{i}/bn_0", H)
        dense(f"decoder/block{i}/fc_0", H, H)
        cbn(f"decoder/block{i}/bn_1", H)
        dense(f"decoder/block{i}/fc_1", H, H)
    cbn("decoder/bn", H)
    dense("decoder/fc_out", H, 1)
    if z_dim:
        L = 128                                   # LatentEncoder's hidden
        for key, fan_in in (("fc_0", 1), ("fc_pos", 3), ("fc_c", c_dim),
                            ("fc_1", L), ("fc_2", 2 * L), ("fc_3", 2 * L)):
            dense(f"encoder_latent/{key}", fan_in, L)
        dense("encoder_latent/fc_mean", L, z_dim)
        dense("encoder_latent/fc_logstd", L, z_dim)
    return shapes


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """Standard normal truncated to [-2, 2], as `jax.random.truncated_normal`."""
    v = rng.normal(size=shape)
    out = np.abs(v) > 2
    while out.any():
        v[out] = rng.normal(size=int(out.sum()))
        out = np.abs(v) > 2
    return v


def victim_param_shapes(name: str, **kwargs) -> dict[str, tuple]:
    """Flat '/'-keyed shapes of a victim classifier's flax variables, each
    key led by its collection (`params/...`, `batch_stats/...`), read off
    the port's module through `params_to_jax`; `kwargs` go to
    `models.build_model` (e.g. `feature_transform`)."""
    from if_defense_tpu_torch.models import build_model

    model = build_model(name, **kwargs)
    tree = params_to_jax(model.state_dict(), model)
    return {k: v.shape for k, v in flatten_params(tree).items()}


def flax_init_params(seed: int, variant: str, **config) -> dict:
    """Seeded flax-layout variables of `variant` ("convonet", "onet",
    "pointconvonet" or a victim's name: "pointnet", "pointnet2", "dgcnn",
    "pointconv", "rscnn"), numpy only, drawn as flax's `init` draws them (`jax.random`
    itself cannot be reproduced): `lecun_normal` kernels (normal truncated
    to 2 std, variance 1/fan_in, fan_in the product of all but the last
    axis), zero biases, zero `fc_1` kernels, the conditional batch norms'
    `conv_gamma` kernel 0 with bias 1 and `conv_beta` 0, PointNet's STN's
    last Dense kernel 0 (`kernel_init=zeros`), batch-norm scales 1, and
    running means 0 and variances 1. `config` takes the arguments of
    `convonet_param_shapes`, `onet_param_shapes` or
    `pointconvonet_param_shapes`, or a victim's model
    arguments (`victim_param_shapes`)."""
    if variant in ("convonet", "pointconvonet"):
        fn = (convonet_param_shapes if variant == "convonet"
              else pointconvonet_param_shapes)
        shapes = {f"params/{k}": v for k, v in fn(**config).items()}
    elif variant == "onet":
        shapes = onet_param_shapes(**config)
    else:                         # a victim; build_model refuses other names
        shapes = victim_param_shapes(variant, **config)
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in shapes.items():
        path = key.split("/")
        if path[-1] == "kernel" and path[-2] not in ("fc_1", "conv_gamma",
                                                      "conv_beta") and not (
                path[-2] == "Dense_0" and path[-3].startswith("STN_")):
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
