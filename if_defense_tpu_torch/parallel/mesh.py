"""Mesh construction, batch sharding and running the shards (port of
`if_defense_tpu/parallel/mesh.py`).

Which devices: `"cuda"` means every visible card, as `jax.devices()` does;
`"cuda:i"` that card alone; `"cpu"` one CPU device. A list of devices is
taken as given, repeats included: that is how the tests split a batch over
`[cpu, cpu]` and the card over `[cuda:0, cuda:0]`.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from typing import Any, Callable, Sequence

import numpy as np
import torch

BATCH_AXIS = "dp"


class Mesh:
    """An n-d array of torch devices with one name per axis."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-d devices, axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def visible_devices(device=None) -> list[torch.device]:
    """The devices a device spec names (module docstring); None is
    `"cuda"`."""
    if device is None:
        device = "cuda"
    if isinstance(device, (list, tuple)):
        return [torch.device(d) for d in device]
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device is visible")
        return [torch.device("cuda", i) for i in range(n)]
    return [device]


def _array(devices: list) -> np.ndarray:
    out = np.empty(len(devices), dtype=object)
    out[:] = devices
    return out


def data_parallel_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """1-D data-parallel mesh over the devices (or the first n)."""
    devices = visible_devices(device)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(_array(devices), (BATCH_AXIS,))


def best_data_mesh(batch_size: int, device=None) -> Mesh:
    """Data-parallel mesh over the most devices that divide `batch_size`."""
    n = len(visible_devices(device))
    while n > 1 and batch_size % n != 0:
        n -= 1
    return data_parallel_mesh(n, device)


def get_mesh(shape: dict[str, int] | None = None, device=None) -> Mesh:
    """General mesh: `{"dp": 4, "mp": 2}`-style axis sizes (row-major)."""
    if not shape:
        return data_parallel_mesh(device=device)
    devices = _array(visible_devices(device))
    sizes = tuple(shape.values())
    total = int(np.prod(sizes))
    if total > devices.size:
        raise ValueError(
            f"mesh {shape} needs {total} devices, have {devices.size}"
        )
    return Mesh(devices[:total].reshape(sizes), tuple(shape.keys()))


def mesh_devices(mesh: Mesh, axis: str = BATCH_AXIS) -> list[torch.device]:
    """The devices along `axis` (the other axes at their first index): one
    per shard of a batch sharded over `axis`."""
    ax = mesh.axis_names.index(axis)
    along = np.moveaxis(mesh.devices, ax, 0)
    return list(along.reshape(along.shape[0], -1)[:, 0])


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def shard_batch(batch, mesh: Mesh, axis: str = BATCH_AXIS) -> list:
    """Split the leading axis of every tensor (or numpy array) in a tree
    into contiguous chunks, one per device along `axis`, each moved to its
    device: a list of trees, in device order. Leading dims must divide the
    axis size; pad with `data.batch_iterator(pad_last=True)` upstream."""
    devices = mesh_devices(mesh, axis)
    n = len(devices)

    def split(x):
        x = torch.as_tensor(x)
        if x.shape[0] % n:
            raise ValueError(f"leading dim {x.shape[0]} does not divide "
                             f"over {n} devices")
        return x.chunk(n)

    return [_tree_map(lambda x, i=i, d=d: split(x)[i].to(d), batch)
            for i, d in enumerate(devices)]


def replicate(tree, mesh: Mesh, axis: str = BATCH_AXIS) -> list:
    """A copy of a module, or of a tree of tensors, on each device along
    `axis` (one per shard, in device order). A module already on a device
    serves as that device's first copy; every other copy is a deep copy,
    so no two shards share a module. Done once per run, not per batch."""
    devices = mesh_devices(mesh, axis)
    if isinstance(tree, torch.nn.Module):
        first = next(iter(tree.parameters()), None)
        home = None if first is None else first.device
        out, used = [], False
        for d in devices:
            if not used and home == d:
                out.append(tree)
                used = True
            else:
                out.append(copy.deepcopy(tree).to(d))
        return out
    return [_tree_map(lambda x, d=d: x.to(d), tree) for d in devices]


def _device_context(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def concat_results(results: list):
    """Concatenate per-shard results along their leading axis, tree-wise:
    tensors on the first shard's device, numpy arrays with numpy; other
    leaves (and None) are taken from the first shard."""
    first = results[0]
    if isinstance(first, dict):
        return {k: concat_results([r[k] for r in results]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(concat_results(list(parts))
                           for parts in zip(*results))
    if isinstance(first, torch.Tensor):
        return torch.cat([r.to(first.device) for r in results], 0)
    if isinstance(first, np.ndarray):
        return np.concatenate(results, 0)
    return first


def run_shards(fn: Callable[[int, Any], Any], shards: list,
               devices: Sequence[torch.device], concat: bool = True):
    """Call `fn(i, shards[i])` for every shard, one thread per shard, each
    under `torch.cuda.device(devices[i])` (on a CUDA device) and with the
    caller's grad and inference modes, in the idiom of
    `torch.nn.parallel.parallel_apply`. One shard runs in the calling
    thread. The first exception of any shard (by shard index) is
    re-raised once every thread has ended. -> the results concatenated in
    shard order (`concat_results`), or their list with `concat=False`."""
    if len(shards) != len(devices):
        raise ValueError(f"{len(shards)} shards for {len(devices)} devices")
    grad, inference = torch.is_grad_enabled(), \
        torch.is_inference_mode_enabled()
    results: list = [None] * len(shards)
    errors: list = [None] * len(shards)

    def work(i):
        try:
            with (torch.inference_mode() if inference
                  else contextlib.nullcontext()), \
                    torch.set_grad_enabled(grad), _device_context(devices[i]):
                results[i] = fn(i, shards[i])
        except BaseException as e:        # re-raised in the caller below
            errors[i] = e

    if len(shards) == 1:
        work(0)
    else:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(shards))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for e in errors:
        if e is not None:
            raise e
    return concat_results(results) if concat else results
