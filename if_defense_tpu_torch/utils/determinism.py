"""Deterministic algorithms for a block of work, restored on exit.

    with deterministic():
        ...   # every op either repeats its bits from run to run or raises

Inside the block:
- `CUBLAS_WORKSPACE_CONFIG` is `:4096:8` where it was unset: cuBLAS's
  deterministic workspace. cuBLAS reads it once, when the process makes
  its first cuBLAS handle, so it takes effect only where the block (or the
  caller, before any CUDA work) sets it first; torch checks it at each
  cuBLAS call under deterministic algorithms and raises where it is unset;
- `torch.use_deterministic_algorithms(True)`: cuDNN chooses deterministic
  algorithms, torch's deterministic forms replace atomic ones (`gather`'s
  backward sorts), and an op with no deterministic form raises instead of
  drifting (`max_pool3d`'s CUDA backward in torch 2.11);
- `torch.backends.cudnn.benchmark` is off, so cuDNN does not time
  algorithms and pick by the clock.
On exit the caller's flags (the warn-only setting included), benchmark
setting and environment variable are put back.

`setting(name)` runs a block in one of `SETTINGS`, to time what each part
of that costs: `deterministic` is `deterministic()`, `no fill` the same
without torch's NaN fill of each new tensor, `free` deterministic
algorithms off.
"""

from __future__ import annotations

import contextlib
import os

import torch

# cuBLAS's deterministic workspace
CUBLAS_WORKSPACE = ":4096:8"


@contextlib.contextmanager
def deterministic():
    """Run the block under deterministic algorithms (module docstring)."""
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    flag = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    benchmark = torch.backends.cudnn.benchmark
    if env is None:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = benchmark
        torch.use_deterministic_algorithms(flag, warn_only=warn_only)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


SETTINGS = ("deterministic", "no fill", "free")


@contextlib.contextmanager
def setting(name: str):
    """Run the block in the setting `name` of `SETTINGS` (module
    docstring); the caller's flags and fill setting are put back."""
    if name not in SETTINGS:
        raise ValueError(f"setting {name!r} is not one of {SETTINGS}")
    fill = torch.utils.deterministic.fill_uninitialized_memory
    flag = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.utils.deterministic.fill_uninitialized_memory = name != "no fill"
    try:
        if name == "free":
            torch.use_deterministic_algorithms(False)
            yield
        else:
            with deterministic():
                yield
    finally:
        torch.utils.deterministic.fill_uninitialized_memory = fill
        torch.use_deterministic_algorithms(flag, warn_only=warn_only)
