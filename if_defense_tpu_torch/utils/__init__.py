"""Params I/O and seeded weights."""

from if_defense_tpu_torch.utils.params_io import (
    init_params,
    load_params_npz,
    params_from_jax,
    save_params_npz,
)

__all__ = ["init_params", "load_params_npz", "params_from_jax",
           "save_params_npz"]
