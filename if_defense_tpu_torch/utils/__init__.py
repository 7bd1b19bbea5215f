"""Params I/O, seeded weights and the metrics sink."""

from if_defense_tpu_torch.utils.metrics import MetricsWriter
from if_defense_tpu_torch.utils.params_io import (
    flax_init_params,
    init_params,
    load_params_npz,
    params_from_jax,
    params_to_jax,
    save_params_npz,
)

__all__ = ["MetricsWriter", "flax_init_params", "init_params",
           "load_params_npz", "params_from_jax", "params_to_jax",
           "save_params_npz"]
