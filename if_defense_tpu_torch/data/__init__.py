"""The npz interchange schema."""

from if_defense_tpu_torch.data.npz import NpzData, load_npz, save_npz

__all__ = ["NpzData", "load_npz", "save_npz"]
