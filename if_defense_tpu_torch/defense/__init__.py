"""Defenses: SOR and the ConvONet-Opt restoration, with the repulsion loss."""

from if_defense_tpu_torch.defense.ifdefense import (
    convonet_opt_defense,
    make_opt_defense,
)
from if_defense_tpu_torch.defense.repulsion import repulsion_loss
from if_defense_tpu_torch.defense.sor import sor_defense

__all__ = ["convonet_opt_defense", "make_opt_defense", "repulsion_loss",
           "sor_defense"]
