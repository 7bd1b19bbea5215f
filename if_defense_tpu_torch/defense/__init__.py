"""Defenses: SRS, SOR, DUP-Net (SOR + PU-Net) and the ConvONet-Opt
restoration, with the repulsion loss."""

from if_defense_tpu_torch.defense.dupnet import DUPNet, process_data_fixed
from if_defense_tpu_torch.defense.ifdefense import (
    convonet_opt_defense,
    make_opt_defense,
)
from if_defense_tpu_torch.defense.punet import PUNet
from if_defense_tpu_torch.defense.repulsion import repulsion_loss
from if_defense_tpu_torch.defense.sor import (
    compact_by_mask,
    sor_defense,
    sor_defense_fixed,
)
from if_defense_tpu_torch.defense.srs import srs_defense

__all__ = ["DUPNet", "PUNet", "compact_by_mask", "convonet_opt_defense",
           "make_opt_defense", "process_data_fixed", "repulsion_loss",
           "sor_defense", "sor_defense_fixed", "srs_defense"]
