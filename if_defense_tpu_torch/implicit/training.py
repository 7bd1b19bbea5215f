"""Occupancy-network training, ONet and ConvONet (port of
`if_defense_tpu/implicit/training.py`).

BCE on the occupancy labels of query points, conditioned on a noisy
surface point cloud (`pointcloud_n` points + N(0, 0.005) noise,
`points_subsample` 2048 queries), Adam. The dataset is one npz of per-shape
arrays:
    pointcloud [S, N, 3]   surface samples (encoder input pool)
    points     [S, P, 3]   query points in the padded unit cube
    points_occ [S, P]      occupancy labels {0, 1}

The JAX package jits the step; the port runs it eagerly. For the plane
ConvONet the three plane lookups of the decoder go through kernel B4 on a
CUDA device, forward and plane gradient (the queries are data, so no uv
gradient); the encoder's pooled max and scatter-mean through the port's
fixed-order kernels (`ops/cuda_scatter.py`) both ways; the grid ConvONet's
volume is sampled by `trilinear_grid_sample`. Under deterministic
algorithms (`utils.determinism`, as `cli/train_implicit.py` runs) a step
of either variant repeats its bits on the card: cuDNN's convolutions and
the trilinear gathers' backward take torch's deterministic forms, and the
3D UNet's max-pool has a backward of its own (`unet3d.max_pool3d_2x`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.nn import functional as F

from if_defense_tpu_torch.implicit.convonet import ConvOccupancyNetwork
from if_defense_tpu_torch.implicit.onet import OccupancyNetwork
from if_defense_tpu_torch.utils.params_io import (
    flax_init_params,
    params_from_jax,
)


@dataclasses.dataclass
class OccupancyBatchSampler:
    """Host-side batch sampler over the occupancy npz arrays (numpy; the
    same batches as the JAX package's for the same seed)."""

    pointcloud: np.ndarray
    points: np.ndarray
    points_occ: np.ndarray
    pointcloud_n: int = 300
    pointcloud_noise: float = 0.005
    points_subsample: int = 2048
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)

    def __len__(self):
        return len(self.pointcloud)

    def sample(self, batch_size: int):
        """Returns (inputs [B, n, 3], queries [B, p, 3], occ [B, p])."""
        idx = self.rng.integers(0, len(self.pointcloud), batch_size)
        pcs = self.pointcloud[idx]
        sel = self.rng.integers(
            0, pcs.shape[1], (batch_size, self.pointcloud_n))
        inputs = np.take_along_axis(pcs, sel[..., None], axis=1)
        inputs = inputs + self.rng.normal(
            0, self.pointcloud_noise, inputs.shape)
        qsel = self.rng.integers(
            0, self.points.shape[1], (batch_size, self.points_subsample))
        queries = np.take_along_axis(self.points[idx], qsel[..., None], 1)
        occ = np.take_along_axis(self.points_occ[idx], qsel, 1)
        return (
            inputs.astype(np.float32),
            queries.astype(np.float32),
            occ.astype(np.float32),
        )


def make_occupancy_train_step(model: torch.nn.Module,
                              learning_rate: float = 1e-4):
    """-> (optimizer, step). `step(inputs, queries, occ)` puts the model in
    training mode (ONet's batch norms then normalise with the batch and
    update their running statistics), takes one Adam step (optax's
    defaults: b1 0.9, b2 0.999, eps 1e-8, bias-corrected) on the mean
    BCE-with-logits against `occ`, and returns `{"loss", "acc"}` as 0-d
    tensors; the step's gradients stay in `.grad` until the next step."""
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)

    def step(inputs: torch.Tensor, queries: torch.Tensor,
             occ: torch.Tensor) -> dict[str, torch.Tensor]:
        model.train()
        opt.zero_grad(set_to_none=True)
        logits = model(inputs, queries)
        loss = F.binary_cross_entropy_with_logits(logits, occ)
        loss.backward()
        opt.step()
        with torch.no_grad():
            acc = ((logits > 0) == (occ > 0.5)).float().mean()
        return {"loss": loss.detach(), "acc": acc}

    return opt, step


def init_occupancy_model(model: torch.nn.Module, seed: int) -> dict:
    """Load `flax_init_params(seed, ...)` for the model's variant, widths,
    plane types and UNet depths into `model`; returns the flax-layout
    variables."""
    from if_defense_tpu_torch.implicit.pointnetpp_encoder import PointConvONet

    if isinstance(model, ConvOccupancyNetwork):
        enc = model.encoder
        variables = flax_init_params(
            seed, "convonet", c_dim=enc.fc_c.out_features,
            hidden_dim=enc.fc_c.in_features, plane_type=model.plane_type,
            grid_resolution=enc.grid_reso,
            unet3d_depth=enc.unet3d.depth if enc.unet3d is not None else 3)
    elif isinstance(model, OccupancyNetwork):
        fc_c = model.encoder.fc_c
        variables = flax_init_params(
            seed, "onet", c_dim=fc_c.out_features, hidden_dim=fc_c.in_features,
            decoder_hidden=model.decoder.fc_p.out_features, z_dim=model.z_dim)
    elif isinstance(model, PointConvONet):
        variables = flax_init_params(
            seed, "pointconvonet",
            c_dim=model.decoder.fc_c_0.in_features,
            hidden_dim=model.decoder.fc_p.out_features)
    else:
        raise TypeError(f"not an occupancy network: {type(model).__name__}")
    model.load_state_dict(params_from_jax(variables, model), strict=True)
    return variables
