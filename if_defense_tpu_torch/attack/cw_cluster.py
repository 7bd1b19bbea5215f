"""CW Add-Cluster and Add-Object attacks (port of
`if_defense_tpu/attack/cw_cluster.py`; CVPR'19 adversarial clusters and
objects, `Add_Cluster.py:48-278`, `Add_Objects.py:50-367`).

The vulnerable-region initialisation is a one-shot host step: DBSCAN over
128 critical points a cloud, in numpy with `np.random.default_rng(seed)`,
a copy of the JAX package's. The optimisation runs through the shared CW
binary search (`attack/cw.py`).

Random draws come from `generator`; the `draws` seam takes them from the
caller instead: for the clusters the init normals [binary_step, B, num_add
* cl_num_p, 3]; for the objects per binary step (normals of the objects
[binary_step, B, num_add, obj_num_p, 3], normals of the shifts and
uniforms in [0, 1) of the angles, both [binary_step, B, num_add, 3]), as
JAX's three keys of a step draw them.
"""

from __future__ import annotations

import math
import os
from typing import Callable

import numpy as np
import torch

from if_defense_tpu_torch.attack.cw import (
    add_search,
    cw_binary_search,
    get_critical_points,
    normal_like,
    step_noise,
)
from if_defense_tpu_torch.attack.losses import (
    chamfer_dist,
    farthest_dist,
    l2_dist,
    logits_adv_loss,
)

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")


def dbscan_labels(points: np.ndarray, eps: float, min_samples: int):
    """Minimal DBSCAN over a small point set; labels, -1 for noise."""
    n = len(points)
    d = ((points[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    neighbors = [np.where(d[i] <= eps * eps)[0] for i in range(n)]
    core = np.array([len(nb) >= min_samples for nb in neighbors])
    labels = np.full(n, -1)
    cluster = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        # breadth-first expansion from this core point
        labels[i] = cluster
        queue = list(neighbors[i])
        while queue:
            j = queue.pop()
            if labels[j] == -1:
                labels[j] = cluster
                if core[j]:
                    queue.extend(neighbors[j])
        cluster += 1
    return labels


def _regions(points: np.ndarray, eps: float, min_samples: int):
    """DBSCAN's clustered points and labels (every point in one cluster
    where DBSCAN finds none), and its clusters from smallest to largest."""
    labels = dbscan_labels(points, eps, min_samples)
    keep = labels >= 0
    lab, pts = labels[keep], points[keep]
    if len(pts) == 0:
        lab, pts = np.zeros(len(points), int), points
    uniq, counts = np.unique(lab, return_counts=True)
    return lab, pts, uniq[np.argsort(counts)]


def _init_clusters(cri_points: np.ndarray, num_add: int, cl_num_p: int,
                   rng: np.random.Generator, eps: float = 0.2,
                   min_samples: int = 3) -> np.ndarray:
    """`num_add` vulnerable regions of `cl_num_p` points a cloud
    (`Add_Cluster.py:83-130`): the largest DBSCAN clusters of the critical
    points, each resampled to `cl_num_p` points, then kNN balls around
    random critical points where the clusters are too few."""
    B = len(cri_points)
    out = np.zeros((B, num_add, cl_num_p, 3), np.float32)
    for i in range(B):
        lab, pts, by_size = _regions(cri_points[i], eps, min_samples)
        clusters = []
        for c in by_size[-num_add:]:
            cp = pts[lab == c]
            idx = rng.choice(len(cp), cl_num_p, replace=len(cp) <= cl_num_p)
            clusters.append(cp[idx])
        while len(clusters) < num_add:
            center = pts[rng.integers(0, len(pts))]
            nn = np.argsort(((pts - center) ** 2).sum(-1))[:cl_num_p]
            ball = pts[nn]
            if len(ball) < cl_num_p:
                ball = ball[rng.choice(len(ball), cl_num_p, replace=True)]
            clusters.append(ball)
        out[i] = np.stack(clusters[:num_add])
    return out


def _init_object_centers(cri_points: np.ndarray, num_add: int,
                         rng: np.random.Generator, eps: float = 0.2,
                         min_samples: int = 3) -> np.ndarray:
    """Seeds for the objects' placement (`Add_Objects.py:100-145`): the
    point nearest the mean of each of the largest DBSCAN clusters, then
    random critical points where the clusters are too few."""
    B = len(cri_points)
    out = np.zeros((B, num_add, 3), np.float32)
    for i in range(B):
        lab, pts, by_size = _regions(cri_points[i], eps, min_samples)
        centers = []
        for c in by_size[-num_add:]:
            cp = pts[lab == c]
            mean = cp.mean(0)
            centers.append(cp[np.argmin(((cp - mean) ** 2).sum(-1))])
        while len(centers) < num_add:
            centers.append(pts[rng.integers(0, len(pts))])
        out[i] = np.stack(centers[:num_add])
    return out


def far_chamfer_dist(added: torch.Tensor, ori: torch.Tensor, num_add: int,
                     chamfer_weight: float = 0.1) -> torch.Tensor:
    """FarthestDist + 0.1 Chamfer (`dist_utils.py:239-276`), [B]."""
    clusters = added.reshape(added.shape[0], num_add, -1, 3)
    return farthest_dist(clusters) + chamfer_weight * chamfer_dist(added, ori)


def _critical_numpy(logits_fn, data, target) -> np.ndarray:
    return get_critical_points(logits_fn, data, target, 128).cpu().numpy()


def cw_add_cluster(
    logits_fn: Callable,
    data: torch.Tensor,
    target: torch.Tensor,
    generator: torch.Generator | None = None,
    adv_fn: Callable = logits_adv_loss,
    num_add: int = 3,
    cl_num_p: int = 32,
    attack_lr: float = 1e-2,
    init_weight: float = 5.0,
    max_weight: float = 30.0,
    binary_step: int = 5,
    num_iter: int = 500,
    seed: int = 0,
    device_chunk_iters: int | None = None,
    draws: torch.Tensor | None = None,
):
    """CW adversarial-cluster attack.

    Returns:
        (best distance [B], adv [B, K + num_add * cl_num_p, 3], success).
    """
    clusters = _init_clusters(_critical_numpy(logits_fn, data, target),
                              num_add, cl_num_p, np.random.default_rng(seed))
    flat0 = torch.from_numpy(clusters.reshape(
        len(clusters), num_add * cl_num_p, 3)).to(data.device)
    return add_search(
        logits_fn, lambda added, ori: far_chamfer_dist(added, ori, num_add),
        adv_fn, data, step_noise(flat0, binary_step, generator, draws),
        target, attack_lr=attack_lr, init_weight=init_weight,
        max_weight=max_weight, binary_step=binary_step, num_iter=num_iter,
        device_chunk_iters=device_chunk_iters)


def _rotate_shift(objects: torch.Tensor, angles: torch.Tensor,
                  shifts: torch.Tensor) -> torch.Tensor:
    """Rotate each object about y by angles[..., 0], then translate:
    objects [B, na, P, 3], angles and shifts [B, na, 3] -> [B, na, P, 3]
    (`Add_Objects.py:148-185`; only the y rotation is used)."""
    ang = angles[..., 0]
    c, s = torch.cos(ang), torch.sin(ang)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([c, z, s, z, o, z, -s, z, c], dim=-1).reshape(
        *ang.shape, 3, 3)                                    # [B, na, 3, 3]
    rotated = torch.einsum("bnpc,bncd->bnpd", objects, rot)
    return rotated + shifts[:, :, None, :]


def load_airplane(obj_num_p: int, num_add: int, scaling: float,
                  rng: np.random.Generator) -> np.ndarray:
    """The template object, `num_add` resamplings of `obj_num_p` points,
    centred, in the unit ball and scaled (`Add_Objects.py:76-98`)."""
    pc = np.load(os.path.join(ASSET_DIR, "airplane.npy")).astype(np.float32)
    out = np.zeros((num_add, obj_num_p, 3), np.float32)
    for i in range(num_add):
        sel = pc[rng.permutation(len(pc))[:obj_num_p]]
        sel = sel - sel.mean(0)
        sel = sel / np.sqrt((sel**2).sum(-1)).max()
        out[i] = sel * scaling
    return out


def cw_add_object(
    logits_fn: Callable,
    data: torch.Tensor,
    target: torch.Tensor,
    generator: torch.Generator | None = None,
    adv_fn: Callable = logits_adv_loss,
    num_add: int = 3,
    obj_num_p: int = 64,
    scaling: float = 0.3,
    chamfer_weight: float = 0.2,
    attack_lr: float = 1e-2,
    init_weight: float = 5.0,
    max_weight: float = 40.0,
    binary_step: int = 5,
    num_iter: int = 500,
    seed: int = 0,
    device_chunk_iters: int | None = None,
    draws: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
):
    """CW adversarial-object attack: rigid copies of the template whose
    points, y rotation and placement are optimised together. The
    variables are (objects, angles, shifts); each step wraps the angles
    into [0, 2 pi).

    Returns:
        (best distance [B], adv [B, K + num_add * obj_num_p, 3], success).
    """
    B, dev = data.shape[0], data.device
    ori = data
    rng = np.random.default_rng(seed)
    template = load_airplane(obj_num_p, num_add, scaling, rng)
    objects0 = torch.from_numpy(np.tile(template[None], (B, 1, 1, 1))).to(dev)
    centers = torch.from_numpy(_init_object_centers(
        _critical_numpy(logits_fn, ori, target), num_add, rng)).to(dev)
    if draws is not None and any(d.shape[0] != binary_step for d in draws):
        raise ValueError(f"draws must hold {binary_step} binary steps")

    def init(step):
        if draws is None:
            n_obj = normal_like(objects0, generator)
            n_shift = normal_like(centers, generator)
            u = torch.rand(centers.shape, generator=generator,
                           dtype=centers.dtype, device=dev)
        else:
            n_obj, n_shift, u = (d[step] for d in draws)
        # jax.random.uniform(maxval=pi): u * (pi - 0) + 0 in f32
        return [objects0 + n_obj * 1e-7, u * math.pi,
                centers + n_shift * 1e-7]

    def points(adv):
        objs, angles, shifts = adv
        pts = _rotate_shift(objs, angles, shifts)
        return pts.reshape(pts.shape[0], -1, 3)

    def dist(adv):
        l2 = l2_dist(adv[0].reshape(B, -1, 3), objects0.reshape(B, -1, 3))
        return l2 + chamfer_weight * chamfer_dist(points(adv), ori)

    def wrap(adv):
        adv[1].copy_(torch.remainder(adv[1], 2 * math.pi))

    obd, best_added, success = cw_binary_search(
        lambda adv: logits_fn(torch.cat([ori, points(adv)], dim=1)),
        dist, adv_fn, init, target, attack_lr=attack_lr,
        init_weight=init_weight, max_weight=max_weight,
        binary_step=binary_step, num_iter=num_iter, record_fn=points,
        postprocess_fn=wrap, device_chunk_iters=device_chunk_iters)
    return obd, torch.cat([ori, best_added], dim=1), success
