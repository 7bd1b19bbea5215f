"""Point ops: pairwise distance, gather, exact kNN, farthest point sampling
and ball query (port of `if_defense_tpu/ops/pointops.py`).

FPS and ball query are kernels B5 and B6 (`ops/cuda_fps.py`,
`ops/cuda_ballquery.py`). `farthest_point_sample` / `query_ball_point`
launch them for CUDA tensors and take the plain versions here for CPU
tensors. The plain versions compute their distances elementwise in a fixed
order (no `bmm`, whose summation order the library picks), the order the
kernels use with no fused multiply-add, so kernel and plain version select
the same indices bit for bit.

The gather's backward on the card is a kernel of the port's own
(`ops/cuda_gather.py`, no TPU kernel): `torch.gather`'s adds with atomics
in an order that changes from run to run, so seeded victim training did
not repeat, and under deterministic algorithms it sorts and runs torch's
index backward, the largest cost of an attack iteration.
"""

from __future__ import annotations

import torch


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance between every pair, expansion form
    ``|s|^2 - 2 s.d + |d|^2`` in full f32.

    Args:
        src: [B, N, C]; dst: [B, M, C]
    Returns:
        [B, N, M]
    """
    s2 = (src * src).sum(-1, keepdim=True)                   # [B, N, 1]
    d2 = (dst * dst).sum(-1, keepdim=True)                   # [B, M, 1]
    cross = torch.bmm(src, dst.transpose(1, 2))
    return s2 - 2.0 * cross + d2.transpose(1, 2)


def pairwise_self_distance(xyz: torch.Tensor) -> torch.Tensor:
    """Squared L2 self-distance matrix, [B, N, 3] -> [B, N, N]."""
    return square_distance(xyz, xyz)


def index_points_plain(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version of `index_points`, `torch.gather`: under autograd
    on the CPU its backward (a `scatter_add_` into zeros) adds each point's
    rows one after another in row order."""
    B, _, C = points.shape
    flat = idx.reshape(B, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, C))
    return out.reshape(*idx.shape, C)


def _gather_backward(grad_out: torch.Tensor, flat: torch.Tensor,
                     num_points: int) -> torch.Tensor:
    """The kernel's gradient; bf16 and f16 gradients summed as their exact
    f32 upcast (in the kernel's order) and rounded to their type once."""
    from if_defense_tpu_torch.ops.cuda_gather import gather_backward_cuda

    if grad_out.dtype in (torch.bfloat16, torch.float16):
        return gather_backward_cuda(grad_out.float(), flat,
                                    num_points).to(grad_out.dtype)
    return gather_backward_cuda(grad_out, flat, num_points)


class _GatherBackward(torch.autograd.Function):
    """The gather's backward by the kernel, [B, M, C] -> [B, N, C]; its own
    backward is the gather, so a second derivative goes through."""

    @staticmethod
    def forward(ctx, grad_out, flat, num_points):
        ctx.save_for_backward(flat)
        return _gather_backward(grad_out, flat, num_points)

    @staticmethod
    def backward(ctx, grad_grad):
        (flat,) = ctx.saved_tensors
        return index_points(grad_grad, flat), None, None


class _IndexPoints(torch.autograd.Function):
    """The gather on the card: `torch.gather` forward (deterministic), the
    kernel backward."""

    @staticmethod
    def forward(ctx, points, flat):
        ctx.save_for_backward(flat)
        ctx.num_points = points.shape[1]
        C = points.shape[2]
        return torch.gather(points, 1,
                            flat.long()[..., None].expand(-1, -1, C))

    @staticmethod
    def backward(ctx, grad_out):
        (flat,) = ctx.saved_tensors
        return _GatherBackward.apply(grad_out, flat, ctx.num_points), None


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather: out[b, ..., c] = points[b, idx[b, ...], c], whose
    gradient adds each point's rows in row order (for f32, the same bits on
    the card and the CPU, run after run).

    On CUDA points that need a gradient the backward is the kernel
    (`ops/cuda_gather.py`; a kernel that fails to build or launch raises):
    f32 gradients as they are, bf16 and f16 ones (a mixed-precision
    victim's) summed as their exact f32 upcast in the same order and
    rounded once to their type, so they repeat run to run on the card but
    are not the CPU's bits in that type (the CPU's autograd rounds after
    each add); any other type raises TypeError. On CPU tensors, and where
    no gradient is taken, the plain version.

    Args:
        points: [B, N, C]; idx: [B, ...] integer indices into the N axis.
    Returns:
        [B, ..., C]
    """
    if not (points.is_cuda and points.requires_grad
            and torch.is_grad_enabled()):
        return index_points_plain(points, idx)
    B, _, C = points.shape
    flat = idx.reshape(B, -1)
    if flat.dtype not in (torch.int32, torch.int64):
        flat = flat.long()
    return _IndexPoints.apply(points, flat).reshape(*idx.shape, C)


def gather_neighbors(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Grouped neighbour gather, `index_points` (the JAX package's one-hot
    MXU form is a TPU device choice; on the GPU a gather is exact and
    cheap, and its backward the same fixed-order kernel)."""
    return index_points(points, idx)


def knn_points(k: int, xyz: torch.Tensor, query: torch.Tensor | None = None,
               exclude_self: bool = False, return_dist: bool = False,
               candidate_mask: torch.Tensor | None = None):
    """Exact k-nearest-neighbour indices of `query` within `xyz`.

    The JAX package's `method="sort"`: a stable sort of the expansion-form
    distances, so ties go to the lower index as with `lax.top_k`.
    `exclude_self` drops the first hit (self, at distance ~0). Points where
    the optional [B, N] `candidate_mask` is not > 0 sit at +inf and are
    never chosen while k valid points remain (fixed-shape masked forwards).

    Returns:
        idx [B, Q, k] (int64), optionally (idx, sqdist [B, Q, k]).
    """
    if query is None:
        query = xyz
    d = square_distance(query, xyz)                          # [B, Q, N]
    if candidate_mask is not None:
        d = d.masked_fill(~(candidate_mask > 0)[:, None, :], torch.inf)
    kk = k + 1 if exclude_self else k
    vals, idx = torch.sort(d, dim=-1, stable=True)
    vals, idx = vals[..., :kk], idx[..., :kk]
    if exclude_self:
        vals, idx = vals[..., 1:], idx[..., 1:]
    if return_dist:
        return idx, vals
    return idx


def knn_self(k: int, xyz: torch.Tensor, return_dist: bool = False):
    """kNN within a cloud excluding self (reference `pn_utils.knn_point`)."""
    return knn_points(k, xyz, exclude_self=True, return_dist=return_dist)


def farthest_point_sample_plain(xyz: torch.Tensor, npoint: int,
                                start_idx: torch.Tensor | None = None,
                                mask: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """Iterative farthest point sampling, plain version of kernel B5.

    Keeps a running min of squared distances to the selected set and
    takes the first maximum (the lowest index). Starts at `start_idx`, or
    at index 0, or, under a mask, at the first valid point. Invalid points
    sit at -inf and are never selected while a valid point remains.
    Distances are the difference form ((dx dx + dy dy) + dz dz).

    Args:
        xyz: [B, N, 3]; npoint: points to select.
        start_idx: optional [B] integer start per cloud.
        mask: optional [B, N] validity mask (> 0 is valid).
    Returns:
        [B, npoint] int32 indices.
    """
    xyz = xyz.detach()
    B, N, _ = xyz.shape
    if mask is None:
        valid = torch.ones((B, N), dtype=torch.bool, device=xyz.device)
    else:
        valid = mask > 0
    if start_idx is None:
        far = valid.to(torch.int32).argmax(dim=1)          # first valid (or 0)
    else:
        far = start_idx.to(device=xyz.device, dtype=torch.long)
    dist = torch.where(valid, torch.inf, -torch.inf).to(xyz.dtype)
    rows = torch.arange(B, device=xyz.device)
    x, y, z = xyz.unbind(-1)
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        c = xyz[rows, far]                                  # [B, 3]
        dx = x - c[:, 0:1]
        dy = y - c[:, 1:2]
        dz = z - c[:, 2:3]
        dist = torch.minimum(dist, (dx * dx + dy * dy) + dz * dz)
        far = dist.argmax(dim=1)
    return out


def query_ball_point_plain(radius: float, nsample: int, xyz: torch.Tensor,
                           new_xyz: torch.Tensor,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """Radius grouping with a fixed group size, plain version of kernel B6.

    Slot j of a centre holds the (j+1)-th point in index order with
    d2 <= radius**2; slots past the hit count repeat the first hit; a
    centre with no hit gets 0. Masked points are out of radius. d2 is the
    expansion (|q|^2 - 2 q.x) + |x|^2 with q.x = (qx xx + qy xy) + qz xz.
    Selection is a cumsum of hits and a search for each slot's rank, so no
    [B, S, N, nsample] indicator is built.

    Args:
        xyz: [B, N, 3] points; new_xyz: [B, S, 3] centres.
        mask: optional [B, N] validity mask (> 0 is valid).
    Returns:
        [B, S, nsample] int32 indices into N.
    """
    xyz, new_xyz = xyz.detach(), new_xyz.detach()
    N = xyz.shape[1]
    xx, xy, xz = (v[:, None, :] for v in xyz.unbind(-1))     # [B, 1, N]
    qx, qy, qz = (v[..., None] for v in new_xyz.unbind(-1))  # [B, S, 1]
    x2 = (xx * xx + xy * xy) + xz * xz
    q2 = (qx * qx + qy * qy) + qz * qz
    cross = (qx * xx + qy * xy) + qz * xz                    # [B, S, N]
    hit = (q2 - 2.0 * cross) + x2 <= radius ** 2
    if mask is not None:
        hit &= (mask > 0)[:, None, :]
    rank = hit.cumsum(dim=-1, dtype=torch.int32)             # [B, S, N]
    slots = torch.arange(1, nsample + 1, dtype=torch.int32,
                         device=xyz.device).expand(*rank.shape[:2], nsample)
    # position of the (j+1)-th hit; N when the centre has <= j hits
    idx = torch.searchsorted(rank, slots.contiguous(), out_int32=True)
    idx = torch.where(idx == N, idx[..., :1], idx)
    return torch.where(idx == N, 0, idx)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """bf16 points as f32, which holds every bf16 value exactly; other
    types as they are."""
    return x.float() if x.dtype == torch.bfloat16 else x


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start_idx: torch.Tensor | None = None,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Farthest point sampling: kernel B5 for CUDA tensors, the plain
    version for CPU tensors. [B, N, 3] -> [B, npoint] int32. bf16 points
    (a mixed-precision victim's) select in f32, on their exact upcast."""
    xyz = _f32(xyz)
    if xyz.is_cuda:
        from if_defense_tpu_torch.ops.cuda_fps import fps_cuda

        return fps_cuda(xyz, npoint, start_idx, mask)
    return farthest_point_sample_plain(xyz, npoint, start_idx, mask)


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """Ball query: kernel B6 for CUDA tensors, the plain version for CPU
    tensors. -> [B, S, nsample] int32. bf16 points and centres select in
    f32, on their exact upcast."""
    xyz, new_xyz = _f32(xyz), _f32(new_xyz)
    if xyz.is_cuda:
        from if_defense_tpu_torch.ops.cuda_ballquery import ballquery_cuda

        return ballquery_cuda(radius, nsample, xyz, new_xyz, mask)
    return query_ball_point_plain(radius, nsample, xyz, new_xyz, mask)
