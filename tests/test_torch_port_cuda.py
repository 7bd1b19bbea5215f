"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Each test carries the `cuda` marker and skips where no CUDA device is
present (decided at run time by the `cuda` fixture). This file imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Tolerances: losses rtol 1e-5 (atol 1e-9); gradients rtol 1e-4 in f32 and
2^-7 (one bf16 rounding) in bf16, with atol 1e-5 of the largest entry
(pair terms summed in other orders); the B2 mask bit-equal; B1 and B3 also
bit-identical from one launch to the next; B4 (the fused plane features)
against the plain version on f32 copies, cast once (the kernel's math is
f32): output bit-equal in f32, gradients to p rtol 1e-4 and
to the planes atol 1e-5 of the largest entry (sums in other orders), rtol
2^-7 in bf16, and bit-identical from one launch to the next; B5 (FPS) and
B6 (ball query) indices bit-equal at PU-Net's four set-abstraction shapes
and past the sizes their kernels keep in registers and shared memory,
masked and not; B6 also at the victims' radii with 48-128 slots that
centres fill (slots past those a block keeps in shared memory too), at
ragged N and S, at shapes where the kernel sets 1, 2, 4 and 8 warps on
a group of centres, and at B = 65536; B2, B5 and B6 bit-identical from one launch
to the next. B1-B3 also at k = 9, 16 and 33 (the threshold scan above the
register top-k). The five victims on the card against their CPU path:
logits within rtol 1e-3 and atol 1e-3 of the largest magnitude. B4's uv
form (`plane_sample_cuda`) against `bilinear_plane_sample` with B4's
tolerances, and both forms at channel counts that fill no 16-byte word
(6 f32, 6 and 12 bf16). The grid ConvONet (encode, decode, gradient to p)
on the card against its CPU path within 1e-4 of the largest magnitude
(TF32 off; the 3D UNet's convolutions sum in other orders), the gradient
to p at >= 99.9 % of its entries (a ReLU within rounding of its kink).
FPS and
ball query on bf16 points bit-equal to the plain versions on their f32
upcast; PointNet with a bf16 trunk within 2 % of its f32 logits. One
PointNet++ train step on the card launches B5 and B6 and matches the CPU
step: loss rtol 1e-4, gradients in direction (cosine >= 0.999 per tensor),
batch statistics within 1e-4 of their scale.
"""

import numpy as np
import pytest
import torch

from if_defense_tpu_torch.defense.repulsion import (
    repulsion_loss_masked,
    repulsion_loss_threshold,
    repulsion_mask,
)
from if_defense_tpu_torch.ops.interp import plane_features
from if_defense_tpu_torch.ops.pointops import (
    farthest_point_sample_plain,
    query_ball_point_plain,
)

pytestmark = pytest.mark.cuda

# PU-Net's set-abstraction levels: (input points, centres, radius)
SA_LEVELS = ((1024, 1024, 0.05), (1024, 512, 0.1), (512, 256, 0.2),
             (256, 128, 0.3))


def _warps_a_group(b, n, s):
    """The warps that B6 sets on each group of 32 centres for these shapes
    (`csrc/ballquery.cu` `auto_splits`): more where the centres are few, no
    more than a chunk's 32-point steps allow."""
    warps, steps, p = b * -(-s // 32), -(-min(n, 4096) // 32), 1
    while warps < 2048 and p < 8 and warps * p < 4096 and 2 * p <= steps:
        p *= 2
    return p


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _points(seed, n=256):
    pc = np.random.default_rng(seed).uniform(-0.4, 0.4, (2, n, 3))
    pc = pc.astype(np.float32)
    pc[:, n - n // 2:] = pc[:, : n // 2]      # resampling repeats points
    return pc


def _lattice(n, seed):
    """2 clouds of the first n nodes of an s x s x s grid at spacing 1/16
    (every d2 exact, so rows tie at their k-th smallest), s = 16 up to 4096
    points, each in its own random order."""
    rng = np.random.default_rng(seed)
    side = max(16, int(np.ceil(n ** (1 / 3))))
    axes = np.arange(side) - side // 2
    grid = np.stack(np.meshgrid(axes, axes, axes, indexing="ij"),
                    -1).reshape(-1, 3)[:n] / 16
    return np.stack([grid[rng.permutation(n)] for _ in range(2)]).astype(
        np.float32)


def _value_grad(fn, x, w):
    x = x.detach().requires_grad_(True)
    out = fn(x)
    (g,) = torch.autograd.grad((out * w).sum(), x)
    return out.detach().cpu(), g.cpu()


def _grad_close(got, want, rtol):
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=rtol,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_repulsion_kernels_match_plain(cuda, dtype):
    from if_defense_tpu_torch.ops import cuda_repulsion as cr

    pc = torch.from_numpy(_points(6)).to(cuda, dtype)
    w = torch.tensor([1.0, 2.0], device=cuda)
    rtol = 1e-4 if dtype == torch.float32 else 2.0**-7
    lk, gk = _value_grad(cr.repulsion_loss_cuda, pc, w)
    lp, gp = _value_grad(repulsion_loss_threshold, pc, w)
    torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-9)
    _grad_close(gk, gp, rtol)
    mask = cr.repulsion_mask_cuda(pc)
    assert torch.equal(mask, repulsion_mask(pc))
    lk, gk = _value_grad(
        lambda x: cr.repulsion_loss_masked_cuda(x, mask), pc, w)
    lp, gp = _value_grad(lambda x: repulsion_loss_masked(x, mask), pc, w)
    torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-9)
    _grad_close(gk, gp, rtol)


@pytest.mark.parametrize("n", [300, 1000, 1024, 4096, 4097, 6000])
@pytest.mark.parametrize("cloud", ["lattice", "duplicates", "cluster"])
def test_cuda_repulsion_kernels_on_ties(cuda, cloud, n):
    """B1, B2 and B3 against their plain versions where rows tie at their
    threshold, for k in {1, 5, 8}, f32 and bf16; N not a multiple of 32 or
    of B3's 16-byte words (300, 1000), and above 1024, where B1's forward
    computes its distances twice and the kernels stage j in chunks (4096,
    and 4097 and 6000: past the 4096 points the kernels once refused, and
    past one chunk of 4096 in B1's backward and two of 2048 in B2). In
    "cluster" 100 points coincide: their rows tie 99 ways at 0, more than a
    warp's list of weighted pairs holds. Two launches on one input give
    bit-identical losses and gradients."""
    from if_defense_tpu_torch.ops import cuda_repulsion as cr

    if cloud == "lattice":
        pts = _lattice(n, n)
    else:
        pts = _points(n, n)
        if cloud == "cluster":
            pts[:, 100:200] = pts[:, :1]
    pts = torch.from_numpy(pts).to(cuda)
    w = torch.tensor([1.0, 2.0], device=cuda)
    for k in (1, 5, 8):
        for dtype, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 2.0**-7)):
            pc = pts.to(dtype)
            mask = cr.repulsion_mask_cuda(pc, k)
            assert torch.equal(mask, repulsion_mask(pc, k))
            pairs = (
                (lambda x: cr.repulsion_loss_cuda(x, k),
                 lambda x: repulsion_loss_threshold(x, k)),
                (lambda x: cr.repulsion_loss_masked_cuda(x, mask, k),
                 lambda x: repulsion_loss_masked(x, mask, k)))
            for kern, plain in pairs:
                lk, gk = _value_grad(kern, pc, w)
                lk2, gk2 = _value_grad(kern, pc, w)
                assert torch.equal(lk, lk2) and torch.equal(gk, gk2)
                lp, gp = _value_grad(plain, pc, w)
                torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-9)
                _grad_close(gk, gp, rtol)


PLANE_NAMES = ("xz", "xy", "yz")


def _plane_inputs(cuda, seed, n_planes, dtype, b=2, q=1000, res=64, c=32):
    """Planes N(0, 1), p from [-0.6, 0.6]^3 (the normalisation clamps about
    one coordinate in ten), the output's cotangent N(0, 1); p and the
    planes in `dtype`."""
    rng = np.random.default_rng(seed)

    def dev(a):
        return torch.from_numpy(a.astype(np.float32)).to(cuda, dtype)

    planes = {n: dev(rng.normal(size=(b, res, res, c)))
              for n in PLANE_NAMES[:n_planes]}
    return (dev(rng.uniform(-0.6, 0.6, (b, q, 3))), planes,
            dev(rng.normal(size=(b, q, c))))


def _features(fn, p, planes, g, want_p, want_planes):
    """fn's output and the gradients asked for, fed the cotangent g."""
    p = p.clone().requires_grad_(want_p)
    planes = {n: t.clone().requires_grad_(want_planes)
              for n, t in planes.items()}
    out = fn(p, planes)
    wrt = ([p] if want_p else []) + (list(planes.values()) if want_planes
                                     else [])
    grads = torch.autograd.grad(out, wrt, g.to(out.dtype)) if wrt else ()
    return [out.detach()] + [x.detach() for x in grads]


def _plain_f32(p, planes):
    """The kernel's semantics: the plain version in f32, cast once to the
    planes' type (the plain version in bf16 normalises in bf16, whose
    rounding moves a coordinate by up to (R - 1) 2^-9 cells)."""
    return plane_features(p.float(), {n: t.float() for n, t in planes.items()},
                          0.1).to(next(iter(planes.values())).dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_planes", [1, 2, 3])
def test_cuda_plane_sample_matches_plain(cuda, n_planes, dtype):
    """Fused B4 (`plane_features_cuda`) forward and gradient to p against
    the plain version: forward bit-equal in f32 (the kernel rounds as the
    plain composition does on the card), dp rtol 1e-4 with atol
    1e-5 of the largest entry (channel sums in other orders); rtol 2^-7 in
    bf16 (one rounding of the f32 result). One launch forward, one for dp;
    two launches give the same bits."""
    from if_defense_tpu_torch.ops.cuda_interp import launches, plane_features_cuda

    p, planes, g = _plane_inputs(cuda, n_planes, n_planes, dtype)
    rtol = 1e-4 if dtype == torch.float32 else 2.0**-7
    before = dict(launches)
    ok, dk = _features(plane_features_cuda, p, planes, g, True, False)
    assert launches["plane_features"] - before["plane_features"] == 1
    assert launches["plane_features_dp"] - before["plane_features_dp"] == 1
    assert launches["plane_features_dplane"] == before["plane_features_dplane"]
    assert ok.dtype == dtype and dk.dtype == dtype
    op, dp = _features(_plain_f32, p, planes, g, True, False)
    if dtype == torch.float32:
        assert torch.equal(ok, op)
    else:
        _grad_close(ok.cpu(), op.cpu(), rtol)
    _grad_close(dk.cpu(), dp.cpu(), rtol)
    # zero exactly where the clamp holds a coordinate in every plane
    assert torch.equal(dk == 0, dp == 0) and bool((dp == 0).any())
    ok2, dk2 = _features(plane_features_cuda, p, planes, g, True, False)
    assert torch.equal(ok, ok2) and torch.equal(dk, dk2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_planes", [1, 2, 3])
def test_cuda_plane_gradient_matches_plain(cuda, n_planes, dtype):
    """The planes' gradients alone (training) and with the gradient to p,
    against the plain version: atol 1e-5 of the largest entry (the plain
    version's gather backward adds in another order), rtol 2^-7 in bf16;
    the border cells take the clamped queries' weights. One launch for the
    planes' gradients whatever their number; two launches give the same
    bits."""
    from if_defense_tpu_torch.ops.cuda_interp import launches, plane_features_cuda

    p, planes, g = _plane_inputs(cuda, 10 + n_planes, n_planes, dtype,
                                 q=2000)
    rtol = 0.0 if dtype == torch.float32 else 2.0**-7
    for want_p in (False, True):
        before = dict(launches)
        got = _features(plane_features_cuda, p, planes, g, want_p, True)
        assert launches["plane_features_dplane"] \
            - before["plane_features_dplane"] == 1
        assert launches["plane_features_dp"] \
            - before["plane_features_dp"] == int(want_p)
        want = _features(_plain_f32, p, planes, g, want_p, True)
        again = _features(plane_features_cuda, p, planes, g, want_p, True)
        for a, b, c in zip(got, want, again):
            assert a.dtype == dtype and torch.equal(a, c)
            _grad_close(a.cpu(), b.cpu(), rtol)
        dplanes = want[1 + want_p:]
        assert all(float(d[:, 0, 0].float().abs().sum()) > 0 for d in dplanes)
    # only the planes asked for get a gradient
    names = list(planes)
    q = {n: t.clone().requires_grad_(n == names[0]) for n, t in planes.items()}
    before = dict(launches)
    (d0,) = torch.autograd.grad(plane_features_cuda(p, q), [q[names[0]]],
                                g)
    assert launches["plane_features_dplane"] - before["plane_features_dplane"] \
        == 1
    _grad_close(d0.cpu(), _features(_plain_f32, p, planes, g, False, True)[1]
                .cpu(), rtol)


def _sa_inputs(cuda, seed, n, masked):
    """4 clouds of n points; cloud 0 is duplicated (FPS to n points ends in
    0s); under a mask ~80 % valid and cloud 3 all invalid."""
    rng = np.random.default_rng(seed)
    pc = (rng.normal(size=(4, n, 3)) * 0.3).astype(np.float32)
    pc[0, n // 2:] = pc[0, : n // 2]
    mask = None
    if masked:
        mask = torch.from_numpy(rng.uniform(size=(4, n)) > 0.2).to(cuda)
        mask[3] = False
    return torch.from_numpy(pc).to(cuda), mask


@pytest.mark.parametrize("masked", [False, True])
def test_cuda_fps_matches_plain(cuda, masked):
    from if_defense_tpu_torch.ops.cuda_fps import fps_cuda

    for level, (n, npoint, _) in enumerate(SA_LEVELS):
        x, mask = _sa_inputs(cuda, level, n, masked)
        got = fps_cuda(x, npoint, mask=mask)
        assert got.dtype == torch.int32
        assert torch.equal(got, farthest_point_sample_plain(x, npoint,
                                                            mask=mask))
    start = torch.tensor([5, 0, 255, 100], device=cuda)
    assert torch.equal(fps_cuda(x, 64, start), farthest_point_sample_plain(
        x, 64, start))


@pytest.mark.parametrize("masked", [False, True])
def test_cuda_ballquery_matches_plain(cuda, masked):
    from if_defense_tpu_torch.ops.cuda_ballquery import ballquery_cuda

    for level, (n, s, radius) in enumerate(SA_LEVELS):
        x, mask = _sa_inputs(cuda, 10 + level, n, masked)
        q = x[:, :s].contiguous()
        q[:, :4] += 5.0                                    # no hit
        got = ballquery_cuda(radius, 32, x, q, mask)
        assert got.dtype == torch.int32
        assert torch.equal(got, query_ball_point_plain(radius, 32, x, q,
                                                       mask))


@pytest.mark.parametrize("n", [8192, 8193, 16385, 40000])
def test_cuda_fps_any_n(cuda, n):
    """B5 at the register tier's largest cloud (8192 points, 1024 threads)
    and above it, where the running minima live in device memory: indices
    bit-equal to the plain version, unmasked, masked and from `start_idx`;
    two launches give the same bits."""
    from if_defense_tpu_torch.ops.cuda_fps import fps_cuda

    rng = np.random.default_rng(n)
    x = torch.from_numpy((rng.normal(size=(2, n, 3)) * 0.3).astype(
        np.float32)).to(cuda)
    mask = torch.from_numpy(rng.uniform(size=(2, n)) > 0.2).to(cuda)
    mask[1, :7] = False
    mask[1, 7] = True
    start = torch.tensor([n - 1, 12345 % n], device=cuda)
    for m, st in ((None, None), (mask, None), (None, start), (mask, start)):
        got = fps_cuda(x, 512, st, m)
        assert torch.equal(got, farthest_point_sample_plain(x, 512, st, m))
        assert torch.equal(got, fps_cuda(x, 512, st, m))
    assert int(fps_cuda(x, 512, mask=mask)[1, 0]) == 7


@pytest.mark.parametrize("n", [1024, 40000])
def test_cuda_fps_degenerate_clouds(cuda, n):
    """B5 on a cloud whose points all coincide (every distance 0 after the
    first pick: index 0 again and again) and on a wholly invalid cloud
    (every key -inf: index 0 throughout), in both tiers, as the plain
    version."""
    from if_defense_tpu_torch.ops.cuda_fps import fps_cuda

    x = torch.full((2, n, 3), 0.25, device=cuda)
    x[1] = torch.linspace(-1, 1, n, device=cuda)[:, None]
    mask = torch.ones((2, n), dtype=torch.bool, device=cuda)
    mask[1] = False
    for m in (None, mask):
        got = fps_cuda(x, 300, mask=m)
        assert torch.equal(got, farthest_point_sample_plain(x, 300, mask=m))
    assert bool((fps_cuda(x, 300)[0] == 0).all())
    assert bool((fps_cuda(x, 300, mask=mask)[1] == 0).all())


@pytest.mark.parametrize("n", [4096, 4097, 12288, 12289, 40000])
def test_cuda_ballquery_any_n(cuda, n):
    """B6 at the largest cloud it stages in shared memory at once (4096
    points) and above it, where it stages the cloud chunk after chunk (B =
    2, 512 centres, 32 slots: 8 warps a group of centres; up to 4097 points
    also B = 64, 1024 centres: one warp a group): groups bit-equal to the
    plain version, masked and not."""
    from if_defense_tpu_torch.ops.cuda_ballquery import ballquery_cuda

    rng = np.random.default_rng(n)
    for b, s in ((2, 512), (64, 1024))[:2 if n <= 4097 else 1]:
        x = torch.from_numpy((rng.normal(size=(b, n, 3)) * 0.3).astype(
            np.float32)).to(cuda)
        q = x[:, :s].contiguous()
        q[:, :4] += 5.0                                    # no hit
        mask = torch.from_numpy(rng.uniform(size=(b, n)) > 0.2).to(cuda)
        assert _warps_a_group(b, n, s) == (8 if b == 2 else 1)
        for m in (None, mask):
            for radius in (0.05, 0.2):
                got = ballquery_cuda(radius, 32, x, q, m)
                assert torch.equal(got, query_ball_point_plain(radius, 32, x,
                                                               q, m))


def _unit_sphere_clouds(seed, b, n):
    """b clouds of n points on ellipsoids with 8 outliers each (as
    `chip_smoke.py`'s), normalised to the unit sphere as a victim sees
    them: dense enough at its radii that most centres fill their slots."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(b, n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pc = d * rng.uniform(0.3, 1.0, (b, 1, 3))
    pc[:, :8] *= 3.0
    pc -= pc.mean(axis=1, keepdims=True)
    pc /= np.linalg.norm(pc, axis=-1).max(axis=1)[:, None, None]
    return pc.astype(np.float32)


@pytest.mark.parametrize("nsample,radius", [(32, 0.2), (48, 0.23),
                                            (64, 0.4), (64, 0.32),
                                            (128, 0.4)])
def test_cuda_ballquery_victim_slots(cuda, nsample, radius):
    """B6 at the victims' radii (PointNet++ 0.2 / 0.4, RS-CNN 0.23 / 0.32)
    with 32-128 slots on unit-sphere clouds where most centres fill them
    (the early exit): bit-equal to the plain version, masked (a cloud with
    no valid point) and not, at 4 clouds of 512 centres, 64 of 512 and 64
    of 1024, where the kernel sets 8, 4 and 1 warps on a group of centres
    (at 1, a block keeps 35 slots a centre in shared memory and stores the
    rest straight to the output); two launches give the same bits."""
    from if_defense_tpu_torch.ops.cuda_ballquery import ballquery_cuda

    x = torch.from_numpy(_unit_sphere_clouds(nsample, 64, 1024)).to(cuda)
    mask = torch.from_numpy(np.random.default_rng(5).uniform(
        size=(64, 1024)) > 0.2).to(cuda)
    mask[2] = False
    for b, every, warps in ((4, 2, 8), (64, 2, 4), (64, 1, 1)):
        q = x[:b, ::every].contiguous()
        q[:, :3] += 3.0                                    # no hit
        assert _warps_a_group(b, 1024, q.shape[1]) == warps
        for m in (None, mask[:b]):
            want = query_ball_point_plain(radius, nsample, x[:b], q, m)
            if m is None:   # most centres fill their slots
                assert float((want[..., -1] != want[..., 0]).float()
                             .mean()) > 0.5
            got = ballquery_cuda(radius, nsample, x[:b], q, m)
            assert torch.equal(got, want)
            assert torch.equal(ballquery_cuda(radius, nsample, x[:b], q, m),
                               got)


@pytest.mark.parametrize("b,n,s,warps", [
    (3, 20, 5, 1), (3, 37, 5, 2), (3, 100, 33, 4), (3, 1000, 129, 8),
    (3, 1030, 1030, 8), (3, 513, 70, 8), (40, 1000, 1000, 4),
    (64, 1030, 1030, 1)])
def test_cuda_ballquery_ragged_shapes(cuda, b, n, s, warps):
    """B6 where N and S are not multiples of 32 or of a block's 32-256
    centres, with 1, 7 and 33 slots, at shapes where the kernel sets 1, 2,
    4 and 8 warps on a group of centres: bit-equal to the plain version,
    masked (a cloud with no valid point) and not; two launches give the
    same bits."""
    from if_defense_tpu_torch.ops.cuda_ballquery import ballquery_cuda

    assert _warps_a_group(b, n, s) == warps
    rng = np.random.default_rng(n + s)
    x = torch.from_numpy((rng.normal(size=(b, n, 3)) * 0.3).astype(
        np.float32)).to(cuda)
    q = torch.from_numpy((rng.normal(size=(b, s, 3)) * 0.3).astype(
        np.float32)).to(cuda)
    mask = torch.from_numpy(rng.uniform(size=(b, n)) > 0.3).to(cuda)
    mask[1] = False
    for m in (None, mask):
        for nsample, radius in ((1, 0.1), (7, 0.3), (33, 0.5)):
            want = query_ball_point_plain(radius, nsample, x, q, m)
            got = ballquery_cuda(radius, nsample, x, q, m)
            assert torch.equal(got, want)
            assert torch.equal(ballquery_cuda(radius, nsample, x, q, m), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1000, 1024, 2000])
def test_cuda_repulsion_mask_rows(cuda, n, dtype):
    """B2 where rows are 16-byte aligned (1024, and 2000 in chunks above
    1024 points) and where they are not (1000: byte stores), for k in
    {1, 5, 8}: bit-equal to the plain version, on random points with
    duplicates and on a lattice (ties at every threshold); two launches
    give the same bits."""
    from if_defense_tpu_torch.ops.cuda_repulsion import repulsion_mask_cuda

    for pts in (_points(n, n), _lattice(n, n)):
        pc = torch.from_numpy(pts).to(cuda, dtype)
        for k in (1, 5, 8):
            got = repulsion_mask_cuda(pc, k)
            assert torch.equal(got, repulsion_mask(pc, k))
            assert torch.equal(got, repulsion_mask_cuda(pc, k))
            assert int(got.diagonal(dim1=1, dim2=2).abs().sum()) == 0


def test_cuda_wrappers_refuse(cuda):
    from if_defense_tpu_torch.ops.cuda_ballquery import ballquery_cuda
    from if_defense_tpu_torch.ops.cuda_fps import fps_cuda
    from if_defense_tpu_torch.ops.cuda_interp import plane_features_cuda
    from if_defense_tpu_torch.ops.cuda_repulsion import repulsion_loss_cuda

    with pytest.raises(ValueError, match="k=16"):
        repulsion_loss_cuda(torch.zeros(1, 16, 3, device=cuda), 16)
    with pytest.raises(ValueError, match="k=0"):
        repulsion_loss_cuda(torch.zeros(1, 16, 3, device=cuda), 0)
    p = torch.zeros(1, 3, 3, device=cuda)
    with pytest.raises(TypeError, match="all be float32 or all bfloat16"):
        plane_features_cuda(p, {"xz": torch.zeros(1, 8, 8, 4, device=cuda,
                                                  dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="shape"):
        plane_features_cuda(p, {"xz": torch.zeros(1, 8, 8, 4, device=cuda),
                                "xy": torch.zeros(1, 8, 4, 4, device=cuda)})
    with pytest.raises(ValueError, match="among"):
        plane_features_cuda(p, {"grid": torch.zeros(1, 8, 8, 4, device=cuda)})
    # no batch limit: B = 65536 clouds of 4 points, bit-equal
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -0.2, 0.2, (65536, 4, 3)).astype(np.float32)).to(cuda)
    q = x[:, 1:3].contiguous()
    assert torch.equal(ballquery_cuda(0.1, 8, x, q),
                       query_ball_point_plain(0.1, 8, x, q))
    with pytest.raises(ValueError, match="nsample=0"):
        ballquery_cuda(0.1, 0, x, q)
    with pytest.raises(ValueError, match="contiguous"):
        fps_cuda(torch.zeros(1, 3, 16, device=cuda).transpose(1, 2), 8)
    with pytest.raises(TypeError, match="float32"):
        fps_cuda(torch.zeros(1, 16, 3, device=cuda, dtype=torch.float64), 8)


@pytest.mark.parametrize("n", [300, 1024, 4097])
@pytest.mark.parametrize("k", [9, 16, 33])
def test_cuda_repulsion_kernels_any_k(cuda, k, n):
    """B1, B2 and B3 above the register top-k's k <= 8, where the kernels
    scan for each row's k-th smallest distance (up to 1024 points from
    registers, above over staged chunks): against the plain versions on a
    lattice (ties at every threshold) and on random points with duplicates,
    f32 and bf16, the B2 mask bit-equal; two launches bit-identical."""
    from if_defense_tpu_torch.ops import cuda_repulsion as cr

    w = torch.tensor([1.0, 2.0], device=cuda)
    for pts in (_lattice(n, n + k), _points(n + k, n)):
        for dtype, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 2.0**-7)):
            pc = torch.from_numpy(pts).to(cuda, dtype)
            mask = cr.repulsion_mask_cuda(pc, k)
            assert torch.equal(mask, repulsion_mask(pc, k))
            assert torch.equal(mask, cr.repulsion_mask_cuda(pc, k))
            assert int(mask.sum(-1).min()) >= k
            pairs = (
                (lambda x: cr.repulsion_loss_cuda(x, k),
                 lambda x: repulsion_loss_threshold(x, k)),
                (lambda x: cr.repulsion_loss_masked_cuda(x, mask, k),
                 lambda x: repulsion_loss_masked(x, mask, k)))
            for kern, plain in pairs:
                lk, gk = _value_grad(kern, pc, w)
                lk2, gk2 = _value_grad(kern, pc, w)
                assert torch.equal(lk, lk2) and torch.equal(gk, gk2)
                lp, gp = _value_grad(plain, pc, w)
                torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-9)
                _grad_close(gk, gp, rtol)


def _victim_clouds(b, n, seed):
    """Clouds on ellipsoid surfaces in the unit ball, a validity mask with
    ~90 % valid points (cloud 0's first point invalid)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(b, n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pc = (d * rng.uniform(0.3, 1.0, (b, 1, 3))).astype(np.float32)
    mask = rng.uniform(size=(b, n)) > 0.1
    mask[0, 0] = False
    return torch.from_numpy(pc), torch.from_numpy(mask)


@pytest.mark.parametrize("name", ["pointnet", "pointnet2", "dgcnn",
                                  "pointconv", "rscnn"])
def test_cuda_victim_matches_cpu(cuda, name):
    """Each victim at its published widths on the card (B5/B6 kernels, TF32
    off) against its CPU path (the plain versions), same seeded weights with
    calibrated batch-norm statistics, B = 2, N = 1024, unmasked and masked:
    logits within atol 1e-3 of the largest magnitude and rtol 1e-3 (f32
    sums in other orders, and the kNN graphs of DGCNN's features may flip a
    near tie at the k-th neighbour)."""
    from if_defense_tpu_torch.models import build_model
    from if_defense_tpu_torch.models.common import calibrate_batch_norm
    from if_defense_tpu_torch.ops import cuda_ballquery, cuda_fps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pc, mask = _victim_clouds(2, 1024, 3)
    torch.manual_seed(0)
    model = calibrate_batch_norm(build_model(name), pc, 1)
    on_card = build_model(name).to(cuda).eval()
    on_card.load_state_dict(model.state_dict())
    launches = cuda_fps.launches["fps"] + cuda_ballquery.launches["ballquery"]
    for m in (None, mask):
        with torch.no_grad():
            want, _ = model(pc, m)
            got, _ = on_card(pc.to(cuda), None if m is None else m.to(cuda))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-3,
                                   atol=1e-3 * float(want.abs().max()))
    grouped = cuda_fps.launches["fps"] + cuda_ballquery.launches["ballquery"]
    assert (grouped > launches) == (name in ("pointnet2", "pointconv",
                                             "rscnn"))


@pytest.mark.parametrize("masked", [False, True])
def test_cuda_dispatch_takes_bf16_points(cuda, masked):
    """FPS and ball query on bf16 points (a mixed-precision victim's) on
    the card select what B5 and B6 select on their exact f32 upcast, which
    is what the plain versions select on the CPU."""
    from if_defense_tpu_torch.ops import (
        farthest_point_sample,
        index_points,
        query_ball_point,
    )

    xyz = torch.from_numpy(_points(17, 1024)).to(torch.bfloat16)
    mask = (torch.from_numpy(np.random.default_rng(18).uniform(
        size=(2, 1024)) > 0.2) if masked else None)
    on = (lambda t: None if t is None else t.to(cuda))
    fps = farthest_point_sample(xyz.to(cuda), 512, mask=on(mask))
    want = farthest_point_sample_plain(xyz.float(), 512, mask=mask)
    assert torch.equal(fps.cpu(), want)
    new = index_points(xyz, want.long())
    got = query_ball_point(0.2, 32, xyz.to(cuda), new.to(cuda), on(mask))
    assert torch.equal(got.cpu(), query_ball_point_plain(
        0.2, 32, xyz.float(), new.float(), mask))


def test_cuda_mixed_victim_close_to_f32(cuda):
    """PointNet (8 classes, seeded init) with a bf16 trunk and an f32 head
    on the card, as `tests/test_attack.py:153` holds JAX's: logits f32,
    within 2 % of the f32 victim's largest logit. (PointNet++ selects its
    groups on the bf16-rounded points, which alone moves a calibrated
    victim's logits by tenths of the largest: no such bound holds there.)"""
    from if_defense_tpu_torch.attack.mixed import make_mixed_logits_fn
    from if_defense_tpu_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    pc = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 64, 3)).astype(np.float32)).to(cuda)
    torch.manual_seed(0)
    model = build_model("pointnet", num_classes=8).to(cuda).eval()
    with torch.no_grad():
        want, _ = model(pc)
        got = make_mixed_logits_fn(model, 8)(pc)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max() / want.abs().max()) < 0.02


def test_cuda_pointnet2_train_step_matches_cpu(cuda):
    """One PointNet++ train step at its published widths (flax's init
    distributions, `flax_init_params(0)`; B = 4, N = 1024; the CPU's
    dropout masks fed to both) on the card launches B5 and B6 twice each in
    its forward and matches the CPU step: loss rtol 1e-4, each gradient in
    the CPU's direction (cosine >= 0.999; the biases that feed a batch
    norm, whose gradient is 0 but for rounding, below 1e-3 of the largest
    entry on both, and a tensor whose CPU gradient lies below 1e-4 of it
    within that of the CPU's), the batch statistics within 1e-4 of their
    scale (a mean's: the larger of its largest entry and the root of its
    variance's: the first norms see centred clouds). Max-pool near ties
    route a gradient to another point on the card, so gradients are held
    in direction, not in bits."""
    from if_defense_tpu_torch.models import build_model
    from if_defense_tpu_torch.models.common import (
        batch_norm_fed_biases,
        generator_draw,
    )
    from if_defense_tpu_torch.ops import cuda_ballquery, cuda_fps
    from if_defense_tpu_torch.training import (
        create_train_state,
        make_train_step,
    )
    from if_defense_tpu_torch.utils.params_io import (
        flax_init_params,
        params_from_jax,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pc, _ = _victim_clouds(4, 1024, 5)
    label = torch.tensor([3, 17, 17, 38])
    weights = params_from_jax(flax_init_params(0, "pointnet2"),
                              build_model("pointnet2"))
    models, losses = [], []
    masks, draw = [], generator_draw(torch.Generator().manual_seed(6))

    def record(shape, rate):
        masks.append(draw(shape, rate))
        return masks[-1]

    for device in ("cpu", cuda):
        model = build_model("pointnet2")
        model.load_state_dict(weights)
        model.to(device)
        state = create_train_state(model, total_epochs=1, steps_per_epoch=3)
        before = (cuda_fps.launches["fps"], cuda_ballquery.launches["ballquery"])
        replayed = iter(masks)
        _, m = make_train_step(model)(
            state, pc.to(device), label.to(device),
            record if device == "cpu" else lambda shape, rate: next(replayed))
        launched = (cuda_fps.launches["fps"] - before[0],
                    cuda_ballquery.launches["ballquery"] - before[1])
        assert launched == ((0, 0) if device == "cpu" else (2, 2))
        models.append(model)
        losses.append(float(m["loss"]))
    assert len(masks) == 2
    cpu, card = models
    assert losses[1] == pytest.approx(losses[0], rel=1e-4)
    grads = {n: p.grad.double() for n, p in cpu.named_parameters()}
    top = max(float(g.abs().max()) for g in grads.values())
    zero = batch_norm_fed_biases(cpu)
    for n, p in card.named_parameters():
        got, want = p.grad.cpu().double(), grads[n]
        if n in zero:
            assert max(float(got.abs().max()),
                       float(want.abs().max())) <= 1e-3 * top, n
        elif float(want.abs().max()) < 1e-4 * top:
            assert float((got - want).abs().max()) <= 1e-4 * top, n
        else:
            cos = float((got * want).sum() / (got.norm() * want.norm()))
            assert cos >= 0.999, (n, cos)
    stats = dict(cpu.named_buffers())
    for n, got in card.named_buffers():
        want = stats[n]
        scale = float(want.abs().max())
        if n.endswith(".mean"):
            scale = max(scale, float(stats[n[:-4] + "var"].max()) ** 0.5)
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale, n


def _mesh_model(variant, seed=0):
    """ConvONet or ONet at the CLI's widths from flax's init distributions
    (`flax_init_params`), every tensor perturbed and the output bias moved
    so that the occupancy field of `_mesh_clouds` crosses the threshold;
    the model in eval mode on the CPU, and its latent of those clouds."""
    from if_defense_tpu_torch.implicit import (
        ConvOccupancyNetwork,
        OccupancyNetwork,
    )
    from if_defense_tpu_torch.implicit.generation import (
        logit_threshold,
        make_grid,
    )
    from if_defense_tpu_torch.utils.params_io import (
        flatten_params,
        flax_init_params,
        params_from_jax,
        unflatten_params,
    )

    rng = np.random.default_rng(seed)
    flat = {k: (v * np.exp(0.2 * rng.normal(size=v.shape)) if k.endswith("/var")
                else v + (0.3 / np.sqrt(np.prod(v.shape[:-1])) if v.ndim > 1
                          else 0.05) * rng.normal(size=v.shape)
                ).astype(np.float32)
            for k, v in flatten_params(flax_init_params(seed, variant)).items()}
    model = ConvOccupancyNetwork() if variant == "convonet" else \
        OccupancyNetwork()
    model.load_state_dict(params_from_jax(unflatten_params(flat), model))
    model.eval().requires_grad_(False)
    pc = torch.from_numpy(_mesh_clouds())
    with torch.no_grad():
        c = model.encode_inputs(pc)
        grid = torch.from_numpy(make_grid(8, 1.1).reshape(1, -1, 3))
        vals = model.decode(grid.expand(len(pc), -1, 3), c)
        model.decoder.fc_out.bias += logit_threshold(0.2) - float(
            vals.median())
    return model, c


def _mesh_clouds():
    """2 clouds of 300 points on ellipsoids in the padded unit cube."""
    rng = np.random.default_rng(3)
    d = rng.normal(size=(2, 300, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (d * rng.uniform(0.2, 0.4, (2, 1, 3))).astype(np.float32)


def _on(c, device):
    return ({k: v.to(device) for k, v in c.items()} if isinstance(c, dict)
            else c.to(device))


def _int8_close(got, want):
    """int8 grids (as quanta) equal but one quantum apart at entries whose
    f32 value straddles a quantum boundary between the devices; -> the
    count of such entries."""
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()
    return int((diff > 0).sum())


def test_cuda_dense_lattice_matches_cpu(cuda):
    """ConvONet's dense lattice (resolution0 8 x upsample 4, the CLI's
    widths) on the card against the CPU path: logits within 1e-4 of the
    largest, the int8 wire equal but at quantum boundaries, the sparse
    wire's blocks rebuilding the card's own int8 grid's signs."""
    from if_defense_tpu_torch.implicit import generation as g

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, c = _mesh_model("convonet")
    with torch.no_grad():
        want = model.dense_lattice_logits(c, 32, 1.1)
        card = model.to(cuda)
        got = card.dense_lattice_logits(_on(c, cuda), 32, 1.1).cpu()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    iso = g.logit_threshold(0.2)
    _int8_close(g.quantize_wire_int8(got, iso).numpy(),
                g.quantize_wire_int8(want, iso).numpy())
    q = g.quantize_wire_int8(got.to(cuda), iso).cpu().numpy()
    fn = g.make_convonet_sparse_eval(card, 32, 1.1, auto_demote=False)
    out = {k: v.cpu().numpy() for k, v in fn(card, _on(c, cuda)).items()}
    meta = fn.sparse_meta
    for b in range(2):
        vol = g.assemble_sparse_grid(out, b, block=meta["block"],
                                     nb=meta["nb"], rp=meta["rp"])
        assert np.array_equal(vol > 0, q[b] > 0)


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_cuda_onet_refinement_matches_cpu(cuda, wire):
    """ONet's coarse + refine path at the CLI's widths (resolution0 8 x
    upsample 4) on the card against the CPU path: the same active voxels
    (top-k indices equal under a clipping budget), the int8 grid equal but
    at quantum boundaries, the bf16 grid within one bf16 step."""
    from if_defense_tpu_torch.implicit import generation as g

    torch.backends.cuda.matmul.allow_tf32 = False
    model, c = _mesh_model("onet")
    iso = g.logit_threshold(0.2)
    grid = torch.from_numpy(g.make_grid(8, 1.1).reshape(1, -1, 3))
    decode = lambda m, p, cc: m.decode(p, cc)      # noqa: E731
    outs = {}
    for dev in ("cpu", cuda):
        m = model.to(dev)
        coarse = g.eval_points_batched(decode, m, _on(c, dev),
                                       grid.to(dev).expand(2, -1, 3), 8192)
        flat, counts = g._active_scores(coarse.reshape(2, 9, 9, 9), iso, r0=8)
        k = max(1, int(counts.min()) // 2)         # clips
        outs[str(dev)] = (coarse.cpu(), counts.cpu(),
                          g._topk_active(flat, k)[0].cpu(),
                          g.compute_value_grids(decode, m, _on(c, dev),
                                                resolution0=8, upsample=4,
                                                wire=wire)[0])
    (cc, cn, ci, cv), (gc, gn, gi, gv) = outs["cpu"], outs[str(cuda)]
    assert float((gc - cc).abs().max()) <= 1e-4 * float(cc.abs().max())
    assert torch.equal(gn, cn) and torch.equal(gi, ci)
    if wire == "int8":
        _int8_close(np.round((gv - iso) * 16), np.round((cv - iso) * 16))
    else:
        step = np.maximum(np.abs(cv), 1e-30) * 2.0**-7
        assert (np.abs(gv - cv) <= step + 1e-4 * np.abs(cv).max()).all()


def test_cuda_stable_topk_ties(cuda):
    """`_topk_active` on the card keeps ties in ascending index order, as
    `lax.top_k` and the CPU's stable sort do (scores 0, 1 and 2 only)."""
    from if_defense_tpu_torch.implicit.generation import _topk_active

    flat = torch.from_numpy(np.random.default_rng(7).integers(
        0, 3, (4, 32768)).astype(np.float32))
    for k in (1, 100, 8192, 32768):
        idx, act = _topk_active(flat.to(cuda), k)
        want = np.argsort(-flat.numpy(), axis=1, kind="stable")[:, :k]
        assert np.array_equal(idx.cpu().numpy(), want)
        assert torch.equal(act.cpu(), _topk_active(flat, k)[1])


def test_cuda_estimate_normals_launch_b4(cuda):
    """`estimate_normals` on ConvONet on the card launches B4 once forward
    and once for the gradient to p a chunk, and its normals are the CPU
    path's (cosine >= 0.999)."""
    from if_defense_tpu_torch.implicit import generation as g
    from if_defense_tpu_torch.ops import cuda_interp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, c = _mesh_model("convonet")
    c1 = {k: v[:1] for k, v in c.items()}
    decode = lambda m, p, cc: m.decode(p, cc)      # noqa: E731
    verts, _ = g.generate_meshes(decode, model, c1, resolution0=8,
                                 upsample=2)[0]
    assert len(verts) > 100
    want = g.estimate_normals(decode, model, c1, verts, chunk=64)
    before = dict(cuda_interp.launches)
    got = g.estimate_normals(decode, model.to(cuda), _on(c1, cuda), verts,
                             chunk=64)
    chunks = -(-len(verts) // 64)
    assert cuda_interp.launches["plane_features"] - before[
        "plane_features"] == chunks
    assert cuda_interp.launches["plane_features_dp"] - before[
        "plane_features_dp"] == chunks
    assert (np.sum(got * want, -1) >= 0.999).all()


def test_cuda_b4_refuses_a_second_derivative(cuda):
    """B4's backward is not differentiable: `refine_mesh`, whose loss holds
    the decoder's gradient, raises on ConvONet on the card instead of
    dropping the second-order terms; on the plain path it runs."""
    from if_defense_tpu_torch.implicit import generation as g

    model, c = _mesh_model("convonet")
    c1 = {k: v[:1] for k, v in c.items()}
    decode = lambda m, p, cc: m.decode(p, cc)      # noqa: E731
    verts, tris = g.generate_meshes(decode, model, c1, resolution0=8,
                                    upsample=2)[0]
    out = g.refine_mesh(decode, model, c1, verts, tris[:50], steps=1)
    assert np.isfinite(out).all()
    with pytest.raises(RuntimeError):
        g.refine_mesh(decode, model.to(cuda), _on(c1, cuda), verts,
                      tris[:50], steps=1)


def _uv_inputs(cuda, seed, c, dtype, b=2, q=1000, res=64):
    """A plane N(0, 1) [b, res, res, c], uv from [-0.1, 1.1]^2 (the clamp
    holds about one coordinate in six), the cotangent N(0, 1)."""
    rng = np.random.default_rng(seed)

    def dev(a):
        return torch.from_numpy(a.astype(np.float32)).to(cuda, dtype)

    return (dev(rng.normal(size=(b, res, res, c))),
            dev(rng.uniform(-0.1, 1.1, (b, q, 2))),
            dev(rng.normal(size=(b, q, c))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [6, 32, 128])
def test_cuda_plane_sample_uv_matches_plain(cuda, c, dtype):
    """B4's uv form against `bilinear_plane_sample` on f32 copies, cast
    once: forward bit-equal in f32, the gradient to uv rtol 1e-4 and the
    plane's atol 1e-5 of the largest entry (sums in other orders), rtol
    2^-7 in bf16; one launch each way, two launches give the same bits."""
    from if_defense_tpu_torch.ops.cuda_interp import launches, plane_sample_cuda
    from if_defense_tpu_torch.ops.interp import bilinear_plane_sample

    plane, uv, g = _uv_inputs(cuda, c, c, dtype)

    def run(fn):
        u = uv.clone().requires_grad_(True)
        pl = plane.clone().requires_grad_(True)
        out = fn(pl, u)
        du, dpl = torch.autograd.grad(out, [u, pl], g.to(out.dtype))
        return out.detach(), du, dpl

    def plain(pl, u):
        return bilinear_plane_sample(pl.float(), u.float()).to(pl.dtype)

    before = dict(launches)
    got = run(plane_sample_cuda)
    assert {k: launches[k] - before[k] for k in
            ("plane_sample", "plane_sample_duv", "plane_sample_dplane")} == {
        "plane_sample": 1, "plane_sample_duv": 1, "plane_sample_dplane": 1}
    want = run(plain)
    if dtype == torch.float32:
        assert torch.equal(got[0], want[0])
    for a, b, r in zip(got, want, (0.0, 1e-4, 0.0)):
        assert a.dtype == dtype
        _grad_close(a.cpu(), b.cpu(), r if dtype == torch.float32 else 2.0**-7)
    assert torch.equal(got[1] == 0, want[1] == 0) and bool((want[1] == 0).any())
    again = run(plane_sample_cuda)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype,c", [(torch.float32, 6), (torch.bfloat16, 6),
                                     (torch.bfloat16, 12)])
def test_cuda_plane_features_any_channels(cuda, dtype, c):
    """B4's p form at channel counts that fill no 16-byte word (the scalar
    path): forward bit-equal in f32, the gradients as
    `test_cuda_plane_gradient_matches_plain`."""
    from if_defense_tpu_torch.ops.cuda_interp import plane_features_cuda

    p, planes, g = _plane_inputs(cuda, 30 + c, 3, dtype, c=c)
    got = _features(plane_features_cuda, p, planes, g, True, True)
    want = _features(_plain_f32, p, planes, g, True, True)
    if dtype == torch.float32:
        assert torch.equal(got[0], want[0])
    for i, (a, b) in enumerate(zip(got, want)):
        rtol = (1e-4 if i == 1 else 0.0) if dtype == torch.float32 else 2.0**-7
        _grad_close(a.cpu(), b.cpu(), rtol)
    again = _features(plane_features_cuda, p, planes, g, True, True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _off_cell_edges(rng, shape, reso, padding=0.1):
    """Queries whose normalised coordinates (`normalize_3d_coordinate`)
    lie at least 0.01 cell from every edge of a `reso`^3 volume and inside
    its clamp: at an edge the trilinear sample's gradient jumps, and one
    ulp of the normalisation (the card multiplies by the reciprocal, the
    CPU divides) decides the side."""
    # cells 0 .. reso - 3: the clamp's top, 1 - 1e-3, cuts the last cell
    cell = rng.integers(0, reso - 2, shape) + rng.uniform(0.01, 0.99, shape)
    u = cell / (reso - 1)
    return ((u - 0.5) * (1 + padding + 1e-3)).astype(np.float32)


def test_cuda_grid_decode_matches_cpu(cuda):
    """The grid ConvONet at full width (c_dim 32, 32^3, 3D UNet depth 3)
    on 2 clouds: the volume, the logits and their gradient to p on the
    card against the CPU path, within 1e-4 of the largest magnitude (the
    gradient: >= 99.9 % of its entries), at queries off the cells' edges
    (`_off_cell_edges`)."""
    from if_defense_tpu_torch.implicit import ConvOccupancyNetwork
    from if_defense_tpu_torch.implicit.training import init_occupancy_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    model = ConvOccupancyNetwork(plane_type=("grid",))
    init_occupancy_model(model, 0)
    with torch.no_grad():
        for t in model.parameters():             # off flax's zero fc_1
            t.add_(0.05 * torch.randn_like(t))
    model.eval()
    rng = np.random.default_rng(5)
    pc = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 600, 3)).astype(np.float32))
    q = torch.from_numpy(_off_cell_edges(rng, (2, 2048, 3), 32))
    out = {}
    for d in ("cpu", cuda):
        m = model.to(d)
        with torch.no_grad():
            c = m.encode_inputs(pc.to(d))
        x = q.to(d).requires_grad_(True)
        logits = m.decode(x, c)
        (gx,) = torch.autograd.grad(logits.sum(), x)
        out[str(d)] = [t.detach().cpu() for t in (c["grid"], logits, gx)]
    (vol, logits, gx), (vol_c, logits_c, gx_c) = out[str(cuda)], out["cpu"]
    for a, b in ((vol, vol_c), (logits, logits_c)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    # a decoder ReLU whose pre-activation lies within rounding of 0 passes
    # its gradient on one device only: >= 99.9 % of the entries
    near = (gx - gx_c).abs() <= 1e-4 * float(gx_c.abs().max())
    assert float(near.float().mean()) >= 0.999, float(near.float().mean())
