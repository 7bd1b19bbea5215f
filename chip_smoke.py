#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card (a Hopper H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. builds the CUDA kernels from `if_defense_tpu_torch/csrc/` with nvcc
     (sm_90a) and prints the build time and each kernel's registers;
  2. holds each kernel (B1 repulsion loss, B2 repulsion mask, B3 masked
     repulsion loss, B4 plane sampling) against its plain PyTorch version
     at the ConvONet-Opt shapes (B=48, N=Q=1024, 64x64x32 planes), forward
     and backward, in f32 and bf16, and times both with CUDA events, and
     B4's one-call PyTorch yardstick (`F.grid_sample`, forward + grid
     gradient);
  3. checks the ConvONet-Opt path on a small input against the port's own
     CPU run (the plain versions) with the same draws;
  4. writes a synthetic npz (48 clouds x 1024 points) and seeded weights,
     and runs `if_defense_tpu_torch.cli.opt_defense` at full width for 201
     steps in the reference mode (f32) and the fast mode (bf16, corner
     cache every 16 steps, cached repulsion graph), with every kernel
     launch counter set to 0 just before each run and read just after;
  5. holds B5 (FPS) and B6 (ball query) against their plain versions at
     PU-Net's four set-abstraction levels, on the level inputs of one batch
     (128) of phase 7's clouds, unmasked and masked: indices bit-equal;
     times both with CUDA events (median of 20);
  6. checks DUP-Net on a small input (B=2, N=1024, the repository's PU-Net
     weights, the same resampling draws) against the port's CPU run;
  7. writes a synthetic npz (256 clouds x 1024 points) and runs
     `if_defense_tpu_torch.cli.defend_npz` at full width (batch 128, PU-Net
     1024 x 4 with `weights/punet_1024_up4.npz`): DUP-Net alone with the
     B5/B6 launch counters set to 0 just before and read just after (first
     run), then all three defenses, then DUP-Net again (warm run); then
     profiles one batch of DUP-Net with torch.profiler.
The last lines are DUP-Net's clouds/s, the card's name and power limit, one
JSON line of the kernels, and `{"ok": true, "device": {...}}`.

Each kernel's `bound_ms` is the least time the card could take for its
work on this run's inputs: the larger of its operations over 67 TFLOP/s
(f32, outside the tensor cores) and its bytes (each input read once, each
output written once) over 3.35 TB/s, the H100 SXM's published peaks.
Operations counted: 8 flops for a pair's squared distance (3 sub, 3 mul,
2 add) and 1 for its selection compare; 50 for a weighted repulsion pair's
term and gradient; 9 per channel for a bilinear sample and 12 for its uv
gradient; FPS 10 per point and step (distance, min, compare); ball query 9
per (centre, point) pair scanned up to the centre's nsample-th hit and 5
per |v|^2.

f32 phases run with TF32 off for matmuls and cuDNN convolutions.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

B, N, R, C = 48, 1024, 64, 32
LR, SMALL_ITERS = 1e-3, 5
DUP_B, DUP_CLOUDS = 128, 256             # defend_npz's batch; clouds in its file
SA_LEVELS = ((1024, 0.05), (512, 0.1), (256, 0.2), (128, 0.3))
NEAR_FACTOR = 1.5
PEAK_F32, HBM = 67e12, 3.35e12           # FLOP/s, bytes/s (H100 SXM)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(least ms on the card, what bounds it) for f32 work."""
    ops_ms, bytes_ms = flops / PEAK_F32 * 1e3, nbytes / HBM * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def ellipsoids(gen, n: int) -> np.ndarray:
    """n clouds of 1024 points on ellipsoid surfaces, 8 outliers each (SOR
    has work to do), f32."""
    d = gen.normal(size=(n, 1024, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pc = d * gen.uniform(0.3, 1.0, (n, 1, 3))
    pc[:, :8] *= 3.0
    return pc.astype(np.float32)


def compare(name: str, got: torch.Tensor, ref: torch.Tensor, atol: float,
            rtol: float) -> float:
    """max |got - ref|; fails unless |got - ref| <= atol + rtol |ref|."""
    got, ref = got.detach().float(), ref.detach().float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)} "
             "or non-finite values")
    err = (got - ref).abs()
    bad = int((err > atol + rtol * ref.abs()).sum())
    worst = float(err.max())
    print(f"  {name}: max_abs_err {worst:.3e} (atol {atol:g}, rtol {rtol:g})"
          f"{'' if not bad else f', {bad} out of tolerance'}")
    if bad:
        fail(f"{name} disagrees with its plain version")
    return worst


def grad_atol(ref: torch.Tensor) -> float:
    """Absolute tolerance of a gradient: 1e-5 of its largest entry. The
    kernel and the plain version sum a point's pair terms in other orders,
    and an entry near 0 is a cancellation of terms of the larger size."""
    return 1e-5 * float(ref.detach().float().abs().max())


def value_and_grad(fn, x: torch.Tensor, w: torch.Tensor):
    x = x.detach().requires_grad_(True)
    out = fn(x)
    (g,) = torch.autograd.grad((out.float() * w).sum(), x)
    return out.detach(), g


def check_kernels(dev) -> list[dict]:
    from if_defense_tpu_torch.defense import repulsion as rep
    from if_defense_tpu_torch.ops import cuda_interp, cuda_repulsion, interp

    gen = np.random.default_rng(0)
    pts = gen.uniform(-0.45, 0.45, (B, N, 3)).astype(np.float32)
    pts[:, N - 24:] = pts[:, :24]          # exact duplicates, as resampling makes
    pts = torch.from_numpy(pts).to(dev)
    w = torch.from_numpy(gen.uniform(0.5, 1.5, B).astype(np.float32)).to(dev)
    bf16_tol = 2.0**-7                     # one bf16 rounding of the result
    rows = []

    print("B1 repulsion_loss (fwd + bwd):")
    errs = []
    for dt, gr in ((torch.float32, 1e-4), (torch.bfloat16, bf16_tol)):
        p = pts.to(dt)
        lk, gk = value_and_grad(cuda_repulsion.repulsion_loss_cuda, p, w)
        lp, gp = value_and_grad(rep.repulsion_loss_threshold, p, w)
        tag = str(dt).split(".")[-1]
        e = [compare(f"loss {tag}", lk, lp, 1e-9, 1e-5),
             compare(f"grad {tag}", gk, gp, grad_atol(gp), gr)]
        if dt == torch.float32:
            errs += e
    ms = median_ms(lambda: value_and_grad(cuda_repulsion.repulsion_loss_cuda,
                                          pts, w))
    plain_ms = median_ms(lambda: value_and_grad(rep.repulsion_loss_threshold,
                                                pts, w))
    pts_bytes = 4 * B * N * 3
    rows.append(dict(name="repulsion_loss", id="B1",
                     source="if_defense_tpu_torch/csrc/repulsion.cu",
                     replaces="if_defense_tpu/ops/pallas_repulsion.py:196",
                     max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                     bound=bound(9 * B * N * N + 50 * B * N * 5,
                                 2 * pts_bytes + 8 * B)))

    print("B2 repulsion_mask:")
    masks = {}
    for dt in (torch.float32, torch.bfloat16):
        mk = cuda_repulsion.repulsion_mask_cuda(pts.to(dt))
        mp = rep.repulsion_mask(pts.to(dt))
        diff = int((mk != mp).sum())
        print(f"  mask {str(dt).split('.')[-1]}: {diff} entries differ "
              f"(bit-equal required), {int(mk.sum())} ones")
        if diff:
            fail("B2 mask disagrees with its plain version")
        masks[dt] = mk
    ms = median_ms(lambda: cuda_repulsion.repulsion_mask_cuda(pts))
    plain_ms = median_ms(lambda: rep.repulsion_mask(pts))
    rows.append(dict(name="repulsion_mask", id="B2",
                     source="if_defense_tpu_torch/csrc/repulsion.cu",
                     replaces="if_defense_tpu/ops/pallas_repulsion.py:267",
                     max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                     bound=bound(9 * B * N * N, pts_bytes + B * N * N)))

    print("B3 repulsion_loss_masked (fwd + bwd):")
    errs = []
    # the mask is built from the f32 points and then held while they move
    moved = pts + 1e-3 * torch.randn(pts.shape, device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(1))
    mask = masks[torch.float32]
    for dt, gr in ((torch.float32, 1e-4), (torch.bfloat16, bf16_tol)):
        p = moved.to(dt)
        lk, gk = value_and_grad(
            lambda x: cuda_repulsion.repulsion_loss_masked_cuda(x, mask), p, w)
        lp, gp = value_and_grad(
            lambda x: rep.repulsion_loss_masked(x, mask), p, w)
        tag = str(dt).split(".")[-1]
        e = [compare(f"loss {tag}", lk, lp, 1e-9, 1e-5),
             compare(f"grad {tag}", gk, gp, grad_atol(gp), gr)]
        if dt == torch.float32:
            errs += e
    ms = median_ms(lambda: value_and_grad(
        lambda x: cuda_repulsion.repulsion_loss_masked_cuda(x, mask), moved, w))
    plain_ms = median_ms(lambda: value_and_grad(
        lambda x: rep.repulsion_loss_masked(x, mask), moved, w))
    rows.append(dict(name="repulsion_loss_masked", id="B3",
                     source="if_defense_tpu_torch/csrc/repulsion.cu",
                     replaces="if_defense_tpu/ops/pallas_repulsion.py:390",
                     max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                     bound=bound(50 * float(mask.sum()),
                                 2 * pts_bytes + 8 * B + B * N * N)))

    print("B4 plane_sample (fwd + uv grad):")
    plane = torch.from_numpy(gen.normal(size=(B, R, R, C)).astype(np.float32)).to(dev)
    uv = torch.from_numpy(
        gen.uniform(0.0, 1.0 - 1e-5, (B, N, 2)).astype(np.float32)).to(dev)
    g_out = torch.from_numpy(gen.normal(size=(B, N, C)).astype(np.float32)).to(dev)

    def run(fn, pl):
        u = uv.detach().requires_grad_(True)
        out = fn(pl, u)
        (du,) = torch.autograd.grad((out.float() * g_out).sum(), u)
        return out.detach(), du

    def plain(pl, u):        # the kernel's semantics: f32 math, plane's type out
        return interp.bilinear_plane_sample(pl.float(), u).to(pl.dtype)

    errs = []
    for dt, (fa, fr) in ((torch.float32, (1e-5, 0.0)),
                         (torch.bfloat16, (1e-3, bf16_tol))):
        pl = plane.to(dt)
        ok_, dk = run(cuda_interp.plane_sample_cuda, pl)
        op, dp = run(plain, pl)
        tag = str(dt).split(".")[-1]
        e = [compare(f"out {tag}", ok_, op, fa, fr),
             compare(f"uv grad {tag}", dk, dp, grad_atol(dp), 1e-5)]
        if dt == torch.float32:
            errs += e
    # the one PyTorch call that computes the same function (a yardstick;
    # the port never calls it): NCHW planes, grid in [-1, 1]
    plane_nchw = plane.permute(0, 3, 1, 2)
    g_nchw = g_out.permute(0, 2, 1)[:, :, None, :]

    def library():
        grid = (2 * uv[:, None] - 1).detach().requires_grad_(True)
        out = torch.nn.functional.grid_sample(
            plane_nchw, grid, mode="bilinear", padding_mode="border",
            align_corners=True)
        (dg,) = torch.autograd.grad((out * g_nchw).sum(), grid)
        return out, dg

    lib_out = library()[0].detach()[:, :, 0].transpose(1, 2)
    diff = float((lib_out - run(interp.bilinear_plane_sample, plane)[0])
                 .abs().max())
    print(f"  grid_sample vs plain: max abs diff {diff:.3e}")
    ms = median_ms(lambda: run(cuda_interp.plane_sample_cuda, plane))
    plain_ms = median_ms(lambda: run(interp.bilinear_plane_sample, plane))
    library_ms = median_ms(library)
    rows.append(dict(name="plane_sample", id="B4",
                     source="if_defense_tpu_torch/csrc/interp.cu",
                     replaces="if_defense_tpu/ops/pallas_interp.py:233",
                     max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                     library_ms=library_ms,
                     bound=bound(21 * B * N * C,
                                 4 * (B * R * R * C + 2 * B * N * 2
                                      + 2 * B * N * C))))
    for r in rows:
        print(f"  {r['id']} {r['name']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]})"
              + (f", grid_sample {r['library_ms']:.4f} ms"
                 if r.get("library_ms") else "")
              + " (median of 20, fwd+bwd where the path takes a gradient)")
    return rows


def check_small_path(dev) -> None:
    """The whole defense on a small input, CUDA (kernels) vs CPU (plain
    versions), same weights and draws: >= 99.9 % of coordinates within
    1e-4, all within 2 lr (steps + 1) (Adam's first steps move a coordinate
    by ~lr sign(g), and a gradient within rounding of 0 can flip it)."""
    from if_defense_tpu_torch.defense.ifdefense import convonet_opt_defense
    from if_defense_tpu_torch.implicit import ConvOccupancyNetwork
    from if_defense_tpu_torch.utils.params_io import (
        init_params,
        params_from_jax,
    )

    cfg = dict(c_dim=16, hidden_dim=16, plane_resolution=32)
    sd = params_from_jax(init_params(3, c_dim=16, hidden_dim=16))
    gen = np.random.default_rng(3)
    pc = gen.normal(size=(2, 512, 3)).astype(np.float32) * 0.3
    sel = gen.uniform(-0.4, 0.4, (2, 128, 3)).astype(np.float32)
    init = gen.uniform(-0.4, 0.4, (2, 256, 3)).astype(np.float32)
    modes = {"reference": dict(),
             "fast f32": dict(interp_refresh=2, rep_graph_cache=True)}
    for name, extra in modes.items():
        outs = []
        for d in ("cpu", dev):
            model = ConvOccupancyNetwork(**cfg)
            model.load_state_dict(sd)
            model.to(d)
            defend = convonet_opt_defense(
                model, iterations=SMALL_ITERS, input_npoint=128,
                sample_npoint=256, **extra)
            draws = tuple(torch.from_numpy(a).to(d) for a in (sel, init))
            outs.append(defend(torch.from_numpy(pc).to(d),
                               draws=draws).cpu())
        err = (outs[0] - outs[1]).abs()
        share = float((err <= 1e-4).float().mean())
        print(f"  {name}: {share:.5f} of coordinates within 1e-4, "
              f"max {float(err.max()):.3e} (bound {2 * LR * (SMALL_ITERS + 1):g})")
        if share < 0.999 or float(err.max()) > 2 * LR * (SMALL_ITERS + 1):
            fail(f"small whole-path run ({name}) disagrees with the CPU run")


def run_cli(tmp: str, name: str, extra: list[str]) -> dict:
    from if_defense_tpu_torch.cli import opt_defense
    from if_defense_tpu_torch.data import load_npz

    data = os.path.join(tmp, f"{name}.npz")
    out_path, = opt_defense.main([
        "--data_root", data, "--weights", os.path.join(tmp, "weights.npz"),
        "--batch_size", str(B), "--iterations", "200",
        "--sample_npoint", "1024", "--seed", "1", "--device", "cuda",
        *extra])
    with open(out_path + ".metrics.jsonl") as f:
        metrics = json.loads(f.read().splitlines()[-1])
    out = load_npz(out_path).test_pc
    radius = float(np.sqrt((out**2).sum(-1)).max())
    print(f"  {name}: output {out.shape}, max radius {radius:.7f}, "
          f"occupancy loss {metrics['occ_loss_first']:.4f} -> "
          f"{metrics['occ_loss_last']:.4f}, "
          f"{metrics['clouds_per_sec']:.3f} clouds/s")
    if out.shape != (B, 1024, 3) or not np.isfinite(out).all():
        fail(f"{name}: output shape {out.shape} or non-finite values")
    if radius > 1 + 1e-5:
        fail(f"{name}: max radius {radius} > 1 + 1e-5")
    if not metrics["occ_loss_last"] < metrics["occ_loss_first"]:
        fail(f"{name}: occupancy loss did not fall")
    return metrics


def sa_level_inputs(dev, clouds: np.ndarray):
    """PU-Net's set-abstraction inputs for one batch of the CLI's clouds:
    SOR, resampling to 1024, then the chain of FPS levels (plain version).
    -> [(points [B, N, 3], centres [B, S, 3], radius)] per level."""
    from if_defense_tpu_torch.defense import process_data_fixed, sor_defense
    from if_defense_tpu_torch.ops import (
        farthest_point_sample_plain,
        index_points,
    )

    pc, mask = sor_defense(torch.from_numpy(clouds).to(dev))
    xyz = process_data_fixed(pc, mask, 1024,
                             torch.Generator(device=dev).manual_seed(0))
    levels = []
    for npoint, radius in SA_LEVELS:
        new = index_points(xyz, farthest_point_sample_plain(xyz, npoint))
        levels.append((xyz, new, radius))
        xyz = new
    return levels


def check_pointops(dev, clouds: np.ndarray) -> list[dict]:
    """B5 and B6 against their plain versions at each SA level, unmasked
    and masked (~90 % valid, the last cloud with none): indices bit-equal.
    Times are medians of 20 unmasked calls; a row's numbers are sums over
    the four levels (one batch of the path)."""
    from if_defense_tpu_torch.ops import (
        farthest_point_sample_plain,
        query_ball_point_plain,
    )
    from if_defense_tpu_torch.ops.cuda_ballquery import ballquery_cuda
    from if_defense_tpu_torch.ops.cuda_fps import fps_cuda

    gen = torch.Generator(device=dev).manual_seed(2)
    # per kernel: ms, plain ms, flops, bytes, summed over the levels
    tot = {k: [0.0, 0.0, 0.0, 0.0] for k in ("fps", "ballquery")}
    for level, (xyz, new, radius) in enumerate(sa_level_inputs(dev, clouds)):
        b, n, _ = xyz.shape
        s = new.shape[1]
        mask = torch.rand((b, n), generator=gen, device=dev) > 0.1
        mask[-1] = False
        for tag, m in (("unmasked", None), ("masked", mask)):
            diff = int((fps_cuda(xyz, s, mask=m) != farthest_point_sample_plain(
                xyz, s, mask=m)).sum())
            diff += int((ballquery_cuda(radius, 32, xyz, new, m)
                         != query_ball_point_plain(radius, 32, xyz, new, m))
                        .sum())
            print(f"  level {level} [{b}, {n}] -> {s} {tag}: {diff} indices "
                  "differ (bit-equal required)")
            if diff:
                fail(f"B5/B6 disagree with their plain versions at level "
                     f"{level} ({tag})")
        # ball-query work: a centre scans up to its 32nd hit, which is slot
        # 31 when that slot differs from slot 0, else the whole cloud
        idx = query_ball_point_plain(radius, 32, xyz, new)
        scanned = torch.where(idx[..., 31] != idx[..., 0], idx[..., 31] + 1, n)
        work = {"fps": (10 * b * n * s, 12 * b * n + 4 * b * s),
                "ballquery": (9 * float(scanned.sum()) + 5 * b * (n + s),
                              12 * b * (n + s) + 4 * b * s * 32)}
        times = {
            "fps": (median_ms(lambda: fps_cuda(xyz, s)),
                    median_ms(lambda: farthest_point_sample_plain(xyz, s))),
            "ballquery": (
                median_ms(lambda: ballquery_cuda(radius, 32, xyz, new)),
                median_ms(lambda: query_ball_point_plain(radius, 32, xyz,
                                                         new)))}
        for k, (ms, plain_ms) in times.items():
            bound_ms, by = bound(*work[k])
            print(f"  level {level} {k}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by})")
            for i, v in enumerate((ms, plain_ms, *work[k])):
                tot[k][i] += v
        print(f"  level {level}: a centre scans "
              f"{float(scanned.float().mean()):.1f} of {n} points on average")
    rows = []
    for k, rid, src, rep_ in (
            ("fps", "B5", "fps.cu", "pallas_fps.py:82"),
            ("ballquery", "B6", "ballquery.cu", "pallas_ballquery.py:71")):
        ms, plain_ms, flops, nbytes = tot[k]
        rows.append(dict(
            name=k, id=rid, source=f"if_defense_tpu_torch/csrc/{src}",
            replaces=f"if_defense_tpu/ops/{rep_}", max_abs_err=0.0, ms=ms,
            plain_ms=plain_ms, bound=bound(flops, nbytes)))
        print(f"  {rid} {k}, 4 levels: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {rows[-1]['bound'][0]:.4f} ms "
              f"({rows[-1]['bound'][1]})")
    return rows


def load_punet(device):
    from if_defense_tpu_torch.cli.defend_npz import DEFAULT_PUNET_WEIGHTS
    from if_defense_tpu_torch.defense import DUPNet
    from if_defense_tpu_torch.utils.params_io import (
        load_params_npz,
        params_from_jax,
    )

    dup = DUPNet(npoint=1024, up_ratio=4)
    dup.pu_net.load_state_dict(
        params_from_jax(load_params_npz(DEFAULT_PUNET_WEIGHTS)))
    return dup.to(device).eval()


def check_small_dupnet(dev) -> None:
    """DUP-Net, CUDA (kernels) vs CPU (plain versions), same weights and
    resampling draws: >= 99.9 % of coordinates within 1e-4, all within
    1e-3. FPS and ball query pick the same indices on both devices, so
    only the f32 matmuls round differently."""
    gen = np.random.default_rng(4)
    pc = ellipsoids(gen, 2)
    u = gen.uniform(size=(2, 1024)).astype(np.float32)
    outs = []
    for d in ("cpu", dev):
        with torch.inference_mode():
            outs.append(load_punet(d)(torch.from_numpy(pc).to(d),
                                      u=torch.from_numpy(u).to(d)).cpu())
    err = (outs[0] - outs[1]).abs()
    share = float((err <= 1e-4).float().mean())
    print(f"  output {tuple(outs[1].shape)}: {share:.5f} of coordinates "
          f"within 1e-4, max {float(err.max()):.3e} (bound 1e-3)")
    if share < 0.999 or float(err.max()) > 1e-3:
        fail("small DUP-Net run disagrees with the CPU run")


def nearness(out: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
    """Per cloud: mean distance of an output point to its nearest input
    point over the input's mean nearest-neighbour spacing."""
    ratios = []
    for o, p in zip(out.split(32), inp.split(32)):
        near = torch.cdist(o, p).amin(-1).mean(-1)
        self_d = torch.cdist(p, p)
        self_d.diagonal(dim1=1, dim2=2).fill_(float("inf"))
        ratios.append(near / self_d.amin(-1).mean(-1))
    return torch.cat(ratios)


def run_defend_npz(dev, tmp: str, clouds: np.ndarray) -> tuple[dict, dict]:
    """The CLI at full width: DUP-Net (first run, launch counters zeroed
    just before and read just after), all three defenses (outputs checked),
    DUP-Net again (warm). -> (launches, clouds/s)."""
    from if_defense_tpu_torch.cli import defend_npz
    from if_defense_tpu_torch.data import load_npz, save_npz
    from if_defense_tpu_torch.ops import cuda_ballquery, cuda_fps

    data = save_npz(os.path.join(tmp, "adv.npz"),
                    {"test_pc": clouds,
                     "test_label": np.arange(len(clouds)) % 40})
    argv = ["--data_root", data, "--device", "cuda"]

    def timed(extra):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths = defend_npz.main(argv + extra)
        torch.cuda.synchronize()
        return paths, time.perf_counter() - t0

    counters = (cuda_fps.launches, cuda_ballquery.launches)
    for counter in counters:
        for k in counter:
            counter[k] = 0
    torch.cuda.reset_peak_memory_stats()
    _, first = timed(["--defense", "dup"])
    launches = {k: v for c in counters for k, v in c.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  DUP-Net first run: {first:.3f} s, launches {launches}, peak "
          f"device memory {peak:.2f} GiB")
    if min(launches.values()) <= 0:
        fail("B5/B6 were not launched on the DUP-Net path")
    paths, seconds = timed([])
    print(f"  all three defenses: {seconds:.3f} s")
    shapes = {"srs": (len(clouds), 1024 - 500, 3), "sor": (len(clouds), 1024, 3),
              "dup": (len(clouds), 4096, 3)}
    for path, (name, shape) in zip(paths, shapes.items()):
        got = load_npz(path)
        print(f"  {name}: {os.path.relpath(path, tmp)} {got.test_pc.shape}")
        if (got.test_pc.shape != shape or not np.isfinite(got.test_pc).all()
                or not os.path.basename(path) == f"{name}_adv.npz"):
            fail(f"{name}: output {path} {got.test_pc.shape} or non-finite")
        if name == "dup":
            ratio = nearness(torch.from_numpy(got.test_pc).to(dev),
                             torch.from_numpy(clouds).to(dev))
            print(f"  dup: nearest-input distance / input spacing, per "
                  f"cloud: max {float(ratio.max()):.3f}, mean "
                  f"{float(ratio.mean()):.3f} (limit {NEAR_FACTOR})")
            if float(ratio.max()) >= NEAR_FACTOR:
                fail("DUP-Net output points lie far from their input cloud")
    _, warm = timed(["--defense", "dup"])
    rates = {"first": len(clouds) / first, "warm": len(clouds) / warm}
    return launches, rates


def profile_dupnet(dev, clouds: np.ndarray) -> None:
    """torch.profiler over one warm batch of DUP-Net (the module, as the
    CLI calls it): wall time, device kernel time and busy share, B5 and
    B6's share, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    dup = load_punet(dev)
    x = torch.from_numpy(clouds).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        dup(x, gen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            dup(x, gen)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        print(f"  profile: wall {wall:.3f} ms; device time not measured "
              "(the profiler saw no CUDA kernel)")
        return
    ours = sum(e.self_device_time_total for e in events
               if "fps_kernel" in e.key or "ballquery_kernel" in e.key) / 1e3
    print(f"  profile, one batch of {len(clouds)}: wall {wall:.3f} ms, "
          f"device kernels {busy:.3f} ms (busy share {busy / wall:.3f}), "
          f"B5 + B6 {ours:.3f} ms ({ours / busy:.3f} of device time)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} "
              f"{e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    from if_defense_tpu_torch.data import save_npz
    from if_defense_tpu_torch.ops import _build, cuda_interp, cuda_repulsion
    from if_defense_tpu_torch.utils.params_io import (
        init_params,
        save_params_npz,
    )

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; card: {card}")

    print("phase 1: build")
    t0 = time.perf_counter()
    _build.libraries()
    print(f"  built {sorted(_build.libraries())} in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({'cached' if _build.build_info['cached'] else 'nvcc'}) "
          f"into {_build.build_info['dir']}")
    for lib, log in _build.build_info["logs"].items():
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line:
                print(f"  [{lib}] {line.strip()}")

    print("phase 2: kernels vs plain versions at the slice's shapes")
    rows = check_kernels(dev)

    print("phase 3: small whole path, CUDA vs CPU, same draws")
    check_small_path(dev)

    print("phase 4: ConvONet-Opt through the CLI, full width, 201 steps")
    counters = (cuda_repulsion.launches, cuda_interp.launches)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        pc = ellipsoids(np.random.default_rng(0), B)
        for name in ("reference", "fast"):
            save_npz(os.path.join(tmp, f"{name}.npz"),
                     {"test_pc": pc, "test_label": np.arange(B) % 40})
        save_params_npz(os.path.join(tmp, "weights.npz"), init_params(0))
        modes = {"reference": [],
                 "fast": ["--compute_dtype", "bfloat16",
                          "--interp_refresh", "16", "--rep_graph_cache"]}
        rates = {}
        for name, extra in modes.items():
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            for counter in counters:
                for k in counter:
                    counter[k] = 0
            rates[name] = run_cli(tmp, name, extra)["clouds_per_sec"]
            launches[name] = {k: v for c in counters for k, v in c.items()}
            print(f"  {name}: launches {launches[name]}")
        # a second, warm run of each mode for the rate
        for name, extra in modes.items():
            rates[name + " warm"] = run_cli(tmp, name, extra)["clouds_per_sec"]

    dup_clouds = ellipsoids(np.random.default_rng(7), DUP_CLOUDS)
    print("phase 5: B5/B6 vs plain versions at PU-Net's SA levels, batch "
          f"{DUP_B}")
    rows += check_pointops(dev, dup_clouds[:DUP_B])

    print("phase 6: small DUP-Net, CUDA vs CPU, same draws")
    check_small_dupnet(dev)

    print(f"phase 7: DUP-Net through defend_npz, full width, {DUP_CLOUDS} "
          f"clouds, batch {DUP_B}")
    with tempfile.TemporaryDirectory() as tmp:
        launches["dup"], dup_rates = run_defend_npz(dev, tmp, dup_clouds)
    profile_dupnet(dev, dup_clouds[:DUP_B])

    used_in = {"repulsion_loss": "reference", "plane_sample": "reference",
               "repulsion_mask": "fast", "repulsion_loss_masked": "fast",
               "fps": "dup", "ballquery": "dup"}
    for row in rows:
        mode = used_in[row["name"]]
        row["launches"] = launches[mode][row["name"]]
        if row["launches"] <= 0:
            fail(f"{row['name']} was not launched in the {mode} mode")
    print("clouds/s: " + json.dumps(rates))
    print("DUP-Net clouds/s (defend_npz, host clock around main()): "
          + json.dumps(dup_rates) + f" on {card}")
    print(card)
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms")}
        | {"route": "cuda", "bound_ms": r["bound"][0],
           "bound_by": r["bound"][1], "library_ms": r.get("library_ms")}
        for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
