#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card (a Hopper H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. builds the CUDA kernels from `if_defense_tpu_torch/csrc/` with nvcc
     (sm_90a) and prints the build time and each kernel's registers;
  2. holds each kernel (B1 repulsion loss, B2 repulsion mask, B3 masked
     repulsion loss, B4 plane sampling) against its plain PyTorch version
     at the ConvONet-Opt shapes (B=48, N=Q=1024, 64x64x32 planes), forward
     and backward, in f32 and bf16, B1-B3 on random points with duplicates
     and on a lattice whose rows tie at their thresholds; times each kernel,
     its plain version and B4's one-call PyTorch yardstick (`F.grid_sample`,
     forward + grid gradient) as set out below;
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
     times both;
  6. checks DUP-Net on a small input (B=2, N=1024, the repository's PU-Net
     weights, the same resampling draws) against the port's CPU run;
  7. writes a synthetic npz (256 clouds x 1024 points) and runs
     `if_defense_tpu_torch.cli.defend_npz` at full width (batch 128, PU-Net
     1024 x 4 with `weights/punet_1024_up4.npz`): DUP-Net alone with the
     B5/B6 launch counters set to 0 just before and read just after (first
     run), then all three defenses, then DUP-Net again (warm run); then
     profiles one batch of DUP-Net with torch.profiler;
  8. holds B4 with its plane gradient against the plain version at the
     training shapes (B=32, Q=2048, 64x64x32 planes, uv from [-0.1, 1.1] so
     the clamp is exercised): forward, plane gradient alone (the training
     call), plane and uv gradient together, in f32, and forward + plane
     gradient with bf16 planes; times the training call, its plain version
     and `F.grid_sample` with the gradient to its input;
  9. trains a small ConvONet (c_dim 8, 16x16 planes) and a narrow ONet (c_dim
     32, decoder 16) for 3 steps on the card and on the CPU from the same
     perturbed `flax_init_params` and sampler batches, and compares losses
     and step 1's gradients;
 10. writes a synthetic occupancy npz (64 union-of-spheres shapes, 3000
     surface points and 10000 labelled queries each, by
     `tools/build_occupancy_dataset.py --synthetic`) and runs
     `if_defense_tpu_torch.cli.train_implicit` at full width for 100 steps
     at lr 1e-3, ConvONet at the CLI's defaults (batch 32, 600 input points,
     2048 queries, 64x64 planes, c_dim 32) and ONet at c_dim 512, hidden
     512, decoder 256, each twice (first and warm run), with B4's launch
     counters set to 0 just before the ConvONet runs and read just after;
     then profiles 10 ConvONet steps with torch.profiler;
 11. checks a small ONet-Opt on the card against the port's CPU run, then
     runs `if_defense_tpu_torch.cli.opt_defense --variant onet` on phase 4's
     clouds (48 x 1024) with the ONet weights phase 10 trained, 201 steps in
     the reference mode, with B1's launch counter set to 0 just before and
     read just after (first run), then again (warm run).
The last lines are DUP-Net's clouds/s, the card's name and power limit, one
JSON line of the kernels, and `{"ok": true, "device": {...}}`.

Each kernel row carries three times, all in f32 at the path's shapes:
- `device_ms` (also `ms`): the device time of what the wrapper launches per
  call (its kernels, and any fill or cast it does around them), from
  torch.profiler over 20 calls of the wrapper alone, forward and backward
  (the backward fed the gradient, so no harness loss runs): the self
  device time of the kernels named, summed, over 20. The printed graph
  replay (one call captured in a CUDA graph, CUDA events around 50
  replays) cross-checks it and stands in for it if the profiler ever sees
  no kernel;
- `call_ms`: the median of 20 CUDA-event timings of one whole eager call
  with a harness loss, `(out * w).sum()`, and its backward: what an eager
  step pays, host work included wherever the device waits for it;
- `plain_ms`: the same whole-call timing of the plain version.
B4's rows add `library_device_ms` (also `library_ms`: every kernel of
`F.grid_sample`'s forward and backward, its gradient's fill included) and
`library_call_ms`. `bound_share` is `bound_ms / device_ms`.

Each kernel's `bound_ms` is the least time the card could take for its
work on this run's inputs: the larger of its operations over 67 TFLOP/s
(f32, outside the tensor cores) and its bytes (each input read once, each
output written once) over 3.35 TB/s, the H100 SXM's published peaks.
Operations counted: 8 flops for a pair's squared distance (3 sub, 3 mul,
2 add) and 1 for its selection compare; 50 for a weighted repulsion pair's
term and gradient; 9 per channel for a bilinear sample and 12 for its uv
gradient; 8 per channel for a query's share of the plane gradient (4
multiplies and 4 adds into the corners), whose bytes are uv and the output
gradient read once and the plane gradient written once; FPS 10 per point
and step (distance, min, compare); ball query 9 per (centre, point) pair
scanned up to the centre's nsample-th hit and 5 per |v|^2.

f32 phases run with TF32 off for matmuls and cuDNN convolutions.
"""

from __future__ import annotations

import json
import os
import re
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
TB, TQ = 32, 2048                        # train_implicit's batch and queries
TRAIN_STEPS, TRAIN_LR = 100, 1e-3
DEVICE_REPS, GRAPH_REPS = 20, 50          # calls per device-time reading
ROOT = os.path.dirname(os.path.abspath(__file__))


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
    """Median of `reps` CUDA-event timings of one whole call of `fn`: what
    an eager step pays per call, host work (autograd, allocation, binding)
    included wherever the device waits for it."""
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


def _label(key: str, names) -> str | None:
    """The name in `names` that a profiler kernel name is (a function name
    followed by its template arguments or parameters), else None; with
    `names` None, the kernel's own function name."""
    if names is None:
        key = key.replace("(anonymous namespace)::", "")
        found = re.search(r"(\w+)\s*[<(]", key.removeprefix("void "))
        return found.group(1) if found else key[:40]
    return next((n for n in names if re.search(rf"\b{re.escape(n)}[<(]", key)),
                None)


def device_ms(fn, names=None, reps: int = DEVICE_REPS):
    """Device time of what `fn` launches per call: torch.profiler over
    `reps` calls, for each kernel named in `names` (every kernel if None)
    its self device time per launch times its launches per call, summed
    (the profiler has been seen to drop a kernel's first launch of the
    window, so a total over `reps` would undercount). -> (ms,
    {kernel: its ms per call}, {kernel seen but not counted: launches}), or
    None where the profiler saw no kernel of `names`."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    stats = prof.key_averages()
    host = {e.key for e in stats
            if e.device_type == torch.autograd.DeviceType.CPU}
    total, ours, others = 0.0, {}, {}
    for e in stats:
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.self_device_time_total <= 0 or e.key in host):
            continue
        label = _label(e.key, names)
        if label is None:
            label = _label(e.key, None)
            others[label] = others.get(label, 0) + e.count
            continue
        ms = e.self_device_time_total / 1e3 / e.count * max(
            1, round(e.count / reps))
        total += ms
        ours[label] = ours.get(label, 0.0) + ms
    if not ours:
        return None
    return total, ours, others


def graph_ms(fn, reps: int = GRAPH_REPS) -> float:
    """Device time per call of `fn` with no host work between kernels: one
    call captured in a CUDA graph (its buffers allocated at capture), then
    CUDA events around `reps` back-to-back replays, over `reps`. Includes
    the gaps between the graph's kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_times(call, plain, bare, names, library=None) -> dict:
    """The timings of one kernel row. `call` and `plain` are the harness
    calls (forward, harness loss, backward) of the wrapper and of the plain
    version, timed whole (`call_ms`, `plain_ms`). `bare` runs only the
    wrapper (its backward fed the gradient, no harness loss); the kernels
    it launches, `names`, are read by the profiler (`device_ms`) and, as a
    cross-check, by graph replay (`graph_ms`). The fallback where the
    profiler sees no kernel is the graph replay, never the whole call.
    `library` = (harness call, bare call) of the one PyTorch call computing
    the same function: `library_call_ms`, and `library_device_ms` over
    every kernel its bare call launches."""
    got = device_ms(bare, names)
    graph = graph_ms(bare)
    if got is None:
        print(f"  the profiler saw no kernel of {names}: device_ms from "
              "graph replay")
        got = (graph, {}, {})
    dev_ms, ours, others = got
    row = dict(call_ms=median_ms(call), plain_ms=median_ms(plain),
               device_ms=dev_ms, graph_ms=graph,
               library_call_ms=None, library_device_ms=None)
    split = ", ".join(f"{k} {v:.4f}" for k, v in ours.items())
    print(f"  device {dev_ms:.4f} ms per call (profiler, {DEVICE_REPS} calls:"
          f" {split}{f'; not counted: {others}' if others else ''}), graph "
          f"replay {graph:.4f} ms, whole call {row['call_ms']:.4f} ms")
    if library is not None:
        lib = device_ms(library[1])
        row["library_call_ms"] = median_ms(library[0])
        row["library_device_ms"] = (lib[0] if lib is not None
                                    else graph_ms(library[1]))
        split = (", ".join(f"{k} {v:.4f}" for k, v in lib[1].items())
                 if lib else "graph replay")
        print(f"  library device {row['library_device_ms']:.4f} ms "
              f"({split}), whole call {row['library_call_ms']:.4f} ms")
    return row


def bare_grad(fn, x: torch.Tensor, g: torch.Tensor, *args):
    """fn(x, *args) and its backward to x alone, fed the gradient `g`: only
    what the wrapper launches (no harness loss and no backward of it)."""
    x = x.detach().requires_grad_(True)
    return torch.autograd.grad(fn(x, *args), x, g)


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


def lattice(gen, b: int, shape: tuple[int, int, int]) -> np.ndarray:
    """b clouds of the nodes of a shape[0] x shape[1] x shape[2] grid at
    spacing 1/16, each in its own random order: every squared distance is
    exact in f32 (and bf16), so ties at a row's k-th smallest are real."""
    axes = [np.arange(s) - s // 2 for s in shape]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3) / 16
    return np.stack([grid[gen.permutation(len(grid))]
                     for _ in range(b)]).astype(np.float32)


def check_repulsion(what: str, pts, moved, w) -> tuple[list, list, torch.Tensor]:
    """B1, B2 and B3 against their plain versions on one input, f32 and
    bf16: losses rtol 1e-5, gradients atol 1e-5 of the largest entry and
    rtol 1e-4 (f32) or 2^-7 (bf16), masks bit-equal. B3 takes the f32 mask
    of `pts` at the points `moved`. -> (B1 f32 errors, B3 f32 errors, the
    f32 mask)."""
    from if_defense_tpu_torch.defense import repulsion as rep
    from if_defense_tpu_torch.ops import cuda_repulsion

    tols = ((torch.float32, 1e-4), (torch.bfloat16, 2.0**-7))
    errs = {"B1": [], "B3": []}
    masks = {}
    for dt, _ in tols:
        mk = cuda_repulsion.repulsion_mask_cuda(pts.to(dt))
        diff = int((mk != rep.repulsion_mask(pts.to(dt))).sum())
        print(f"  {what} B2 mask {str(dt).split('.')[-1]}: {diff} entries "
              f"differ (bit-equal required), {int(mk.sum())} ones")
        if diff:
            fail(f"B2 mask disagrees with its plain version ({what})")
        masks[dt] = mk
    mask = masks[torch.float32]
    pairs = {"B1": (cuda_repulsion.repulsion_loss_cuda,
                    rep.repulsion_loss_threshold, pts),
             "B3": (lambda x: cuda_repulsion.repulsion_loss_masked_cuda(x, mask),
                    lambda x: rep.repulsion_loss_masked(x, mask), moved)}
    for kid, (kern, plain, x) in pairs.items():
        for dt, gr in tols:
            lk, gk = value_and_grad(kern, x.to(dt), w)
            lp, gp = value_and_grad(plain, x.to(dt), w)
            tag = f"{what} {kid} {str(dt).split('.')[-1]}"
            e = [compare(f"{tag} loss", lk, lp, 1e-9, 1e-5),
                 compare(f"{tag} grad", gk, gp, grad_atol(gp), gr)]
            if dt == torch.float32:
                errs[kid] += e
    return errs["B1"], errs["B3"], mask


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

    print("B1-B3 on random points with duplicates (B3's mask built from the "
          "points, then held while they move by ~1e-3):")
    moved = pts + 1e-3 * torch.randn(pts.shape, device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(1))
    b1_errs, b3_errs, mask = check_repulsion("random", pts, moved, w)
    print(f"B1-B3 on a 16x8x8 lattice at spacing 1/16 (ties at every "
          f"threshold), {B} clouds in random orders:")
    lat = torch.from_numpy(lattice(gen, B, (16, 8, 8))).to(dev)
    e1, e3, _ = check_repulsion("lattice", lat, lat, w)
    b1_errs += e1
    b3_errs += e3

    pts_bytes = 4 * B * N * 3
    print("B1 repulsion_loss (fwd + bwd), random points, f32:")
    rows.append(dict(
        name="repulsion_loss", id="B1",
        source="if_defense_tpu_torch/csrc/repulsion.cu",
        replaces="if_defense_tpu/ops/pallas_repulsion.py:196",
        max_abs_err=max(b1_errs),
        bound=bound(9 * B * N * N + 50 * B * N * 5, 2 * pts_bytes + 8 * B),
        **kernel_times(
            lambda: value_and_grad(cuda_repulsion.repulsion_loss_cuda, pts, w),
            lambda: value_and_grad(rep.repulsion_loss_threshold, pts, w),
            lambda: bare_grad(cuda_repulsion.repulsion_loss_cuda, pts, w),
            ("rep_fwd", "rows_to_loss", "rep_bwd"))))

    print("B2 repulsion_mask, random points, f32:")
    rows.append(dict(
        name="repulsion_mask", id="B2",
        source="if_defense_tpu_torch/csrc/repulsion.cu",
        replaces="if_defense_tpu/ops/pallas_repulsion.py:267",
        max_abs_err=0.0, bound=bound(9 * B * N * N, pts_bytes + B * N * N),
        **kernel_times(
            lambda: cuda_repulsion.repulsion_mask_cuda(pts),
            lambda: rep.repulsion_mask(pts),
            lambda: cuda_repulsion.repulsion_mask_cuda(pts), ("rep_mask",))))

    print("B3 repulsion_loss_masked (fwd + bwd), moved points, f32:")

    def masked(x):
        return cuda_repulsion.repulsion_loss_masked_cuda(x, mask)

    rows.append(dict(
        name="repulsion_loss_masked", id="B3",
        source="if_defense_tpu_torch/csrc/repulsion.cu",
        replaces="if_defense_tpu/ops/pallas_repulsion.py:390",
        max_abs_err=max(b3_errs),
        bound=bound(50 * float(mask.sum()),
                    2 * pts_bytes + 8 * B + B * N * N),
        **kernel_times(
            lambda: value_and_grad(masked, moved, w),
            lambda: value_and_grad(
                lambda x: rep.repulsion_loss_masked(x, mask), moved, w),
            lambda: bare_grad(masked, moved, w),
            ("rep_masked_fwd", "rows_to_loss", "rep_masked_bwd"))))

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
    grid = 2 * uv[:, None] - 1

    def sample(g):
        return torch.nn.functional.grid_sample(
            plane_nchw, g, mode="bilinear", padding_mode="border",
            align_corners=True)

    def library():
        g = (2 * uv[:, None] - 1).detach().requires_grad_(True)
        out = sample(g)
        (dg,) = torch.autograd.grad((out * g_nchw).sum(), g)
        return out, dg

    lib_out = library()[0].detach()[:, :, 0].transpose(1, 2)
    diff = float((lib_out - run(interp.bilinear_plane_sample, plane)[0])
                 .abs().max())
    print(f"  grid_sample vs plain: max abs diff {diff:.3e}")
    rows.append(dict(
        name="plane_sample", id="B4",
        source="if_defense_tpu_torch/csrc/interp.cu",
        replaces="if_defense_tpu/ops/pallas_interp.py:233",
        max_abs_err=max(errs),
        bound=bound(21 * B * N * C,
                    4 * (B * R * R * C + 2 * B * N * 2 + 2 * B * N * C)),
        **kernel_times(
            lambda: run(cuda_interp.plane_sample_cuda, plane),
            lambda: run(interp.bilinear_plane_sample, plane),
            lambda: bare_grad(lambda u: cuda_interp.plane_sample_cuda(
                plane, u), uv, g_out),
            ("sample_fwd", "sample_bwd"),
            library=(library, lambda: bare_grad(sample, grid, g_nchw)))))
    for r in rows:
        print_row(r)
    return rows


def print_row(r: dict) -> None:
    lib = r.get("library_device_ms")
    print(f"  {r['id']} {r['name']}: device {r['device_ms']:.4f} ms "
          f"(whole call {r['call_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
          f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}, share "
          f"{r['bound'][0] / r['device_ms']:.3f})"
          + (f", library device {lib:.4f} ms (whole call "
             f"{r['library_call_ms']:.4f})" if lib is not None else ""))


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


def run_cli(tmp: str, name: str, extra: list[str],
            weights: str | None = None) -> dict:
    from if_defense_tpu_torch.cli import opt_defense
    from if_defense_tpu_torch.data import load_npz

    data = os.path.join(tmp, f"{name}.npz")
    out_path, = opt_defense.main([
        "--data_root", data,
        "--weights", weights or os.path.join(tmp, "weights.npz"),
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
    Times are of unmasked calls (`kernel_times`); a row's numbers are sums
    over the four levels (one batch of the path)."""
    from if_defense_tpu_torch.ops import (
        farthest_point_sample_plain,
        query_ball_point_plain,
    )
    from if_defense_tpu_torch.ops.cuda_ballquery import ballquery_cuda
    from if_defense_tpu_torch.ops.cuda_fps import fps_cuda

    gen = torch.Generator(device=dev).manual_seed(2)
    # per kernel: times, flops and bytes, summed over the levels
    tot = {k: dict.fromkeys(("call_ms", "plain_ms", "device_ms", "graph_ms",
                             "flops", "bytes"), 0.0)
           for k in ("fps", "ballquery")}
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
        calls = {
            "fps": (lambda: fps_cuda(xyz, s),
                    lambda: farthest_point_sample_plain(xyz, s),
                    ("fps_kernel",)),
            "ballquery": (lambda: ballquery_cuda(radius, 32, xyz, new),
                          lambda: query_ball_point_plain(radius, 32, xyz, new),
                          ("ballquery_kernel",))}
        for k, (kern, plain, names) in calls.items():
            print(f"  level {level} {k}:")
            t = kernel_times(kern, plain, kern, names)
            bound_ms, by = bound(*work[k])
            print(f"  level {level} {k}: device {t['device_ms']:.4f} ms, "
                  f"plain {t['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({by})")
            for key in ("call_ms", "plain_ms", "device_ms", "graph_ms"):
                tot[k][key] += t[key]
            tot[k]["flops"] += work[k][0]
            tot[k]["bytes"] += work[k][1]
        print(f"  level {level}: a centre scans "
              f"{float(scanned.float().mean()):.1f} of {n} points on average")
    rows = []
    for k, rid, src, rep_ in (
            ("fps", "B5", "fps.cu", "pallas_fps.py:82"),
            ("ballquery", "B6", "ballquery.cu", "pallas_ballquery.py:71")):
        t = tot[k]
        rows.append(dict(
            name=k, id=rid, source=f"if_defense_tpu_torch/csrc/{src}",
            replaces=f"if_defense_tpu/ops/{rep_}", max_abs_err=0.0,
            call_ms=t["call_ms"], plain_ms=t["plain_ms"],
            device_ms=t["device_ms"], graph_ms=t["graph_ms"],
            library_call_ms=None, library_device_ms=None,
            bound=bound(t["flops"], t["bytes"])))
        print(f"  {rid}, summed over the 4 levels:")
        print_row(rows[-1])
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


def check_plane_gradient(dev) -> dict:
    """B4 with its plane gradient at the training shapes, against the plain
    version: forward, plane gradient alone, plane and uv gradient, in f32
    (atol 1e-5 of the largest reference entry), and forward + plane
    gradient with bf16 planes. Times the training call (forward + plane
    gradient), its plain version and `F.grid_sample` with the gradient to
    its input (`kernel_times`)."""
    from if_defense_tpu_torch.ops import cuda_interp, interp

    gen = np.random.default_rng(8)
    plane = torch.from_numpy(
        gen.normal(size=(TB, R, R, C)).astype(np.float32)).to(dev)
    uv = torch.from_numpy(
        gen.uniform(-0.1, 1.1, (TB, TQ, 2)).astype(np.float32)).to(dev)
    g_out = torch.from_numpy(
        gen.normal(size=(TB, TQ, C)).astype(np.float32)).to(dev)

    def run(fn, pl, with_uv=False):
        p = pl.detach().requires_grad_(True)
        u = uv.detach().requires_grad_(with_uv)
        out = fn(p, u)
        grads = torch.autograd.grad((out.float() * g_out).sum(),
                                    (p, u) if with_uv else (p,))
        return (out.detach(), *grads)

    def plain(pl, u):        # the kernel's semantics: f32 math, plane's type out
        return interp.bilinear_plane_sample(pl.float(), u).to(pl.dtype)

    def rel(ref):
        return 1e-5 * float(ref.detach().float().abs().max())

    errs = []
    ok_, dk = run(cuda_interp.plane_sample_cuda, plane)
    op, dp = run(plain, plane)
    errs += [compare("out f32", ok_, op, rel(op), 0.0),
             compare("dplane f32", dk, dp, rel(dp), 0.0)]
    _, dk, duk = run(cuda_interp.plane_sample_cuda, plane, True)
    _, dp, dup = run(plain, plane, True)
    errs.append(compare("dplane f32 (with uv grad)", dk, dp, rel(dp), 0.0))
    compare("uv grad f32 (with dplane)", duk, dup, rel(dup), 1e-5)
    pl16 = plane.to(torch.bfloat16)
    ok_, dk = run(cuda_interp.plane_sample_cuda, pl16)
    op, dp = run(plain, pl16)
    compare("out bf16", ok_, op, 1e-3, 2.0**-7)
    compare("dplane bf16", dk, dp, rel(dp), 2.0**-7)
    print(f"  {int(((uv < 0) | (uv > 1)).any(-1).sum())} of "
          f"{TB * TQ} queries clamped; border cells' gradient "
          f"{float(dp[:, 0, 0].float().abs().sum()):.3f} (nonzero)")

    plane_nchw = plane.permute(0, 3, 1, 2)
    g_nchw = g_out.permute(0, 2, 1)[:, :, None, :]
    grid = (2 * uv[:, None] - 1)

    def sample(x):
        return torch.nn.functional.grid_sample(
            x, grid, mode="bilinear", padding_mode="border",
            align_corners=True)

    def library():
        x = plane_nchw.detach().requires_grad_(True)
        return torch.autograd.grad((sample(x) * g_nchw).sum(), x)

    lib_grad = library()[0].permute(0, 2, 3, 1)
    diff = float((lib_grad - run(interp.bilinear_plane_sample, plane)[1])
                 .abs().max())
    print(f"  grid_sample input gradient vs plain: max abs diff {diff:.3e}")
    plane_bytes, q = 4 * TB * R * R * C, TB * TQ
    print("  B4 training call (fwd + plane grad), f32:")
    row = dict(
        name="plane_sample_dplane", id="B4",
        source="if_defense_tpu_torch/csrc/interp.cu",
        replaces="if_defense_tpu/ops/pallas_interp.py:74",
        max_abs_err=max(errs),
        bound=bound((9 + 8) * q * C,
                    2 * plane_bytes + 2 * 8 * q + 2 * 4 * q * C),
        # the wrapper's fill of its f32 accumulator counts; a bf16 plane's
        # cast would too (not timed: f32 here)
        **kernel_times(
            lambda: run(cuda_interp.plane_sample_cuda, plane),
            lambda: run(interp.bilinear_plane_sample, plane),
            lambda: bare_grad(cuda_interp.plane_sample_cuda, plane, g_out, uv),
            ("sample_fwd", "sample_bwd_plane", "FillFunctor",
             "direct_copy_kernel_cuda"),
            library=(library, lambda: bare_grad(sample, plane_nchw, g_nchw))))
    print_row(row)
    return row


def perturbed(tree: dict, seed: int) -> dict:
    """Every tensor moved off its init (flax zero-initialises each block's
    fc_1 and the CBN kernels): kernels by 0.3/sqrt(fan_in), other tensors
    by 0.05, running variances scaled by exp(0.2 N(0, 1))."""
    from if_defense_tpu_torch.utils.params_io import (
        flatten_params,
        unflatten_params,
    )

    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flatten_params(tree).items():
        n = rng.normal(size=v.shape)
        if k.endswith("/var"):
            v = v * np.exp(0.2 * n)
        else:
            v = v + (0.3 / np.sqrt(np.prod(v.shape[:-1])) if v.ndim > 1
                     else 0.05) * n
        out[k] = v.astype(np.float32)
    return unflatten_params(out)


def small_models():
    from if_defense_tpu_torch.implicit import (
        ConvOccupancyNetwork,
        OccupancyNetwork,
    )

    return {"convonet c8 16x16": lambda: ConvOccupancyNetwork(8, 8, 16),
            "onet c32 h32 d16": lambda: OccupancyNetwork(32, 32, 16)}


def check_small_training(dev, occ_npz: str) -> None:
    """3 training steps on the card and on the CPU from the same
    `perturbed(flax_init_params)` and sampler batches (B=4, 256 input
    points, 512 queries, lr 1e-4): step 1's loss within rtol 1e-5, its
    gradients within rtol 1e-4 and atol 1e-4 of each tensor's largest entry
    (a tensor whose gradient is 0 up to rounding, as a bias before a batch
    norm, stays so), the 3 losses within rtol 1e-4.

    The weights are perturbed because flax's zero biases put the UNet's
    pre-activations over every empty plane cell exactly at ReLU's kink,
    where the last bit of rounding decides whether a gradient passes, and
    the card and the CPU then route a whole region's gradient differently."""
    from if_defense_tpu_torch.implicit.training import (
        OccupancyBatchSampler,
        init_occupancy_model,
        make_occupancy_train_step,
    )
    from if_defense_tpu_torch.utils.params_io import params_from_jax

    with np.load(occ_npz) as z:
        arrays = (z["pointcloud"][:8], z["points"][:8], z["points_occ"][:8])
    for name, make in small_models().items():
        sampler = OccupancyBatchSampler(*arrays, pointcloud_n=256,
                                        points_subsample=512, seed=0)
        batches = [sampler.sample(4) for _ in range(3)]
        runs = []
        for d in ("cpu", dev):
            model = make()
            model.load_state_dict(params_from_jax(
                perturbed(init_occupancy_model(model, 0), 1)))
            model.to(d)
            _, step = make_occupancy_train_step(model, 1e-4)
            losses = []
            for i, b in enumerate(batches):
                losses.append(float(step(*(torch.from_numpy(a).to(d)
                                           for a in b))["loss"]))
                if i == 0:
                    grads = {n: p.grad.detach().cpu()
                             for n, p in model.named_parameters()}
            runs.append((losses, grads))
        (lc, gc), (lg, gg) = runs
        zero = 1e-6 * max(float(g.abs().max()) for g in gc.values())
        worst = 0.0
        for n, ref in gc.items():
            top = float(ref.abs().max())
            if top < zero:
                if float(gg[n].abs().max()) >= zero:
                    fail(f"{name}: gradient of {n} is 0 on the CPU only")
                continue
            err = (gg[n] - ref).abs() / (1e-4 * top + 1e-4 * ref.abs())
            worst = max(worst, float(err.max()))
        print(f"  {name}: losses CPU {lc}, card {lg}; step-1 gradients of "
              f"{len(gc)} tensors, worst error / bound {worst:.3f}")
        if abs(lg[0] - lc[0]) > 1e-5 * abs(lc[0]) or worst > 1 or any(
                abs(a - b) > 1e-4 * abs(a) for a, b in zip(lc, lg)):
            fail(f"{name}: training on the card disagrees with the CPU run")


def build_occupancy_npz(tmp: str) -> str:
    path = os.path.join(tmp, "occ.npz")
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "build_occupancy_dataset.py"),
         "--synthetic", "64", "--surface_n", "3000", "--query_n", "10000",
         "--out", path], check=True, timeout=300, stdout=subprocess.DEVNULL)
    return path


def run_train_cli(tmp: str, occ_npz: str, variant: str, tag: str) -> dict:
    """One `train_implicit` run at full width: losses finite, the last
    logged loss below the first, the npz loads strictly."""
    from if_defense_tpu_torch.cli import train_implicit
    from if_defense_tpu_torch.implicit import (
        ConvOccupancyNetwork,
        OccupancyNetwork,
    )
    from if_defense_tpu_torch.utils.params_io import (
        load_params_npz,
        params_from_jax,
    )

    out = os.path.join(tmp, f"{variant}_{tag}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = train_implicit.main([
        "--variant", variant, "--data", occ_npz, "--steps", str(TRAIN_STEPS),
        "--lr", str(TRAIN_LR), "--log_every", "10", "--output", out,
        "--device", "cuda"])
    seconds = time.perf_counter() - t0
    with open(out + ".metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records]
    model = ConvOccupancyNetwork() if variant == "convonet" else OccupancyNetwork()
    model.load_state_dict(params_from_jax(load_params_npz(path)), strict=True)
    rate = records[-1]["steps_per_sec"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {variant} {tag}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(acc {records[0]['acc']:.3f} -> {records[-1]['acc']:.3f}), "
          f"{rate:.2f} steps/s (metrics), {seconds:.2f} s around main(), "
          f"peak device memory {peak:.2f} GiB")
    if len(records) != TRAIN_STEPS // 10 or not np.isfinite(losses).all():
        fail(f"{variant} {tag}: {len(records)} metrics lines or non-finite")
    if not losses[-1] < losses[0]:
        fail(f"{variant} {tag}: training loss did not fall")
    return dict(path=path, steps_per_sec=rate)


def profile_training(dev, occ_npz: str) -> None:
    """torch.profiler over 10 warm ConvONet training steps at the CLI's
    defaults: wall time, device kernel time and busy share, B4's share, and
    the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from if_defense_tpu_torch.implicit import ConvOccupancyNetwork
    from if_defense_tpu_torch.implicit.training import (
        OccupancyBatchSampler,
        init_occupancy_model,
        make_occupancy_train_step,
    )

    with np.load(occ_npz) as z:
        sampler = OccupancyBatchSampler(z["pointcloud"], z["points"],
                                        z["points_occ"], pointcloud_n=600,
                                        points_subsample=TQ, seed=1)
    model = ConvOccupancyNetwork()
    init_occupancy_model(model, 1)
    model.to(dev)
    _, step = make_occupancy_train_step(model, TRAIN_LR)
    batches = [[torch.from_numpy(a).to(dev) for a in sampler.sample(TB)]
               for _ in range(13)]
    for b in batches[:3]:
        step(*b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[3:]:
            step(*b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # a user annotation's device-side range (Adam's step) spans kernels
    # that are counted on their own; it also has a host-side event of its
    # name, which no kernel has
    stats = prof.key_averages()
    host = {e.key for e in stats
            if e.device_type == torch.autograd.DeviceType.CPU}
    events = [e for e in stats
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0 and e.key not in host]
    if not events:
        print(f"  profile, 10 steps: wall {wall:.3f} ms; device time not "
              "measured (the profiler saw no CUDA kernel)")
        return
    busy = sum(e.self_device_time_total for e in events) / 1e3
    ours = sum(e.self_device_time_total for e in events
               if "sample_fwd" in e.key or "sample_bwd" in e.key) / 1e3
    print(f"  profile, 10 ConvONet steps (batch {TB}): wall {wall:.3f} ms, "
          f"device kernels {busy:.3f} ms (busy share {busy / wall:.3f}), "
          f"B4 fwd + plane grad {ours:.3f} ms ({ours / busy:.3f} of device "
          "time)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} "
              f"{e.key[:90]}")


def check_small_onet_opt(dev) -> None:
    """ONet-Opt on a small input, CUDA (kernels) vs CPU (plain versions),
    same perturbed weights and draws; the bound of phase 3."""
    from if_defense_tpu_torch.defense.ifdefense import onet_opt_defense
    from if_defense_tpu_torch.implicit import OccupancyNetwork
    from if_defense_tpu_torch.utils.params_io import (
        flax_init_params,
        params_from_jax,
    )

    sd = params_from_jax(perturbed(flax_init_params(
        3, "onet", c_dim=32, hidden_dim=32, decoder_hidden=16), 4))
    gen = np.random.default_rng(5)
    pc = gen.normal(size=(2, 512, 3)).astype(np.float32) * 0.3
    sel = gen.uniform(-0.4, 0.4, (2, 128, 3)).astype(np.float32)
    init = gen.uniform(-0.4, 0.4, (2, 256, 3)).astype(np.float32)
    outs = []
    for d in ("cpu", dev):
        model = OccupancyNetwork(32, 32, 16)
        model.load_state_dict(sd)
        defend = onet_opt_defense(model.to(d), iterations=SMALL_ITERS,
                                  input_npoint=128, sample_npoint=256)
        draws = tuple(torch.from_numpy(a).to(d) for a in (sel, init))
        outs.append(defend(torch.from_numpy(pc).to(d), draws=draws).cpu())
    err = (outs[0] - outs[1]).abs()
    share = float((err <= 1e-4).float().mean())
    print(f"  onet reference: {share:.5f} of coordinates within 1e-4, "
          f"max {float(err.max()):.3e} (bound {2 * LR * (SMALL_ITERS + 1):g})")
    if share < 0.999 or float(err.max()) > 2 * LR * (SMALL_ITERS + 1):
        fail("small ONet-Opt run disagrees with the CPU run")


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

    print(f"phase 8: B4 with the plane gradient at the training shapes "
          f"(B={TB}, Q={TQ}, {R}x{R}x{C})")
    rows.append(check_plane_gradient(dev))

    train_rates, onet_rates = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        occ_npz = build_occupancy_npz(tmp)
        print("phase 9: small training, CUDA vs CPU, same init and batches")
        check_small_training(dev, occ_npz)

        print(f"phase 10: train_implicit, full width, {TRAIN_STEPS} steps "
              f"at lr {TRAIN_LR:g}")
        for k in cuda_interp.launches:
            cuda_interp.launches[k] = 0
        runs = {}
        for variant in ("convonet", "onet"):
            for tag in ("first", "warm"):
                runs[variant, tag] = run_train_cli(tmp, occ_npz, variant, tag)
            if variant == "convonet":
                launches["train"] = dict(cuda_interp.launches)
                print(f"  convonet, both runs: launches {launches['train']}")
                want = 2 * 3 * TRAIN_STEPS     # 3 planes a step, 2 runs
                if launches["train"] != {"plane_sample": want,
                                         "plane_sample_dplane": want}:
                    fail(f"B4 launches {launches['train']} in ConvONet "
                         f"training, not {want} forward and {want} plane "
                         "gradient (and no uv gradient)")
        train_rates = {f"{v} {t}": r["steps_per_sec"]
                       for (v, t), r in runs.items()}
        profile_training(dev, occ_npz)

        print("phase 11: ONet-Opt, small CUDA vs CPU, then opt_defense "
              "--variant onet at full width, 201 steps")
        check_small_onet_opt(dev)
        save_npz(os.path.join(tmp, "onet.npz"),
                 {"test_pc": ellipsoids(np.random.default_rng(0), B),
                  "test_label": np.arange(B) % 40})
        weights = runs["onet", "warm"]["path"]
        for k in cuda_repulsion.launches:
            cuda_repulsion.launches[k] = 0
        onet_rates["first"] = run_cli(tmp, "onet", ["--variant", "onet"],
                                      weights)["clouds_per_sec"]
        launches["onet"] = dict(cuda_repulsion.launches)
        print(f"  onet: launches {launches['onet']}")
        if launches["onet"]["repulsion_loss"] != 2 * 201:
            fail(f"B1 launched {launches['onet']['repulsion_loss']} times "
                 "in ONet-Opt, not 402")
        onet_rates["warm"] = run_cli(tmp, "onet", ["--variant", "onet"],
                                     weights)["clouds_per_sec"]

    used_in = {"repulsion_loss": "reference", "plane_sample": "reference",
               "repulsion_mask": "fast", "repulsion_loss_masked": "fast",
               "fps": "dup", "ballquery": "dup",
               "plane_sample_dplane": "train"}
    for row in rows:
        mode = used_in[row["name"]]
        row["launches"] = launches[mode][row["name"]]
        if row["launches"] <= 0:
            fail(f"{row['name']} was not launched in the {mode} mode")
    print("clouds/s: " + json.dumps(rates))
    print("ONet-Opt clouds/s: " + json.dumps(onet_rates) + f" on {card}")
    print("train_implicit steps/s: " + json.dumps(train_rates) + f" on {card}")
    print("DUP-Net clouds/s (defend_npz, host clock around main()): "
          + json.dumps(dup_rates) + f" on {card}")
    print(card)
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "source", "replaces", "launches",
                           "max_abs_err", "plain_ms", "call_ms", "device_ms",
                           "library_call_ms", "library_device_ms")}
        | {"route": "cuda", "ms": r["device_ms"], "bound_ms": r["bound"][0],
           "bound_by": r["bound"][1],
           "bound_share": r["bound"][0] / r["device_ms"],
           "library_ms": r["library_device_ms"]}
        for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
