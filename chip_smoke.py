#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card (a Hopper H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. builds the CUDA kernels from `if_defense_tpu_torch/csrc/` with nvcc
     (sm_90a) and prints the build time and each kernel's registers;
  2. holds each kernel (B1 repulsion loss, B2 repulsion mask, B3 masked
     repulsion loss, B4 plane sampling) against its plain PyTorch version
     at the ConvONet-Opt shapes (B=48, N=Q=1024, 64x64x32 planes), forward
     and backward, in f32 and bf16, and times both with CUDA events;
  3. checks the whole path on a small input against the port's own CPU run
     (the plain versions) with the same draws;
  4. writes a synthetic npz (48 clouds x 1024 points) and seeded weights,
     and runs `if_defense_tpu_torch.cli.opt_defense` at full width for 201
     steps in the reference mode (f32) and the fast mode (bf16, corner
     cache every 16 steps, cached repulsion graph), with every kernel
     launch counter set to 0 just before each run and read just after.
The last lines are the card's name and power limit, one JSON line of the
kernels, and `{"ok": true, "device": {...}}`.

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
    rows.append(dict(name="repulsion_loss", id="B1",
                     source="if_defense_tpu_torch/csrc/repulsion.cu",
                     replaces="if_defense_tpu/ops/pallas_repulsion.py:196",
                     max_abs_err=max(errs), ms=ms, plain_ms=plain_ms))

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
                     max_abs_err=0.0, ms=ms, plain_ms=plain_ms))

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
                     max_abs_err=max(errs), ms=ms, plain_ms=plain_ms))

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
    ms = median_ms(lambda: run(cuda_interp.plane_sample_cuda, plane))
    plain_ms = median_ms(lambda: run(interp.bilinear_plane_sample, plane))
    rows.append(dict(name="plane_sample", id="B4",
                     source="if_defense_tpu_torch/csrc/interp.cu",
                     replaces="if_defense_tpu/ops/pallas_interp.py:233",
                     max_abs_err=max(errs), ms=ms, plain_ms=plain_ms))
    for r in rows:
        print(f"  {r['id']} {r['name']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms (median of 20, fwd+bwd where "
              "the path takes a gradient)")
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
        gen = np.random.default_rng(0)
        # ellipsoid surfaces with a few outliers (SOR has work to do)
        d = gen.normal(size=(B, 1024, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        pc = d * gen.uniform(0.3, 1.0, (B, 1, 3))
        pc[:, :8] *= 3.0
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

    used_in = {"repulsion_loss": "reference", "plane_sample": "reference",
               "repulsion_mask": "fast", "repulsion_loss_masked": "fast"}
    for row in rows:
        mode = used_in[row["name"]]
        row["launches"] = launches[mode][row["name"]]
        if row["launches"] <= 0:
            fail(f"{row['name']} was not launched in the {mode} mode")
    print("clouds/s: " + json.dumps(rates))
    print(card)
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms")}
        | {"route": "cuda"} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
