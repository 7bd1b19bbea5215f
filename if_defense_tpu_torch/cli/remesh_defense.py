"""ONet-Mesh defense CLI: reconstruct a mesh per cloud and resample it
(port of `if_defense_tpu/cli/remesh_defense.py`).

Mirrors `ONet/remesh_defense.py`: optional SOR -> unit-cube preprocessing ->
encode -> occupancy on a lattice -> isosurface and 1024-point surface
sampling -> unit-sphere normalisation -> npz, written as
`<variant>_remesh-<file>.npz` into `ONet-Mesh/` (or `ConvONet-Mesh/`)
beside the input, with a `.metrics.jsonl` sidecar. Encoding and occupancy
run batched on one device, eagerly (CUDA unless `--device cpu`; f32 with
TF32 off unless `--compute_dtype bfloat16`); the value grids cross to the
host in the `--wire` format, and the native isosurface code marches and
samples each cloud there, one cloud per worker thread. The CLI runs under
deterministic algorithms (restored on return; on the card it sets
`CUBLAS_WORKSPACE_CONFIG` where unset): the encoder's scatter-mean would
otherwise sum with atomics, and a logit moved by its rounding can cross a
quantum boundary of the int8 wire, so two runs, the int8 and sparse wires
and any thread count give the same bits.

Failed reconstructions fall back to a random resample (or zero padding) of
the input cloud, like :159-170. The encoder subset is drawn from a
`torch.Generator` seeded by `--seed` (one per file and split); the host's
numpy stream (`np.random.default_rng(--seed)`: per-cloud sampling seeds,
fallbacks, mesh-mode sampling) is the JAX CLI's.

Usage:
    python -m if_defense_tpu_torch.cli.remesh_defense --data_root adv.npz \
        --weights weights/onet_mn40.npz
"""

from __future__ import annotations

import argparse
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from if_defense_tpu_torch.cli import device_of
from if_defense_tpu_torch.data import load_npz, save_npz
from if_defense_tpu_torch.defense.ifdefense import sample_valid
from if_defense_tpu_torch.defense.sor import sor_defense
from if_defense_tpu_torch.implicit import ConvOccupancyNetwork, OccupancyNetwork
from if_defense_tpu_torch.implicit.generation import (
    DEFAULT_PADDING,
    assemble_sparse_grid,
    compute_value_grids,
    generate_meshes,
    make_convonet_dense_eval,
    make_convonet_sparse_eval,
    mesh_from_value_grid,
    sample_surface,
    sample_value_grid,
)
from if_defense_tpu_torch.ops import normalize_unit_cube
from if_defense_tpu_torch.utils import MetricsWriter
from if_defense_tpu_torch.utils.meshio import export_mesh
from if_defense_tpu_torch.utils.params_io import (
    load_params_npz,
    params_from_jax,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="IF-Defense mesh restoration")
    p.add_argument("--variant", default="onet", choices=["onet", "convonet"])
    p.add_argument("--data_root", required=True)
    p.add_argument("--weights", required=True)
    p.add_argument("--train", action="store_true")
    p.add_argument("--sample_npoint", type=int, default=1024)
    p.add_argument("--input_npoint", type=int, default=None,
                   help="encoder input points (default 300 onet/600 convonet)")
    p.add_argument("--padding_scale", type=float, default=0.9)
    p.add_argument("--threshold", type=float, default=0.2)
    p.add_argument("--resolution0", type=int, default=32)
    p.add_argument("--upsample", type=int, default=4,
                   help="fine cells per coarse voxel (MISE: 2 steps of x2)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--no_sor", action="store_true")
    p.add_argument("--sor_k", type=int, default=2)
    p.add_argument("--sor_alpha", type=float, default=1.1)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--compute_dtype", default=None,
                   choices=[None, "bfloat16"],
                   help="run the coarse+refinement occupancy evaluations "
                        "in bf16 (ONet; the values only feed crossing "
                        "tests and interpolation)")
    p.add_argument("--wire", default="bf16",
                   choices=["bf16", "int8", "sparse"],
                   help="device->host value format. int8 quantises the "
                        "logits (occupancy signs exact, vertex shift "
                        "<= 1 quantum): 1/4 of the dense f32 grid, and on "
                        "the coarse+refine (ONet) path it quantises the "
                        "refined-voxel values. sparse moves only "
                        "surface-adjacent int8 blocks (the same samples "
                        "as int8; ConvONet only, --sample_mode direct)")
    p.add_argument("--sparse_blocks", type=int, default=None,
                   help="static per-cloud active-block budget for "
                        "--wire sparse (default: adaptive, the next power "
                        "of two of the detected count, uncapped)")
    p.add_argument("--sample_mode", default="direct",
                   choices=["direct", "mesh"],
                   help="direct = fused native marching+sampling (no "
                        "indexed mesh, the same surface); mesh = build the "
                        "indexed mesh then area-sample it (reference "
                        "shape: `ONet/remesh_defense.py:151-171`)")
    p.add_argument("--save_mesh", default=None, metavar="DIR",
                   help="also export every reconstructed surface as a "
                        "mesh file under DIR (one per cloud, grouped by "
                        "input file/split)")
    p.add_argument("--mesh_format", default="off",
                   choices=["off", "obj", "ply"])
    p.add_argument("--host_workers", type=int, default=0,
                   help="threads for the per-cloud host marching+"
                        "sampling (direct mode; the native code releases "
                        "the GIL and is stateless). 0 = one per core; the "
                        "per-cloud seeds are fixed up front, so the "
                        "output does not depend on the thread count")
    p.add_argument("--device", default="cuda",
                   help="torch device; without a card pass --device cpu")
    return p.parse_args(argv)


def build_model(args, device: torch.device):
    """(model on `device` in eval mode, encoder input points) from the
    weights npz (the JAX package's flat format; ONet's holds `params` and
    `batch_stats`)."""
    if args.variant == "onet":
        model, input_n = OccupancyNetwork(), args.input_npoint or 300
    else:
        model, input_n = ConvOccupancyNetwork(), args.input_npoint or 600
    model.load_state_dict(
        params_from_jax(load_params_npz(args.weights), model))
    return model.to(device).eval().requires_grad_(False), input_n


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def remesh_batch(model, input_n, batch_pc, args, rng, generator,
                 dense_fn=None, decode_fn=None, encode_fn=None,
                 sparse_fn=None, mesh_tag="", mesh_base=0, mesh_valid=None,
                 draws=None, timings=None):
    """Defend one [B, K, 3] batch; returns ([B, sample_npoint, 3], [B]
    failed flags).

    `draws` replaces the random encoder subset ([B, input_n, 3] on the
    model's device; tests pass JAX's). `mesh_tag`/`mesh_base` name the
    --save_mesh exports (per-file subdirectory, global cloud index).
    `timings`, a dict, receives the host-clock seconds of the phases
    (`encode_s`, `occupancy_s`: evaluation and the copy to the host,
    `host_s`: marching and sampling), each ended by a device synchronise,
    `workers` and the wire's bytes (`wire_bytes`; with more keys from
    `compute_value_grids`). The phases are also `torch.profiler` ranges
    (`remesh.encode`, `remesh.occupancy`, `remesh.host`).
    """
    device = next(model.parameters()).device
    B = batch_pc.shape[0]
    if mesh_valid is None:
        mesh_valid = B

    if args.save_mesh:
        mesh_dir = os.path.join(args.save_mesh, mesh_tag)
        os.makedirs(mesh_dir, exist_ok=True)

        def save_mesh(b, vol=None, iso=None, verts=None, tris=None):
            if b >= mesh_valid:                # batch-padding duplicate
                return
            if vol is not None:
                verts, tris = mesh_from_value_grid(
                    vol, iso, 1.0 + DEFAULT_PADDING)
            if len(verts) == 0:                # degenerate surface: the
                return                         # npz falls back, no mesh
            export_mesh(os.path.join(
                mesh_dir, f"cloud_{mesh_base + b:05d}.{args.mesh_format}"),
                verts, tris)
    else:
        def save_mesh(b, **kw):
            pass

    t0 = time.perf_counter()
    with torch.profiler.record_function("remesh.encode"), torch.no_grad():
        pc = torch.as_tensor(np.asarray(batch_pc, np.float32)).to(device)
        if not args.no_sor:
            pc, mask = sor_defense(pc, args.sor_k, args.sor_alpha)
        else:
            mask = torch.ones(pc.shape[:2], dtype=pc.dtype, device=device)
        proc = normalize_unit_cube(pc, args.padding_scale, mask)
        sel = (sample_valid(proc, mask, input_n, generator)
               if draws is None else draws)
        c = encode_fn(model, sel)
        proc_np = proc.cpu().numpy()
        mask_np = mask.cpu().numpy() > 0.5
    if timings is not None:
        _sync(device)
        timings["encode_s"] = time.perf_counter() - t0

    gen_kwargs = dict(
        threshold=args.threshold, resolution0=args.resolution0,
        upsample=args.upsample, dense_eval_fn=dense_fn, wire=args.wire,
        compute_dtype=args.compute_dtype,
    )
    box = 1.0 + DEFAULT_PADDING

    def occupancy(fn, *a, **kw):
        t1 = time.perf_counter()
        with torch.profiler.record_function("remesh.occupancy"):
            out = fn(*a, **kw)
        if timings is not None:
            timings["occupancy_s"] = time.perf_counter() - t1
        return out

    def grids(**kw):
        return occupancy(compute_value_grids, decode_fn, model, c,
                         **{**gen_kwargs, "timings": timings, **kw})

    def seeds():
        # one base draw + per-cloud offset, fixed up front: the output
        # does not depend on the threads' execution order
        base = int(rng.integers(2**62))
        return [base + b for b in range(B)]

    def sample_cloud_fns():
        """One sampling callable per cloud (raising ValueError on a
        degenerate surface)."""
        if args.sample_mode == "direct" and sparse_fn is not None:
            meta = sparse_fn.sparse_meta
            out_np = occupancy(lambda: {
                k: v.cpu().numpy() for k, v in sparse_fn(model, c).items()})
            if timings is not None:
                timings["wire_bytes"] = sum(v.nbytes for v in out_np.values())
            if "dense" in out_np:
                # auto-demoted to the dense int8 wire (active blocks nearly
                # everywhere): the same int8 values, so the same samples
                print("NOTE: sparse wire auto-demoted to dense int8 "
                      "(active blocks ≥ dense-wire bytes)")
                s = seeds()
                for b in range(B):
                    def one(b=b):
                        vol = out_np["dense"][b]
                        save_mesh(b, vol=vol, iso=meta["iso"])
                        return sample_value_grid(
                            vol, meta["iso"], box, args.sample_npoint,
                            seed=s[b])
                    yield one
                return
            dense_cache = []                  # lazy per-batch fallback
            fallback_lock = threading.Lock()
            s = seeds()
            for b in range(B):
                def one(b=b):
                    try:
                        vol = assemble_sparse_grid(
                            out_np, b, block=meta["block"],
                            nb=meta["nb"], rp=meta["rp"])
                    except RuntimeError:
                        # block budget clipped: the dense int8 wire for
                        # this batch (int8, not bf16, so the samples stay
                        # the sparse wire's)
                        with fallback_lock:
                            if not dense_cache:
                                print("WARNING: sparse wire clipped "
                                      f"(n_need {out_np['n_need'].max()} > "
                                      f"{meta['M']}); dense fallback — "
                                      "raise --sparse_blocks")
                                dense_cache.append(grids(wire="int8")[0])
                        vol = dense_cache[0][b]
                    save_mesh(b, vol=vol, iso=meta["iso"])
                    return sample_value_grid(
                        vol, meta["iso"], box, args.sample_npoint,
                        seed=s[b])
                yield one
        elif args.sample_mode == "direct":
            values, iso = grids()
            s = seeds()
            for b in range(B):
                def one(b=b, vb=values[b], sb=s[b]):
                    save_mesh(b, vol=vb, iso=iso)
                    return sample_value_grid(
                        vb, iso, box, args.sample_npoint, seed=sb)
                yield one
        else:
            # the marching runs inside generate_meshes here
            meshes = occupancy(generate_meshes, decode_fn, model, c,
                               **gen_kwargs)
            for b, (verts, tris) in enumerate(meshes):
                def one(b=b, v=verts, t=tris):
                    save_mesh(b, verts=v, tris=t)
                    return sample_surface(v, t, args.sample_npoint, rng)
                yield one

    out = np.zeros((B, args.sample_npoint, 3), np.float32)
    failed = np.zeros(B, bool)

    def run_one(fn):
        try:
            return fn()
        except ValueError:
            return None                        # degenerate surface

    # device work and the seed draws run here, the per-cloud host work below
    fns = list(sample_cloud_fns())
    t1 = time.perf_counter()
    workers = args.host_workers or (os.cpu_count() or 1)
    if args.sample_mode != "direct":
        workers = 1
    with torch.profiler.record_function("remesh.host"):
        if workers > 1:
            # the native sampler is stateless and releases the GIL; seeds
            # are drawn before, so results do not depend on the order
            with ThreadPoolExecutor(max_workers=workers) as ex:
                samples = list(ex.map(run_one, fns))
        else:
            samples = [run_one(fn) for fn in fns]
    if timings is not None:
        timings["host_s"] = time.perf_counter() - t1
        timings["workers"] = workers

    for b, pts in enumerate(samples):
        if pts is None:
            # reconstruction failed: fall back to resampling the input
            # (remesh_defense.py:159-170)
            failed[b] = True
            valid = proc_np[b][mask_np[b]]
            if len(valid):
                idx = rng.integers(0, len(valid), args.sample_npoint)
                pts = valid[idx]
            else:
                pts = np.zeros((args.sample_npoint, 3), np.float32)
        # unit-sphere normalise
        pts = pts - pts.mean(0, keepdims=True)
        r = np.sqrt((pts**2).sum(-1)).max()
        out[b] = pts / max(r, 1e-12)
    return out, failed


def defend_clouds(model, input_n, pc, args, dense_fn=None, decode_fn=None,
                  encode_fn=None, sparse_fn=None, mesh_tag="", draws=None):
    """Every cloud of `pc` in batches of `--batch_size`, the tail batch
    padded with copies of its last cloud. `draws`: an iterator of encoder
    subsets, one per batch (see `remesh_batch`). -> (defended clouds,
    fallback count)."""
    device = next(model.parameters()).device
    rng = np.random.default_rng(args.seed)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    outs, failures = [], 0
    B = args.batch_size
    for i in range(0, len(pc), B):
        batch = pc[i : i + B].astype(np.float32)
        pad = B - len(batch)
        if pad:
            batch = np.concatenate([batch, batch[-1:].repeat(pad, 0)], 0)
        out, failed = remesh_batch(
            model, input_n, batch, args, rng, generator, dense_fn,
            decode_fn, encode_fn, sparse_fn, mesh_tag=mesh_tag,
            mesh_base=i, mesh_valid=B - pad,
            draws=None if draws is None else next(draws))
        if pad:
            out, failed = out[: B - pad], failed[: B - pad]
        outs.append(out)
        failures += int(failed.sum())
    return np.concatenate(outs, 0), failures


def get_save_name(path: str, variant: str) -> str:
    folder = os.path.join(
        os.path.dirname(os.path.abspath(path)),
        "ONet-Mesh" if variant == "onet" else "ConvONet-Mesh",
    )
    return os.path.join(folder, f"{variant}_remesh-{os.path.basename(path)}")


def build_eval_fns(args, model):
    """(dense_fn, sparse_fn, decode_fn, encode_fn) for the run. ConvONet
    (three planes) evaluates the whole fine lattice (`dense_fn`, and
    `sparse_fn` for `--wire sparse`); ONet runs coarse + refine through
    `decode_fn`."""
    dense_fn, sparse_fn = None, None
    if args.variant == "convonet":
        rf = args.resolution0 * args.upsample
        # the box the generate_meshes query grid uses (1 + padding)
        dense_fn = make_convonet_dense_eval(model, rf, 1.0 + DEFAULT_PADDING)
        if args.wire == "sparse":
            sparse_fn = make_convonet_sparse_eval(
                model, rf, 1.0 + DEFAULT_PADDING, args.threshold,
                max_blocks=args.sparse_blocks)

    def decode_fn(m, p, cc):
        return m.decode(p, cc)

    def encode_fn(m, p):
        return m.encode_inputs(p)

    return dense_fn, sparse_fn, decode_fn, encode_fn


CUBLAS_WORKSPACE = ":4096:8"     # cuBLAS's deterministic workspace


def main(argv=None, draws=None):
    """Defend every npz of `--data_root`; the saved paths. `draws` (for
    tests): an iterator of encoder subsets, one per batch in run order."""
    args = parse_args(argv)
    device = device_of(args.device)
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _remesh(args, device, draws)
    finally:
        torch.use_deterministic_algorithms(deterministic)


def _remesh(args, device: torch.device, draws) -> list:
    if device.type == "cuda" and args.compute_dtype is None:
        # f32 reference numerics: no TF32 in matmuls or cuDNN convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model, input_n = build_model(args, device)
    dense_fn, sparse_fn, decode_fn, encode_fn = build_eval_fns(args, model)
    # dense_fn is None for ONet: there the coarse+refine path runs and
    # honours --compute_dtype
    if args.compute_dtype is not None and dense_fn is not None:
        print("WARNING: --compute_dtype is a no-op on the ConvONet "
              "dense-lattice path (evaluation precision is set by the "
              "lattice evaluator; use --wire int8 to compact the "
              "transfer instead)")
    if args.wire == "sparse" and (
            sparse_fn is None or args.sample_mode != "direct"):
        raise SystemExit(
            "--wire sparse needs --variant convonet (3-plane latent) "
            "and --sample_mode direct")

    files = (
        [os.path.join(args.data_root, f)
         for f in sorted(os.listdir(args.data_root))
         if os.path.isfile(os.path.join(args.data_root, f))]
        if os.path.isdir(args.data_root) else [args.data_root]
    )
    fns = (dense_fn, decode_fn, encode_fn, sparse_fn)
    saved = []
    for path in files:
        d = load_npz(path)
        t0 = time.perf_counter()
        out = {"test_label": d.test_label}
        if d.target_label is not None:
            out["target_label"] = d.target_label
        stem = os.path.splitext(os.path.basename(path))[0]
        out["test_pc"], fails = defend_clouds(
            model, input_n, d.test_pc[..., :3], args, *fns,
            mesh_tag=os.path.join(stem, "test"), draws=draws)
        n = len(out["test_pc"])
        if args.train:
            out["train_pc"], f2 = defend_clouds(
                model, input_n, d.train_pc[..., :3], args, *fns,
                mesh_tag=os.path.join(stem, "train"), draws=draws)
            out["train_label"] = d.train_label
            n += len(out["train_pc"])
            fails += f2
        dt = time.perf_counter() - t0          # ends in host numpy
        save_path = get_save_name(path, args.variant)
        save_npz(save_path, out)
        MetricsWriter(save_path + ".metrics.jsonl").write(
            variant=f"{args.variant}-mesh", data=path, clouds=n,
            seconds=dt, clouds_per_sec=n / max(dt, 1e-9),
            reconstruction_failures=fails, output=save_path)
        print(f"remesh defense saved to {save_path} "
              f"({n} clouds, {fails} fallbacks, {dt:.1f}s)")
        saved.append(save_path)
    return saved


if __name__ == "__main__":
    main()
