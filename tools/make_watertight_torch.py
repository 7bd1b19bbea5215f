"""Make watertight meshes from raw (possibly broken) meshes, on the port's
host geometry library.

The port of `tools/make_watertight.py`: the same steps, with the
isosurface from `if_defense_tpu_torch.native.marching_isosurface` (the
same C++ source, built by the port's loader). Role of
`ONet/data_proc/make_watertight.py`, which shells out to the external
Manifold binary and cleans small components with trimesh. This
tool is self-contained: voxelise each mesh's occupancy on a dense grid
(+z ray-crossing parity), re-extract the surface with the native marching-
tetrahedra kernel (watertight by construction), and drop small connected
components (the reference's `postprocess_mesh`, faces < total/100).

Usage:
    python tools/make_watertight_torch.py --mesh_root MN40_off \
        --out_root MN40_watertight [--resolution 128]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from if_defense_tpu_torch.native import marching_isosurface  # noqa: E402
from tools.build_occupancy_dataset import (  # noqa: E402
    load_off,
    normalize_mesh,
    occupancy_ray_parity,
)


def save_off(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "w") as f:
        f.write(f"OFF\n{len(verts)} {len(faces)} 0\n")
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in faces:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def connected_components(faces: np.ndarray) -> np.ndarray:
    """Component id per face (union-find over shared edges)."""
    parent = {}

    def find(a):
        root = a
        while parent.get(root, root) != root:
            root = parent[root]
        while parent.get(a, a) != a:
            parent[a], a = root, parent[a]
        return root

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    edge_owner = {}
    for fi, t in enumerate(faces):
        for a, b in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            key = (min(a, b), max(a, b))
            if key in edge_owner:
                union(fi, edge_owner[key])
            else:
                edge_owner[key] = fi
    return np.array([find(fi) for fi in range(len(faces))])


def drop_small_components(verts, faces, min_frac: float = 0.01):
    """Remove components with fewer than min_frac * total faces
    (`make_watertight.py:14-33` semantics)."""
    if len(faces) == 0:
        return verts, faces
    comp = connected_components(faces)
    ids, counts = np.unique(comp, return_counts=True)
    keep_ids = set(ids[counts >= max(int(len(faces) * min_frac), 1)])
    keep = np.array([c in keep_ids for c in comp])
    faces = faces[keep]
    used = np.unique(faces)
    remap = -np.ones(len(verts), np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces]


def watertight_remesh(verts: np.ndarray, faces: np.ndarray,
                      resolution: int = 128):
    """Voxel-occupancy remesh: watertight by construction."""
    verts = normalize_mesh(verts)
    g = np.linspace(-0.55, 0.55, resolution + 1).astype(np.float32)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    queries = np.stack([X, Y, Z], -1).reshape(-1, 3)
    occ = occupancy_ray_parity(verts, faces, queries, grid=64)
    vol = np.where(occ, 1.0, -1.0).reshape(
        resolution + 1, resolution + 1, resolution + 1).astype(np.float32)
    vol = np.pad(vol, 1, constant_values=-1.0)
    v, t = marching_isosurface(vol, 0.0)
    v = (v - 1.0) / resolution - 0.5
    v = v * 1.1  # undo the padded box
    return drop_small_components(v.astype(np.float32), t)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mesh_root", required=True,
                   help="root dir of OFF meshes (class subdirs)")
    p.add_argument("--out_root", required=True)
    p.add_argument("--resolution", type=int, default=128)
    args = p.parse_args(argv)

    count_bad = 0
    for cls in sorted(os.listdir(args.mesh_root)):
        croot = os.path.join(args.mesh_root, cls)
        if not os.path.isdir(croot):
            continue
        out_c = os.path.join(args.out_root, cls)
        os.makedirs(out_c, exist_ok=True)
        for fname in sorted(os.listdir(croot)):
            if not fname.endswith(".off"):
                continue
            try:
                verts, faces = load_off(os.path.join(croot, fname))
                v, t = watertight_remesh(verts, faces, args.resolution)
                if len(t) == 0:
                    raise ValueError("empty remesh")
                save_off(os.path.join(out_c, fname), v, t)
            except Exception as e:  # noqa: BLE001 — skip & count like ref
                print(f"failed {cls}/{fname}: {e}")
                count_bad += 1
    print(f"done; {count_bad} meshes failed")
    return count_bad


if __name__ == "__main__":
    main()
