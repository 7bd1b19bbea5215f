"""Mesh file export and import (.off / .obj / .ply), a copy of
`if_defense_tpu/utils/meshio.py`.

The reference's mesh writers (`ONet/im2mesh/utils/libmcubes/exporter.py:1-63`,
and `remesh_defense.py`'s trimesh objects), used by `--save_mesh` of the
ONet-Mesh / ConvONet-Mesh defense. Host-side numpy text and binary IO.
"""

from __future__ import annotations

import os

import numpy as np


def export_off(path: str, vertices: np.ndarray, triangles: np.ndarray):
    """Write an OFF file (the reference exporter's default format)."""
    vertices = np.asarray(vertices, np.float32)
    triangles = np.asarray(triangles, np.int64)
    with open(path, "w") as f:
        f.write("OFF\n")
        f.write(f"{len(vertices)} {len(triangles)} 0\n")
        np.savetxt(f, vertices, fmt="%.6f")
        np.savetxt(
            f, np.concatenate(
                [np.full((len(triangles), 1), 3), triangles], axis=1),
            fmt="%d")


def export_obj(path: str, vertices: np.ndarray, triangles: np.ndarray):
    """Write a Wavefront OBJ file (1-indexed faces)."""
    vertices = np.asarray(vertices, np.float32)
    triangles = np.asarray(triangles, np.int64)
    with open(path, "w") as f:
        np.savetxt(f, vertices, fmt="v %.6f %.6f %.6f")
        np.savetxt(f, triangles + 1, fmt="f %d %d %d")


def export_ply(path: str, vertices: np.ndarray, triangles: np.ndarray):
    """Write a binary little-endian PLY file (compact for big meshes)."""
    vertices = np.ascontiguousarray(vertices, np.float32)
    triangles = np.asarray(triangles)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(vertices)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(triangles)}\n"
        "property list uchar int vertex_indices\nend_header\n")
    face_dt = np.dtype([("n", np.uint8), ("idx", "<i4", (3,))])
    faces = np.empty(len(triangles), face_dt)
    faces["n"] = 3
    faces["idx"] = triangles
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(vertices.astype("<f4").tobytes())
        f.write(faces.tobytes())


_EXPORTERS = {".off": export_off, ".obj": export_obj, ".ply": export_ply}


def export_mesh(path: str, vertices: np.ndarray, triangles: np.ndarray):
    """Dispatch on file extension (.off / .obj / .ply)."""
    ext = os.path.splitext(path)[1].lower()
    try:
        writer = _EXPORTERS[ext]
    except KeyError:
        raise ValueError(
            f"unsupported mesh extension {ext!r}; use one of "
            f"{sorted(_EXPORTERS)}") from None
    writer(path, vertices, triangles)


def load_off(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read an OFF file back into (vertices [V,3] f32, triangles [T,3])."""
    with open(path) as f:
        tokens = f.read().split()
    if tokens[0] != "OFF":
        raise ValueError(f"{path} is not an OFF file")
    nv, nt = int(tokens[1]), int(tokens[2])
    data = np.asarray(tokens[4:], dtype=np.float64)
    verts = data[: nv * 3].reshape(nv, 3).astype(np.float32)
    faces = data[nv * 3: nv * 3 + nt * 4].reshape(nt, 4).astype(np.int64)
    if not (faces[:, 0] == 3).all():
        raise ValueError("only triangle meshes are supported")
    return verts, faces[:, 1:]


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a (triangle-only) OBJ back into (vertices, triangles)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                faces.append([int(p.split("/")[0]) - 1
                              for p in parts[1:4]])
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int64).reshape(-1, 3))
