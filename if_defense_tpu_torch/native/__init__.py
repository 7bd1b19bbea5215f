"""Host geometry kernels in C++, loaded with ctypes (the port's copy of
`if_defense_tpu/native/`).

`isosurface.cpp` (marching tetrahedra into an indexed mesh), `sample.cpp`
(fused marching and area-weighted sampling, f32 and int8 grids),
`assemble.cpp` (the fine value grid of the coarse + refine path) and
`simplify.cpp` (QEM simplification) are the JAX package's sources,
unchanged. They run on the host in both packages: occupancy is evaluated
on the device, the isosurface pass turns its value grid into points.

On first use the sources are compiled by `g++` with the JAX build's flags
into `if_defense_tpu_torch/_build/native-<hash>/libgeometry.so`, keyed on
the sources, the flags and the host's CPU (`-march=native` output does not
run everywhere). The build goes to a temporary directory that is renamed
into place, so processes that build at once do not clash. With the same
flags on one host, both packages' libraries return the same bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRCS = tuple(_DIR / f"{n}.cpp"
              for n in ("isosurface", "simplify", "assemble", "sample"))
BUILD = _DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()


def _cpu_model() -> str:
    """The host CPU's model name and feature flags (what `-march=native`
    compiles for)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().splitlines()
    except OSError:
        import platform

        return platform.machine() + platform.processor()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(sorted(set(keep)))


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_model().encode())
    for src in _SRCS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the library where it is missing; its path."""
    out = BUILD / f"native-{_digest()}"
    so = out / "libgeometry.so"
    if so.exists():
        return str(so)
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD, prefix="tmp-native-"))
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp / so.name),
                        *map(str, _SRCS)], check=True)
        try:
            os.replace(tmp, out)
        except OSError:              # another process finished first
            if not so.exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return str(so)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(build()))
    return _lib


def _bind(lib):
    f32p, i64p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)
    lib.mt_extract.restype = ctypes.c_int
    lib.mt_extract.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(f32p), i64p, ctypes.POINTER(i64p), i64p,
    ]
    lib.mt_free.restype = None
    lib.mt_free.argtypes = [ctypes.c_void_p]
    lib.qem_simplify.restype = ctypes.c_int
    lib.qem_simplify.argtypes = [
        f32p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.POINTER(f32p), i64p, ctypes.POINTER(i64p),
        i64p,
    ]
    lib.qem_free.restype = None
    lib.qem_free.argtypes = [ctypes.c_void_p]
    lib.assemble_fine.restype = None
    lib.assemble_fine.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, i64p, f32p, ctypes.c_int64, f32p,
    ]
    lib.assemble_fine_vox.restype = None
    lib.assemble_fine_vox.argtypes = lib.assemble_fine.argtypes
    lib.mt_sample_f32.restype = ctypes.c_int
    lib.mt_sample_f32.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int64, ctypes.c_uint64, f32p, ctypes.POINTER(ctypes.c_double),
    ]
    lib.mt_sample_i8.restype = ctypes.c_int
    lib.mt_sample_i8.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64, ctypes.c_uint64, f32p,
        ctypes.POINTER(ctypes.c_double),
    ]
    return lib


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _grid(volume: np.ndarray, dtype) -> np.ndarray:
    vol = np.ascontiguousarray(volume, dtype)
    if vol.ndim != 3:
        raise ValueError(f"expected a 3-D value grid, got shape {vol.shape}")
    return vol


def _take_mesh(free, vp, nv, tp, nt):
    """Copy a malloc'd (vertices, triangles) pair out, then free it."""
    try:
        verts = (np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy()
                 if nv.value else np.zeros((0, 3), np.float32))
        tris = (np.ctypeslib.as_array(tp, shape=(nt.value, 3)).copy()
                if nt.value else np.zeros((0, 3), np.int64))
    finally:
        free(vp)
        free(tp)
    return verts, tris


def marching_isosurface(volume: np.ndarray, iso: float):
    """Extract the isosurface of a dense value grid.

    Args:
        volume: [nx, ny, nz] float array; "inside" is value > iso.
        iso: isovalue.
    Returns:
        (vertices [V, 3] float32 in grid-index coordinates,
         triangles [T, 3] int64)
    """
    lib = _load()
    vol = _grid(volume, np.float32)
    vp, tp = ctypes.POINTER(ctypes.c_float)(), ctypes.POINTER(ctypes.c_int64)()
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.mt_extract(_f32(vol), *vol.shape, ctypes.c_float(iso),
                        ctypes.byref(vp), ctypes.byref(nv),
                        ctypes.byref(tp), ctypes.byref(nt))
    if rc != 0:
        raise RuntimeError("isosurface extraction failed (alloc)")
    return _take_mesh(lib.mt_free, vp, nv, tp, nt)


def sample_isosurface(volume: np.ndarray, iso: float, n: int,
                      seed: int = 0) -> np.ndarray:
    """Fused marching tetrahedra and area-weighted surface sampling.

    The surface of `marching_isosurface` sampled as `sample_surface` does,
    in one native pass with no indexed mesh (`sample.cpp`). An int8 grid is
    marched in the quantised domain (iso ignored: `quantize_wire_int8`
    puts the isovalue at q == 0).

    Args:
        volume: [nx, ny, nz] float32 logits or int8 quantised logits.
        iso: isovalue (float grids only).
        n: number of samples.
    Returns:
        [n, 3] float32 points in grid-index coordinates.
    Raises:
        ValueError on an empty or degenerate surface (callers fall back,
        as `ONet/remesh_defense.py:159-170` does).
    """
    lib = _load()
    out = np.empty((n, 3), np.float32)
    area = ctypes.c_double()
    if volume.dtype == np.int8:
        vol = _grid(volume, np.int8)
        rc = lib.mt_sample_i8(
            vol.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), *vol.shape,
            n, ctypes.c_uint64(seed), _f32(out), ctypes.byref(area))
    else:
        vol = _grid(volume, np.float32)
        rc = lib.mt_sample_f32(
            _f32(vol), *vol.shape, ctypes.c_float(iso), n,
            ctypes.c_uint64(seed), _f32(out), ctypes.byref(area))
    if rc != 0:
        raise ValueError("empty or degenerate isosurface")
    return out


def simplify_mesh(vertices: np.ndarray, triangles: np.ndarray,
                  target_faces: int, aggressiveness: float = 5.0):
    """Quadric-error-metric simplification toward `target_faces` (the role
    of the reference's `libsimplify.simplify_mesh`).

    Returns:
        (vertices [V', 3] float32, triangles [T', 3] int64)
    """
    lib = _load()
    verts = np.ascontiguousarray(vertices, np.float32)
    tris = np.ascontiguousarray(triangles, np.int64)
    if len(tris) and (tris.min() < 0 or tris.max() >= len(verts)):
        raise ValueError("triangle index out of range")
    vp, tp = ctypes.POINTER(ctypes.c_float)(), ctypes.POINTER(ctypes.c_int64)()
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.qem_simplify(_f32(verts), len(verts), _i64(tris), len(tris),
                          target_faces, ctypes.c_double(aggressiveness),
                          ctypes.byref(vp), ctypes.byref(nv),
                          ctypes.byref(tp), ctypes.byref(nt))
    if rc != 0:
        raise RuntimeError("mesh simplification failed (alloc)")
    return _take_mesh(lib.qem_free, vp, nv, tp, nt)


def assemble_fine_grid(coarse: np.ndarray, upsample: int,
                       flat_idx: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Dense fine grid: the nearest-upsampled coarse grid with refined
    values scattered in.

    Args:
        coarse: [R0+1, R0+1, R0+1] float32 coarse logits (one cloud).
        upsample: fine cells per coarse cell.
        flat_idx: [n] int64 raveled indices into the (R0*u+1)^3 fine grid.
        values: [n] float32 refined logits.
    Returns:
        [Rf+1, Rf+1, Rf+1] float32 fine grid.
    """
    lib = _load()
    coarse = np.ascontiguousarray(coarse, np.float32)
    r0 = coarse.shape[0] - 1
    rf = r0 * upsample + 1
    flat_idx = np.ascontiguousarray(flat_idx, np.int64)
    values = np.ascontiguousarray(values, np.float32)
    if len(flat_idx) != len(values) or (
            len(flat_idx) and (flat_idx.min() < 0
                               or flat_idx.max() >= rf ** 3)):
        raise ValueError("fine-grid indices out of range or unmatched")
    out = np.empty((rf, rf, rf), np.float32)
    lib.assemble_fine(_f32(coarse), r0, upsample, _i64(flat_idx),
                      _f32(values), len(values), _f32(out))
    return out


def assemble_fine_grid_vox(coarse: np.ndarray, upsample: int,
                           vox_ids: np.ndarray,
                           values: np.ndarray) -> np.ndarray:
    """Voxel-addressed fine-grid assembly (no host-side index tensors).

    Args:
        coarse: [R0+1, R0+1, R0+1] float32 coarse logits (one cloud).
        upsample: fine cells per coarse cell.
        vox_ids: [n] int64 flat active coarse-voxel ids (x*R0^2 + y*R0 + z).
        values: [n, (u+1)^3] float32 refined logits in ox-oy-oz offset
            order (meshgrid indexing='ij').
    Returns:
        [Rf+1, Rf+1, Rf+1] float32 fine grid.
    """
    lib = _load()
    coarse = np.ascontiguousarray(coarse, np.float32)
    r0 = coarse.shape[0] - 1
    rf = r0 * upsample + 1
    vox_ids = np.ascontiguousarray(vox_ids, np.int64)
    values = np.ascontiguousarray(values, np.float32)
    if values.shape != (len(vox_ids), (upsample + 1) ** 3) or (
            len(vox_ids) and (vox_ids.min() < 0 or vox_ids.max() >= r0 ** 3)):
        raise ValueError("voxel ids out of range or values misshapen")
    out = np.empty((rf, rf, rf), np.float32)
    lib.assemble_fine_vox(_f32(coarse), r0, upsample, _i64(vox_ids),
                          _f32(values), len(vox_ids), _f32(out))
    return out
