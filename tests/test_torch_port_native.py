"""The port's host geometry library and mesh files against the JAX
package's.

`if_defense_tpu_torch.native` compiles the JAX package's C++ sources with
the same flags (`-O3 -march=native`) into its own build directory, so on
one host both libraries return the same bits: every comparison here is
exact (`np.array_equal`). The inputs are a sphere's signed distance, a
seeded random field (many small surfaces), their int8 quantisation and a
marched mesh. The mesh writers are copies, so the files are byte-equal.
"""

import os

import numpy as np
import pytest

from if_defense_tpu import native as jax_native
from if_defense_tpu.utils import meshio as jax_meshio
from if_defense_tpu_torch import native
from if_defense_tpu_torch.utils import meshio


def _sphere(n=33, radius=0.6):
    g = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    return (radius - np.sqrt(X**2 + Y**2 + Z**2)).astype(np.float32)


def _random_field(n=24, seed=0):
    return np.random.default_rng(seed).normal(size=(n, n, n)).astype(
        np.float32)


def _int8(vol, iso=0.0):
    x = np.clip((vol - iso) * 16.0, -127, 127)
    return np.where(x > 0, np.ceil(x), np.floor(x)).astype(np.int8)


def _equal(a, b):
    return all(np.array_equal(x, y) and x.dtype == y.dtype
               for x, y in zip(a, b))


def test_build_lands_in_the_ports_directory():
    path = native.build()
    assert os.path.basename(os.path.dirname(path)).startswith("native-")
    assert os.path.dirname(os.path.dirname(path)) == str(native.BUILD)
    assert native.build() == path            # cached: no second compile


@pytest.mark.parametrize("field", ["sphere", "random"])
def test_marching_isosurface_bit_equal(field):
    vol = _sphere() if field == "sphere" else _random_field()
    iso = 0.0 if field == "sphere" else 0.3
    got = native.marching_isosurface(vol, iso)
    want = jax_native.marching_isosurface(vol, iso)
    assert len(got[1]) > 100
    assert _equal(got, want)


@pytest.mark.parametrize("field", ["sphere", "random"])
def test_sample_isosurface_bit_equal(field):
    vol = _sphere() if field == "sphere" else _random_field(seed=1)
    for seed in (0, 7):
        got = native.sample_isosurface(vol, 0.1, 500, seed)
        assert np.array_equal(got, jax_native.sample_isosurface(
            vol, 0.1, 500, seed))
        q = _int8(vol, 0.1)
        got8 = native.sample_isosurface(q, 0.1, 500, seed)
        assert np.array_equal(got8, jax_native.sample_isosurface(
            q, 0.1, 500, seed))
        assert got8.shape == (500, 3) and np.isfinite(got8).all()


def test_degenerate_surface_raises_in_both():
    empty = np.full((9, 9, 9), -5.0, np.float32)
    for lib in (native, jax_native):
        with pytest.raises(ValueError):
            lib.sample_isosurface(empty, 0.0, 16, 0)
        with pytest.raises(ValueError):
            lib.sample_isosurface(_int8(empty), 0.0, 16, 0)
    v, t = native.marching_isosurface(empty, 0.0)
    assert v.shape == (0, 3) and t.shape == (0, 3)


def test_simplify_mesh_bit_equal():
    verts, tris = native.marching_isosurface(_sphere(), 0.0)
    got = native.simplify_mesh(verts, tris, len(tris) // 6)
    want = jax_native.simplify_mesh(verts, tris, len(tris) // 6)
    assert len(got[1]) <= len(tris) // 4
    assert _equal(got, want)


def test_assemble_fine_grid_bit_equal():
    rng = np.random.default_rng(3)
    r0, u = 6, 3
    coarse = rng.normal(size=(r0 + 1,) * 3).astype(np.float32)
    rf = r0 * u + 1
    flat = rng.choice(rf**3, 200, replace=False).astype(np.int64)
    vals = rng.normal(size=200).astype(np.float32)
    got = native.assemble_fine_grid(coarse, u, flat, vals)
    assert np.array_equal(got, jax_native.assemble_fine_grid(
        coarse, u, flat, vals))
    vox = rng.choice(r0**3, 20, replace=False).astype(np.int64)
    vv = rng.normal(size=(20, (u + 1) ** 3)).astype(np.float32)
    got = native.assemble_fine_grid_vox(coarse, u, vox, vv)
    assert np.array_equal(got, jax_native.assemble_fine_grid_vox(
        coarse, u, vox, vv))
    with pytest.raises(ValueError):
        native.assemble_fine_grid_vox(coarse, u, vox + r0**3, vv)


MESH_V = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1.5]], np.float32)
MESH_T = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int64)


@pytest.mark.parametrize("fmt", ["off", "obj", "ply"])
def test_mesh_files_byte_equal_and_round_trip(fmt, tmp_path):
    verts, tris = native.marching_isosurface(_sphere(17), 0.0)
    for v, t in ((MESH_V, MESH_T), (verts, tris)):
        mine, theirs = tmp_path / f"a.{fmt}", tmp_path / f"b.{fmt}"
        meshio.export_mesh(str(mine), v, t)
        jax_meshio.export_mesh(str(theirs), v, t)
        assert mine.read_bytes() == theirs.read_bytes()
        if fmt == "ply":
            continue
        load = meshio.load_off if fmt == "off" else meshio.load_obj
        lv, lt = load(str(mine))
        np.testing.assert_allclose(lv, v, atol=1e-6)
        np.testing.assert_array_equal(lt, t)
    with pytest.raises(ValueError, match="unsupported mesh extension"):
        meshio.export_mesh(str(tmp_path / "m.stl"), MESH_V, MESH_T)
