"""Mesh generation (`implicit/generation.py` and ConvONet's lattice
methods), PyTorch port vs JAX package, on the CPU.

Both packages run the same perturbed flax-layout weights (ConvONet c_dim/hidden 8
with 16x16 planes, ONet c_dim/hidden 32 and decoder 16 on its running
statistics), B = 2 clouds, resolution0 8, upsample 2 or 4. Tolerances:
- logits (planes, lattice, dense lattice, coarse grid) within 1e-5 of the
  largest magnitude: f32 on both sides, sums in other orders;
- binary decisions (active scores, top-k indices, int8 quantisation) equal
  exactly, but int8 entries whose f32 value lies within 1e-5 of a quantum
  boundary, which are counted (here none at these seeds);
- bf16-wire grids within one bf16 step (2^-7 relative) and >= 99 %
  within the logits' tolerance: a 1e-6 difference in f32 can round the
  other way;
- host geometry (marching, sampling) on one grid bit-equal;
- normals at cosine >= 0.9999; `refine_mesh` vertices within 1e-4, on
  JAX's Dirichlet draws fed through the `dirichlet` seam.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from if_defense_tpu.implicit import ConvOccupancyNetwork as JaxConvONet
from if_defense_tpu.implicit import OccupancyNetwork as JaxONet
from if_defense_tpu.implicit import convonet as jax_convonet
from if_defense_tpu.implicit import generation as jg
from if_defense_tpu_torch.implicit import (
    ConvOccupancyNetwork,
    OccupancyNetwork,
    convonet,
)
from if_defense_tpu_torch.implicit import generation as tg
from if_defense_tpu_torch.utils.params_io import (
    flatten_params,
    flax_init_params,
    params_from_jax,
    unflatten_params,
)

C, RES, B, R0 = 8, 16, 2, 8
LOGIT_TOL, BOUNDARY_TOL, COS = 1e-5, 1e-5, 0.9999
BOX = 1.0 + jg.DEFAULT_PADDING


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """torch's CPU ops in one thread (ROADMAP.md section C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=2)
def _setup(variant: str):
    """(JAX model, variables, JAX latent, port model, port latent) for B
    clouds, every weight perturbed off flax's init, and the output bias
    moved so that the median of each cloud's coarse grid sits at the iso
    value (the field has a surface)."""
    rng = np.random.default_rng(0 if variant == "convonet" else 1)
    pc = rng.uniform(-0.4, 0.4, (B, 64, 3)).astype(np.float32)
    pc[1] *= np.array([1.0, 0.6, 0.8], np.float32)
    jm = JaxConvONet(C, C, RES) if variant == "convonet" else \
        JaxONet(32, 32, 16)
    # flax's init distributions drawn with numpy (a JAX init of the UNet
    # takes half a minute op by op)
    flat = flatten_params(
        flax_init_params(0, "convonet", c_dim=C, hidden_dim=C)
        if variant == "convonet" else
        flax_init_params(0, "onet", c_dim=32, hidden_dim=32,
                         decoder_hidden=16))
    flat = {k: (v * np.exp(0.2 * rng.normal(size=v.shape)) if k.endswith("/var")
                else v + (0.3 / np.sqrt(np.prod(v.shape[:-1])) if v.ndim > 1
                          else 0.05) * rng.normal(size=v.shape)
                ).astype(np.float32)
            for k, v in flat.items()}
    jc = jm.apply(unflatten_params(flat), jnp.asarray(pc),
                  method="encode_inputs")
    grid = jnp.asarray(jg.make_grid(R0, BOX).reshape(1, -1, 3))
    vals = np.asarray(jm.apply(unflatten_params(flat),
                               jnp.broadcast_to(grid, (B,) + grid.shape[1:]),
                               jc, method="decode"))
    flat["params/decoder/fc_out/bias"] += np.float32(
        tg.logit_threshold(0.2) - np.median(vals))
    variables = unflatten_params(flat)
    tm = ConvOccupancyNetwork(C, C, RES) if variant == "convonet" else \
        OccupancyNetwork(32, 32, 16)
    tm.load_state_dict(params_from_jax(variables, tm))
    tm.eval().requires_grad_(False)
    jc = jm.apply(variables, jnp.asarray(pc), method="encode_inputs")
    with torch.no_grad():
        tc = tm.encode_inputs(torch.from_numpy(pc))
    return jm, variables, jc, tm, tc


def _jax_decode(jm):
    return lambda v, p, c: jm.apply(v, p, c, method="decode")


def _decode(m, p, c):
    return m.decode(p, c)


def _near(got, want, scale):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert err.max() <= LOGIT_TOL * scale, (err.max(), scale)


def _int8_equal_but_boundary(got, want, f32):
    """int8 grids equal but where the JAX f32 value sits within
    BOUNDARY_TOL (in logits) of a quantum boundary; -> (entries that
    differ, entries at a boundary)."""
    x = (np.asarray(f32, np.float64) - tg.logit_threshold(0.2)) * 16.0
    boundary = np.abs(x - np.round(x)) <= BOUNDARY_TOL * 16.0
    diff = got != want
    assert not (diff & ~boundary).any(), int((diff & ~boundary).sum())
    return int(diff.sum()), int(boundary.sum())


def _bf16_close(got, want):
    """Every entry within one bf16 step; >= 99 % also within LOGIT_TOL of
    the largest (ONet's bf16 wire keeps the coarse grid in f32)."""
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)
    assert (err <= np.maximum(np.abs(want), 1e-30) * 2.0**-7).all()
    near = err <= LOGIT_TOL * np.abs(want).max()
    assert near.mean() >= 0.99, near.mean()


@pytest.mark.parametrize("args", [(16, 1.1, 16, 0.1), (128, 1.1, 64, 0.1),
                                  (9, 1.3, 7, 0.05)])
def test_lattice_axis_selector_equal(args):
    np.testing.assert_array_equal(convonet.lattice_axis_selector(*args),
                                  jax_convonet.lattice_axis_selector(*args))


@pytest.mark.parametrize("rf", [8, 16])
def test_lattice_methods_match_jax(rf):
    jm, v, jc, tm, tc = _setup("convonet")
    want_lat = jm.apply(v, jc, rf, BOX, method="lattice_planes")
    want = np.asarray(jm.apply(v, jc, rf, BOX, method="dense_lattice_logits"))
    scale = np.abs(want).max()
    fidx = np.random.default_rng(rf).integers(0, rf + 1, (B, 300, 3))
    want_dl = jm.apply(v, jnp.asarray(fidx, jnp.int32), want_lat, rf, BOX,
                       method="decode_lattice")
    with torch.no_grad():
        lat = tm.lattice_planes(tc, rf, BOX)
        for pl in lat:
            _near(lat[pl].numpy(), want_lat[pl],
                  np.abs(np.asarray(want_lat[pl])).max())
        got = tm.dense_lattice_logits(tc, rf, BOX).numpy()
        dl = tm.decode_lattice(torch.from_numpy(fidx), lat, rf, BOX).numpy()
        exact = tm.decode((torch.from_numpy(fidx).float() / rf - 0.5) * BOX,
                          tc).numpy()
    assert got.shape == (B, rf + 1, rf + 1, rf + 1)
    _near(got, want, scale)
    _near(dl, want_dl, scale)
    # the port's lattice paths equal its own exact decode at lattice points
    _near(dl, exact, scale)
    _near(got[np.arange(B)[:, None], fidx[..., 0], fidx[..., 1], fidx[..., 2]],
          exact, scale)


def _coarse(variant):
    """The coarse grid, [B, R0+1]^3, of each package (numpy)."""
    jm, v, jc, tm, tc = _setup(variant)
    grid = jg.make_grid(R0, BOX).reshape(1, -1, 3)
    want = np.asarray(jg.eval_points_batched(
        _jax_decode(jm), v, jc, jnp.broadcast_to(grid, (B,) + grid.shape[1:]),
        chunk=256)).reshape((B,) + (R0 + 1,) * 3)
    got = tg.eval_points_batched(
        _decode, tm, tc, torch.from_numpy(grid).expand(B, -1, 3),
        chunk=300).numpy().reshape(want.shape)
    return got, want


@pytest.mark.parametrize("variant", ["convonet", "onet"])
def test_active_voxels_and_topk_match_jax(variant):
    got_c, want_c = _coarse(variant)
    _near(got_c, want_c, np.abs(want_c).max())
    iso = tg.logit_threshold(0.2)
    assert np.abs(want_c - iso).min() > 1e-5   # no sign at a near tie
    flat, counts = tg._active_scores(torch.from_numpy(want_c.copy()), iso,
                                    r0=R0)
    jflat, jcounts = jg._active_scores(jnp.asarray(want_c),
                                       jnp.float32(iso), r0=R0)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    need = int(counts.max())
    assert 8 < need <= R0**3
    # budgets that clip (ties among the 2s and 1s decide) and one that does
    # not; the scores are 0, 1, 2 only, so ties are the rule
    for k in (need // 3, need - 1, 256 if need <= 256 else need):
        idx, act = tg._topk_active(flat, k)
        jidx, jact = jg._topk_active(jflat, k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(act.numpy(), np.asarray(jact))


def test_quantize_wire_int8_bit_equal():
    iso = tg.logit_threshold(0.2)
    rng = np.random.default_rng(4)
    q = np.arange(-140, 141) / 16.0 + iso              # on the boundaries
    vals = np.concatenate([
        rng.normal(size=5000) * 4 + iso, q, np.nextafter(q, 99),
        np.nextafter(q, -99), [iso, 100.0, -100.0]]).astype(np.float32)
    got = tg.quantize_wire_int8(torch.from_numpy(vals), iso).numpy()
    want = np.asarray(jg.quantize_wire_int8(jnp.asarray(vals), iso))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int8
    assert (np.sign(got) == np.sign(vals - np.float32(iso))).all()
    np.testing.assert_array_equal(tg.dequantize_wire_int8(got, iso),
                                  jg.dequantize_wire_int8(want, iso))


@pytest.mark.parametrize("variant,wire,upsample", [
    ("convonet", "bf16", 2), ("convonet", "int8", 4),
    ("onet", "bf16", 2), ("onet", "int8", 4)])
def test_compute_value_grids_match_jax(variant, wire, upsample):
    jm, v, jc, tm, tc = _setup(variant)
    rf = R0 * upsample
    kw = dict(resolution0=R0, upsample=upsample, wire=wire, chunk=512)
    if variant == "convonet":
        jdense = jg.make_convonet_dense_eval(jm, rf, BOX)
        f32 = np.asarray(jdense(v, jc))
        want, iso = jg.compute_value_grids(None, v, jc, dense_eval_fn=jdense,
                                           **kw)
        got, _ = tg.compute_value_grids(
            None, tm, tc, dense_eval_fn=tg.make_convonet_dense_eval(
                tm, rf, BOX), **kw)
    else:
        want, iso = jg.compute_value_grids(_jax_decode(jm), v, jc, **kw)
        got, _ = tg.compute_value_grids(_decode, tm, tc, **kw)
        f32 = _jax_f32_fine(upsample)
    assert got.shape == want.shape == (B,) + (rf + 1,) * 3
    if wire == "int8":
        if variant == "onet":              # dequantised on the host
            got, want = (np.round((g - iso) * 16) for g in (got, want))
        n, near = _int8_equal_but_boundary(got, want, f32)
        print(f"{variant}: {n} int8 entries differ, of {near} within "
              f"{BOUNDARY_TOL} of a quantum boundary")
    else:
        _bf16_close(got, want)


def test_convonet_refinement_through_the_lattice_evaluator():
    """ConvONet's coarse + refine path with the lattice evaluator
    (`make_convonet_lattice_eval`), bf16 wire, against JAX's."""
    jm, v, jc, tm, tc = _setup("convonet")
    rf = R0 * 2
    kw = dict(resolution0=R0, upsample=2, chunk=512)
    want, _ = jg.compute_value_grids(
        _jax_decode(jm), v, jc,
        lattice_eval_fn=jg.make_convonet_lattice_eval(jm, rf, BOX, 100),
        **kw)
    got, _ = tg.compute_value_grids(
        _decode, tm, tc,
        lattice_eval_fn=tg.make_convonet_lattice_eval(tm, rf, BOX, 100),
        **kw)
    _bf16_close(got, want)


def test_compute_value_grids_bf16_compute_close():
    """--compute_dtype bfloat16 on ONet: the model copy, the latent and the
    queries in bf16 on both sides; the grids agree in sign but near the
    surface (|logit - iso| > 0.05) and within 0.05 of the largest logit."""
    jm, v, jc, tm, tc = _setup("onet")
    kw = dict(resolution0=R0, upsample=2, chunk=512,
              compute_dtype="bfloat16")
    want, iso = jg.compute_value_grids(_jax_decode(jm), v, jc, **kw)
    got, _ = tg.compute_value_grids(_decode, tm, tc, **kw)
    assert next(tm.parameters()).dtype == torch.float32   # copy cast
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()
    far = np.abs(want - iso) > 0.05
    assert ((got > iso) == (want > iso))[far].all()


def _jax_f32_fine(upsample):
    """JAX's ONet fine grid before the wire: its coarse grid and refined
    values in f32, assembled as `active_voxel_refinement` does."""
    from if_defense_tpu.native import assemble_fine_grid_vox

    jm, v, jc, _, _ = _setup("onet")
    coarse = _coarse("onet")[1]
    flat, counts = jg._active_scores(jnp.asarray(coarse),
                                     jnp.float32(tg.logit_threshold(0.2)),
                                     r0=R0)
    need = int(counts.max())
    k = min(R0**3, max(256, 1 << max(need - 1, 0).bit_length()))
    idx, act = (np.asarray(a) for a in jg._topk_active(flat, k))
    pts = jg._fine_points(jnp.asarray(idx), r0=R0, u=upsample, box_size=BOX)
    vals = np.asarray(jg.eval_points_batched(_jax_decode(jm), v, jc, pts,
                                             512)).reshape(B, k, -1)
    return np.stack([assemble_fine_grid_vox(coarse[b], upsample,
                                            idx[b][act[b]], vals[b][act[b]])
                     for b in range(B)])


def _sparse(tm, tc, rf, **kw):
    fn = tg.make_convonet_sparse_eval(tm, rf, BOX, 0.2, block=4, **kw)
    return fn, {k: x.numpy() for k, x in fn(tm, tc).items()}


def test_sparse_wire_matches_dense_int8():
    """The port's sparse blocks rebuild its own dense int8 grid's signs and
    samples exactly, and its blocks and ids equal JAX's, also under a
    budget that clips."""
    jm, v, jc, tm, tc = _setup("convonet")
    rf, iso = 16, tg.logit_threshold(0.2)
    q_dense = tg.compute_value_grids(
        None, tm, tc, resolution0=4, upsample=4, wire="int8",
        dense_eval_fn=tg.make_convonet_dense_eval(tm, rf, BOX))[0]
    fn, out = _sparse(tm, tc, rf, max_blocks=128, auto_demote=False)
    jfn = jg.make_convonet_sparse_eval(jm, rf, BOX, 0.2, block=4,
                                       max_blocks=128, auto_demote=False)
    jout = {k: np.asarray(x) for k, x in jfn(v, jc).items()}
    assert fn.sparse_meta == jfn.sparse_meta
    for k in ("idx", "inside", "n_need"):
        np.testing.assert_array_equal(out[k], jout[k])
    valid = out["idx"] >= 0
    np.testing.assert_array_equal(out["blocks"][valid], jout["blocks"][valid])
    # a budget that clips: block scores are 0 or 1, so ties pick the blocks
    cap = int(out["n_need"].max()) // 2
    _, clipped = _sparse(tm, tc, rf, max_blocks=cap, auto_demote=False)
    jclipped = jg.make_convonet_sparse_eval(jm, rf, BOX, 0.2, block=4,
                                            max_blocks=cap,
                                            auto_demote=False)(v, jc)
    assert clipped["idx"].shape[1] == cap
    np.testing.assert_array_equal(clipped["idx"], np.asarray(jclipped["idx"]))
    np.testing.assert_array_equal(clipped["blocks"],
                                  np.asarray(jclipped["blocks"]))
    meta = fn.sparse_meta
    crossings = 0
    for b in range(B):
        vol = tg.assemble_sparse_grid(out, b, block=4, nb=meta["nb"],
                                      rp=meta["rp"])
        np.testing.assert_array_equal(vol > 0, q_dense[b] > 0)
        try:
            s_dense = tg.sample_value_grid(q_dense[b], iso, BOX, 256, seed=b)
        except ValueError:
            continue
        crossings += 1
        np.testing.assert_array_equal(
            tg.sample_value_grid(vol, iso, BOX, 256, seed=b), s_dense)
    assert crossings > 0


def test_sparse_wire_bucket_cap_and_demotion():
    """The adaptive budget fits the need; a cap below it raises in
    `assemble_sparse_grid`; an active-everywhere field demotes to the dense
    int8 grid (as in tests/test_generation.py)."""
    _, _, _, tm, tc = _setup("convonet")
    rf = 16
    fn, out = _sparse(tm, tc, rf, auto_demote=False)
    need, m = int(out["n_need"].max()), out["blocks"].shape[1]
    assert 1 < need <= m <= fn.sparse_meta["nb"] ** 3
    assert m <= max(64, 2 * need)
    _, capped = _sparse(tm, tc, rf, max_blocks=need - 1, auto_demote=False)
    worst = int(np.argmax(capped["n_need"]))
    with pytest.raises(RuntimeError, match="sparse wire clipped"):
        tg.assemble_sparse_grid(capped, worst, block=4, nb=5, rp=17)
    q_dense = tg.compute_value_grids(
        None, tm, tc, resolution0=4, upsample=4, wire="int8",
        dense_eval_fn=tg.make_convonet_dense_eval(tm, rf, BOX))[0]
    demoted = _sparse(tm, tc, rf)[1]
    if "dense" in demoted:
        np.testing.assert_array_equal(demoted["dense"], q_dense)
    else:                    # compact enough that sparse still wins
        assert demoted["blocks"].shape[1] * 64 + 125 < 17**3


def _sphere_grid(n=17, radius=0.33):
    g = (np.arange(n) / (n - 1) - 0.5) * BOX
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    return (20.0 * (radius - np.sqrt(X**2 + Y**2 + Z**2))).astype(np.float32)


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_meshes_and_samples_bit_equal_on_one_grid(wire):
    """On one value grid the port's host half (wire, marching, simplify,
    fused sampling) gives JAX's bits."""
    vol = np.stack([_sphere_grid(), _sphere_grid(radius=0.25)])
    want = jg.generate_meshes(None, None, jnp.zeros((2, 1)), resolution0=4,
                              upsample=4, wire=wire, simplify_nfaces=300,
                              dense_eval_fn=lambda v, c: jnp.asarray(vol))
    got = tg.generate_meshes(None, None, torch.zeros(2, 1), resolution0=4,
                             upsample=4, wire=wire, simplify_nfaces=300,
                             dense_eval_fn=lambda m, c: torch.from_numpy(vol))
    for (gv, gt), (wv, wt) in zip(got, want):
        assert len(gt) and np.array_equal(gt, wt)
        np.testing.assert_array_equal(gv, wv)
    iso = tg.logit_threshold(0.2)
    for grid in (vol[0], tg.quantize_wire_int8(torch.from_numpy(vol[0]),
                                               iso).numpy()):
        np.testing.assert_array_equal(
            tg.sample_value_grid(grid, iso, BOX, 500, seed=3),
            jg.sample_value_grid(grid, iso, BOX, 500, seed=3))
        for a, b in zip(tg.mesh_from_value_grid(grid, iso, BOX),
                        jg.mesh_from_value_grid(grid, iso, BOX)):
            np.testing.assert_array_equal(a, b)


def test_sample_surface_bit_equal():
    verts, tris = tg.generate_meshes(
        None, None, torch.zeros(1, 1), resolution0=4, upsample=4,
        dense_eval_fn=lambda m, c: torch.from_numpy(_sphere_grid()[None]))[0]
    got = tg.sample_surface(verts, tris, 700, np.random.default_rng(5))
    want = jg.sample_surface(verts, tris, 700, np.random.default_rng(5))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tg.sample_surface(verts, tris[:0], 10, np.random.default_rng(0))


def _one_cloud(variant):
    jm, v, jc, tm, tc = _setup(variant)
    if variant == "convonet":
        return jm, v, {k: x[:1] for k, x in jc.items()}, tm, \
            {k: x[:1] for k, x in tc.items()}
    return jm, v, jc[:1], tm, tc[:1]


def _mesh(variant):
    jm, v, jc, tm, tc = _one_cloud(variant)
    verts, tris = tg.generate_meshes(_decode, tm, tc, resolution0=R0,
                                     upsample=2)[0]
    assert len(tris) > 20
    return verts, tris


@pytest.mark.parametrize("variant", ["convonet", "onet"])
def test_estimate_normals_match_jax(variant):
    jm, v, jc, tm, tc = _one_cloud(variant)
    verts, _ = _mesh(variant)
    got = tg.estimate_normals(_decode, tm, tc, verts, chunk=100)
    want = jg.estimate_normals(_jax_decode(jm), v, jc, verts, chunk=128)
    assert got.shape == verts.shape
    assert (np.sum(got * want, -1) >= COS).all()


def test_refine_mesh_matches_jax_on_its_draws():
    """On a mesh without zero-area faces: JAX's `jnp.linalg.norm` has a NaN
    gradient at 0, so one such face turns every JAX vertex NaN (torch takes
    the subgradient 0)."""
    jm, v, jc, tm, tc = _one_cloud("convonet")
    verts, tris = _mesh("convonet")
    e = np.cross(verts[tris[:, 1]] - verts[tris[:, 0]],
                 verts[tris[:, 2]] - verts[tris[:, 1]])
    tris = tris[np.linalg.norm(e, axis=1) > 1e-8]
    steps, seed = 6, 3
    want = jg.refine_mesh(_jax_decode(jm), v, jc, verts, tris, steps=steps,
                          seed=seed)
    keys = jax.random.split(jax.random.key(seed), steps)
    draws = np.stack([np.asarray(jax.random.dirichlet(
        k, jnp.full((3,), 0.5), (len(tris),))) for k in keys])
    got = tg.refine_mesh(_decode, tm, tc, verts, tris, steps=steps,
                         dirichlet=draws)
    assert np.abs(want - verts).max() > 1e-4           # the vertices moved
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # default draws: numpy's, seeded
    again = tg.refine_mesh(_decode, tm, tc, verts, tris, steps=2, seed=1)
    np.testing.assert_array_equal(again, tg.refine_mesh(
        _decode, tm, tc, verts, tris, steps=2, seed=1))


def test_generate_mesh_sliding_matches_jax():
    """Toy crop callables (a box of half-width 0.3 about the input crop's
    centre, exact in f32): the stitched mesh equals JAX's."""
    pc = np.random.default_rng(6).uniform(-0.9, 0.9, (200, 3)).astype(
        np.float32)

    def enc_j(v, p, vol):
        return jnp.asarray(vol.mean(0))

    def dec_j(v, q, c, vol):
        return 0.3 - jnp.max(jnp.abs(q - c), -1)

    def enc_t(m, p, vol):
        return torch.from_numpy(vol.mean(0))

    def dec_t(m, q, c, vol):
        return 0.3 - (q - c).abs().amax(-1)

    kw = dict(resolution0=4, upsample=2, threshold=0.5, chunk=100)
    want = jg.generate_mesh_sliding(enc_j, dec_j, None, pc, **kw)
    got = tg.generate_mesh_sliding(enc_t, dec_t, None, pc, **kw)
    assert len(got[1]) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
