"""The grid ConvONet and the rest of ConvONet's library, PyTorch port vs
JAX package, on the CPU.

Inputs come from numpy seeds; weights from `flax_init_params` (flax's init
distributions drawn with numpy: a JAX init of a 3D UNet takes about 20 s
op by op), or from the port module's own init through `params_to_jax`,
with every tensor perturbed, loaded into the port through
`params_from_jax`. Sizes are small: c_dim/hidden 8, an 8^3 grid, 8x8
planes, UNet3D depth 2 alone and 3 inside the JAX model (its fixed depth),
B = 2.

Tolerances: `trilinear_grid_sample` and its gradients atol 1e-6 on values
and gradients of order 1 (f32, an explicit 8-corner lerp against JAX's
three contractions: sums of a few terms in other orders); the cell maps
exact;
networks rtol 1e-5 with atol 1e-5 of the largest magnitude, 1e-4 where a
3D UNet is in the way (27-tap convolutions summed in other orders); the
slice as a whole as in `test_torch_port_defense.py` and
`test_torch_port_generation.py`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from if_defense_tpu.defense.ifdefense import convonet_opt_defense as jax_defense
from if_defense_tpu.implicit import ConvOccupancyNetwork as JaxConvONet
from if_defense_tpu.implicit import convonet as jcv
from if_defense_tpu.implicit import generation as jg
from if_defense_tpu.implicit.unet3d import UNet3D as JaxUNet3D
from if_defense_tpu.ops import interp as jinterp
from if_defense_tpu.ops import scatter as jscatter
from if_defense_tpu_torch.defense.ifdefense import convonet_opt_defense
from if_defense_tpu_torch.implicit import (
    ConvOccupancyNetwork,
    LocalPoolPointnet,
    PatchLocalPoolPointnet,
    UNet3D,
)
from if_defense_tpu_torch.implicit import convonet as tcv
from if_defense_tpu_torch.implicit import generation as tg
from if_defense_tpu_torch.implicit.training import init_occupancy_model
from if_defense_tpu_torch.ops import interp as tinterp
from if_defense_tpu_torch.ops import scatter as tscatter
from if_defense_tpu_torch.utils.params_io import (
    flatten_params,
    flax_init_params,
    params_from_jax,
    params_to_jax,
    unflatten_params,
)

C, RES, RG, B = 8, 8, 8, 2
GRID = ("grid",)
MIXED = ("xz", "grid")
BOX = 1.0 + jg.DEFAULT_PADDING


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """torch's CPU ops in one thread (ROADMAP.md section C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(flat: dict, seed: int) -> dict:
    """Every tensor moved off its init: kernels by 0.3/sqrt(fan_in), other
    tensors by 0.05."""
    rng = np.random.default_rng(seed)
    return {k: (v + (0.3 / np.sqrt(np.prod(v.shape[:-1])) if v.ndim > 1
                     else 0.05) * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in flat.items()}


def _load_perturbed(tm):
    """The port module `tm` with its own init perturbed, and those weights
    as flax variables (which the JAX module then takes by name)."""
    torch.manual_seed(0)
    v = unflatten_params(_perturb(flatten_params(
        params_to_jax(tm.state_dict(), tm)), 1))
    tm.load_state_dict(params_from_jax(v, tm), strict=True)
    return v


def _close(got, want, rtol, scale_atol=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale_atol * np.abs(want).max())


def _cloud(seed, shape, lo=0.5):
    return np.random.default_rng(seed).uniform(-lo, lo, shape).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _model(plane_type: tuple, surface: bool = False):
    """(JAX model, perturbed variables, port model) of a small ConvONet;
    `surface` moves the output bias so that the median logit of a coarse
    grid sits at the iso value (the field has a surface)."""
    jm = JaxConvONet(C, C, RES, plane_type=plane_type, grid_resolution=RG)
    flat = _perturb(flatten_params(flax_init_params(
        0, "convonet", c_dim=C, hidden_dim=C, plane_type=plane_type,
        grid_resolution=RG)), 1)
    if surface:
        pc = _cloud(0, (B, 64, 3), 0.4)
        v = unflatten_params(flat)
        jc = jm.apply(v, jnp.asarray(pc), method="encode_inputs")
        grid = jnp.asarray(jg.make_grid(8, BOX).reshape(1, -1, 3))
        vals = np.asarray(jm.apply(v, jnp.broadcast_to(grid, (B,) + grid.shape[1:]),
                                   jc, method="decode"))
        flat["params/decoder/fc_out/bias"] += np.float32(
            tg.logit_threshold(0.2) - np.median(vals))
    v = unflatten_params(flat)
    tm = ConvOccupancyNetwork(C, C, RES, plane_type=plane_type,
                              grid_resolution=RG)
    tm.load_state_dict(params_from_jax(v, tm), strict=True)
    return jm, v, tm.eval()


def test_trilinear_grid_sample_value_and_gradient():
    rng = np.random.default_rng(0)
    # features and cotangent of 0.1: values and gradients of order 1
    grid = (rng.normal(size=(B, 5, 6, 7, 3)) * 0.1).astype(np.float32)
    uvw = rng.uniform(-0.2, 1.2, (B, 300, 3)).astype(np.float32)
    uvw[0, :3] = [[0.0, 0.5, 1.0], [1.0, 1.0, 1.0], [0.25, 0.0, 0.5]]
    cot = (rng.normal(size=(B, 300, 3)) * 0.1).astype(np.float32)

    def jf(g, u):
        return jnp.sum(jinterp.trilinear_grid_sample(g, u) * cot)

    want = jinterp.trilinear_grid_sample(jnp.asarray(grid), jnp.asarray(uvw))
    jg_grid, jg_uvw = jax.grad(jf, (0, 1))(jnp.asarray(grid), jnp.asarray(uvw))
    tgrid = torch.from_numpy(grid).requires_grad_(True)
    tuvw = torch.from_numpy(uvw).requires_grad_(True)
    got = tinterp.trilinear_grid_sample(tgrid, tuvw)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tgrid.grad.numpy(), np.asarray(jg_grid),
                               rtol=0, atol=1e-6)
    # a coordinate exactly at 0 or 1: jnp.clip passes half its gradient
    # (a tie of max / min), torch's clamp all of it
    edge = (uvw == 0) | (uvw == 1)
    np.testing.assert_allclose(tuvw.grad.numpy()[~edge],
                               np.asarray(jg_uvw)[~edge], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tuvw.grad.numpy()[edge],
                               2 * np.asarray(jg_uvw)[edge], rtol=0, atol=1e-6)
    assert np.abs(np.asarray(jg_uvw)).max() > 0.1
    # outside [0, 1] the clamp holds the coordinate: no gradient
    out = (uvw < 0) | (uvw > 1)
    assert out.any() and (tuvw.grad.numpy()[out] == 0).all()


def test_plane_sample_cpu_is_the_plain_version():
    rng = np.random.default_rng(1)
    plane = torch.from_numpy(rng.normal(size=(B, 6, 5, 6)).astype(np.float32))
    uv = torch.from_numpy(rng.uniform(-0.1, 1.1, (B, 50, 2)).astype(np.float32))
    want = jinterp.bilinear_plane_sample(jnp.asarray(plane.numpy()),
                                         jnp.asarray(uv.numpy()))
    np.testing.assert_allclose(tinterp.plane_sample(plane, uv).numpy(),
                               np.asarray(want), atol=1e-6)


def test_normalize_3d_and_cell_index_exact():
    p = _cloud(2, (B, 500, 3), 0.7)
    p[0, :4] = [[0.5499, -0.55, 0.0], [0.55, 0.55, 0.55], [-1, 0, 1],
                [0.0, 0.0, 0.0]]
    jn = np.asarray(jcv.normalize_3d_coordinate(jnp.asarray(p), 0.1))
    tn = tcv.normalize_3d_coordinate(torch.from_numpy(p), 0.1)
    np.testing.assert_array_equal(tn.numpy(), jn)
    np.testing.assert_array_equal(
        tcv.coordinate2index_3d(tn, RG).numpy(),
        np.asarray(jcv.coordinate2index_3d(jnp.asarray(jn), RG)))


def test_pooled_mean_and_scatter_max():
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(B, 200, 5)).astype(np.float32)
    idx = rng.integers(0, 40, (B, 200)).astype(np.int32)
    np.testing.assert_allclose(
        tscatter.pooled_mean_by_cell(torch.from_numpy(feat),
                                     torch.from_numpy(idx), 64).numpy(),
        np.asarray(jscatter.pooled_mean_by_cell(jnp.asarray(feat),
                                                jnp.asarray(idx))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        tscatter.scatter_max_2d(torch.from_numpy(feat), torch.from_numpy(idx),
                                64).numpy(),
        np.asarray(jscatter.scatter_max_2d(jnp.asarray(feat), jnp.asarray(idx),
                                           64)))


def test_unet3d():
    jm = JaxUNet3D(C, depth=2, start_filts=C)
    x = np.random.default_rng(4).normal(size=(B, RG, RG, RG, C)).astype(np.float32)
    tm = UNet3D(C, depth=2, start_filts=C)
    v = _load_perturbed(tm)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)), 1e-4, 1e-4)


@pytest.mark.parametrize("plane_type", [GRID, MIXED])
def test_local_pool_pointnet(plane_type):
    jm = jcv.LocalPoolPointnet(C, C, RES, plane_type=plane_type,
                               grid_resolution=RG, unet_depth=2,
                               unet3d_depth=2)
    p = _cloud(5, (B, 128, 3))
    tm = LocalPoolPointnet(C, C, RES, unet_depth=2, plane_type=plane_type,
                           grid_resolution=RG, unet3d_depth=2)
    v = _load_perturbed(tm)
    want = jm.apply(v, jnp.asarray(p))
    with torch.no_grad():
        got = tm(torch.from_numpy(p))
    assert list(got) == list(want)
    for pl in want:
        _close(got[pl], want[pl], 1e-4, 1e-4)


@pytest.mark.parametrize("plane_type", [GRID, MIXED])
def test_grid_decode_and_gradient_to_p(plane_type):
    jm, v, tm = _model(plane_type)
    pc = _cloud(6, (B, 96, 3))
    q = _cloud(7, (B, 200, 3), 0.6)             # some past the padded cube
    jc = jm.apply(v, jnp.asarray(pc), method="encode_inputs")
    want = jm.apply(v, jnp.asarray(q), jc, method="decode")
    jgrad = jax.grad(lambda x: jnp.sum(jm.apply(v, x, jc, method="decode")))(
        jnp.asarray(q))
    with torch.no_grad():
        tc = tm.encode_inputs(torch.from_numpy(pc))
    for pl in jc:
        _close(tc[pl], jc[pl], 1e-4, 1e-4)
    # the decoder on JAX's latent, so the decoder alone is held to 1e-5
    tq = torch.from_numpy(q).requires_grad_(True)
    got = tm.decode(tq, {k: torch.from_numpy(np.array(a)) for k, a in jc.items()})
    got.sum().backward()
    _close(got, want, 1e-5)
    _close(tq.grad, jgrad, 1e-5)
    with torch.no_grad():
        _close(tm.decode(torch.from_numpy(q), tc), want, 1e-4, 1e-4)


def test_decode_with_normalised_coordinates():
    """`p_n`: each plane sampled at the caller's uv (`plane_sample`), the
    grid at the caller's uvw."""
    jm, v, tm = _model(MIXED)
    jc = jm.apply(v, jnp.asarray(_cloud(8, (B, 96, 3))), method="encode_inputs")
    q = _cloud(9, (B, 150, 3))
    rng = np.random.default_rng(10)
    p_n = {"xz": rng.uniform(-0.1, 1.1, (B, 150, 2)).astype(np.float32),
           "grid": rng.uniform(-0.1, 1.1, (B, 150, 3)).astype(np.float32)}
    want = jm.apply(v, jnp.asarray(q), jc,
                    {k: jnp.asarray(a) for k, a in p_n.items()},
                    method="decode")
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(q),
                        {k: torch.from_numpy(np.array(a)) for k, a in jc.items()},
                        {k: torch.from_numpy(a) for k, a in p_n.items()})
    _close(got, want, 1e-5)


@pytest.mark.parametrize("scatter_type,pos_encoding", [
    ("max", "linear"), ("max", "sin_cos"), ("mean", "linear"),
    ("mean", "sin_cos")])
def test_patch_local_pool_pointnet(scatter_type, pos_encoding):
    plane_type = ("xz", "xy", "grid")
    kw = dict(plane_resolution=RES, grid_resolution=RG, unet_depth=2,
              unet3d_depth=2, scatter_type=scatter_type, local_coord=True,
              pos_encoding=pos_encoding, unit_size=0.1)
    p = _cloud(11, (B, 128, 3))
    rng = np.random.default_rng(12)
    # the caller's cell indices, some cells shared
    index = {"xz": rng.integers(0, RES * RES // 4, (B, 128)),
             "xy": rng.integers(0, RES * RES, (B, 128)),
             "grid": rng.integers(0, RG**3 // 8, (B, 128))}
    jm = jcv.PatchLocalPoolPointnet(C, C, **kw)
    jindex = {k: jnp.asarray(a, jnp.int32) for k, a in index.items()}
    tm = PatchLocalPoolPointnet(C, C, plane_type=plane_type, **kw)
    v = _load_perturbed(tm)
    want = jm.apply(v, jnp.asarray(p), jindex)
    with torch.no_grad():
        got = tm(torch.from_numpy(p),
                 {k: torch.from_numpy(a) for k, a in index.items()})
    for pl in want:
        _close(got[pl], want[pl], 1e-4, 1e-4)
    with pytest.raises(ValueError):
        tm(torch.from_numpy(p), {"xz": torch.from_numpy(index["xz"])})


def test_positional_encoding_and_map2local():
    p = _cloud(13, (B, 40, 3), 0.55)
    np.testing.assert_allclose(
        tcv.map2local(torch.from_numpy(p), 0.1, "sin_cos").numpy(),
        np.asarray(jcv.map2local(jnp.asarray(p), 0.1, "sin_cos")), atol=2e-6)
    np.testing.assert_allclose(
        tcv.map2local(torch.from_numpy(p), 0.1).numpy(),
        np.asarray(jcv.map2local(jnp.asarray(p), 0.1)), atol=1e-6)


def test_init_occupancy_model_follows_the_grid():
    tm = ConvOccupancyNetwork(C, C, RES, plane_type=MIXED, grid_resolution=RG)
    tm.encoder = LocalPoolPointnet(C, C, RES, plane_type=MIXED,
                                   grid_resolution=RG, unet3d_depth=2)
    variables = init_occupancy_model(tm, 0)
    keys = set(flatten_params(variables))
    assert "params/encoder/unet3d/up_0/upconv/kernel" in keys
    assert "params/encoder/unet/down_3/conv1/kernel" in keys
    assert not any("unet3d/down_2" in k for k in keys)
    jm = JaxConvONet(C, C, RES, plane_type=("grid",), grid_resolution=RG)
    x = jnp.zeros((1, 16, 3))
    shapes = jax.eval_shape(jm.init, jax.random.key(0), x, x)
    want = {k: tuple(s.shape) for k, s in flatten_params(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.int8),
                               shapes)).items()}
    got = {k: tuple(a.shape) for k, a in flatten_params(flax_init_params(
        0, "convonet", c_dim=C, hidden_dim=C, plane_type=("grid",))).items()}
    assert got == want


def _jax_draws(pc, key, inp, samp):
    from if_defense_tpu.defense.ifdefense import sample_valid as jax_sample_valid
    from if_defense_tpu.defense.sor import sor_defense as jax_sor
    from if_defense_tpu.ops import normalize_unit_cube as jax_cube

    pc, mask = jax_sor(pc, 2, 1.1)
    proc = jax_cube(pc, 0.9, mask)
    k_enc, k_init, k_noise = jax.random.split(key, 3)
    sel = jax_sample_valid(proc, mask, inp, k_enc)
    pts = jax_sample_valid(proc, mask, samp, k_init)
    noise = jax.random.normal(k_noise, pts.shape) * 0.01
    return sel, jnp.clip(pts + noise, -0.45, 0.45)


ITERS, INP, SAMP, LR = 8, 64, 128, 1e-3


@functools.lru_cache(maxsize=1)
def _defense_case():
    """(port model, clouds, JAX's draws, JAX's output) of a small grid
    ConvONet-Opt, 8 steps in the reference mode."""
    import os

    jm, v, tm = _model(GRID)
    pc = (np.random.default_rng(14).normal(size=(B, 160, 3)) * 0.3).astype(
        np.float32)
    pc[:, :3] *= 4.0                                   # outliers for SOR
    key = jax.random.key(1)
    kwargs = dict(iterations=ITERS, input_npoint=INP, sample_npoint=SAMP, lr=LR)
    old = os.environ.get("IFDEF_FORCE_FUSED_REPULSION")
    os.environ["IFDEF_FORCE_FUSED_REPULSION"] = "1"
    try:
        want = np.asarray(jax_defense(jm, v, **kwargs)(jnp.asarray(pc), key))
        draws = tuple(torch.from_numpy(np.array(a)) for a in
                      jax.jit(_jax_draws, static_argnums=(2, 3))(
                          jnp.asarray(pc), key, INP, SAMP))
    finally:
        if old is None:
            del os.environ["IFDEF_FORCE_FUSED_REPULSION"]
        else:
            os.environ["IFDEF_FORCE_FUSED_REPULSION"] = old
    return tm, pc, draws, want, kwargs


def test_grid_opt_defense_matches_jax():
    """The slice as a whole: ConvONet-Opt on the grid model, JAX's draws
    through the `draws` seam; >= 99.9 % of coordinates within 1e-4 and all
    within 2 lr (iterations + 1), as `test_torch_port_defense.py`."""
    tm, pc, draws, want, kwargs = _defense_case()
    stats = {}
    got = convonet_opt_defense(tm, **kwargs)(torch.from_numpy(pc), draws=draws,
                                             stats=stats).numpy()
    assert got.shape == want.shape == (B, SAMP, 3) and np.isfinite(got).all()
    err = np.abs(got - want)
    assert (err <= 1e-4).mean() >= 0.999, (err.max(), (err <= 1e-4).mean())
    assert err.max() <= 2 * LR * (ITERS + 1), err.max()
    assert float(stats["occ_loss_last"]) < float(stats["occ_loss_first"])


def test_grid_opt_defense_interp_refresh_is_the_reference_mode():
    """A grid latent keeps the exact path under `interp_refresh > 1` (no
    corner cache, as the JAX package): the reference mode's bits. With
    `rep_graph_cache` the port refuses, where the JAX package drops the
    flag silently (ROADMAP.md section C)."""
    tm, pc, draws, _, kwargs = _defense_case()
    ref = convonet_opt_defense(tm, **kwargs)(torch.from_numpy(pc), draws=draws)
    fast = convonet_opt_defense(tm, interp_refresh=16, **kwargs)(
        torch.from_numpy(pc), draws=draws)
    assert torch.equal(ref, fast)
    with pytest.raises(ValueError, match="corner_cache_fn"):
        convonet_opt_defense(tm, interp_refresh=16, rep_graph_cache=True,
                             **kwargs)


def test_lattice_evaluators_decline_the_grid():
    _, _, grid = _model(GRID)
    _, _, mixed = _model(MIXED)
    planes = ConvOccupancyNetwork(C, C, RES, plane_type=("xz", "xy"))
    for m in (grid, mixed):
        assert tg.make_convonet_lattice_eval(m, 16, BOX) is None
    for m in (grid, mixed, planes):
        assert tg.make_convonet_dense_eval(m, 16, BOX) is None
        assert tg.make_convonet_sparse_eval(m, 16, BOX) is None
    assert tg.make_convonet_lattice_eval(planes, 16, BOX) is not None
    c = {"grid": torch.zeros((1, RG, RG, RG, C))}
    with pytest.raises(ValueError):
        grid.lattice_planes(c, 16, BOX)
    with pytest.raises(ValueError):
        grid.dense_lattice_logits(c, 16, BOX)


def test_grid_value_grids_match_jax():
    """The mesh path's front half on the grid model: the exact coarse +
    refine path (no lattice evaluator), bf16 wire, as
    `test_torch_port_generation.py` holds it: every entry within one bf16
    step, >= 99 % within 1e-5 of the largest logit."""
    jm, v, tm = _model(GRID, surface=True)
    pc = _cloud(0, (B, 64, 3), 0.4)
    jc = jm.apply(v, jnp.asarray(pc), method="encode_inputs")
    with torch.no_grad():
        tc = tm.encode_inputs(torch.from_numpy(pc))
    kw = dict(resolution0=8, upsample=2, chunk=512)
    want, iso = jg.compute_value_grids(
        lambda vv, p, c: jm.apply(vv, p, c, method="decode"), v, jc, **kw)
    got, _ = tg.compute_value_grids(lambda m, p, c: m.decode(p, c), tm, tc,
                                    **kw)
    assert got.shape == want.shape == (B, 17, 17, 17)
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)
    assert (err <= np.maximum(np.abs(want), 1e-30) * 2.0**-7).all()
    assert (err <= 1e-5 * np.abs(want).max()).mean() >= 0.99
    assert (want > iso).any() and (want < iso).any()
