"""The whole ConvONet-Opt and ONet-Opt restorations, PyTorch port vs JAX
package.

Both run `make_opt_defense` (through `convonet_opt_defense`, or
`onet_opt_defense`) for 5 steps on the same clouds and perturbed flax
weights (ConvONet c_dim/hidden 8, 16x16 planes; ONet c_dim/hidden 32,
decoder 16, its batch norms on running statistics; B=2, 256 optimised
points). `jax.random` cannot be reproduced in
torch, so the encoder subset and the initial points are drawn the JAX way
(`ifdefense.py:144-171`) and handed to the port through its `draws` seam.
JAX runs its Pallas repulsion kernels in interpret mode
(IFDEF_FORCE_FUSED_REPULSION=1), the exact selection the port's CPU path
computes.

Tolerance (f32 modes): >= 99.9 % of coordinates within 1e-4, and all
within 2 lr (iterations + 1): Adam moves a coordinate by about lr sign(g),
so a gradient within rounding of 0 can send one coordinate the other way.
bf16 mode: >= 95 % of coordinates within 1e-3 and all within 5e-2. bf16
rounds the decoder and the points at other places in the two frameworks, a
coordinate's bf16 step near the unit sphere is 2^-8 ~ 4e-3, and the output
is rescaled to the unit sphere (about x2 here), so a few coordinates take a
different Adam direction more than once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from if_defense_tpu.defense.ifdefense import convonet_opt_defense as jax_defense
from if_defense_tpu.defense.ifdefense import onet_opt_defense as jax_onet_defense
from if_defense_tpu.defense.ifdefense import sample_valid as jax_sample_valid
from if_defense_tpu.defense.sor import sor_defense as jax_sor
from if_defense_tpu.implicit import ConvOccupancyNetwork as JaxConvONet
from if_defense_tpu.implicit import OccupancyNetwork as JaxONet
from if_defense_tpu.ops import normalize_unit_cube as jax_cube
from if_defense_tpu_torch.defense.ifdefense import (
    convonet_opt_defense,
    onet_opt_defense,
)
from if_defense_tpu_torch.implicit import ConvOccupancyNetwork, OccupancyNetwork
from if_defense_tpu_torch.utils.params_io import (
    flatten_params,
    params_from_jax,
    unflatten_params,
)

C, RES, B, K, INP, SAMP, ITERS, LR = 8, 16, 2, 256, 64, 256, 5, 1e-3


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """torch's CPU ops in one thread. Multi-threaded elementwise math has
    been seen to return one worker's chunk of a large tensor at low
    accuracy now and then (ROADMAP.md section C), which these tolerances
    would catch; in one thread the result does not depend on the split."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=2)
def _setup(model=None):
    rng = np.random.default_rng(0)
    pc = (rng.normal(size=(B, K, 3)) * 0.3).astype(np.float32)
    pc[:, :3] *= 4.0                                   # outliers for SOR
    model = model or JaxConvONet(C, C, RES)
    x = jnp.zeros((1, 32, 3))
    flat = flatten_params(jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.key(0), x, x)))
    # running variances are scaled, so that they stay positive
    flat = {k: (v * np.exp(0.2 * rng.normal(size=v.shape)) if k.endswith("/var")
                else v + (0.3 / np.sqrt(np.prod(v.shape[:-1])) if v.ndim > 1
                          else 0.05) * rng.normal(size=v.shape)
                ).astype(np.float32)
            for k, v in flat.items()}
    return pc, unflatten_params(flat)


@jax.jit
def _jax_draws(pc, key):
    """The encoder subset and initial points as JAX's defend draws them."""
    pc, mask = jax_sor(pc, 2, 1.1)
    proc = jax_cube(pc, 0.9, mask)
    k_enc, k_init, k_noise = jax.random.split(key, 3)
    sel = jax_sample_valid(proc, mask, INP, k_enc)
    pts = jax_sample_valid(proc, mask, SAMP, k_init)
    noise = jax.random.normal(k_noise, pts.shape) * 0.01
    return sel, jnp.clip(pts + noise, -0.45, 0.45)


MODES = {
    "reference": {},
    "fast_f32": {"interp_refresh": 2, "rep_graph_cache": True},
    "bf16": {"compute_dtype": "bfloat16", "interp_refresh": 2,
             "rep_graph_cache": True},
    "exact_knn": {"exact_knn": True, "knn_refresh": 2},
}


@pytest.mark.parametrize("mode", list(MODES))
def test_opt_defense_matches_jax(mode, monkeypatch):
    monkeypatch.setenv("IFDEF_FORCE_FUSED_REPULSION", "1")
    pc, variables = _setup()
    kwargs = dict(iterations=ITERS, input_npoint=INP, sample_npoint=SAMP,
                  lr=LR, **MODES[mode])
    key = jax.random.key(1)
    want = np.asarray(jax_defense(JaxConvONet(C, C, RES), variables,
                                  **kwargs)(jnp.asarray(pc), key))
    draws = tuple(torch.from_numpy(np.array(a))
                  for a in _jax_draws(jnp.asarray(pc), key))
    model = ConvOccupancyNetwork(C, C, RES)
    model.load_state_dict(params_from_jax(variables, model))
    stats = {}
    got = convonet_opt_defense(model, **kwargs)(
        torch.from_numpy(pc), draws=draws, stats=stats).numpy()

    assert got.shape == want.shape == (B, SAMP, 3)
    assert np.isfinite(got).all()
    err = np.abs(got - want)
    if mode == "bf16":
        near, share, bound = 1e-3, 0.95, 5e-2
    else:
        near, share, bound = 1e-4, 0.999, 2 * LR * (ITERS + 1)
    assert (err <= near).mean() >= share, (err.max(), (err <= near).mean())
    assert err.max() <= bound, err.max()
    assert float(stats["occ_loss_last"]) < float(stats["occ_loss_first"])


def test_onet_opt_defense_matches_jax(monkeypatch):
    """ONet-Opt in the reference mode; the decoder's batch norms use the
    running statistics (the port's loop model is in eval mode)."""
    monkeypatch.setenv("IFDEF_FORCE_FUSED_REPULSION", "1")
    pc, variables = _setup(JaxONet(32, 32, 16))
    kwargs = dict(iterations=ITERS, input_npoint=INP, sample_npoint=SAMP,
                  lr=LR)
    key = jax.random.key(2)
    want = np.asarray(jax_onet_defense(JaxONet(32, 32, 16), variables,
                                       **kwargs)(jnp.asarray(pc), key))
    draws = tuple(torch.from_numpy(np.array(a))
                  for a in _jax_draws(jnp.asarray(pc), key))
    model = OccupancyNetwork(32, 32, 16)
    model.load_state_dict(params_from_jax(variables, model))
    stats = {}
    got = onet_opt_defense(model.train(), **kwargs)(
        torch.from_numpy(pc), draws=draws, stats=stats).numpy()

    assert got.shape == want.shape == (B, SAMP, 3)
    assert np.isfinite(got).all()
    err = np.abs(got - want)
    assert (err <= 1e-4).mean() >= 0.999, (err.max(), (err <= 1e-4).mean())
    assert err.max() <= 2 * LR * (ITERS + 1), err.max()
    assert model.training            # the caller's model is left as it was
    assert float(stats["occ_loss_last"]) < float(stats["occ_loss_first"])


def test_rep_graph_cache_needs_the_corner_cache():
    """JAX drops rep_graph_cache silently without the corner-cache
    functions; the port raises (and raises as JAX does without
    interp_refresh > 1)."""
    from if_defense_tpu_torch.defense.ifdefense import make_opt_defense

    def no_fn(*_):
        return None

    with pytest.raises(ValueError, match="interp_refresh"):
        make_opt_defense(no_fn, no_fn, rep_graph_cache=True)
    with pytest.raises(ValueError, match="corner_cache_fn"):
        make_opt_defense(no_fn, no_fn, rep_graph_cache=True,
                         interp_refresh=2)


def test_opt_defense_above_4096_points():
    """ConvONet-Opt restores 4200 points a cloud (more than the 4096 the
    repulsion kernels once refused), B=1, 2 iterations: finite points inside
    the unit sphere. The card runs the same path through B1
    (`chip_smoke.py` phase 3, `tests/test_torch_port_cuda.py`)."""
    from if_defense_tpu_torch.utils.params_io import init_params

    pc = (np.random.default_rng(3).normal(size=(1, K, 3)) * 0.3).astype(
        np.float32)
    model = ConvOccupancyNetwork(C, C, RES)
    model.load_state_dict(params_from_jax(init_params(0, c_dim=C,
                                                      hidden_dim=C), model))
    defend = convonet_opt_defense(model, iterations=2, input_npoint=INP,
                                  sample_npoint=4200)
    out = defend(torch.from_numpy(pc),
                 torch.Generator().manual_seed(3)).numpy()
    assert out.shape == (1, 4200, 3) and np.isfinite(out).all()
    assert np.sqrt((out ** 2).sum(-1)).max() <= 1 + 1e-5


def test_generator_draws_are_seeded():
    """Without draws the port samples from the torch.Generator it is given:
    the same seed gives the same restoration."""
    pc, variables = _setup()
    model = ConvOccupancyNetwork(C, C, RES)
    model.load_state_dict(params_from_jax(variables, model))
    defend = convonet_opt_defense(model, iterations=2, input_npoint=INP,
                                  sample_npoint=SAMP)
    outs = [defend(torch.from_numpy(pc),
                   torch.Generator().manual_seed(7)).numpy()
            for _ in range(2)]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert np.isfinite(outs[0]).all()
