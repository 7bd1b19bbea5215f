"""The PyTorch port's modules against the JAX package on the same inputs.

Inputs are made from a seed with numpy. Networks use flax-initialised
weights with every tensor perturbed (flax zero-initialises each ResNet
block's fc_1), loaded into the port through `params_from_jax`. Sizes are
small: c_dim/hidden 8, 16x16 planes, UNet depth 3, B <= 2, N <= 256.
Network tolerance: rtol 1e-4, atol 1e-5 (f32 on both sides, sums in other
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from if_defense_tpu.defense.sor import sor_defense as jax_sor_defense
from if_defense_tpu.defense.sor import sor_statistics as jax_sor_statistics
from if_defense_tpu.implicit import ConvOccupancyNetwork as JaxConvONet
from if_defense_tpu.implicit.convonet import LocalDecoder as JaxDecoder
from if_defense_tpu.implicit.convonet import LocalPoolPointnet as JaxEncoder
from if_defense_tpu.implicit.unet2d import UNet2D as JaxUNet2D
from if_defense_tpu.ops import normalize_unit_cube as jax_cube
from if_defense_tpu.ops import normalize_unit_sphere as jax_sphere
from if_defense_tpu_torch.defense.sor import sor_defense, sor_statistics
from if_defense_tpu_torch.implicit import (
    ConvOccupancyNetwork,
    LocalDecoder,
    LocalPoolPointnet,
    UNet2D,
)
from if_defense_tpu_torch.ops import normalize_unit_cube, normalize_unit_sphere
from if_defense_tpu_torch.utils.params_io import (
    flatten_params,
    params_from_jax,
    unflatten_params,
)

RTOL, ATOL = 1e-4, 1e-5
C, RES = 8, 16


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


def _perturbed(variables, seed):
    """Flax variables with every tensor moved off its init (nonzero fc_1),
    by 0.3/sqrt(fan_in) for kernels and 0.05 for biases, so activations stay
    of order 1 through the UNet."""
    rng = np.random.default_rng(seed)
    flat = flatten_params(jax.tree_util.tree_map(np.asarray, variables))
    out = {}
    for k, v in flat.items():
        scale = (0.3 / np.sqrt(np.prod(v.shape[:-1])) if v.ndim > 1
                 else 0.05)
        out[k] = (v + scale * rng.normal(size=v.shape)).astype(np.float32)
    return unflatten_params(out)


def _port(module, variables):
    module.load_state_dict(params_from_jax(variables, module), strict=True)
    return module.eval()


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _cloud(seed, shape=(2, 256, 3), scale=0.3):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale


@pytest.mark.parametrize("masked", [False, True])
def test_normalisation(masked):
    pc = _cloud(0)
    mask = (np.random.default_rng(1).uniform(size=pc.shape[:2]) > 0.2
            ).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    np.testing.assert_allclose(
        normalize_unit_cube(torch.from_numpy(pc), 0.9, tm).numpy(),
        np.asarray(jax_cube(jnp.asarray(pc), 0.9, jm)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        normalize_unit_sphere(torch.from_numpy(pc), tm).numpy(),
        np.asarray(jax_sphere(jnp.asarray(pc), jm)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sor_mask_equal_and_statistic_close(seed):
    pc = _cloud(seed)
    pc[:, :4] *= 4.0                                      # a few outliers
    stat = sor_statistics(torch.from_numpy(pc))
    np.testing.assert_allclose(
        stat.numpy(), np.asarray(jax_sor_statistics(jnp.asarray(pc))),
        rtol=0, atol=1e-6)
    _, mask = sor_defense(torch.from_numpy(pc))
    _, jmask = jax_sor_defense(jnp.asarray(pc))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert 0 < mask.sum() < mask.numel()


def test_unet2d():
    jm = JaxUNet2D(C, depth=3, start_filts=C)
    x = np.random.default_rng(3).normal(size=(2, RES, RES, C)).astype(np.float32)
    v = _perturbed(jm.init(jax.random.key(0), jnp.asarray(x)), 4)
    tm = _port(UNet2D(C, depth=3, start_filts=C), v)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)))


def test_local_pool_pointnet():
    jm = JaxEncoder(C, C, RES, unet_depth=3)
    p = np.random.default_rng(5).uniform(-0.45, 0.45, (2, 128, 3)).astype(np.float32)
    v = _perturbed(jm.init(jax.random.key(0), jnp.asarray(p)), 6)
    tm = _port(LocalPoolPointnet(C, C, RES, unet_depth=3), v)
    want = jm.apply(v, jnp.asarray(p))
    with torch.no_grad():
        got = tm(torch.from_numpy(p))
    assert list(got) == list(want) == ["xz", "xy", "yz"]
    for pl in want:
        _close(got[pl], want[pl])


def test_local_decoder_features_and_head():
    rng = np.random.default_rng(7)
    planes = {pl: rng.normal(size=(2, RES, RES, C)).astype(np.float32)
              for pl in ("xz", "xy", "yz")}
    p = rng.uniform(-0.5, 0.5, (2, 100, 3)).astype(np.float32)
    jm = JaxDecoder(C, C)
    jplanes = {k: jnp.asarray(x) for k, x in planes.items()}
    v = _perturbed(jm.init(jax.random.key(0), jnp.asarray(p), jplanes), 8)
    tm = _port(LocalDecoder(C, C), v)
    tplanes = {k: torch.from_numpy(x) for k, x in planes.items()}
    with torch.no_grad():
        feat = tm.sample_features(torch.from_numpy(p), tplanes)
        _close(feat, jm.apply(v, jnp.asarray(p), jplanes,
                              method="sample_features"))
        _close(tm(torch.from_numpy(p), tplanes),
               jm.apply(v, jnp.asarray(p), jplanes))


def test_convonet_encode_decode():
    rng = np.random.default_rng(9)
    pc = rng.uniform(-0.45, 0.45, (2, 128, 3)).astype(np.float32)
    q = rng.uniform(-0.5, 0.5, (2, 100, 3)).astype(np.float32)
    jm = JaxConvONet(C, C, RES)
    v = _perturbed(jm.init(jax.random.key(0), jnp.asarray(pc), jnp.asarray(q)), 10)
    tm = _port(ConvOccupancyNetwork(C, C, RES), v)
    c = jm.apply(v, jnp.asarray(pc), method="encode_inputs")
    with torch.no_grad():
        tc = tm.encode_inputs(torch.from_numpy(pc))
        for pl in c:
            _close(tc[pl], c[pl])
        _close(tm.decode(torch.from_numpy(q), tc),
               jm.apply(v, jnp.asarray(q), c, method="decode"))
