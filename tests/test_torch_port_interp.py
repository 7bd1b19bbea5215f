"""The plain version of kernel B4, `ops.interp.plane_features` (each plane's
`normalize_coordinate`, its bilinear sample, the sum over the planes),
against the JAX package's `LocalDecoder.sample_features` on the same
inputs: the forward, and the gradients to p and to every plane through
`jax.vjp` with the same numpy cotangent. 1, 2 and 3 planes in the dict's
order; p drawn from [-0.7, 0.7]^3, so that the normalisation's clamp (and
its zero gradient) is exercised. The CUDA kernel is held to this plain
version on the card (`tests/test_torch_port_cuda.py`, `chip_smoke.py`).

Tolerance: rtol 1e-5 with atol 1e-5 of the largest entry (f32 on both
sides; JAX and torch sum the corner products and the channel terms of the
p gradient in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from if_defense_tpu.implicit.convonet import LocalDecoder as JaxDecoder
from if_defense_tpu_torch.implicit import LocalDecoder
from if_defense_tpu_torch.ops import plane_features

PLANES = ("xz", "xy", "yz")
C, RES, B, Q = 8, 16, 2, 200


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """torch's CPU ops in one thread (see tests/test_torch_port_modules.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("n_planes", [1, 2, 3])
def test_plane_features_match_jax_sample_features(n_planes):
    rng = np.random.default_rng(n_planes)
    names = PLANES[:n_planes]
    planes = {n: rng.normal(size=(B, RES, RES, C)).astype(np.float32)
              for n in names}
    p = rng.uniform(-0.7, 0.7, (B, Q, 3)).astype(np.float32)
    g = rng.normal(size=(B, Q, C)).astype(np.float32)

    jm = JaxDecoder(C, C)
    jplanes = {n: jnp.asarray(x) for n, x in planes.items()}
    v = jm.init(jax.random.key(0), jnp.asarray(p), jplanes)
    want, vjp = jax.vjp(
        lambda q, pl: jm.apply(v, q, pl, method="sample_features"),
        jnp.asarray(p), jplanes)
    want_dp, want_dplanes = vjp(jnp.asarray(g))

    tp = torch.from_numpy(p).requires_grad_(True)
    tplanes = {n: torch.from_numpy(x).requires_grad_(True)
               for n, x in planes.items()}
    got = plane_features(tp, tplanes, 0.1)
    got.backward(torch.from_numpy(g))
    _close(got, want)
    _close(tp.grad, want_dp)
    for n in names:
        _close(tplanes[n].grad, want_dplanes[n])
    # clamped coordinates pass no gradient: both sides agree on the zeros
    assert (tp.grad == 0).any()
    # the decoder takes this plain version for CPU tensors
    with torch.no_grad():
        np.testing.assert_array_equal(
            LocalDecoder(C, C).sample_features(tp, tplanes).numpy(),
            got.detach().numpy())
