"""DUP-Net and the baseline-defense CLI, PyTorch port vs JAX package.

FPS (B5) and ball query (B6): the port's plain versions against the JAX
lax/XLA paths and against the Pallas kernels in interpret mode, indices
identical. SOR-fixed, SRS (JAX's permutations fed through `perm`) and
`process_data_fixed` (JAX's uniforms fed through `u`) identical. PU-Net
and the whole DUP-Net with the repository's weights
(`weights/punet_1024_up4.npz`): rtol 1e-4, atol 1e-5 (the Dense layers sum
in other orders; FPS, ball query and the 3-NN give the same indices, so
nothing else differs).

The CUDA kernels are held to these plain versions on the card by
`tests/test_torch_port_cuda.py` and `chip_smoke.py`.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from if_defense_tpu.defense.dupnet import DUPNet as JaxDUPNet
from if_defense_tpu.defense.dupnet import process_data_fixed as jax_process
from if_defense_tpu.defense.punet import PUNet as JaxPUNet
from if_defense_tpu.defense.sor import compact_by_mask as jax_compact
from if_defense_tpu.defense.sor import sor_defense_fixed as jax_sor_fixed
from if_defense_tpu.defense.srs import srs_defense as jax_srs
from if_defense_tpu.ops import farthest_point_sample as jax_fps
from if_defense_tpu.ops import query_ball_point as jax_ball_query
from if_defense_tpu.ops.pallas_ballquery import ballquery_pallas
from if_defense_tpu.ops.pallas_fps import fps_pallas
from if_defense_tpu.utils.params_io import load_params_npz as jax_load_params
from if_defense_tpu_torch.cli import defend_npz
from if_defense_tpu_torch.data import load_npz, save_npz
from if_defense_tpu_torch.defense import (
    DUPNet,
    PUNet,
    compact_by_mask,
    process_data_fixed,
    sor_defense_fixed,
    srs_defense,
)
from if_defense_tpu_torch.ops import (
    farthest_point_sample_plain,
    query_ball_point_plain,
)
from if_defense_tpu_torch.utils.params_io import (
    load_params_npz,
    params_from_jax,
)

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "weights", "punet_1024_up4.npz")


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


def _clouds(b=4, n=256, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n, 3)) * 0.3).astype(np.float32)


def _mask(b=4, n=256, seed=1):
    """~80 % valid; cloud 1 starts with invalid points, cloud 2 has none
    valid (FPS then returns 0s, ball query finds no hit)."""
    m = (np.random.default_rng(seed).uniform(size=(b, n)) > 0.2)
    m = m.astype(np.float32)
    m[1, :5] = 0
    m[2] = 0
    return m


@functools.lru_cache(maxsize=1)
def _weights():
    return jax_load_params(WEIGHTS), params_from_jax(load_params_npz(WEIGHTS))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("case", ["random", "duplicates", "masked", "start"])
def test_fps_plain_matches_jax(case):
    """Indices identical to the lax path and, unmasked, to the Pallas
    kernel. `duplicates` is a cloud padded by duplication and sampled to
    its full size: once every distance is 0 the pick is index 0, again and
    again."""
    x = _clouds()
    npoint, mask, start = 64, None, None
    if case == "duplicates":
        x = np.concatenate([x[:, :128], x[:, :128]], axis=1)
        npoint = 256
    elif case == "masked":
        mask = _mask()
    elif case == "start":
        start = np.array([3, 0, 255, 17], np.int32)
    got = farthest_point_sample_plain(
        _t(x), npoint, None if start is None else _t(start),
        None if mask is None else _t(mask)).numpy()
    want = np.asarray(jax_fps(
        jnp.asarray(x), npoint,
        start_idx=None if start is None else jnp.asarray(start),
        mask=None if mask is None else jnp.asarray(mask)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if case in ("random", "duplicates"):
        np.testing.assert_array_equal(
            got, np.asarray(fps_pallas(jnp.asarray(x), npoint,
                                       interpret=True)))
    if case == "duplicates":
        assert (got[:, 128:] == 0).all()
    if case == "masked":
        assert (got[2] == 0).all() and got[1, 0] == 5
        assert mask[np.arange(4)[:, None], got][[0, 1, 3]].all()


def _assert_same_groups(got, want, x, q, radius):
    """Identical indices, except at a centre that has a point within 1e-6
    of the radius (|d2 - r2| <= 1e-6 in f64): XLA may sum q.x in another
    order than the port, and only such a point can change sides."""
    bad = np.argwhere((got != want).any(-1))
    d2 = ((q[:, :, None, :].astype(np.float64)
           - x[:, None, :, :].astype(np.float64)) ** 2).sum(-1)
    for b, s in bad:
        assert (np.abs(d2[b, s] - radius ** 2) <= 1e-6).any(), (b, s)


@pytest.mark.parametrize("case", ["levels", "no_hit", "small_tile", "masked"])
def test_ball_query_plain_matches_jax(case):
    x = _clouds()
    q = x[:, ::4].copy()                                   # [4, 64, 3]
    mask = None
    if case == "no_hit":
        q[:, :8] += 5.0                                    # far from all
    elif case == "masked":
        mask = _mask()
    for radius, nsample in ((0.05, 32), (0.1, 32), (0.2, 32), (0.3, 16)):
        got = query_ball_point_plain(
            radius, nsample, _t(x), _t(q),
            None if mask is None else _t(mask)).numpy()
        assert got.dtype == np.int32 and got.shape == (4, 64, nsample)
        want = np.asarray(jax_ball_query(
            radius, nsample, jnp.asarray(x), jnp.asarray(q),
            mask=None if mask is None else jnp.asarray(mask)))
        _assert_same_groups(got, want, x, q, radius)
        if mask is None:
            tile = 8 if case == "small_tile" else 64
            kern = np.asarray(ballquery_pallas(
                radius, nsample, jnp.asarray(x), jnp.asarray(q),
                tile_s=tile, interpret=True))
            _assert_same_groups(got, kern, x, q, radius)
        if case == "no_hit":
            assert (got[:, :8] == 0).all()
        if case == "masked":                # only valid points, or no hit
            picked = mask[np.arange(4)[:, None, None], got] > 0
            assert (picked.all(-1) | (got == 0).all(-1)).all()
            assert (got[2] == 0).all()


def test_sor_fixed_and_compact_match_jax():
    x = _clouds(n=128)
    x[:, :6] *= 5.0                                        # outliers
    got, count = sor_defense_fixed(_t(x))
    want, want_count = jax_sor_fixed(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(count.numpy(), np.asarray(want_count))
    assert count.dtype == torch.int32 and (count < 128).all()
    mask = _mask(n=128)
    got, count = compact_by_mask(_t(x), _t(mask))
    want, want_count = jax_compact(jnp.asarray(x), jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(count.numpy(), np.asarray(want_count))


def test_srs_with_jax_permutation_matches_jax():
    x = _clouds(n=128)
    key = jax.random.key(3)
    perm = np.stack([np.asarray(jax.random.permutation(k, 128))
                     for k in jax.random.split(key, 4)])
    got = srs_defense(_t(x), 28, perm=_t(perm)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_srs(
        jnp.asarray(x), 28, key)))
    drawn = [srs_defense(_t(x), 28, torch.Generator().manual_seed(5))
             for _ in range(2)]
    assert drawn[0].shape == (4, 100, 3)
    torch.testing.assert_close(drawn[0], drawn[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="drop_num"):
        srs_defense(_t(x), 128)


def _jax_uniforms(key, b, k):
    """The [B, K] uniforms `process_data_fixed` draws from `key`."""
    return np.stack([np.asarray(jax.random.uniform(s, (k,)))
                     for s in jax.random.split(key, b)])


def test_process_data_fixed_with_jax_uniforms_matches_jax():
    x = _clouds(n=128)
    mask = _mask(n=128)
    key = jax.random.key(4)
    u = _jax_uniforms(key, 4, 128)
    for npoint in (64, 128, 200):      # subsample, keep, duplicate
        got = process_data_fixed(_t(x), _t(mask), npoint, u=_t(u)).numpy()
        want = np.asarray(jax_process(jnp.asarray(x), jnp.asarray(mask),
                                      npoint, key))
        np.testing.assert_array_equal(got, want)


def test_params_from_jax_loads_punet_weights():
    _, sd = _weights()
    missing, unexpected = PUNet().load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    with np.load(WEIGHTS) as npz:
        assert len(sd) == len(npz.files) == 50


def test_punet_matches_jax():
    variables, sd = _weights()
    x = _clouds(b=2, n=256, seed=2)
    want = np.asarray(jax.jit(JaxPUNet(256, 4).apply)(variables,
                                                      jnp.asarray(x)))
    net = PUNet(npoint=256, up_ratio=4)
    net.load_state_dict(sd)
    with torch.no_grad():
        got = net(_t(x)).numpy()
    assert got.shape == want.shape == (2, 1024, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_dupnet_matches_jax():
    variables, sd = _weights()
    x = _clouds(b=2, n=1024, seed=3)
    x[:, :10] *= 4.0                                       # outliers
    key = jax.random.key(0)
    want = np.asarray(jax.jit(JaxDUPNet(npoint=1024, up_ratio=4).__call__)(
        variables, jnp.asarray(x), key))
    dup = DUPNet(npoint=1024, up_ratio=4)
    dup.pu_net.load_state_dict(sd)
    with torch.no_grad():
        got = dup(_t(x), u=_t(_jax_uniforms(key, 2, 1024))).numpy()
    assert got.shape == want.shape == (2, 4096, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_defend_npz_cli_on_cpu(tmp_path):
    """All three defenses through the CLI: the tail batch is padded and cut
    back, outputs land in `<defense>/<defense>_<file>.npz` with the labels,
    at the shapes each defense gives."""
    rng = np.random.default_rng(0)
    data = save_npz(str(tmp_path / "adv.npz"),
                    {"test_pc": rng.normal(size=(3, 128, 3)) * 0.3,
                     "test_label": np.array([3, 1, 4]),
                     "target_label": np.array([5, 9, 2])})
    paths = defend_npz.main([
        "--data_root", data, "--device", "cpu", "--npoint", "64",
        "--batch_size", "2", "--srs_drop_num", "28"])
    assert paths == [str(tmp_path / d / f"{d}_adv.npz")
                     for d in ("srs", "sor", "dup")]
    for path, n in zip(paths, (100, 128, 256)):
        got = load_npz(path)
        assert got.test_pc.shape == (3, n, 3)
        assert np.isfinite(got.test_pc).all()
        np.testing.assert_array_equal(got.test_label, [3, 1, 4])
        np.testing.assert_array_equal(got.target_label, [5, 9, 2])


@pytest.mark.parametrize("cli", ["defend_npz", "opt_defense",
                                 "train_implicit"])
def test_clis_refuse_to_fall_back_to_the_cpu(cli, monkeypatch, tmp_path):
    """Without a card and without `--device cpu`, a CLI exits non-zero
    with a message instead of running on the CPU."""
    from if_defense_tpu_torch.cli import opt_defense, train_implicit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"defend_npz": ["--data_root", str(tmp_path / "x.npz")],
            "opt_defense": ["--data_root", str(tmp_path / "x.npz"),
                            "--weights", str(tmp_path / "w.npz")],
            "train_implicit": ["--data", str(tmp_path / "occ.npz"),
                               "--output", str(tmp_path / "w")]}[cli]
    modules = {"defend_npz": defend_npz, "opt_defense": opt_defense,
               "train_implicit": train_implicit}
    with pytest.raises(SystemExit) as exc:
        modules[cli].main(argv)
    assert exc.value.code not in (0, None)
    assert "--device cpu" in str(exc.value.code)

