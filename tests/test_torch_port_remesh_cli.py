"""The port's mesh-restoration CLI (`cli/remesh_defense.py`) against the JAX
package's on the CPU.

The weights are one flat npz per variant at the CLI's widths (ConvONet
c_dim 32 with 64x64 planes, ONet c_dim 512 and decoder 256), drawn from
flax's init distributions with every tensor perturbed and the output bias
moved so that the occupancy field crosses the threshold; the same file runs
in both CLIs. The data are 4 clouds of 128 points, `--resolution0 8
--upsample 2 --input_npoint 32 --sample_npoint 64`, one batch of 4.
`jax.random` cannot be reproduced in torch, so JAX's encoder subsets are
computed here the JAX CLI's way and handed to the port's `main` through
its `draws` seam.

Tolerances: on the int8 wire the samples are bit-identical but for clouds
whose int8 value grids differ between the packages, where each differing
entry is one quantum apart (a logit within f32 rounding of a quantum
boundary; such clouds are counted, none at these seeds); on the bf16 wire
each cloud's Chamfer distance to JAX's is <= 1e-4 and >= 99 % of the
coordinates lie within 1e-4. Port against port (thread count, the sparse
wire's clipped fallback) is bit-identical.
"""

import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from if_defense_tpu.cli import remesh_defense as jrd
from if_defense_tpu.defense.ifdefense import sample_valid as jax_sample_valid
from if_defense_tpu.defense.sor import sor_defense as jax_sor
from if_defense_tpu.implicit import generation as jg
from if_defense_tpu.ops import normalize_unit_cube as jax_cube
from if_defense_tpu_torch.cli import remesh_defense as rd
from if_defense_tpu_torch.data import load_npz, save_npz
from if_defense_tpu_torch.implicit import ConvOccupancyNetwork, OccupancyNetwork
from if_defense_tpu_torch.implicit import generation as tg
from if_defense_tpu_torch.utils.meshio import load_off
from if_defense_tpu_torch.utils.params_io import (
    flatten_params,
    flax_init_params,
    params_from_jax,
    save_params_npz,
    unflatten_params,
)

N_CLOUDS, N_POINTS = 4, 128
SMALL = ["--resolution0", "8", "--upsample", "2", "--input_npoint", "32",
         "--sample_npoint", "64", "--batch_size", "4"]
INPUT_N = 32


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """torch's CPU ops in one thread (ROADMAP.md section C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clouds():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(N_CLOUDS, N_POINTS, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pc = d * rng.uniform(0.4, 1.0, (N_CLOUDS, 1, 3))
    pc[:, :4] *= 2.5                                   # outliers for SOR
    return pc.astype(np.float32)


@functools.lru_cache(maxsize=2)
def _weights_tree(variant: str) -> dict:
    rng = np.random.default_rng(5)
    flat = flatten_params(flax_init_params(1, variant))
    flat = {k: (v * np.exp(0.2 * rng.normal(size=v.shape)) if k.endswith("/var")
                else v + (0.3 / np.sqrt(np.prod(v.shape[:-1])) if v.ndim > 1
                          else 0.05) * rng.normal(size=v.shape)
                ).astype(np.float32)
            for k, v in flat.items()}
    model = ConvOccupancyNetwork() if variant == "convonet" else \
        OccupancyNetwork()
    model.load_state_dict(params_from_jax(unflatten_params(flat), model))
    with torch.no_grad():
        c = model.eval().encode_inputs(torch.from_numpy(
            _clouds()[:, :INPUT_N] * 0.3))
        grid = torch.from_numpy(tg.make_grid(8, 1.1).reshape(1, -1, 3))
        vals = model.decode(grid.expand(N_CLOUDS, -1, 3), c).numpy()
    flat["params/decoder/fc_out/bias"] += np.float32(
        tg.logit_threshold(0.2) - np.median(vals))
    return unflatten_params(flat)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("remesh_cli")
    out = {"tmp": tmp}
    for v in ("convonet", "onet"):
        out[v] = save_params_npz(str(tmp / f"{v}.npz"), _weights_tree(v))
    label = np.arange(N_CLOUDS) % 40
    out["data"] = save_npz(str(tmp / "x.npz"), {
        "test_pc": _clouds(), "test_label": label,
        "target_label": (label + 3) % 40})
    return out


def _copy(files, tmp_path, name):
    """The data npz in a directory of its own (outputs land beside it)."""
    d = tmp_path / name
    d.mkdir()
    return str(shutil.copy(files["data"], d / "x.npz"))


def _jax_draws(pc: np.ndarray, seed: int = 1) -> list:
    """JAX's encoder subsets, one per batch of 4, as its CLI draws them
    (`defend_clouds`, `remesh_batch`)."""
    key = jax.random.key(seed)
    draws = []
    for i in range(0, len(pc), 4):
        key, sub = jax.random.split(key)
        p, mask = jax_sor(jnp.asarray(pc[i : i + 4]), 2, 1.1)
        proc = jax_cube(p, 0.9, mask)
        k_enc, _ = jax.random.split(sub)
        draws.append(torch.from_numpy(np.array(
            jax_sample_valid(proc, mask, INPUT_N, k_enc))))
    return draws


def _both(files, tmp_path, variant, *extra):
    """(JAX CLI's clouds, port CLI's clouds, JAX's encoder subsets)."""
    argv = ["--variant", variant, "--weights", files[variant], *SMALL,
            *extra]
    jpath, = jrd.main(["--data_root", _copy(files, tmp_path, "jax"), *argv])
    draws = _jax_draws(_clouds())
    path, = rd.main(["--data_root", _copy(files, tmp_path, "port"), *argv,
                     "--device", "cpu"], draws=iter(draws))
    return load_npz(jpath).test_pc, load_npz(path).test_pc, draws


def _int8_grids(files, variant, draws):
    """Both packages' int8 value grids ([B, ...] as integer quanta) from
    JAX's encoder subsets: (port, JAX)."""
    tree = _weights_tree(variant)
    jm = jrd.build_model(jrd.parse_args(
        ["--variant", variant, "--data_root", "x", "--weights",
         files[variant]]))[0]
    sel = draws[0].numpy()
    jc = jm.apply(tree, jnp.asarray(sel), method="encode_inputs")
    model = ConvOccupancyNetwork() if variant == "convonet" else \
        OccupancyNetwork()
    model.load_state_dict(params_from_jax(tree, model))
    model.eval()
    with torch.no_grad():
        c = model.encode_inputs(draws[0])
    kw = dict(resolution0=8, upsample=2, wire="int8")
    iso = tg.logit_threshold(0.2)
    if variant == "convonet":
        got = tg.compute_value_grids(None, model, c, dense_eval_fn=(
            tg.make_convonet_dense_eval(model, 16, 1.1)), **kw)[0]
        want = jg.compute_value_grids(None, tree, jc, dense_eval_fn=(
            jg.make_convonet_dense_eval(jm, 16, 1.1)), **kw)[0]
        return got.astype(int), np.asarray(want).astype(int)
    got = tg.compute_value_grids(lambda m, p, cc: m.decode(p, cc), model, c,
                                 **kw)[0]
    want = jg.compute_value_grids(
        lambda v, p, cc: jm.apply(v, p, cc, method="decode"), tree, jc,
        **kw)[0]
    return (np.round((got - iso) * 16).astype(int),
            np.round((want - iso) * 16).astype(int))


def test_parse_args_matches_jax():
    base = ["--data_root", "x.npz", "--weights", "w.npz"]
    got = vars(rd.parse_args(base))
    assert got.pop("device") == "cuda"
    assert got == vars(jrd.parse_args(base))
    flags = ["--variant", "convonet", "--train", "--sample_npoint", "512",
             "--input_npoint", "100", "--padding_scale", "0.8",
             "--threshold", "0.3", "--resolution0", "16", "--upsample", "2",
             "--batch_size", "8", "--no_sor", "--sor_k", "3", "--sor_alpha",
             "1.2", "--seed", "4", "--compute_dtype", "bfloat16", "--wire",
             "sparse", "--sparse_blocks", "64", "--sample_mode", "mesh",
             "--save_mesh", "m", "--mesh_format", "ply", "--host_workers",
             "3"]
    got = vars(rd.parse_args(base + flags + ["--device", "cpu"]))
    assert got.pop("device") == "cpu"
    assert got == vars(jrd.parse_args(base + flags))


def test_cli_needs_a_card_or_device_cpu(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        rd.main(["--data_root", files["data"], "--weights",
                 files["onet"]])


@pytest.mark.parametrize("variant", ["convonet", "onet"])
def test_int8_wire_matches_jax_cli(variant, files, tmp_path):
    want, got, draws = _both(files, tmp_path, variant, "--wire", "int8")
    assert got.shape == want.shape == (N_CLOUDS, 64, 3)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1).max(1), 1.0,
                               atol=1e-5)
    differs = [b for b in range(N_CLOUDS)
               if not np.array_equal(got[b], want[b])]
    print(f"{variant}: {len(differs)} clouds differ from JAX's")
    if differs:
        # only clouds whose int8 grid differs, by one quantum at entries
        # that straddle a quantum boundary
        g_port, g_jax = _int8_grids(files, variant, draws)
        assert np.abs(g_port - g_jax).max() <= 1
        grid_differs = (g_port != g_jax).reshape(N_CLOUDS, -1).any(-1)
        assert grid_differs[differs].all()
        assert len(differs) <= 1


def _chamfer(a, b):
    d = ((a[:, :, None] - b[:, None]) ** 2).sum(-1)
    return d.min(2).mean(1) + d.min(1).mean(1)


@pytest.mark.parametrize("variant", ["convonet", "onet"])
def test_bf16_wire_close_to_jax_cli(variant, files, tmp_path):
    want, got, _ = _both(files, tmp_path, variant)
    assert np.isfinite(got).all()
    assert _chamfer(got.astype(np.float64), want).max() <= 1e-4
    assert (np.abs(got - want) <= 1e-4).mean() >= 0.99


def _port(files, src, *extra, variant="convonet"):
    path, = rd.main(["--variant", variant, "--data_root", src, "--weights",
                     files[variant], *SMALL, "--device", "cpu", *extra])
    return path, load_npz(path).test_pc.copy()


def test_threads_and_sparse_fallback_bit_identical(files, tmp_path):
    """--host_workers 1 and 4 give the same bits; so do --wire sparse with
    a 1-block budget (every cloud falls back to the int8 grid) and --wire
    int8 (`tests/test_cli_e2e.py:251-299`)."""
    src = _copy(files, tmp_path, "a")
    _, serial = _port(files, src, "--wire", "int8", "--host_workers", "1")
    _, threaded = _port(files, src, "--wire", "int8", "--host_workers", "4")
    np.testing.assert_array_equal(threaded, serial)
    _, sparse = _port(files, src, "--wire", "sparse", "--sparse_blocks", "1")
    np.testing.assert_array_equal(sparse, serial)
    _, adaptive = _port(files, src, "--wire", "sparse")
    np.testing.assert_array_equal(adaptive, serial)
    with pytest.raises(SystemExit, match="--wire sparse needs"):
        _port(files, src, "--wire", "sparse", variant="onet")


def test_save_mesh_and_metrics(files, tmp_path):
    """--save_mesh writes one loadable mesh a cloud inside the padded box;
    the metrics record has the JAX CLI's keys; mesh sampling mode runs."""
    src = _copy(files, tmp_path, "m")
    mesh_dir = str(tmp_path / "meshes")
    path, out = _port(files, src, "--sample_mode", "mesh", "--save_mesh",
                      mesh_dir, variant="onet")
    assert path == os.path.join(os.path.dirname(src), "ONet-Mesh",
                                "onet_remesh-x.npz")
    assert out.shape == (N_CLOUDS, 64, 3) and np.isfinite(out).all()
    export = os.path.join(mesh_dir, "x", "test")
    names = sorted(os.listdir(export))
    assert len(names) == N_CLOUDS
    for name in names:
        v, t = load_off(os.path.join(export, name))
        assert len(v) and len(t) and t.max() < len(v)
        assert np.abs(v).max() <= 0.55 + 1.1 / 16 + 1e-6
    rec = json.loads(open(path + ".metrics.jsonl").readline())
    jpath, = jrd.main(["--variant", "onet", "--data_root",
                       _copy(files, tmp_path, "j"), "--weights",
                       files["onet"], *SMALL, "--wire", "int8"])
    want = json.loads(open(jpath + ".metrics.jsonl").readline())
    assert rec.keys() == want.keys()
    assert rec["variant"] == want["variant"] == "onet-mesh"
    assert rec["clouds"] == N_CLOUDS and rec["clouds_per_sec"] > 0
