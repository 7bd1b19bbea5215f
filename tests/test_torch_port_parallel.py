"""The port's batch sharding (`if_defense_tpu_torch.parallel`) and the
kernel wrappers' launch counters under threads, on the CPU.

- `best_data_mesh`, `get_mesh` and `visible_devices` on stubbed device
  lists, and `best_data_mesh`, `get_mesh` and `data_parallel_mesh` with
  eight stubbed cards against the JAX functions on the eight CPU devices
  that `conftest.py` makes; `shard_batch` and `replicate` round trips;
  `run_shards` re-raises the first shard's exception and keeps the
  caller's grad mode.
- `_build.launch` counts exactly when threads launch at once, and calls
  under the tensor's device; `_build.libraries` loads every library once
  when threads ask for them at once.
- Each eval CLI's library path at a tiny size with its batch split over
  `[cpu, cpu]` against one shard: bit-equal. The draws are made for the
  whole batch and split, and the defense's means over the batch divide by
  the whole batch's count, so nothing is left for a tolerance.
- `opt_defense`, `defend_npz` and `attack` with `--device cpu` (one shard)
  write what the library functions give when they draw for themselves.

torch runs single-threaded here (ROADMAP.md section C)."""

import functools
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from if_defense_tpu.parallel import mesh as jax_mesh
from if_defense_tpu_torch.cli import (
    attack,
    defend_npz,
    inference,
    opt_defense,
    remesh_defense,
)
from if_defense_tpu_torch.data import (
    ModelNet40Attack,
    ModelNet40NormalAttack,
    batch_iterator,
    save_npz,
)
from if_defense_tpu_torch.defense import DUPNet, sor_defense_fixed, srs_defense
from if_defense_tpu_torch.defense.ifdefense import convonet_opt_defense
from if_defense_tpu_torch.implicit import ConvOccupancyNetwork, OccupancyNetwork
from if_defense_tpu_torch.implicit import generation as tg
from if_defense_tpu_torch.models import build_model
from if_defense_tpu_torch.models.common import calibrate_batch_norm
from if_defense_tpu_torch.ops import _build
from if_defense_tpu_torch.parallel import (
    best_data_mesh,
    data_parallel_mesh,
    get_mesh,
    mesh_devices,
    replicate,
    run_shards,
    shard_batch,
    visible_devices,
)
from if_defense_tpu_torch.utils.checkpoint import save_eval_checkpoint
from if_defense_tpu_torch.utils.params_io import (
    flatten_params,
    flax_init_params,
    init_params,
    load_params_npz,
    params_from_jax,
    params_to_jax,
    save_params_npz,
    unflatten_params,
)

CPU = torch.device("cpu")
TWO = ["cpu", "cpu"]
B, N = 4, 64


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_visible_devices_and_meshes(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert visible_devices("cuda") == [torch.device("cuda", i)
                                       for i in range(3)]
    assert visible_devices(None) == visible_devices("cuda")
    assert visible_devices("cuda:1") == [torch.device("cuda", 1)]
    assert visible_devices("cpu") == [CPU]
    # the most devices that divide the batch
    assert best_data_mesh(6, "cuda").shape == {"dp": 3}
    assert best_data_mesh(4, "cuda").shape == {"dp": 2}
    assert best_data_mesh(7, "cuda").size == 1
    assert mesh_devices(best_data_mesh(8, ["cpu"] * 4)) == [CPU] * 4
    assert best_data_mesh(48, "cuda:2").size == 1
    mesh = get_mesh({"dp": 2, "mp": 1}, "cuda")
    assert mesh.devices.shape == (2, 1) and mesh.axis_names == ("dp", "mp")
    assert mesh_devices(mesh) == [torch.device("cuda", i) for i in range(2)]
    assert mesh_devices(get_mesh({"mp": 1, "dp": 3}, "cuda")) == \
        visible_devices("cuda")
    assert get_mesh(None, "cuda").shape == {"dp": 3}
    with pytest.raises(ValueError, match="needs 4 devices, have 3"):
        get_mesh({"dp": 2, "mp": 2}, "cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        visible_devices("cuda")


def _same_mesh(port, ref) -> None:
    """The port's mesh over stubbed cards against JAX's over CPU devices:
    size, axis sizes, axis names and the device indices in order."""
    assert port.size == ref.size
    assert port.shape == dict(ref.shape)
    assert port.axis_names == tuple(ref.axis_names)
    assert port.devices.shape == ref.devices.shape
    assert [d.index for d in port.devices.flat] == \
        [d.id for d in ref.devices.flat]


def test_data_meshes_match_jax(monkeypatch):
    """`best_data_mesh(b)` for b = 1..16 and `data_parallel_mesh(n)` over
    eight stubbed cards give JAX's meshes over its eight CPU devices."""
    import jax

    assert len(jax.devices()) == 8
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for b in range(1, 17):
        _same_mesh(best_data_mesh(b, "cuda"), jax_mesh.best_data_mesh(b))
    for n in (None, 1, 3, 8):
        _same_mesh(data_parallel_mesh(n, "cuda"),
                   jax_mesh.data_parallel_mesh(n))


@pytest.mark.parametrize("shape", [
    None, {"dp": 8}, {"dp": 4, "mp": 2}, {"mp": 2, "dp": 2},
    {"dp": 2, "mp": 2, "sp": 2}, {"dp": 3, "mp": 3},
])
def test_get_mesh_matches_jax(monkeypatch, shape):
    """`get_mesh(shape)` over eight stubbed cards against JAX's over its
    eight CPU devices, the error for a mesh of more devices included."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    try:
        ref = jax_mesh.get_mesh(shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            get_mesh(shape, "cuda")
        assert str(got.value) == str(e)
        return
    _same_mesh(get_mesh(shape, "cuda"), ref)


def test_shard_batch_and_replicate_round_trip():
    mesh = data_parallel_mesh(device=TWO)
    x = torch.arange(24.0).reshape(4, 2, 3)
    y = np.arange(4)
    shards = shard_batch({"x": x, "y": (y, None)}, mesh)
    assert len(shards) == 2 and torch.equal(shards[1]["x"], x[2:])
    assert torch.equal(shards[0]["y"][0], torch.as_tensor(y[:2]))
    assert shards[0]["y"][1] is None
    assert torch.equal(run_shards(lambda i, s: s["x"], shards,
                                  mesh_devices(mesh)), x)
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(torch.zeros(3, 2), mesh)

    model = torch.nn.Linear(3, 2)
    copies = replicate(model, mesh)
    assert copies[0] is model and copies[1] is not model
    assert all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), copies[1].state_dict().values()))
    assert copies[1].weight.data_ptr() != model.weight.data_ptr()
    tree = replicate({"w": x, "n": None}, mesh)
    assert len(tree) == 2 and tree[1]["w"] is x and tree[1]["n"] is None


def test_run_shards_reraises_and_keeps_modes():
    devices = [CPU] * 3

    def fn(i, x):
        if i >= 1:
            raise ValueError(f"shard {i}")
        return x * 2

    with pytest.raises(ValueError, match="shard 1"):
        run_shards(fn, [torch.ones(1)] * 3, devices)
    with pytest.raises(ValueError, match="shards for"):
        run_shards(fn, [torch.ones(1)] * 2, devices)
    with torch.no_grad():
        modes = run_shards(lambda i, x: [torch.is_grad_enabled()],
                           [0, 1, 2], devices, concat=False)
    assert modes == [[False]] * 3
    names = run_shards(lambda i, x: threading.current_thread().name,
                       [0, 1], devices[:2], concat=False)
    assert len(set(names)) == 2
    out = run_shards(lambda i, x: (x + i, np.full(2, i)),
                     list(torch.zeros(3, 1, 2)), devices)
    assert torch.equal(out[0], torch.tensor([[0.0, 0.0], [1, 1], [2, 2]]))
    assert out[1].tolist() == [0, 0, 1, 1, 2, 2]


def test_launch_counts_exact_under_threads(monkeypatch):
    """Eight threads launch 2000 times each through `_build.launch` (the
    helper every wrapper calls) with a short switch interval, into a
    counter whose read gives the interpreter away (so an unlocked
    read-modify-write loses counts): the count is exact, each call ran
    under its tensor's device and got that device's stream, and a failed
    launch still counts and raises."""
    seen = []

    class Counter(dict):
        def __getitem__(self, key):
            value = super().__getitem__(key)
            time.sleep(0)                  # another thread may run here
            return value

    class Stream:
        cuda_stream = 7

    def device_ctx(device):
        seen.append(device)
        return torch.no_grad()          # any context manager

    monkeypatch.setattr(torch.cuda, "device", device_ctx)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: Stream())
    launches = Counter(k=0)
    t = torch.zeros(1)
    calls = []

    def fn(a, b, stream):
        calls.append(stream)
        return 0

    def work():
        for _ in range(2000):
            _build.launch("fps", "test", fn, (1, 2), t, launches, "k")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert launches["k"] == 16000
    assert len(seen) == 16000 and set(seen) == {t.device}
    assert set(calls) == {7}
    monkeypatch.setattr(_build, "check", lambda lib, err, what: (
        _ for _ in ()).throw(RuntimeError(f"{what}: {err}")) if err else None)
    with pytest.raises(RuntimeError, match="bad: 3"):
        _build.launch("fps", "bad", lambda a, s: 3, (0,), t, launches, "k")
    assert launches["k"] == 16001


def test_libraries_load_once_under_threads(monkeypatch, tmp_path):
    """Eight threads bind a kernel's function at once while the libraries
    load slowly: every thread gets the whole set, each library is loaded
    once, and no thread sees the set half filled."""
    sources = sorted(_build.CSRC.glob("*.cu"))
    out = tmp_path / _build._digest()
    out.mkdir()
    (out / "done").write_text("ok\n")
    for src in sources:
        (out / f"{src.stem}.log").write_text("")
    loaded = []

    class SlowLibrary:
        def __init__(self, path):
            time.sleep(0.02)
            loaded.append(path)

        def __getattr__(self, name):
            return lambda *a: 0

    monkeypatch.setattr(_build, "BUILD", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_info", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", SlowLibrary)
    last = sources[-1].stem
    errors, bound = [], []

    def work():
        try:
            bound.append(_build.bind(last, "fn", []))
        except Exception as e:          # collected, asserted below
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not errors and len(bound) == 8
    assert sorted(loaded) == sorted(
        str(out / f"lib{src.stem}.so") for src in sources)
    assert set(_build.libraries()) == {src.stem for src in sources}
    assert _build.build_info["cached"] is True


def _clouds(n_clouds, n=N, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n_clouds, n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pc = d * rng.uniform(0.4, 1.0, (n_clouds, 1, 3))
    pc[:, :3] *= 2.5                                   # outliers for SOR
    return pc.astype(np.float32)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Six clouds (a padded tail batch at B = 4) and their labels."""
    tmp = tmp_path_factory.mktemp("parallel")
    label = np.arange(6) % 40
    path = save_npz(str(tmp / "x.npz"), {
        "test_pc": _clouds(6), "test_label": label,
        "target_label": (label + 3) % 40})
    return tmp, path


def _both(run, tmp, path):
    """run(data path, devices) unsplit, then over [cpu, cpu], each on a
    copy of the data in its own directory -> the two results."""
    out = []
    for name, devices in (("one", None), ("two", TWO)):
        d = tmp / f"{run.__name__}-{name}"
        d.mkdir(exist_ok=True)
        src = str(d / "x.npz")
        with open(path, "rb") as f, open(src, "wb") as g:
            g.write(f.read())
        out.append(run(src, devices))
    return out


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _equal_files(a, b):
    a, b = _npz(a), _npz(b)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("variant", ["convonet", "onet"])
def test_opt_defense_split_equals_unsplit(data, variant):
    """ConvONet-Opt and ONet-Opt (reference mode, 4 steps) with each batch
    over [cpu, cpu]: bit-equal to one device, and the metrics' losses
    (the shards' parts summed) within f32 rounding of the unsplit ones."""
    tmp, path = data
    weights = save_params_npz(str(tmp / f"{variant}-w.npz"),
                              init_params(0) if variant == "convonet"
                              else flax_init_params(0, "onet"))
    argv = ["--variant", variant, "--weights", weights, "--device", "cpu",
            "--batch_size", str(B), "--iterations", "4",
            "--sample_npoint", "64"]

    def run(src, devices):
        (out,) = opt_defense.main(["--data_root", src, *argv],
                                  devices=devices)
        with open(out + ".metrics.jsonl") as f:
            return out, json.loads(f.readline())

    (a, ma), (b, mb) = _both(run, tmp, path)
    _equal_files(a, b)
    assert (ma["devices"], mb["devices"]) == (1, 2)
    for k in ("occ_loss_first", "occ_loss_last"):
        assert mb[k] == pytest.approx(ma[k], rel=1e-6)


def test_opt_defense_one_device_is_the_library_path(data):
    """`opt_defense --device cpu` (a mesh of one) writes what the unsplit
    library defense gives on the same generator, bit for bit."""
    tmp, path = data
    weights = save_params_npz(str(tmp / "lib-w.npz"), init_params(0))
    (out,) = opt_defense.main(["--data_root", path, "--weights", weights,
                               "--device", "cpu", "--batch_size", "6",
                               "--iterations", "3", "--sample_npoint", "64"])
    model = ConvOccupancyNetwork()
    model.load_state_dict(params_from_jax(init_params(0), model))
    defend = convonet_opt_defense(model.eval(), iterations=3,
                                  sample_npoint=64)
    gen = torch.Generator().manual_seed(1)
    want = defend(torch.from_numpy(_clouds(6)), gen).numpy()
    assert np.array_equal(_npz(out)["test_pc"], want)


def test_defend_npz_split_equals_unsplit(data):
    """SRS, SOR and DUP-Net (the repository's PU-Net) with each batch over
    [cpu, cpu]: bit-equal (SRS's and DUP-Net's uniforms drawn for the
    whole batch, then split)."""
    tmp, path = data

    def run(src, devices):
        return defend_npz.main(["--data_root", src, "--device", "cpu",
                                "--batch_size", str(B), "--npoint", "32",
                                "--srs_drop_num", "16"], devices=devices)

    one, two = _both(run, tmp, path)
    assert len(one) == 3
    for a, b in zip(one, two):
        _equal_files(a, b)


def _padded_batches(pc: np.ndarray, fn) -> np.ndarray:
    """fn(batch tensor) over batches of B, the tail padded with copies of
    its last cloud and cut back, as the CLIs batch."""
    outs = []
    for i in range(0, len(pc), B):
        batch = pc[i : i + B]
        pad = B - len(batch)
        if pad:
            batch = np.concatenate([batch, batch[-1:].repeat(pad, 0)], 0)
        outs.append(fn(torch.from_numpy(batch)).numpy()[: B - pad])
    return np.concatenate(outs, 0)


def test_defend_npz_one_device_is_the_library_path(data):
    """`defend_npz --device cpu` (a mesh of one) writes what
    `srs_defense`, `sor_defense_fixed` and DUP-Net give when they draw
    from the file's generator themselves, bit for bit."""
    tmp, path = data
    d = tmp / "defend-lib"
    d.mkdir(exist_ok=True)
    src = save_npz(str(d / "x.npz"), dict(_npz(path)))
    paths = defend_npz.main(["--data_root", src, "--device", "cpu",
                             "--batch_size", str(B), "--npoint", "32",
                             "--srs_drop_num", "16"])
    dup = DUPNet(sor_k=2, sor_alpha=1.1, npoint=32, up_ratio=4)
    dup.pu_net.load_state_dict(params_from_jax(
        load_params_npz(defend_npz.DEFAULT_PUNET_WEIGHTS), dup.pu_net))
    dup.eval()
    gens = {name: torch.Generator().manual_seed(1)
            for name in ("srs", "dup")}
    want = {
        "srs": lambda x: srs_defense(x, 16, gens["srs"]),
        "sor": lambda x: sor_defense_fixed(x, 2, 1.1)[0],
        "dup": lambda x: dup(x, gens["dup"]),
    }
    with torch.inference_mode():
        for name, out in zip(("srs", "sor", "dup"), paths):
            assert np.array_equal(_npz(out)["test_pc"],
                                  _padded_batches(_clouds(6), want[name]))


@pytest.fixture(scope="module")
def victim(data):
    tmp, _ = data
    model = build_model("pointnet").eval()
    calibrate_batch_norm(model, torch.from_numpy(_clouds(8, seed=3)))
    return save_eval_checkpoint(str(tmp / "victim.npz"), params_to_jax(
        model.state_dict(), model), {"model": "pointnet"})


def test_inference_split_equals_unsplit(data, victim):
    """`cli.inference` (PointNet, both modes) with each batch over
    [cpu, cpu]: the same metrics record; the split eval step's logits
    bit-equal to the unsplit one's."""
    tmp, path = data
    for mode in ("normal", "target"):
        argv = ["--data", path, "--checkpoint", victim, "--num_points",
                str(N), "--batch_size", str(B), "--mode", mode,
                "--device", "cpu"]
        assert inference.main(argv) == inference.main(argv, devices=TWO)
    args = inference.parse_args(argv)
    pc = torch.from_numpy(_clouds(B))
    _, _, one = inference._load_eval_cached(args, best_data_mesh(B, "cpu"))
    _, _, two = inference._load_eval_cached(args, best_data_mesh(B, TWO))
    assert torch.equal(one(pc), two(pc))


@functools.lru_cache(maxsize=2)
def _mesh_weights(variant: str) -> dict:
    """flax-initialised weights, perturbed, whose surface crosses the
    lattice (the output bias moved to the median logit)."""
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
        c = model.eval().encode_inputs(torch.from_numpy(_clouds(2) * 0.3))
        grid = torch.from_numpy(tg.make_grid(8, 1.1).reshape(1, -1, 3))
        vals = model.decode(grid.expand(2, -1, 3), c).numpy()
    flat["params/decoder/fc_out/bias"] += np.float32(
        tg.logit_threshold(0.2) - np.median(vals))
    return unflatten_params(flat)


@pytest.mark.parametrize("variant,extra", [
    ("convonet", ["--wire", "sparse"]),
    ("convonet", ["--sample_mode", "mesh"]),
    ("onet", ["--wire", "int8"]),
])
def test_remesh_split_equals_unsplit(data, variant, extra):
    """`cli.remesh_defense` at a 17^3 lattice with each batch over
    [cpu, cpu] (SOR and the encoder subset for the whole batch, each
    share encoded and evaluated apart, the host's numpy stream as
    before): bit-equal, the sparse wire's per-share block budgets and the
    mesh mode included."""
    tmp, path = data
    weights = save_params_npz(str(tmp / f"mesh-{variant}.npz"),
                              _mesh_weights(variant))

    def run(src, devices):
        (out,) = remesh_defense.main(
            ["--variant", variant, "--data_root", src, "--weights", weights,
             "--device", "cpu", "--batch_size", str(B), "--resolution0",
             "8", "--upsample", "2", "--sample_npoint", "128",
             "--host_workers", "2", *extra], devices=devices)
        return out

    a, b = _both(run, tmp, path)
    _equal_files(a, b)


# (attack, flags) at tiny iteration counts, 160-point clouds (kNN's with
# normals); two binary steps where the family searches
ATTACK_SPLITS = [
    ("perturb", ["--binary_step", "2", "--num_iter", "2"]),
    ("add", ["--binary_step", "2", "--num_iter", "2", "--num_add", "16"]),
    ("add_cluster", ["--binary_step", "2", "--num_iter", "2"]),
    ("add_object", ["--binary_step", "2", "--num_iter", "2"]),
    ("knn", ["--num_iter", "3"]),
    ("fgm", []),
    ("mifgm", ["--num_iter", "3"]),
    ("pgd", ["--num_iter", "3"]),
    ("drop", ["--num_drop", "10"]),
]


def _attack_data(tmp, name: str) -> str:
    """Six 160-point clouds (with normals for kNN), labels and targets."""
    rng = np.random.default_rng(2)
    pc = (rng.normal(size=(6, 160, 3)) * 0.4).astype(np.float32)
    if name == "knn":
        nrm = rng.normal(size=pc.shape)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        pc = np.concatenate([pc, nrm.astype(np.float32)], -1)
    label = np.arange(6) % 40
    return save_npz(str(tmp / f"attack-{name}.npz"), {
        "test_pc": pc, "test_label": label, "target_label": (label + 5) % 40})


def _attack_argv(name, src, victim, extra) -> list:
    return ["--attack", name, "--data", src, "--checkpoint", victim,
            "--num_points", "160", "--batch_size", str(B), "--output",
            src + ".adv.npz", "--device", "cpu", *extra]


@pytest.mark.parametrize("name,extra", ATTACK_SPLITS)
def test_attack_split_equals_unsplit(data, victim, name, extra):
    """`cli.attack` with each batch over [cpu, cpu]: the same adversarial
    npz bit for bit and the same success rate (the generator's draws, and
    the cluster and object attacks' numpy inits, made for the whole batch,
    the attacks' means over the whole batch's count)."""
    tmp, _ = data
    path = _attack_data(tmp, name)

    def run(src, devices):
        return attack.main(_attack_argv(name, src, victim, extra),
                           devices=devices)

    (a, ra), (b, rb) = _both(run, tmp, path)
    _equal_files(a, b)
    assert ra == rb


@pytest.mark.parametrize("name,extra", ATTACK_SPLITS)
def test_attack_one_device_is_the_library_path(data, victim, name, extra):
    """`cli.attack --device cpu` (a mesh of one): its first batch is what
    `build_attack`'s run gives when the attack draws from the batch's
    generator (and makes its own inits) itself, bit for bit."""
    tmp, _ = data
    d = tmp / f"attack-lib-{name}"
    d.mkdir(exist_ok=True)
    src = _attack_data(d, name)
    argv = _attack_argv(name, src, victim, extra)
    out, _ = attack.main(argv)
    args = attack.parse_args(argv)
    model, _ = attack.load_eval_model(victim, args.model)
    model.requires_grad_(False)
    run, mode = attack.build_attack(
        args, *attack._victim_fns(model, args.victim_dtype))
    ds = (ModelNet40NormalAttack if mode == "target_normal"
          else ModelNet40Attack)(src, 160)
    (batch, _), *_ = batch_iterator(ds, B, pad_last=True)
    pc = torch.from_numpy(np.ascontiguousarray(batch[0][..., :3]))
    normal = (torch.from_numpy(np.ascontiguousarray(batch[0][..., 3:6]))
              if batch[0].shape[-1] > 3 else None)
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        adv, _ = run(pc, torch.as_tensor(batch[1]).long(),
                     torch.as_tensor(batch[2]).long(), normal,
                     attack.batch_generator(args.seed, 0, CPU))
    finally:
        torch.use_deterministic_algorithms(deterministic)
    assert np.array_equal(_npz(out)["test_pc"][:B], adv.detach().numpy())
