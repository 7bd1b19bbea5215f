"""Data-parallel victim training of the PyTorch port on the CPU: the train
step split over `["cpu", "cpu"]` (two shards, two threads), against the
JAX package's train step on a batch sharded over two of the eight CPU
devices `conftest.py` makes, and against the port's unsplit step.

- (i) JAX's sharded step: `make_train_step` jitted over inputs placed by
  `parallel.shard_batch(..., data_parallel_mesh(2))`, XLA's statistics over
  the global batch. PointNet with the feature transform, PointNet with
  label smoothing, PointNet++ (the plain FPS and ball query) and DGCNN, 3
  steps at B = 4 (two shards of 2), N = 64, float64, the port fed JAX's
  variables and dropout masks: the masks a sharded apply draws are shown
  equal to the unsharded apply's (`jax_dropout_masks` on sharded and on
  plain clouds), and the split step draws the whole batch's through
  `split_draw`. Held as `test_train_steps_match_jax` holds the unsplit
  step: loss rtol 1e-5; batch_stats within 1e-5 of each tensor's largest
  entry + 1e-3 lr; Adam's count equal; params within 1e-5 of the largest
  entry + 1e-4 lr a step, a tensor whose gradient is 0 in exact
  arithmetic (below 1e-9 of the largest entry in JAX's step 1) within
  1e-2 lr; mu and the root of nu within 1e-5 of their largest entry +
  1e-9 of the largest gradient entry.
- (ii) The port's unsplit step, each of 3 steps from the split run's
  state (weights, statistics, Adam's moments and count): loss and
  accuracy within 1e-10 (relative); every gradient within 1e-10 of its
  tensor's largest entry, a tensor whose gradient is 0 but for rounding
  (below 1e-9 of the largest entry) within 1e-10 of the largest entry;
  batch statistics within 1e-10 of their largest entry. Two split runs
  are bit-equal (losses, weights, statistics).
- (iii) The control: the same split with each shard's own statistics
  (the exchange bypassed) misses (i)'s bound.
- (iv) `split_draw`: each shard's masks are the unsplit draw's rows, in
  the unsplit order, with the threads racing; a shard of another width
  raises.
- (v) A shard that raises inside its forward, while the other waits at
  the exchange, makes `run_shards` re-raise its error within a second
  (through the train step too); uneven exchanges and a wait past the
  limit raise.
- (vi) `cli/train.py` and `cli/hybrid_train.py` over `devices=["cpu",
  "cpu"]` against `--device cpu` (float32): the records' accuracies
  equal and the losses within 1e-5 (relative), a split `--resume` as the
  unsplit one, and the split `evaluate` the unsplit accuracies.

torch runs single-threaded here (ROADMAP.md section C).
"""

import copy
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from if_defense_tpu.models import build_model as jax_build_model
from if_defense_tpu.parallel import mesh as jax_mesh
from if_defense_tpu.training import create_train_state as jax_create
from if_defense_tpu.training import make_train_step as jax_make_step
from if_defense_tpu_torch import training
from if_defense_tpu_torch.cli import hybrid_train, train
from if_defense_tpu_torch.data import ModelNet40
from if_defense_tpu_torch.implicit import layers
from if_defense_tpu_torch.implicit.layers import BatchNorm
from if_defense_tpu_torch.models import build_model
from if_defense_tpu_torch.models.common import generator_draw, split_draw
from if_defense_tpu_torch.parallel import (
    ShardAborted,
    StatsExchange,
    current_exchange,
    run_shards,
)
from if_defense_tpu_torch.training import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from if_defense_tpu_torch.utils.params_io import (
    adam_state_to_jax,
    flatten_params,
    flax_init_params,
    params_from_jax,
    params_to_jax,
)
from test_torch_port_train_cli import argv, records, write_data
from test_torch_port_victim_training import (
    batches,
    jax_dropout_masks,
    replay,
    to_numpy,
    tree_max,
)
from test_torch_port_victims import perturbed

STEPS, B, N, LR = 3, 4, 64, 1e-3
TWO = ["cpu", "cpu"]
CASES = [("pointnet", {"feature_transform": True}, False),
         ("pointnet", {}, True), ("pointnet2", {}, False),
         ("dgcnn", {}, False)]
IDS = ["pointnet-ft", "pointnet-smoothing", "pointnet2", "dgcnn"]
SPLIT_TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """torch's CPU ops in one thread (see ROADMAP.md section C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_sharded_run(name, kw, smoothing, data) -> dict:
    """JAX's train step over 3 batches sharded over two CPU devices, in
    float64, from `create_train_state`'s variables (perturbed for the
    feature transform, whose regulariser has a NaN gradient at flax's
    init). -> {start, masks, losses, after: [(variables, adam)], grads
    (step 1's, from Adam's first moment), zero (the tensors whose step-1
    gradient is 0 but for rounding)}."""
    fea = 0.001 if kw.get("feature_transform") else 0.0
    mesh = jax_mesh.data_parallel_mesh(2)
    jm = jax_build_model(name, **kw)
    with jax.enable_x64(True):
        js = jax.jit(lambda x: jax_create(
            jm, jax.random.key(0), x, total_epochs=1,
            steps_per_epoch=STEPS))(data[0][0].astype(np.float32))
        if kw:
            js = js.replace(params=perturbed({"params": js.params},
                                             3)["params"])
        js = js.replace(
            params=jax.tree_util.tree_map(lambda a: jnp.asarray(
                a, jnp.float64), js.params),
            batch_stats=jax.tree_util.tree_map(lambda a: jnp.asarray(
                a, jnp.float64), js.batch_stats))
        js = js.replace(opt_state=js.tx.init(js.params))
        start = {"params": to_numpy(js.params),
                 "batch_stats": to_numpy(js.batch_stats)}
        jstep = jax_make_step(jm, smoothing, fea)
        keys = jax.random.split(jax.random.key(7), STEPS)
        sharded = [jax_mesh.shard_batch((pc, label), mesh)
                   for pc, label in data]
        masks = jax_dropout_masks(jm, start, [
            (pc, keys[i]) for i, (pc, _) in enumerate(data)])
        masks_sharded = jax_dropout_masks(jm, start, [
            (pc, keys[i]) for i, (pc, _) in enumerate(sharded)])
        losses, after = [], []
        for i, (pc, label) in enumerate(sharded):
            assert len(pc.sharding.device_set) == 2
            mu0 = to_numpy(js.opt_state[1].mu)
            js, m = jstep(js, pc, label, keys[i])
            losses.append(float(m["loss"]))
            after.append((to_numpy({"params": js.params,
                                    "batch_stats": js.batch_stats}),
                          to_numpy(js.opt_state[1])))
            if i == 0:      # Adam's first moment: mu = 0.1 (g + wd p)
                grads = jax.tree_util.tree_map(
                    lambda mu, m0, p: (np.asarray(mu) - 0.9 * m0) / 0.1
                    - 1e-4 * p, js.opt_state[1].mu, mu0, start["params"])
    # the sharded apply draws the unsharded apply's masks
    for step, step_sharded in zip(masks, masks_sharded):
        assert len(step) == len(step_sharded)
        for a, b in zip(step, step_sharded):
            np.testing.assert_array_equal(a, np.asarray(b))
    top = tree_max(grads)
    zero = {k for k, g in flatten_params(grads).items()
            if np.abs(g).max() < 1e-9 * top}
    return dict(start=start, masks=masks, losses=losses, after=after,
                top=top, zero=zero)


def port_state(name, kw, start):
    model = build_model(name, **kw)
    model.load_state_dict(params_from_jax(start, model), strict=True)
    model.double()
    return create_train_state(model, total_epochs=1, steps_per_epoch=STEPS)


def hold_to_jax(tag, state, m, want_loss, want_vars, want_adam, step, ref):
    """One step of the port against JAX's, with
    `test_train_steps_match_jax`'s tolerances (module docstring)."""
    model = state.model
    np.testing.assert_allclose(float(m["loss"]), want_loss, rtol=1e-5,
                               err_msg=f"{tag} loss")
    got_vars = params_to_jax(model.state_dict(), model)
    got = flatten_params(got_vars["batch_stats"])
    for k, w in flatten_params(want_vars["batch_stats"]).items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5 * np.abs(
            w).max() + 1e-3 * LR, err_msg=f"{tag} batch_stats {k}")
    adam = adam_state_to_jax(state.optimizer.state_dict(), model)
    assert int(adam["count"]) == int(want_adam.count) == step
    got_p = flatten_params(got_vars["params"])
    got_m, got_v = flatten_params(adam["mu"]), flatten_params(adam["nu"])
    want_m = flatten_params(to_numpy(want_adam.mu))
    want_v = flatten_params(to_numpy(want_adam.nu))
    noise = 1e-9 * ref["top"]
    for k, w in flatten_params(want_vars["params"]).items():
        atol = (1e-2 * LR if k in ref["zero"]
                else 1e-5 * np.abs(w).max() + 1e-4 * LR * step)
        np.testing.assert_allclose(got_p[k], w, rtol=0, atol=atol,
                                   err_msg=f"{tag} param {k}")
        np.testing.assert_allclose(
            got_m[k], want_m[k], rtol=0,
            atol=1e-5 * np.abs(want_m[k]).max() + noise,
            err_msg=f"{tag} mu {k}")
        np.testing.assert_allclose(
            np.sqrt(got_v[k]), np.sqrt(want_v[k]), rtol=0,
            atol=1e-5 * np.sqrt(want_v[k]).max() + noise,
            err_msg=f"{tag} sqrt nu {k}")


def split_run_against_jax(name, kw, smoothing, ref, data):
    """The port's train step split over TWO, from JAX's start, with JAX's
    masks, each step held to JAX's sharded step."""
    fea = 0.001 if kw.get("feature_transform") else 0.0
    state = port_state(name, kw, ref["start"])
    step = make_train_step(state.model, smoothing, fea, devices=TWO)
    for i, (pc, label) in enumerate(data):
        state, m = step(state, torch.from_numpy(pc),
                        torch.from_numpy(label).long(),
                        replay(ref["masks"][i]))
        assert 0 <= float(m["acc"]) <= 1
        want_vars, want_adam = ref["after"][i]
        hold_to_jax(f"{name} split step {i + 1}", state, m, ref["losses"][i],
                    want_vars, want_adam, i + 1, ref)


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's sharded runs by case id, each made once for the file."""
    refs = {}

    def get(case_id):
        if case_id not in refs:
            refs[case_id] = jax_sharded_run(*CASES[IDS.index(case_id)],
                                            batches(1))
        return refs[case_id]

    return get


@pytest.mark.parametrize("name,kw,smoothing", CASES, ids=IDS)
def test_split_steps_match_jax_sharded(name, kw, smoothing, jax_refs):
    """(i)"""
    ref = jax_refs(IDS[CASES.index((name, kw, smoothing))])
    split_run_against_jax(name, kw, smoothing, ref, batches(1))


def test_per_shard_statistics_miss_the_bound(monkeypatch, jax_refs):
    """(iii): with each shard's own batch statistics (the exchange
    bypassed in every batch norm) the split step is out of (i)'s bound:
    the test sees the fault it guards against."""
    data = batches(1)
    name, kw, smoothing = CASES[0]
    ref = jax_refs(IDS[0])
    monkeypatch.setattr(layers, "current_exchange", lambda: None)
    with pytest.raises(AssertionError):
        split_run_against_jax(name, kw, smoothing, ref, data)


def _copy_state(dst, src):
    """dst's weights, statistics, Adam state and count set to src's (a
    copy: `load_state_dict` keeps tensors of the same device and type)."""
    dst.model.load_state_dict(src.model.state_dict())
    dst.optimizer.load_state_dict(copy.deepcopy(src.optimizer.state_dict()))
    dst.set_step(src.step)


@pytest.mark.parametrize("name,kw,smoothing", [CASES[0], CASES[2],
                                               CASES[3]],
                         ids=[IDS[0], IDS[2], IDS[3]])
def test_split_step_matches_unsplit(name, kw, smoothing):
    """(ii): each step from the split run's state on one device, and a
    second split run bit-equal to the first."""
    fea = 0.001 if kw.get("feature_transform") else 0.0
    start = perturbed(flax_init_params(0, name, **kw), 4)
    runs = []
    for devices in (TWO, None, TWO):
        state = port_state(name, kw, start)
        runs.append((state, make_train_step(state.model, smoothing, fea,
                                            devices=devices)))
    (split, split_step), (one, one_step), (again, again_step) = runs
    gens = [torch.Generator().manual_seed(5) for _ in runs]
    for i, (pc, label) in enumerate(batches(2)):
        pc, label = torch.from_numpy(pc), torch.from_numpy(label).long()
        _copy_state(one, split)
        _, want = one_step(one, pc, label, generator_draw(gens[1]))
        _, got = split_step(split, pc, label, generator_draw(gens[0]))
        _, rerun = again_step(again, pc, label, generator_draw(gens[2]))
        tag = f"{name} step {i + 1}"
        for k in ("loss", "acc"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=SPLIT_TOL, err_msg=f"{tag} {k}")
            assert float(rerun[k]) == float(got[k]), (tag, k)
        grads = {n: p.grad for n, p in one.model.named_parameters()}
        top = max(float(g.abs().max()) for g in grads.values())
        for n, p in split.model.named_parameters():
            scale = float(grads[n].abs().max())
            scale = scale if scale >= 1e-9 * top else top
            err = float((p.grad - grads[n]).abs().max())
            assert err <= SPLIT_TOL * scale, (tag, n, err / scale)
        stats = dict(one.model.named_buffers())
        for n, b in split.model.named_buffers():
            err = float((b - stats[n]).abs().max())
            assert err <= SPLIT_TOL * float(stats[n].abs().max()), (tag, n)
        for (n, a), b in zip(split.model.state_dict().items(),
                             again.model.state_dict().values()):
            assert torch.equal(a, b), (tag, n)


def test_split_draw_takes_the_unsplit_rows():
    """(iv)"""
    sizes, calls = [3, 1, 2], [(6, 5), (6, 7), (6,)]
    want_gen = torch.Generator().manual_seed(9)
    want = [generator_draw(want_gen)(shape, 0.4) for shape in calls]
    draws = split_draw(generator_draw(torch.Generator().manual_seed(9)),
                       sizes)
    starts = [0, 3, 4]

    def shard(i, _):
        out = []
        for shape in calls:
            time.sleep(0.001 * ((i + len(out)) % 3))     # race the threads
            out.append(draws[i]((sizes[i], *shape[1:]), 0.4))
        return out

    got = run_shards(shard, [None] * 3, [torch.device("cpu")] * 3,
                     concat=False)
    for i, masks in enumerate(got):
        for k, m in enumerate(masks):
            assert torch.equal(m, want[k][starts[i]:starts[i] + sizes[i]]), \
                (i, k)
    with pytest.raises(ValueError):
        split_draw(generator_draw(torch.Generator()), [2, 2])[0]((3, 5), .5)


class _TwoNorms(nn.Module):
    """Dense + BatchNorm twice; shard `fail_in` raises before its second
    norm, or makes one norm more where `extra`."""

    def __init__(self, fail_in=None, extra=False):
        super().__init__()
        self.Dense_0, self.BatchNorm_0 = nn.Linear(3, 8), BatchNorm(8)
        self.Dense_1, self.BatchNorm_1 = nn.Linear(8, 4), BatchNorm(4)
        self.fail_in, self.extra = fail_in, extra

    def forward(self, x, draw=None):
        x = self.BatchNorm_0(self.Dense_0(x))
        shard = current_exchange()[1]
        if shard == self.fail_in:
            if self.extra:
                x = self.BatchNorm_0(x)
            else:
                time.sleep(0.2)            # the other shard waits first
                raise ValueError(f"shard {shard} fails")
        x = self.BatchNorm_1(self.Dense_1(x))
        return x.mean(1), {}


def _within(fn, seconds: float):
    """fn() in a thread that must end within `seconds`: -> (its exception
    or None, the seconds it took)."""
    out = {}

    def work():
        t0 = time.monotonic()
        try:
            fn()
        except BaseException as e:      # handed to the caller
            out["error"] = e
        out["seconds"] = time.monotonic() - t0

    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(timeout=seconds + 5)
    assert not t.is_alive(), "the split step hangs"
    return out.get("error"), out["seconds"]


def test_a_failing_shard_raises_without_a_hang():
    """(v)"""
    x = torch.randn(4, 5, 3, generator=torch.Generator().manual_seed(0))
    y = torch.tensor([0, 1, 2, 3])
    for fail_in in (0, 1):
        model = _TwoNorms(fail_in)
        state = create_train_state(model)
        step = make_train_step(model, devices=TWO)
        err, seconds = _within(lambda: step(state, x, y, None), 1.0)
        assert isinstance(err, ValueError) and str(err) == \
            f"shard {fail_in} fails", err
        assert seconds < 1.0
    # one shard exchanges once more than the other
    model = _TwoNorms(1, extra=True)
    step = make_train_step(model, devices=TWO)
    err, seconds = _within(lambda: step(create_train_state(model), x, y,
                                        None), 1.0)
    assert isinstance(err, RuntimeError) and "unevenly" in str(err), err
    # a shard that waits past the limit
    exchange = StatsExchange(TWO, timeout=0.2)

    def shard(i, _):
        with exchange.shard(i):
            if i == 1:
                time.sleep(0.6)
            exchange.all_sum(torch.ones(2, 3), 1)

    err, seconds = _within(lambda: run_shards(shard, [None] * 2, [
        torch.device("cpu")] * 2), 2.0)
    assert isinstance(err, TimeoutError), err
    # a ShardAborted comes second to the error that caused it
    assert issubclass(ShardAborted, RuntimeError)


def in_float64(monkeypatch):
    """The train CLI's victims in float64 (their inputs cast on entry), so
    that its records hold to (ii)'s tolerance: in float32 Adam turns the
    split's rounding differences into weight steps of either sign for
    gradients near its eps, and a few steps part the losses by ~1e-3."""
    build = train.build_model

    def build_double(name, **kw):
        model = build(name, **kw).double()
        model.register_forward_pre_hook(
            lambda module, args: (args[0].double(), *args[1:]))
        return model

    monkeypatch.setattr(train, "build_model", build_double)


def _cli_runs(tmp_path, name, main, extra=()):
    data = write_data(tmp_path / "toy.npz", 6)
    defended = write_data(tmp_path / "def.npz", 7)
    extra = [*extra, *(["--def_data", defended]
                       if main is hybrid_train.main else [])]
    out = {}
    for tag, devices in (("one", None), ("split", TWO)):
        path = tmp_path / f"{name}-{tag}"
        main(argv(data, path, tmp_path, "--epochs", "2", "--eval_every",
                  "1", *extra), devices=devices)
        out[tag] = path
    return data, out


def _same_records(a, b):
    ra, rb = records(a), records(b)
    assert len(ra) == len(rb)
    for x, y in zip(ra, rb):
        assert set(x) == set(y)
        for k, v in x.items():
            if k in ("time", "epoch_time"):
                continue
            if k == "train_loss":
                np.testing.assert_allclose(y[k], v, rtol=SPLIT_TOL,
                                           err_msg=k)
            else:
                assert y[k] == v, (k, y[k], v)


@pytest.mark.parametrize("cli", ["train", "hybrid_train"])
def test_clis_split_write_the_unsplit_records(cli, tmp_path, monkeypatch):
    """(vi): 2 epochs of PointNet, each batch of 4 split in two."""
    in_float64(monkeypatch)
    main = train.main if cli == "train" else hybrid_train.main
    _, out = _cli_runs(tmp_path, cli, main)
    _same_records(out["one"], out["split"])


def test_split_resume_and_evaluate(tmp_path, monkeypatch):
    """(vi): a split `--resume` continues as the unsplit one does, and the
    split eval step scores the padded test batches as the unsplit one."""
    in_float64(monkeypatch)
    data = write_data(tmp_path / "toy.npz", 8)
    first = tmp_path / "first"
    train.main(argv(data, first, tmp_path, "--epochs", "1"))
    resumed = {}
    for tag, devices in (("one", None), ("split", TWO)):
        resumed[tag] = tmp_path / f"resumed-{tag}"
        train.main(argv(data, resumed[tag], tmp_path, "--epochs", "2",
                        "--resume", str(first / "final.npz")),
                   devices=devices)
    _same_records(resumed["one"], resumed["split"])
    assert [r["epoch"] for r in records(resumed["split"])
            if "epoch" in r] == [2]

    model = build_model("pointnet")
    model.load_state_dict(params_from_jax(
        perturbed(flax_init_params(0, "pointnet"), 5), model))
    ds = ModelNet40(data, N, partition="test")        # 6 clouds: one padded
    accs = [train.evaluate(make_eval_step(model, devices), ds, 4)
            for devices in (None, TWO)]
    assert accs[0] == accs[1]
    assert os.path.exists(resumed["split"] / "final.npz")


def test_split_eval_step_follows_the_master(monkeypatch):
    """The split eval step's replicas copy the master's weights at its
    first call and after the master has moved (a load, a train step),
    and at no other call; each time it scores as the master does."""
    syncs = []
    sync = training._sync
    monkeypatch.setattr(training, "_sync",
                        lambda replicas: (syncs.append(1), sync(replicas)))
    model = build_model("pointnet")
    model.load_state_dict(params_from_jax(flax_init_params(0, "pointnet"),
                                          model))
    pc = torch.from_numpy(np.random.default_rng(0).normal(
        size=(B, N, 3)).astype(np.float32))
    split, one = make_eval_step(model, TWO), make_eval_step(model)

    def scores(expect_sync: bool):
        before = len(syncs)
        got, want = split(pc), one(pc)
        assert len(syncs) == before + expect_sync
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(
            want.abs().max()))
        return want

    first = scores(True)
    scores(False)
    model.load_state_dict(params_from_jax(
        perturbed(flax_init_params(0, "pointnet"), 5), model))
    assert not torch.allclose(scores(True), first)
    scores(False)
    state = create_train_state(model)
    step = make_train_step(model, devices=TWO)
    step(state, pc, torch.arange(B) % 40,
         generator_draw(torch.Generator().manual_seed(0)))
    scores(True)
    scores(False)
