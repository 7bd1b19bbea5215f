"""Implicit-network training and ONet, PyTorch port vs JAX package.

- Weights: `params_to_jax` inverts `params_from_jax` bit for bit;
  `flax_init_params` has flax's keys, shapes, zeros and ones, and kernel
  stds within 15 % of flax's (kernels of >= 1024 entries).
- The batch sampler gives JAX's batches bit for bit.
- ONet's layers and networks against JAX with every tensor perturbed
  (flax's zero-initialised `fc_1` and CBN kernels would hide half of each
  block), in train mode (batch statistics, updated running averages) and
  eval mode: layers rtol 1e-5, atol 1e-6; networks rtol 1e-4, atol 1e-5
  (f32 on both sides, sums in other orders).
- Training: the same perturbed tree in both frameworks and JAX's own
  batches, ConvONet at c_dim/hidden 8 with 16x16 planes and ONet at c_dim
  and hidden 32, decoder 16. Step 1's loss (rtol 1e-5) and gradients per
  tensor (rtol 1e-4, atol 1e-5 of the tensor's largest entry; JAX's are
  read back from Adam's first moment, mu = 0.1 g after one step; a bias
  that feeds a batch norm has gradient 0 up to rounding in both); the
  losses of 3 steps (rtol 1e-4: Adam's early steps are about lr sign(g),
  so a gradient within rounding of 0 moves a weight either way); ONet's
  batch statistics after 3 train-mode steps along JAX's own parameters
  (rtol 1e-4, atol 1e-6). Along the port's own parameters they would
  differ by the Adam steps of those zero-gradient biases, whose sign is
  rounding noise in each framework and which shift the batch means.
- The training CLI on the CPU at a tiny size: its npz loads into JAX's
  model, whose logits equal the port's (atol 1e-5).

Each JAX train step compiles once per module (a module-scoped fixture).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from if_defense_tpu.implicit import ConvOccupancyNetwork as JaxConvONet
from if_defense_tpu.implicit import OccupancyNetwork as JaxONet
from if_defense_tpu.implicit import layers as jax_layers
from if_defense_tpu.implicit import onet as jax_onet
from if_defense_tpu.implicit.training import (
    OccupancyBatchSampler as JaxSampler,
)
from if_defense_tpu.implicit.training import (
    init_occupancy_model as jax_init_model,
)
from if_defense_tpu.implicit.training import (
    make_occupancy_train_step as jax_train_step,
)
from if_defense_tpu.utils.params_io import load_params_npz as jax_load_params
from if_defense_tpu_torch.cli import train_implicit
from if_defense_tpu_torch.implicit import (
    CBatchNorm,
    ConvOccupancyNetwork,
    CResnetBlockConv1d,
    DecoderCBatchNorm,
    OccupancyNetwork,
    ResnetBlockConv1d,
    ResnetPointnet,
)
from if_defense_tpu_torch.implicit.training import (
    OccupancyBatchSampler,
    make_occupancy_train_step,
)
from if_defense_tpu_torch.utils.params_io import (
    flatten_params,
    flax_init_params,
    load_params_npz,
    params_from_jax,
    params_to_jax,
    unflatten_params,
)

LR, STEPS, BATCH = 1e-4, 3, 2
VARIANTS = {
    "convonet": (lambda: JaxConvONet(8, 8, 16),
                 lambda: ConvOccupancyNetwork(8, 8, 16)),
    "onet": (lambda: JaxONet(32, 32, 16),
             lambda: OccupancyNetwork(32, 32, 16)),
}


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
    """Flax variables with every tensor moved off its init: kernels by
    0.3/sqrt(fan_in), other params and running means by 0.05, running
    variances scaled by exp(0.2 N(0, 1)) so they stay positive."""
    rng = np.random.default_rng(seed)
    flat = flatten_params(jax.tree_util.tree_map(np.asarray, variables))
    out = {}
    for k, v in flat.items():
        noise = rng.normal(size=v.shape)
        if k.endswith("/var"):
            v = v * np.exp(0.2 * noise)
        elif v.ndim > 1:
            v = v + 0.3 / np.sqrt(np.prod(v.shape[:-1])) * noise
        else:
            v = v + 0.05 * noise
        out[k] = v.astype(np.float32)
    return unflatten_params(out)


def _init(jm, *args):
    """`jm.init` on numpy arguments, jitted (eager init of a ConvONet
    takes longer than compiling it)."""
    return jax.jit(jm.init)(jax.random.key(0), *map(jnp.asarray, args))


def _port(module, variables):
    module.load_state_dict(params_from_jax(variables), strict=True)
    return module


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got)
                                          else got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _stats_close(module, want, rtol, atol):
    got = flatten_params(params_to_jax(module.state_dict())["batch_stats"])
    want = flatten_params(jax.tree_util.tree_map(np.asarray, want))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _occupancy_data(seed=0, shapes=4, surface_n=300, query_n=500):
    """Union-of-two-spheres shapes: surface points, labelled queries."""
    rng = np.random.default_rng(seed)
    pcs, qs, occs = [], [], []
    for _ in range(shapes):
        centers = rng.uniform(-0.2, 0.2, (2, 3))
        radii = rng.uniform(0.1, 0.25, 2)
        d = rng.normal(size=(surface_n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        which = rng.integers(0, 2, surface_n)
        pcs.append(centers[which] + radii[which, None] * d)
        q = rng.uniform(-0.55, 0.55, (query_n, 3))
        occs.append((np.linalg.norm(q[:, None] - centers, axis=-1)
                     < radii).any(-1))
        qs.append(q)
    return (np.stack(pcs).astype(np.float32), np.stack(qs).astype(np.float32),
            np.stack(occs).astype(np.float32))


# ---------------------------------------------------------------- weights


@pytest.mark.parametrize("variant", ["convonet", "onet"])
def test_params_to_jax_inverts_params_from_jax(variant, jax_runs):
    tree = jax_runs[variant]["variables"]
    back = params_to_jax(params_from_jax(tree))
    assert sorted(back) == sorted(tree)
    want, got = flatten_params(tree), flatten_params(back)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("variant", ["convonet", "onet"])
def test_flax_init_params_draws_as_flax(variant):
    """Full width: keys and shapes of `init_occupancy_model`'s tree, zeros
    and ones exactly where flax's are, kernel stds within 15 %."""
    jm = JaxConvONet() if variant == "convonet" else JaxONet()
    want = flatten_params(jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: jax_init_model(jm, key))(jax.random.key(0))))
    got = flatten_params(flax_init_params(0, variant))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    checked = 0
    for k, w in want.items():
        for value in (0.0, 1.0):
            np.testing.assert_array_equal(got[k] == value, w == value,
                                          err_msg=f"{k} == {value}")
        if k.endswith("kernel") and w.size >= 1024 and w.std() > 0:
            assert abs(got[k].std() / w.std() - 1) < 0.15, k
            checked += 1
    assert checked >= 10


def test_sampler_gives_jax_batches():
    pcs, qs, occ = _occupancy_data()
    kw = dict(pointcloud_n=64, points_subsample=128, seed=3)
    mine = OccupancyBatchSampler(pcs, qs, occ, **kw)
    theirs = JaxSampler(pcs, qs, occ, **kw)
    assert len(mine) == len(theirs) == 4
    for _ in range(3):
        for a, b in zip(mine.sample(BATCH), theirs.sample(BATCH)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- layers and ONet


def _layer_case(name):
    """(flax module, port module, args as numpy) of one ONet layer."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 50, 8)).astype(np.float32) * 2 + 0.5
    c = rng.normal(size=(2, 12)).astype(np.float32)
    if name == "cbn":
        return jax_layers.CBatchNorm(8), CBatchNorm(12, 8), (x, c)
    if name == "cresnet":
        return (jax_layers.CResnetBlockConv1d(size_h=6, size_out=10),
                CResnetBlockConv1d(12, 8, 6, 10), (x, c))
    return (jax_layers.ResnetBlockConv1d(size_h=6, size_out=10),
            ResnetBlockConv1d(8, 6, 10), (x,))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["cbn", "cresnet", "resnet"])
def test_batchnorm_layers_match_jax(name, train):
    jm, tm, args = _layer_case(name)
    jargs = [jnp.asarray(a) for a in args]
    v = _perturbed(_init(jm, *args), 12)
    _port(tm, v).train(train)
    got = tm(*(torch.from_numpy(a) for a in args))
    if train:
        want, upd = jm.apply(v, *jargs, train=True, mutable=["batch_stats"])
        _stats_close(tm, upd["batch_stats"], 1e-5, 1e-6)
    else:
        want = jm.apply(v, *jargs, train=False)
        _stats_close(tm, v["batch_stats"], 0, 0)        # untouched
    _close(got, want, 1e-5, 1e-6)


def test_resnet_pointnet_matches_jax():
    p = np.random.default_rng(13).uniform(-0.5, 0.5, (2, 64, 3))
    p = p.astype(np.float32)
    jm = jax_onet.ResnetPointnet(16, 16)
    v = _perturbed(_init(jm, p), 14)
    tm = _port(ResnetPointnet(16, 16), v)
    _close(tm(torch.from_numpy(p)), jm.apply(v, jnp.asarray(p)))


@pytest.mark.parametrize("train", [False, True])
def test_decoder_cbatchnorm_matches_jax(train):
    rng = np.random.default_rng(15)
    p = rng.uniform(-0.55, 0.55, (2, 100, 3)).astype(np.float32)
    c = rng.normal(size=(2, 16)).astype(np.float32)
    jm = jax_onet.DecoderCBatchNorm(hidden_size=8)
    v = _perturbed(_init(jm, p, c), 16)
    tm = _port(DecoderCBatchNorm(16, 8), v).train(train)
    got = tm(torch.from_numpy(p), torch.from_numpy(c))
    if train:
        want, upd = jm.apply(v, jnp.asarray(p), jnp.asarray(c), train=True,
                             mutable=["batch_stats"])
        _stats_close(tm, upd["batch_stats"], 1e-4, 1e-6)
    else:
        want = jm.apply(v, jnp.asarray(p), jnp.asarray(c))
    _close(got, want)


def test_occupancy_network_matches_jax():
    rng = np.random.default_rng(17)
    pc = rng.uniform(-0.45, 0.45, (2, 64, 3)).astype(np.float32)
    q = rng.uniform(-0.55, 0.55, (2, 100, 3)).astype(np.float32)
    jm = JaxONet(32, 32, 16)
    v = _perturbed(_init(jm, pc, q), 18)
    tm = _port(OccupancyNetwork(32, 32, 16), v).eval()
    tpc, tq = torch.from_numpy(pc), torch.from_numpy(q)
    c = jm.apply(v, jnp.asarray(pc), method="encode_inputs")
    _close(tm.encode_inputs(tpc), c)
    _close(tm.decode(tq, tm.encode_inputs(tpc)),
           jm.apply(v, jnp.asarray(q), c, method="decode"))
    want, upd = jm.apply(v, jnp.asarray(pc), jnp.asarray(q), train=True,
                         mutable=["batch_stats"])
    _close(tm.train()(tpc, tq), want)
    _stats_close(tm, upd["batch_stats"], 1e-4, 1e-6)
    mean, logstd = tm.infer_z(tq, torch.zeros(2, 100), tm.encode_inputs(tpc))
    jmean, jlogstd = jm.apply(v, jnp.asarray(q), jnp.zeros((2, 100)), c,
                              method="infer_z")
    assert mean.shape == logstd.shape == jmean.shape == jlogstd.shape == (2, 0)
    assert tm.get_z_from_prior(3).shape == (3, 0)


# --------------------------------------------------------------- training


@pytest.fixture(scope="module")
def jax_runs():
    """Per variant: the perturbed tree, JAX's batches, and JAX's train
    step over them (one compile each): losses, step 1's gradients, the
    final batch statistics."""
    pcs, qs, occ = _occupancy_data()
    runs = {}
    for variant, (make_jax, _) in VARIANTS.items():
        jm = make_jax()
        x = np.zeros((1, 32, 3), np.float32)
        variables = _perturbed(_init(jm, x, x), 20)
        sampler = JaxSampler(pcs, qs, occ, pointcloud_n=64,
                             points_subsample=128, seed=5)
        batches = [sampler.sample(BATCH) for _ in range(STEPS)]
        tx, step = jax_train_step(jm, LR)
        params = variables["params"]
        stats = variables.get("batch_stats")
        opt_state = tx.init(params)
        losses, trajectory = [], []
        for i, batch in enumerate(batches):
            trajectory.append(params)
            params, stats, opt_state, m = step(params, stats, opt_state,
                                               *batch)
            losses.append(float(m["loss"]))
            if i == 0:               # one Adam step: mu = (1 - b1) g
                grads = jax.tree_util.tree_map(
                    lambda mu: np.asarray(mu) / 0.1, opt_state[0].mu)
        runs[variant] = dict(variables=variables, batches=batches,
                             losses=losses, grads=grads, stats=stats,
                             trajectory=trajectory)
    return runs


@pytest.mark.parametrize("variant", ["convonet", "onet"])
def test_train_steps_match_jax(variant, jax_runs):
    run = jax_runs[variant]
    model = _port(VARIANTS[variant][1](), run["variables"])
    _, step = make_occupancy_train_step(model, LR)
    losses = []
    for i, batch in enumerate(run["batches"]):
        m = step(*(torch.from_numpy(a) for a in batch))
        losses.append(float(m["loss"]))
        assert 0 <= float(m["acc"]) <= 1
        if i == 0:
            np.testing.assert_allclose(losses[0], run["losses"][0],
                                       rtol=1e-5)
            grads = flatten_params(params_to_jax(
                {n: p.grad for n, p in model.named_parameters()})["params"])
            want = flatten_params(run["grads"])
            assert grads.keys() == want.keys()
            # a bias that feeds a batch norm has gradient 0 up to rounding
            # (the norm subtracts the batch mean): 0 up to rounding here too
            zero = 1e-6 * max(np.abs(w).max() for w in want.values())
            for k, w in want.items():
                if np.abs(w).max() < zero:
                    assert np.abs(grads[k]).max() < zero, k
                    continue
                np.testing.assert_allclose(
                    grads[k], w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                    err_msg=k)
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-4)


def test_onet_batch_stats_follow_jax(jax_runs):
    """The running statistics after 3 train-mode forwards, each with the
    parameters JAX's step had, from the same starting statistics."""
    run = jax_runs["onet"]
    model = _port(VARIANTS["onet"][1](), run["variables"]).train()
    with torch.no_grad():
        for params, batch in zip(run["trajectory"], run["batches"]):
            missing, _ = model.load_state_dict(
                params_from_jax({"params": params}), strict=False)
            assert all(k.endswith((".mean", ".var")) for k in missing)
            model(*(torch.from_numpy(a) for a in batch[:2]))
    _stats_close(model, run["stats"], 1e-4, 1e-6)


@pytest.mark.parametrize("variant", ["convonet", "onet"])
def test_train_implicit_cli_on_cpu(variant, tmp_path):
    """The port's CLI at full width on the CPU, 3 steps: its npz loads into
    JAX's model, whose logits equal the port's; the metrics have the keys."""
    pcs, qs, occ = _occupancy_data(surface_n=700)
    data = str(tmp_path / "occ.npz")
    np.savez(data, pointcloud=pcs, points=qs, points_occ=occ)
    out = train_implicit.main([
        "--variant", variant, "--data", data, "--device", "cpu",
        "--batch_size", "2", "--steps", "3", "--points_subsample", "128",
        "--log_every", "2", "--output", str(tmp_path / "w")])
    assert out == str(tmp_path / "w.npz")
    with open(tmp_path / "w.metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [2, 3]
    for r in records:
        assert {"step", "loss", "acc", "steps_per_sec"} <= r.keys()
        assert np.isfinite(r["loss"])

    variables = jax_load_params(out)
    assert sorted(variables) == (["params"] if variant == "convonet"
                                 else ["batch_stats", "params"])
    jm = JaxConvONet() if variant == "convonet" else JaxONet()
    tm = ConvOccupancyNetwork() if variant == "convonet" else OccupancyNetwork()
    tm.load_state_dict(params_from_jax(load_params_npz(out)), strict=True)
    rng = np.random.default_rng(21)
    pc = rng.uniform(-0.45, 0.45, (2, 300, 3)).astype(np.float32)
    q = rng.uniform(-0.55, 0.55, (2, 64, 3)).astype(np.float32)
    want = jm.apply(variables, jnp.asarray(pc), jnp.asarray(q))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(pc), torch.from_numpy(q))
    _close(got, want, 0, 1e-5)
