"""Victim training, PyTorch port vs JAX package, on the CPU.

- Step parity: for each victim (PointNet also with the feature transform
  and with label smoothing), JAX's `create_train_state` gives the
  variables, which `params_from_jax` carries into the port; 3 train steps
  in both packages on the same batches (B = 4, N = 64) with the same
  dropout masks: JAX's, captured with `nn.intercept_methods` around
  `Dropout.__call__` in an `apply` with the step's key (flax's draws
  depend only on the key and the module path, so `make_train_step` draws
  the same), fed to the port's `draw` seam. Both run in float64
  (`jax.enable_x64`, the port's modules and inputs in double): in float32
  JAX's own gradients lie up to ~2e-1 of a tensor's largest entry from
  the float64 gradient of the same step at these shapes, where the port's
  lie within ~1e-4 of it, and Adam turns such differences into weight
  steps of either sign. After each step: loss (rtol 1e-5); batch_stats
  within 1e-5 of each tensor's largest entry (+ 1e-3 lr: the running means
  hold the steps of the zero-gradient biases below); Adam's count equal;
  params within 1e-5 of each tensor's largest entry + 1e-4 lr a step (an
  entry whose gradient is near Adam's eps of 1e-8 moves its step by that
  much for a rounding difference of its gradient); mu and the root of nu
  within 1e-5 of their largest entry + 1e-9 of the largest gradient
  entry. A tensor whose gradient is 0 in exact arithmetic (below 1e-9 of
  the largest entry in JAX's step 1: a bias that feeds a train-mode batch
  norm; STN's layers behind its zero last kernel) is held there in the
  port too, and its weights within 1e-2 lr (Adam's normalised step turns
  rounding noise into steps of either sign well below the rate).
  PointConv: JAX computes its squared distances (so its densities) and
  its aggregation einsum with `preferred_element_type=float32` in float64
  too (`ops/pointops.py:38`, `models/pointconv.py:119`), so it is held at
  float32 level, each step from JAX's state after the one before (the
  trajectories part by Adam's sign steps): loss rtol 1e-4, batch_stats
  within 1e-4, >= 99 % of each tensor's weights within the bound above
  and every one within Adam's 2 lr, moments >= 99 % within theirs or in
  direction (cosine >= 0.999). The port's float32 step from the same
  start is then held to JAX's float64 step 1: loss rtol 1e-4, gradients
  cosine >= 0.999 per tensor, and a tensor whose gradient lies below 1e-5
  of the largest entry (float32 rounding) within that of JAX's. The feature-transform case starts from perturbed
  variables: at flax's init STN_1 gives T = I exactly, where JAX's
  `feature_transform_regularizer` (`jnp.linalg.norm`) has a NaN gradient
  and every parameter turns NaN after one step (shown below); torch's
  `matrix_norm` takes 0 there.
- `cross_entropy_loss` in both modes (rtol 1e-6), the schedule
  (`optim.ScheduledRate`) over T + 3 steps against
  `optax.cosine_decay_schedule` (rtol 1e-6), and the Adam + L2 update of a
  toy tree over 5 steps against JAX's optax chain (weights and moments
  rtol 1e-5, weights atol 1e-9; `tests/test_torch_port_optim.py` holds
  the optimiser to the bit).
- `flax_init_params` for the victims: JAX's `model.init` keys and shapes,
  zero biases, STN's last kernel 0, unit batch-norm scales and variances,
  each kernel's std within 10 % of 1/sqrt(fan_in) (>= 4096 entries).
- Checkpoints: `save_checkpoint` -> `restore_checkpoint` gives the same
  variables, Adam state, step and metadata; `restore_checkpoint_raw` and
  `load_eval_model` read a train checkpoint; a JAX train checkpoint
  converted by `tools/victim_ckpt_to_npz.py` resumes with JAX's Adam state
  and step.
"""

import importlib.util
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from if_defense_tpu.models import build_model as jax_build_model
from if_defense_tpu.models.pointnet import (
    feature_transform_regularizer as jax_ftr,
)
from if_defense_tpu.training import create_train_state as jax_create
from if_defense_tpu.training import cross_entropy_loss as jax_ce
from if_defense_tpu.training import make_train_step as jax_make_step
from if_defense_tpu.utils.checkpoint import save_checkpoint as jax_save
from if_defense_tpu_torch.cli.inference import load_eval_model
from if_defense_tpu_torch.models import build_model
from if_defense_tpu_torch.training import (
    AverageMeter,
    create_train_state,
    cross_entropy_loss,
    eval_variables,
    make_train_step,
)
from if_defense_tpu_torch.utils import restore_checkpoint, save_checkpoint
from if_defense_tpu_torch.utils.checkpoint import restore_checkpoint_raw
from if_defense_tpu_torch.utils.params_io import (
    adam_state_from_jax,
    adam_state_to_jax,
    flatten_params,
    flax_init_params,
    params_from_jax,
    params_to_jax,
)
from test_torch_port_victims import perturbed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, B, N, LR = 3, 4, 64, 1e-3
CASES = [("pointnet", {}, False), ("pointnet", {"feature_transform": True},
                                   False), ("pointnet", {}, True),
         ("pointnet2", {}, False), ("dgcnn", {}, False),
         ("pointconv", {}, False), ("rscnn", {}, False)]


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """torch's CPU ops in one thread (see ROADMAP.md section C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batches(seed, n=STEPS, dtype=np.float64):
    """n batches of B clouds of distinct shapes (ellipsoids of random axes,
    shifted), so that the head's batch norms over B clouds are not
    near-degenerate, and labels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        d = rng.normal(size=(B, N, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        pc = (d * rng.uniform(0.05, 1, (B, 1, 3))
              * rng.uniform(0.7, 1, (B, N, 1)) + rng.uniform(-.3, .3, (B, 1, 3)))
        out.append((pc.astype(dtype), rng.integers(0, 40, B).astype(np.int32)))
    return out


def jax_dropout_masks(jm, variables, steps) -> list:
    """For each (clouds, dropout key) of `steps`, the keep masks flax's
    `nn.Dropout` layers draw in a train-mode apply with that key, in call
    order: each layer's rng is taken as the layer would take it
    (`make_rng`), passed to the layer, and its mask read off a second call
    on ones with the same rng. One jitted probe for all the steps."""

    def probe(variables, pc, key):
        masks = []

        def interceptor(next_fun, args, kwargs, context):
            if (isinstance(context.module, fnn.Dropout)
                    and context.method_name == "__call__"):
                rng = context.module.make_rng("dropout")
                out = next_fun(*args, rng=rng)
                masks.append(next_fun(jnp.ones_like(args[0]), rng=rng) != 0)
                return out
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(interceptor):
            jm.apply(variables, pc, train=True, rngs={"dropout": key},
                     mutable=["batch_stats"])
        return masks

    probe = jax.jit(probe)
    return [[np.asarray(m) for m in probe(variables, jnp.asarray(pc), key)]
            for pc, key in steps]


def replay(masks):
    """A `draw` that returns `masks` in order, checking each shape."""
    it = iter(masks)

    def draw(shape, rate):
        m = next(it)
        assert m.shape == tuple(shape)
        return torch.from_numpy(m.copy())

    return draw


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close_trees(got, want, what, rel=1e-5, extra=0.0, skip=()):
    """Every tensor but those in `skip` within `rel` of its largest entry
    in `want`, plus `extra`."""
    got, want = flatten_params(got), flatten_params(want)
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        if k in skip:
            continue
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=rel * np.abs(w).max() + extra,
                                   err_msg=f"{what} {k}")


def tree_max(tree) -> float:
    return max(np.abs(v).max() for v in flatten_params(tree).values())


def cosine(a, b):
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


def test_jax_feature_transform_is_nan_from_its_init():
    """Why the feature-transform case starts from perturbed variables: at
    T = I JAX's regulariser has a NaN gradient, the port's a zero one."""
    eye = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    assert np.isnan(np.asarray(jax.grad(jax_ftr)(jnp.asarray(eye)))).all()
    from if_defense_tpu_torch.models.pointnet import (
        feature_transform_regularizer,
    )
    t = torch.from_numpy(eye).requires_grad_()
    feature_transform_regularizer(t).backward()
    assert torch.equal(t.grad, torch.zeros_like(t))


@pytest.mark.parametrize("name,kw,smoothing", CASES,
                         ids=["pointnet", "pointnet-ft", "pointnet-smoothing",
                              "pointnet2", "dgcnn", "pointconv", "rscnn"])
def test_train_steps_match_jax(name, kw, smoothing):
    fea = 0.001 if kw.get("feature_transform") else 0.0
    data = batches(1)
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
        masks = jax_dropout_masks(jm, start, [
            (pc, keys[i]) for i, (pc, _) in enumerate(data)])
        losses, after = [], []
        for i, (pc, label) in enumerate(data):
            mu0 = to_numpy(js.opt_state[1].mu)
            js, m = jstep(js, jnp.asarray(pc), jnp.asarray(label), keys[i])
            assert m["loss"].dtype == jnp.float64
            losses.append(float(m["loss"]))
            after.append((to_numpy({"params": js.params,
                                    "batch_stats": js.batch_stats}),
                          to_numpy(js.opt_state[1])))
            if i == 0:      # Adam's first moment: mu = 0.1 (g + wd p)
                grads = jax.tree_util.tree_map(
                    lambda mu, m0, p: (np.asarray(mu) - 0.9 * m0) / 0.1
                    - 1e-4 * p, js.opt_state[1].mu, mu0, start["params"])
    top_grad = tree_max(grads)
    zero = {k for k, g in flatten_params(grads).items()
            if np.abs(g).max() < 1e-9 * top_grad}
    # JAX's PointConv computes its squared distances (hence its densities)
    # and its aggregation einsum with preferred_element_type float32
    # (ops/pointops.py:38, models/pointconv.py:119), in float64 too
    f32_inside = name == "pointconv"

    # the port in float64 along the same steps
    model = build_model(name, **kw)
    model.load_state_dict(params_from_jax(start, model), strict=True)
    model.double()
    state = create_train_state(model, total_epochs=1, steps_per_epoch=STEPS)
    step = make_train_step(model, smoothing, fea)
    for i, (pc, label) in enumerate(data):
        want_vars, want_adam = after[i]
        tag = f"{name} step {i + 1}"
        if f32_inside and i > 0:
            # the trajectories part at float32 level: each step from
            # JAX's state after the one before
            prev_vars, prev_adam = after[i - 1]
            model.load_state_dict(
                params_from_jax(prev_vars, model, np.float64))
            state.optimizer.load_state_dict(adam_state_from_jax(
                prev_adam._asdict(), model, state.optimizer.state_dict()))
            state.set_step(i)
        state, m = step(state, torch.from_numpy(pc),
                        torch.from_numpy(label).long(), replay(masks[i]))
        np.testing.assert_allclose(float(m["loss"]), losses[i],
                                   rtol=1e-4 if f32_inside else 1e-5,
                                   err_msg=f"{tag} loss")
        assert 0 <= float(m["acc"]) <= 1
        if i == 0:
            got = flatten_params(params_to_jax(
                {n: p.grad for n, p in model.named_parameters()},
                model)["params"])
            for k in zero:
                assert np.abs(got[k]).max() < 1e-9 * top_grad, (tag, k)
        got_vars = params_to_jax(model.state_dict(), model)
        # the running means hold the steps of the zero-gradient biases
        # that feed their norms (0.1 of each, well below the rate)
        close_trees(got_vars["batch_stats"], want_vars["batch_stats"],
                    f"{tag} batch_stats", rel=1e-4 if f32_inside else 1e-5,
                    extra=1e-3 * LR)
        adam = adam_state_to_jax(state.optimizer.state_dict(), model)
        assert int(adam["count"]) == int(want_adam.count) == i + 1
        got_p = flatten_params(got_vars["params"])
        got_m, got_v = flatten_params(adam["mu"]), flatten_params(adam["nu"])
        want_m = flatten_params(to_numpy(want_adam.mu))
        want_v = flatten_params(to_numpy(want_adam.nu))
        for k, w in flatten_params(want_vars["params"]).items():
            # a tensor whose gradient is 0 in exact arithmetic (a bias
            # that feeds a train-mode batch norm) has moments of rounding
            # noise, which Adam's normalised step turns into steps of any
            # sign well below the rate; elsewhere an entry whose gradient
            # is near Adam's eps of 1e-8 moves its step by ~1e-4 lr for a
            # rounding difference of its gradient. The moments: mu, and
            # nu through its root, within 1e-5 of their largest entry
            # plus 1e-9 of the largest gradient entry (rounding)
            atol = (1e-2 * LR if k in zero
                    else 1e-5 * np.abs(w).max() + 1e-4 * LR * (i + 1))
            noise = 1e-9 * top_grad
            pairs = ((got_p[k], w, atol, "param"),
                     (got_m[k], want_m[k],
                      1e-5 * np.abs(want_m[k]).max() + noise, "mu"),
                     (np.sqrt(got_v[k]), np.sqrt(want_v[k]),
                      1e-5 * np.sqrt(want_v[k]).max() + noise, "sqrt nu"))
            for g, want, tol, what in pairs:
                if not f32_inside:
                    np.testing.assert_allclose(g, want, rtol=0, atol=tol,
                                               err_msg=f"{tag} {what} {k}")
                    continue
                # Adam turns float32-level gradient differences into
                # steps of either sign where |g| is near them: >= 99 % of
                # entries as above or moments in direction, and every
                # weight within Adam's bound of 2 lr of JAX's
                assert np.mean(np.abs(g - want) <= tol) >= 0.99 or (
                    what != "param"
                    and (k in zero or cosine(g, want) >= 0.999)), (tag, k)
                if what == "param":
                    assert np.abs(g - want).max() <= 2.02 * LR, k

    # the port in float32 from the same start: step 1 against JAX's float64
    model = build_model(name, **kw)
    model.load_state_dict(params_from_jax(start, model), strict=True)
    state = create_train_state(model, total_epochs=1, steps_per_epoch=STEPS)
    pc, label = data[0]
    _, m = make_train_step(model, smoothing, fea)(
        state, torch.from_numpy(pc.astype(np.float32)),
        torch.from_numpy(label).long(), replay(masks[0]))
    np.testing.assert_allclose(float(m["loss"]), losses[0], rtol=1e-4)
    got = flatten_params(params_to_jax(
        {n: p.grad for n, p in model.named_parameters()}, model)["params"])
    want = flatten_params(grads)
    for k, w in want.items():
        if np.abs(w).max() < 1e-5 * top_grad:      # float32 rounding
            assert np.abs(got[k] - w).max() < 1e-5 * top_grad, k
        else:
            assert cosine(got[k].astype(np.float64), w) >= 0.999, k


@pytest.mark.parametrize("smoothing", [False, True])
def test_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(6, 40)) * 3).astype(np.float32)
    label = rng.integers(0, 40, 6).astype(np.int32)
    want = float(jax_ce(jnp.asarray(logits), jnp.asarray(label), smoothing))
    got = float(cross_entropy_loss(torch.from_numpy(logits),
                                   torch.from_numpy(label), smoothing))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_schedule_matches_optax():
    """The rate of each of T + 3 steps: step k at count k - 1, clamped at
    eta_min from count T on."""
    epochs, per_epoch, lr, eta_min = 3, 4, 1e-3, 1e-5
    state = create_train_state(torch.nn.Linear(2, 2), learning_rate=lr,
                               total_epochs=epochs, steps_per_epoch=per_epoch)
    sched = optax.cosine_decay_schedule(lr, epochs * per_epoch,
                                        alpha=eta_min / lr)
    got, want = [], []
    for count in range(epochs * per_epoch + 3):
        got.append(state.optimizer.param_groups[0]["lr"])
        want.append(float(sched(count)))
        state.optimizer.step()
        state.scheduler.step()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] == pytest.approx(eta_min, rel=1e-12)


class _Toy(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        h = fnn.Dense(3)(x)
        return fnn.Dense(2)(h)


def test_adam_weight_decay_matches_optax():
    """The victims' optimiser (L2 decay, the cosine schedule) against the
    JAX package's optax chain (add_decayed_weights -> scale_by_adam ->
    scale_by_learning_rate), the same gradients fed to both, 5 steps."""
    js = jax_create(_Toy(), jax.random.key(0), np.zeros((1, 4), np.float32),
                    total_epochs=1, steps_per_epoch=4)
    toy = torch.nn.Module()
    toy.Dense_0, toy.Dense_1 = torch.nn.Linear(4, 3), torch.nn.Linear(3, 2)
    toy.load_state_dict(params_from_jax({"params": to_numpy(js.params)}, toy))
    state = create_train_state(toy, total_epochs=1, steps_per_epoch=4)
    rng = np.random.default_rng(4)
    for i in range(5):
        g = jax.tree_util.tree_map(
            lambda a: (rng.normal(size=a.shape) * 10.0 ** rng.integers(
                -9, 1, a.shape)).astype(np.float32), to_numpy(js.params))
        js = js.apply_gradients(grads=g)
        for name, p in toy.named_parameters():
            p.grad = params_from_jax({"params": g}, toy)[name]
        state.optimizer.step()
        state.scheduler.step()
        got = params_to_jax(toy.state_dict(), toy)["params"]
        for k, w in flatten_params(to_numpy(js.params)).items():
            np.testing.assert_allclose(flatten_params(got)[k], w, rtol=1e-5,
                                       atol=1e-9, err_msg=f"step {i} {k}")
        adam = adam_state_to_jax(state.optimizer.state_dict(), toy)
        assert int(adam["count"]) == int(js.opt_state[1].count) == i + 1
        for key in ("mu", "nu"):
            for k, w in flatten_params(to_numpy(
                    getattr(js.opt_state[1], key))).items():
                np.testing.assert_allclose(flatten_params(adam[key])[k], w,
                                           rtol=1e-5, atol=0,
                                           err_msg=f"{key} {k}")


@pytest.mark.parametrize("name", ["pointnet", "pointnet2", "dgcnn",
                                  "pointconv", "rscnn"])
def test_flax_init_params_victims(name):
    kw = {"feature_transform": True} if name == "pointnet" else {}
    want = jax.eval_shape(lambda: jax_build_model(name, **kw).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((2, 64, 3)), train=True))
    want = {k: v.shape for k, v in flatten_params(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), want)).items()}
    got = flatten_params(flax_init_params(0, name, **kw))
    assert {k: v.shape for k, v in got.items()} == want
    for k, v in got.items():
        path = k.split("/")
        assert v.dtype == np.float32
        if path[-1] == "kernel" and path[-2] == "Dense_0" and path[-3] in (
                "STN_0", "STN_1"):
            assert not v.any(), k
        elif path[-1] == "kernel":
            if v.size >= 4096:
                std = 1 / np.sqrt(np.prod(v.shape[:-1]))
                assert abs(v.std() / std - 1) < 0.1, k
            assert np.abs(v).max() <= 2 * (1 / np.sqrt(np.prod(
                v.shape[:-1]))) / .87962566103423978 + 1e-6, k
        elif path[-1] in ("scale", "var"):
            assert (v == 1).all(), k
        else:
            assert not v.any(), k
    model = build_model(name, **kw)
    model.load_state_dict(
        params_from_jax(flax_init_params(0, name, **kw), model), strict=True)


def _train_tiny(tmp_path, steps=2):
    model = build_model("pointnet")
    model.load_state_dict(
        params_from_jax(flax_init_params(1, "pointnet"), model))
    state = create_train_state(model, total_epochs=2, steps_per_epoch=3)
    step = make_train_step(model)
    gen = torch.Generator().manual_seed(0)
    from if_defense_tpu_torch.models.common import generator_draw
    for pc, label in batches(2, steps, np.float32):
        state, _ = step(state, torch.from_numpy(pc),
                        torch.from_numpy(label).long(), generator_draw(gen))
    return state


def test_checkpoint_round_trip(tmp_path):
    state = _train_tiny(tmp_path)
    meta = {"model": "pointnet", "epoch": 1, "acc": 0.25, "num_points": N}
    path = save_checkpoint(str(tmp_path / "best"), state, meta)
    assert path == str(tmp_path / "best.npz")
    fresh = build_model("pointnet")
    back, got_meta = restore_checkpoint(
        path, create_train_state(fresh, total_epochs=2, steps_per_epoch=3))
    assert got_meta == meta and back.step == state.step == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k
    want = adam_state_to_jax(state.optimizer.state_dict(), state.model)
    got = adam_state_to_jax(back.optimizer.state_dict(), back.model)
    assert int(got["count"]) == int(want["count"]) == 2
    for key in ("mu", "nu"):
        for k, v in flatten_params(want[key]).items():
            np.testing.assert_array_equal(flatten_params(got[key])[k], v)
    assert back.optimizer.param_groups[0]["lr"] == pytest.approx(
        state.optimizer.param_groups[0]["lr"], rel=1e-12)
    # the eval side reads a train checkpoint
    raw = restore_checkpoint_raw(path)
    assert set(raw) == {"params", "batch_stats", "metadata"}
    model, m = load_eval_model(path)
    assert m == meta
    for k, v in state.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    close_trees(eval_variables(back), {k: raw[k] for k in (
        "params", "batch_stats")}, "eval variables", 0)
    # a resumed step continues as the uninterrupted one does
    pc, label = batches(3, 1, np.float32)[0]
    draw = lambda shape, rate: torch.ones(shape, dtype=torch.bool)  # noqa
    step = make_train_step(state.model)
    _, a = step(state, torch.from_numpy(pc), torch.from_numpy(label).long(),
                draw)
    _, b = make_train_step(back.model)(back, torch.from_numpy(pc),
                                       torch.from_numpy(label).long(), draw)
    assert float(a["loss"]) == float(b["loss"])
    for k, v in state.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k


def test_adam_state_round_trip():
    state = _train_tiny(None, steps=1)
    tree = adam_state_to_jax(state.optimizer.state_dict(), state.model)
    sd = adam_state_from_jax(tree, state.model, state.optimizer.state_dict())
    for i, s in state.optimizer.state_dict()["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sd["state"][i][k], s[k])
        assert float(sd["state"][i]["step"]) == float(s["step"])
    with pytest.raises(ValueError):
        adam_state_from_jax(tree, build_model("pointnet2"),
                            state.optimizer.state_dict())


def test_converted_jax_train_checkpoint_resumes(tmp_path):
    """A JAX train checkpoint (orbax) after one step, through the
    converter: the port restores its variables, Adam state and step."""
    spec = importlib.util.spec_from_file_location(
        "victim_ckpt_to_npz", os.path.join(ROOT, "tools",
                                            "victim_ckpt_to_npz.py"))
    conv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conv)
    jm = jax_build_model("pointnet")
    (pc, label), = batches(5, 1, np.float32)
    js = jax_create(jm, jax.random.key(0), pc, total_epochs=2,
                    steps_per_epoch=3)
    js, _ = jax_make_step(jm)(js, jnp.asarray(pc), jnp.asarray(label),
                              jax.random.key(1))
    jax_save(str(tmp_path / "jax_ckpt"), js,
             {"model": "pointnet", "epoch": 1, "num_points": N})
    path = conv.convert(str(tmp_path / "jax_ckpt"), str(tmp_path / "v.npz"))
    assert os.path.exists(path + ".opt.npz")
    state, meta = restore_checkpoint(path, create_train_state(
        build_model("pointnet"), total_epochs=2, steps_per_epoch=3))
    assert meta["epoch"] == 1 and state.step == 1
    close_trees(params_to_jax(state.model.state_dict(), state.model),
                to_numpy({"params": js.params,
                          "batch_stats": js.batch_stats}), "variables", 0)
    adam = adam_state_to_jax(state.optimizer.state_dict(), state.model)
    assert int(adam["count"]) == 1
    close_trees(adam["mu"], to_numpy(js.opt_state[1].mu), "mu", 0)
    close_trees(adam["nu"], to_numpy(js.opt_state[1].nu), "nu", 0)
    sched = optax.cosine_decay_schedule(1e-3, 6, alpha=1e-2)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
        float(sched(1)), rel=1e-6)


def test_average_meter():
    m = AverageMeter()
    assert m.avg == 0.0
    m.update(2.0, 3)
    m.update(4.0, 1)
    assert m.avg == pytest.approx(2.5)
