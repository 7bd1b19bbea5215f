"""The port's one optimiser against optax as the JAX package runs it
(under `jit`, on the CPU), through each of its users.

- Updates: 12 steps of gradients over eight decades through each user's
  own code, against the jitted optax transformation the JAX package steps
  there: `optax.adam(1e-3)` for the defense's points (`make_opt_defense`,
  the loop itself, its loss's gradient replaced by the given one) and for
  `attack.cw.adam`, and the JAX package's victim chain
  (`add_decayed_weights` -> `scale_by_adam` -> `scale_by_learning_rate(
  cosine_decay_schedule)`, the schedule's 10 steps ending inside the 12)
  for `training.create_train_state`. Each update is read on weights set to
  0 before its step (Adam's update does not depend on them, and the
  decay's term is then 0; the trajectory case below takes the decay on):
  within 1e-6 of optax's, relative, and bit-equal at every step, as are
  the moments where the user holds the optimiser. `torch.optim.Adam` and
  a float64 schedule miss by about 6.5e-6 at every step; optax's
  operations run one at a time (not jitted) miss the bits of a fifth of
  the moments from step 2 on, XLA's fused multiply-adds.
- The victim chain on weights that it moves (the decay on), 12 steps:
  the weights bit-equal to the JAX package's jitted chain at every step.
- The schedule, `optim.cosine_decay_schedule`, bit-equal to optax's
  jitted float32 schedule at every count of a long run and beyond it.
- Resuming: a victim's training saved after 3 steps and restored (the
  state then holds `step` as a float tensor and no scratch, as
  `adam_state_from_jax` writes it) takes a 4th step bit-equal to an
  unbroken run's; a JAX train checkpoint converted by
  `tools/victim_ckpt_to_npz.py` takes the next step, on the same
  gradients, bit-equal to JAX's own.
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
from if_defense_tpu.training import create_train_state as jax_create
from if_defense_tpu.training import make_train_step as jax_make_step
from if_defense_tpu.utils.checkpoint import save_checkpoint as jax_save
from if_defense_tpu_torch.attack import cw
from if_defense_tpu_torch.defense.ifdefense import make_opt_defense
from if_defense_tpu_torch.models import build_model
from if_defense_tpu_torch.models.common import generator_draw
from if_defense_tpu_torch.training import create_train_state, make_train_step
from if_defense_tpu_torch.utils import restore_checkpoint, save_checkpoint
from if_defense_tpu_torch.utils.params_io import (
    adam_state_to_jax,
    flatten_params,
    flax_init_params,
    params_from_jax,
    params_to_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, LR, WD, T = 12, 1e-3, 1e-4, 10
SHAPES = [(3, 32), (32,), (3, 3, 32, 64), (1,)]
POINTS = (2, 16, 3)


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """torch's CPU ops in one thread (see ROADMAP.md section C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gradients(shapes, seed=0):
    """STEPS lists of float32 gradients, entries over eight decades."""
    rng = np.random.default_rng(seed)
    return [[(rng.normal(size=s) * 10.0 ** rng.uniform(-8, 0, s)).astype(
        np.float32) for s in shapes] for _ in range(STEPS)]


class _Toy(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        return fnn.Dense(2)(x)


def victim_chain():
    """The JAX package's victim optimiser over T steps (its
    `create_train_state`'s `tx`)."""
    return jax_create(_Toy(), jax.random.key(0), np.zeros((1, 4), np.float32),
                      learning_rate=LR, weight_decay=WD, total_epochs=1,
                      steps_per_epoch=T).tx


# Each user: (the optax transformation it stands for, a runner). A runner
# takes the STEPS gradients (numpy lists over the user's shapes) and yields
# after each step (the update, read on weights that were 0 before it; the
# moments as lists, or None where the user keeps the optimiser inside).


def run_cw(grads):
    ws = [torch.zeros(g.shape, requires_grad=True) for g in grads[0]]
    opt = cw.adam(ws, LR)
    for g in grads:
        with torch.no_grad():
            for w, a in zip(ws, g):
                w.zero_()
                w.grad = torch.from_numpy(a)
        opt.step()
        yield ([w.detach().numpy().copy() for w in ws],
               [[opt.state[w][k].numpy().copy() for w in ws]
                for k in ("exp_avg", "exp_avg_sq")])


def run_victim(grads):
    model = torch.nn.ParameterList(torch.zeros(g.shape) for g in grads[0])
    state = create_train_state(model, learning_rate=LR, weight_decay=WD,
                               total_epochs=1, steps_per_epoch=T)
    ws = list(model.parameters())
    for g in grads:
        with torch.no_grad():
            for w, a in zip(ws, g):
                w.zero_()
                w.grad = torch.from_numpy(a)
        state.optimizer.step()
        state.scheduler.step()
        yield ([w.detach().numpy().copy() for w in ws],
               [[state.optimizer.state[w][k].numpy().copy() for w in ws]
                for k in ("exp_avg", "exp_avg_sq")])


class _Inject(torch.autograd.Function):
    """Zero logits whose backward hands the points a given gradient."""

    @staticmethod
    def forward(ctx, p, grad):
        ctx.grad = grad
        return p.sum(-1) * 0.0

    @staticmethod
    def backward(ctx, g):
        return ctx.grad, None


def run_defense(grads):
    """The defense's own loop (`make_opt_defense`, lr 1e-3, STEPS + 1
    steps, no SOR, the repulsion's weight 0): its decoder reads the points
    the step before left (the update of that step: the points were 0
    before it), sets them to 0, and hands the given gradient back."""
    seen = []

    def decode(model, p, c):
        i = len(seen)
        with torch.no_grad():
            seen.append(p.detach().clone())
            p.zero_()
        return _Inject.apply(p, torch.from_numpy(grads[min(i, STEPS - 1)][0]))

    defend = make_opt_defense(decode, lambda m, pc: None, input_npoint=4,
                              sample_npoint=POINTS[1], iterations=STEPS,
                              lr=LR, rep_weight=0.0, sor=False)
    sel = torch.zeros(POINTS[0], 4, 3)
    pts = torch.full(POINTS, 0.25)
    defend(torch.nn.Module(), pts, draws=(sel, pts))
    for u in seen[1:]:
        yield [u.numpy()], None


USERS = {"defense": (POINTS, run_defense), "cw_adam": (SHAPES, run_cw),
         "create_train_state": (SHAPES, run_victim)}


@pytest.mark.parametrize("user", list(USERS))
def test_updates_are_optax(user):
    shapes, run = USERS[user]
    grads = gradients([shapes] if user == "defense" else shapes)
    tx = victim_chain() if user == "create_train_state" else optax.adam(LR)
    zeros = [jnp.zeros(s, jnp.float32) for s in
             ([shapes] if user == "defense" else shapes)]
    state, update = tx.init(zeros), jax.jit(tx.update)
    adam_state = (lambda s: s[1]) if user == "create_train_state" else (
        lambda s: s[0])
    n = 0
    for t, (g, (got, moments)) in enumerate(zip(grads, run(grads)), 1):
        want, state = update([jnp.asarray(a) for a in g], state, zeros)
        for w, u in zip(got, want):
            u = np.asarray(u)
            gap = float(np.max(np.abs(w - u) / np.abs(u)))
            assert gap <= 1e-6, (user, t, gap)
            np.testing.assert_array_equal(w, u, err_msg=f"step {t}")
        if moments is not None:
            for got_m, want_m in zip(moments, (adam_state(state).mu,
                                               adam_state(state).nu)):
                for a, b in zip(got_m, want_m):
                    np.testing.assert_array_equal(a, np.asarray(b))
        n += 1
    assert n == STEPS


def test_victim_chain_trajectory_with_decay():
    """The victim's optimiser on weights it moves: the decay's term g +
    wd p on, the weights bit-equal to the JAX package's jitted chain (its
    step's update and apply) at every step."""
    rng = np.random.default_rng(5)
    start = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    tx = victim_chain()
    params = [jnp.asarray(a) for a in start]
    state = tx.init(params)

    @jax.jit
    def step(g, state, params):
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state
    model = torch.nn.ParameterList(
        torch.nn.Parameter(torch.from_numpy(a.copy())) for a in start)
    ts = create_train_state(model, learning_rate=LR, weight_decay=WD,
                            total_epochs=1, steps_per_epoch=T)
    for t, g in enumerate(gradients(SHAPES, seed=6), 1):
        g = [a * 1e3 for a in g]               # the decay's size and more
        params, state = step([jnp.asarray(a) for a in g], state, params)
        for w, a in zip(model.parameters(), g):
            w.grad = torch.from_numpy(a)
        ts.optimizer.step()
        ts.scheduler.step()
        for w, p in zip(model.parameters(), params):
            np.testing.assert_array_equal(w.detach().numpy(), np.asarray(p),
                                          err_msg=f"step {t}")


def test_schedule_is_optax_float32():
    """The rate at every count of a schedule and beyond it, bit-equal to
    optax's schedule under `jit`."""
    from if_defense_tpu_torch.optim import cosine_decay_schedule

    for lr, steps, eta_min in ((1e-3, 6000, 1e-5), (1e-3, 61600, 1e-5),
                               (1e-3, 6, 1e-5), (1e-4, 77, 1e-6)):
        ours = cosine_decay_schedule(lr, steps, eta_min / lr)
        sched = optax.cosine_decay_schedule(lr, steps, alpha=eta_min / lr)
        counts = np.arange(steps + 5)
        want = np.asarray(jax.jit(jax.vmap(sched))(jnp.asarray(counts)))
        got = np.array([ours(int(c)) for c in counts], np.float32)
        np.testing.assert_array_equal(got, want)


def _pointnet_state():
    model = build_model("pointnet")
    model.load_state_dict(
        params_from_jax(flax_init_params(1, "pointnet"), model))
    return create_train_state(model, total_epochs=2, steps_per_epoch=3)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.normal(size=(3, 32, 3)).astype(
        np.float32)), torch.from_numpy(rng.integers(0, 40, 3)))
        for _ in range(n)]


def _same_state(a, b):
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    sa = adam_state_to_jax(a.optimizer.state_dict(), a.model)
    sb = adam_state_to_jax(b.optimizer.state_dict(), b.model)
    assert int(sa["count"]) == int(sb["count"])
    for key in ("mu", "nu"):
        for k, v in flatten_params(sa[key]).items():
            np.testing.assert_array_equal(flatten_params(sb[key])[k], v)


def test_resume_from_sidecar_equals_unbroken_run(tmp_path):
    """3 steps, save, restore into a fresh state (`step` a float tensor,
    no scratch), a 4th step: the same bits as 4 unbroken steps."""
    data = _batches(4)

    def run(state, batches):
        step = make_train_step(state.model)
        gen = torch.Generator().manual_seed(0)
        for pc, label in batches:
            state, _ = step(state, pc, label, generator_draw(gen))
        return state, gen

    unbroken, _ = run(_pointnet_state(), data)
    first, gen = run(_pointnet_state(), data[:3])
    path = save_checkpoint(str(tmp_path / "w"), first, {"model": "pointnet"})
    back, _ = restore_checkpoint(path, _pointnet_state())
    st = back.optimizer.state[next(back.model.parameters())]
    assert isinstance(st["step"], torch.Tensor)            # torch's layout
    assert back.optimizer.param_groups[0]["lr"] == \
        first.optimizer.param_groups[0]["lr"]
    step = make_train_step(back.model)
    back, _ = step(back, *data[3], generator_draw(gen))
    _same_state(back, unbroken)
    assert back.step == unbroken.step == 4
    assert back.optimizer.param_groups[0]["lr"] == \
        unbroken.optimizer.param_groups[0]["lr"]


def test_converted_jax_checkpoint_takes_jax_next_step(tmp_path):
    """A JAX train checkpoint after one step, through the converter, then
    one more step of the same gradients in both packages (JAX's jitted, as
    its train step applies them): the weights and the moments
    bit-equal."""
    spec = importlib.util.spec_from_file_location(
        "victim_ckpt_to_npz", os.path.join(ROOT, "tools",
                                            "victim_ckpt_to_npz.py"))
    conv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conv)
    jm = jax_build_model("pointnet")
    pc = np.random.default_rng(5).normal(size=(3, 32, 3)).astype(np.float32)
    label = np.array([1, 2, 3], np.int32)
    js = jax_create(jm, jax.random.key(0), pc, total_epochs=2,
                    steps_per_epoch=3)
    js, _ = jax_make_step(jm)(js, jnp.asarray(pc), jnp.asarray(label),
                              jax.random.key(1))
    jax_save(str(tmp_path / "jax_ckpt"), js,
             {"model": "pointnet", "epoch": 1, "num_points": 32})
    path = conv.convert(str(tmp_path / "jax_ckpt"), str(tmp_path / "v.npz"))
    state, _ = restore_checkpoint(path, create_train_state(
        build_model("pointnet"), total_epochs=2, steps_per_epoch=3))
    rng = np.random.default_rng(6)
    grads = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 10.0 ** rng.uniform(
            -8, 0, a.shape)).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, js.params))
    js = jax.jit(lambda s, g: s.apply_gradients(grads=g))(js, grads)
    torch_grads = params_from_jax({"params": grads}, state.model)
    for name, p in state.model.named_parameters():
        p.grad = torch_grads[name]
    state.optimizer.step()
    state.scheduler.step()
    got = flatten_params(params_to_jax(state.model.state_dict(),
                                       state.model)["params"])
    for k, v in flatten_params(jax.tree_util.tree_map(
            np.asarray, js.params)).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    adam = adam_state_to_jax(state.optimizer.state_dict(), state.model)
    assert int(adam["count"]) == int(js.opt_state[1].count) == 2
    for key in ("mu", "nu"):
        for k, v in flatten_params(jax.tree_util.tree_map(
                np.asarray, getattr(js.opt_state[1], key))).items():
            np.testing.assert_array_equal(flatten_params(adam[key])[k], v,
                                          err_msg=f"{key} {k}")
