"""The protocol's full-width ConvONet training step, PyTorch port vs JAX
package, and the patch-based TPU-precision mode (`tools/tpu_precision.py`)
against the function mode it replaced.

- One train step of `ConvOccupancyNetwork()` at full width (three 64^2
  planes, the accuracy protocol's model) in both frameworks from the same
  tree (`flax_init_params(0)`, every tensor moved as
  `tests/test_torch_port_training.py` moves them: flax's zero biases
  would hide half of each block) on one batch of JAX's own sampler: a
  hard-family occupancy npz (`tools/synthetic_dataset.py`), batch 2, 600
  input points with the protocol's noise, 512 queries. Step 1's loss
  within rtol 1e-5 and each tensor's gradient within
  `test_train_steps_match_jax`'s tolerances (rtol 1e-4, atol 1e-5 of the
  tensor's largest entry; JAX's read back from Adam's first moment,
  mu = 0.1 g; a gradient that is 0 up to rounding in JAX is so in the
  port). `tools/train_vs_jax.py` runs the same comparison for 50 steps at
  the protocol's batch.
- The mode: the patched entry points give the loss, every gradient and
  the call counts of a small ConvONet train step bit for bit as a
  `TorchFunctionMode` that routes the same products through the same
  `_Rounded` did (the mode's first form, kept here as the reference).
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from if_defense_tpu.implicit import ConvOccupancyNetwork as JaxConvONet
from if_defense_tpu.implicit.training import (
    make_occupancy_train_step as jax_train_step,
)
from if_defense_tpu_torch.implicit import ConvOccupancyNetwork
from if_defense_tpu_torch.implicit.training import (
    init_occupancy_model,
    make_occupancy_train_step,
)
from if_defense_tpu_torch.utils.params_io import (
    flatten_params,
    flax_init_params,
    params_to_jax,
    unflatten_params,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools import tpu_precision  # noqa: E402
from tools.train_vs_jax import (  # noqa: E402
    FLAGS,
    jax_batches,
    occupancy_arrays,
    port_model,
)

STEP_FLAGS = dict(FLAGS, batch_size=2, points_subsample=512)


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """torch's CPU ops in one thread, as in the other port parity files
    (ROADMAP.md section C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturbed(variables: dict, seed: int) -> dict:
    """`tests/test_torch_port_training.py`'s `_perturbed`: kernels moved
    by 0.3/sqrt(fan_in), every other tensor by 0.05."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flatten_params(variables).items():
        noise = rng.normal(size=v.shape)
        if k.endswith("/var"):
            v = v * np.exp(0.2 * noise)
        elif v.ndim > 1:
            v = v + 0.3 / np.sqrt(np.prod(v.shape[:-1])) * noise
        else:
            v = v + 0.05 * noise
        out[k] = v.astype(np.float32)
    return unflatten_params(out)


def test_full_width_train_step_matches_jax(tmp_path):
    arrays = occupancy_arrays(1, 1, str(tmp_path))
    batch, = jax_batches(arrays, 1, 0, STEP_FLAGS)
    assert [a.shape for a in batch] == [(2, 600, 3), (2, 512, 3), (2, 512)]
    variables = perturbed(flax_init_params(0, "convonet"), 20)
    lr = STEP_FLAGS["lr"]

    tx, step = jax_train_step(JaxConvONet(), lr)
    opt_state = tx.init(variables["params"])
    _, _, opt_state, m = step(variables["params"], None, opt_state, *batch)
    want = flatten_params(jax.tree_util.tree_map(
        lambda mu: np.asarray(mu) / 0.1, opt_state[0].mu))

    model = port_model(variables)
    assert sum(p.numel() for p in model.parameters()) == 1_978_209
    _, port_step = make_occupancy_train_step(model, lr)
    got_m = port_step(*(torch.from_numpy(a) for a in batch))
    np.testing.assert_allclose(float(got_m["loss"]), float(m["loss"]),
                               rtol=1e-5)
    got = flatten_params(params_to_jax(
        {n: p.grad for n, p in model.named_parameters()}, model)["params"])
    assert got.keys() == want.keys()
    zero = 1e-6 * max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        if np.abs(w).max() < zero:
            assert np.abs(got[k]).max() < zero, k
            continue
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


def test_occupancy_adam_updates_are_optax_adam():
    """The implicit training's optimiser (the one
    `make_occupancy_train_step` returns) against optax.adam as the JAX
    package's jitted train step runs it (under `jit`: XLA's fused
    multiply-adds) over 12 steps on gradients over eight decades: each
    step's update (read on weights reset to 0 before it, Adam's update not
    depending on them) within 1e-6 of optax's, relative, and the moments
    bit-equal; steps 1-2 bit-equal. `torch.optim.Adam` takes the bias
    corrections in float64, 6.4e-6 of each update away from optax's
    float32 ones in the first steps, and misses at every step."""
    import jax
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(0)
    shapes = [(3, 32), (32,), (3, 3, 32, 64), (1,)]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.uniform(-8, 0, s)).astype(
        np.float32) for s in shapes] for _ in range(12)]
    tx = optax.adam(1e-4)
    zeros = [jnp.zeros(s, jnp.float32) for s in shapes]
    state, update = tx.init(zeros), jax.jit(tx.update)
    ours = torch.nn.ParameterList(torch.zeros(s) for s in shapes)
    theirs = [torch.zeros(s, requires_grad=True) for s in shapes]
    opts = (make_occupancy_train_step(ours, 1e-4)[0], torch.optim.Adam(
        theirs, lr=1e-4, betas=(0.9, 0.999), eps=1e-8))
    torch_gaps = []
    for t, g in enumerate(grads, 1):
        updates, state = update([jnp.asarray(a) for a in g], state, zeros)
        for ws, opt in zip((ours, theirs), opts):
            with torch.no_grad():
                for w, a in zip(ws, g):
                    w.zero_()
                    w.grad = torch.from_numpy(a)
            opt.step()
        gaps = []
        for ws in (ours, theirs):
            gaps.append(max(float(np.max(np.abs(
                w.detach().numpy() - np.asarray(u)) / np.abs(np.asarray(u))))
                for w, u in zip(ws, updates)))
        assert gaps[0] <= 1e-6, (t, gaps)
        if t <= 2:
            for w, u in zip(ours, updates):
                np.testing.assert_array_equal(w.detach().numpy(),
                                              np.asarray(u))
        for w, mu, nu in zip(ours, state[0].mu, state[0].nu):
            np.testing.assert_array_equal(
                opts[0].state[w]["exp_avg"].numpy(), np.asarray(mu))
            np.testing.assert_array_equal(
                opts[0].state[w]["exp_avg_sq"].numpy(), np.asarray(nu))
        torch_gaps.append(gaps[1])
    assert min(torch_gaps) > 1e-6, torch_gaps


# -- the mode against its first form ------------------------------------


class FunctionModeReference(TorchFunctionMode):
    """The mode's first form: a `TorchFunctionMode` that sees every torch
    call and sends the same products through `tpu_precision._Rounded`."""

    WEIGHTED = {torch.nn.functional.linear, torch.nn.functional.conv1d,
                torch.nn.functional.conv2d, torch.nn.functional.conv3d,
                torch.nn.functional.conv_transpose1d,
                torch.nn.functional.conv_transpose2d,
                torch.nn.functional.conv_transpose3d}
    PRODUCTS = {torch.matmul, torch.bmm, torch.mm, torch.Tensor.matmul,
                torch.Tensor.bmm, torch.Tensor.mm, torch.Tensor.__matmul__}

    def __init__(self):
        super().__init__()
        self.counts = {}
        self.full = tpu_precision._full_precision_codes()

    def _count(self, key):
        self.counts[key] = self.counts.get(key, 0) + 1

    @staticmethod
    def _caller():
        f = sys._getframe(2)
        skip = (os.path.join("torch", "overrides.py"),
                os.path.join("torch", "functional.py"), __file__)
        while f is not None and f.f_code.co_filename.endswith(skip):
            f = f.f_back
        return None if f is None else f.f_code

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        apply = tpu_precision._apply
        if func in self.WEIGHTED:
            x, w, *rest = args
            bias = rest[0] if rest else kwargs.pop("bias", None)
            tail = rest[1:]
            self._count(func.__name__)
            return apply(lambda *a: func(*a, *tail, **kwargs), 2, True,
                         (x, w, bias))
        if func is torch.einsum or func in self.PRODUCTS:
            if self._caller() in self.full:
                self._count("full precision")
                return func(*args, **kwargs)
            if func is torch.einsum:
                eq, *ops = args
                self._count("einsum")
                return apply(lambda *o: torch.einsum(eq, *o), len(ops),
                             False, tuple(ops))
            self._count(func.__name__)
            return apply(lambda *a: func(*a, **kwargs), 2, False,
                         tuple(args))
        return func(*args, **kwargs)


def _small_step(mode):
    """One train step of a small ConvONet (c_dim/hidden 8, 16^2 planes)
    under `mode`, plus a product, an einsum and a full-precision product
    on leaves that need gradients: -> (loss, extra outputs, gradients,
    counts)."""
    model = ConvOccupancyNetwork(8, 8, 16)
    init_occupancy_model(model, 0)
    _, step = make_occupancy_train_step(model, 1e-4)
    rng = np.random.default_rng(3)
    pc = torch.from_numpy(rng.uniform(-.45, .45, (2, 64, 3)).astype(np.float32))
    q = torch.from_numpy(rng.uniform(-.55, .55, (2, 128, 3)).astype(np.float32))
    occ = torch.from_numpy((rng.random((2, 128)) < .5).astype(np.float32))
    a = torch.from_numpy(rng.normal(size=(2, 30, 20)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2, 20, 10)).astype(np.float32))
    a.requires_grad_()
    b.requires_grad_()
    from if_defense_tpu_torch.ops.pointops import square_distance

    with mode as m:
        loss = step(pc, q, occ)["loss"]
        extra = [a @ b, torch.bmm(a, b), torch.einsum("bij,bjk->bik", a, b),
                 square_distance(a, a)]
        sum(e.square().sum() for e in extra).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    grads.update(a=a.grad, b=b.grad)
    return loss, extra, grads, dict(m.counts)


def test_patched_mode_equals_function_mode_bit_for_bit():
    want = _small_step(FunctionModeReference())
    got = _small_step(tpu_precision.tpu_default_precision())
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)
    assert got[2].keys() == want[2].keys()
    for k in want[2]:
        assert torch.equal(got[2][k], want[2][k]), k
    assert got[3] == want[3]
    assert got[3]["full precision"] == 1 and got[3]["einsum"] == 1
    assert got[3]["matmul"] == 1 and got[3]["bmm"] == 1
    # and the entry points are torch's own again
    assert torch.nn.functional.linear is torch._C._nn.linear
    assert "__matmul__" not in vars(torch.Tensor)


def test_mode_legs_covers_only_the_named_legs(tmp_path):
    """`--mode_legs`' seam: `Legs.run` runs each CLI call inside
    `Legs.context(leg)`, and `mode_legs` enters the mode for the legs
    whose names start with one of its words, and only for them."""
    from tools import accuracy_benchmark_torch as acc

    x, w = torch.randn(4, 8), torch.randn(3, 8)

    def cli(argv):
        return torch.nn.functional.linear(x, w)

    default = acc.Legs.context
    context, modes = tpu_precision.mode_legs(["train_implicit"])
    acc.Legs.context = staticmethod(context)
    try:
        legs = acc.Legs(str(tmp_path / "legs.json"), "cpu")
        rounded = legs.run("train_implicit convonet", cli, [])
        plain = legs.run("defend convonet_opt hard8.npz", cli, [])
    finally:
        acc.Legs.context = staticmethod(default)
    assert [m.counts for m in modes] == [{"linear": 1}]
    assert torch.equal(rounded, torch.nn.functional.linear(
        tpu_precision.round_bf16(x), tpu_precision.round_bf16(w)))
    assert torch.equal(plain, x @ w.T)
    assert [r["leg"] for r in legs.rows] == ["train_implicit convonet",
                                             "defend convonet_opt hard8.npz"]
    assert torch.nn.functional.linear is torch._C._nn.linear


def test_paired_view_prints_c_minus_a_with_each_verdict(tmp_path):
    """`tools/accuracy_vs_jax.py ARM_C --paired ARM_A`: a row a seed and
    defended cell, each arm's band verdict against JAX's, and C - A; a
    run with one opt mode has its bare `convonet_opt` read as f32."""
    import json

    from tools import accuracy_vs_jax

    def write(arm, seed, knn_opt):
        d = tmp_path / arm / f"seed{seed}"
        d.mkdir(parents=True)
        res = {"seed": seed, "victims": {"pointnet": {
            "clean_accuracy": 1.0, "attacks": {"knn": {
                "success_rate": 0.8, "attacked": {"accuracy": 0.2},
                "defended": {"convonet_opt": {"accuracy": knn_opt},
                             "sor": {"accuracy": 0.9}}}}}}}
        (d / "results.json").write_text(json.dumps(res))

    for seed, (a, c) in enumerate([(0.9175, 0.955), (0.95, 0.94)]):
        write("A", seed, a)
        write("C", seed, c)
    jax = {"pointnet/knn/convonet_opt:f32": {"mean": 0.9517, "std": 0.0014},
           "pointnet/knn/sor": {"mean": 0.906, "std": 0.018},
           "pointnet/knn/attacked": {"mean": 0.106, "std": 0.048}}
    lines = accuracy_vs_jax.paired(str(tmp_path / "C"), str(tmp_path / "A"),
                                   jax)
    rows = {tuple(c.strip() for c in line.split("|")[1:3]): line
            for line in lines if line.startswith("| 0") or
            line.startswith("| 1")}
    assert "| **OUT** | 95.50 | in | +3.75 |" in rows[
        ("0", "pointnet/knn/convonet_opt:f32")]
    assert "| 95.00 | in | 94.00 | in | -1.00 |" in rows[
        ("1", "pointnet/knn/convonet_opt:f32")]
    assert "+0.00" in rows[("0", "pointnet/knn/sor")]
    assert len(rows) == 6               # 2 seeds x (attacked, sor, opt)
