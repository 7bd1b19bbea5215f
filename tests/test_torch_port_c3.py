"""ConvONet-Opt at the accuracy protocol's size and precision, PyTorch port
vs JAX package, and the TPU-precision diagnostic mode
(`tools/tpu_precision.py`).

The defense: both packages restore B = 4 clouds of the hard synthetic
family (`tools/synthetic_dataset.py`, 1024 points, a few outliers added
so that SOR flags points) with the flags `tools/accuracy_benchmark_torch.py`
passes to `cli/opt_defense.py` in its f32 mode: the reference mode, 200
iterations (201 Adam steps), the CLI's SOR (k 2, alpha 1.1), encoder
subset (600 points), initial points (1024, sigma 0.01), lr, repulsion
weight and threshold, on the full-width ConvONet the protocol trains,
from the same perturbed seeded weights (`init_params(0)`, every tensor
moved as `tests/test_torch_port_defense.py` moves them). `jax.random`
cannot be reproduced in torch, so the encoder subset and the initial
points are drawn the JAX way and handed to the port through its `draws`
seam (`tools/defense_vs_jax.py`, which runs the same comparison on a
whole protocol batch). JAX runs its fused repulsion kernel forced on the
CPU (IFDEF_FORCE_FUSED_REPULSION=1, interpret mode): the exact k-nearest
selection that the TPU ran and that the port computes on the CPU
(ROADMAP's deliberate differences).

Tolerances. chip_smoke's restoration gate, >= 99.9 % of coordinates
within 1e-4, holds over the first 4 Adam steps. Over all 201 it holds for
no pair of f32 runs: Adam steps each coordinate by about lr sign(g), and
a gradient that rounding moves across a ReLU's kink, or near 0, sends the
coordinate another way, which later steps carry on. The JAX package
itself, given the same clouds with half their coordinates moved by one
unit in the last place, keeps 57.6 % of the coordinates within 1e-4 of
its own result at 201 steps (largest gap 4.2e-2), where the port keeps
51.6 % (6.9e-2). So at 201 steps the test holds the port's gap from JAX
to that yardstick, run beside it: the share within 1e-4 no more than 0.1
below the yardstick's, the mean coordinate gap and the symmetric Chamfer
distance no more than 1.5 times the yardstick's, and the Chamfer distance
under 5 % of the restored clouds' point spacing (the surfaces agree).
The largest gaps are printed. A control shows that these bounds see a
fault of the size a port could make: the port with its repulsion weight
halved, run beside the others, must miss the share, mean-gap and Chamfer
bounds.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from if_defense_tpu_torch.utils.params_io import (
    flatten_params,
    init_params,
    unflatten_params,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.defense_vs_jax import (  # noqa: E402
    FLAGS,
    NEAR,
    gaps,
    in_thread,
    jax_draws,
    nudged,
    restore_jax,
    restore_port,
    spacing,
)
from tools.synthetic_dataset import (  # noqa: E402
    HARD_CLASSES,
    _hard_surface,
    _normalize,
)
from tools.tpu_precision import round_bf16, tpu_default_precision  # noqa: E402

B, N, OUTLIERS = 4, 1024, 8
SHARE = 0.999                       # chip_smoke's gate: within NEAR = 1e-4
YARD_SHARE, YARD_RATIO, SURFACE = 0.1, 1.5, 0.05


@pytest.fixture(autouse=True)
def _one_cpu_thread(monkeypatch):
    """torch's CPU ops in one thread, as in the other port parity files
    (ROADMAP.md section C); JAX's fused repulsion kernel forced."""
    monkeypatch.setenv("IFDEF_FORCE_FUSED_REPULSION", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hard_clouds(seed: int, b: int) -> np.ndarray:
    """`b` clouds of the hard family (one a class, in order), each
    normalised to the unit sphere as the dataset writes them, with
    `OUTLIERS` points moved 1.5-2.5 radii out along random directions."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(b):
        p, _ = _hard_surface(HARD_CLASSES[i % len(HARD_CLASSES)], N, rng)
        pn, _, _ = _normalize(p)
        d = rng.normal(size=(OUTLIERS, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        pn[rng.choice(N, OUTLIERS, replace=False)] = \
            d * rng.uniform(1.5, 2.5, (OUTLIERS, 1))
        out.append(pn)
    return np.stack(out).astype(np.float32)


def perturbed_weights(seed: int) -> dict:
    """The protocol model's seeded weights (`init_params`), every tensor
    moved by a seeded normal step as the parity tests do."""
    rng = np.random.default_rng(seed + 100)
    flat = {k: (v + (0.3 / np.sqrt(np.prod(v.shape[:-1])) if v.ndim > 1
                     else 0.05) * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in flatten_params(init_params(seed)).items()}
    return unflatten_params(flat)


def test_protocol_defense_first_steps_within_gate():
    """The protocol's ConvONet-Opt, B = 4 x 1024 points, over its first 4
    Adam steps (iterations = 3): the port within chip_smoke's gate of
    JAX."""
    pc, variables = hard_clouds(0, B), perturbed_weights(0)
    key, flags = jax.random.key(0), dict(FLAGS, iterations=3)
    want = in_thread(restore_jax, pc, variables, key, flags)
    got = restore_port(pc, variables, jax_draws(pc, key, flags), flags)
    g = gaps(got, want())
    print(f"4 steps: {g}")
    assert np.isfinite(got).all() and got.shape == (B, N, 3)
    assert g["within_1e-4"] >= SHARE, g


# planted faults the 201-step bounds must see: the port's flags changed
FAULTS = {"repulsion weight halved":
          dict(FLAGS, rep_weight=FLAGS["rep_weight"] / 2)}


@pytest.fixture(scope="module")
def protocol():
    """The protocol's ConvONet-Opt, f32 reference mode, B = 4 x 1024
    points, all 201 steps, side by side in threads: JAX's, JAX's on the
    clouds moved by one ulp (the yardstick), the port's with JAX's draws,
    and the port's with each of `FAULTS`."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IFDEF_FORCE_FUSED_REPULSION", "1")
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            pc, variables = hard_clouds(0, B), perturbed_weights(0)
            key = jax.random.key(0)
            want = in_thread(restore_jax, pc, variables, key)
            yard = in_thread(restore_jax, nudged(pc), variables, key)
            draws = jax_draws(pc, key)
            faulty = {name: in_thread(restore_port, pc, variables, draws,
                                      flags)
                      for name, flags in FAULTS.items()}
            stats = {}
            got = restore_port(pc, variables, draws, stats=stats)
            return {"want": want(), "yard": yard(), "got": got,
                    "stats": stats,
                    "faulty": {k: f() for k, f in faulty.items()}}
        finally:
            torch.set_num_threads(n)


def yardstick_misses(got: np.ndarray, run: dict) -> list:
    """The 201-step bounds (module docstring) that the restoration `got`
    misses, held against JAX's and its one-ulp yardstick in `run`."""
    g, y = gaps(got, run["want"]), gaps(run["yard"], run["want"])
    print(f"201 steps: {g}; JAX vs JAX one ulp: {y}; point spacing "
          f"{spacing(run['want']):.4f}")
    return [name for name, ok in (
        ("share", g["within_1e-4"] >= y["within_1e-4"] - YARD_SHARE),
        ("mean", g["mean"] <= YARD_RATIO * y["mean"]),
        ("chamfer", g["chamfer"] <= YARD_RATIO * y["chamfer"]),
        ("surface", g["chamfer"] <= SURFACE * spacing(run["want"])))
        if not ok]


def test_protocol_defense_matches_jax(protocol):
    """All 201 steps: the port's gap from JAX no wider than JAX's gap from
    itself on clouds moved by one ulp, run beside it (module
    docstring)."""
    got, want = protocol["got"], protocol["want"]
    assert got.shape == want.shape == (B, FLAGS["sample_npoint"], 3)
    assert np.isfinite(got).all()
    assert yardstick_misses(got, protocol) == []
    stats = protocol["stats"]
    assert float(stats["occ_loss_last"]) < float(stats["occ_loss_first"])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_protocol_bounds_see_a_planted_fault(protocol, fault):
    """The control: the port with a planted fault, run beside the others,
    misses the share, mean-gap and Chamfer bounds that the port meets."""
    got = protocol["faulty"][fault]
    assert np.isfinite(got).all()
    assert {"share", "mean", "chamfer"} <= set(
        yardstick_misses(got, protocol)), fault


# -- the TPU-precision mode ---------------------------------------------


def test_mode_linear_and_conv_round_operands_bit_for_bit():
    """Under the mode a Linear and a Conv2d give their f32 op on
    bf16-rounded input and weight (the bias in f32), bit for bit, and
    their input gradient is the same products' backward on the
    bf16-rounded incoming gradient."""
    gen = torch.Generator().manual_seed(0)
    lin, conv = torch.nn.Linear(48, 32), torch.nn.Conv2d(8, 16, 3, padding=1)
    x = torch.randn(64, 48, generator=gen, requires_grad=True)
    xi = torch.randn(2, 8, 12, 12, generator=gen, requires_grad=True)
    g = torch.randn(64, 32, generator=gen)
    with tpu_default_precision() as mode:
        y, z = lin(x), conv(xi)
        y.backward(g)
    assert mode.counts == {"linear": 1, "conv2d": 1}
    assert torch.equal(y, F.linear(round_bf16(x), round_bf16(lin.weight),
                                   lin.bias))
    assert torch.equal(z, F.conv2d(round_bf16(xi), round_bf16(conv.weight),
                                   conv.bias, padding=1))
    assert torch.equal(x.grad, round_bf16(g) @ round_bf16(lin.weight))
    assert torch.equal(lin.bias.grad, g.sum(0))
    assert not torch.equal(y, lin(x))             # f32 outside the mode


def test_mode_agrees_with_jax_default_dot():
    """The mode's Linear against JAX's TPU-default product,
    `jnp.dot(x.astype(bf16), w.astype(bf16), preferred_element_type=f32)`,
    within f32 rounding of the accumulation (both sum exact products of
    bf16 values in f32, in orders of their own)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 96)).astype(np.float32)
    w = rng.normal(size=(96, 40)).astype(np.float32)
    with tpu_default_precision():
        got = F.linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()))
    want = np.asarray(jnp.dot(jnp.asarray(x).astype(jnp.bfloat16),
                              jnp.asarray(w).astype(jnp.bfloat16),
                              preferred_element_type=jnp.float32))
    scale = np.abs(x) @ np.abs(w)
    assert np.all(np.abs(got.numpy() - want) <= 96 * 2.0**-23 * scale)
    f32 = x @ w                                      # and not the f32 one
    assert np.abs(got.numpy() - f32).max() > 100 * np.abs(
        got.numpy() - want).max()


def test_mode_leaves_other_ops_and_restores():
    """Ops outside the list are untouched, the products JAX asks HIGHEST
    for (`square_distance`'s) keep f32, and leaving the mode restores
    both f32 products and TF32's settings."""
    from if_defense_tpu_torch.ops.pointops import square_distance

    gen = torch.Generator().manual_seed(2)
    a, b = torch.randn(1, 50, 3, generator=gen), torch.randn(
        1, 40, 3, generator=gen)
    m1, m2 = torch.randn(30, 20, generator=gen), torch.randn(
        20, 10, generator=gen)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    with tpu_default_precision() as mode:
        d = square_distance(a, b)
        s = torch.add(m1, 1.5).sum()
        p = m1 @ m2
        assert not torch.backends.cuda.matmul.allow_tf32
    assert mode.counts == {"full precision": 1, "matmul": 1}
    assert torch.equal(d, square_distance(a, b))
    assert torch.equal(s, torch.add(m1, 1.5).sum())
    assert torch.equal(p, round_bf16(m1) @ round_bf16(m2))
    assert not torch.equal(m1 @ m2, p)
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == tf32
