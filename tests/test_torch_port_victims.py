"""The port's victim classifiers against the JAX package's on the CPU.

For each of the five victims (`models/__init__.py` registry), the JAX
victim's flax variables from `model.init`, with every tensor perturbed
(flax zero-initialises STN's last Dense, which would hide the transform),
and their batch-norm statistics calibrated on the test clouds and then
perturbed (`calibrated`), are carried into the port's victim by
`params_from_jax`; both run in eval
mode on the same numpy inputs, unmasked and masked (~80 % valid points).
Sizes: B = 2, N = 64 (the level sizes of the published widths exceed N
there; FPS then repeats points as in the reference), and PointNet++ once
at N = 1024.

Before the logits, the selections of each victim's point ops (FPS, ball
query, kNN) are compared on the same inputs, so that a flipped selection
is reported as such and not as a logit mismatch: the first two levels'
inputs (level 2's from JAX's level 1), and for DGCNN the kNN graph of every
EdgeConv block's input features (JAX's intermediates).

Tolerance (f32 on both sides, sums in other orders through up to ~15
layers): logits and PointNet's aux within rtol 1e-5 and atol 1e-5 of the
largest magnitude of the reference (measured: up to 9e-7 of it);
selections exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from if_defense_tpu import ops as jops
from if_defense_tpu.models import build_model as jax_build_model
from if_defense_tpu_torch import ops
from if_defense_tpu_torch.models import MODEL_REGISTRY, build_model
from if_defense_tpu_torch.models.pointnet import feature_transform_regularizer
from if_defense_tpu_torch.utils.params_io import (
    flatten_params,
    params_from_jax,
    params_to_jax,
    unflatten_params,
)

RTOL, ATOL = 1e-5, 1e-5
NAMES = ("pointnet", "pointnet2", "dgcnn", "pointconv", "rscnn")
# (fps centres, radius or None for kNN, group size) of levels 1 and 2
LEVELS = {"pointnet2": ((512, 0.2, 32), (128, 0.4, 64)),
          "rscnn": ((512, 0.23, 48), (128, 0.32, 64)),
          "pointconv": ((512, None, 32), (128, None, 64))}


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


def perturbed(variables, seed):
    """Every tensor moved off its init: kernels by 0.3/sqrt(fan_in), other
    tensors by 0.05, batch-norm variances scaled by exp(0.2 N(0, 1))."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flatten_params(jax.tree_util.tree_map(np.asarray,
                                                      variables)).items():
        n = rng.normal(size=v.shape)
        if k.endswith("/var"):
            v = v * np.exp(0.2 * n)
        else:
            v = v + (0.3 / np.sqrt(np.prod(v.shape[:-1])) if v.ndim > 1
                     else 0.05) * n
        out[k] = v.astype(np.float32)
    return unflatten_params(out)


def calibrated(jm, variables, pc, seed):
    """The variables with every batch norm's running statistics set to the
    statistics of its input on the clouds `pc` (or on the tuple of
    arguments `pc`; one train-mode forward from zeroed statistics: flax
    then holds 0.1 x the batch's), then perturbed
    (means by 0.1 std, variances scaled by exp(0.2 N(0, 1))). With flax's
    unit statistics, a batch norm's input need not be centred, and a ReLU
    behind it can be dead for every point (PointConv's DensityNet ends in
    one): the comparison would then hold constants."""
    zero = jax.tree_util.tree_map(np.zeros_like, variables["batch_stats"])
    args = pc if isinstance(pc, tuple) else (jnp.asarray(pc),)
    _, upd = jm.apply({**variables, "batch_stats": zero}, *args,
                      train=True, mutable=["batch_stats"],
                      rngs={"dropout": jax.random.key(seed)})
    rng = np.random.default_rng(seed)
    stats = {k: np.asarray(v) / 0.1 for k, v in flatten_params(
        jax.tree_util.tree_map(np.asarray, upd["batch_stats"])).items()}
    for k, v in stats.items():
        n = rng.normal(size=v.shape)
        if k.endswith("/var"):
            stats[k] = v * np.exp(0.2 * n)
        else:
            stats[k] = v + 0.1 * np.sqrt(stats[k[:-len("mean")] + "var"]) * n
    return {"params": variables["params"], "batch_stats": unflatten_params(
        {k: v.astype(np.float32) for k, v in stats.items()})}


def inputs(seed, b=2, n=64):
    """Clouds in the unit ball and a validity mask with ~80 % valid."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(b, n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pc = (d * rng.uniform(0.2, 1.0, (b, n, 1))).astype(np.float32)
    mask = rng.uniform(size=(b, n)) > 0.2
    mask[:, 0] = False                      # the first valid point is not 0
    return pc, mask


def victims(name, seed, pc):
    """(JAX model, perturbed variables with statistics calibrated on the
    clouds `pc`, the port's model with them)."""
    jm = jax_build_model(name)
    variables = calibrated(jm, perturbed(jm.init(
        jax.random.key(seed), jnp.asarray(pc), train=False), seed), pc, seed)
    pm = build_model(name)
    pm.load_state_dict(params_from_jax(variables, pm), strict=True)
    return jm, variables, pm.eval()


def close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * float(np.abs(want).max()),
                               err_msg=what)


def check_selections(name, pc, mask, jm, variables):
    """The victim's FPS / ball-query / kNN selections, JAX's against the
    port's on the same inputs (level 2 from JAX's level-1 centres)."""
    t = torch.from_numpy
    for m in (None, mask):
        tm = None if m is None else t(m)
        jmask = None if m is None else jnp.asarray(m)
        if name in LEVELS:
            xyz = pc
            for lvl, (s, radius, ns) in enumerate(LEVELS[name]):
                lm, jlm = (tm, jmask) if lvl == 0 else (None, None)
                want = np.asarray(jops.farthest_point_sample(
                    jnp.asarray(xyz), s, mask=jlm))
                got = ops.farthest_point_sample(t(xyz), s, mask=lm).numpy()
                np.testing.assert_array_equal(
                    got, want, err_msg=f"{name} level {lvl} FPS flipped")
                new = np.take_along_axis(xyz, want[..., None], axis=1)
                if radius is None:
                    want = np.asarray(jops.knn_points(
                        ns, jnp.asarray(xyz), jnp.asarray(new),
                        candidate_mask=jlm))
                    got = ops.knn_points(ns, t(xyz), t(new),
                                         candidate_mask=lm).numpy()
                else:
                    want = np.asarray(jops.query_ball_point(
                        radius, ns, jnp.asarray(xyz), jnp.asarray(new),
                        mask=jlm))
                    got = ops.query_ball_point(radius, ns, t(xyz), t(new),
                                               mask=lm).numpy()
                np.testing.assert_array_equal(
                    got, want, err_msg=f"{name} level {lvl} grouping flipped")
                xyz = new
        elif name == "dgcnn":
            _, state = jm.apply(variables, jnp.asarray(pc), train=False,
                                mask=jmask, capture_intermediates=True)
            inter = state["intermediates"]
            feats = [pc] + [np.asarray(inter[f"PointwiseMLP_{i}"]["__call__"]
                                       [0]).max(axis=2) for i in range(3)]
            for i, x in enumerate(feats):
                want = np.asarray(jops.knn_points(20, jnp.asarray(x),
                                                  candidate_mask=jmask))
                got = ops.knn_points(20, t(x), candidate_mask=tm).numpy()
                np.testing.assert_array_equal(
                    got, want, err_msg=f"dgcnn block {i} kNN flipped")


@pytest.mark.parametrize("name", NAMES)
def test_victim_matches_jax(name):
    """Selections, then logits (and PointNet's aux), unmasked and masked."""
    pc, mask = inputs(1)
    jm, variables, pm = victims(name, 2, pc)
    check_selections(name, pc, mask, jm, variables)
    for m in (None, mask):
        want, jaux = jm.apply(variables, jnp.asarray(pc), train=False,
                              mask=None if m is None else jnp.asarray(m))
        with torch.no_grad():
            got, aux = pm(torch.from_numpy(pc),
                          None if m is None else torch.from_numpy(m))
        tag = f"{name} {'masked' if m is not None else 'unmasked'}"
        assert got.shape == (2, 40) and torch.isfinite(got).all()
        # the two clouds' logits differ: no layer holds a constant
        assert float((got[0] - got[1]).abs().max()) > 1e-2 * float(
            got.abs().max())
        close(got, want, f"{tag} logits")
        assert set(aux) == set(jaux)
        for k in aux:
            close(aux[k], jaux[k], f"{tag} aux {k}")


def test_pointnet2_matches_jax_at_1024_points():
    """PointNet++ at the published cloud size, where SA1 takes 512 of 1024
    points and its ball query fills 32 slots."""
    pc, mask = inputs(3, n=1024)
    jm, variables, pm = victims("pointnet2", 4, pc)
    check_selections("pointnet2", pc, mask, jm, variables)
    for m in (None, mask):
        want, _ = jm.apply(variables, jnp.asarray(pc), train=False,
                           mask=None if m is None else jnp.asarray(m))
        with torch.no_grad():
            got, _ = pm(torch.from_numpy(pc),
                        None if m is None else torch.from_numpy(m))
        close(got, want, f"pointnet2 N=1024 mask={m is not None}")


def test_masked_forward_equals_compacted_cloud():
    """With a mask, a victim in eval mode scores the valid points alone:
    PointNet and DGCNN (pools and kNN candidates masked) equal the
    forward of the compacted cloud."""
    pc, mask = inputs(5, b=1)
    for name in ("pointnet", "dgcnn"):
        _, _, pm = victims(name, 6, pc)
        with torch.no_grad():
            got, _ = pm(torch.from_numpy(pc), torch.from_numpy(mask))
            want, _ = pm(torch.from_numpy(pc[:, mask[0]]))
        torch.testing.assert_close(got, want, rtol=RTOL,
                                   atol=ATOL * float(want.abs().max()))


def test_params_to_jax_round_trip():
    """A port-saved tree loads in the JAX victim and gives its logits; the
    round trip through both layouts is exact, for every victim."""
    pc, _ = inputs(7)
    for name in NAMES:
        torch.manual_seed(0)
        pm = build_model(name).eval()
        tree = params_to_jax(pm.state_dict(), pm)
        back = build_model(name)
        back.load_state_dict(params_from_jax(tree, back), strict=True)
        for k, v in pm.state_dict().items():
            assert torch.equal(back.state_dict()[k], v), k
        assert set(tree) == {"params", "batch_stats"}
        jm = jax_build_model(name)
        want = jax.eval_shape(
            lambda: jm.init(jax.random.key(0), jnp.zeros((2, 64, 3))))
        assert ({k: v.shape for k, v in flatten_params(tree).items()}
                == {k: v.shape for k, v in flatten_params(
                    jax.tree_util.tree_map(
                        lambda a: np.zeros(a.shape, a.dtype), want)).items()})
        if name == "pointnet":
            jl, _ = jm.apply(tree, jnp.asarray(pc), train=False)
            with torch.no_grad():
                pl, _ = pm(torch.from_numpy(pc))
            close(pl, jl, "pointnet round trip")


def test_registry_and_regularizer():
    with pytest.raises(ValueError, match="unknown model"):
        build_model("nope")
    assert sorted(MODEL_REGISTRY) == sorted(NAMES)
    assert isinstance(build_model("PointNet"), MODEL_REGISTRY["pointnet"])
    from if_defense_tpu.models import feature_transform_regularizer as jreg

    t = np.random.default_rng(8).normal(size=(3, 4, 4)).astype(np.float32)
    close(feature_transform_regularizer(torch.from_numpy(t)),
          jreg(jnp.asarray(t)), "regularizer")


def test_msg_and_feature_propagation_match_jax():
    """PointNet++'s multi-scale set abstraction and feature propagation
    (no classifier of the registry uses them): outputs against JAX's."""
    from if_defense_tpu.models.pointnet2 import (
        FeaturePropagation as JaxFP,
    )
    from if_defense_tpu.models.pointnet2 import (
        SetAbstractionMsg as JaxMsg,
    )
    from if_defense_tpu_torch.models.pointnet2 import (
        FeaturePropagation,
        SetAbstractionMsg,
    )

    pc, _ = inputs(9, n=128)
    feats = np.random.default_rng(10).normal(size=(2, 128, 5)).astype(
        np.float32)
    cases = (
        (JaxMsg(32, (0.2, 0.4), (8, 16), ((8, 16), (8, 12))),
         SetAbstractionMsg(32, (0.2, 0.4), (8, 16), 5, ((8, 16), (8, 12))),
         (pc, feats)),
        (JaxFP((16, 8)), FeaturePropagation(5 + 4, (16, 8)),
         (pc, pc[:, :32], feats, feats[:, :32, :4])),
        (JaxFP((8,)), FeaturePropagation(5 + 4, (8,)),
         (pc, pc[:, :1], feats, feats[:, :1, :4])),
    )
    for i, (jmod, pmod, args) in enumerate(cases):
        jargs = [jnp.asarray(a) for a in args]
        variables = calibrated(jmod, perturbed(jmod.init(
            jax.random.key(i), *jargs, train=False), i), tuple(jargs), i)
        pmod.load_state_dict(params_from_jax(variables, pmod), strict=True)
        want = jmod.apply(variables, *jargs, train=False)
        with torch.no_grad():
            got = pmod.eval()(*[torch.from_numpy(a) for a in args])
        if isinstance(want, tuple):               # (new_xyz, features)
            np.testing.assert_array_equal(got[0].numpy(), want[0])
            want, got = want[1], got[1]
        close(got, want, type(pmod).__name__)
