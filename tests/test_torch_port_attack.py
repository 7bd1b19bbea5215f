"""The port's attack library against the JAX package's on the CPU.

The same numpy inputs, made from a seed, go through both packages; JAX's
random draws reach the port through each attack's `draws` seam (the CW
init normals per binary step, the kNN/FGM/PGD starts, PGD's uniforms, the
object attack's three draws of a step). The victims are the linear toy of
`tests/test_attack.py:34` (logits = sum of the points @ W, any N) and, for
Drop and the mixed mode, PointNet with `params_from_jax` weights.

Tolerances:
- distances, losses and clips: values rtol 1e-6 (atol 1e-6 of the inputs'
  scale, for the distance matrix's expansion form), gradients rtol 1e-5;
- the attacks (at most 5 iterations): adversarial clouds within atol 1e-5,
  best distances within rtol 1e-4 (Adam's arithmetic in another order),
  success masks equal;
- DBSCAN, the cluster and object inits, the template object and Drop's
  kept sets: exactly equal;
- chunked against unchunked runs of the port: bit-equal;
- the mixed mode: logits within 2 % of the largest f32 logit, as in
  `tests/test_attack.py:153`.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from if_defense_tpu import ops as jops
from if_defense_tpu.attack import clip as jclip
from if_defense_tpu.attack import cw as jcw
from if_defense_tpu.attack import cw_cluster as jcluster
from if_defense_tpu.attack import drop as jdrop
from if_defense_tpu.attack import losses as jlosses
from if_defense_tpu.models import build_model as jax_build_model
from if_defense_tpu_torch import ops
from if_defense_tpu_torch.attack import clip, cw, cw_cluster, drop, losses
from if_defense_tpu_torch.attack.mixed import (
    cast_trunk_bf16,
    make_mixed_logits_fn,
)
from if_defense_tpu_torch.models import build_model
from if_defense_tpu_torch.utils.params_io import params_from_jax
from test_torch_port_victims import perturbed

# the packages export a function `fgm` that hides the module of that name
jfgm = importlib.import_module("if_defense_tpu.attack.fgm")
fgm = importlib.import_module("if_defense_tpu_torch.attack.fgm")
NC = 4
W = np.array(jax.random.normal(jax.random.key(42), (3, NC)))
ADV_ATOL, DIST_RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """torch's CPU ops in one thread (see ROADMAP.md section C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jtoy(pc):
    return jnp.sum(pc, axis=1) @ jnp.asarray(W)


def ttoy(pc):
    return pc.sum(dim=1) @ torch.from_numpy(W)


def jtoy_masked(pc, mask):
    return jnp.sum(pc * mask[..., None].astype(pc.dtype), axis=1) @ W


def ttoy_masked(pc, mask):
    return (pc * mask[..., None]).sum(dim=1) @ torch.from_numpy(W)


def toy_data(b=4, k=32, seed=0):
    """Clouds, their toy-victim labels and targets two classes on."""
    pc = (np.random.default_rng(seed).normal(size=(b, k, 3)) * 0.3).astype(
        np.float32)
    label = np.asarray(jtoy(pc)).argmax(-1)
    return pc, label, (label + 2) % NC


def t(x):
    return torch.from_numpy(np.array(x))


def normals(key, shape, n):
    """JAX's CW init draws: a standard normal per split of `key`."""
    return np.stack([np.asarray(jax.random.normal(k, shape))
                     for k in jax.random.split(key, n)])


def close(got, want, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


def value_and_grad_pair(jfn, tfn, *arrays):
    """Both packages' value of fn(*arrays) and its gradient to arrays[0]
    (through the sum of the [B] values)."""
    jval = jfn(*(jnp.asarray(a) for a in arrays))
    jgrad = jax.grad(lambda x: jnp.sum(jfn(x, *arrays[1:])))(
        jnp.asarray(arrays[0]))
    x = t(arrays[0]).requires_grad_(True)
    tval = tfn(x, *(t(a) for a in arrays[1:]))
    (tgrad,) = torch.autograd.grad(tval.sum(), x)
    return (tval, np.asarray(jval)), (tgrad, np.asarray(jgrad))


def test_distances_and_losses_match_jax():
    rng = np.random.default_rng(1)
    adv = rng.uniform(-1, 1, (3, 40, 3)).astype(np.float32)
    ori = rng.uniform(-1, 1, (3, 56, 3)).astype(np.float32)
    near = (ori[:, :40] + rng.normal(size=(3, 40, 3)) * 0.05).astype(
        np.float32)
    # [B] distances: rtol 1e-6 on values and 1e-5 on gradients
    for a2o, o2a in ((ops.chamfer_distance, jops.chamfer_distance),
                     (ops.hausdorff_distance, jops.hausdorff_distance)):
        for got, want in zip(a2o(t(adv), t(ori)), o2a(adv, ori)):
            close(got, want, rtol=1e-6, atol=1e-6)
    pairs = [(functools.partial(jlosses.chamfer_dist, method=m),
              functools.partial(losses.chamfer_dist, method=m), adv, ori)
             for m in ("adv2ori", "ori2adv", "both")]
    pairs += [(functools.partial(jlosses.hausdorff_dist, method=m),
               functools.partial(losses.hausdorff_dist, method=m), adv, ori)
              for m in ("adv2ori", "ori2adv", "both")]
    pairs += [(jlosses.l2_dist, losses.l2_dist, near, ori[:, :40]),
              (jlosses.l2_dist, losses.l2_dist, ori[:, :40], ori[:, :40]),
              (jlosses.chamfer_knn_dist, losses.chamfer_knn_dist, near,
               ori)]
    for k, alpha in ((5, 1.05), (3, 0.5)):
        pairs.append((functools.partial(jlosses.knn_dist, k=k, alpha=alpha),
                      functools.partial(losses.knn_dist, k=k, alpha=alpha),
                      near))
    clusters = near.reshape(3, 4, 10, 3)
    pairs.append((jlosses.farthest_dist, losses.farthest_dist, clusters))
    for jfn, tfn, *arrays in pairs:
        (tv, jv), (tg, jg) = value_and_grad_pair(jfn, tfn, *arrays)
        close(tv, jv, rtol=1e-6, atol=1e-6)
        close(tg, jg, rtol=1e-5, atol=1e-6)
    # the losses on logits, with a tie in one row
    logits = rng.normal(size=(5, 7)).astype(np.float32) * 3
    logits[2, 4] = logits[2, 1]
    target = np.array([0, 3, 1, 6, 2])
    for kappa in (0.0, 15.0):
        (tv, jv), (tg, jg) = value_and_grad_pair(
            functools.partial(jlosses.logits_adv_loss, kappa=kappa),
            lambda x, tg: losses.logits_adv_loss(x, tg, kappa), logits,
            target)
        close(tv, jv, rtol=1e-6)
        close(tg, jg, rtol=1e-5)
    (tv, jv), (tg, jg) = value_and_grad_pair(
        jlosses.cross_entropy_adv_loss, losses.cross_entropy_adv_loss,
        logits, target)
    close(tv, jv, rtol=1e-6)
    close(tg, jg, rtol=1e-5, atol=1e-7)
    occ = rng.uniform(size=(2, 4, 5, 6)).astype(np.float32)
    occ2 = rng.uniform(size=(2, 4, 5, 6)).astype(np.float32)
    close(ops.compute_iou(t(occ), t(occ2)), jops.compute_iou(occ, occ2),
          rtol=1e-6)


def test_clips_and_projection_match_jax():
    """The clips, and the projection with normals: points moved outward,
    inward (onto the tangent plane) and straight inward (back to their
    origin), and no normals at all."""
    rng = np.random.default_rng(2)
    ori = rng.normal(size=(3, 50, 3)).astype(np.float32)
    normal = rng.normal(size=(3, 50, 3))
    normal = (normal / np.linalg.norm(normal, axis=-1, keepdims=True)).astype(
        np.float32)
    diff = (rng.normal(size=(3, 50, 3)) * 0.2).astype(np.float32)
    diff[:, :10] = -0.3 * normal[:, :10]                 # straight inward
    pc = ori + diff
    inside = (diff * normal).sum(-1) < 0
    assert 10 < inside.sum() < 140
    for budget in (0.05, 100.0):
        close(clip.clip_points_l2(t(pc), t(ori), budget),
              jclip.clip_points_l2(pc, ori, budget), rtol=1e-6, atol=1e-6)
        close(clip.clip_points_linf(t(pc), t(ori), budget),
              jclip.clip_points_linf(pc, ori, budget), rtol=1e-6, atol=1e-6)
        close(clip.project_inner_clip_linf(t(pc), t(ori), t(normal), budget),
              jclip.project_inner_clip_linf(pc, ori, normal, budget),
              rtol=1e-6, atol=1e-6)
    got = clip.project_inner_points(t(pc), t(ori), t(normal))
    close(got, jclip.project_inner_points(pc, ori, normal), rtol=1e-6,
          atol=1e-6)
    np.testing.assert_allclose(got.numpy()[:, :10], ori[:, :10], atol=1e-6)
    np.testing.assert_array_equal(
        clip.project_inner_points(t(pc), t(ori), None).numpy(), pc)


def test_fgm_family_matches_jax():
    pc, _, target = toy_data()
    budget = 0.08 * np.sqrt(32 * 3)
    key = jax.random.key(5)
    jadv, jsucc = jfgm.fgm(jtoy, jnp.asarray(pc), jnp.asarray(target), budget)
    adv, succ = fgm.fgm(ttoy, t(pc), t(target), budget)
    close(adv, jadv, atol=ADV_ATOL)
    np.testing.assert_array_equal(succ.numpy(), np.asarray(jsucc))
    noise = np.asarray(jax.random.normal(key, pc.shape))
    for jf, tf in ((jfgm.ifgm, fgm.ifgm), (jfgm.mifgm, fgm.mifgm)):
        jadv, jsucc = jf(jtoy, jnp.asarray(pc), jnp.asarray(target), key,
                         budget, budget / 5, 5)
        adv, succ = tf(ttoy, t(pc), t(target), budget, budget / 5, 5,
                       draws=t(noise))
        close(adv, jadv, atol=ADV_ATOL)
        np.testing.assert_array_equal(succ.numpy(), np.asarray(jsucc))
    k1, k2 = jax.random.split(key)
    u = np.asarray(jax.random.uniform(k1, pc.shape))
    noise = np.asarray(jax.random.normal(k2, pc.shape))
    jadv, jsucc = jfgm.pgd(jtoy, jnp.asarray(pc), jnp.asarray(target), key,
                           budget, budget / 5, 5)
    adv, succ = fgm.pgd(ttoy, t(pc), t(target), budget, budget / 5, 5,
                        draws=(t(u), t(noise)))
    close(adv, jadv, atol=ADV_ATOL)
    np.testing.assert_array_equal(succ.numpy(), np.asarray(jsucc))


def cw_cases(pc, target, key, bs=2, iters=5):
    """(name, JAX call, port call taking device_chunk_iters) of each CW
    attack on the toy victim, with JAX's draws through the seam."""
    jpc, jtg, tpc, ttg = jnp.asarray(pc), jnp.asarray(target), t(pc), t(target)
    B, K, _ = pc.shape
    init = t(normals(key, pc.shape, bs))
    add = t(normals(key, (B, 16, 3), bs))
    cluster = t(normals(key, (B, 2 * 8, 3), bs))
    steps = jax.random.split(key, bs)
    obj = [jax.random.split(k, 3) for k in steps]
    obj_draws = tuple(t(np.stack(x)) for x in zip(*[
        (np.asarray(jax.random.normal(k1, (B, 2, 16, 3))),
         np.asarray(jax.random.normal(k2, (B, 2, 3))),
         np.asarray(jax.random.uniform(k3, (B, 2, 3))))
        for k1, k2, k3 in obj]))
    rng = np.random.default_rng(9)
    normal = rng.normal(size=pc.shape)
    normal = (normal / np.linalg.norm(normal, axis=-1, keepdims=True)).astype(
        np.float32)
    knn_noise = t(np.asarray(jax.random.normal(key, pc.shape)))
    common = dict(binary_step=bs, num_iter=iters)
    cases = [
        ("perturb",
         lambda: jcw.cw_perturb(jtoy, jpc, jtg, key, **common),
         lambda c: cw.cw_perturb(ttoy, tpc, ttg, draws=init,
                                 device_chunk_iters=c, **common))]
    # Hausdorff from the clean points: adv2ori's maximum at the start is
    # over the added points' rounding noise (each sits 1e-7 from a clean
    # point), so which point it moves depends on the matmul's rounding
    for dist, method in (("chamfer", "adv2ori"), ("hausdorff", "ori2adv")):
        jd = functools.partial(getattr(jlosses, dist + "_dist"),
                               method=method)
        td = functools.partial(getattr(losses, dist + "_dist"),
                               method=method)
        cases.append((
            "add " + dist,
            lambda jd=jd: jcw.cw_add(jtoy, jpc, jtg, key, jd, num_add=16,
                                     **common),
            lambda c, td=td: cw.cw_add(ttoy, tpc, ttg, None, td, num_add=16,
                                       draws=add, device_chunk_iters=c,
                                       **common)))
    cases += [
        ("knn",
         lambda: jcw.cw_knn(jtoy, jpc, jtg, key, jlosses.chamfer_knn_dist,
                            normal=jnp.asarray(normal), num_iter=iters),
         lambda c: cw.cw_knn(ttoy, tpc, ttg, None, losses.chamfer_knn_dist,
                             normal=t(normal), num_iter=iters,
                             draws=knn_noise, device_chunk_iters=c)),
        ("cluster",
         lambda: jcluster.cw_add_cluster(jtoy, jpc, jtg, key, num_add=2,
                                         cl_num_p=8, seed=3, **common),
         lambda c: cw_cluster.cw_add_cluster(
             ttoy, tpc, ttg, num_add=2, cl_num_p=8, seed=3, draws=cluster,
             device_chunk_iters=c, **common)),
        ("object",
         lambda: jcluster.cw_add_object(jtoy, jpc, jtg, key, num_add=2,
                                        obj_num_p=16, seed=3, **common),
         lambda c: cw_cluster.cw_add_object(
             ttoy, tpc, ttg, num_add=2, obj_num_p=16, seed=3,
             draws=obj_draws, device_chunk_iters=c, **common)),
    ]
    return cases


def test_cw_attacks_match_jax():
    """Every CW attack at binary_step 2 and 5 iterations (the kNN attack
    5 iterations): best distances, adversarial clouds and success masks;
    and each port run chunked (2, a remainder of 1) bit-equal to
    unchunked."""
    pc, _, target = toy_data(k=160)
    for name, jrun, trun in cw_cases(pc, target, jax.random.key(7)):
        want = [np.asarray(x) for x in jrun()]
        got = [x.detach().numpy() for x in trun(None)]
        chunked = [x.detach().numpy() for x in trun(2)]
        for g, c in zip(got, chunked):
            np.testing.assert_array_equal(g, c, err_msg=name)
        if name == "knn":
            (gadv, gsucc), (wadv, wsucc) = got, want
        else:
            gdist, gadv, gsucc = got
            wdist, wadv, wsucc = want
            np.testing.assert_allclose(gdist, wdist, rtol=DIST_RTOL,
                                       err_msg=name)
        assert gadv.shape == wadv.shape, name
        np.testing.assert_allclose(gadv, wadv, atol=ADV_ATOL, err_msg=name)
        np.testing.assert_array_equal(gsucc, wsucc, err_msg=name)
    assert name == "object"
    with pytest.raises(ValueError, match=">= 1"):
        cw.cw_perturb(ttoy, t(pc), t(target), torch.Generator(),
                      binary_step=1, num_iter=2, device_chunk_iters=-1)


def test_cw_reaches_success_and_records_evaluated_iterates():
    """At 3 x 40 iterations (`tests/test_attack.py:77`) the toy attack
    succeeds, the recorded clouds are
    the ones whose logits hit the target, and clouds that never succeed
    fall back to the final iterate."""
    pc, _, target = toy_data()
    dist, adv, succ = cw.cw_perturb(ttoy, t(pc), t(target),
                                    torch.Generator().manual_seed(0),
                                    binary_step=3, num_iter=40)
    assert succ.float().mean() >= 0.75
    pred = ttoy(adv).argmax(-1)
    assert bool((pred[succ] == t(target)[succ]).all())
    np.testing.assert_allclose(dist[succ].numpy(), losses.l2_dist(
        adv, t(pc))[succ].numpy(), rtol=1e-6)


def test_dbscan_and_inits_equal_jax():
    rng = np.random.default_rng(4)
    blobs = np.concatenate([rng.normal(size=(20, 3)) * 0.02 + c
                            for c in (0.0, 1.0, 2.0)] + [
        rng.uniform(-3, 3, (15, 3))]).astype(np.float32)
    np.testing.assert_array_equal(
        cw_cluster.dbscan_labels(blobs, 0.2, 3),
        jcluster.dbscan_labels(blobs, 0.2, 3))
    cri = np.stack([blobs[rng.permutation(len(blobs))] for _ in range(3)])
    cri[2] = rng.uniform(-5, 5, cri[2].shape)               # no cluster
    for num_add in (2, 5):
        np.testing.assert_array_equal(
            cw_cluster._init_clusters(cri, num_add, 8,
                                      np.random.default_rng(1)),
            jcluster._init_clusters(cri, num_add, 8,
                                    np.random.default_rng(1)))
        np.testing.assert_array_equal(
            cw_cluster._init_object_centers(cri, num_add,
                                            np.random.default_rng(2)),
            jcluster._init_object_centers(cri, num_add,
                                          np.random.default_rng(2)))
    np.testing.assert_array_equal(
        cw_cluster.load_airplane(64, 3, 0.3, np.random.default_rng(5)),
        jcluster.load_airplane(64, 3, 0.3, np.random.default_rng(5)))
    objs, angles, shifts = (x.astype(np.float32) for x in (
        rng.normal(size=(2, 3, 5, 3)), rng.uniform(0, 7, (2, 3, 3)),
        rng.normal(size=(2, 3, 3))))
    close(cw_cluster._rotate_shift(t(objs), t(angles), t(shifts)),
          jcluster._rotate_shift(objs, angles, shifts), rtol=1e-6, atol=1e-7)


def pointnet_victims(seed=0, b=2, n=64):
    """JAX's PointNet (4 classes) with perturbed flax-init variables, and
    the port's with the same weights; clouds and their labels. Not the
    batch-norm statistics `calibrated` on these 128 points: they scale the
    logits to ~1e5, where the softmax saturates, the cross entropy's
    gradient is exactly 0 and every saliency ties."""
    rng = np.random.default_rng(seed)
    pc = (rng.normal(size=(b, n, 3)) * 0.4).astype(np.float32)
    jm = jax_build_model("pointnet", num_classes=4)
    variables = perturbed(jm.init(
        jax.random.key(seed), jnp.asarray(pc), train=False), seed)
    model = build_model("pointnet", num_classes=4)
    model.load_state_dict(params_from_jax(variables, model), strict=True)
    model.eval()

    def jlogits(p, mask=None):
        return jm.apply(variables, p, train=False, mask=mask)[0]

    label = np.asarray(jlogits(jnp.asarray(pc))).argmax(-1)
    return pc, label, jlogits, (lambda p, mask=None: model(p, mask)[0]), model


def test_drop_kept_sets_equal_jax():
    """Drop's kept sets, masked (5 + 5 + 2 points) and shrinking, exactly
    equal to JAX's, on the toy victim and on PointNet (B = 2, N = 64);
    the masked and shrinking forms keep the same points."""
    pc, label, _ = toy_data()
    victims = [("toy", pc, label, jtoy_masked, jtoy, ttoy_masked, ttoy)]
    ppc, plabel, jlogits, tlogits, _ = pointnet_victims()
    victims.append(("pointnet", ppc, plabel, jlogits, jlogits, tlogits,
                    tlogits))
    for name, x, lab, jmasked, jplain, tmasked, tplain in victims:
        _, jmask, jstill = jdrop.saliency_drop_masked(
            jmasked, jnp.asarray(x), jnp.asarray(lab), 12)
        _, mask, still = drop.saliency_drop_masked(tmasked, t(x), t(lab), 12)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask),
                                      err_msg=name)
        # saliency decided: not every score tied (the lowest indices)
        assert (mask.numpy()[:, :12] > 0).any(), name
        np.testing.assert_array_equal(still.numpy(), np.asarray(jstill))
        kept, _ = drop.saliency_drop(tmasked, t(x), t(lab), 12)
        np.testing.assert_array_equal(kept.numpy(), np.asarray(
            jdrop.compact_kept(jnp.asarray(x), jmask, 12)))
        jkept, jstill = jdrop.saliency_drop_shrink(
            jplain, jnp.asarray(x), jnp.asarray(lab), 12)
        skept, sstill = drop.saliency_drop_shrink(tplain, t(x), t(lab), 12)
        np.testing.assert_array_equal(skept.numpy(), np.asarray(jkept),
                                      err_msg=name)
        np.testing.assert_array_equal(sstill.numpy(), np.asarray(jstill))
        for a, b in zip(kept.numpy(), skept.numpy()):
            assert sorted(map(tuple, a)) == sorted(map(tuple, b)), name


def test_mixed_victim_close_to_f32():
    """The bf16-trunk, f32-head victim (PointNet, 8 classes): logits f32
    and within 2 % of the f32 logits' largest magnitude; only the head's
    weight and bias stay f32, every batch-norm buffer is bf16."""
    rng = np.random.default_rng(0)
    pc = torch.from_numpy(rng.normal(size=(4, 64, 3)).astype(np.float32))
    torch.manual_seed(0)
    model = build_model("pointnet", num_classes=8).eval()
    with torch.no_grad():
        want = model(pc)[0]
        got = make_mixed_logits_fn(model, 8)(pc)
        got_masked = make_mixed_logits_fn(model, 8, masked=True)(
            pc, torch.ones(4, 64))
    assert got.dtype == torch.float32
    for g in (got, got_masked):
        assert float((g - want).abs().max() / want.abs().max()) < 0.02
    mixed = cast_trunk_bf16(model, 8)
    kept = [k for k, v in mixed.state_dict().items()
            if v.dtype == torch.float32]
    assert kept == ["Dense_1.weight", "Dense_1.bias"], kept
    assert all(v.dtype == torch.bfloat16 for k, v in
               mixed.state_dict().items() if k.endswith(("mean", "var")))
    assert next(model.parameters()).dtype == torch.float32   # a copy


def test_bf16_points_select_as_their_f32_upcast():
    """FPS and ball query take bf16 points (a mixed victim's) and select
    what they select on the exact f32 upcast, masked and not."""
    rng = np.random.default_rng(6)
    xyz = torch.from_numpy(rng.uniform(-1, 1, (2, 300, 3)).astype(
        np.float32)).to(torch.bfloat16)
    mask = torch.from_numpy(rng.uniform(size=(2, 300)) > 0.3)
    for m in (None, mask):
        fps = ops.farthest_point_sample(xyz, 40, mask=m)
        np.testing.assert_array_equal(
            fps.numpy(), ops.farthest_point_sample(xyz.float(), 40,
                                                   mask=m).numpy())
        new = ops.index_points(xyz, fps)
        got = ops.query_ball_point(0.3, 16, xyz, new, mask=m)
        np.testing.assert_array_equal(
            got.numpy(), ops.query_ball_point(0.3, 16, xyz.float(),
                                              new.float(), mask=m).numpy())
