"""The rest of the implicit-model library, PyTorch port vs JAX package, on
the CPU: the PointNet++ ConvONet, ONet's decoder registry, latent encoder
and VAE helpers, the legacy decoders, and the params layout for rank-5 and
transposed kernels.

Inputs come from numpy seeds. Weights come from the port module's own init
with every tensor perturbed, through `params_to_jax` (a JAX init of these
modules takes seconds op by op), so the JAX module takes them by name.
Sizes are small: c_dim 8, hidden 16, z_dim 4, B = 2.

Tolerances: rtol 1e-5 with atol 1e-5 of the largest magnitude for values
and gradients (f32 on both sides, sums in other orders), 1e-4 through the
legacy voxel decoder's transposed convolutions (27 taps of 256 channels);
batch statistics after a train step at the same tolerance; the params round
trip exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from if_defense_tpu.implicit import legacy as jlegacy
from if_defense_tpu.implicit import onet as jonet
from if_defense_tpu.implicit import pointnetpp_encoder as jpp
from if_defense_tpu.implicit import ConvOccupancyNetwork as JaxConvONet
from if_defense_tpu_torch.implicit import (
    ConvOccupancyNetwork,
    FeatureDecoder,
    LatentEncoder,
    OccupancyNetwork,
    UNet2D,
    UNet3D,
    VoxelDecoder,
)
from if_defense_tpu_torch.implicit import onet as tonet
from if_defense_tpu_torch.implicit.legacy import AffineLayer
from if_defense_tpu_torch.implicit.pointnetpp_encoder import PointConvONet
from if_defense_tpu_torch.implicit.training import init_occupancy_model
from if_defense_tpu_torch.utils import params_io
from if_defense_tpu_torch.utils.params_io import (
    flatten_params,
    flax_init_params,
    params_from_jax,
    params_to_jax,
    unflatten_params,
)

C, H, Z, B, T = 8, 16, 4, 2, 40


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """torch's CPU ops in one thread (ROADMAP.md section C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_perturbed(tm, seed=1):
    """The port module with its own init perturbed (running variances
    scaled, so they stay positive), and those weights as flax variables."""
    torch.manual_seed(0)
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in flatten_params(params_to_jax(tm.state_dict(), tm)).items():
        n = rng.normal(size=v.shape)
        if k.endswith("/var"):
            v = v * np.exp(0.2 * n)
        else:
            v = v + (0.3 / np.sqrt(np.prod(v.shape[:-1])) if v.ndim > 1
                     else 0.05) * n
        flat[k] = v.astype(np.float32)
    variables = unflatten_params(flat)
    tm.load_state_dict(params_from_jax(variables, tm), strict=True)
    return variables


def _close(got, want, rtol=1e-5, scale_atol=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale_atol * np.abs(want).max())


def _arr(seed, shape, scale=0.5):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def test_point_conv_onet():
    """PointConvONet: encode (FPS and ball query, the plain versions of
    B5 and B6 here), decode and its gradient to p."""
    pc = np.random.default_rng(0).uniform(-0.5, 0.5, (B, 300, 3)).astype(
        np.float32)
    q = np.random.default_rng(1).uniform(-0.55, 0.55, (B, T, 3)).astype(
        np.float32)
    tm = PointConvONet(C, H)
    v = _load_perturbed(tm)
    jm = jpp.PointConvONet(C, H)
    jc = jm.apply(v, jnp.asarray(pc), method="encode_inputs")
    want = jm.apply(v, jnp.asarray(q), jc, method="decode")
    jgrad = jax.grad(lambda x: jnp.sum(jm.apply(v, x, jc, method="decode")))(
        jnp.asarray(q))
    with torch.no_grad():
        tc = tm.encode_inputs(torch.from_numpy(pc))
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc[0]))
    _close(tc[1], jc[1])
    tq = torch.from_numpy(q).requires_grad_(True)
    got = tm.decode(tq, tc)
    got.sum().backward()
    _close(got, want)
    _close(tq.grad, jgrad)


# (JAX constructor kwargs, port constructor kwargs) of each registry name
DECODERS = {
    "simple": (dict(hidden_size=H, c_dim=C, z_dim=Z),
               dict(hidden_size=H, c_dim=C, z_dim=Z)),
    "cbatchnorm": (dict(hidden_size=H, z_dim=Z),
                   dict(c_dim=C, hidden_size=H, z_dim=Z)),
    "cbatchnorm2": (dict(hidden_size=H, c_dim=C, z_dim=Z, n_blocks=3),
                    dict(hidden_size=H, c_dim=C, z_dim=Z, n_blocks=3)),
    "batchnorm": (dict(hidden_size=H, c_dim=C, z_dim=Z, leaky=True),
                  dict(hidden_size=H, c_dim=C, z_dim=Z, leaky=True)),
    "cbatchnorm_noresnet": (dict(hidden_size=H, z_dim=Z, leaky=True),
                            dict(c_dim=C, hidden_size=H, z_dim=Z, leaky=True)),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", list(DECODERS))
def test_registry_decoder(name, train):
    """Each decoder with a latent z, in eval mode (running statistics) and
    in train mode (batch statistics, and the running statistics after the
    step), and the gradient to p."""
    assert set(tonet.DECODER_REGISTRY) == set(jonet.DECODER_REGISTRY)
    jkw, tkw = DECODERS[name]
    jm = jonet.DECODER_REGISTRY[name](**jkw)
    tm = tonet.DECODER_REGISTRY[name](**tkw)
    v = _load_perturbed(tm)
    p, c, z = _arr(2, (B, T, 3)), _arr(3, (B, C)), _arr(4, (B, Z))
    jargs = (jnp.asarray(c), jnp.asarray(z))

    def jf(x):
        if train:
            return jm.apply(v, x, *jargs, train=True, mutable=["batch_stats"])
        return jm.apply(v, x, *jargs, train=False), {}

    # z None is the prior mean, zeros (eval mode: the step below moves the
    # running statistics in train mode)
    with torch.no_grad():
        _close(tm.eval()(torch.from_numpy(p), torch.from_numpy(c)),
               jm.apply(v, jnp.asarray(p), jnp.asarray(c)))
    (want, stats) = jf(jnp.asarray(p))
    jgrad = jax.grad(lambda x: jnp.sum(jf(x)[0]))(jnp.asarray(p))
    tm.train(train)
    tp = torch.from_numpy(p).requires_grad_(True)
    got = tm(tp, torch.from_numpy(c), torch.from_numpy(z))
    got.sum().backward()
    _close(got, want)
    _close(tp.grad, jgrad)
    if train and name != "simple":
        moved = flatten_params(jax.tree_util.tree_map(np.asarray, stats))
        ours = flatten_params(params_to_jax(tm.state_dict(), tm))
        assert moved
        for k, a in moved.items():
            _close(ours[k], a)


@pytest.mark.parametrize("leaky", [False, True])
def test_latent_encoder(leaky):
    jm = jonet.LatentEncoder(z_dim=Z, c_dim=C, hidden_dim=H, leaky=leaky)
    tm = LatentEncoder(Z, C, H, leaky)
    v = _load_perturbed(tm)
    p, c = _arr(5, (B, T, 3)), _arr(6, (B, C))
    occ = (np.random.default_rng(7).uniform(size=(B, T)) > 0.5).astype(np.float32)
    want = jm.apply(v, jnp.asarray(p), jnp.asarray(occ), jnp.asarray(c))
    jgrad = jax.grad(lambda x: sum(jnp.sum(a) for a in jm.apply(
        v, x, jnp.asarray(occ), jnp.asarray(c))))(jnp.asarray(p))
    tp = torch.from_numpy(p).requires_grad_(True)
    got = tm(tp, torch.from_numpy(occ), torch.from_numpy(c))
    sum(a.sum() for a in got).backward()
    for g, w in zip(got, want):
        _close(g, w)
    _close(tp.grad, jgrad)


def test_sample_z_and_kl_normal():
    mean, logstd = _arr(8, (B, Z)), _arr(9, (B, Z), 0.3)
    key = jax.random.key(3)
    want = jonet.sample_z(jnp.asarray(mean), jnp.asarray(logstd), key)
    eps = np.array(jax.random.normal(key, mean.shape))      # JAX's own draw
    got = tonet.sample_z(torch.from_numpy(mean), torch.from_numpy(logstd),
                         eps=torch.from_numpy(eps))
    _close(got, want)
    _close(tonet.kl_normal(torch.from_numpy(mean), torch.from_numpy(logstd)),
           jonet.kl_normal(jnp.asarray(mean), jnp.asarray(logstd)))
    g = torch.Generator().manual_seed(0)
    z = tonet.sample_z(torch.from_numpy(mean), torch.from_numpy(logstd), g)
    assert z.shape == (B, Z) and torch.isfinite(z).all()


def test_onet_with_a_latent():
    """OccupancyNetwork(z_dim > 0): infer_z, decode with z and with the
    prior mean, the prior draws; and `init_occupancy_model`'s keys."""
    jm = jonet.OccupancyNetwork(C, H, H, z_dim=Z)
    tm = OccupancyNetwork(C, H, H, z_dim=Z).eval()
    v = _load_perturbed(tm)
    pc, p = _arr(10, (B, 64, 3)), _arr(11, (B, T, 3))
    occ = (np.random.default_rng(12).uniform(size=(B, T)) > 0.5).astype(np.float32)
    jc = jm.apply(v, jnp.asarray(pc), method="encode_inputs")
    jmean, jlog = jm.apply(v, jnp.asarray(p), jnp.asarray(occ), jc,
                           method="infer_z")
    jout = jm.apply(v, jnp.asarray(p), jc, jmean, method="decode")
    with torch.no_grad():
        tc = tm.encode_inputs(torch.from_numpy(pc))
        mean, logstd = tm.infer_z(torch.from_numpy(p), torch.from_numpy(occ), tc)
        _close(mean, jmean)
        _close(logstd, jlog)
        _close(tm.decode(torch.from_numpy(p), tc, mean), jout)
        _close(tm(torch.from_numpy(pc), torch.from_numpy(p)),
               jm.apply(v, jnp.asarray(pc), jnp.asarray(p)))
    assert torch.equal(tm.get_z_from_prior(3), torch.zeros(3, Z))
    draw = tm.get_z_from_prior(3, torch.Generator().manual_seed(0))
    assert draw.shape == (3, Z) and draw.abs().sum() > 0
    assert OccupancyNetwork(C, H, H).infer_z(
        torch.from_numpy(p), torch.from_numpy(occ), tc)[0].shape == (B, 0)
    keys = set(flatten_params(init_occupancy_model(
        OccupancyNetwork(C, H, H, z_dim=Z), 0)))
    assert "params/encoder_latent/fc_mean/kernel" in keys
    assert "params/decoder/fc_z/kernel" in keys


def test_affine_layer_init():
    """Zero kernels, identity and (0, 0, 2): p + (0, 0, 2) for any c."""
    layer = AffineLayer(C)
    p = torch.from_numpy(_arr(13, (B, T, 3)))
    c = torch.from_numpy(_arr(14, (B, C)))
    torch.testing.assert_close(layer(c, p), p + torch.tensor([0.0, 0.0, 2.0]),
                               rtol=0, atol=0)


def test_voxel_decoder_same_conv_transpose():
    """VoxelDecoder: flax's SAME stride-2 transposed convolutions (torch's
    padding 0, cropped to the first 2n) and the trilinear sample."""
    jm = jlegacy.VoxelDecoder(z_dim=Z, c_dim=C, hidden_size=H)
    tm = VoxelDecoder(Z, C, H)
    v = _load_perturbed(tm)
    p = np.random.default_rng(15).uniform(-0.55, 0.55, (B, T, 3)).astype(
        np.float32)
    c, z = _arr(16, (B, C)), _arr(17, (B, Z))
    want = jm.apply(v, jnp.asarray(p), jnp.asarray(c), jnp.asarray(z))
    jgrad = jax.grad(lambda x: jnp.sum(jm.apply(
        v, x, jnp.asarray(c), jnp.asarray(z))))(jnp.asarray(p))
    tp = torch.from_numpy(p).requires_grad_(True)
    got = tm(tp, torch.from_numpy(c), torch.from_numpy(z))
    got.sum().backward()
    _close(got, want, 1e-4, 1e-4)
    _close(tp.grad, jgrad, 1e-4, 1e-4)
    # the upstream idiom (padding 1, output_padding 1) is another operation
    conv = tm.convtrp_0
    x = torch.from_numpy(_arr(18, (1, 256, 4, 4, 4)))
    same = conv(x)[:, :, :8, :8, :8]
    shifted = torch.nn.functional.conv_transpose3d(
        x, conv.weight, conv.bias, stride=2, padding=1, output_padding=1)
    assert (same - shifted).abs().max() > 0.1


@pytest.mark.parametrize("c_dim", [6, 8])
def test_feature_decoder(c_dim):
    jm = jlegacy.FeatureDecoder(z_dim=Z, c_dim=c_dim, hidden_size=H)
    tm = FeatureDecoder(Z, c_dim, H)
    v = _load_perturbed(tm)
    p = _arr(19, (B, T, 3))
    fmap, z = _arr(20, (B, 8, 8, c_dim)), _arr(21, (B, Z))
    want = jm.apply(v, jnp.asarray(p), jnp.asarray(fmap), jnp.asarray(z))
    jgrad = jax.grad(lambda x, f: jnp.sum(jm.apply(v, x, f, jnp.asarray(z))),
                     (0, 1))(jnp.asarray(p), jnp.asarray(fmap))
    tp = torch.from_numpy(p).requires_grad_(True)
    tf = torch.from_numpy(fmap).requires_grad_(True)
    got = tm(tp, tf, torch.from_numpy(z))
    got.sum().backward()
    _close(got, want)
    _close(tp.grad, jgrad[0])
    _close(tf.grad, jgrad[1])


def test_params_round_trip_rank5_and_transposed():
    """params_to_jax(params_from_jax(v, m), m) == v for rank-5 Conv and
    ConvTranspose kernels (the grid ConvONet's `upconv`, VoxelDecoder's
    `convtrp_<i>`); a kernel is transposed where its module is, whatever
    the module's name."""
    rng = np.random.default_rng(22)
    vox = VoxelDecoder(Z, C, H)
    for model, flat in (
            (ConvOccupancyNetwork(C, C, 16, plane_type=("xz", "grid")),
             flatten_params(flax_init_params(0, "convonet", c_dim=C,
                                             hidden_dim=C,
                                             plane_type=("xz", "grid")))),
            (vox, flatten_params(params_to_jax(vox.state_dict(), vox)))):
        flat = {k: rng.normal(size=a.shape).astype(np.float32)
                for k, a in flat.items()}
        assert any(a.ndim == 5 and ("/upconv/" in k or "/convtrp_" in k)
                   for k, a in flat.items())
        back = flatten_params(params_to_jax(
            params_from_jax(unflatten_params(flat), model), model))
        assert set(back) == set(flat)
        for k, a in flat.items():
            np.testing.assert_array_equal(back[k], a)
    # names that would mislead a rule by name: a Conv3d named `upconv`, a
    # ConvTranspose3d named `a`
    named = torch.nn.Module()
    named.upconv = torch.nn.Conv3d(2, 3, 2)
    named.a = torch.nn.ConvTranspose3d(2, 3, 2)
    assert params_io.transposed_convs(named) == {"a"}
    tree = params_to_jax(named.state_dict(), named)["params"]
    conv = named.upconv.weight.detach().numpy()
    trp = named.a.weight.detach().numpy()
    np.testing.assert_array_equal(tree["upconv"]["kernel"],
                                  conv.transpose(2, 3, 4, 1, 0))
    np.testing.assert_array_equal(
        tree["a"]["kernel"],
        trp[:, :, ::-1, ::-1, ::-1].transpose(2, 3, 4, 0, 1))
    sd = params_from_jax({"params": tree}, named)
    assert torch.equal(sd["upconv.weight"], named.upconv.weight)
    assert torch.equal(sd["a.weight"], named.a.weight)


def test_flax_init_shapes_match_jax():
    """`flax_init_params` gives the keys and shapes of the JAX modules'
    init: the grid ConvONet, PointConvONet, ONet with a latent."""
    def jax_shapes(module, *args):
        shapes = jax.eval_shape(module.init, jax.random.key(0), *args)
        return {k: tuple(a.shape) for k, a in flatten_params(
            jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.int8),
                                   shapes)).items()}

    x = jnp.zeros((1, 300, 3))
    cases = [
        (JaxConvONet(C, C, 16, plane_type=("xz", "grid"), grid_resolution=8),
         (x, x), ("convonet", dict(c_dim=C, hidden_dim=C,
                                   plane_type=("xz", "grid")))),
        (jpp.PointConvONet(C, H), (x, x[:, :10]),
         ("pointconvonet", dict(c_dim=C, hidden_dim=H))),
        (jonet.OccupancyNetwork(C, H, H, z_dim=Z), (x, x[:, :10]),
         ("onet", dict(c_dim=C, hidden_dim=H, decoder_hidden=H, z_dim=Z))),
    ]
    for module, args, (variant, kw) in cases:
        want = jax_shapes(module, *args)
        got = {k: tuple(a.shape) for k, a in
               flatten_params(flax_init_params(0, variant, **kw)).items()}
        missing = set(got) - set(want)
        assert set(want) <= set(got), set(want) ^ set(got)
        assert all(got[k] == want[k] for k in want)
        # flax's init calls no encoder_latent, so it makes none; the port
        # builds it with the model
        assert all(variant == "onet" and k.startswith("params/encoder_latent/")
                   for k in missing), missing


def test_exports_cover_the_jax_packages():
    """The port's `implicit` and `ops` export every name the JAX package's
    do."""
    import if_defense_tpu.implicit as jimplicit
    import if_defense_tpu.ops as jops
    import if_defense_tpu_torch.implicit as timplicit
    import if_defense_tpu_torch.ops as tops

    assert set(jimplicit.__all__) <= set(timplicit.__all__)
    assert set(jops.__all__) <= set(tops.__all__)


@pytest.mark.parametrize("first", ["if_defense_tpu_torch.models",
                                   "if_defense_tpu_torch.implicit",
                                   "if_defense_tpu_torch.implicit.training"])
def test_import_order(first):
    """The models and the implicit package import in either order (the
    PointNet++ ConvONet builds on `models.pointnet2`, whose `models.common`
    imports `implicit.layers`)."""
    import subprocess
    import sys

    code = (f"import {first}; import if_defense_tpu_torch.models, "
            "if_defense_tpu_torch.implicit.pointnetpp_encoder, "
            "if_defense_tpu_torch.implicit.training")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
