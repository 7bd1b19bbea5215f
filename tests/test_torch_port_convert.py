"""The port's `.pth` converters (`if_defense_tpu_torch/convert/`) against
the JAX package's (`if_defense_tpu/convert/`).

No reference `.pth` ships with the repository, so each reference state
dict is built from a flax tree by `tools/reference_pth.py` (the inverse of
the converters' key maps): ONet and ConvONet at c_dim / hidden 16 (ONet's
decoder hidden 16; ConvONet's 16x16 planes, UNet depth 4) from flax's init
with every tensor perturbed; PU-Net from the repository's weights; the
four victims at their published widths, perturbed, their batch-norm
statistics calibrated on the clouds; PointNet++'s saved with
`nn.DataParallel`'s `module.` prefix. Each converter of the port gives the
JAX converter's tree leaf for leaf (same keys, `np.array_equal`), and the
tree the flax tree it came from. The port module loaded with
`params_from_jax` of its tree matches the JAX module with the JAX tree on
the same inputs: the implicit nets rtol 1e-4, atol 1e-5 (the module
tests' bound), PU-Net rtol 1e-4, atol 1e-5 (the DUP-Net tests'), the
victims' logits rtol 1e-5 with atol 1e-5 of the largest (the victim
tests'). ConvONet's up-convolutions reach the port's `ConvTranspose2d`
bit for bit. Every reference dict goes through a file written with
`torch.save` (read back `weights_only`) on the JAX side or the port's.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from if_defense_tpu.convert import implicit_weights as jiw
from if_defense_tpu.convert import punet_weights as jpw
from if_defense_tpu.convert import victim_weights as jvw
from if_defense_tpu.defense.punet import PUNet as JaxPUNet
from if_defense_tpu.implicit import ConvOccupancyNetwork as JaxConvONet
from if_defense_tpu.implicit import OccupancyNetwork as JaxONet
from if_defense_tpu.models import build_model as jax_build_model
from if_defense_tpu.utils.params_io import load_params_npz as jax_load_npz
from if_defense_tpu_torch.convert import implicit_weights as iw
from if_defense_tpu_torch.convert import punet_weights as pw
from if_defense_tpu_torch.convert import victim_weights as vw
from if_defense_tpu_torch.defense.punet import PUNet
from if_defense_tpu_torch.implicit import ConvOccupancyNetwork, OccupancyNetwork
from if_defense_tpu_torch.cli.inference import load_eval_model
from if_defense_tpu_torch.utils.checkpoint import save_eval_checkpoint
from if_defense_tpu_torch.utils.params_io import (
    flatten_params,
    load_params_npz,
    params_from_jax,
    save_params_npz,
)
from test_torch_port_victims import calibrated, inputs, perturbed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUNET = os.path.join(ROOT, "weights", "punet_1024_up4.npz")
W = 16


def _tool():
    spec = importlib.util.spec_from_file_location(
        "reference_pth", os.path.join(ROOT, "tools", "reference_pth.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


reference_state_dict = _tool().reference_state_dict


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _same_tree(got, want):
    got, want = flatten_params(got), flatten_params(_np_tree(want))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == np.float32, k
        assert np.array_equal(got[k], want[k]), k


def _saved(tmp_path, name, sd):
    path = str(tmp_path / f"{name}.pth")
    torch.save(sd, path)
    return path


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_convonet_converter(tmp_path):
    rng = np.random.default_rng(0)
    pc = rng.uniform(-0.45, 0.45, (2, 128, 3)).astype(np.float32)
    q = rng.uniform(-0.5, 0.5, (2, 100, 3)).astype(np.float32)
    jm = JaxConvONet(W, W, 16)
    tree = perturbed(jm.init(jax.random.key(0), jnp.asarray(pc),
                             jnp.asarray(q)), 1)
    sd = reference_state_dict("convonet", tree)
    path = _saved(tmp_path, "convonet", sd)
    got = iw.convert_convonet_pth(path, n_blocks=5, unet_depth=4)
    want = jiw.convert_convonet_pth(sd, n_blocks=5, unet_depth=4)
    _same_tree(got, want)
    _same_tree(got, tree)
    _same_tree(iw.convert_convonet_pth(sd), got)        # a dict, as JAX's
    model = ConvOccupancyNetwork(W, W, 16)
    model.load_state_dict(params_from_jax(got, model), strict=True)
    # the reference's up-convolution reaches the port's bit for bit
    for i in range(3):
        assert torch.equal(
            model.state_dict()[f"encoder.unet.up_{i}.upconv.weight"],
            sd[f"encoder.unet.up_convs.{i}.upconv.weight"])
    c = jm.apply(want, jnp.asarray(pc), method="encode_inputs")
    with torch.no_grad():
        tc = model.eval().encode_inputs(torch.from_numpy(pc))
        for pl in c:
            _close(tc[pl], c[pl], 1e-4, 1e-5)
        _close(model.decode(torch.from_numpy(q), tc),
               jm.apply(want, jnp.asarray(q), c, method="decode"), 1e-4, 1e-5)
    # a converted npz loads in both packages
    npz = save_params_npz(str(tmp_path / "convonet.npz"), got)
    _same_tree(load_params_npz(npz), jax_load_npz(npz))


def test_onet_converter(tmp_path):
    rng = np.random.default_rng(1)
    pc = rng.uniform(-0.45, 0.45, (2, 100, 3)).astype(np.float32)
    q = rng.uniform(-0.5, 0.5, (2, 64, 3)).astype(np.float32)
    jm = JaxONet(W, W, W)
    tree = perturbed(jm.init(jax.random.key(1), jnp.asarray(pc),
                             jnp.asarray(q)), 2)
    sd = reference_state_dict("onet", tree)
    got = iw.convert_onet_pth(_saved(tmp_path, "onet", sd))
    want = jiw.convert_onet_pth(sd)
    _same_tree(got, want)
    _same_tree(got, tree)
    model = OccupancyNetwork(W, W, W)
    model.load_state_dict(params_from_jax(got, model), strict=True)
    c = jm.apply(want, jnp.asarray(pc), method="encode_inputs")
    with torch.no_grad():
        tc = model.eval().encode_inputs(torch.from_numpy(pc))
        _close(tc, c, 1e-4, 1e-5)
        _close(model.decode(torch.from_numpy(q), tc),
               jm.apply(want, jnp.asarray(q), c, method="decode"), 1e-4, 1e-5)


def test_punet_converter(tmp_path):
    """The repository's PU-Net weights through a reference `.pth` and back:
    the same tree as JAX's converter and as the npz, and PU-Net (64
    input points) as JAX's on it."""
    tree = jax_load_npz(PUNET)
    path = _saved(tmp_path, "punet", reference_state_dict("punet", tree))
    got = pw.convert_punet_pth(path, up_ratio=4)
    _same_tree(got, jpw.convert_punet_pth(path, up_ratio=4))
    _same_tree(got, tree)
    net = PUNet(npoint=64, up_ratio=4)
    net.load_state_dict(params_from_jax(got, net), strict=True)
    x = np.random.default_rng(3).normal(size=(1, 64, 3)).astype(np.float32)
    want = jax.jit(JaxPUNet(64, 4).apply)(tree, jnp.asarray(x))
    with torch.no_grad():
        _close(net.eval()(torch.from_numpy(x)), want, 1e-4, 1e-5)


VICTIMS = {"pointnet": vw.convert_pointnet_pth,
           "dgcnn": vw.convert_dgcnn_pth,
           "pointnet2": vw.convert_pointnet2_pth,
           "pointconv": vw.convert_pointconv_pth}


@pytest.mark.parametrize("name", list(VICTIMS))
def test_victim_converters(tmp_path, name):
    pc, mask = inputs(4)
    jm = jax_build_model(name)
    tree = calibrated(jm, perturbed(jm.init(
        jax.random.key(5), jnp.asarray(pc), train=False), 5), pc, 5)
    sd = reference_state_dict(name, tree, module_prefix=name == "pointnet2")
    assert any(k.startswith("module.") for k in sd) == (name == "pointnet2")
    got = VICTIMS[name](_saved(tmp_path, name, sd))
    want = getattr(jvw, f"convert_{name}_pth")(sd)
    _same_tree(got, want)
    _same_tree(got, tree)
    # an eval checkpoint of the converted tree scores in the port
    ckpt = save_eval_checkpoint(str(tmp_path / f"{name}.npz"), got,
                                {"model": name})
    model, meta = load_eval_model(ckpt)
    assert meta["model"] == name
    logits = np.asarray(jm.apply(want, jnp.asarray(pc), train=False)[0])
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(pc))[0].numpy()
    _close(out, logits, 1e-5, 1e-5 * float(np.abs(logits).max()))
