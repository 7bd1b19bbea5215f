"""Golden parity check of the port's ONet and ConvONet against the
reference's torch modules.

The port of `tools/parity_implicit.py`. Instantiates the reference models
(from `--reference_root`, on the CPU; random weights or a given state
dict), converts their state dicts with
`if_defense_tpu_torch.convert.implicit_weights`, runs the port's model on
`--device` (TF32 off) and compares the encoder's output (ConvONet's three
planes, ONet's latent code) and the decoder's logits. A `torch_scatter`
shim (the 2.x public API) lets the reference's ConvONet encoder run
without its CUDA extension.

Run: python tools/parity_implicit_torch.py [--device cuda] \
         [--reference_root DIR]
"""

from __future__ import annotations

import argparse
import os
import sys
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools import parity_victims_torch as _victims  # noqa: E402


def install_torch_scatter_shim():
    import torch

    def scatter_mean(src, index, dim=-1, out=None, dim_size=None):
        assert dim == -1 or dim == src.dim() - 1
        index = index.expand_as(src)
        size = out.shape[-1] if out is not None else (
            dim_size or int(index.max()) + 1)
        shape = src.shape[:-1] + (size,)
        summ = torch.zeros(shape, dtype=src.dtype).scatter_add(
            -1, index, src)
        cnt = torch.zeros(shape, dtype=src.dtype).scatter_add(
            -1, index, torch.ones_like(src))
        mean = summ / cnt.clamp(min=1)
        return mean if out is None else out + mean

    def scatter_max(src, index, dim=-1, out=None, dim_size=None):
        assert dim == -1 or dim == src.dim() - 1
        index = index.expand_as(src)
        size = dim_size or int(index.max()) + 1
        shape = src.shape[:-1] + (size,)
        res = torch.full(shape, float("-inf"), dtype=src.dtype)
        res = res.scatter_reduce(-1, index, src, reduce="amax",
                                 include_self=True)
        res = torch.where(torch.isinf(res), torch.zeros_like(res), res)
        return res, None

    mod = types.ModuleType("torch_scatter")
    mod.scatter_mean = scatter_mean
    mod.scatter_max = scatter_max
    sys.modules["torch_scatter"] = mod


class _AnyAttr(types.ModuleType):
    def __getattr__(self, name):
        return object


def install_import_stubs(*names):
    """Placeholder modules (any attribute resolves) for import-time-only
    reference deps (trimesh, the Cython geometry extensions, ...)."""
    for name in names:
        if name not in sys.modules:
            sys.modules[name] = _AnyAttr(name)


def _load_split_sd(enc_t, dec_t, sd):
    """Load a reference checkpoint's state dict (encoder./decoder.
    prefixed, as im2mesh's CheckpointIO saves it under the 'model' key)
    into the torch encoder/decoder pair."""
    enc_t.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()
                           if k.startswith("encoder.")})
    dec_t.load_state_dict({k[len("decoder."):]: v for k, v in sd.items()
                           if k.startswith("decoder.")})
    enc_t.eval(), dec_t.eval()


def _joined_sd(enc_t, dec_t) -> dict:
    """The pair's state dict under the wrapper's key prefixes, as numpy."""
    sd = {f"encoder.{k}": v.numpy() for k, v in enc_t.state_dict().items()}
    sd.update({f"decoder.{k}": v.numpy()
               for k, v in dec_t.state_dict().items()})
    return sd


def _port_model(model, variables, device):
    import torch

    from if_defense_tpu_torch.utils.params_io import params_from_jax

    model.load_state_dict(params_from_jax(variables, model), strict=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return model.eval().to(device)


def check_convonet(sd=None, device="cuda",
                   reference_root=_victims.REFERENCE_ROOT):
    import torch

    install_torch_scatter_shim()
    install_import_stubs(
        "trimesh", "plyfile", "im2mesh", "im2mesh.utils",
        "im2mesh.utils.libkdtree", "im2mesh.utils.libmcubes",
        "im2mesh.utils.libmise", "im2mesh.utils.libsimplify",
        "src.utils.libmcubes", "src.utils.libmise", "src.utils.libsimplify",
    )
    _victims.use_reference(reference_root, "ConvONet")
    from src.conv_onet.models.decoder import LocalDecoder as TorchDec
    from src.encoder.pointnet import LocalPoolPointnet as TorchEnc

    torch.manual_seed(0)
    enc_t = TorchEnc(
        c_dim=32, dim=3, hidden_dim=32, scatter_type="max",
        unet=True, unet_kwargs={"depth": 4, "merge_mode": "concat",
                                "start_filts": 32},
        plane_resolution=64, plane_type=["xz", "xy", "yz"], padding=0.1,
    )
    dec_t = TorchDec(dim=3, c_dim=32, hidden_size=32, sample_mode="bilinear",
                     padding=0.1)
    enc_t.eval(), dec_t.eval()
    if sd is not None:
        _load_split_sd(enc_t, dec_t, sd)

    rng = np.random.default_rng(0)
    pc = rng.uniform(-0.45, 0.45, size=(2, 200, 3)).astype(np.float32)
    q = rng.uniform(-0.5, 0.5, size=(2, 77, 3)).astype(np.float32)

    with torch.no_grad():
        c_t = enc_t(torch.from_numpy(pc))
        out_t = dec_t(torch.from_numpy(q), c_t).numpy()

    from if_defense_tpu_torch.convert.implicit_weights import (
        convert_convonet_pth,
    )
    from if_defense_tpu_torch.implicit import ConvOccupancyNetwork

    model = _port_model(ConvOccupancyNetwork(),
                        convert_convonet_pth(_joined_sd(enc_t, dec_t)),
                        device)
    with torch.no_grad():
        c_p = model.encode_inputs(torch.from_numpy(pc).to(device))
        out_p = model.decode(torch.from_numpy(q).to(device), c_p)
    out_p = out_p.cpu().numpy()

    gaps = []
    for pl in ("xz", "xy", "yz"):
        # the reference's plane [B, C, H, W], the port's (as JAX's)
        # [B, H, W, C]
        t = c_t[pl].numpy().transpose(0, 2, 3, 1)
        gaps.append(float(np.abs(t - c_p[pl].cpu().numpy()).max()))
        print(f"  plane {pl}: max diff {gaps[-1]:.3e} "
              f"(scale {np.abs(t).mean():.3f})")
    gaps.append(float(np.abs(out_t - out_p).max()))
    print(f"  decoder logits: max diff {gaps[-1]:.3e} "
          f"(scale {np.abs(out_t).mean():.3f})")
    return max(gaps)


def check_onet(sd=None, device="cuda",
               reference_root=_victims.REFERENCE_ROOT):
    import torch

    # drop the im2mesh stubs installed for the ConvONet check so the real
    # package imports cleanly, then re-stub its native extensions
    for name in list(sys.modules):
        if name.startswith("im2mesh"):
            del sys.modules[name]
    _victims.use_reference(reference_root, "ONet")
    install_import_stubs(
        "im2mesh.utils.libkdtree", "im2mesh.utils.libmcubes",
        "im2mesh.utils.libmise", "im2mesh.utils.libsimplify",
    )
    from im2mesh.encoder.pointnet import ResnetPointnet as TorchEnc
    from im2mesh.onet.models.decoder import DecoderCBatchNorm as TorchDec

    torch.manual_seed(0)
    enc_t = TorchEnc(c_dim=512, dim=3, hidden_dim=512)
    dec_t = TorchDec(dim=3, z_dim=0, c_dim=512, hidden_size=256)
    enc_t.eval(), dec_t.eval()
    if sd is not None:
        _load_split_sd(enc_t, dec_t, sd)
    else:
        # randomise BN running stats so the test isn't trivially mean0/var1
        with torch.no_grad():
            for m in dec_t.modules():
                if isinstance(m, torch.nn.BatchNorm1d):
                    m.running_mean.uniform_(-0.3, 0.3)
                    m.running_var.uniform_(0.5, 1.5)

    rng = np.random.default_rng(1)
    pc = rng.uniform(-0.45, 0.45, size=(2, 150, 3)).astype(np.float32)
    q = rng.uniform(-0.5, 0.5, size=(2, 66, 3)).astype(np.float32)

    with torch.no_grad():
        c_t = enc_t(torch.from_numpy(pc))
        out_t = dec_t(torch.from_numpy(q), None, c_t).numpy()

    from if_defense_tpu_torch.convert.implicit_weights import convert_onet_pth
    from if_defense_tpu_torch.implicit import OccupancyNetwork

    model = _port_model(OccupancyNetwork(),
                        convert_onet_pth(_joined_sd(enc_t, dec_t)), device)
    with torch.no_grad():
        c_p = model.encode_inputs(torch.from_numpy(pc).to(device))
        out_p = model.decode(torch.from_numpy(q).to(device), c_p)

    d_c = float(np.abs(c_t.numpy() - c_p.cpu().numpy()).max())
    d = float(np.abs(out_t - out_p.cpu().numpy()).max())
    print(f"  latent c: max diff {d_c:.3e} (scale {np.abs(c_t).mean():.3f})")
    print(f"  decoder logits: max diff {d:.3e} "
          f"(scale {np.abs(out_t).mean():.3f})")
    return max(d, d_c)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reference_root", default=_victims.REFERENCE_ROOT)
    p.add_argument("--device", default="cuda",
                   help="the port's side (default cuda; cpu when asked)")
    args = p.parse_args(argv)
    from if_defense_tpu_torch.cli import device_of

    device = device_of(args.device)
    print("ConvONet parity:")
    d1 = check_convonet(device=device, reference_root=args.reference_root)
    print("ONet parity:")
    d2 = check_onet(device=device, reference_root=args.reference_root)
    ok = d1 < 1e-3 and d2 < 1e-3
    print("PARITY", "OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
