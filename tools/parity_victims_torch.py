"""Golden parity check of the port's victim classifiers against the
reference's torch modules.

The port of `tools/parity_victims.py`. Instantiates the reference models
(from `--reference_root`, on the CPU, eval mode; random weights with
randomised batch-norm statistics, or a given state dict), converts their
state dicts with `if_defense_tpu_torch.convert.victim_weights`, runs the
port's model on `--device` (TF32 off) and compares the logits. DGCNN's
hard-coded `device('cuda')` (`baselines/model/dgcnn.py:22`) is patched to
the CPU for the reference's forward.

Run: python tools/parity_victims_torch.py [--device cuda] \
         [--reference_root DIR]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the reference repository: by default a checkout of it at `reference/`
# inside this one (listed in .gitignore)
REFERENCE_ROOT = os.path.join(ROOT, "reference")


def use_reference(root: str, *sub: str) -> None:
    """Put `<root>/<sub>` first on the import path."""
    path = os.path.join(root, *sub)
    if path not in sys.path:
        sys.path.insert(0, path)


def _randomise_bn(module):
    import torch

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.uniform_(-0.3, 0.3)
                m.running_var.uniform_(0.5, 1.5)


def _init_weights(net, sd):
    """Random BN stats (structural parity) or a given state dict (the
    reference's checkpoints may carry DataParallel 'module.' prefixes,
    stripped as the converters strip them)."""
    net.eval()
    if sd is None:
        _randomise_bn(net)
    else:
        net.load_state_dict(
            {k[7:] if k.startswith("module.") else k: v
             for k, v in sd.items()})
        net.eval()


def port_logits(name: str, sd: dict, pc: np.ndarray, device) -> np.ndarray:
    """The port's `name` victim with the converted `sd`, run on `device`
    in eval mode with TF32 off: its logits on the CPU."""
    import torch

    from if_defense_tpu_torch.convert import victim_weights
    from if_defense_tpu_torch.models import build_model
    from if_defense_tpu_torch.utils.params_io import params_from_jax

    variables = getattr(victim_weights, f"convert_{name}_pth")(sd)
    model = build_model(name)
    model.load_state_dict(params_from_jax(variables, model), strict=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = model.eval().to(device)
    with torch.no_grad():
        out = model(torch.from_numpy(pc).to(device))[0]
    return out.cpu().numpy()


def _report(name: str, logits_t: np.ndarray, logits_p: np.ndarray) -> float:
    d = float(np.abs(logits_t - logits_p).max())
    print(f"  {name} logits: max diff {d:.3e} "
          f"(scale {np.abs(logits_t).mean():.3f})")
    return d


def _zero_randint():
    """`torch.randint` giving zeros: the reference's FPS then starts at
    point 0, as the port's does."""
    import torch

    def zero_randint(low, high, size, **kw):
        kw.setdefault("dtype", torch.long)
        return torch.zeros(size, dtype=kw["dtype"])

    return zero_randint


def check_pointnet(sd=None, device="cuda", reference_root=REFERENCE_ROOT):
    import torch

    use_reference(reference_root, "baselines")
    from model.pointnet import PointNetCls

    torch.manual_seed(0)
    net = PointNetCls(k=40, feature_transform=False, use_bn=True)
    _init_weights(net, sd)

    rng = np.random.default_rng(0)
    pc = rng.normal(size=(4, 128, 3)).astype(np.float32)
    with torch.no_grad():
        logits_t, _, _ = net(torch.from_numpy(pc.transpose(0, 2, 1)))
    return _report("pointnet", logits_t.numpy(),
                   port_logits("pointnet", net.state_dict(), pc, device))


def check_dgcnn(sd=None, device="cuda", reference_root=REFERENCE_ROOT):
    import torch

    # the reference hard-codes cuda for the gather index helper: patch
    real_device = torch.device

    def fake_device(arg):
        return real_device("cpu") if arg == "cuda" else real_device(arg)

    use_reference(reference_root, "baselines")
    torch.device = fake_device
    try:
        from model.dgcnn import DGCNN as TorchDGCNN

        torch.manual_seed(0)
        net = TorchDGCNN(emb_dims=1024, k=20, output_channels=40, use_bn=True)
        _init_weights(net, sd)

        rng = np.random.default_rng(1)
        pc = rng.normal(size=(2, 64, 3)).astype(np.float32)
        with torch.no_grad():
            logits_t = net(torch.from_numpy(pc.transpose(0, 2, 1))).numpy()
    finally:
        torch.device = real_device
    return _report("dgcnn", logits_t,
                   port_logits("dgcnn", net.state_dict(), pc, device))


def _check_sampled(name: str, make, seed: int, sd, device) -> float:
    """PointNet++ and PointConv: 2 clouds of 256 points, the reference's
    FPS started at point 0."""
    import torch

    torch.manual_seed(0)
    net = make()
    _init_weights(net, sd)

    rng = np.random.default_rng(seed)
    pc = rng.normal(size=(2, 256, 3)).astype(np.float32)
    orig_randint = torch.randint
    torch.randint = _zero_randint()
    try:
        with torch.no_grad():
            logits_t = net(torch.from_numpy(pc.transpose(0, 2, 1))).numpy()
    finally:
        torch.randint = orig_randint
    return _report(name, logits_t,
                   port_logits(name, net.state_dict(), pc, device))


def check_pointnet2(sd=None, device="cuda", reference_root=REFERENCE_ROOT):
    use_reference(reference_root, "baselines")
    from model.pointnet2 import PointNet2ClsSsg as TorchPN2

    return _check_sampled("pointnet2", lambda: TorchPN2(num_classes=40), 2,
                          sd, device)


def check_pointconv(sd=None, device="cuda", reference_root=REFERENCE_ROOT):
    use_reference(reference_root, "baselines")
    from model.pointconv import PointConvDensityClsSsg as TorchPC

    return _check_sampled("pointconv", lambda: TorchPC(num_classes=40), 3,
                          sd, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reference_root", default=REFERENCE_ROOT)
    p.add_argument("--device", default="cuda",
                   help="the port's side (default cuda; cpu when asked)")
    args = p.parse_args(argv)
    from if_defense_tpu_torch.cli import device_of

    device = device_of(args.device)
    ds = []
    for title, check in (("PointNet", check_pointnet),
                         ("DGCNN", check_dgcnn),
                         ("PointNet++", check_pointnet2),
                         ("PointConv", check_pointconv)):
        print(f"{title} parity:")
        ds.append(check(device=device, reference_root=args.reference_root))
    ok = all(d < 1e-3 for d in ds)
    print("PARITY", "OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
