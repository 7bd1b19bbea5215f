"""IF-Defense in PyTorch and CUDA, for one NVIDIA H100.

A port of `if_defense_tpu` (the JAX package, which stays the reference).
It mirrors the JAX package's layout so that each module's counterpart is
easy to find, keeps the JAX layouts at public function boundaries (points
`[B, N, 3]`, planes channel-last `[B, R, R, C]`, the repulsion mask int8
`[B, N, N]`) and never imports JAX.

Each Pallas kernel of the JAX package becomes a CUDA C++ kernel for
`sm_90a` under `csrc/`, built on first use by `ops/_build.py`. Every
kernel wrapper keeps a plain PyTorch version beside it: the wrapper takes
the plain version for tensors on the CPU and launches the kernel (or
raises) for tensors on a CUDA device.

Subpackages
-----------
- ``ops``       normalisation, point ops (kNN, FPS, ball query), scatter,
                plane sampling and the CUDA kernel wrappers
- ``data``      the npz interchange schema
- ``implicit``  ConvONet (encoder, UNet, decoder), ONet (encoder, CBN
                decoder) and occupancy training
- ``defense``   SRS, SOR, DUP-Net (PU-Net), repulsion and the ConvONet-Opt
                and ONet-Opt restoration loop
- ``cli``       `python -m if_defense_tpu_torch.cli.opt_defense`,
                `python -m if_defense_tpu_torch.cli.defend_npz` and
                `python -m if_defense_tpu_torch.cli.train_implicit`
- ``utils``     flat-npz params, the flax-to-torch layout map both ways,
                seeded init, the metrics sink
"""

__version__ = "0.1.0"
