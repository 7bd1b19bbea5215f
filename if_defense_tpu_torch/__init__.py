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
- ``data``      the npz interchange schema, the ModelNet40 dataset
                variants and `batch_iterator`
- ``models``    the victim classifiers: PointNet, PointNet++ (SSG),
                DGCNN, PointConv and RS-CNN, and `build_model`
- ``training``  the victims' eval step
- ``implicit``  ConvONet (encoder, UNet, decoder, lattice evaluation),
                ONet (encoder, CBN decoder), occupancy training and mesh
                generation (`implicit.generation`)
- ``native``    the host isosurface library (the JAX package's C++,
                built with g++ on first use): marching, sampling,
                fine-grid assembly, QEM simplification
- ``defense``   SRS, SOR, DUP-Net (PU-Net), repulsion and the ConvONet-Opt
                and ONet-Opt restoration loop
- ``cli``       `python -m if_defense_tpu_torch.cli.opt_defense`,
                `python -m if_defense_tpu_torch.cli.defend_npz`,
                `python -m if_defense_tpu_torch.cli.train_implicit`,
                `python -m if_defense_tpu_torch.cli.inference`,
                `python -m if_defense_tpu_torch.cli.remesh_defense` and
                `python -m if_defense_tpu_torch.cli.attack`
- ``utils``     flat-npz params, the flax-to-torch layout map both ways,
                seeded init, victim checkpoints (flat npz), the checkpoint
                registry, `BoundedCache`, the metrics sink, mesh files,
                YAML configs (`config`), `PhaseTimer` and `trace`
                (`profiling`)
- ``convert``   the reference's pretrained `.pth` files to the flax tree
- ``parallel``  device meshes; a batch split over the visible cards,
                one thread a card (the eval CLIs use it)
"""

__version__ = "0.1.0"
