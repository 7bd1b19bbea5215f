"""The TPU's default matmul precision on the port: a diagnostic mode.

The JAX package leaves its dense layers, convolutions, matmuls and einsums
at the default matmul precision, which on a TPU multiplies bf16-rounded
operands and accumulates in f32. It asks for more in a few places only
(a grep of `precision=` in `if_defense_tpu/`):

- `ops/pointops.py:39` square distances (HIGHEST); the port's
  `ops.pointops.square_distance`, which every kNN, SOR and chamfer term
  goes through;
- `implicit/convonet.py:349-355` the plane sampling on a lattice (HIGH);
  the port's `ConvOccupancyNetwork.lattice_planes`;
- `implicit/pointnetpp_encoder.py:62` the Gaussian-weighted features
  (HIGH); the port's `LocalPointDecoder.forward` product;
- `ops/interp.py`, `ops/scatter.py`, `ops/pointops.py:137,186` and
  `ops/pallas_ballquery.py:41` (HIGH or HIGHEST), whose counterparts in
  the port are its CUDA kernels or gathers, with no dense product;
- `cli/inference.py:185` (HIGHEST when `--boundary_tau` > 0, which the
  accuracy protocol leaves at 0).

`tpu_default_precision()` is a `torch.overrides.TorchFunctionMode` that
computes every other dense product of the port the TPU's way: both
operands rounded to bf16, the product in f32 with TF32 off. The products
are `F.linear`, `conv1d/2d/3d`, `conv_transpose1d/2d/3d`, `matmul`,
`bmm`, `mm`, `einsum` and the `@` operator. Their backward is the TPU's
too: the transposed products on the bf16-rounded incoming gradient and
operands (a bias's gradient is the f32 sum of the unrounded gradient, as
JAX's). A product called directly from one of the functions above, and
every hand-written kernel, keeps full f32. The mode is thread-local, as
torch's function modes are: it reaches code that runs in the thread that
entered it.

Usage (the accuracy protocol under the mode, one card; the arguments are
`tools/accuracy_benchmark_torch.py`'s, with `--device cuda:0` pinned so
every CLI runs its one shard in this thread):

    python tools/tpu_precision.py --out_dir runs/acc_tpu --seeds 0 \\
        --attacks clean knn --defenses none srs sor dup convonet_opt \\
        --opt_modes f32 bf16_r16 --occ_steps 10000 --test_per_class 50
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# products whose operands are (input, weight[, bias]); the bias is added
# in f32 and its gradient is the unrounded one
_WEIGHTED = {F.linear, F.conv1d, F.conv2d, F.conv3d, F.conv_transpose1d,
             F.conv_transpose2d, F.conv_transpose3d}
# products of two operands, each rounded
_PRODUCTS = {torch.matmul, torch.bmm, torch.mm, torch.Tensor.matmul,
             torch.Tensor.bmm, torch.Tensor.mm, torch.Tensor.__matmul__,
             torch.Tensor.__rmatmul__}


def _full_precision_codes() -> set:
    """The code objects whose own products JAX computes at HIGH or
    HIGHEST precision (the module docstring's list)."""
    from if_defense_tpu_torch.implicit.convonet import ConvOccupancyNetwork
    from if_defense_tpu_torch.implicit.pointnetpp_encoder import (
        LocalPointDecoder,
    )
    from if_defense_tpu_torch.ops import pointops

    return {pointops.square_distance.__code__,
            ConvOccupancyNetwork.lattice_planes.__code__,
            LocalPointDecoder.forward.__code__}


_SKIP_FILES = (os.path.join("torch", "overrides.py"),
               os.path.join("torch", "functional.py"), __file__)


def _caller_code():
    """The code object of the first frame outside torch's dispatch and
    this module: the function that called the product."""
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename.endswith(_SKIP_FILES):
        f = f.f_back
    return None if f is None else f.f_code


def round_bf16(x):
    """`x` rounded to bf16 (round to nearest even) and back to its type;
    anything but a floating tensor as it is."""
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(torch.bfloat16).to(x.dtype)
    return x


class _Rounded(torch.autograd.Function):
    """`call(*operands, *rest)` on bf16-rounded operands, whose backward is
    the same products' backward on the bf16-rounded incoming gradient.
    `rest[0]` may be a bias (`biased`), whose gradient is the unrounded
    one. The forward keeps the product's own graph and the backward runs
    it: no product is computed twice."""

    @staticmethod
    def forward(ctx, call, n_ops, biased, *args):
        with torch.enable_grad():
            leaves = []
            for i, a in enumerate(args):
                if isinstance(a, torch.Tensor) and (
                        i < n_ops or (biased and i == n_ops)):
                    a = (round_bf16(a) if i < n_ops else a).detach() \
                        .requires_grad_(a.requires_grad)
                leaves.append(a)
            out = call(*leaves)
        ctx.out, ctx.leaves = out, leaves
        ctx.n_ops, ctx.biased = n_ops, biased
        return out.detach()

    @staticmethod
    def backward(ctx, g):
        out, leaves, n = ctx.out, ctx.leaves, ctx.n_ops
        grads = [None] * len(leaves)
        ops = [i for i in range(n) if leaves[i].requires_grad]
        bias = (n if ctx.biased and isinstance(leaves[n], torch.Tensor)
                and leaves[n].requires_grad else None)
        if ops:
            got = torch.autograd.grad(out, [leaves[i] for i in ops],
                                      round_bf16(g),
                                      retain_graph=bias is not None)
            for i, v in zip(ops, got):
                grads[i] = v
        if bias is not None:
            grads[bias], = torch.autograd.grad(out, [leaves[bias]], g)
        ctx.out = ctx.leaves = None
        return (None, None, None, *grads)


class TPUDefaultPrecision(TorchFunctionMode):
    """The mode; `counts` holds, per product name, the calls it rounded
    and (under "full precision") the calls it left in f32."""

    def __init__(self):
        super().__init__()
        self.counts: dict[str, int] = {}
        self._full = _full_precision_codes()
        self._lock = threading.Lock()

    def _count(self, key: str) -> None:
        with self._lock:
            self.counts[key] = self.counts.get(key, 0) + 1

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in _WEIGHTED:
            x, w, *rest = args
            bias = rest[0] if rest else kwargs.pop("bias", None)
            tail = rest[1:]
            self._count(func.__name__)
            return self._apply(lambda *a: func(*a, *tail, **kwargs), 2,
                               True, (x, w, bias))
        if func is torch.einsum or func in _PRODUCTS:
            if _caller_code() in self._full:
                self._count("full precision")
                return func(*args, **kwargs)
            if func is torch.einsum:
                eq, *ops = args
                if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
                    ops = list(ops[0])
                self._count("einsum")
                return self._apply(lambda *o: torch.einsum(eq, *o),
                                   len(ops), False, tuple(ops))
            self._count(func.__name__)
            return self._apply(lambda *a: func(*a, **kwargs), 2, False,
                               tuple(args))
        return func(*args, **kwargs)

    @staticmethod
    def _apply(call, n_ops, biased, args):
        if torch.is_grad_enabled() and any(
                isinstance(a, torch.Tensor) and a.requires_grad
                for a in args):
            return _Rounded.apply(call, n_ops, biased, *args)
        return call(*[round_bf16(a) if i < n_ops else a
                      for i, a in enumerate(args)])


@contextlib.contextmanager
def tpu_default_precision():
    """Within the block, the port's dense products as the TPU's default
    precision computes them (module docstring), with TF32 off; TF32's
    settings are restored on exit. Yields the mode (its `counts`)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mode = TPUDefaultPrecision()
    try:
        with mode:
            yield mode
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32


def main(argv=None):
    """`tools/accuracy_benchmark_torch.main(argv)` under the mode, on one
    card (`--device cuda:0` unless another single card is given)."""
    from tools import accuracy_benchmark_torch as acc

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--device" in argv:
        dev = argv[argv.index("--device") + 1]
        if dev == "cuda":
            raise SystemExit("--device cuda would split batches over "
                             "threads, which the mode does not reach; "
                             "give one card, e.g. cuda:0")
    else:
        argv += ["--device", "cuda:0"]
    with tpu_default_precision() as mode:
        out = acc.main(argv)
    print("tpu_default_precision calls:", dict(sorted(mode.counts.items())),
          flush=True)
    return out


if __name__ == "__main__":
    main()
