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

`tpu_default_precision()` computes every other dense product of the port
the TPU's way: both operands rounded to bf16, the product in f32 with TF32
off. It patches the product entry points for the length of the block:
`F.linear`, `conv1d/2d/3d` and `conv_transpose1d/2d/3d` (which `nn.Linear`
and `nn.Conv*` call), and `torch.matmul`, `bmm`, `mm`, `einsum` and the
`Tensor` methods `matmul`, `bmm`, `mm` and `@` (the port's few direct
product sites). No other op passes through Python. Their backward is the TPU's
too: the transposed products on the bf16-rounded incoming gradient and
operands (a bias's gradient is the f32 sum of the unrounded gradient, as
JAX's). A product called directly from one of the functions above, and
every hand-written kernel, keeps full f32. The mode reaches code that runs
in the thread that entered it; other threads see the f32 products.

Usage (the accuracy protocol under the mode, one card; the arguments are
`tools/accuracy_benchmark_torch.py`'s, with `--device cuda:0` pinned so
every CLI runs its one shard in this thread; `--mode_legs` limits the
mode to the legs whose names start with one of its words, e.g.
`train_implicit` for the ConvONet's training alone):

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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# products whose operands are (input, weight[, bias]); the bias is added
# in f32 and its gradient is the unrounded one
_WEIGHTED = ("linear", "conv1d", "conv2d", "conv3d", "conv_transpose1d",
             "conv_transpose2d", "conv_transpose3d")
# products of two operands, each rounded: (owner, attribute, count name)
_PRODUCTS = ((torch, "matmul", "matmul"), (torch, "bmm", "bmm"),
             (torch, "mm", "mm"), (torch.Tensor, "matmul", "matmul"),
             (torch.Tensor, "bmm", "bmm"), (torch.Tensor, "mm", "mm"),
             (torch.Tensor, "__matmul__", "matmul"))


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


class TPUDefaultPrecision:
    """The mode of one thread; `counts` holds, per product name, the calls
    it rounded and (under "full precision") the calls it left in f32."""

    def __init__(self):
        self.counts: dict[str, int] = {}
        self._full = _full_precision_codes()

    def _count(self, key: str) -> None:
        self.counts[key] = self.counts.get(key, 0) + 1

    def weighted(self, func, name, args, kwargs):
        x, w, *rest = args
        bias = rest[0] if rest else kwargs.pop("bias", None)
        tail = rest[1:]
        self._count(name)
        return _apply(lambda *a: func(*a, *tail, **kwargs), 2, True,
                      (x, w, bias))

    def product(self, func, name, args, kwargs):
        if _caller_code() in self._full:
            self._count("full precision")
            return func(*args, **kwargs)
        self._count(name)
        return _apply(lambda *a: func(*a, **kwargs), 2, False, tuple(args))

    def einsum(self, func, args):
        if _caller_code() in self._full:
            self._count("full precision")
            return func(*args)
        eq, *ops = args
        if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
            ops = list(ops[0])
        self._count("einsum")
        return _apply(lambda *o: func(eq, *o), len(ops), False, tuple(ops))


def _apply(call, n_ops, biased, args):
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return _Rounded.apply(call, n_ops, biased, *args)
    return call(*[round_bf16(a) if i < n_ops else a
                  for i, a in enumerate(args)])


_local = threading.local()          # .mode: this thread's mode, if any


def _entry(kind, func, name):
    """The patched entry point: `func` itself outside the mode."""
    if kind == "weighted":
        def patched(*args, **kwargs):
            mode = getattr(_local, "mode", None)
            if mode is None:
                return func(*args, **kwargs)
            return mode.weighted(func, name, args, dict(kwargs))
    elif kind == "einsum":
        def patched(*args, **kwargs):
            mode = getattr(_local, "mode", None)
            if mode is None:
                return func(*args, **kwargs)
            return mode.einsum(func, args)
    else:
        def patched(*args, **kwargs):
            mode = getattr(_local, "mode", None)
            if mode is None:
                return func(*args, **kwargs)
            return mode.product(func, name, args, kwargs)
    return patched


class _Patches:
    """The entry points, patched while at least one thread is in the mode
    and torch's own again when the last one leaves."""

    def __init__(self):
        self.lock = threading.Lock()
        self.users = 0
        self.saved: list = []        # (owner, attribute, its own or None)

    def enter(self) -> None:
        with self.lock:
            if self.users == 0:
                entries = [(F, n, "weighted", n) for n in _WEIGHTED]
                entries += [(owner, attr, "product", name)
                            for owner, attr, name in _PRODUCTS]
                entries.append((torch, "einsum", "einsum", "einsum"))
                for owner, attr, kind, name in entries:
                    self.saved.append((owner, attr, vars(owner).get(attr)))
                    setattr(owner, attr,
                            _entry(kind, getattr(owner, attr), name))
            self.users += 1

    def leave(self) -> None:
        with self.lock:
            self.users -= 1
            while self.users == 0 and self.saved:
                owner, attr, original = self.saved.pop()
                if original is None:
                    delattr(owner, attr)
                else:
                    setattr(owner, attr, original)


_PATCHES = _Patches()


@contextlib.contextmanager
def tpu_default_precision():
    """Within the block, the port's dense products as the TPU's default
    precision computes them (module docstring), with TF32 off; TF32's
    settings and the entry points are restored on exit. Yields the mode
    (its `counts`)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mode, outer = TPUDefaultPrecision(), getattr(_local, "mode", None)
    _PATCHES.enter()
    _local.mode = mode
    try:
        yield mode
    finally:
        _local.mode = outer
        _PATCHES.leave()
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32


def mode_legs(words: list[str]):
    """A `Legs.context` that enters the mode for the legs whose names
    start with one of `words`; -> (context, the modes it entered)."""
    modes = []

    @contextlib.contextmanager
    def context(leg: str):
        if not leg.startswith(tuple(words)):
            yield
            return
        with tpu_default_precision() as mode:
            modes.append(mode)
            yield
    return context, modes


def main(argv=None):
    """`tools/accuracy_benchmark_torch.main(argv)` under the mode, on one
    card (`--device cuda:0` unless another single card is given); with
    `--mode_legs W [W ...]`, only the legs whose names start with a W."""
    from tools import accuracy_benchmark_torch as acc

    argv = list(sys.argv[1:] if argv is None else argv)
    words = None
    if "--mode_legs" in argv:
        i = argv.index("--mode_legs")
        j = i + 1
        while j < len(argv) and not argv[j].startswith("--"):
            j += 1
        words, argv = argv[i + 1:j], argv[:i] + argv[j:]
        if not words:
            raise SystemExit("--mode_legs needs at least one leg name")
    if "--device" in argv:
        dev = argv[argv.index("--device") + 1]
        if dev == "cuda":
            raise SystemExit("--device cuda would split batches over "
                             "threads, which the mode does not reach; "
                             "give one card, e.g. cuda:0")
    else:
        argv += ["--device", "cuda:0"]
    if words is None:
        with tpu_default_precision() as mode:
            out = acc.main(argv)
        counts = mode.counts
    else:
        default, (context, modes) = acc.Legs.context, mode_legs(words)
        acc.Legs.context = staticmethod(context)
        try:
            out = acc.main(argv)
        finally:
            acc.Legs.context = staticmethod(default)
        counts = {}
        for mode in modes:
            for k, v in mode.counts.items():
                counts[k] = counts.get(k, 0) + v
        print(f"tpu_default_precision legs: {words}, {len(modes)} entered",
              flush=True)
    print("tpu_default_precision calls:", dict(sorted(counts.items())),
          flush=True)
    return out


if __name__ == "__main__":
    main()
