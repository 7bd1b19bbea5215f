"""Whole-batch statistics for a batch split over devices.

A split train step runs one shard per device, one thread each
(`mesh.run_shards`). What JAX computes over the global batch of a sharded
step, the shards compute here from exchanged partials:

- means over the batch: `batch_mean(x)` divides a shard's sum by the whole
  batch's count inside `shard_of(total)`, so the shards' values add up to
  the whole batch's mean (the losses, the accuracy);
- train-mode batch norms: inside `StatsExchange.shard(i)`, each norm hands
  in its partial `[sum x, sum x^2]` over every axis but the last with its
  element count (`all_sum`) and gets back the global sums on its own
  device. The partials are added on the first device in shard order, so
  every shard sees the same bits and a rerun under deterministic
  algorithms is bit-equal. The sum is one autograd node
  (`_AllSumToDevices`), whose backward adds the shards' gradients on the
  first device in shard order, so one backward over all shards gives each
  shard's activations their share of the global statistics' gradient, in
  an order that does not depend on which card finishes first.

The exchange lives inside the process (no process group); the CPU tests
split over `[cpu, cpu]`.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Sequence

import torch

from if_defense_tpu_torch.parallel.mesh import ShardAborted

# the whole batch's count while this thread runs a share of it
_BATCH_TOTAL = contextvars.ContextVar("batch_total", default=None)
# (exchange, shard index) while this thread runs a shard's forward
_SHARD = contextvars.ContextVar("stats_shard", default=None)

# how long a shard waits for the others at one exchange; the first forward
# on a card may build the kernels' libraries (nvcc) under a lock
EXCHANGE_TIMEOUT_S = 600.0


@contextlib.contextmanager
def shard_of(total: int):
    """Inside, `batch_mean` divides by `total`, the count of the batch that
    this thread's examples are a share of."""
    token = _BATCH_TOTAL.set(total)
    try:
        yield
    finally:
        _BATCH_TOTAL.reset(token)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the batch of per-example values [B], `x.sum() /
    total`: inside `shard_of(total)` this share's part of the whole
    batch's mean, else `total` is B. Each example's gradient is the
    incoming one over the count, rounded as `x.mean()`'s is."""
    total = _BATCH_TOTAL.get()
    return x.sum() / (len(x) if total is None else total)


def current_exchange() -> tuple[StatsExchange, int] | None:
    """(the exchange, this thread's shard index) inside
    `StatsExchange.shard`, else None."""
    return _SHARD.get()


class _AllSumToDevices(torch.autograd.Function):
    """n partials (shard i's on devices[i]) -> their sum on every shard's
    device: added on the first device in shard order, then copied.
    Backward: the n incoming gradients added on the first device in shard
    order, then copied back to each shard's device."""

    @staticmethod
    def forward(ctx, devices, *partials):
        ctx.devices = devices
        home = devices[0]
        total = partials[0].to(home)
        for p in partials[1:]:
            total = total + p.to(home)
        return (total, *(total.to(d, copy=True) for d in devices[1:]))

    @staticmethod
    def backward(ctx, *grads):
        home = ctx.devices[0]
        g = grads[0].to(home)
        for gi in grads[1:]:
            g = g + gi.to(home)
        return (None, g, *(g.to(d, copy=True) for d in ctx.devices[1:]))


class StatsExchange:
    """The rendezvous of one split step's shards (module docstring).

    Each shard runs its forward inside `shard(i)`. Over two or more
    shards every call of `all_sum` is a rendezvous of all of them, and so
    is the end of the forward (one shard has nothing to exchange): a
    shard that exchanges a different number of times than the others, or
    a partial of another shape, makes every shard raise. A
    shard that raises inside `shard(i)` aborts the rendezvous, so the
    others raise `ShardAborted` at once instead of waiting; a wait longer
    than `timeout` seconds raises `TimeoutError`."""

    def __init__(self, devices: Sequence, timeout: float = EXCHANGE_TIMEOUT_S):
        self.devices = [torch.device(d) for d in devices]
        self.timeout = timeout
        self._posts: list = [None] * len(self.devices)
        self._calls = [0] * len(self.devices)
        self._result = None
        self._failed = False
        self._barrier = threading.Barrier(len(self.devices),
                                          action=self._combine)

    @contextlib.contextmanager
    def shard(self, i: int):
        """Run shard i's forward: `current_exchange()` is (self, i)
        inside; on leaving, a last rendezvous of two or more shards
        checks that every shard exchanged as often."""
        token = _SHARD.set((self, i))
        try:
            yield
            if len(self.devices) > 1:
                self._meet(i, ("end",))
        except BaseException:
            self.abort()
            raise
        finally:
            _SHARD.reset(token)

    def abort(self) -> None:
        """Break the rendezvous: every shard waiting or yet to wait raises
        `ShardAborted`."""
        self._failed = True
        self._barrier.abort()

    def all_sum(self, partial: torch.Tensor, count: int
                ) -> tuple[torch.Tensor, int]:
        """This thread's shard's partial sums and element count -> the
        sums and count over every shard, the sums on this shard's
        device. One shard's own sums are the whole batch's: it returns
        them as they are, with no rendezvous."""
        context = current_exchange()
        if context is None or context[0] is not self:
            raise RuntimeError("all_sum outside this exchange's shard()")
        if len(self.devices) == 1:
            return partial, count
        i = context[1]
        totals, n = self._meet(i, ("sum", partial, count))
        return totals[i], n

    def _meet(self, i: int, post: tuple):
        self._posts[i] = post
        self._calls[i] += 1
        t0 = time.monotonic()
        try:
            self._barrier.wait(self.timeout)
        except threading.BrokenBarrierError:
            if self._failed:
                raise ShardAborted(
                    f"shard {i}: another shard of the split step failed"
                ) from None
            raise TimeoutError(
                f"shard {i} waited {time.monotonic() - t0:.1f} s at "
                f"exchange {self._calls[i] - 1} for the other shards "
                f"(limit {self.timeout} s)") from None
        return self._result

    def _combine(self) -> None:
        """The barrier's action, run by the last shard to arrive while the
        others wait."""
        posts = self._posts
        kinds = [(p[0], tuple(p[1].shape), p[1].dtype) if p[0] == "sum"
                 else p for p in posts]
        if len(set(kinds)) > 1:
            self._failed = True
            raise RuntimeError(
                "the shards of a split step exchange batch statistics "
                f"unevenly: at exchange {self._calls[0] - 1} they hand in "
                f"{[k[:2] for k in kinds]}")
        if posts[0][0] == "end":
            self._result = None
            return
        try:
            totals = _AllSumToDevices.apply(self.devices,
                                            *(p[1] for p in posts))
        except BaseException:
            self._failed = True
            raise
        self._result = (totals, sum(p[2] for p in posts))
