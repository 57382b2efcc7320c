"""The collectives of the sharded paths, each with its backward written out.

Four operations, over a process group of the mesh (``None``, a mesh
without a process group, makes each an identity):

- ``gather_rows``: the all-gather of equal row tiles into the frame; its
  backward is this rank's slice of the cotangent (times ``grad_scale``).
- ``winner_mask``: the all-gather of each shard's hit distance ``t`` and
  the shard whose ``t`` is least, the first on ties, as ``jnp.argmin``;
  no gradient.
- ``masked_sum``: the sum over the group of each rank's planes where it is
  the winner and zeros elsewhere (bools and ints as int32), so every rank
  gets the winner's record; its backward sums the cotangents over the
  group and keeps them where this rank won, the transpose of the JAX
  package's ``psum`` under ``shard_map(check_vma=False)``.
- ``all_sum`` and ``sum_grads``: the sum over the group of a tensor, and of
  every parameter's gradient in place after ``backward()``.

The backwards do not come from ``torch.distributed.nn.functional``, whose
all-reduce backward sums cotangents whatever the caller needs. While a
``census()`` block is open, every collective notes its kind, group size,
element count and dtype.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

__all__ = [
    "gather_rows",
    "first_min",
    "winner_mask",
    "pick",
    "masked_sum",
    "all_sum",
    "sum_grads",
    "census",
]

_log: list | None = None


@contextlib.contextmanager
def census():
    """A list that every collective made inside the block appends
    ``(kind, group size, elements, dtype)`` to."""
    global _log
    prev, _log = _log, []
    try:
        yield _log
    finally:
        _log = prev


def _note(kind: str, group, x: torch.Tensor) -> None:
    if _log is not None:
        _log.append((kind, dist.get_world_size(group), x.numel(), str(x.dtype)))


def _all_gather(x: torch.Tensor, group) -> list:
    _note("all_gather", group, x)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    _note("all_reduce", group, x)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_scale):
        ctx.group, ctx.grad_scale, ctx.rows = group, grad_scale, x.shape[0]
        return torch.cat(_all_gather(x.contiguous(), group), dim=0)

    @staticmethod
    def backward(ctx, ct):
        r0 = dist.get_rank(ctx.group) * ctx.rows
        ct = ct[r0:r0 + ctx.rows]
        return (ct * ctx.grad_scale if ctx.grad_scale != 1.0 else ct), None, None


def gather_rows(x: torch.Tensor, group, grad_scale: float = 1.0) -> torch.Tensor:
    """The group's equal ``[rows, ...]`` tiles, joined in group-rank order
    along the rows. Backward: this rank's slice of the cotangent, times
    ``grad_scale``: a loss taken alike on every rank, its gradients summed
    over the ranks, counts each tile once."""
    if group is None:
        return x
    return _GatherRows.apply(x, group, grad_scale)


def first_min(ts: torch.Tensor) -> torch.Tensor:
    """The index along the first axis of ``ts`` (``[shards, ...]``) of the
    least value, the first on ties (``torch.argmin``, as ``jnp.argmin``)."""
    return torch.argmin(ts, dim=0)


def winner_mask(t: torch.Tensor, group) -> torch.Tensor:
    """Where this rank holds the least ``t`` of the group, the lowest group
    rank on ties (``first_min``). Every rank gets the same winners."""
    if group is None:
        return torch.ones_like(t, dtype=torch.bool)
    with torch.no_grad():
        win = first_min(torch.stack(_all_gather(t.detach().contiguous(), group)))
    return win == dist.get_rank(group)


def pick(planes, mask: torch.Tensor) -> tuple:
    """Each plane where ``mask`` and zeros elsewhere, bool and int planes
    as int32: one rank's part of ``masked_sum``, whose sum over the ranks
    of a group is the winner's planes."""
    return tuple(torch.where(mask, p, 0.0) if p.is_floating_point()
                 else torch.where(mask, p.to(torch.int32), 0) for p in planes)


class _MaskedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, mask, *planes):
        ctx.group, ctx.mask = group, mask
        ctx.floats = [p.is_floating_point() for p in planes]
        picked = pick(planes, mask)
        out = [None] * len(planes)
        for floats in (True, False):
            idx = [k for k, f in enumerate(ctx.floats) if f == floats]
            if idx:
                packed = _all_reduce(torch.stack([picked[k] for k in idx]), group)
                for row, k in enumerate(idx):
                    out[k] = packed[row].to(planes[k].dtype)
        ctx.mark_non_differentiable(*(o for o, f in zip(out, ctx.floats) if not f))
        return tuple(out)

    @staticmethod
    def backward(ctx, *cts):
        idx = [k for k, f in enumerate(ctx.floats) if f]
        shape = ctx.mask.shape
        packed = torch.stack([
            torch.zeros(shape, device=ctx.mask.device) if cts[k] is None else cts[k]
            for k in idx])
        packed = torch.where(ctx.mask, _all_reduce(packed.contiguous(), ctx.group), 0.0)
        grads = [None] * len(cts)
        for row, k in enumerate(idx):
            grads[k] = packed[row]
        return None, None, *grads


def masked_sum(planes, mask: torch.Tensor, group) -> tuple:
    """The winner's planes on every rank of the group: the sum over the
    group of each plane where ``mask`` (this rank won) and zeros elsewhere,
    float planes in one all-reduce, bool and int planes as int32 in
    another. Differentiable in the float planes."""
    if group is None:
        return tuple(planes)
    return _MaskedSum.apply(group, mask, *planes)


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group, a new tensor (no gradient)."""
    x = x.detach().clone()
    return x if group is None else _all_reduce(x, group)


def sum_grads(params, group) -> None:
    """Sum every parameter's ``.grad`` over the group, in place; a
    parameter without one takes part with zeros, so every rank makes the
    same collectives."""
    if group is None:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        _all_reduce(p.grad, group)
