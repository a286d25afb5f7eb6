"""The row scatter-add of the train step and the vertex gather whose
backward it is (one hand-written CUDA kernel, csrc/scatter.cu).

`scatter_rows(rows, idx, num)` is out[num,C] = 0; out[idx[r]] += rows[r]:
the JAX package's `.at[idx].add(rows)` and `segment_sum`, and the transpose
of its vertex gathers. On CPU tensors it runs the plain version
`scatter_rows_plain` (`index_add_`, which on the CPU sums each
destination's rows in ascending row order, as JAX's CPU scatter does); on
CUDA tensors the kernel, which sums in that same order, each add rounded on
its own, so both give the same bits on every run. The kernel has two
routes, which `scatter_route` chooses from the call's sizes: "cluster", one
launch of one thread-block cluster, for calls up to 65,536 rows (the
step's silhouette views), and "grid", a single-sweep radix sort over the
whole card, for the rest. No fallback: a CUDA tensor launches its route
or raises; no route gives way to the other.

`gather_rows(x, idx)` is x[idx] with `scatter_rows` as its backward, so the
step's vertex gathers no longer differentiate through advanced indexing
(IndexBackward0, a sort-based `index_put_` with accumulate on the card).

An index outside [0, num) raises `RuntimeError`. A call on its own reads
the kernel's flag and raises at once, which waits for the launch. Inside
`deferred_bounds_check(word)` (the scope of a CUDA graph of the train
step) a call ORs its flag into `word` on the device and reads nothing; the
word's owner reads it once, later, and raises then
(`raise_if_out_of_bounds`).
"""

from __future__ import annotations

import contextlib

import torch

from drt_tpu_torch import kernels

_INT32_MAX = 2 ** 31 - 1

ROUTES = ("cluster", "grid")          # csrc/scatter.cu's route 0 and 1
# The cluster route takes a call of at most CLUSTER_MAX_ROWS rows into at
# most CLUSTER_MAX_OUT output elements. One cluster runs on 16 of the
# card's 132 multiprocessors, so its time grows with the rows faster than
# the grid route's: measured on every call of the step on dog_mid{20k,45k,
# 90k} (scripts/tune_torch_oracle.py --what scatter-routes), the cluster
# route is the faster up to 65,536 rows (the silhouette views) and ties or
# loses above (the soups' second stages from 98,304 rows, the normals, the
# dihedral term). The output bound keeps the zeroing of a large output
# (2^24 destinations) on the whole card.
CLUSTER_MAX_ROWS = 2 ** 16
CLUSTER_MAX_OUT = 2 ** 20

# The device word of the open `deferred_bounds_check` scope, or None. A
# module variable, not a thread-local: the backward's scatters run on the
# autograd engine's own thread.
_deferred_word = None


@contextlib.contextmanager
def deferred_bounds_check(word: torch.Tensor):
    """For the duration, each `scatter_rows_cuda` call ORs its out-of-range
    flag into `word` ([1] int32 on the card) instead of reading it, so the
    call never waits on the host. Scopes do not nest."""
    global _deferred_word
    if word.dtype != torch.int32 or word.shape != (1,):
        raise ValueError(f"word: expected [1] int32, got "
                         f"{tuple(word.shape)} {word.dtype}")
    if _deferred_word is not None:
        raise RuntimeError("deferred_bounds_check: a scope is already open")
    _deferred_word = word
    try:
        yield word
    finally:
        _deferred_word = None


def raise_if_out_of_bounds(flag, num=None):
    """Raise the out-of-range error if `flag` (a host number) is set."""
    if flag:
        into = f" for {num} destinations" if num is not None else ""
        raise RuntimeError(f"scatter_rows: an index is out of bounds{into}")


def scatter_route(n_rows: int, n_cols: int, n_out: int) -> str:
    """The route of csrc/scatter.cu that a call of n_rows rows of n_cols
    into n_out destinations takes: "cluster" up to CLUSTER_MAX_ROWS rows
    and CLUSTER_MAX_OUT output elements, "grid" above."""
    if n_rows <= CLUSTER_MAX_ROWS and n_out * n_cols <= CLUSTER_MAX_OUT:
        return "cluster"
    return "grid"


@kernels.checks("scatter")
def _check_lib(lib):
    """A card that schedules the cluster route's cluster."""
    if lib.scatter_cluster_size() < 1:
        raise RuntimeError("scatter: the card schedules no cluster of the "
                           "cluster route's CTAs")


def cluster_size() -> int:
    """The CTAs of the cluster route's one cluster on this card (16 where
    the card schedules it, from cudaOccupancyMaxActiveClusters at the
    first call); raises if the card schedules none."""
    return kernels.library("scatter").scatter_cluster_size()


def scatter_rows_plain(rows, idx, num: int):
    """Plain version of csrc/scatter.cu: rows [R,C] summed into [num,C] at
    idx [R] (int64), each destination's rows in ascending row order on the
    CPU."""
    return rows.new_zeros((num, rows.shape[1])).index_add_(0, idx, rows)


def _check(rows, idx, num: int):
    kernels.expect("rows", rows, (None, None), kernels.FLOATS, rows.device)
    kernels.expect("idx", idx, (rows.shape[0],), torch.int64, rows.device)
    if not 0 <= num <= _INT32_MAX or rows.shape[0] > _INT32_MAX // 2:
        raise ValueError(f"{rows.shape[0]} rows into {num}: beyond the "
                         "kernel's int32 sizes")


def scatter_rows_cuda(rows, idx, num: int, route: str | None = None):
    """Launch csrc/scatter.cu on the current stream: inputs and result as in
    `scatter_rows_plain`, contiguous on one CUDA device, 1 <= C <= 16, on
    `route` ("cluster" or "grid"; by default `scatter_route`'s). Rows
    whose every entry is +-0 are skipped (the same bits). An index outside
    [0, num) raises, as in the plain version: the kernel flags it and the
    wrapper reads the flag, which waits for the launch to finish; inside
    `deferred_bounds_check` the flag is ORed into the scope's word on the
    device and nothing waits."""
    _check(rows, idx, num)
    kernels.need_cuda("scatter_rows_cuda", rows)
    lib = kernels.library("scatter")
    n_rows, n_cols = rows.shape
    if not 1 <= n_cols <= lib.scatter_max_cols():
        raise ValueError(f"{n_cols} columns: the kernel takes 1 to "
                         f"{lib.scatter_max_cols()}")
    if route is None:
        route = scatter_route(n_rows, n_cols, num)
    if route not in ROUTES:
        raise ValueError(f"route {route!r}: expected one of {ROUTES}")
    code = ROUTES.index(route)
    out = torch.empty((num, n_cols), dtype=rows.dtype, device=rows.device)
    scratch = torch.empty(lib.scatter_scratch_ints(n_rows, num, code),
                          dtype=torch.int32, device=rows.device)
    kernels.launch(
        "scatter", rows, ("scatter_launches", f"scatter_{route}_launches"),
        what=f"scatter ({route} route)", rows=rows,
        rows_f64=rows.dtype == torch.float64, idx=idx, n_rows=n_rows,
        n_cols=n_cols, n_out=num, route=code, out=out, scratch=scratch)
    word = _deferred_word
    if word is None:
        raise_if_out_of_bounds(scratch[-1].item(), num)
    elif word.device != rows.device:
        raise ValueError(f"the deferred bounds word is on {word.device}, "
                         f"rows on {rows.device}")
    else:
        word.bitwise_or_(scratch[-1:])
    return out


def _scatter(rows, idx, num: int):
    if idx.dtype == torch.int32:            # int32 face arrays: as indexing
        idx = idx.long()
    rows, idx = rows.contiguous(), idx.contiguous()
    fn = kernels.on_device(rows, scatter_rows_cuda, scatter_rows_plain)
    _check(rows, idx, num)
    return fn(rows, idx, num)


class _ScatterRows(torch.autograd.Function):
    """scatter_rows with the gather of the cotangent as its backward."""

    @staticmethod
    def forward(ctx, rows, idx, num):
        ctx.save_for_backward(idx)
        return _scatter(rows, idx, num)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return gather_rows(g, idx), None, None


class _GatherRows(torch.autograd.Function):
    """x[idx] with scatter_rows as its backward."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.num = x.shape[0]
        return x[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return scatter_rows(g, idx, ctx.num), None


def scatter_rows(rows, idx, num: int):
    """[num,C]: rows [R,C] summed at idx [R] (int64, or int32 widened),
    each destination's rows in ascending row order (the kernel on CUDA
    tensors, the plain version on CPU tensors). Differentiable in rows."""
    return _ScatterRows.apply(rows, idx, num)


def gather_rows(x, idx):
    """x[idx] for x [V,C] and idx [R] (int64), whose backward is
    `scatter_rows` of the cotangent into [V,C]."""
    return _GatherRows.apply(x, idx)
