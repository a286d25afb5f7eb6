"""The row scatter-add of the train step and the vertex gather whose
backward it is (one hand-written CUDA kernel, csrc/scatter.cu).

`scatter_rows(rows, idx, num)` is out[num,C] = 0; out[idx[r]] += rows[r]:
the JAX package's `.at[idx].add(rows)` and `segment_sum`, and the transpose
of its vertex gathers. On CPU tensors it runs the plain version
`scatter_rows_plain` (`index_add_`, which on the CPU sums each
destination's rows in ascending row order, as JAX's CPU scatter does); on
CUDA tensors the kernel, which sums in that same order, each add rounded on
its own, so both give the same bits on every run. No fallback: a CUDA
tensor launches the kernel or raises.

`gather_rows(x, idx)` is x[idx] with `scatter_rows` as its backward, so the
step's vertex gathers no longer differentiate through advanced indexing
(IndexBackward0, a sort-based `index_put_` with accumulate on the card).
"""

from __future__ import annotations

import torch

from drt_tpu_torch import kernels

_ROW_DTYPES = (torch.float32, torch.float64)
_INT32_MAX = 2 ** 31 - 1


def scatter_rows_plain(rows, idx, num: int):
    """Plain version of csrc/scatter.cu: rows [R,C] summed into [num,C] at
    idx [R] (int64), each destination's rows in ascending row order on the
    CPU."""
    return rows.new_zeros((num, rows.shape[1])).index_add_(0, idx, rows)


def _check(rows, idx, num: int):
    dev = rows.device
    if rows.dim() != 2 or rows.dtype not in _ROW_DTYPES:
        raise ValueError(f"rows: expected [R,C] float32 or float64, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if (idx.dim() != 1 or idx.dtype != torch.int64
            or idx.shape[0] != rows.shape[0]):
        raise ValueError(f"idx: expected [{rows.shape[0]}] int64, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if idx.device != dev:
        raise ValueError(f"idx is on {idx.device}, rows on {dev}")
    if not (rows.is_contiguous() and idx.is_contiguous()):
        raise ValueError("rows and idx must be contiguous")
    if not 0 <= num <= _INT32_MAX or rows.shape[0] > _INT32_MAX // 2:
        raise ValueError(f"{rows.shape[0]} rows into {num}: beyond the "
                         "kernel's int32 sizes")


def scatter_rows_cuda(rows, idx, num: int):
    """Launch csrc/scatter.cu on the current stream: inputs and result as in
    `scatter_rows_plain`, contiguous on one CUDA device, 1 <= C <= 16. Rows
    whose every entry is +-0 are skipped (the same bits). An index outside
    [0, num) raises, as in the plain version: the kernel flags it and the
    wrapper reads the flag, which waits for the launch to finish."""
    _check(rows, idx, num)
    if rows.device.type != "cuda":
        raise ValueError("scatter_rows_cuda needs CUDA tensors")
    lib = kernels.load()
    n_cols = rows.shape[1]
    if not 1 <= n_cols <= lib.scatter_max_cols():
        raise ValueError(f"{n_cols} columns: the kernel takes 1 to "
                         f"{lib.scatter_max_cols()}")
    with torch.cuda.device(rows.device):
        out = torch.empty((num, n_cols), dtype=rows.dtype, device=rows.device)
        scratch = torch.empty(lib.scatter_scratch_ints(rows.shape[0]),
                              dtype=torch.int32, device=rows.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.scatter_launch(
            rows.data_ptr(), int(rows.dtype == torch.float64),
            idx.data_ptr(), rows.shape[0], n_cols, num, out.data_ptr(),
            scratch.data_ptr(), stream)
    kernels.check(lib, err, "scatter")
    kernels.counters.scatter_launches += 1
    if scratch[-1].item():
        raise RuntimeError(f"scatter_rows: an index is out of bounds for "
                           f"{num} destinations")
    return out


def _scatter(rows, idx, num: int):
    dev = rows.device.type
    if idx.dtype == torch.int32:            # int32 face arrays: as indexing
        idx = idx.long()
    rows, idx = rows.contiguous(), idx.contiguous()
    if dev == "cuda":
        return scatter_rows_cuda(rows, idx, num)
    if dev == "cpu":
        _check(rows, idx, num)
        return scatter_rows_plain(rows, idx, num)
    raise ValueError(f"scatter_rows: unsupported device {rows.device}")


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
