"""Batched row gather and its scatter-add transpose: the CUDA kernels
(`csrc/gather_rows.cu`) and their plain PyTorch versions.

Port of the JAX package's `gather_rows` and `gather_rows_hybrid`
(`anystereo_tpu/ops/pallas/gather_kernel.py`), the query sampler of the
arbitrary-scale decoder: `out[b, q, :] = table[b, idx[b, q], :]`, with the
gradient `dtbl[b, p, :] = sum of g[b, q, :] over the q with idx[b, q] == p`.
The cotangent keeps its own dtype (bf16 in training), the sum is fp32, and
the cast to the table's dtype comes after the sum.  `idx` is int32 in
[0, N) and gets no gradient.  An index out of range raises on the CPU; on
the card it is the caller's contract (the kernels write zeros for it and
drop its gradient, as the TPU kernels do).
"""

from __future__ import annotations

import ctypes

import torch

_TABLE_DTYPES = (torch.float32, torch.bfloat16)


def _entry(name: str, argtypes):
    """A C entry point of `csrc/gather_rows.cu`, built on first use."""
    from anystereo_tpu_torch.ops.kernels.build import load_library

    fn = getattr(load_library("gather_rows"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_idx(idx: torch.Tensor, batch: int, device: torch.device):
    if idx.dim() != 2 or idx.shape[0] != batch:
        raise ValueError(f"expected idx [{batch}, Q], got {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.device != device:
        raise ValueError(f"idx on {idx.device}, the other operand on {device}")


def _kernel_device(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU tensor (plain
    version); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {t.device}")
    return True


# ------------------------------------------------------------------ forward


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: advanced indexing.  table [B, N, C], idx [B, Q] →
    [B, Q, C]."""
    b = torch.arange(table.shape[0], device=table.device)[:, None]
    return table[b, idx.long()]


def gather_unit(row_bytes: int, *ptrs: int) -> tuple:
    """(unit, lanes) of the gather kernel: the copy unit, the widest of 16, 4
    and 2 bytes that divides a row and every pointer's address, and the
    lanes of a warp that share one query row, one unit each (the kernel
    takes min(row_bytes / unit, 32) and loops over the rest): 23 lanes of
    16 bytes at 184 bf16 channels, 5 at 40, 9 lanes of 4 bytes at 9 fp32
    channels."""
    unit = next(u for u in (16, 4, 2) if row_bytes % u == 0 and all(p % u == 0 for p in ptrs))
    return unit, min(row_bytes // unit, 32)


def _gather_rows_forward(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if table.dim() != 3:
        raise ValueError(f"expected table [B, N, C], got {tuple(table.shape)}")
    if table.dtype not in _TABLE_DTYPES:
        raise TypeError(f"table must be float32 or bfloat16, got {table.dtype}")
    _check_idx(idx, table.shape[0], table.device)
    if not _kernel_device(table):
        return gather_rows_ref(table, idx)
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    batch, n, c = table.shape
    q = idx.shape[1]
    out = torch.empty((batch, q, c), dtype=table.dtype, device=table.device)
    row_bytes = c * table.element_size()
    unit, _ = gather_unit(row_bytes, table.data_ptr(), out.data_ptr())
    fn = _entry("anystereo_gather_rows",
                [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
                + [ctypes.c_void_p])
    with torch.cuda.device(table.device):
        err = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), batch, n, q, row_bytes, unit,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_rows kernel failed: CUDA error {err}")
    gather_rows.launches += 1
    return out


# ----------------------------------------------------------------- backward


def scatter_rows_add_ref(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version: fp32 `index_add_` per sample.  idx [B, Q], g [B, Q, C]
    → [B, n, C] fp32."""
    batch, _, c = g.shape
    dtbl = torch.zeros((batch, n, c), dtype=torch.float32, device=g.device)
    gf = g.float()
    for b in range(batch):
        dtbl[b].index_add_(0, idx[b].long(), gf[b])
    return dtbl


def scatter_vec(c: int, dtype: torch.dtype, ptr: int) -> int:
    """Channels one lane of the scatter kernel adds at once: the widest of 4,
    2 and 1 that divides the row and g's address.  A table row is then
    aligned to the vector too (the table is a fresh allocation), so 4 adds
    through one float4 atomic, 2 through a float2 one, 1 through a scalar
    one.  bf16 stops at 4 channels (an 8-byte load), not 8 (16 bytes): with 8
    a lane's two float4 atomics go 32 bytes apart and each atomic instruction
    of a warp covers half of every sector it touches, which measured 1.5x
    slower on the H100 (`PERF.md` §6)."""
    size = torch.empty((), dtype=dtype).element_size()
    return next(v for v in (4, 2, 1) if c % v == 0 and ptr % (v * size) == 0)


def scatter_rows_add(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """`dtbl[b, p, :] = sum of g[b, q, :] over q with idx[b, q] == p`, summed
    in fp32: idx [B, Q] int32, g [B, Q, C] fp32 or bf16 → [B, n, C] fp32.

    A CUDA tensor goes to the kernel (fp32 vector atomics, `scatter_vec`
    channels a lane, into a table this wrapper zero-fills, so the order of
    each row's sum changes from run to run), a CPU tensor to the plain
    version; any other device raises.
    Each kernel launch adds one to `scatter_rows_add.launches`."""
    if g.dim() != 3:
        raise ValueError(f"expected g [B, Q, C], got {tuple(g.shape)}")
    if g.dtype not in _TABLE_DTYPES:
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    _check_idx(idx, g.shape[0], g.device)
    if idx.shape[1] != g.shape[1]:
        raise ValueError(f"idx {tuple(idx.shape)} and g {tuple(g.shape)} disagree on Q")
    if not _kernel_device(g):
        return scatter_rows_add_ref(idx, g, n)
    if not (g.is_contiguous() and idx.is_contiguous()):
        raise ValueError("g and idx must be contiguous")
    batch, q, c = g.shape
    dtbl = torch.zeros((batch, n, c), dtype=torch.float32, device=g.device)
    fn = _entry("anystereo_scatter_rows_add",
                [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
                + [ctypes.c_void_p])
    with torch.cuda.device(g.device):
        err = fn(idx.data_ptr(), g.data_ptr(), dtbl.data_ptr(), batch, n, q, c,
                 int(g.dtype == torch.bfloat16), scatter_vec(c, g.dtype, g.data_ptr()),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"scatter_rows_add kernel failed: CUDA error {err}")
    scatter_rows_add.launches += 1
    return dtbl


scatter_rows_add.launches = 0


# ------------------------------------------------- the differentiable pair


def _table_grad(ctx, g):
    (idx,) = ctx.saved_tensors
    return scatter_rows_add(idx, g.contiguous(), ctx.rows).to(ctx.table_dtype), None


class _GatherRows(torch.autograd.Function):
    """Kernel forward, kernel backward."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows, ctx.table_dtype = table.shape[1], table.dtype
        return _gather_rows_forward(table, idx)

    backward = staticmethod(_table_grad)


class _GatherRowsHybrid(torch.autograd.Function):
    """Plain indexing forward, kernel backward."""

    @staticmethod
    def forward(ctx, table, idx):
        _check_idx(idx, table.shape[0], table.device)
        ctx.save_for_backward(idx)
        ctx.rows, ctx.table_dtype = table.shape[1], table.dtype
        return gather_rows_ref(table, idx)

    backward = staticmethod(_table_grad)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`out[b, q, :] = table[b, idx[b, q], :]`, an exact copy of rows: table
    [B, N, C] fp32 or bf16, idx [B, Q] int32 → [B, Q, C] in the table's
    dtype.  Differentiable in `table` through `scatter_rows_add`.

    A CUDA tensor goes to the kernels and a CPU tensor to their plain
    versions; any other device raises.  Each forward launch adds one to
    `gather_rows.launches`."""
    return _GatherRows.apply(table, idx)


gather_rows.launches = 0


def gather_rows_hybrid(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Same contract as `gather_rows`; the forward is plain indexing on
    every device and only the backward is the kernel."""
    return _GatherRowsHybrid.apply(table, idx)
