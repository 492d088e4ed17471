"""H-tiled spatial inference over a process group (the spatial half of the
JAX package's `parallel/`).

The JAX package places the images on a `spatial` mesh axis split along H
and lets GSPMD partition every convolution, normalisation and resize and
insert the halo exchanges.  PyTorch has no such partitioner, so the port
tiles explicitly: each rank of the group holds the full-resolution rows
`[r0, r1)` of the frame, and every op that couples rows reads the
*spatial context* set by the entry points below:

  * a convolution, transposed convolution or pool exchanges the rows its
    kernel needs along H with the neighbouring ranks (zeros past the
    frame's top and bottom, as the conv's own padding) and convolves with
    no H padding;
  * a normalisation computes its mean and variance over the whole image:
    per-rank fp32 sums, summed over the group (two passes: the mean, then
    the centred sum of squares);
  * a resize, a nearest gather or a coordinate grid works in global row
    indices and positions, shifted to the rank's own rows.

Outside the context every op computes exactly what it computes without
tiling.  Tile boundaries fall on multiples of 32 px, the coarsest stride
(the feature pyramid and the 3-D hourglass reach 1/32), so every strided
conv and pool sees the phase of the unsharded forward; tiles may be of
unequal height (1504 px = 47 x 32 px on two ranks: 768 and 736 rows).

Every rank takes every collective in the same order: each branch around a
collective is decided by global shapes, never by a rank's own.

Transport: over NCCL (one card a rank) the exchanges pass device tensors;
over gloo (the CPU, or ranks that share a card, which NCCL refuses) every
halo and every reduction goes through host buffers.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TILE = 32  # px: tile boundaries fall on multiples of the coarsest stride
# latent rows a nearest gather may read past its rank's rows (the 4-nearest
# and ensemble shifts, and a query's cell at a finer latent than the one that
# decides its owner, stay within one)
GATHER_HALO = 2


def row_partition(height: int, ranks: int) -> Tuple[int, ...]:
    """The full-resolution row boundaries `(0, r1, ..., height)` of `ranks`
    tiles: whole 32-px units, the first `units % ranks` tiles one unit
    taller.  Raises `ValueError` for a height that cannot be split so."""
    units, rest = divmod(height, TILE)
    if rest or units < ranks:
        raise ValueError(f"height {height} cannot be split into {ranks} tiles of whole {TILE}-px rows "
                         f"(it needs a multiple of {TILE} of at least {TILE * ranks}; pad the frame to {TILE})")
    base, extra = divmod(units, ranks)
    bounds = [0]
    for k in range(ranks):
        bounds.append(bounds[-1] + (base + (k < extra)) * TILE)
    return tuple(bounds)


class _Peers:
    """A rank's place in a process group and the transport to its
    neighbours."""

    def __init__(self, group: Optional[dist.ProcessGroup]):
        self.group = group if group is not None else dist.group.WORLD
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)
        self.peers = [dist.get_global_rank(self.group, k) for k in range(self.size)]
        self.gloo = dist.get_backend(self.group) == "gloo"
        self.stats = CollectiveStats()

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """`t` as the backend sends it: on the host under gloo."""
        return t.cpu() if self.gloo else t

    @contextlib.contextmanager
    def _timed(self, kind: str, device: torch.device):
        """Count one collective; time it on the host clock under gloo (after
        the card has finished the work queued before it, which the staging
        would wait for anyway) and with CUDA events under NCCL."""
        events = None
        if device.type == "cuda":
            if self.gloo:
                torch.cuda.synchronize(device)
            else:
                events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                events[0].record()
        t0 = time.perf_counter()
        yield
        self.stats.add(kind, time.perf_counter() - t0, events)

    def swap(self, x: torch.Tensor, lo: int, hi: int, dim: int) -> torch.Tensor:
        """`x` with `lo` rows of the previous rank before its rows along `dim`
        and `hi` rows of the next rank after them, zeros past the first and
        last ranks; a negative count drops that many of x's own rows (a
        neighbour still gets x's own edge rows)."""
        n = x.shape[dim]
        drop_lo, drop_hi = max(-lo, 0), max(-hi, 0)
        own = x.narrow(dim, drop_lo, n - drop_lo - drop_hi)
        lo, hi = max(lo, 0), max(hi, 0)
        if lo == 0 and hi == 0:
            return own
        k, last = self.rank, self.size - 1

        def rows(count, received):
            """The rows to receive (on the host under gloo), or zeros past the
            frame's edge."""
            shape = list(x.shape)
            shape[dim] = count
            return torch.zeros(shape, dtype=x.dtype, device="cpu" if received and self.gloo else x.device)

        with self._timed("exchange", x.device):
            top, bottom, ops = rows(lo, k > 0), rows(hi, k < last), []
            if lo:
                if k > 0:
                    ops.append(dist.P2POp(dist.irecv, top, self.peers[k - 1], self.group))
                if k < last:
                    ops.append(dist.P2POp(dist.isend, self._wire(x.narrow(dim, n - lo, lo).contiguous()),
                                          self.peers[k + 1], self.group))
            if hi:
                if k < last:
                    ops.append(dist.P2POp(dist.irecv, bottom, self.peers[k + 1], self.group))
                if k > 0:
                    ops.append(dist.P2POp(dist.isend, self._wire(x.narrow(dim, 0, hi).contiguous()),
                                          self.peers[k - 1], self.group))
            for work in dist.batch_isend_irecv(ops) if ops else ():
                work.wait()
            parts = [top.to(x.device)] if lo else []
            parts.append(own)
            if hi:
                parts.append(bottom.to(x.device))
            return torch.cat(parts, dim)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the group, in place."""
        with self._timed("reduction", t.device):
            wire = self._wire(t)
            dist.all_reduce(wire, group=self.group)
            if wire is not t:
                t.copy_(wire)
        return t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's `t` (all of one shape), in group order, on t's device."""
        with self._timed("gather", t.device):
            wire = self._wire(t.contiguous())
            out = [torch.empty_like(wire) for _ in range(self.size)]
            dist.all_gather(out, wire, group=self.group)
            return [o.to(t.device) for o in out]


class CollectiveStats:
    """The collectives a rank made, by kind, and their summed time: the host
    clock under gloo, CUDA events under NCCL (read by `summary`)."""

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self.host_s = 0.0
        self._events: list = []

    def add(self, kind, seconds, events):
        self.counts[kind] = self.counts.get(kind, 0) + 1
        if events is None:
            self.host_s += seconds
        else:
            events[1].record()
            self._events.append(events)

    def summary(self) -> Dict[str, float]:
        """{"exchange": n, "reduction": n, "gather": n, "collectives": n,
        "ms": summed time}; synchronises the card under NCCL."""
        if self._events:
            torch.cuda.synchronize()
        ms = self.host_s * 1e3 + sum(a.elapsed_time(b) for a, b in self._events)
        return {**self.counts, "collectives": sum(self.counts.values()), "ms": ms}


class SpatialContext:
    """The group, its row partition (full-resolution boundaries) and the
    frame's height: maps a level's local rows to the rank's global rows.  A
    level is named by its stride s (1/s resolution); the rank holds its rows
    `[r0 // s, r1 // s)` of `height // s`."""

    def __init__(self, group: Optional[dist.ProcessGroup], height: int):
        self.net = _Peers(group)
        self.height = height
        self.bounds = row_partition(height, self.net.size)
        self._matrices: Dict[tuple, Tuple[torch.Tensor, int, int]] = {}

    @property
    def stats(self) -> CollectiveStats:
        return self.net.stats

    def stride(self, rows: int) -> int:
        """The level stride of a tensor that holds `rows` of this rank's rows."""
        r0, r1 = self.bounds[self.net.rank], self.bounds[self.net.rank + 1]
        s, rest = divmod(r1 - r0, rows) if rows else (0, 1)
        if rest or s == 0 or self.height % s:
            raise ValueError(f"{rows} rows are no level of the tile [{r0}, {r1}) of {self.height}")
        return s

    def tiles(self, s: int) -> List[Tuple[int, int]]:
        """Every rank's global rows at the level of stride s."""
        return [(a // s, b // s) for a, b in zip(self.bounds[:-1], self.bounds[1:])]

    def span(self, rows: int) -> Tuple[int, int, int]:
        """(first row, end row, the level's global rows) of a tensor that
        holds `rows` of this rank's rows."""
        s = self.stride(rows)
        a0, a1 = self.tiles(s)[self.net.rank]
        return a0, a1, self.height // s

    def global_rows(self, rows: int) -> int:
        return self.span(rows)[2]

    def halo(self, x: torch.Tensor, lo: int, hi: int, dim: int) -> torch.Tensor:
        """`x`'s rows along `dim` with `lo` rows before and `hi` after (the
        neighbours' rows; zeros past the frame), or fewer where negative."""
        if lo <= 0 and hi <= 0:  # no rows to receive (a 1x1 kernel): no collective
            return self.net.swap(x, lo, hi, dim)
        s = self.stride(x.shape[dim])
        heights = [b - a for a, b in self.tiles(s)]
        if lo > min(heights[:-1], default=lo) or hi > min(heights[1:], default=hi):
            raise ValueError(f"a halo of {lo} + {hi} rows exceeds a neighbour's tile at 1/{s} "
                             f"(tile heights {heights})")
        return self.net.swap(x, lo, hi, dim)

    def take_rows(self, x: torch.Tensor, rows: torch.Tensor, dim: int, halo: int = GATHER_HALO
                  ) -> torch.Tensor:
        """x's rows at the global indices `rows` (within `halo` of this
        rank's rows, else `ValueError`)."""
        a0, _, _ = self.span(x.shape[dim])
        ext = self.halo(x, halo, halo, dim)
        return ext.index_select(dim, within(rows - (a0 - halo), ext.shape[dim]))

    def local_matrix(self, x: torch.Tensor, build: Callable[[int, int], torch.Tensor], out_rows: int,
                     dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """For the global resize matrix `build(in rows, out rows)` ([out, in],
        built once a context on the host) applied along x's rows `dim`: this
        rank's block of it, [out_rows, rows of the halo'd x], on x's device
        and dtype, and x with the halo the block reads (sized for the rank
        that reads the most)."""
        s_in, s_out = self.stride(x.shape[dim]), self.stride(out_rows)
        key = (build, s_in, s_out)
        if key not in self._matrices:
            matrix = build(self.height // s_in, self.height // s_out)
            lo = hi = 0
            for (b0, b1), (p0, p1) in zip(self.tiles(s_in), self.tiles(s_out)):
                cols = torch.nonzero(matrix[p0:p1].abs().sum(0))[:, 0]
                lo, hi = max(lo, b0 - int(cols[0])), max(hi, int(cols[-1]) + 1 - b1)
            self._matrices[key] = matrix, lo, hi
        matrix, lo, hi = self._matrices[key]
        ext = self.halo(x, lo, hi, dim)
        (a0, a1), (o0, o1) = self.tiles(s_in)[self.net.rank], self.tiles(s_out)[self.net.rank]
        first, n_in = a0 - lo, matrix.shape[1]
        block = torch.zeros(o1 - o0, ext.shape[dim], dtype=matrix.dtype)
        c0, c1 = max(first, 0), min(a1 + hi, n_in)
        block[:, c0 - first:c1 - first] = matrix[o0:o1, c0:c1]
        return block.to(device=x.device, dtype=x.dtype), ext

    def moments(self, x: torch.Tensor, dims: Sequence[int], rows_dim: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 mean and biased variance of `x` over `dims` (which hold the
        rows' dim `rows_dim`) over the whole image: per-rank sums over the
        group, the mean first, then the centred sum of squares."""
        xf = x.float()
        count = self._count(x, dims, rows_dim)
        mean = self.net.all_reduce_(xf.sum(dims, keepdim=True)) / count
        centred = xf - mean
        var = self.net.all_reduce_((centred * centred).sum(dims, keepdim=True)) / count
        return mean, var

    def mean(self, x: torch.Tensor, dims: Sequence[int], rows_dim: int) -> torch.Tensor:
        """The mean of `x` over `dims` over the whole image, in x's dtype."""
        count = self._count(x, dims, rows_dim)
        return (self.net.all_reduce_(x.float().sum(dims, keepdim=True)) / count).to(x.dtype)

    def _count(self, x: torch.Tensor, dims: Sequence[int], rows_dim: int) -> float:
        """The elements over `dims` of the whole image (the rows' dim counted
        at the frame's rows)."""
        count = self.global_rows(x.shape[rows_dim]) / x.shape[rows_dim]
        for d in dims:
            count *= x.shape[d]
        return count

    def gather_rows(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole image from every rank's rows of `x` along `dim`."""
        tiles = self.tiles(self.stride(x.shape[dim]))
        tallest = max(b - a for a, b in tiles)
        pad = list(x.shape)
        pad[dim] = tallest - x.shape[dim]
        parts = self.net.all_gather(torch.cat([x, x.new_zeros(pad)], dim))
        return torch.cat([p.narrow(dim, 0, b - a) for p, (a, b) in zip(parts, tiles)], dim)


def within(local: torch.Tensor, n: int) -> torch.Tensor:
    """`local`, row indices into a tile and its halo of `n` rows, checked to
    fall inside it: a stray index raises `ValueError` rather than read
    another row (one host read of the indices' range)."""
    if local.numel():
        first, last = torch.stack(torch.aminmax(local)).tolist()
        if first < 0 or last >= n:
            raise ValueError(f"row indices {first}..{last} fall outside the tile and its halo of {n} rows")
    return local


_CURRENT: contextvars.ContextVar = contextvars.ContextVar("spatial_context", default=None)


def current() -> Optional[SpatialContext]:
    """The spatial context the ops read, or None outside the entry points."""
    return _CURRENT.get()


def frame_rows(rows: int) -> int:
    """The rows of the frame's map at the level of a tensor with `rows` rows:
    `rows` itself outside a spatial context."""
    ctx = current()
    return rows if ctx is None else ctx.global_rows(rows)


@contextlib.contextmanager
def spatial_context(group: Optional[dist.ProcessGroup], height: int) -> Iterator[SpatialContext]:
    """Within `with`, the ops run on this rank's rows (`row_partition`) of
    a frame of `height` rows tiled over `group`."""
    token = _CURRENT.set(SpatialContext(group, height))
    try:
        yield _CURRENT.get()
    finally:
        _CURRENT.reset(token)


def halo_exchange(x: torch.Tensor, halo: int, group: Optional[dist.ProcessGroup] = None,
                  axis: int = 1) -> torch.Tensor:
    """Pad a rank's block `x` with `halo` rows of each neighbour along
    `axis`, the edge row repeated at the group's first and last ranks
    (`F.pad` mode 'replicate'); [..., H_local + 2*halo, ...]."""
    peers = _Peers(group)
    out = peers.swap(x, halo, halo, axis)
    n = x.shape[axis]
    if peers.rank == 0:
        out.narrow(axis, 0, halo).copy_(x.narrow(axis, 0, 1).expand_as(out.narrow(axis, 0, halo)))
    if peers.rank == peers.size - 1:
        out.narrow(axis, n + halo, halo).copy_(x.narrow(axis, n - 1, 1).expand_as(out.narrow(axis, 0, halo)))
    return out


def gather_batch(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Every rank's `x` (one shape), concatenated along the batch in group
    order (through the host under gloo)."""
    return torch.cat(_Peers(group).all_gather(x), 0)


def _query_tiles(ctx: SpatialContext, coords: torch.Tensor, latent: int):
    """For each rank, its queries: ([B, Qk] positions in the caller's order,
    [B, Qk] mask of the real ones).  A query belongs to the rank that owns
    the latent row (at 1/`latent`) the decoder's nearest-index rule puts it
    in; Qk is the rank's most queries of a sample (at least one: a rank
    with none decodes one stand-in query)."""
    # imported here: ops/sampling imports this module
    from anystereo_tpu_torch.ops.sampling import _nearest_indices

    h = ctx.height // latent
    iy = _nearest_indices(coords[..., 0].clamp(-1.0 + 1e-6, 1.0 - 1e-6), h)
    inner = torch.tensor([a for a, _ in ctx.tiles(latent)[1:]], device=coords.device)
    owner = torch.bucketize(iy, inner, right=True)
    out = []
    for k in range(ctx.net.size):
        mine = owner == k
        qk = max(int(mine.sum(1).max()), 1)
        order = torch.argsort((~mine).to(torch.int8), dim=1, stable=True)[:, :qk]
        out.append((order, mine.gather(1, order)))
    return out


def infer_spatial_sharded(model, params_or_state, left: torch.Tensor, right: torch.Tensor,
                          coords: Optional[torch.Tensor], scale, group: Optional[dist.ProcessGroup] = None,
                          iters: int = 32, stats: Optional[dict] = None) -> torch.Tensor:
    """The eval forward of `model` with H tiled over `group`.

    Every rank passes the whole frame (`left`, `right` [B, H, W, 3]), as
    the JAX function takes global arrays, runs the forward on its own rows
    and returns the whole result: the disparity at `coords` [B, Q, 2] in
    the caller's order ([B, Q]), or, with `coords` None, the dense decode of
    the frame's own pixel centres ([B, H, W]).  A query is decoded by the
    rank that owns its latent row.  `params_or_state`: a state_dict loaded
    into `model` first (parameters and buffers), or None for its own
    weights.  `stats`: a dict that receives this rank's collectives
    (`CollectiveStats.summary`).  The result is the unsharded forward's
    within reduction-order noise."""
    if params_or_state is not None:
        model.load_state_dict(params_or_state, strict=True)
    b, h = left.shape[0], left.shape[1]
    with spatial_context(group, h) as ctx:
        r0, r1 = ctx.bounds[ctx.net.rank], ctx.bounds[ctx.net.rank + 1]
        tile_l, tile_r = left[:, r0:r1], right[:, r0:r1]
        if coords is None:
            out = model(tile_l, tile_r, iters=iters, scale=scale, mode="eval").disp_final
            result = ctx.gather_rows(out, dim=1)
        else:
            latent = 2 ** model.cfg.n_downsample
            tiles = _query_tiles(ctx, coords, latent)
            order, real = tiles[ctx.net.rank]
            a0, _ = ctx.tiles(latent)[ctx.net.rank]
            stand_in = coords.new_tensor([-1.0 + (2 * a0 + 1) / (h // latent), 0.0])
            mine = torch.where(real[..., None], coords.gather(1, order[..., None].expand(-1, -1, 2)), stand_in)
            out = model(tile_l, tile_r, iters=iters, coords=mine, scale=scale, mode="eval").disp_final
            width = max(o.shape[1] for o, _ in tiles)
            parts = ctx.net.all_gather(torch.cat([out, out.new_zeros(b, width - out.shape[1])], 1))
            q = coords.shape[1]
            result = out.new_zeros(b, q + 1)
            for part, (order_k, real_k) in zip(parts, tiles):
                dest = torch.where(real_k, order_k, q)
                result.scatter_(1, dest, part[:, :dest.shape[1]])
            result = result[:, :q]
        if stats is not None:
            stats.update(ctx.stats.summary())
    return result
