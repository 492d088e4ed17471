// Batched row gather and its scatter-add transpose for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package's
// anystereo_tpu/ops/pallas/gather_kernel.py: `_gather_fwd_kernel` (the
// forward of `gather_rows`) and `_gather_bwd_kernel` (the backward of
// `gather_rows` and of `gather_rows_hybrid`).
//
//   forward   out[b, q, :]  = table[b, idx[b, q], :]            (exact copy)
//   backward  dtbl[b, p, :] = sum over q with idx[b, q] == p of g[b, q, :]
//
// The TPU kernels build one-hot tiles and contract them on the matrix unit,
// Q*N*C multiply-adds for Q*C useful values, because a TPU has no fast
// scattered access to its memory.  The card has: the forward is a copy with
// computed source addresses, the backward an fp32 `atomicAdd` per element.
//
// What bounds them: bytes.  Forward: the table (at most 5 MB) stays in L2,
// where each row is read about Q/N = 4 to 16 times, so the least traffic is
// the indices and the table read once and the output written once (most of
// it: 37.7 MB at 184 bf16 channels).  A query row is owned by a
// group of lanes sized to the row: lane i copies the i-th unit of 16, 4 or 2
// bytes, the widest that divides a row's bytes and the pointers' alignment
// (the wrapper chooses; 23 lanes of 16 bytes at 184 bf16 channels, 5 at 40,
// 9 lanes of 4 bytes at 9 fp32 channels), with several queries side by side
// in a warp for narrow rows, so that reads of a row and writes of the output
// coalesce.  Each group reads the indices of 4 queries (one load a query,
// its lanes on one address), then loads their table rows, then stores them,
// so that many loads are in flight; index arithmetic is 32-bit, with the
// sample as the grid's y.  The index loads and the output's stores are
// streaming (evict first): though the decoder reads the output right
// after, measured inside the training step (`chip_smoke.py --profile`,
// against the same source with plain stores) they take 5% off the kernel's
// summed time (`PERF.md` §6); the table's loads carry no hint.
//
// Backward: g is read once (it is most of the bytes: 37.7 MB of bf16 at
// 2 x 51,200 queries of 184 channels) and the table, zeroed by the wrapper,
// takes one atomic add per value of g.  On the H100 the atomics are the
// limit, so the design cuts their number and keeps them dense.  A lane owns
// `vec` consecutive channels of a query row (the wrapper picks the widest
// of 4, 2, 1 that divides the row and the pointers' alignment), reads them
// as one 8- or 16-byte load, widens bf16 to fp32 and adds them with one of
// Hopper's vector atomics (`atomicAdd` on float4 / float2 in global
// memory): 4x fewer atomic operations than one a value where a table row is
// 16 bytes aligned (C = 40 and 184), and each atomic instruction of a warp
// covers whole, neighbouring sectors (8 bf16 channels a lane, two float4
// adds 32 bytes apart, measured 1.5x slower); the 36-byte rows of C = 9 take
// scalar atomics.  A query row is owned by C / vec lanes of one warp (lane
// groups sized to the row, several queries to a warp for narrow rows); each
// group reads the indices of 4 queries and loads their rows of g before it
// adds any (many loads in flight), with 32-bit index arithmetic in a
// grid-stride loop, and the sample as the grid's y.  g and the indices are
// streaming loads (evict first).  With about Q/N = 4 to 16 queries on a
// table row the contention is mild, and the tables (at most 5 MB) stay in
// L2.  The sum is fp32 whatever g's type; the order of the atomic adds
// changes from run to run, so the result is reproducible only up to fp32
// rounding of each row's sum.  One launch a call, beside the wrapper's
// zero-fill: no sort, histogram or scan pass, whose extra launches would
// cost the launch-bound training step more host time than they save on the
// card.
//
// Where the caller asks PyTorch for deterministic algorithms,
// `scatter_rows_ordered` runs instead: no atomics, and each table row sums
// its queries in ascending q in fp32 from zero, so a run repeats bit for
// bit: the order of `index_add_` on the CPU, and of PyTorch's deterministic
// `index_add_` on the card for rows wider than one channel.  One launch, no
// sort: a block owns up to 128 consecutive table rows of a sample and
// finds their queries itself, a stable counting sort in shared memory (its
// comment below).  What bounds it: g read once from device memory, and
// each block's pass over all its sample's indices (200 KB at Q = 51,200)
// from L2, so the grid holds about two blocks an SM and no more.
//
// An index outside [0, N) is the caller's fault; the kernels do not fault on
// it: the forward writes zeros for that query and the backward drops it, as
// the TPU kernels' one-hot compare does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

constexpr int kQueriesInFlight = 4;  // query rows a lane group loads before it stores (adds)

// The lane groups of both kernels: a query row of `units` units is owned by
// `lanes` = min(units, 32) lanes of a warp, which takes per_warp = 32 / lanes
// rows side by side, and a chunk of per_warp * kQueriesInFlight consecutive
// queries at a time.
struct LaneGroup {
  int lanes, per_warp, slot, unit;
  bool active;
  __device__ __forceinline__ explicit LaneGroup(int units) {
    lanes = units < 32 ? units : 32;
    per_warp = 32 / lanes;
    const int lane = threadIdx.x & 31;
    slot = lane / lanes;
    unit = lane - slot * lanes;
    active = slot < per_warp;
  }
};

// table [B, n, upr] units, idx [B, q], out [B, q, upr] units; upr = units
// per row; blockIdx.y is the sample.  Out-of-range indices give zero rows.
template <typename Unit>
__global__ void __launch_bounds__(kThreads)
gather_rows_fwd(const Unit* __restrict__ table, const int32_t* __restrict__ idx,
                Unit* __restrict__ out, int q, int n, int upr) {
  constexpr int UNR = kQueriesInFlight;
  const LaneGroup lg(upr);
  const int chunk = lg.per_warp * UNR;
  const int b = blockIdx.y;
  const int32_t* ib = idx + (int64_t)b * q;
  const Unit* tb = table + (int64_t)b * n * upr;
  Unit* ob = out + (int64_t)b * q * upr;
  const int64_t warp = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int64_t warps = gridDim.x * (kThreads / 32);
  for (int64_t q0 = warp * chunk; q0 < q; q0 += warps * chunk) {
    int qs[UNR], p[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      qs[u] = (int)q0 + u * lg.per_warp + lg.slot;
      const int32_t pv = (lg.active && qs[u] < q) ? __ldcs(ib + qs[u]) : -1;
      p[u] = (pv >= 0 && pv < n) ? pv : -1;
    }
    for (int k = lg.unit; lg.active && k < upr; k += lg.lanes) {
      Unit v[UNR];
#pragma unroll
      for (int u = 0; u < UNR; ++u) v[u] = p[u] >= 0 ? tb[p[u] * upr + k] : Unit();
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        if (qs[u] < q) __stcs(ob + qs[u] * upr + k, v[u]);
      }
    }
  }
}

// bf16 pair -> two fp32, exactly (the bits go to the high half)
__device__ __forceinline__ void widen(unsigned w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

// VEC consecutive values of g at p (aligned to their size) as fp32.  g is
// read once: streaming loads (evict first), so that its lines make room for
// each other rather than push the table (or dirty lines of other kernels)
// out of L2.
template <int VEC>
__device__ __forceinline__ void load_g(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldcs(reinterpret_cast<const float2*>(p));
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = __ldcs(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_g(const __nv_bfloat16* p, float* v) {
  if constexpr (VEC == 4) {
    const uint2 t = __ldcs(reinterpret_cast<const uint2*>(p));
    widen(t.x, v), widen(t.y, v + 2);
  } else if constexpr (VEC == 2) {
    widen(__ldcs(reinterpret_cast<const unsigned*>(p)), v);
  } else {
    v[0] = __bfloat162float(__ldcs(reinterpret_cast<const __nv_bfloat16*>(p)));
  }
}

// dtbl[p : p + VEC] += v, as vector atomics where VEC allows
template <int VEC>
__device__ __forceinline__ void add_vec(float* p, const float* v) {
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (VEC == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// idx [B, q], g [B, q, c], dtbl [B, n, c] fp32 (zeroed); c % VEC == 0.  A
// query row of c / VEC units is owned by a `LaneGroup`; blockIdx.y is the
// sample.  Each lane group loads the indices of its kQueriesInFlight queries
// (one request a row, its lanes reading one address) and then their rows of
// g before it adds any, so that many loads are in flight where one query's
// loads and adds would wait on each other.
template <typename GT, int VEC>
__global__ void __launch_bounds__(kThreads)
scatter_rows_add(const int32_t* __restrict__ idx, const GT* __restrict__ g,
                 float* __restrict__ dtbl, int q, int n, int c) {
  constexpr int UNR = kQueriesInFlight;
  const LaneGroup lg(c / VEC);
  const int lanes = lg.lanes, per_warp = lg.per_warp, slot = lg.slot, unit = lg.unit;
  const bool active = lg.active;
  const int chunk = per_warp * UNR;
  const int b = blockIdx.y;
  const int32_t* ib = idx + (int64_t)b * q;
  const GT* gb = g + (int64_t)b * q * c;
  float* tb = dtbl + (int64_t)b * n * c;
  const int warp = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int warps = gridDim.x * (kThreads / 32);
  for (int q0 = warp * chunk; q0 < q; q0 += warps * chunk) {
    int p[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int qu = q0 + u * per_warp + slot;
      const int32_t pv = (active && qu < q) ? __ldcs(ib + qu) : -1;
      p[u] = (pv >= 0 && pv < n) ? pv : -1;
    }
    for (int ch = unit * VEC; active && ch < c; ch += lanes * VEC) {
      float v[UNR][VEC];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        if (p[u] >= 0) load_g<VEC>(gb + (int64_t)(q0 + u * per_warp + slot) * c + ch, v[u]);
      }
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        if (p[u] >= 0) add_vec<VEC>(tb + (int64_t)p[u] * c + ch, v[u]);
      }
    }
  }
}

// The backward in PyTorch's deterministic mode.  A block owns the table
// rows [p0, p0 + rows) of one sample (rows <= kOrderedRowsMax; the grid's x
// is the row blocks and its y the sample) and sums each row's queries in
// ascending q in fp32 from zero; it writes every element of its rows, so
// the table needs no zero-fill.  It finds its rows' queries itself, by a
// stable counting sort of the sample's indices in shared memory:
//   1. count: the queries are cut into kOrderedWarps contiguous segments,
//      one a warp.  A warp streams its segment, 16 bytes of indices a lane
//      and kQuadsInFlight loads in flight; it counts the queries of each of
//      the block's rows into cnt[row][segment] (shared atomics: integer
//      counts have no order) and stages them, (q, row) in ascending q, in
//      its own kStageCap slots;
//   2. scan: an exclusive scan over (row, then segment) gives each segment
//      its first slot in each row's list, and begin[row] each list's start;
//   3. place: each warp places its staged queries, 32 at a time; a query's
//      slot is its segment's next slot in its row plus its rank among the
//      lanes with the same row (`__match_any_sync`), so that each list holds
//      its row's queries in ascending q.  A segment that found more than
//      kStageCap queries streams its indices again past the last one staged
//      and places the rest one lane after another;
//   4. sum: a `LaneGroup` takes a row at a time and walks its list,
//      loading kSumInFlight queries' rows of g (`vec` channels a lane,
//      evict first) before it adds any, and stores the row.
// The lists hold kListCap queries.  Where the block's rows receive more,
// the block takes q in windows of kListCap queries (a window cannot
// overflow), counting, placing and summing each in turn; a row's partial
// sum is carried from window to window in its own elements of the table,
// which only this block writes, so the adds are the same sequence and give
// the same bits.  Indices outside [0, n) fall in no block's rows.
constexpr int kOrderedThreads = 512;
constexpr int kOrderedWarps = kOrderedThreads / 32;
constexpr int kOrderedRowsMin = 8, kOrderedRowsMax = 128;
constexpr int kOrderedBlocks = 264;  // two blocks on each of the H100's 132 SMs
constexpr int kListCap = 4096;       // queries a block places at once
constexpr int kStageCap = 256;       // queries a warp stages in its count
constexpr int kQuadsInFlight = 4;    // 16-byte loads of indices a lane has in flight
constexpr int kSumInFlight = 8;      // query rows of g a lane group loads before it adds them

struct OrderedShared {
  int cnt[kOrderedRowsMax * kOrderedWarps];  // [row][segment]: the count, then the next slot
  int begin[kOrderedRowsMax + 1];            // each row's first slot, then the total
  int warp_sum[kOrderedWarps];
  unsigned stage_q[kOrderedWarps][kStageCap];        // [segment]: its first queries in the rows,
  unsigned char stage_row[kOrderedWarps][kStageCap];  // ascending, and their rows
  unsigned list[kListCap];                           // the queries, row after row
};

// Segment `seg` of the queries [qa, qb), from query `from` on (qa <= from),
// in ascending q.  Each segment is a multiple of 32 indices from the
// 16-byte word that holds query qa (the first may start before qa, the last
// end early): lane l reads the word w = w0 + 32u + l (4 indices) for
// u < kQuadsInFlight at once (one scalar load an index where the word is
// not wholly inside the range), then visit(row, hits, j0) runs for each u
// in turn: row[k] the index of query j0 + k less p0, and bit k of `hits`
// set where it lies in [0, rows) (and the query in the range).  Every lane
// of the warp makes the same calls, so `visit` may use the whole warp.
template <typename Visit>
__device__ __forceinline__ void walk_quads(const int32_t* __restrict__ ib, unsigned qa, unsigned qb,
                                           unsigned from, int seg, int p0, int rows, Visit visit) {
  const unsigned lane = threadIdx.x & 31;
  // a = q + off counts indices from the 16-byte word that holds ib[0]
  const unsigned off = (unsigned)(reinterpret_cast<uintptr_t>(ib) >> 2) & 3;
  const int4* words = reinterpret_cast<const int4*>(ib - off);
  const unsigned lo = (qa + off) & ~3u, hi = qb + off, len = hi - lo;
  const unsigned per = (len / kOrderedWarps + (len % kOrderedWarps != 0) + 31) & ~31u;
  const unsigned long long s0 = lo + (unsigned long long)seg * per;
  const unsigned s = s0 < hi ? (unsigned)s0 : hi, e = hi - s > per ? s + per : hi;
  const unsigned start = max(s, (from + off) & ~3u);
  for (unsigned a0 = start; a0 < e; a0 += 128 * kQuadsInFlight) {
    int4 t[kQuadsInFlight];
    bool whole[kQuadsInFlight];
#pragma unroll
    for (int u = 0; u < kQuadsInFlight; ++u) {
      const unsigned a = a0 + 128 * u + 4 * lane;
      whole[u] = a >= from + off && a + 4 <= e;
      t[u] = whole[u] ? __ldg(words + (a >> 2)) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kQuadsInFlight; ++u) {
      const unsigned a = a0 + 128 * u + 4 * lane;
      unsigned row[4] = {(unsigned)t[u].x, (unsigned)t[u].y, (unsigned)t[u].z, (unsigned)t[u].w};
      unsigned hits = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!whole[u]) {
          const bool in = a + k >= from + off && a + k < e;
          row[k] = in ? (unsigned)__ldg(ib + (a + k - off)) : (unsigned)p0 - 1;
        }
        row[k] -= (unsigned)p0;
        hits |= (unsigned)(row[k] < (unsigned)rows) << k;
      }
      visit(row, hits, (long long)a - off);
    }
  }
}

// Step 1 for the queries [qa, qb) by this warp's segment, then step 2:
// sh.cnt and sh.begin, the total in sh.begin[rows], and the segment's
// staged queries; returns how many queries the segment found (the first
// kStageCap of them staged).  Ends with a barrier.
__device__ __forceinline__ int count_rows(OrderedShared& sh, const int32_t* __restrict__ ib, unsigned qa,
                                          unsigned qb, int p0, int rows) {
  const int warp = threadIdx.x >> 5, seg = warp, lane = threadIdx.x & 31;
  const unsigned lower_lanes = (1u << lane) - 1;
  const int cells = rows * kOrderedWarps;
  for (int i = threadIdx.x; i < cells; i += kOrderedThreads) sh.cnt[i] = 0;
  __syncthreads();
  int found = 0;  // the same in every lane of the warp
  walk_quads(ib, qa, qb, qa, seg, p0, rows, [&](const unsigned (&row)[4], unsigned hits, long long j0) {
    // the lanes' counts of queries in the rows (at most 4: three bits)
    const int count = __popc(hits);
    const unsigned c1 = __ballot_sync(0xffffffffu, count & 1), c2 = __ballot_sync(0xffffffffu, count & 2),
                   c4 = __ballot_sync(0xffffffffu, count & 4);
    if (hits) {
      int slot = found + __popc(c1 & lower_lanes) + 2 * __popc(c2 & lower_lanes) + 4 * __popc(c4 & lower_lanes);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (hits >> k & 1) {
          atomicAdd(&sh.cnt[row[k] * kOrderedWarps + seg], 1);
          if (slot < kStageCap) {
            sh.stage_q[seg][slot] = (unsigned)(j0 + k);
            sh.stage_row[seg][slot] = (unsigned char)row[k];
          }
          ++slot;
        }
      }
    }
    found += __popc(c1) + 2 * __popc(c2) + 4 * __popc(c4);
  });
  __syncthreads();
  // exclusive scan over (row, segment): thread t owns `per` consecutive cells
  const int per = (cells + kOrderedThreads - 1) / kOrderedThreads;
  const int i0 = min(cells, (int)threadIdx.x * per), i1 = min(cells, i0 + per);
  int own = 0;
  for (int i = i0; i < i1; ++i) own += sh.cnt[i];
  int incl = own;
  for (int d = 1; d < 32; d *= 2) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) sh.warp_sum[warp] = incl;
  __syncthreads();
  int next = incl - own;
  for (int v = 0; v < warp; ++v) next += sh.warp_sum[v];
  for (int i = i0; i < i1; ++i) {
    const int here = sh.cnt[i];
    if (i % kOrderedWarps == 0) sh.begin[i / kOrderedWarps] = next;
    sh.cnt[i] = next;
    next += here;
  }
  if (threadIdx.x == kOrderedThreads - 1) sh.begin[rows] = next;  // every cell lies before its range
  __syncthreads();
  return found;
}

// Step 3 for this warp's segment of the queries [qa, qb), after
// count_rows found `found` queries there.
__device__ __forceinline__ void place_rows(OrderedShared& sh, const int32_t* __restrict__ ib, unsigned qa,
                                           unsigned qb, int found, int p0, int rows) {
  const int seg = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lower_lanes = (1u << lane) - 1;
  const int staged = min(found, kStageCap);
  for (int i0 = 0; i0 < staged; i0 += 32) {
    const int i = i0 + lane;
    const int row = i < staged ? sh.stage_row[seg][i] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, row);
    int* next = &sh.cnt[max(row, 0) * kOrderedWarps + seg];
    if (row >= 0) sh.list[*next + __popc(peers & lower_lanes)] = sh.stage_q[seg][i];
    __syncwarp();
    if (row >= 0 && (peers & lower_lanes) == 0) *next += __popc(peers);
    __syncwarp();
  }
  if (found > kStageCap) {  // the rest of the segment, past the last query staged
    walk_quads(ib, qa, qb, sh.stage_q[seg][kStageCap - 1] + 1, seg, p0, rows,
               [&](const unsigned (&row)[4], unsigned hits, long long j0) {
      // the lanes with queries in the rows, in ascending q
      for (unsigned lanes = __ballot_sync(0xffffffffu, hits != 0); lanes; lanes &= lanes - 1) {
        if (lane == __ffs(lanes) - 1) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (hits >> k & 1) sh.list[sh.cnt[row[k] * kOrderedWarps + seg]++] = (unsigned)(j0 + k);
          }
        }
        __syncwarp();
      }
    });
  }
}

// idx [B, q], g [B, q, c], dtbl [B, n, c] fp32 (every element written);
// c % VEC == 0; blockIdx.x * rows_per_block is the block's first row.
template <typename GT, int VEC>
__global__ void __launch_bounds__(kOrderedThreads, 2)
scatter_rows_ordered(const int32_t* __restrict__ idx, const GT* __restrict__ g,
                     float* __restrict__ dtbl, int q, int n, int c, int rows_per_block) {
  __shared__ OrderedShared sh;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * rows_per_block, rows = min(rows_per_block, n - p0);
  const int32_t* ib = idx + (int64_t)b * q;
  const GT* gb = g + (int64_t)b * q * c;
  float* tb = dtbl + ((int64_t)b * n + p0) * c;
  const LaneGroup lg(c / VEC);
  const int groups = kOrderedWarps * lg.per_warp, group = warp * lg.per_warp + lg.slot;

  int found = count_rows(sh, ib, 0, q, p0, rows);
  // one window of all the queries where the lists hold them, else windows of kListCap
  const unsigned window = sh.begin[rows] <= kListCap ? (unsigned)q : (unsigned)kListCap;
  unsigned qa = 0;
  do {
    const unsigned qb = q - qa > window ? qa + window : q;
    if (window != (unsigned)q) found = count_rows(sh, ib, qa, qb, p0, rows);
    place_rows(sh, ib, qa, qb, found, p0, rows);
    __syncthreads();
    for (int r = group; lg.active && r < rows; r += groups) {
      const int j0 = sh.begin[r], j1 = sh.begin[r + 1];
      for (int ch = lg.unit * VEC; ch < c; ch += lg.lanes * VEC) {
        float* dst = tb + (int64_t)r * c + ch;
        float acc[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = qa == 0 ? 0.0f : dst[e];  // the earlier windows' sum
        for (int j = j0; j < j1; j += kSumInFlight) {
          float v[kSumInFlight][VEC];
#pragma unroll
          for (int u = 0; u < kSumInFlight; ++u) {
            if (j + u < j1) load_g<VEC>(gb + (int64_t)sh.list[j + u] * c + ch, v[u]);
          }
#pragma unroll
          for (int u = 0; u < kSumInFlight; ++u) {
            if (j + u < j1) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], v[u][e]);
            }
          }
        }
        if constexpr (VEC == 4) {
          *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
        } else if constexpr (VEC == 2) {
          *reinterpret_cast<float2*>(dst) = make_float2(acc[0], acc[1]);
        } else {
          *dst = acc[0];
        }
      }
    }
    qa = qb;
    __syncthreads();  // every list is summed before the next window's count
  } while (qa < (unsigned)q);
}

// The grid of both kernels: enough blocks for every chunk of queries, at
// most 8192 (the kernels loop), times the batch
dim3 grid_for(int64_t batch, int64_t q, int units) {
  const int lanes = units < 32 ? units : 32;
  const int64_t per_block = (int64_t)(kThreads / 32) * (32 / lanes) * kQueriesInFlight;
  const int64_t need = (q + per_block - 1) / per_block;
  return dim3((unsigned)(need < 8192 ? need : 8192), (unsigned)batch);
}

template <typename Unit>
void launch_gather(const void* table, const int32_t* idx, void* out, int64_t batch, int n,
                   int q, int upr, cudaStream_t s) {
  gather_rows_fwd<Unit><<<grid_for(batch, q, upr), kThreads, 0, s>>>(
      (const Unit*)table, idx, (Unit*)out, q, n, upr);
}

template <typename GT, int VEC>
void launch_scatter(const int32_t* idx, const GT* g, float* dtbl, int batch, int n,
                    int q, int c, cudaStream_t s) {
  scatter_rows_add<GT, VEC><<<grid_for(batch, q, c / VEC), kThreads, 0, s>>>(idx, g, dtbl, q, n, c);
}

// The deterministic backward's rows a block: the fewest that give at most
// kOrderedBlocks blocks in all (each block reads all its sample's indices,
// so fewer, wider blocks read less; as many blocks on each SM, so that no
// SM sums more rows than another), within [kOrderedRowsMin,
// kOrderedRowsMax]; and its grid
int ordered_rows(int64_t batch, int64_t n) {
  const int64_t per_sample = batch < kOrderedBlocks ? kOrderedBlocks / batch : 1;
  const int64_t rows = (n + per_sample - 1) / per_sample;
  return (int)(rows < kOrderedRowsMin ? kOrderedRowsMin : rows > kOrderedRowsMax ? kOrderedRowsMax : rows);
}

template <typename GT, int VEC>
void launch_ordered(const int32_t* idx, const GT* g, float* dtbl, int batch, int n, int q, int c,
                    cudaStream_t s) {
  const int rows = ordered_rows(batch, n);
  const dim3 grid((unsigned)((n + rows - 1) / rows), (unsigned)batch);
  scatter_rows_ordered<GT, VEC><<<grid, kOrderedThreads, 0, s>>>(idx, g, dtbl, q, n, c, rows);
}

}  // namespace

// table [batch, n, row_bytes], idx [batch, q] int32, out [batch, q,
// row_bytes]; `unit` is 16, 4 or 2 and divides row_bytes, and both pointers
// are aligned to it.  Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for another unit, a batch beyond the grid's y or
// n or q units beyond 32 bits.
extern "C" int anystereo_gather_rows(const void* table, const void* idx, void* out,
                                     long long batch, long long n, long long q,
                                     int row_bytes, int unit, void* stream) {
  if (unit != 16 && unit != 4 && unit != 2) return (int)cudaErrorInvalidValue;
  if (row_bytes % unit != 0) return (int)cudaErrorInvalidValue;
  const long long upr = row_bytes / unit;
  if (batch > 65535 || n * upr > INT32_MAX || q * upr > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || q == 0 || upr == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* ix = (const int32_t*)idx;
  if (unit == 16) {
    launch_gather<uint4>(table, ix, out, batch, (int)n, (int)q, (int)upr, s);
  } else if (unit == 4) {
    launch_gather<uint32_t>(table, ix, out, batch, (int)n, (int)q, (int)upr, s);
  } else {
    launch_gather<uint16_t>(table, ix, out, batch, (int)n, (int)q, (int)upr, s);
  }
  return (int)cudaGetLastError();
}

// idx [batch, q] int32, g [batch, q, c] fp32 (g_bf16 == 0) or bf16, dtbl
// [batch, n, c] fp32, zeroed by the caller; `vec` channels a lane (4, 2 or 1)
// divides c, and g is aligned to vec values.  Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for another vec, a batch
// beyond the grid's y or q, n or q * c beyond 32 bits.
extern "C" int anystereo_scatter_rows_add(const void* idx, const void* g, void* dtbl,
                                          long long batch, long long n, long long q,
                                          int c, int g_bf16, int vec, void* stream) {
  if (batch > 65535 || n > INT32_MAX || q > INT32_MAX || q * c > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if ((vec != 4 && vec != 2 && vec != 1) || c % vec != 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || q == 0 || c == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* ix = (const int32_t*)idx;
  float* d = (float*)dtbl;
  if (g_bf16) {
    const __nv_bfloat16* gg = (const __nv_bfloat16*)g;
    switch (vec) {
      case 4: launch_scatter<__nv_bfloat16, 4>(ix, gg, d, batch, n, q, c, s); break;
      case 2: launch_scatter<__nv_bfloat16, 2>(ix, gg, d, batch, n, q, c, s); break;
      default: launch_scatter<__nv_bfloat16, 1>(ix, gg, d, batch, n, q, c, s);
    }
  } else {
    const float* gg = (const float*)g;
    switch (vec) {
      case 4: launch_scatter<float, 4>(ix, gg, d, batch, n, q, c, s); break;
      case 2: launch_scatter<float, 2>(ix, gg, d, batch, n, q, c, s); break;
      default: launch_scatter<float, 1>(ix, gg, d, batch, n, q, c, s);
    }
  }
  return (int)cudaGetLastError();
}

// The deterministic backward: the arguments of anystereo_scatter_rows_add,
// but dtbl need not be zeroed (every element is written), and each row's
// queries are summed in ascending order.  Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for another vec, a batch
// beyond the grid's y or q, n, q * c or n * c beyond 32 bits.
extern "C" int anystereo_scatter_rows_ordered(const void* idx, const void* g, void* dtbl,
                                              long long batch, long long n, long long q,
                                              int c, int g_bf16, int vec, void* stream) {
  if (batch > 65535 || n > INT32_MAX || q > INT32_MAX || q * c > INT32_MAX || n * c > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if ((vec != 4 && vec != 2 && vec != 1) || c % vec != 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || n == 0 || c == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* ix = (const int32_t*)idx;
  float* d = (float*)dtbl;
  if (g_bf16) {
    const __nv_bfloat16* gg = (const __nv_bfloat16*)g;
    switch (vec) {
      case 4: launch_ordered<__nv_bfloat16, 4>(ix, gg, d, batch, n, q, c, s); break;
      case 2: launch_ordered<__nv_bfloat16, 2>(ix, gg, d, batch, n, q, c, s); break;
      default: launch_ordered<__nv_bfloat16, 1>(ix, gg, d, batch, n, q, c, s);
    }
  } else {
    const float* gg = (const float*)g;
    switch (vec) {
      case 4: launch_ordered<float, 4>(ix, gg, d, batch, n, q, c, s); break;
      case 2: launch_ordered<float, 2>(ix, gg, d, batch, n, q, c, s); break;
      default: launch_ordered<float, 1>(ix, gg, d, batch, n, q, c, s);
    }
  }
  return (int)cudaGetLastError();
}
