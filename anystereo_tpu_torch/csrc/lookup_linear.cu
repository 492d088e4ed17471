// Single-level linear tap lookups on row-major volumes, for Hopper (sm_90a):
// arbitrary positions per tap, and a window of consecutive taps from one
// start per row; forward and backward of each.
//
// Replaces the TPU kernels of anystereo_tpu/ops/pallas/lookup_kernel.py:
//   `gather_rows_linear`   vol [R, L], pos [R, K]  -> out [R, K]
//                          (bodies `_fwd_kernel`, `_bwd_kernel`)
//   `gather_window_linear` vol [R, L], base [R], K -> out [R, K]
//                          (bodies `_win_fwd_kernel`, `_win_bwd_kernel`)
//
// What they compute.  Rows: tap k of row r sits at p = pos[r, k];
// i0 = floor(p), w = p - i0, out = vol[r, i0]*(1 - w) + vol[r, i0+1]*w, where
// an entry outside [0, L) counts as zero (each neighbour on its own, so
// i0 = -1 keeps its upper half and i0 = L-1 its lower).  The backward is the
// transpose in the volume: dvol[r, l] = sum over k of g[r, k]*(1 - w_k) where
// i0_k == l, plus g[r, k]*w_k where i0_k + 1 == l; taps that share an entry
// sum.  Window: tap k of row r sits at base[r] + k, so i0 = floor(base) and
// f = base - i0 are shared by the row's taps: out[r, k] = (1 - f)*vol[r, i0+k]
// + f*vol[r, i0+k+1]; backward dvol[r, i0+j] = (1 - f)*g[r, j] + f*g[r, j-1]
// for j = 0..K (terms with a tap index outside [0, K) absent), one
// coefficient an entry.  Positions get no gradient.  Everything is fp32.
//
// What bounds them: memory.  A tap is two loads, three products and sums.  The
// TPU bodies form every tap as a masked sum over all 128-padded lanes of the
// row, in tiles of 256 rows, because a lane cannot index; here only the
// entries some tap needs are read.
//   - rows forward (B8, the evaluator's left-right occlusion warp, one
//     launch a frame at 375 x 1242 x 1242): a thread an output element paid
//     a 64-bit division, a load of its position and then, dependent on it,
//     two scalar loads from the row: two round trips to device memory in a
//     row, 8.6 us against a bound of 1.6 on the H100, ~5 of it the launch.
//     So a block owns a row and a range of its taps (equal ranges of at most
//     4*kThreads*kRowsFwdVecs, a multiple of 4; the occlusion row is one):
//     it copies the row into shared memory by cp.async, 16 bytes a copy
//     between a 4-byte head and tail (the row placed at the same offset
//     within 16 bytes as in `vol`, so that both ends of each copy are
//     aligned), and while the copies fly each thread loads its positions as
//     float4s; one round trip, then the taps from shared memory with 32-bit
//     indices and no division, and float4 stores.  Positions and output take
//     16-byte vectors where they share their offset within 16 bytes, with a
//     scalar head and tail, and scalars where not.  The occlusion call is
//     then at the launch and its bytes (the time after a flush that leaves
//     L2 clean is 1 us shorter), level with the old kernel.  Rows longer
//     than kRowsStaged entries, and rows with fewer than a quarter as many
//     taps as entries, keep a thread an element (`rows_linear_fwd_taps`):
//     there the copy reads far more than the taps do, and staging lost on
//     the H100 (4.5x at 30,000 x 48 x 9, 15% at 3,000 x 312 x 64);
//   - window forward (B7, the "levels" flavor's lookup): a thread per
//     output element, as the rows forward, paid a 64-bit division, a reload
//     of base[r] and its floor for each of a row's taps, and loaded each
//     window entry twice: at the GEV volume (R 239,616, L 48) its own work
//     took 3.4x its bound of bytes on the H100, bound by its instructions.
//     So each warp owns a tile of consecutive rows and works alone, with no
//     barrier across the block, so that the warps of an SM overlap one
//     tile's loads with another's stores; a tile is 32 rows, or 16 where
//     that leaves too few warps to fill the card (`window_tile`).  A lane a
//     row forms i0 and f once; the tile's windows, taps+1 entries a row,
//     are copied once into the warp's shared memory by cp.async,
//     neighbouring lanes on neighbouring entries of a row (zeros outside
//     [0, L)), all of a lane's copies in flight at once and with an
//     evict-first L2 hint, as B4's (the GRU loop's pooled levels are larger
//     than L2); then the tile's taps, tile*taps floats that lie contiguous
//     in `out`, are formed four at a time from shared memory and written as
//     16-byte vectors.  Index arithmetic inside the tile is 32-bit, with the
//     divisor a constant for the models' 9 taps.  The GEV call is then bound
//     by bytes (a 40-byte window touches two or three 32-byte sectors of its
//     row).  With fewer rows than 16-row tiles need to fill the card (the
//     correlation calls, 29,952 rows and fewer) the launch and two dependent
//     loads bound the call, and a thread a tap (`window_linear_fwd_taps`,
//     32-bit indices) keeps each thread's path the shortest: on the H100 the
//     staged tiles were a little slower there.  Windows too wide to stage
//     (taps + 1 > kWinStaged, wider than any model's) take it too;
//   - window backward (B7's, on the "levels" training step): dvol [R, L] is
//     mostly zeros (10 of 48 entries live at GEV, 10 of 312 at the eval
//     correlation), so its one write is the bound.  A thread an entry paid
//     a 64-bit division, a reload of base[r] and its floor, and a 4-byte
//     store for each entry, and lost 1.5x to `grid_sampler_2d_backward` at
//     the eval-shaped correlation on the H100.  So each warp owns a tile of
//     consecutive rows (32, halved to 4 while the card would hold fewer than
//     16 warps an SM: `window_bwd_tile`) and works alone; its lanes form each
//     row's i0, f and taps + 1 coefficients once, into shared memory, with
//     the cotangent's rows (contiguous) read coalesced; then the tile's
//     tile*L entries, contiguous in dvol, are written as 16-byte vectors,
//     each lane stepping its (row, l) by 128 entries so that no entry pays a
//     division; 32-bit indices inside the tile.  Windows too wide for a
//     4-row tile's coefficients (taps + 1 > 767) take a warp a row
//     (`window_linear_bwd_rows`);
//   - rows backward (B8's, reached only as a gradient): taps collide inside a
//     row (many k land on one l), and each entry's sum must keep the plain
//     version's ascending k.  Walking every tap for every entry (K*L
//     comparisons a row, 578 M at the occlusion warp's 375 x 1242 x 1242)
//     was bound by instructions at 120x its bound of bytes, 10.8x slower
//     than `grid_sampler_2d_backward` on the H100.  So a block takes a range
//     of up to 640 entries of a row (the occlusion row: two) and sorts the
//     row's taps, a chunk of 1,280 at a time, by their lower entry i0 with a
//     stable counting sort in shared memory, which needs no order of the
//     positions (the warp's x - disparity has none): each warp counts its
//     run of the chunk by bucket, a scan gives each warp its first slot in
//     each bucket, and each warp places its run, ranks inside a group of 32
//     from `__match_any_sync`; then entry l merges the taps at i0 = l - 1
//     (upper halves) with those at i0 = l (lower halves), two contiguous
//     runs, by k.  O(K + L) work a row, no atomics in device memory, every
//     entry written, dvol stored as 16-byte vectors.  What bounds it now is
//     the latency of that chain of barriers in one block (a one-row launch
//     takes ~6 us of its own on the H100), not bytes; 40 registers and 28 KB
//     of shared memory a block let all 750 blocks of the occlusion call stay
//     resident at once.  A row of at most 32 taps skips the sort: each entry
//     walks them (at most 32 comparisons), as the first port did.
//
// Numerics: every operation is an explicit round-to-nearest intrinsic in the
// order of the plain PyTorch versions (`ops/kernels/lookup_linear.py`), so
// nvcc contracts nothing into an FMA and kernel and plain version agree bit
// for bit.  floor(p) is clamped in float to [-2, L] (rows) or [-(K+1), L]
// (window) before the conversion to int: that moves only taps and windows
// with no live entry and keeps the index finite for positions like 3e9.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsChunk = 1280;  // taps of a row the rows backward sorts at a time (5 a thread)
constexpr int kRowsSpan = 640;    // entries of a row one block of it covers (28 KB in all)
constexpr int kRowsWalk = 32;     // a row of at most this many taps is walked, not sorted
constexpr int kRowsBlocksPerSM = 6;  // blocks of it an SM holds: 40 registers a thread at most
constexpr int kRowsStaged = 8192;   // the longest row the rows forward stages (32 KB)
constexpr int kRowsFwdVecs = 2;     // float4s of positions a thread of it holds
constexpr int kWinWarps = 4;        // warps a block of the window forward / backward holds
constexpr int kWinWarpsPerSM = 16;  // warps a tile height must give each SM
constexpr int kWinStaged = 94;      // the widest window (taps + 1) it stages: 48 KB a block
constexpr int kBwdMinTile = 4;      // the shortest tile of the window backward
constexpr int kBwdWarpWords = 3072; // 4-byte words of shared memory a warp of it may take
static_assert(kRowsChunk % kThreads == 0, "the rows backward holds whole rounds of a chunk");
static_assert(kThreads == 256, "the rows backward keeps a bucket's 8 warp counts in 16 bytes");

// 4-byte words of shared memory a warp of the window forward takes: f and
// i0 of its `tile` rows, then their windows of `span` entries.
__host__ __device__ constexpr int win_words(int tile, int span) { return tile * (2 + span); }

// 4-byte words of shared memory a warp of the window backward takes: i0 of
// its `tile` rows, then their span coefficients.
__host__ __device__ constexpr int bwd_words(int tile, int span) { return tile * (1 + span); }

__device__ __forceinline__ float entry_or_zero(const float* __restrict__ row, int i,
                                               int length) {
  return (i >= 0 && i < length) ? __ldg(row + i) : 0.0f;
}

// lower*(1 - w) + upper*w, in the plain version's order
__device__ __forceinline__ float lerp_rn(float lower, float upper, float w) {
  return __fadd_rn(__fmul_rn(lower, __fsub_rn(1.0f, w)), __fmul_rn(upper, w));
}

// ---- arbitrary positions ----

// The tap at position p of a row staged in `row` (shared memory).
__device__ __forceinline__ float staged_tap(const float* row, float p, int length) {
  const float f0 = floorf(p);
  const float w = __fsub_rn(p, f0);
  const int i0 = (int)fminf(fmaxf(f0, -2.0f), (float)length);
  const float lower = (i0 >= 0 && i0 < length) ? row[i0] : 0.0f;
  const float upper = (i0 + 1 >= 0 && i0 + 1 < length) ? row[i0 + 1] : 0.0f;
  return lerp_rn(lower, upper, w);
}

// grid (rows, ranges of `span` taps, span a multiple of 4 and at most
// 4 * kThreads * kRowsFwdVecs): block -> taps [k0, k0 + span) of row
// blockIdx.x.  `vec`: pos and out share their offset within 16 bytes
// (float4 loads and stores).
__global__ void __launch_bounds__(kThreads)
rows_linear_fwd(const float* __restrict__ vol, const float* __restrict__ pos,
                float* __restrict__ out, int length, int taps, int span, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int64_t r = blockIdx.x;
  const float* src = vol + r * length;
  // the row at the same offset within 16 bytes as in `vol`: a head of up to
  // 3 entries, then 16-byte copies with both ends aligned, then a tail
  const int shift = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  float* row = smem + shift;
  const int head = min(length, (4 - shift) & 3);
  const int vecs = (length - head) / 4;
  const uint64_t policy = evict_first();
  if ((int)threadIdx.x < head) copy_async4(row + threadIdx.x, src + threadIdx.x, policy);
  for (int v = threadIdx.x; v < vecs; v += kThreads)
    copy_async16(row + head + 4 * v, src + head + 4 * v, policy);
  for (int i = head + 4 * vecs + threadIdx.x; i < length; i += kThreads)
    copy_async4(row + i, src + i, policy);
  // this block's taps: a scalar head up to the first 16-byte boundary, up
  // to kRowsFwdVecs float4s a thread (loaded before the wait), a scalar
  // tail; all scalars where `vec` is 0
  const int k0 = blockIdx.y * span;
  const int n = min(span, taps - k0);
  const float* p = pos + r * taps + k0;
  float* o = out + r * taps + k0;
  const int phead = vec ? min(n, (int)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4)) : n;
  const int pvecs = vec ? (n - phead) / 4 : 0;
  float4 pv[kRowsFwdVecs];
#pragma unroll
  for (int u = 0; u < kRowsFwdVecs; ++u) {
    const int v = threadIdx.x + u * kThreads;
    if (v < pvecs) pv[u] = __ldg(reinterpret_cast<const float4*>(p + phead) + v);
  }
  copy_async_wait();
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kRowsFwdVecs; ++u) {
    const int v = threadIdx.x + u * kThreads;
    if (v < pvecs)
      reinterpret_cast<float4*>(o + phead)[v] =
          make_float4(staged_tap(row, pv[u].x, length), staged_tap(row, pv[u].y, length),
                      staged_tap(row, pv[u].z, length), staged_tap(row, pv[u].w, length));
  }
  for (int i = threadIdx.x; i < phead; i += kThreads) o[i] = staged_tap(row, __ldg(p + i), length);
  for (int i = phead + 4 * pvecs + threadIdx.x; i < n; i += kThreads)
    o[i] = staged_tap(row, __ldg(p + i), length);
}

// Rows of more than kRowsStaged entries, or with fewer than a quarter as
// many taps as entries: a thread an output element, k fastest, so the loads
// of pos and the stores coalesce; the row's loads stay inside one row
// (served by L1/L2).  (Its name holds `rows_linear_fwd`: a profiler sum by
// name takes both.)
__global__ void __launch_bounds__(kThreads)
rows_linear_fwd_taps(const float* __restrict__ vol, const float* __restrict__ pos,
                     float* __restrict__ out, int64_t rows, int length, int taps) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * taps) return;
  const int64_t r = t / taps;
  const float p = __ldg(pos + t);
  const float f0 = floorf(p);
  const float w = __fsub_rn(p, f0);
  const int i0 = (int)fminf(fmaxf(f0, -2.0f), (float)length);
  const float* row = vol + r * length;
  out[t] = lerp_rn(entry_or_zero(row, i0, length), entry_or_zero(row, i0 + 1, length), w);
}

// The rows backward's dynamic shared memory, in 4-byte words, for chunks of
// up to `chunk` taps and ranges of `span` entries: the slot counts (two
// warps' counts a word, four words a bucket) and the bucket starts only
// where the chunks are sorted, then the warps' scan sums, the
// range's sums, the sorted taps' halves and their chunk indices (16 bits).
struct RowsShared {
  int start, warp_sum, acc, lower, upper, k, words;
  __host__ __device__ RowsShared(int chunk, int span) {
    const bool sorted = chunk > kRowsWalk;
    start = sorted ? 4 * (span + 2) : 0;
    warp_sum = start + (sorted ? span + 2 : 0);
    acc = warp_sum + kThreads / 32;
    lower = acc + span;
    upper = lower + chunk + 1;
    k = upper + chunk + 1;
    words = k + (chunk + 2) / 2;
  }
};

// grid (rows, ranges): block -> entries [e0, e0 + span) of row blockIdx.x,
// e0 = blockIdx.y * span, span <= kRowsSpan; the row's taps a chunk at a
// time, in ascending k, each entry's sum carried from chunk to chunk.  A tap
// at i0 has the bucket b = i0 - e0 + 1 (none if neither half lands in the
// range): its lower half goes to entry el = b - 1, its upper half to el = b.
// Each chunk is sorted stably by bucket: its groups of 32 taps are split
// into runs, one a warp, held in registers; each warp counts its taps by
// bucket (shared atomics: counts have no order); a scan over (bucket, warp)
// gives each warp its first slot in each bucket; each warp places its taps
// there, one group at a time, a tap's rank the number of lower lanes with
// its bucket (`__match_any_sync`), storing (k, lower, upper) in sorted order.  Entry el then merges bucket el (upper
// halves) and bucket el + 1 (lower halves), two contiguous runs, by k.  A
// row of at most kRowsWalk taps is one chunk, walked by each entry instead
// in ascending k, the sum stored straight from the thread.  No atomics in
// device memory; sums in the plain version's order.
__global__ void __launch_bounds__(kThreads, kRowsBlocksPerSM)
rows_linear_bwd(const float* __restrict__ pos, const float* __restrict__ g,
                float* __restrict__ dvol, int length, int taps, int span) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kRuns = kRowsChunk / kThreads;  // groups of 32 taps a warp holds at most
  constexpr unsigned short kNone = 0xffff;      // no bucket (walked rows)
  extern __shared__ __align__(16) unsigned smem_rows[];
  const RowsShared at(min(taps, kRowsChunk), span);
  // s_slot[b][v / 2], half v % 2: warp v's count of bucket b, then its next slot
  uint4* s_slot4 = reinterpret_cast<uint4*>(smem_rows);
  unsigned* s_slot = smem_rows;
  int* s_start = reinterpret_cast<int*>(smem_rows + at.start);  // first slot of each bucket, and the end
  int* s_warp_sum = reinterpret_cast<int*>(smem_rows + at.warp_sum);
  float* s_acc = reinterpret_cast<float*>(smem_rows + at.acc);
  float* s_lower = reinterpret_cast<float*>(smem_rows + at.lower);  // the sorted taps' halves
  float* s_upper = reinterpret_cast<float*>(smem_rows + at.upper);
  unsigned short* s_k = reinterpret_cast<unsigned short*>(smem_rows + at.k);  // their k - k0
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned half = 16 * (warp % 2);
  const int64_t r = blockIdx.x;
  const int e0 = blockIdx.y * span;
  const int entries = min(span, length - e0);
  const int buckets = entries + 1;
  const float* prow = pos + r * taps;
  const float* grow = g + r * taps;
  // the tap's bucket, or -1, and its two halves
  auto stage = [&](int k, int& b, float& lower, float& upper) {
    const float p = __ldg(prow + k), gv = __ldg(grow + k);
    const float f0 = floorf(p);
    const float w = __fsub_rn(p, f0);
    b = (int)fminf(fmaxf(f0, -2.0f), (float)length) - e0 + 1;
    if (b < 0 || b > entries) b = -1;
    lower = __fmul_rn(gv, __fsub_rn(1.0f, w));
    upper = __fmul_rn(gv, w);
  };
  if (taps <= kRowsWalk) {  // one chunk, walked by each entry (span <= kThreads)
    if (threadIdx.x < taps) {
      int b;
      stage(threadIdx.x, b, s_lower[threadIdx.x], s_upper[threadIdx.x]);
      s_k[threadIdx.x] = b < 0 ? kNone : (unsigned short)b;
    }
    __syncthreads();
    const int el = threadIdx.x;
    if (el < entries) {
      float acc = 0.0f;
      for (int i = 0; i < taps; ++i) {
        if (s_k[i] == el + 1) acc = __fadd_rn(acc, s_lower[i]);
        else if (s_k[i] == el) acc = __fadd_rn(acc, s_upper[i]);
      }
      dvol[r * length + e0 + el] = acc;
    }
    return;
  }
  for (int e = threadIdx.x; e < entries; e += kThreads) s_acc[e] = 0.0f;
  for (int k0 = 0; k0 < taps; k0 += kRowsChunk) {
    const int n = min(kRowsChunk, taps - k0);
    __syncthreads();  // the previous chunk has been summed
    // warp v holds the groups [g0, g1) of the chunk, in order
    const int groups = (n + 31) / 32;
    const int sorters = min(kWarps, groups), per_warp = (groups + sorters - 1) / sorters;
    const int g0 = min(groups, warp * per_warp), g1 = min(groups, g0 + per_warp);
    int bk[kRuns];
    float lo[kRuns], up[kRuns];
#pragma unroll
    for (int u = 0; u < kRuns; ++u) {
      const int i = (g0 + u) * 32 + lane;
      bk[u] = -1;
      if (g0 + u < g1 && i < n) stage(k0 + i, bk[u], lo[u], up[u]);
    }
    for (int b = threadIdx.x; b < buckets; b += kThreads) s_slot4[b] = make_uint4(0, 0, 0, 0);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kRuns; ++u)
      if (bk[u] >= 0) atomicAdd(s_slot + 4 * bk[u] + warp / 2, 1u << half);
    __syncthreads();
    // exclusive scan over (bucket, warp): thread t owns `per_thread` buckets
    const int per_thread = (buckets + kThreads - 1) / kThreads;
    const int b0 = min(buckets, (int)threadIdx.x * per_thread), b1 = min(buckets, b0 + per_thread);
    int own = 0;
    for (int b = b0; b < b1; ++b) {
      const uint4 c = s_slot4[b];
      own += (int)((c.x & 0xffff) + (c.x >> 16) + (c.y & 0xffff) + (c.y >> 16) + (c.z & 0xffff) +
                   (c.z >> 16) + (c.w & 0xffff) + (c.w >> 16));
    }
    int incl = own;
    for (int d = 1; d < 32; d *= 2) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane == 31) s_warp_sum[warp] = incl;
    __syncthreads();
    int next = incl - own;
    for (int v = 0; v < warp; ++v) next += s_warp_sum[v];
    for (int b = b0; b < b1; ++b) {  // counts, then each warp's first slot, in warp order
      s_start[b] = next;
      const uint4 c = s_slot4[b];
      unsigned w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const unsigned even = next, count = w[h];
        next += count & 0xffff;
        w[h] = even | ((unsigned)next << 16);
        next += count >> 16;
      }
      s_slot4[b] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    if (threadIdx.x == kThreads - 1) s_start[buckets] = next;  // every live tap
    __syncthreads();
    unsigned* slot = s_slot + warp / 2;  // slot[4 * b], this warp's half
    unsigned peers[kRuns];  // the lanes of each group with this lane's bucket
#pragma unroll
    for (int u = 0; u < kRuns; ++u)
      peers[u] = g0 + u < g1 ? __match_any_sync(0xffffffffu, bk[u]) : 0;  // g1: the same for the warp
#pragma unroll
    for (int u = 0; u < kRuns; ++u) {
      if (g0 + u >= g1) break;
      if (bk[u] >= 0) {
        const int i = (int)((slot[4 * bk[u]] >> half) & 0xffff) + __popc(peers[u] & ((1u << lane) - 1));
        s_k[i] = (unsigned short)((g0 + u) * 32 + lane);
        s_lower[i] = lo[u];
        s_upper[i] = up[u];
      }
      __syncwarp();
      if (bk[u] >= 0 && lane == __ffs(peers[u]) - 1)
        atomicAdd(slot + 4 * bk[u], (unsigned)__popc(peers[u]) << half);
      __syncwarp();
    }
    __syncthreads();
    // entry el: bucket el (upper halves) and bucket el + 1 (lower halves), by k
    for (int el = threadIdx.x; el < entries; el += kThreads) {
      int a = s_start[el], b = s_start[el + 1];
      const int mid = b, end = s_start[el + 2];
      float acc = s_acc[el];
      for (int left = end - a; left > 0; --left) {
        const int ka = a < mid ? s_k[a] : kRowsChunk;
        const int kb = b < end ? s_k[b] : kRowsChunk;
        const bool upper = ka < kb;
        acc = __fadd_rn(acc, upper ? s_upper[a] : s_lower[b]);
        a += upper;
        b += !upper;
      }
      s_acc[el] = acc;
    }
  }
  __syncthreads();
  // the range's entries, 16-byte vectors between a scalar head and tail
  float* dst = dvol + r * length + e0;
  const int head = min(entries, (int)(((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / 4));
  const int vecs = (entries - head) / 4;
  for (int e = threadIdx.x; e < head; e += kThreads) dst[e] = s_acc[e];
  for (int v = threadIdx.x; v < vecs; v += kThreads) {
    const float* s = s_acc + head + 4 * v;
    reinterpret_cast<float4*>(dst + head)[v] = make_float4(s[0], s[1], s[2], s[3]);
  }
  for (int e = head + 4 * vecs + threadIdx.x; e < entries; e += kThreads) dst[e] = s_acc[e];
}

// ---- a window of consecutive taps from one start per row ----

__device__ __forceinline__ void window_start(float base, int length, int taps, int& i0,
                                             float& f) {
  const float f0 = floorf(base);
  f = __fsub_rn(base, f0);
  i0 = (int)fminf(fmaxf(f0, -(float)(taps + 1)), (float)length);
}

// Each warp owns a tile of `tile` consecutive rows (32 or 16), stages
// their windows in its shared memory [tile][taps + 1] and works alone (no
// block barrier, so the warps of an SM overlap their loads and stores):
// TAPS > 0 is the count known at compile time, 0 takes `taps_rt`.
template <int TAPS>
__global__ void __launch_bounds__(32 * kWinWarps)
window_linear_fwd(const float* __restrict__ vol, const float* __restrict__ base,
                  float* __restrict__ out, int64_t rows, int length, int taps_rt, int tile) {
  extern __shared__ __align__(16) float smem[];
  const int taps = TAPS > 0 ? TAPS : taps_rt;
  const int span = taps + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* fs = smem + warp * win_words(tile, span);  // [tile]
  int* starts = reinterpret_cast<int*>(fs + tile);  // [tile]
  float* win = fs + 2 * tile;                       // [tile][span]
  const int64_t r0 = ((int64_t)blockIdx.x * kWinWarps + warp) * tile;
  if (r0 >= rows) return;
  const int nrows = rows - r0 < tile ? (int)(rows - r0) : tile;
  const float* vol0 = vol + r0 * length;  // the tile's rows: 32 * length < 2^31
  if (lane < nrows) {
    int i0;
    float f;
    window_start(__ldg(base + r0 + lane), length, taps, i0, f);
    starts[lane] = i0;
    fs[lane] = f;
  }
  __syncwarp();
  // asynchronous copies: no load waits on the store of the one before
  const uint64_t policy = evict_first();
  for (int i = lane; i < nrows * span; i += 32) {
    const int row = i / span;
    const int j = starts[row] + (i - row * span);
    if (j >= 0 && j < length)
      copy_async4(win + i, vol0 + row * length + j, policy);
    else
      win[i] = 0.0f;
  }
  copy_async_wait();
  __syncwarp();
  // tap e of the tile: (1 - f)*s_k + f*s_{k+1} of row e / taps, k = e % taps
  auto tap = [&](int e) {
    const int row = e / taps;
    const int k = e - row * taps;
    const float f = fs[row];
    const float* s = win + row * span + k;
    return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, f), s[0]), __fmul_rn(f, s[1]));
  };
  // the tile's taps are contiguous in `out` (and start on a 16-byte boundary
  // where `out` does: r0 is a multiple of 16)
  const int total = nrows * taps;
  float* dst = out + r0 * taps;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int i = lane; i < total / 4; i += 32)
      reinterpret_cast<float4*>(dst)[i] = make_float4(tap(4 * i), tap(4 * i + 1), tap(4 * i + 2),
                                                      tap(4 * i + 3));
    done = total & ~3;
  }
  for (int e = done + lane; e < total; e += 32) dst[e] = tap(e);
}

// Few rows (a few thousand), or windows too wide to stage: a thread a tap,
// 32-bit indices (rows * taps below 2^31 - kThreads).  There the launch and
// two dependent loads bound the call, and a thread's path is shortest when
// each forms one tap.  (Its name holds `window_linear_fwd`: a profiler sum
// of B7 by name takes both.)
template <int TAPS>
__global__ void __launch_bounds__(kThreads)
window_linear_fwd_taps(const float* __restrict__ vol, const float* __restrict__ base,
                   float* __restrict__ out, int rows, int length, int taps_rt) {
  const int taps = TAPS > 0 ? TAPS : taps_rt;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= rows * taps) return;
  const int r = e / taps;
  const int k = e - r * taps;
  int i0;
  float f;
  window_start(__ldg(base + r), length, taps, i0, f);
  const float* row = vol + (int64_t)r * length;
  out[e] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, f), entry_or_zero(row, i0 + k, length)),
                     __fmul_rn(f, entry_or_zero(row, i0 + k + 1, length)));
}

// Rows of a warp's tile in the window forward: 32, or 16 where 32 leaves
// the card's `sms` SMs fewer than kWinWarpsPerSM warps each; 0 where 16
// does too, or where the window is too wide to stage (a thread a tap then,
// `window_linear_fwd_taps`).
inline int window_tile(int64_t rows, int taps, int sms) {
  if (taps + 1 > kWinStaged) return 0;
  for (int tile = 32; tile >= 16; tile /= 2)
    if ((rows + tile - 1) / tile >= (int64_t)kWinWarpsPerSM * sms) return tile;
  return 0;
}

// Coefficient j of a window's backward, (1 - f)*g_j + f*g_{j-1} with the
// terms whose tap index lies outside [0, taps) left out, in the plain
// version's order.
__device__ __forceinline__ float window_coeff(const float* __restrict__ grow, int j, int taps,
                                              float f) {
  float c = 0.0f;
  if (j < taps) c = __fmul_rn(__fsub_rn(1.0f, f), __ldg(grow + j));
  if (j >= 1) c = __fadd_rn(c, __fmul_rn(f, __ldg(grow + j - 1)));
  return c;
}

// Each warp owns a tile of `tile` consecutive rows (kBwdMinTile to 32) and
// works alone.  Its lanes form the tile's taps + 1 coefficients a row once,
// into shared memory [tile][taps + 1], each with its row's start i0; then
// the tile's tile*length entries of dvol, contiguous, are written four at a
// time: each is its row's coefficient at j = l - i0, or zero.  A lane walks
// its entries by (row, l), stepped by 128 entries at a time, so no entry
// pays a division.  TAPS > 0 is the count known at compile time.
template <int TAPS>
__global__ void __launch_bounds__(32 * kWinWarps)
window_linear_bwd(const float* __restrict__ base, const float* __restrict__ g,
                  float* __restrict__ dvol, int64_t rows, int length, int taps_rt, int tile) {
  extern __shared__ __align__(16) float smem[];
  const int taps = TAPS > 0 ? TAPS : taps_rt;
  const int span = taps + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* starts = reinterpret_cast<int*>(smem + warp * bwd_words(tile, span));  // [tile]
  float* coeff = smem + warp * bwd_words(tile, span) + tile;                  // [tile][span]
  const int64_t r0 = ((int64_t)blockIdx.x * kWinWarps + warp) * tile;
  if (r0 >= rows) return;
  const int nrows = rows - r0 < tile ? (int)(rows - r0) : tile;
  const float* g0 = g + r0 * taps;  // the tile's cotangent rows, contiguous
  for (int i = lane; i < nrows * span; i += 32) {
    const int row = i / span;
    const int j = i - row * span;
    int i0;
    float f;
    window_start(__ldg(base + r0 + row), length, taps, i0, f);
    if (j == 0) starts[row] = i0;
    coeff[i] = window_coeff(g0 + row * taps, j, taps, f);
  }
  __syncwarp();
  auto entry = [&](int row, int l) {
    const int j = l - starts[row];
    return (unsigned)j <= (unsigned)taps ? coeff[row * span + j] : 0.0f;
  };
  // the tile's entries are contiguous in dvol and start on a 16-byte
  // boundary where dvol does (r0 is a multiple of 4)
  const int total = nrows * length;
  float* dst = dvol + r0 * length;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int step_rows = 128 / length, step_l = 128 - step_rows * length;
    int row = 4 * lane / length, l = 4 * lane - row * length;
    for (int v = lane; v < total / 4; v += 32) {
      float out[4];
      int rr = row, ll = l;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        out[q] = entry(rr, ll);
        if (++ll == length) ll = 0, ++rr;
      }
      reinterpret_cast<float4*>(dst)[v] = make_float4(out[0], out[1], out[2], out[3]);
      row += step_rows;
      l += step_l;
      if (l >= length) l -= length, ++row;
    }
    done = total & ~3;
  }
  for (int e = done + lane; e < total; e += 32) {
    const int row = e / length;
    dst[e] = entry(row, e - row * length);
  }
}

// Windows too wide for a kBwdMinTile-row tile's coefficients in a warp's
// share (taps + 1 > kBwdWarpWords / kBwdMinTile - 1 = 767, wider than any
// model's): a warp a row, each lane forming the coefficients of its entries.
__global__ void __launch_bounds__(32 * kWinWarps)
window_linear_bwd_rows(const float* __restrict__ base, const float* __restrict__ g,
                       float* __restrict__ dvol, int64_t rows, int length, int taps) {
  const int64_t r = (int64_t)blockIdx.x * kWinWarps + threadIdx.x / 32;
  if (r >= rows) return;
  int i0;
  float f;
  window_start(__ldg(base + r), length, taps, i0, f);
  const float* grow = g + r * taps;
  float* drow = dvol + r * length;
  for (int l = threadIdx.x % 32; l < length; l += 32) {
    const int j = l - i0;
    drow[l] = (unsigned)j <= (unsigned)taps ? window_coeff(grow, j, taps, f) : 0.0f;
  }
}

// Rows of a warp's tile in the window backward: 32, halved while that
// leaves the card's `sms` SMs fewer than kWinWarpsPerSM warps each or the
// tile's coefficients do not fit a warp's share, down to kBwdMinTile; 0
// where even that does not fit (`window_linear_bwd_rows` then).
inline int window_bwd_tile(int64_t rows, int taps, int sms) {
  int tile = 32;
  while (tile > kBwdMinTile && (bwd_words(tile, taps + 1) > kBwdWarpWords ||
                                (rows + tile - 1) / tile < (int64_t)kWinWarpsPerSM * sms))
    tile /= 2;
  return bwd_words(tile, taps + 1) <= kBwdWarpWords ? tile : 0;
}

inline unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// All operands fp32 and contiguous; every kernel launches on `stream` and the
// function returns cudaGetLastError().

// vol [rows, length], pos [rows, taps] -> out [rows, taps]
extern "C" int anystereo_gather_rows_linear(const void* vol, const void* pos, void* out,
                                            long long rows, int length, int taps,
                                            void* stream) {
  if (length < 1 || taps < 1 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  // a grid of (rows, ranges) holds at most 2^31 - 1 rows and 65,535 ranges
  if (length > kRowsStaged || 4LL * taps < length || rows > 2147483647LL ||
      taps > 65535LL * 4 * kThreads * kRowsFwdVecs) {
    rows_linear_fwd_taps<<<blocks_for((int64_t)rows * taps), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)vol, (const float*)pos, (float*)out, rows, length, taps);
    return (int)cudaGetLastError();
  }
  // equal ranges of at most 4 * kThreads * kRowsFwdVecs taps, each a multiple of 4
  const int most = 4 * kThreads * kRowsFwdVecs;
  const int ranges = (taps + most - 1) / most;
  const int span = ((taps + ranges - 1) / ranges + 3) / 4 * 4;
  const int vec = ((reinterpret_cast<uintptr_t>(pos) ^ reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const size_t shared = sizeof(float) * (length + 3);
  rows_linear_fwd<<<dim3((unsigned)rows, (unsigned)((taps + span - 1) / span)), kThreads, shared,
                    (cudaStream_t)stream>>>((const float*)vol, (const float*)pos, (float*)out, length,
                                            taps, span, vec);
  return (int)cudaGetLastError();
}

// pos [rows, taps], g [rows, taps] -> dvol [rows, length], every entry written
extern "C" int anystereo_gather_rows_linear_bwd(const void* pos, const void* g, void* dvol,
                                                long long rows, int length, int taps,
                                                void* stream) {
  // ranges of up to kRowsSpan entries; where the taps are walked, an entry a thread
  const int widest = taps <= kRowsWalk ? kThreads : kRowsSpan;
  const int ranges = (length + widest - 1) / widest;  // blocks a row
  if (length < 1 || taps < 1 || rows < 0 || rows > 2147483647LL || ranges > 65535)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  const int span = (length + ranges - 1) / ranges;
  const size_t shared = sizeof(unsigned) * RowsShared(min(taps, kRowsChunk), span).words;
  rows_linear_bwd<<<dim3((unsigned)rows, (unsigned)ranges), kThreads, shared, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)g, (float*)dvol, length, taps, span);
  return (int)cudaGetLastError();
}

// vol [rows, length], base [rows] -> out [rows, taps]
extern "C" int anystereo_gather_window_linear(const void* vol, const void* base, void* out,
                                              long long rows, int length, int taps,
                                              void* stream) {
  // a tile's rows, and a thread a tap's taps, are indexed in 32 bits
  if (length < 1 || taps < 1 || rows < 0 || length > INT_MAX / 32 || taps > INT_MAX / 32 - 1)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int tile = window_tile(rows, taps, sms);
  if (tile == 0) {
    if (rows * taps > INT_MAX - kThreads) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((rows * taps + kThreads - 1) / kThreads);
    auto kernel = taps == 9 ? window_linear_fwd_taps<9> : window_linear_fwd_taps<0>;
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)vol, (const float*)base, (float*)out, (int)rows, length, taps);
    return (int)cudaGetLastError();
  }
  const size_t shared = sizeof(float) * kWinWarps * win_words(tile, taps + 1);
  const int64_t rows_per_block = (int64_t)kWinWarps * tile;
  const unsigned blocks = (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  auto kernel = taps == 9 ? window_linear_fwd<9> : window_linear_fwd<0>;
  kernel<<<blocks, 32 * kWinWarps, shared, (cudaStream_t)stream>>>(
      (const float*)vol, (const float*)base, (float*)out, rows, length, taps, tile);
  return (int)cudaGetLastError();
}

// base [rows], g [rows, taps] -> dvol [rows, length], every entry written
extern "C" int anystereo_gather_window_linear_bwd(const void* base, const void* g, void* dvol,
                                                  long long rows, int length, int taps,
                                                  void* stream) {
  // a tile's entries are indexed in 32 bits
  if (length < 1 || taps < 1 || rows < 0 || length > INT_MAX / 32 || taps > INT_MAX / 32 - 1)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int tile = window_bwd_tile(rows, taps, sms);
  const int64_t rows_per_block = (int64_t)kWinWarps * (tile > 0 ? tile : 1);
  const unsigned blocks = (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  if (tile == 0) {
    window_linear_bwd_rows<<<blocks, 32 * kWinWarps, 0, (cudaStream_t)stream>>>(
        (const float*)base, (const float*)g, (float*)dvol, rows, length, taps);
    return (int)cudaGetLastError();
  }
  const size_t shared = sizeof(float) * kWinWarps * bwd_words(tile, taps + 1);
  auto kernel = taps == 9 ? window_linear_bwd<9> : window_linear_bwd<0>;
  kernel<<<blocks, 32 * kWinWarps, shared, (cudaStream_t)stream>>>(
      (const float*)base, (const float*)g, (float*)dvol, rows, length, taps, tile);
  return (int)cudaGetLastError();
}
