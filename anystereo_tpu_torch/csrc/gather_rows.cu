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
