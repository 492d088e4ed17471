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
// What bounds them: bytes.  Forward: neighbouring threads copy neighbouring
// units of one row, so reads of a row and writes of the output coalesce;
// the unit is 16, 4 or 2 bytes, the widest that divides a row's bytes and
// the pointers' alignment (the wrapper chooses), so any channel count works
// (9 fp32 channels take the 4-byte path, 40 and 184 bf16 channels the
// 16-byte path).
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

// table [B, n, upr] units, idx [B, q], out [B, q, upr] units; upr = units
// per row.  One thread per output unit.
template <typename Unit>
__global__ void __launch_bounds__(kThreads)
gather_rows_fwd(const Unit* __restrict__ table, const int32_t* __restrict__ idx,
                Unit* __restrict__ out, int64_t total, int64_t q, int64_t n,
                int upr) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t row = t / upr;  // b * q + query
  const int u = (int)(t - row * upr);
  const int64_t b = row / q;
  const int32_t p = __ldg(idx + row);
  Unit v = Unit();
  if (p >= 0 && p < n) v = table[(b * n + p) * upr + u];
  out[t] = v;
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

constexpr int kQueriesInFlight = 4;  // query rows a lane group loads before it adds

// idx [B, q], g [B, q, c], dtbl [B, n, c] fp32 (zeroed); c % VEC == 0.  A
// query row is owned by `lanes` = min(c / VEC, 32) lanes of a warp, which
// takes per_warp = 32 / lanes rows side by side; blockIdx.y is the sample.
// A warp takes a chunk of per_warp * kQueriesInFlight consecutive queries;
// each lane group loads the indices of its kQueriesInFlight queries (one
// request a row, its lanes reading one address) and then their rows of g
// before it adds any, so that many loads are in flight where one query's
// loads and adds would wait on each other.
template <typename GT, int VEC>
__global__ void __launch_bounds__(kThreads)
scatter_rows_add(const int32_t* __restrict__ idx, const GT* __restrict__ g,
                 float* __restrict__ dtbl, int q, int n, int c) {
  constexpr int UNR = kQueriesInFlight;
  const int units = c / VEC;
  const int lanes = units < 32 ? units : 32;
  const int per_warp = 32 / lanes;
  const int chunk = per_warp * UNR;
  const int lane = threadIdx.x & 31;
  const int slot = lane / lanes;
  const int unit = lane - slot * lanes;
  const bool active = slot < per_warp;
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

template <typename GT, int VEC>
void launch_scatter(const int32_t* idx, const GT* g, float* dtbl, int batch, int n,
                    int q, int c, cudaStream_t s) {
  const int lanes = c / VEC < 32 ? c / VEC : 32;
  const int64_t per_block = (int64_t)(kThreads / 32) * (32 / lanes) * kQueriesInFlight;
  const int64_t need = (q + per_block - 1) / per_block;
  const dim3 grid((unsigned)(need < 8192 ? need : 8192), (unsigned)batch);
  scatter_rows_add<GT, VEC><<<grid, kThreads, 0, s>>>(idx, g, dtbl, q, n, c);
}

unsigned blocks_for(int64_t total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

}  // namespace

// table [batch, n, row_bytes], idx [batch, q] int32, out [batch, q,
// row_bytes]; `unit` is 16, 4 or 2 and divides row_bytes, and both pointers
// are aligned to it.  Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for another unit.
extern "C" int anystereo_gather_rows(const void* table, const void* idx, void* out,
                                     long long batch, long long n, long long q,
                                     int row_bytes, int unit, void* stream) {
  if (unit != 16 && unit != 4 && unit != 2) return (int)cudaErrorInvalidValue;
  if (row_bytes % unit != 0) return (int)cudaErrorInvalidValue;
  const int upr = row_bytes / unit;
  const int64_t total = (int64_t)batch * q * upr;
  if (total == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* ix = (const int32_t*)idx;
  if (unit == 16) {
    gather_rows_fwd<uint4><<<blocks_for(total), kThreads, 0, s>>>(
        (const uint4*)table, ix, (uint4*)out, total, q, n, upr);
  } else if (unit == 4) {
    gather_rows_fwd<uint32_t><<<blocks_for(total), kThreads, 0, s>>>(
        (const uint32_t*)table, ix, (uint32_t*)out, total, q, n, upr);
  } else {
    gather_rows_fwd<uint16_t><<<blocks_for(total), kThreads, 0, s>>>(
        (const uint16_t*)table, ix, (uint16_t*)out, total, q, n, upr);
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
