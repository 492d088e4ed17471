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
// 16-byte path).  Backward: one thread per element of g, coalesced reads,
// atomics into a table that was zeroed by the wrapper; g is fp32 or bf16
// and is widened to fp32 before the add, so the sum is an fp32 sum whatever
// g's type.  With about Q/N = 4 to 16 queries on a table row the contention
// is mild, and the tables (at most 2 MB) stay in L2.  The order of the
// atomic adds changes from run to run, so the result is reproducible only
// up to fp32 rounding of each row's sum.
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

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// idx [B, q], g [B, q, c], dtbl [B, n, c] fp32 (zeroed).  One thread per
// element of g.
template <typename GT>
__global__ void __launch_bounds__(kThreads)
scatter_rows_add(const int32_t* __restrict__ idx, const GT* __restrict__ g,
                 float* __restrict__ dtbl, int64_t total, int64_t q, int64_t n,
                 int c) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t row = t / c;
  const int ch = (int)(t - row * c);
  const int64_t b = row / q;
  const int32_t p = __ldg(idx + row);
  if (p < 0 || p >= n) return;
  atomicAdd(dtbl + (b * n + p) * c + ch, load_f32(g + t));
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
// [batch, n, c] fp32, zeroed by the caller.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int anystereo_scatter_rows_add(const void* idx, const void* g, void* dtbl,
                                          long long batch, long long n, long long q,
                                          int c, int g_bf16, void* stream) {
  const int64_t total = (int64_t)batch * q * c;
  if (total == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* ix = (const int32_t*)idx;
  if (g_bf16) {
    scatter_rows_add<__nv_bfloat16><<<blocks_for(total), kThreads, 0, s>>>(
        ix, (const __nv_bfloat16*)g, (float*)dtbl, total, q, n, c);
  } else {
    scatter_rows_add<float><<<blocks_for(total), kThreads, 0, s>>>(
        ix, (const float*)g, (float*)dtbl, total, q, n, c);
  }
  return (int)cudaGetLastError();
}
