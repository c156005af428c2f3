// Exact dense-Adam update of the embedding table: the full-table sweep
// (kernel 7) and the sparse row step (kernel 6).
//
// Kernel 7 replaces tpurec/ops/fused_adam_pallas.py::fused_decay_adam
// (_decay_kernel), the sweep of tpurec/train/hybrid.py::_sweep_only:
//
//   u  = coef * p (+ g_small on the flat prefix [0, n_g))
//   m' = b1 * m + (1 - b1) * u,   v' = b2 * v + (1 - b2) * u * u
//   p' = p - lr * (m' / bc1) / (sqrt(v' / bc2) + eps)
//   sumsq = sum(p * p) of the table before the step
//
// over the flat table, in place.  m and v are stored as float32 or
// bfloat16 (rounded to nearest even on the store, as astype(bfloat16)
// does); the math runs in float32.  The TPU kernel takes float32 moments
// only; bfloat16 storage is what hybrid.py:203-207 does.
//
// Bound on the H100: bytes.  Each element reads p, m, v and writes them
// back: 16 B per element with bfloat16 moments (417 MB at 1,627,120 x 16,
// 0.124 ms at 3.35 TB/s), 24 B with float32 (625 MB, 0.187 ms).  The
// design is one grid-stride pass in which a thread moves 8 elements per
// step with 16-byte accesses (two float4 of p; two float4 or one 16-byte
// pack of 8 bfloat16 per moment), so the loads are the widest the memory
// system serves.  sum(p * p) is summed in double per thread and per block
// into a [grid] buffer, which a second one-block kernel adds up in a
// fixed order: deterministic, unlike a float atomic.
//
// Kernel 6 replaces the function of fused_adam_pallas.py::
// fused_sparse_adam (_kernel) in the form the hybrid update uses, the
// big-field row correction of hybrid.py:249-263 written back at :122-129:
// for sorted, unique touched ids (sentinels >= V skipped; the sort and
// the duplicate sums are torch ops outside, as _dedup_sorted stays jnp
// outside pallas_call)
//
//   u = g_u + coef * p_old, then the Adam step of p, m, v for those rows.
//
// The correction reads the rows' values from before the step, while the
// sweep updates the table in place.  So the row step runs first, from the
// untouched table, into compact [N, D] buffers (pb float32, mb and vb in
// the moments' type), and a second kernel writes them over the swept rows
// after the sweep.  The ids are unique, so no two threads write one row.
// Bound: bytes, under 1 MB at 1,024 ids of 16 values: launch-bound.
//
// The plain versions are in tpurec_torch/ops/fused_adam.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Adam {
  float lr, b1, omb1, b2, omb2, eps, coef, bc1, bc2;
};

__device__ __forceinline__ void adam(const Adam& h, float p, float m,
                                     float v, float u, float& p2, float& m2,
                                     float& v2) {
  m2 = h.b1 * m + h.omb1 * u;
  v2 = h.b2 * v + h.omb2 * (u * u);
  p2 = p - h.lr * (m2 / h.bc1) / (sqrtf(v2 / h.bc2) + h.eps);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = __bfloat162float(b[k]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&x)[8]) {
  uint4 raw;
  __nv_bfloat16* b = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) b[k] = __float2bfloat16_rn(x[k]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// n % 8 == 0; g holds the first n_g elements' gradients (n_g <= n)
template <typename MT>
__global__ void __launch_bounds__(kThreads)
    decay_adam_kernel(float* __restrict__ p, MT* __restrict__ m,
                      MT* __restrict__ v, const float* __restrict__ g,
                      long long n, long long n_g, Adam h,
                      double* __restrict__ block_sumsq) {
  double acc = 0.0;
  const long long stride = 8LL * gridDim.x * blockDim.x;
  for (long long i = 8LL * (static_cast<long long>(blockIdx.x) * blockDim.x +
                            threadIdx.x);
       i < n; i += stride) {
    float pv[8], mv[8], vv[8], gv[8];
    load8(p + i, pv);
    load8(m + i, mv);
    load8(v + i, vv);
    if (i + 8 <= n_g) {
      load8(g + i, gv);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) gv[k] = i + k < n_g ? g[i + k] : 0.f;
    }
    float p2[8], m2[8], v2[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc += static_cast<double>(pv[k] * pv[k]);
      adam(h, pv[k], mv[k], vv[k], h.coef * pv[k] + gv[k], p2[k], m2[k],
           v2[k]);
    }
    store8(p + i, p2);
    store8(m + i, m2);
    store8(v + i, v2);
  }
  __shared__ double warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    block_sumsq[blockIdx.x] = s;
  }
}

// sumsq[0] = sum of the G block sums, in a fixed order
__global__ void __launch_bounds__(kThreads)
    finish_sumsq_kernel(const double* __restrict__ block_sumsq, int G,
                        float* __restrict__ sumsq) {
  __shared__ double part[kThreads];
  double s = 0.0;
  for (int i = threadIdx.x; i < G; i += blockDim.x) s += block_sumsq[i];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) part[threadIdx.x] += part[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) sumsq[0] = static_cast<float>(part[0]);
}

// one thread per (row j, column d); rows with id outside [0, V) skipped
template <typename MT>
__global__ void __launch_bounds__(kThreads)
    adam_rows_kernel(const float* __restrict__ p, const MT* __restrict__ m,
                     const MT* __restrict__ v,
                     const long long* __restrict__ ids,
                     const float* __restrict__ g, int N, int D, long long V,
                     Adam h, float* __restrict__ pb, MT* __restrict__ mb,
                     MT* __restrict__ vb) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(N) * D) return;
  const long long id = ids[idx / D];
  if (id < 0 || id >= V) return;
  const long long src = id * D + idx % D;
  const float p_old = p[src];
  float p2, m2, v2;
  adam(h, p_old, to_f(m[src]), to_f(v[src]), g[idx] + h.coef * p_old, p2,
       m2, v2);
  pb[idx] = p2;
  mb[idx] = from_f<MT>(m2);
  vb[idx] = from_f<MT>(v2);
}

template <typename MT>
__global__ void __launch_bounds__(kThreads)
    write_rows_kernel(float* __restrict__ p, MT* __restrict__ m,
                      MT* __restrict__ v, const long long* __restrict__ ids,
                      const float* __restrict__ pb,
                      const MT* __restrict__ mb, const MT* __restrict__ vb,
                      int N, int D, long long V) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(N) * D) return;
  const long long id = ids[idx / D];
  if (id < 0 || id >= V) return;
  const long long dst = id * D + idx % D;
  p[dst] = pb[idx];
  m[dst] = mb[idx];
  v[dst] = vb[idx];
}

Adam make_adam(float lr, float b1, float omb1, float b2, float omb2,
               float eps, float coef, float bc1, float bc2) {
  Adam h;
  h.lr = lr;
  h.b1 = b1;
  h.omb1 = omb1;
  h.b2 = b2;
  h.omb2 = omb2;
  h.eps = eps;
  h.coef = coef;
  h.bc1 = bc1;
  h.bc2 = bc2;
  return h;
}

}  // namespace

// Kernel 7.  p [n] float32, m and v [n] float32 (bf16 = 0) or bfloat16
// (bf16 = 1), all 16-byte aligned with n % 8 == 0; g [n_g] float32.
// block_sumsq is [grid] double scratch, sumsq one float.  The constants
// come from the host: omb1 = 1 - b1, omb2 = 1 - b2, bc1 = 1 - b1^t,
// bc2 = 1 - b2^t.  Returns the cudaError_t of the launches.
extern "C" int tpurec_decay_adam(float* p, void* m, void* v, int bf16,
                                 const float* g, long long n, long long n_g,
                                 float lr, float b1, float omb1, float b2,
                                 float omb2, float eps, float coef,
                                 float bc1, float bc2, int grid,
                                 double* block_sumsq, float* sumsq,
                                 void* stream) {
  if (n % 8 != 0 || n_g > n || n_g < 0 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Adam h = make_adam(lr, b1, omb1, b2, omb2, eps, coef, bc1, bc2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    decay_adam_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        p, static_cast<__nv_bfloat16*>(m), static_cast<__nv_bfloat16*>(v),
        g, n, n_g, h, block_sumsq);
  else
    decay_adam_kernel<float><<<grid, kThreads, 0, s>>>(
        p, static_cast<float*>(m), static_cast<float*>(v), g, n, n_g, h,
        block_sumsq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_sumsq_kernel<<<1, kThreads, 0, s>>>(block_sumsq, grid, sumsq);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 6, the row step: ids [N] int64 (unique; outside [0, V) skipped),
// g [N, D] float32 -> pb [N, D] float32 and mb, vb [N, D] in the moments'
// type, from the table p [V, D] and moments m, v before the sweep.
extern "C" int tpurec_adam_rows(const float* p, const void* m, const void* v,
                                int bf16, const long long* ids,
                                const float* g, int N, int D, long long V,
                                float lr, float b1, float omb1, float b2,
                                float omb2, float eps, float coef, float bc1,
                                float bc2, float* pb, void* mb, void* vb,
                                void* stream) {
  if (N < 0 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const Adam h = make_adam(lr, b1, omb1, b2, omb2, eps, coef, bc1, bc2);
  const long long n = static_cast<long long>(N) * D;
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    adam_rows_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        p, static_cast<const __nv_bfloat16*>(m),
        static_cast<const __nv_bfloat16*>(v), ids, g, N, D, V, h, pb,
        static_cast<__nv_bfloat16*>(mb), static_cast<__nv_bfloat16*>(vb));
  else
    adam_rows_kernel<float><<<blocks, kThreads, 0, s>>>(
        p, static_cast<const float*>(m), static_cast<const float*>(v), ids,
        g, N, D, V, h, pb, static_cast<float*>(mb), static_cast<float*>(vb));
  return static_cast<int>(cudaGetLastError());
}

// Kernel 6, the write-back after the sweep: rows ids of p, m, v get pb,
// mb, vb.
extern "C" int tpurec_write_rows(float* p, void* m, void* v, int bf16,
                                 const long long* ids, const float* pb,
                                 const void* mb, const void* vb, int N,
                                 int D, long long V, void* stream) {
  if (N < 0 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const long long n = static_cast<long long>(N) * D;
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    write_rows_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        p, static_cast<__nv_bfloat16*>(m), static_cast<__nv_bfloat16*>(v),
        ids, pb, static_cast<const __nv_bfloat16*>(mb),
        static_cast<const __nv_bfloat16*>(vb), N, D, V);
  else
    write_rows_kernel<float><<<blocks, kThreads, 0, s>>>(
        p, static_cast<float*>(m), static_cast<float*>(v), ids, pb,
        static_cast<const float*>(mb), static_cast<const float*>(vb), N, D,
        V);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpurec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
