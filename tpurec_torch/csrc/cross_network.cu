// DCN-v1 cross network: forward (kernel 8) and its backward (kernel 9).
//
// Replaces tpurec/ops/crossnet_pallas.py::cross_network_fused: the forward
// _fwd_kernel (run by _pallas_fwd) and the backward _bwd_kernel (run by
// _pallas_bwd through the custom VJP _fused_bwd).  For every batch row,
// with x0 the row [D] and w, b [L, D]:
//
//   x_{l+1} = x0 * (x_l . w_l) + b_l + x_l,   l = 0 .. L-1;  out = x_L
//
// and backwards, from g = d out (the steps of _bwd_kernel):
//
//   for l = L-1 .. 0:   dxw = g . x0,  db[l] += g,  dw[l] += dxw * x_l,
//                       dx0_extra += g * (x_l . w_l),  g += dxw * w_l
//   dx = g + dx0_extra
//
// Bound on the H100: bytes.  The forward reads x and writes out (at
// B=512, D=368: 1.5 MB, under half a microsecond at 3.35 TB/s), the
// backward reads x and g and writes dx (2.3 MB); w and b are 8.8 KB.  The
// arithmetic is a few FMAs per byte, so the launch, not the memory,
// bounds both at the batch sizes the models use.
//
// Design: one warp per batch row.  A lane holds its share of the row in
// registers (C chunks of VEC floats: 16-byte loads when D % 4 == 0 and the
// tensors are 16-byte aligned, scalar loads otherwise), so each layer is
// one warp-shuffle dot product and one register update; w and b sit in
// shared memory.  The backward keeps x0, g and dx0_extra in registers and
// recomputes x_l from x0 when it reaches layer l (the same operations in
// the same order as the forward, so the same bits), as _bwd_kernel
// recomputes the states instead of saving them.
//
// The weight gradients dw, db [L, D] are sums over the batch.  A block's
// warps walk the rows blockIdx.x * W + warp, + gridDim.x * W, ...; each
// lane adds its elements into its warp's slice of shared memory (a lane
// always owns the same elements, so there are no races), the block sums
// its warps in order into its slice of a [grid, 2, L, D] partial buffer,
// and a second kernel sums the grid slices in order.  No atomics: two
// calls give the same bits.  Only rows < B are visited; a real row that
// holds NaN puts NaN into dw and db, as JAX's masked `where` does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunks = 8;   // C <= 8: D <= 32 * 8 * VEC

template <int VEC>
struct Vec;

template <>
struct Vec<4> {
  using T = float4;
  __device__ static T load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Vec<1> {
  using T = float;
  __device__ static T load(const float* p) { return *p; }
  __device__ static void store(float* p, T v) { *p = v; }
};

__device__ __forceinline__ float dot(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ float dot(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// x0 * s + b + x, component-wise
__device__ __forceinline__ float cross(float x0, float s, float b, float x) {
  return fmaf(x0, s, b) + x;
}
__device__ __forceinline__ float4 cross(float4 x0, float s, float4 b,
                                        float4 x) {
  return make_float4(cross(x0.x, s, b.x, x.x), cross(x0.y, s, b.y, x.y),
                     cross(x0.z, s, b.z, x.z), cross(x0.w, s, b.w, x.w));
}

// a + s * b, component-wise
__device__ __forceinline__ float axpy(float a, float s, float b) {
  return fmaf(s, b, a);
}
__device__ __forceinline__ float4 axpy(float4 a, float s, float4 b) {
  return make_float4(fmaf(s, b.x, a.x), fmaf(s, b.y, a.y), fmaf(s, b.z, a.z),
                     fmaf(s, b.w, a.w));
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float warp_sum(float s) {
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// Row r's element offset of a lane's chunk c, or -1 past the row's end.
template <int VEC>
__device__ __forceinline__ int elem(int c, int lane, int D) {
  const int i = (c * 32 + lane) * VEC;
  return i < D ? i : -1;
}

// s = sum over the row of a . v (v in shared memory), across the warp
template <int VEC, int C>
__device__ __forceinline__ float row_dot(const typename Vec<VEC>::T (&a)[C],
                                         const float* v, int lane, int D) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = elem<VEC>(c, lane, D);
    if (i >= 0) s = dot(a[c], Vec<VEC>::load(v + i), s);
  }
  return warp_sum(s);
}

// x = x0, then layers 0 .. n-1 of the recurrence, in registers
template <int VEC, int C>
__device__ __forceinline__ void run_layers(const typename Vec<VEC>::T (&x0)[C],
                                           typename Vec<VEC>::T (&x)[C],
                                           const float* w, const float* b,
                                           int n, int lane, int D) {
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = x0[c];
  for (int l = 0; l < n; ++l) {
    const float s = row_dot<VEC, C>(x, w + l * D, lane, D);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = elem<VEC>(c, lane, D);
      if (i >= 0) x[c] = cross(x0[c], s, Vec<VEC>::load(b + l * D + i), x[c]);
    }
  }
}

// Copy w and b [L, D] into shared memory (w then b); ends synced.
__device__ void stage_weights(const float* __restrict__ w,
                              const float* __restrict__ b, int n,
                              float* sw) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sw[i] = w[i];
    sw[n + i] = b[i];
  }
  __syncthreads();
}

template <int VEC, int C>
__global__ void cross_fwd_kernel(const float* __restrict__ x,
                                 const float* __restrict__ w,
                                 const float* __restrict__ b, int B, int D,
                                 int L, float* __restrict__ out) {
  using T = typename Vec<VEC>::T;
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);   // w [L, D], then b [L, D]
  stage_weights(w, b, L * D, sw);
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
      (threadIdx.x >> 5);
  if (row >= B) return;
  const float* xr = x + row * D;
  T x0[C], xl[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = elem<VEC>(c, lane, D);
    x0[c] = i >= 0 ? Vec<VEC>::load(xr + i) : zero<T>();
  }
  run_layers<VEC, C>(x0, xl, sw, sw + L * D, L, lane, D);
  float* orow = out + row * D;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = elem<VEC>(c, lane, D);
    if (i >= 0) Vec<VEC>::store(orow + i, xl[c]);
  }
}

template <int VEC, int C>
__global__ void cross_bwd_kernel(const float* __restrict__ x,
                                 const float* __restrict__ w,
                                 const float* __restrict__ b,
                                 const float* __restrict__ g, int B, int D,
                                 int L, float* __restrict__ dx,
                                 float* __restrict__ partial) {
  using T = typename Vec<VEC>::T;
  extern __shared__ float4 smem4[];
  const int n = L * D;
  const int W = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* sw = reinterpret_cast<float*>(smem4);   // w, b [L, D]
  float* acc = sw + 2 * n;                       // [W, 2, L, D]: dw, db
  float* mine = acc + warp * 2 * n;
  for (int i = threadIdx.x; i < 2 * n * W; i += blockDim.x) acc[i] = 0.f;
  stage_weights(w, b, n, sw);
  const float* bw = sw + n;

  for (long long row = static_cast<long long>(blockIdx.x) * W + warp;
       row < B; row += static_cast<long long>(gridDim.x) * W) {
    T x0[C], gr[C], extra[C], xl[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = elem<VEC>(c, lane, D);
      x0[c] = i >= 0 ? Vec<VEC>::load(x + row * D + i) : zero<T>();
      gr[c] = i >= 0 ? Vec<VEC>::load(g + row * D + i) : zero<T>();
      extra[c] = zero<T>();
    }
    for (int l = L - 1; l >= 0; --l) {
      run_layers<VEC, C>(x0, xl, sw, bw, l, lane, D);
      const float xw = row_dot<VEC, C>(xl, sw + l * D, lane, D);
      float dxw = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (elem<VEC>(c, lane, D) >= 0) dxw = dot(gr[c], x0[c], dxw);
      dxw = warp_sum(dxw);
      float* dw = mine + l * D;
      float* db = mine + n + l * D;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int i = elem<VEC>(c, lane, D);
        if (i < 0) continue;
        Vec<VEC>::store(db + i, add(Vec<VEC>::load(db + i), gr[c]));
        Vec<VEC>::store(dw + i, axpy(Vec<VEC>::load(dw + i), dxw, xl[c]));
        extra[c] = axpy(extra[c], xw, gr[c]);
        gr[c] = axpy(gr[c], dxw, Vec<VEC>::load(sw + l * D + i));
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = elem<VEC>(c, lane, D);
      if (i >= 0) Vec<VEC>::store(dx + row * D + i, add(gr[c], extra[c]));
    }
  }
  __syncthreads();
  // this block's partial: its warps' slices summed in order
  float* part = partial + static_cast<long long>(blockIdx.x) * 2 * n;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < W; ++k) s += acc[k * 2 * n + i];
    part[i] = s;
  }
}

// out[e] = sum_{k < G} partial[k, e], in order of k
__global__ void sum_partials_kernel(const float* __restrict__ partial, int G,
                                    int n, float* __restrict__ out) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < G; ++k) s += partial[static_cast<long long>(k) * n + e];
    out[e] = s;
  }
}

typedef void (*FwdKernel)(const float*, const float*, const float*, int, int,
                          int, float*);
typedef void (*BwdKernel)(const float*, const float*, const float*,
                          const float*, int, int, int, float*, float*);

template <int VEC>
FwdKernel fwd_kernel(int C) {
  switch (C) {
    case 1: return cross_fwd_kernel<VEC, 1>;
    case 2: return cross_fwd_kernel<VEC, 2>;
    case 3: return cross_fwd_kernel<VEC, 3>;
    case 4: return cross_fwd_kernel<VEC, 4>;
    case 5: return cross_fwd_kernel<VEC, 5>;
    case 6: return cross_fwd_kernel<VEC, 6>;
    case 7: return cross_fwd_kernel<VEC, 7>;
    case 8: return cross_fwd_kernel<VEC, 8>;
  }
  return nullptr;
}

template <int VEC>
BwdKernel bwd_kernel(int C) {
  switch (C) {
    case 1: return cross_bwd_kernel<VEC, 1>;
    case 2: return cross_bwd_kernel<VEC, 2>;
    case 3: return cross_bwd_kernel<VEC, 3>;
    case 4: return cross_bwd_kernel<VEC, 4>;
    case 5: return cross_bwd_kernel<VEC, 5>;
    case 6: return cross_bwd_kernel<VEC, 6>;
    case 7: return cross_bwd_kernel<VEC, 7>;
    case 8: return cross_bwd_kernel<VEC, 8>;
  }
  return nullptr;
}

// chunks of VEC floats per lane for a row of D, 0 when over kMaxChunks
int chunks(int D, int vec) {
  const int c = (D + 32 * vec - 1) / (32 * vec);
  return c <= kMaxChunks ? c : 0;
}

cudaError_t allow_smem(const void* kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// x [B, D], w and b [L, D] -> out [B, D].  vec is 4 (D % 4 == 0, 16-byte
// aligned tensors) or 1; warps is the rows per block.  Returns the
// cudaError_t of the launch.
extern "C" int tpurec_cross_network_fwd(const float* x, const float* w,
                                        const float* b, int B, int D, int L,
                                        int vec, int warps, float* out,
                                        void* stream) {
  const int C = chunks(D, vec);
  if (B < 0 || D < 1 || L < 1 || C == 0 || warps < 1 || warps > 32 ||
      (vec != 4 && vec != 1) || (vec == 4 && D % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const FwdKernel k = vec == 4 ? fwd_kernel<4>(C) : fwd_kernel<1>(C);
  const long long smem = 2LL * L * D * sizeof(float);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(k), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + warps - 1) / warps;
  k<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, b, B, D, L, out);
  return static_cast<int>(cudaGetLastError());
}

// The backward: x [B, D] (the forward's input), w, b [L, D] and g [B, D]
// -> dx [B, D] and wgrad [2, L, D] (dw, then db).  partial is [grid, 2, L,
// D] scratch; warps rows per block, each block's warps walking the rows
// with a stride of grid * warps.
extern "C" int tpurec_cross_network_bwd(const float* x, const float* w,
                                        const float* b, const float* g,
                                        int B, int D, int L, int vec,
                                        int warps, int grid, float* dx,
                                        float* partial, float* wgrad,
                                        void* stream) {
  const int C = chunks(D, vec);
  if (B < 1 || D < 1 || L < 1 || C == 0 || warps < 1 || warps > 32 ||
      grid < 1 || (vec != 4 && vec != 1) || (vec == 4 && D % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdKernel k = vec == 4 ? bwd_kernel<4>(C) : bwd_kernel<1>(C);
  const long long smem = (2LL + 2LL * warps) * L * D * sizeof(float);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(k), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  k<<<grid, 32 * warps, smem, s>>>(x, w, b, g, B, D, L, dx, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = 2 * L * D;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, s>>>(partial, grid, n,
                                                      wgrad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpurec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
