// Embedding row gather for the fused, layout-ordered table (kernel 1).
//
// Replaces tpurec/ops/embedding_pallas.py::embedding_gather_fused (the
// double-buffered row-DMA Pallas gather) together with the lookup around
// it on the serving path: nn/core.py::mixed_table_lookup and the
// Predictor's dequantisation (serve.py:202-206).  One launch turns ids
// [N, F] int32 into float32 rows [N, F, D]:
//
//   g      = ids[n, f] + offsets[f]                (int32, wraps like XLA)
//   row    = table[g] with jnp.take's rule over the field's row limit:
//            g in [-lim, 0) wraps to lim + g, anything else outside
//            [0, lim) gives the fill value (NaN for float rows, -128 for
//            int8 rows).  lim is the small-field prefix for small fields
//            when the layout has both kinds, else the table's row count,
//            which reproduces mixed_table_lookup's two gathers exactly.
//   scales (int8 tables): out = float(row) * scales[g], the scale taken
//            with the same rule over the whole table (fill NaN).
//
// Bound on the H100: bytes.  At D=16 a row is 64 B (f32), 32 B (bf16) or
// 16 B (int8), so one thread moves 16 bytes of a row with one vector
// load, converts, and writes its floats with 16-byte stores; neighbouring
// threads hold neighbouring pieces of a row, and a warp covers whole rows.
// The table stays in device memory and is never read out of bounds.  At
// the serving batch sizes the work is a few MB, so the launch, not the
// memory, bounds the time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ float fill_value() {
  return __int_as_float(0x7fc00000);  // NaN, as jnp.take fills float rows
}
template <>
__device__ __forceinline__ float fill_value<int8_t>() {
  return -128.0f;  // jnp.take fills int8 rows with the type's minimum
}

template <typename T, int VEC>
__global__ void gather_kernel(const T* __restrict__ table,
                              const float* __restrict__ scales,
                              const int* __restrict__ ids,
                              const int* __restrict__ offsets,
                              const int* __restrict__ limits,
                              long long n, int n_fields, int d,
                              int n_table_rows, float* __restrict__ out) {
  const int chunks = d / VEC;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= n * chunks) return;
  const long long i = t / chunks;  // flat (row, field) index
  const int c = static_cast<int>(t - i * chunks);
  const int f = static_cast<int>(i % n_fields);
  // int32 add with wrap-around (unsigned arithmetic has no overflow UB)
  const int g = static_cast<int>(static_cast<unsigned>(ids[i]) +
                                 static_cast<unsigned>(offsets[f]));
  const int lim = min(limits[f], n_table_rows);
  const int r = g < 0 ? g + lim : g;

  float vals[VEC];
  if (r >= 0 && r < lim) {
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(
        table + static_cast<long long>(r) * d + c * VEC);
#pragma unroll
    for (int k = 0; k < VEC; ++k) vals[k] = to_float(p.v[k]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) vals[k] = fill_value<T>();
  }
  if (scales != nullptr) {
    const int s = g < 0 ? g + n_table_rows : g;
    const float sc = (s >= 0 && s < n_table_rows) ? scales[s]
                                                  : __int_as_float(0x7fc00000);
#pragma unroll
    for (int k = 0; k < VEC; ++k) vals[k] *= sc;
  }
  float* dst = out + i * d + c * VEC;
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4)
      *reinterpret_cast<float4*>(dst + k) =
          make_float4(vals[k], vals[k + 1], vals[k + 2], vals[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) dst[k] = vals[k];
  }
}

template <typename T>
cudaError_t launch(const void* table, const float* scales, const int* ids,
                   const int* offsets, const int* limits, long long n,
                   int n_fields, int d, int n_table_rows, float* out,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);  // one 16-byte load per thread
  const bool vec_ok = d % kVec == 0 &&
                      reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int vec = vec_ok ? kVec : 1;
  const long long threads = n * (d / vec);
  const int block = 256;
  const long long grid = (threads + block - 1) / block;
  const T* tab = static_cast<const T*>(table);
  if (vec_ok)
    gather_kernel<T, kVec><<<grid, block, 0, stream>>>(
        tab, scales, ids, offsets, limits, n, n_fields, d, n_table_rows, out);
  else
    gather_kernel<T, 1><<<grid, block, 0, stream>>>(
        tab, scales, ids, offsets, limits, n, n_fields, d, n_table_rows, out);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 int8.  scales may be null.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int tpurec_embedding_gather(const void* table, int dtype,
                                       const float* scales, const int* ids,
                                       const int* offsets, const int* limits,
                                       long long n, int n_fields, int d,
                                       int n_table_rows, float* out,
                                       void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(table, scales, ids, offsets, limits, n, n_fields,
                           d, n_table_rows, out, s);
    case 1:
      return launch<__nv_bfloat16>(table, scales, ids, offsets, limits, n,
                                   n_fields, d, n_table_rows, out, s);
    case 2:
      return launch<int8_t>(table, scales, ids, offsets, limits, n, n_fields,
                            d, n_table_rows, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* tpurec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
