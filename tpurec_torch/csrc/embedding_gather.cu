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
// Bound on the H100: bytes (ids in, the rows read, float32 rows out).  A
// row of D=16 is 64 B (f32), 32 B (bf16) or 16 B (int8); a "piece" is 16
// bytes of a row, one vector load, and neighbouring lanes hold
// neighbouring pieces, so one warp-wide load covers whole rows.  The
// latency of a random row read is what bounds a gather this small, so a
// thread takes kUnroll pieces kBlock apart: it issues the id loads of all
// of them, then all their row loads, and only then converts and stores,
// which keeps kUnroll independent 16-byte reads in flight per thread (of
// 1, 2, 4 and 8, 2 ran fastest on the H100 at B=512 and 4096; more leaves
// too few blocks).  Index arithmetic is 32-bit, with no 64-bit division
// per piece (the wrapper refuses more than 2^31 pieces).
//
// The host side is a prepared plan (GatherPlan): the table's type, width
// and row count and the per-field offset/limit arrays are checked and
// fixed once, and a launch passes only the ids, their row count, the
// output, the table pointer (the training step updates the table in
// place, and a caller may move it) and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kUnroll = 2;

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

// Pieces base + u * kBlock for u < kUnroll, base = blockIdx.x * kBlock *
// kUnroll + threadIdx.x; piece i is chunk i % chunks of (row, field) pair
// i / chunks.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBlock)
    gather_kernel(const T* __restrict__ table,
                  const float* __restrict__ scales,
                  const int* __restrict__ ids,
                  const int* __restrict__ offsets,
                  const int* __restrict__ limits, unsigned n_pieces,
                  unsigned n_fields, unsigned chunks, int d,
                  int n_table_rows, float* __restrict__ out) {
  const unsigned base = blockIdx.x * static_cast<unsigned>(kBlock * kUnroll) +
                        threadIdx.x;
  unsigned pair[kUnroll], chunk[kUnroll];
  int g[kUnroll], lim[kUnroll];
  bool live[kUnroll];
  // 1. each piece's id and its field's offset and limit
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned i = base + u * kBlock;
    live[u] = i < n_pieces;
    pair[u] = i / chunks;
    chunk[u] = i - pair[u] * chunks;
    const unsigned f = pair[u] % n_fields;
    // int32 add with wrap-around (unsigned arithmetic has no overflow UB)
    g[u] = live[u] ? static_cast<int>(static_cast<unsigned>(ids[pair[u]]) +
                                      static_cast<unsigned>(offsets[f]))
                   : 0;
    lim[u] = live[u] ? min(limits[f], n_table_rows) : 0;
  }
  // 2. the row pieces (and scales), all in flight together
  Pack<T, VEC> p[kUnroll];
  bool ok[kUnroll];
  float sc[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int r = g[u] < 0 ? g[u] + lim[u] : g[u];
    ok[u] = r >= 0 && r < lim[u];
    if (ok[u])
      p[u] = *reinterpret_cast<const Pack<T, VEC>*>(
          table + static_cast<long long>(r) * d + chunk[u] * VEC);
    if (scales != nullptr) {
      const int s = g[u] < 0 ? g[u] + n_table_rows : g[u];
      sc[u] = (live[u] && s >= 0 && s < n_table_rows)
                  ? scales[s]
                  : __int_as_float(0x7fc00000);
    }
  }
  // 3. convert and store
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (!live[u]) continue;
    float vals[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      vals[k] = ok[u] ? to_float(p[u].v[k]) : fill_value<T>();
    if (scales != nullptr) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) vals[k] *= sc[u];
    }
    float* dst = out + static_cast<long long>(pair[u]) * d + chunk[u] * VEC;
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
}

}  // namespace

// What a launch needs besides the ids: fixed when the gather is prepared.
// dtype: 0 float32, 1 bfloat16, 2 int8.  scales may be null.
struct GatherPlan {
  const float* scales;
  const int* offsets;
  const int* limits;
  int dtype;
  int n_fields;
  int d;
  int n_table_rows;
};

namespace {

template <typename T>
cudaError_t launch(const GatherPlan& pl, const void* table, const int* ids,
                   long long n, float* out, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);  // one 16-byte load per piece
  const bool vec_ok = pl.d % kVec == 0 &&
                      reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int vec = vec_ok ? kVec : 1;
  const long long pieces = n * pl.n_fields * (pl.d / vec);
  if (pieces > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(
      (pieces + kBlock * kUnroll - 1) / (kBlock * kUnroll));
  const T* tab = static_cast<const T*>(table);
  if (vec_ok)
    gather_kernel<T, kVec><<<grid, kBlock, 0, stream>>>(
        tab, pl.scales, ids, pl.offsets, pl.limits,
        static_cast<unsigned>(pieces), pl.n_fields, pl.d / kVec, pl.d,
        pl.n_table_rows, out);
  else
    gather_kernel<T, 1><<<grid, kBlock, 0, stream>>>(
        tab, pl.scales, ids, pl.offsets, pl.limits,
        static_cast<unsigned>(pieces), pl.n_fields, pl.d, pl.d,
        pl.n_table_rows, out);
  return cudaGetLastError();
}

}  // namespace

// ids [n, plan->n_fields] int32 -> out [n, n_fields, d] float32 rows of
// the [n_table_rows, d] table.  Returns the cudaError_t of the launch (0
// on success).
extern "C" int tpurec_embedding_gather(const GatherPlan* plan,
                                       const void* table, const int* ids,
                                       long long n, float* out,
                                       void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (plan->dtype) {
    case 0:
      return launch<float>(*plan, table, ids, n, out, s);
    case 1:
      return launch<__nv_bfloat16>(*plan, table, ids, n, out, s);
    case 2:
      return launch<int8_t>(*plan, table, ids, n, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* tpurec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
