// Exact dense-Adam update of the embedding table: the full-table sweep
// (kernel 7) and, carried by the same pass, the sparse row step (kernel 6).
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
// Kernel 6 replaces fused_adam_pallas.py::fused_sparse_adam (_kernel):
// one pass over (p, m, v) in which each tile adds the gradients of its
// touched rows.  Here the touched rows ride in kernel 7's pass: a row
// with entries takes
//
//   u = coef * p + (sum of its entries' gradients, in sort order)
//
// in place of coef * p + g_small, the rule of the hybrid update, which
// sets the row correction over the swept row (hybrid.py:122-129).  Ids
// outside [0, V) touch nothing.  Outside the kernel, as the TPU function
// keeps them outside pallas_call, are one stable sort of the ids, giving
// (sid, order), and one searchsorted of the tiles' row bounds, giving for
// each 256-value tile t of the flat table the range [lo[t], hi[t]) of
// sorted entries whose rows meet it.  No sums of duplicates, no compact
// row buffers, no gather of the gradient rows: the kernel reads
// g[order[k]] where it needs it.
//
// Bound on the H100: bytes.  Each element reads p, m, v and writes them
// back: 16 B per element with bfloat16 moments (417 MB at 1,627,120 x 16,
// 0.124 ms at 3.35 TB/s), 24 B with float32 (625 MB, 0.187 ms); the rows
// add their gradients (64 KB at 1,024 ids of 16 values) and the ranges
// (0.8 MB of int32 at that table), 0.2% more.  The design is one
// grid-stride pass in which a thread moves 8 elements per step with
// 16-byte accesses (two float4 of p; two float4 or one 16-byte pack of 8
// bfloat16 per moment), so the loads are the widest the memory system
// serves.  A warp's step is one tile (32 lanes x 8 values, 16 rows at
// D=16); it reads the tile's range one step ahead, and almost every
// range is empty (1,024 ids over 101,700 tiles), which costs one
// broadcast load.  A non-empty range runs before the table's loads, so
// that its registers are not live beside them: the kernel keeps 4 blocks
// of 256 threads an SM (at most 64 registers, no spills), as kernel 7
// does; on an H100 80GB HBM3 at 700 W, 3 blocks cost 3% of the pass, 2
// cost 15%, and spilled registers 2.2x.
// Where D % 8 == 0 and D <= 32, the warp's 32 lanes load 32 entries'
// gradient rows at once into the warp's slice of shared memory (4 KB),
// and each lane then adds, in order, the staged rows whose row is its
// own; so a tile holding hundreds of entries of one row (every id equal)
// pays one memory latency per 32 of them.  Other D take each value's row
// apart and load each entry's values from device memory.  Sums run
// in the stable sort's order, batch order within a row: two calls give
// the same bits, and inf or NaN summed in order gives what the sum gives
// (inf, or NaN for inf - inf).  sum(p * p) is summed in double per
// thread and per block into a [grid] buffer, which a second one-block
// kernel adds up in a fixed order: deterministic, unlike a float atomic.
// (Doing that sum in the pass's last block, behind a counter, measured
// 1 us slower at the flagship's shape than the second launch, on the
// same card.)
//
// The plain versions are in tpurec_torch/ops/fused_adam.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;      // values a warp moves a step: 32 lanes x 8
constexpr int kStageD = 32;     // widest row the staged row step takes
constexpr int kRowsMinBlocks = 4; // blocks an SM with rows (<= 64 registers)

struct Adam {
  float lr, b1, omb1, b2, omb2, eps, coef, bc1, bc2;
};

// Kernel 6's touched rows: the N ids sorted stably (sid), each one's row
// of g [N, D] (order), and tile t's entries [lo[t], hi[t])
struct Rows {
  const long long* sid;
  const long long* order;
  const float* g;
  const int* lo;
  const int* hi;
  int D;
};

__device__ __forceinline__ void adam(const Adam& h, float p, float m,
                                     float v, float u, float& p2, float& m2,
                                     float& v2) {
  m2 = h.b1 * m + h.omb1 * u;
  v2 = h.b2 * v + h.omb2 * (u * u);
  p2 = p - h.lr * (m2 / h.bc1) / (sqrtf(v2 / h.bc2) + h.eps);
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

// gv = g[i .. i + 8), zero past n_g
__device__ __forceinline__ void load_g(const float* g, long long i,
                                       long long n_g, float (&gv)[8]) {
  if (i + 8 <= n_g) {
    load8(g + i, gv);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) gv[k] = i + k < n_g ? g[i + k] : 0.f;
  }
}

// Kernel 6's part of a warp's step.  The lane holds the values [i, i + 8)
// of the flat table (none when !in); its warp's tile has the sorted
// entries [a, b), a < b (the same on every lane).  Each value k whose row
// has entries takes, in gv[k], the sum of their gradients in sort order.
// Any D: each value's row and column apart, the 32 entries of a round
// broadcast by shuffles.
__device__ void row_grads(const Rows& r, long long i, bool in, int a, int b,
                          float (&gv)[8]) {
  const int lane = threadIdx.x & 31;
  const int D = r.D;
  // rows as offsets from the first row the tile meets; -1: no value
  const long long tile_row = (i - 8 * lane) / D;
  const long long row = i / D;
  const int c0 = static_cast<int>(i - row * D);
  const int rel0 = static_cast<int>(row - tile_row);
  int rel[8];                 // value k's column: c0 + k - (rel[k] - rel0) D
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    rel[k] = in ? rel0 + (c0 + k) / D : -1;
    acc[k] = -0.f;            // -0 + x == x for every x
  }
  unsigned hit = 0;
  for (int base = a; base < b; base += 32) {
    // 32 entries a round; s is the entry's row offset (-2: none)
    int s = -2, o = 0;
    if (base + lane < b) {
      s = static_cast<int>(r.sid[base + lane] - tile_row);
      o = static_cast<int>(r.order[base + lane]);
    }
    const int cnt = min(32, b - base);
    for (int q = 0; q < cnt; ++q) {
      const int sq = __shfl_sync(0xffffffffu, s, q);
      const long long gq =
          static_cast<long long>(__shfl_sync(0xffffffffu, o, q)) * D;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (sq == rel[k]) {
          acc[k] += r.g[gq + c0 + k - (rel[k] - rel0) * D];
          hit |= 1u << k;
        }
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (hit >> k & 1u) gv[k] = acc[k];
}

// The same for D % 8 == 0 and D <= kStageD: the 8 values lie in one row.
// Each round the warp's 32 lanes copy 32 entries' gradient rows at once
// into the warp's slice of shared memory (cp.async: no registers); then
// each lane adds, in order, the staged rows whose row is its own.
__device__ void row_grads_staged(const Rows& r, long long i, bool in, int a,
                                 int b, float (&gv)[8]) {
  __shared__ float4 stage[kThreads / 32][32 * kStageD / 4];
  __shared__ int stage_row[kThreads / 32][32];
  const int lane = threadIdx.x & 31;
  const int D = r.D;
  const int D4 = D / 4;
  float4* g4 = stage[threadIdx.x >> 5];
  int* srow = stage_row[threadIdx.x >> 5];
  const long long tile_row = (i - 8 * lane) / D;
  const long long row = i / D;
  const int rel = in ? static_cast<int>(row - tile_row) : -1;
  const int c4 = static_cast<int>(i - row * D) / 4;
  bool hit = false;
  for (int base = a; base < b; base += 32) {
    const int cnt = min(32, b - base);
    if (lane < cnt) {
      srow[lane] = static_cast<int>(r.sid[base + lane] - tile_row);
      const float* src = r.g + r.order[base + lane] * D;
      for (int j = 0; j < D4; ++j) {
        const unsigned dst = static_cast<unsigned>(
            __cvta_generic_to_shared(g4 + lane * D4 + j));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                     "l"(src + 4 * j)
                     : "memory");
      }
    } else {
      srow[lane] = -2;
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                     : "memory");
    __syncwarp();
    for (int q = 0; q < cnt; ++q) {
      if (srow[q] != rel) continue;
      if (!hit) {
#pragma unroll
        for (int k = 0; k < 8; ++k) gv[k] = -0.f;     // -0 + x == x
        hit = true;
      }
      const float4 x = g4[q * D4 + c4];
      const float4 y = g4[q * D4 + c4 + 1];
      gv[0] += x.x; gv[1] += x.y; gv[2] += x.z; gv[3] += x.w;
      gv[4] += y.x; gv[5] += y.y; gv[6] += y.z; gv[7] += y.w;
    }
    __syncwarp();
  }
}

// Kernel 7, and with ROWS (1: any D, 2: D % 8 == 0 and D <= kStageD)
// kernel 6 in the same pass.  n % 8 == 0; g holds the first n_g elements'
// gradients (n_g <= n).  With ROWS a warp steps while its tile starts
// inside the table, so that every lane takes part in the row step, which
// runs between the small-field gradient's load and the table's (its
// registers are not live beside the table's values), at kRowsMinBlocks
// blocks an SM, kernel 7's occupancy.
template <typename MT, int ROWS>
__global__ void __launch_bounds__(kThreads, ROWS != 0 ? kRowsMinBlocks : 1)
    decay_adam_kernel(float* __restrict__ p, MT* __restrict__ m,
                      MT* __restrict__ v, const float* __restrict__ g,
                      long long n, long long n_g, Adam h,
                      double* __restrict__ block_sumsq, Rows rows) {
  double acc = 0.0;
  const long long stride = 8LL * gridDim.x * blockDim.x;
  const int lane8 = 8 * (threadIdx.x & 31);
  long long i =
      8LL * (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
  int a = 0, b = 0;             // this step's tile range
  if constexpr (ROWS != 0) {
    if (i - lane8 < n) {
      a = rows.lo[(i - lane8) / kTile];
      b = rows.hi[(i - lane8) / kTile];
    }
  }
  for (; (ROWS != 0 ? i - lane8 : i) < n; i += stride) {
    const bool in = ROWS == 0 || i < n;
    float pv[8], mv[8], vv[8], gv[8];
    if constexpr (ROWS == 0) {
      load8(p + i, pv);
      load8(m + i, mv);
      load8(v + i, vv);
      load_g(g, i, n_g, gv);
    } else {
      if (in) load_g(g, i, n_g, gv);
      if (a < b) {
        if constexpr (ROWS == 2)
          row_grads_staged(rows, i, in, a, b, gv);
        else
          row_grads(rows, i, in, a, b, gv);
      }
      const long long next = i - lane8 + stride;
      a = b = 0;
      if (next < n) {
        a = rows.lo[next / kTile];
        b = rows.hi[next / kTile];
      }
      if (in) {
        load8(p + i, pv);
        load8(m + i, mv);
        load8(v + i, vv);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) pv[k] = mv[k] = vv[k] = gv[k] = 0.f;
      }
    }
    float p2[8], m2[8], v2[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc += static_cast<double>(pv[k] * pv[k]);
      adam(h, pv[k], mv[k], vv[k], h.coef * pv[k] + gv[k], p2[k], m2[k],
           v2[k]);
    }
    if (in) {
      store8(p + i, p2);
      store8(m + i, m2);
      store8(v + i, v2);
    }
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

template <int ROWS>
void launch(int bf16, int grid, cudaStream_t s, float* p, void* m, void* v,
            const float* g, long long n, long long n_g, const Adam& h,
            double* block_sumsq, const Rows& rows) {
  if (bf16)
    decay_adam_kernel<__nv_bfloat16, ROWS><<<grid, kThreads, 0, s>>>(
        p, static_cast<__nv_bfloat16*>(m), static_cast<__nv_bfloat16*>(v), g,
        n, n_g, h, block_sumsq, rows);
  else
    decay_adam_kernel<float, ROWS><<<grid, kThreads, 0, s>>>(
        p, static_cast<float*>(m), static_cast<float*>(v), g, n, n_g, h,
        block_sumsq, rows);
}

}  // namespace

// Kernel 7, carrying kernel 6 when sid is not null.  p [n] float32, m and
// v [n] float32 (bf16 = 0) or bfloat16 (bf16 = 1), all 16-byte aligned
// with n % 8 == 0; g [n_g] float32.  block_sumsq is [grid] double
// scratch, sumsq one float.  The constants come from the host: omb1 = 1 -
// b1, omb2 = 1 - b2, bc1 = 1 - b1^t, bc2 = 1 - b2^t.
//
// The rows (or all null): sid [N] the ids sorted stably, order [N] each
// one's row in g_rows [N, D] (16-byte aligned), n = V * D, and bounds
// [2, T] int32, T = ceil(n / 256): bounds[t] and bounds[T + t] are the
// first entries with sid >= floor(256 t / D) and sid >= min(V,
// ceil(256 (t + 1) / D)).  Returns the cudaError_t of the launches.
extern "C" int tpurec_decay_adam(float* p, void* m, void* v, int bf16,
                                 const float* g, long long n, long long n_g,
                                 float lr, float b1, float omb1, float b2,
                                 float omb2, float eps, float coef,
                                 float bc1, float bc2, int grid,
                                 double* block_sumsq, float* sumsq,
                                 const long long* sid,
                                 const long long* order,
                                 const float* g_rows, const int* bounds,
                                 int D, void* stream) {
  if (n % 8 != 0 || n_g > n || n_g < 0 || grid < 1 ||
      (sid != nullptr && (order == nullptr || g_rows == nullptr ||
                          bounds == nullptr || D < 1 || n % D != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
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
  const long long T = (n + kTile - 1) / kTile;
  const Rows rows{sid, order, g_rows, bounds,
                  bounds == nullptr ? nullptr : bounds + T, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sid == nullptr)
    launch<0>(bf16, grid, s, p, m, v, g, n, n_g, h, block_sumsq, rows);
  else if (D % 8 == 0 && D <= kStageD)
    launch<2>(bf16, grid, s, p, m, v, g, n, n_g, h, block_sumsq, rows);
  else
    launch<1>(bf16, grid, s, p, m, v, g, n, n_g, h, block_sumsq, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_sumsq_kernel<<<1, kThreads, 0, s>>>(block_sumsq, grid, sumsq);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpurec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
