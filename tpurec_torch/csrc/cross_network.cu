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
// The rewrite both kernels run on: with c_l = x0 . w_l, e_l = bsum_l .
// w_l and bsum_l = b_0 + ... + b_{l-1} (bsum_0 = 0),
//
//   x_l = x0 (1 + S_l) + bsum_l,  S_l = s_0 + ... + s_{l-1}
//   s_l = x_l . w_l = (1 + S_l) c_l + e_l
//
// so a row's L dot products s_l follow by a scalar recurrence from the L
// dot products c_l of the row itself and L - 1 row-independent e_l.  This
// rounds differently from the recurrence (the checks hold the forward to
// 1e-5 of the output's scale).  A row holding NaN is NaN throughout, as
// in the recurrence.  A row holding +inf may part from it, a difference
// kept on purpose: with x0[j] = +inf, c_l is inf with the sign of w_l[j],
// and where w_l[j] > 0 for every l >= 1, S_L stays +-inf and the forward
// gives the row +-inf (NaN only where x0 is 0), where the recurrence's
// dot products of mixed-sign infinities give NaN throughout; elsewhere
// both give NaN throughout.  No other row is touched.
//
// Forward design (cross_fwd_kernel, kernel 8): a warp takes K rows (1,
// or 2 where a lane's share of a row is at most 4 chunks: the host takes
// 2 only where the blocks still fill the card), W warps a block.  A lane
// holds its share of each row in registers (C chunks of VEC floats:
// 16-byte loads when D % 4 == 0 and the tensors are 16-byte aligned,
// scalar loads otherwise) and owns the same elements of every row, so
// it reads its elements of w_l and b_l straight into registers
// through the read-only path, with no shared memory and no barrier, a
// group of layers at a time: a group's loads are all in flight at once,
// issued after the rows', and one butterfly reduces the group's K G sums
// c_l and its e_l together; the lane then carries the scalar recurrence
// on.  After the last group it writes
//
//   out = x0 (1 + S_L) + bsum_L
//
// elementwise.  At L = kFixedLayers (3, the models' n_cross_layers) a
// variant of its own takes all the layers in one group, unguarded; any
// other L runs with L a runtime argument, kLayerGroup (3) layers a group
// (the backward takes at most kMaxLayers).  The runtime-L variant at L =
// 3 took 0.0030 ms against the fixed one's 0.0025 at B=512 and 0.0047
// against 0.0045 at B=4096 (scripts/time_kernels.py, in turns, H100 80GB
// HBM3 at 700 W), so the fixed variant stays; a template parameter for
// every L from 1 to 8 doubled the build time.

// Backward design (cross_bwd_kernel, kernel 9), one launch.  A warp
// carries K = 2 rows at a time where a lane's share of a row is at most
// 4 chunks, else 1.  The backward's L dot
// products g_l . x0 and the forward's s_l are not taken one after
// another: with q = g . x0, besides the rewrite above,
//
//   dxw_{L-1} = q,  dxw_{l-1} = dxw_l (1 + c_l)   (g_{l-1} . x0 =
//                                                  dxw_l + dxw_l c_l)
//
// so a row needs one warp reduction, of its L + 1 dot products (the K
// rows' and the L - 1 e_l in one butterfly), and scalar recurrences; the
// rest is elementwise (the checks hold dx to 1e-5 and dw, db to 1e-4 of
// their scales).  A lane always owns the same elements of every row, so it
// adds its rows' dw and db terms (summed over its K rows in registers)
// into its warp's [2, L, D] slice of shared memory with no race.  The
// block sums its warps' slices in order; the blocks of a thread-block
// cluster (kCluster of them) sum those over distributed shared memory in
// rank order, each block a share of the elements, into the cluster's slice
// of a [clusters, 2, L, D] partial buffer (70 KB at the DCN step's B=512);
// the block whose count completes the grid (a counter it resets itself,
// after __threadfence) marks its cluster, whose blocks then sum the
// clusters' slices in order into dw and db.  No float atomics: two calls
// give the same bits, and a launch keeps no state between calls (it may be
// captured in a CUDA graph).  Only rows < B are read; a real row that
// holds NaN puts NaN into dw and db, as JAX's masked `where` does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxChunks = 8;   // C <= 8: D <= 32 * 8 * VEC
constexpr int kMaxLayers = 8;   // layers the backward takes, at most
constexpr int kLayerGroup = 3;  // layers a forward butterfly takes, any L
constexpr int kFixedLayers = 3; // the models' L, a forward variant of its own
constexpr int kMaxFwdWarps = 8; // warps of a forward block, at most
constexpr int kMaxBwdWarps = 8; // warps of a backward block, at most
constexpr int kCluster = 8;     // blocks of a backward cluster (portable)
constexpr int kMaxClusters = 16; // backward clusters, at most

template <int VEC>
struct Vec;

template <>
struct Vec<4> {
  using T = float4;
  __device__ static T load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static T ldg(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Vec<1> {
  using T = float;
  __device__ static T load(const float* p) { return *p; }
  __device__ static T ldg(const float* p) { return __ldg(p); }
  __device__ static void store(float* p, T v) { *p = v; }
};

// A load through L2 only (what other blocks of this launch wrote)
template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T ldcg(const float* p);
template <>
__device__ __forceinline__ float ldcg<1>(const float* p) {
  return __ldcg(p);
}
template <>
__device__ __forceinline__ float4 ldcg<4>(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float dot(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ float dot(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// x * s + b, component-wise
__device__ __forceinline__ float fma_vec(float x, float s, float b) {
  return fmaf(x, s, b);
}
__device__ __forceinline__ float4 fma_vec(float4 x, float s, float4 b) {
  return make_float4(fmaf(x.x, s, b.x), fmaf(x.y, s, b.y), fmaf(x.z, s, b.z),
                     fmaf(x.w, s, b.w));
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

// Rows a warp carries at a time: 2 while a lane's share of a row is at
// most 4 chunks (its registers then hold both rows), else 1
__host__ __device__ constexpr int rows_per_warp(int C) {
  return C <= 4 ? 2 : 1;
}

// Start copying src [n] into shared memory by cp.async, VEC floats a copy
// (16-byte aligned when VEC is 4); cp_async_wait_all() and a barrier make
// it visible
template <int VEC>
__device__ __forceinline__ void stage_async(const float* __restrict__ src,
                                            int n, float* dst) {
  for (int i = threadIdx.x * VEC; i < n; i += blockDim.x * VEC) {
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    if (VEC == 4)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                   "l"(src + i)
                   : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                   "l"(src + i)
                   : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Kernel 8's layers l0 .. l0 + G - 1 (those < L) for a lane's K rows x0:
// loads the lane's elements of their w_l and b_l (after the rows'), one
// butterfly for the rows' sums c_l and the layers' e_l, then the scalar
// recurrence, carrying bs (the lane's elements of bsum_l) and each row's
// S on.  EXACT: the group is all the layers (l0 = 0, L = G), so e_0 = 0
// takes no slot and nothing is guarded.
template <int VEC, int C, int K, int G, bool EXACT>
__device__ __forceinline__ void fwd_layers(
    const typename Vec<VEC>::T (&x0)[K][C], const float* __restrict__ w,
    const float* __restrict__ b, int D, int l0, int L,
    typename Vec<VEC>::T (&bs)[C], float (&S)[K]) {
  using T = typename Vec<VEC>::T;
  constexpr int E0 = EXACT ? 1 : 0;     // the first layer with an e slot
  constexpr int NV = K * G + G - E0;    // the rows' c_l, then the e_l
  const int lane = threadIdx.x & 31;
  T wl[G][C], bl[G][C];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = elem<VEC>(c, lane, D);
      const bool ok = i >= 0 && (EXACT || l0 + j < L);
      wl[j][c] = ok ? Vec<VEC>::ldg(w + (l0 + j) * D + i) : zero<T>();
      bl[j][c] = ok ? Vec<VEC>::ldg(b + (l0 + j) * D + i) : zero<T>();
    }
  float v[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    T s = bs[c];
#pragma unroll
    for (int j = 0; j < G; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        v[k * G + j] = dot(x0[k][c], wl[j][c], v[k * G + j]);
      if (j >= E0) v[K * G + j - E0] = dot(s, wl[j][c], v[K * G + j - E0]);
      if (EXACT || l0 + j < L) s = add(s, bl[j][c]);
    }
    bs[c] = s;
  }
  // one butterfly for all of them, each sum in the same order on every
  // lane
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < NV; ++j)
      v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
#pragma unroll
  for (int j = 0; j < G; ++j)
    if (EXACT || l0 + j < L)
#pragma unroll
      for (int k = 0; k < K; ++k)
        S[k] += fmaf(1.f + S[k], v[k * G + j],
                     j >= E0 && l0 + j > 0 ? v[K * G + j - E0] : 0.f);
}

// Kernel 8.  Warp w of block b takes rows (b W + w) K .. + K - 1 (those
// < B), W = blockDim.x / 32.  LF > 0: L == LF, all the layers in one
// butterfly; LF == 0: any L, kLayerGroup layers a butterfly.
template <int VEC, int C, int K, int LF>
__global__ void __launch_bounds__(32 * kMaxFwdWarps)
    cross_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, int B, int D, int L,
                     float* __restrict__ out) {
  using T = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
       (threadIdx.x >> 5)) * K;
  if (row0 >= B) return;
  T x0[K][C];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = elem<VEC>(c, lane, D);
      x0[k][c] = row0 + k < B && i >= 0
                     ? Vec<VEC>::load(x + (row0 + k) * D + i)
                     : zero<T>();
    }
  T bs[C];                              // the lane's elements of bsum_l
  float S[K];                           // each row's S_l, then S_L
#pragma unroll
  for (int c = 0; c < C; ++c) bs[c] = zero<T>();
#pragma unroll
  for (int k = 0; k < K; ++k) S[k] = 0.f;
  if constexpr (LF > 0) {
    fwd_layers<VEC, C, K, LF, true>(x0, w, b, D, 0, LF, bs, S);
  } else {
#pragma unroll 1
    for (int l0 = 0; l0 < L; l0 += kLayerGroup)
      fwd_layers<VEC, C, K, kLayerGroup, false>(x0, w, b, D, l0, L, bs, S);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float* orow = out + (row0 + k) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = elem<VEC>(c, lane, D);
      if (row0 + k < B && i >= 0)
        Vec<VEC>::store(orow + i, fma_vec(x0[k][c], 1.f + S[k], bs[c]));
    }
  }
}

// The backward block's shared memory, in floats: w [L, D]; bsum [L, D]
// (bsum_l = b_0 + ... + b_{l-1}; bsum_0 = 0); each warp's dw/db slice [2,
// L, D]; each warp's dot-product totals [32]; each of its K rows' scalars
// s_l, 1 + S_l and dxw_l [3 kMaxLayers].
struct BwdLayout {
  long long bs, slices, slice, tot, sc;
  __host__ __device__ BwdLayout(int D, int L, int W, int K) {
    const long long n = static_cast<long long>(L) * D;
    bs = n;
    slices = 2 * n;
    slice = 2 * n;
    tot = slices + W * slice;
    sc = tot + 32LL * W;
    bytes_ = 4 * (sc + static_cast<long long>(W) * K * 3 * kMaxLayers);
  }
  long long bytes_;
  __host__ __device__ long long bytes() const { return bytes_; }
};

// Kernel 9.  Block b's warp w takes rows (b*W + w)*K .. + K - 1, then a
// grid's stride on.  cpart is [gridDim.x / kCluster, 2, L, D] when there
// is more than one cluster.
template <int VEC, int C>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(32 * kMaxBwdWarps, 1)
    cross_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, const float* __restrict__ g,
                     int B, int D, int L, float* __restrict__ dx,
                     float* __restrict__ cpart, unsigned* counter,
                     float* __restrict__ wgrad) {
  using T = typename Vec<VEC>::T;
  constexpr int K = rows_per_warp(C);
  constexpr int Q = kMaxLayers + 1;     // a row's dot products: c_l, then q
  constexpr int NV = K * Q + kMaxLayers - 1;  // and the e_l
  extern __shared__ float4 smem4[];
  __shared__ bool last;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = L * D;
  const int W = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const BwdLayout lay(D, L, W, K);
  float* sw = reinterpret_cast<float*>(smem4);   // w [L, D]
  float* bs = sw + lay.bs;                       // bsum [L, D]
  float* part = sw + lay.slices;                 // warp slices; block's
  float* mine = part + warp * lay.slice;         // dw [L, D], db [L, D]
  float* tot = sw + lay.tot + 32 * warp;   // this warp's NV totals
  float* scal = sw + lay.sc + warp * K * 3 * kMaxLayers;
  if (threadIdx.x == 0) last = false;

  // rows row0 .. row0 + K - 1 (those < B) into x0 and gr
  bool ok[K];
  T x0[K][C], gr[K][C];
  auto load_rows = [&](long long row0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ok[k] = row0 + k < B;
      const long long r = (row0 + k) * D;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int i = elem<VEC>(c, lane, D);
        x0[k][c] = ok[k] && i >= 0 ? Vec<VEC>::load(x + r + i) : zero<T>();
        gr[k][c] = ok[k] && i >= 0 ? Vec<VEC>::load(g + r + i) : zero<T>();
      }
    }
  };
  // the first rows load while w and b arrive
  const long long stride = static_cast<long long>(gridDim.x) * W * K;
  long long row0 = (static_cast<long long>(blockIdx.x) * W + warp) * K;
  load_rows(row0);
  stage_async<VEC>(w, n, sw);
  stage_async<VEC>(b, n - D, bs + D);
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = elem<VEC>(c, lane, D);
      if (i < 0) continue;
      Vec<VEC>::store(mine + l * D + i, zero<T>());
      Vec<VEC>::store(mine + n + l * D + i, zero<T>());
    }
  cp_async_wait_all();
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float a = 0.f;
    bs[i] = 0.f;
    for (int l = 1; l < L; ++l) {
      a += bs[l * D + i];
      bs[l * D + i] = a;
    }
  }
  __syncthreads();

  for (; row0 < B; row0 += stride) {
    // (1) every dot product of the K rows in one reduction: c_l = x0 .
    // w_l at [k Q + l], q = g . x0 at [k Q + kMaxLayers], e_l = bsum_l .
    // w_l at [K Q + l - 1]
    {
      float v[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) v[j] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int e = elem<VEC>(c, lane, D);
        const int i = e < 0 ? 0 : e;
#pragma unroll
        for (int k = 0; k < K; ++k)
          v[k * Q + kMaxLayers] = dot(gr[k][c], x0[k][c],
                                      v[k * Q + kMaxLayers]);
#pragma unroll
        for (int l = 0; l < kMaxLayers; ++l) {
          if (l < L) {
            T wl = Vec<VEC>::load(sw + l * D + i);
            if (e < 0) wl = zero<T>();
#pragma unroll
            for (int k = 0; k < K; ++k)
              v[k * Q + l] = dot(x0[k][c], wl, v[k * Q + l]);
            if (l > 0)
              v[K * Q + l - 1] =
                  dot(Vec<VEC>::load(bs + l * D + i), wl, v[K * Q + l - 1]);
          }
        }
      }
      // one butterfly for all of them, each sum in the same order on
      // every lane
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < NV; ++j)
          v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
      if (lane == 0)
#pragma unroll
        for (int j = 0; j < NV; ++j) tot[j] = v[j];
    }
    __syncwarp();
    // (2) each row's scalars, lane k for row k: s_l = x_l . w_l = (1 +
    // S_l) c_l + e_l with S_l = s_0 + ... + s_{l-1} (x_l = x0 (1 + S_l) +
    // bsum_l), and dxw_{L-1} = q, dxw_{l-1} = dxw_l (1 + c_l) (g_{l-1} =
    // g_l + dxw_l w_l, so g_{l-1} . x0 = dxw_l + dxw_l c_l)
    if (lane < K) {
      const float* t = tot + lane * Q;
      float* s = scal + lane * 3 * kMaxLayers;
      float S = 0.f;
      for (int l = 0; l < L; ++l) {
        const float sl = fmaf(1.f + S, t[l], l > 0 ? tot[K * Q + l - 1] : 0.f);
        s[l] = sl;
        s[kMaxLayers + l] = 1.f + S;
        S += sl;
      }
      float d = t[kMaxLayers];
      for (int l = L - 1; l >= 0; --l) {
        s[2 * kMaxLayers + l] = d;
        d *= 1.f + t[l];
      }
    }
    __syncwarp();
    // (3) layers backwards: dw[l] += dxw_l x_l, db[l] += g_l, dx0_extra
    // += s_l g_l, g_{l-1} = g_l + dxw_l w_l, row by row in order; a lane's
    // K rows summed in registers, then added to its warp's slice
    T ex[K][C];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int c = 0; c < C; ++c) ex[k][c] = zero<T>();
    for (int l = L - 1; l >= 0; --l) {
      float sl[K], al[K], dl[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        sl[k] = scal[k * 3 * kMaxLayers + l];
        al[k] = scal[k * 3 * kMaxLayers + kMaxLayers + l];
        dl[k] = scal[k * 3 * kMaxLayers + 2 * kMaxLayers + l];
      }
      float* dw = mine + l * D;
      float* db = mine + n + l * D;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int e = elem<VEC>(c, lane, D);
        const int i = e < 0 ? 0 : e;
        const T wl = Vec<VEC>::load(sw + l * D + i);
        const T bl = Vec<VEC>::load(bs + l * D + i);
        T dwc = Vec<VEC>::load(dw + i);
        T dbc = Vec<VEC>::load(db + i);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (ok[k]) {
            dbc = add(dbc, gr[k][c]);
            dwc = axpy(dwc, dl[k], l == 0 ? x0[k][c]
                                          : fma_vec(x0[k][c], al[k], bl));
          }
          ex[k][c] = axpy(ex[k][c], sl[k], gr[k][c]);
          gr[k][c] = axpy(gr[k][c], dl[k], wl);
        }
        if (e >= 0) {
          Vec<VEC>::store(db + i, dbc);
          Vec<VEC>::store(dw + i, dwc);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!ok[k]) continue;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int e = elem<VEC>(c, lane, D);
        if (e >= 0)
          Vec<VEC>::store(dx + (row0 + k) * D + e, add(gr[k][c], ex[k][c]));
      }
    }
    __syncwarp();
    if (row0 + stride < B) load_rows(row0 + stride);
  }

  // the block's partial: its warps' slices summed in order, into slice 0
  __syncthreads();
  for (int e = threadIdx.x * VEC; e < 2 * n; e += blockDim.x * VEC) {
    T v[kMaxBwdWarps];
#pragma unroll
    for (int k = 0; k < kMaxBwdWarps; ++k)
      if (k < W) v[k] = Vec<VEC>::load(part + k * lay.slice + e);
    T sum = v[0];
#pragma unroll
    for (int k = 1; k < kMaxBwdWarps; ++k)
      if (k < W) sum = add(sum, v[k]);
    Vec<VEC>::store(part + e, sum);
  }
  // the cluster's partial: its blocks' partials summed in rank order, each
  // block a share [e0, e1) of the elements, read over distributed shared
  // memory; with one cluster, that is dw and db
  cluster.sync();
  const int n_cl = gridDim.x / kCluster;
  const int share = ((2 * n + kCluster - 1) / kCluster + VEC - 1) / VEC * VEC;
  const int e0 = static_cast<int>(cluster.block_rank()) * share;
  const int e1 = min(2 * n, e0 + share);
  {
    const float* peer[kCluster];
#pragma unroll
    for (int q = 0; q < kCluster; ++q)
      peer[q] = cluster.map_shared_rank(part, q);
    float* out = n_cl == 1 ? wgrad
                           : cpart + static_cast<long long>(
                                         blockIdx.x / kCluster) * 2 * n;
    for (int e = e0 + threadIdx.x * VEC; e < e1; e += blockDim.x * VEC) {
      T v[kCluster];
#pragma unroll
      for (int q = 0; q < kCluster; ++q) v[q] = Vec<VEC>::load(peer[q] + e);
      T sum = v[0];
#pragma unroll
      for (int q = 1; q < kCluster; ++q) sum = add(sum, v[q]);
      Vec<VEC>::store(out + e, sum);
    }
  }
  if (n_cl > 1) {
    // the block whose count completes the grid's marks its cluster the
    // last: that cluster sums the clusters' partials
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0 &&
        atomicAdd(counter, 1u) == gridDim.x - 1) {
      *counter = 0u;
#pragma unroll
      for (int q = 0; q < kCluster; ++q)
        *cluster.map_shared_rank(&last, q) = true;
    }
  }
  cluster.sync();                 // the peers are done reading this block
  if (!last) return;
  for (int e = e0 + threadIdx.x * VEC; e < e1; e += blockDim.x * VEC) {
    T v[kMaxClusters];
#pragma unroll
    for (int q = 0; q < kMaxClusters; ++q)
      if (q < n_cl) v[q] = ldcg<VEC>(cpart + q * 2LL * n + e);
    T sum = v[0];
#pragma unroll
    for (int q = 1; q < kMaxClusters; ++q)
      if (q < n_cl) sum = add(sum, v[q]);
    Vec<VEC>::store(wgrad + e, sum);
  }
}

// The launch floors beside kernels 8 and 9: empty kernels launched as
// they are (kernel 9's: its grid, cluster, block and dynamic shared
// memory)
__global__ void empty_kernel() {}
__global__ void __cluster_dims__(kCluster, 1, 1) empty_cluster_kernel() {}

typedef void (*FwdKernel)(const float*, const float*, const float*, int, int,
                          int, float*);
typedef void (*BwdKernel)(const float*, const float*, const float*,
                          const float*, int, int, int, float*, float*,
                          unsigned*, float*);

// K is 1 or rows_per_warp(C); L of kFixedLayers takes its own variant
template <int VEC, int C, int K>
FwdKernel fwd_kernel_l(int L) {
  return L == kFixedLayers ? cross_fwd_kernel<VEC, C, K, kFixedLayers>
                           : cross_fwd_kernel<VEC, C, K, 0>;
}

template <int VEC, int C>
FwdKernel fwd_kernel_k(int K, int L) {
  if (K == 1) return fwd_kernel_l<VEC, C, 1>(L);
  if (K == rows_per_warp(C)) return fwd_kernel_l<VEC, C, rows_per_warp(C)>(L);
  return nullptr;
}

template <int VEC>
FwdKernel fwd_kernel(int C, int K, int L) {
  switch (C) {
    case 1: return fwd_kernel_k<VEC, 1>(K, L);
    case 2: return fwd_kernel_k<VEC, 2>(K, L);
    case 3: return fwd_kernel_k<VEC, 3>(K, L);
    case 4: return fwd_kernel_k<VEC, 4>(K, L);
    case 5: return fwd_kernel_k<VEC, 5>(K, L);
    case 6: return fwd_kernel_k<VEC, 6>(K, L);
    case 7: return fwd_kernel_k<VEC, 7>(K, L);
    case 8: return fwd_kernel_k<VEC, 8>(K, L);
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

// x [B, D], w and b [L, D] -> out [B, D].  vec is 4 (D % 4 ==
// 0, 16-byte aligned tensors) or 1; a block is `warps` warps, a warp
// takes `rows` rows (1, or tpurec_cross_network_rows_per_warp).  Returns
// the cudaError_t of the launch.
extern "C" int tpurec_cross_network_fwd(const float* x, const float* w,
                                        const float* b, int B, int D, int L,
                                        int vec, int warps, int rows,
                                        float* out, void* stream) {
  const int C = chunks(D, vec);
  if (B < 0 || D < 1 || L < 1 || C == 0 || warps < 1 ||
      warps > kMaxFwdWarps || (vec != 4 && vec != 1) ||
      (vec == 4 && D % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdKernel k =
      vec == 4 ? fwd_kernel<4>(C, rows, L) : fwd_kernel<1>(C, rows, L);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int per_block = warps * rows;
  k<<<(B + per_block - 1) / per_block, 32 * warps, 0,
      static_cast<cudaStream_t>(stream)>>>(x, w, b, B, D, L, out);
  return static_cast<int>(cudaGetLastError());
}

// Rows a warp of either kernel carries at a time for a row of D at
// vec-float loads (0 when D is over kMaxChunks chunks a lane)
extern "C" int tpurec_cross_network_rows_per_warp(int D, int vec) {
  const int C = chunks(D, vec);
  return C == 0 ? 0 : rows_per_warp(C);
}

// Shared memory of one backward block of `warps` warps, in bytes
extern "C" long long tpurec_cross_network_bwd_smem_bytes(int D, int L,
                                                         int vec, int warps) {
  return BwdLayout(D, L, warps,
                   tpurec_cross_network_rows_per_warp(D, vec)).bytes();
}

// The backward, one launch: x [B, D] (the forward's input), w, b [L, D]
// (L <= 8) and g [B, D] -> dx [B, D] and wgrad [2, L, D] (dw, then db).
// grid is a multiple of kCluster (8) blocks of `warps` warps; partial is
// [grid / 8, 2, L, D] scratch (unused with one cluster); counter is one
// unsigned int that is 0 before the launch (the launch leaves it 0).
extern "C" int tpurec_cross_network_bwd(const float* x, const float* w,
                                        const float* b, const float* g,
                                        int B, int D, int L, int vec,
                                        int warps, int grid, float* dx,
                                        float* partial, unsigned* counter,
                                        float* wgrad, void* stream) {
  const int C = chunks(D, vec);
  if (B < 1 || D < 1 || L < 1 || L > kMaxLayers || C == 0 || warps < 1 ||
      warps > kMaxBwdWarps || grid < kCluster || grid % kCluster != 0 ||
      grid / kCluster > kMaxClusters || (vec != 4 && vec != 1) ||
      (vec == 4 && D % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdKernel k = vec == 4 ? bwd_kernel<4>(C) : bwd_kernel<1>(C);
  const long long smem =
      tpurec_cross_network_bwd_smem_bytes(D, L, vec, warps);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(k), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, b, g, B, D, L, dx, partial, counter, wgrad);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel launched as kernel 9 is (grid a multiple of 8, a
// cluster of 8, `threads` threads and `smem` bytes of dynamic shared
// memory): the floor under kernel 9's device time.
extern "C" int tpurec_cross_network_empty(int grid, int threads,
                                          long long smem, void* stream) {
  if (grid < kCluster || grid % kCluster != 0 || threads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(empty_cluster_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  empty_cluster_kernel<<<grid, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel launched as kernel 8 is (`grid` blocks of `threads`
// threads, no shared memory): the floor under kernel 8's device time.
extern "C" int tpurec_cross_network_empty_fwd(int grid, int threads,
                                              void* stream) {
  if (grid < 1 || threads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  empty_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpurec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
