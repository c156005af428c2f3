// Field-attention stack: forward (kernel 2, eval and training) and its
// backward (kernel 3); one attention layer: forward (kernel 4) and its
// backward (kernel 5), described where they are defined below.
//
// Replaces tpurec/ops/attention_pallas.py::fused_field_attention: the
// forward _fwd_kernel (run by _run_fwd) and the backward _bwd_kernel (run
// by _run_bwd through the custom VJP _ffa_bwd):
//
//   x = emb @ w_emb + b_emb                                   [F, A]
//   L times:  (saved[l] = x when training)
//             qkv = x @ w_in + b_in                           [F, 3A]
//             per head h: a = softmax(q_h k_h^T / sqrt(hd))   [F, F]
//                         a = keep ? a / (1 - rate) : 0       (dropout)
//                         o_h = a @ v_h                       [F, hd]
//             x = o @ w_out + b_out                           [F, A]
//   y = relu(x + emb @ w_res + b_res)     (no residual when w_res is null)
//
// for every batch row.  Weights are [in, out] as the JAX package stores
// them, in the Pallas kernel's flat order.
//
// Dropout bits.  The TPU kernel draws them from the TPU's own generator.
// Here they are a counter-based hash: bits = mix(key ^ ctr) with
// key = mix(mix(seed ^ 0x9e3779b9) ^ row), ctr = ((l*H + h)*F + f)*F + g
// and mix the "lowbias32" integer hash; a weight is kept when
// bits < floor((1 - rate) * 2^32), the threshold rule of _keep_mask.  The
// seed is a device scalar (drawn per step on the card, so no step waits
// on the host for it).  The backward regenerates the forward's mask from
// the same counters, and tpurec_torch/ops/attention.py computes the same
// hash in int64 arithmetic for the plain version.
//
// Bound on the H100: float32 operations.  Per batch row the forward does
// 2*F*D*A*2 + L*(2*F*A*3A + 4*H*F*F*hd + 2*F*A*A) flops, about 2.76 MFLOP
// at F=23, D=16, A=64, H=2, L=3, against about 6 KB of input and output
// (plus L*F*A*4 = 17.7 KB of saved layer inputs when training); the
// backward does about 2.5x that (it recomputes each layer's internals,
// as the Pallas kernel does).  The weights (about 210 KB) are shared by
// all rows and stay in L2.  The forward runs its products on the tensor
// cores in three TF32 passes: the work it issues is bounded by 3 x its
// flops at the TF32 peak (2.46x less time than the float32 bound).
//
// Forward design (field_attention_kernel): a block of 512 threads takes R
// batch rows (the wrapper picks R from B, F and the card) and stacks their
// fields into one [M = R*F padded to 48, .] matrix in shared memory, so
// the four projections (emb @ w_emb, x @ w_in, o @ w_out, emb @ w_res)
// are each one product over M rows.  Each projection's weights are staged
// in shared memory once per block by cp.async, the next one's while the
// current step runs, so a batch row costs 1/R of the weight traffic of
// one row per block (about 1.2 MB a row before, from L2).  The products
// run on the tensor cores as mma.sync m16n8k8 TF32 with the 3xTF32 split
// (a = a_hi + a_lo; a_lo*b_hi + a_hi*b_lo + a_hi*b_hi summed in float32),
// which keeps float32 accuracy; single-pass TF32 would not.  Rows of one
// batch row never mix with another's: the products are row by row, and
// the attention (scores, softmax, dropout, ad @ v) runs per batch row on
// SIMT FMAs over that row's F x F block, with the row maximum subtracted
// as jax.nn.softmax does.  Shared memory holds x [M, A] (the scores [R, H,
// F, F] reuse it while x is dead), qkv [M, 3A] (o overwrites q; emb is
// staged there before the first layer and again for the residual) and two
// weight buffers: about 171 KB at R=4 and the flagship shapes (where the
// weights do not fit beside a block's activations, the products read them
// from device memory instead).  Strides keep a warp's MMA fragment loads
// on 32 distinct banks.  The attention of one (batch row, head, 16-field
// tile) is one warp's work from scores to ad @ v, with no block barrier;
// the three TF32 passes of a k step are issued tile by tile so that no
// product waits on the one before it.

// Backward design: a block walks the batch rows blockIdx.x, +gridDim.x,
// ...; for each it holds the row's recomputed qkv, softmax, dropped
// weights, o and the gradients dx, do, dqkv, ds in shared memory (about
// 75 KB at the flagship shapes, over the 48 KB default: the launch opts
// in).  demb is written per row.  The weight gradients are sums over all
// rows: a block adds its rows' contributions into its own slice of a
// [grid, n_w] partial buffer in device memory (one thread always owns the
// same elements, so there are no races; the block's first row writes
// instead of adding, so nothing needs zeroing), and a second kernel sums
// the grid slices in a fixed order.  That is deterministic, unlike float
// atomics, whose order changes from run to run; the partials cost a
// read-modify-write of the weight gradients (about 210 KB) per row, held
// in L2 at grid = 2 blocks per SM.
//
// The 16-byte loads need D, A and A/H to be multiples of 4 and 16-byte
// aligned tensors; the wrapper checks both.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TPUREC_ATTN_MAX_LAYERS 8

namespace {

constexpr int kThreads = 256;

// max(v, 0) that keeps NaN, as jnp.maximum and torch.relu do
__device__ __forceinline__ float relu(float v) {
  return (v > 0.f || v != v) ? v : 0.f;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// acc += s * v, component-wise
__device__ __forceinline__ void fma4(float4& acc, float s, float4 v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

// acc + a . b, summed in order x, y, z, w
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// "lowbias32" (Chris Wellons' integer hash): a bijection of uint32
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

struct Dropout {
  int on;                  // 0: no dropout (eval, or rate 0)
  uint32_t thresh;         // keep a weight when its bits < thresh
  float keep;              // 1 - rate, the divisor of kept weights
  const long long* seed;   // device scalar; read only when on
};

__device__ __forceinline__ uint32_t row_key(const Dropout& dp,
                                            long long row) {
  if (!dp.on) return 0u;
  const uint32_t s = static_cast<uint32_t>(*dp.seed);
  return mix32(mix32(s ^ 0x9e3779b9u) ^ static_cast<uint32_t>(row));
}

__device__ __forceinline__ bool kept(uint32_t key, uint32_t ctr,
                                     uint32_t thresh) {
  return mix32(key ^ ctr) < thresh;
}

struct Weights {
  const float* w_emb;
  const float* b_emb;
  const float* w_res;  // null: no V_res residual
  const float* b_res;
  const float* w_in[TPUREC_ATTN_MAX_LAYERS];
  const float* b_in[TPUREC_ATTN_MAX_LAYERS];
  const float* w_out[TPUREC_ATTN_MAX_LAYERS];
  const float* b_out[TPUREC_ATTN_MAX_LAYERS];
};

// y[m, n] = sum_k x[m, k] * w[k, n] + b[n] for m < M, n < N, K and N
// multiples of 4.  x and y are in shared memory, w and b in device memory.
// A thread owns rows m0..m0+3 by columns n0..n0+3.
__device__ void dense(const float* x, int M, int K,
                      const float* __restrict__ w,
                      const float* __restrict__ b, int N, float* y) {
  const int n_groups = N / 4;
  const int tiles = (M + 3) / 4 * n_groups;
  for (int i = threadIdx.x; i < tiles; i += blockDim.x) {
    const int n0 = (i % n_groups) * 4;
    const int m0 = (i / n_groups) * 4;
    const float* xr[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) xr[t] = x + min(m0 + t, M - 1) * K;
    float4 acc[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < K; k += 4) {
      const float4 w0 = ldg4(w + (k + 0) * N + n0);
      const float4 w1 = ldg4(w + (k + 1) * N + n0);
      const float4 w2 = ldg4(w + (k + 2) * N + n0);
      const float4 w3 = ldg4(w + (k + 3) * N + n0);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float4 xv = ld4(xr[t] + k);
        fma4(acc[t], xv.x, w0);
        fma4(acc[t], xv.y, w1);
        fma4(acc[t], xv.z, w2);
        fma4(acc[t], xv.w, w3);
      }
    }
    const float4 bn = ldg4(b + n0);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (m0 + t < M) st4(y + (m0 + t) * N + n0, add4(acc[t], bn));
  }
}

// y[m, k] (+)= sum_n x[m, n] * w[k, n] (x @ w^T) for m < M, k < K; x [M, N]
// in shared memory, w [K, N] in device memory, K and N multiples of 4.
// A thread owns rows m0..m0+3 by columns k0..k0+3.
__device__ void dense_t(const float* x, int M, int N,
                        const float* __restrict__ w, int K, float* y,
                        bool accumulate) {
  const int k_groups = K / 4;
  const int tiles = (M + 3) / 4 * k_groups;
  for (int i = threadIdx.x; i < tiles; i += blockDim.x) {
    const int k0 = (i % k_groups) * 4;
    const int m0 = (i / k_groups) * 4;
    const float* xr[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) xr[t] = x + min(m0 + t, M - 1) * N;
    float acc[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[t][u] = 0.f;
    for (int n = 0; n < N; n += 4) {
      float4 wv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) wv[u] = ldg4(w + (k0 + u) * N + n);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float4 xv = ld4(xr[t] + n);
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[t][u] = dot4(xv, wv[u], acc[t][u]);
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (m0 + t >= M) continue;
      float* yr = y + (m0 + t) * K + k0;
      float4 v = make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
      if (accumulate) v = add4(ld4(yr), v);
      st4(yr, v);
    }
  }
}

// g[k, n] (+)= sum_m x[m, k] * y[m, n] (x^T @ y) and gb[n] (+)= sum_m
// y[m, n]; x [M, K] and y [M, N] in shared memory, g [K, N] and gb [N] this
// block's slices of the partial sums in device memory.  `first` writes
// instead of adding.  K and N multiples of 4; a thread owns a 4x4 tile.
__device__ void wgrad(const float* x, const float* y, int M, int K, int N,
                      float* g, float* gb, bool first) {
  const int n_groups = N / 4;
  const int tiles = K / 4 * n_groups;
  for (int i = threadIdx.x; i < tiles; i += blockDim.x) {
    const int n0 = (i % n_groups) * 4;
    const int k0 = (i / n_groups) * 4;
    float4 acc[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int m = 0; m < M; ++m) {
      const float4 xv = ld4(x + m * K + k0);
      const float4 yv = ld4(y + m * N + n0);
      fma4(acc[0], xv.x, yv);
      fma4(acc[1], xv.y, yv);
      fma4(acc[2], xv.z, yv);
      fma4(acc[3], xv.w, yv);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float* p = g + (k0 + t) * N + n0;
      st4(p, first ? acc[t] : add4(ld4(p), acc[t]));
    }
  }
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float s = 0.f;
    for (int m = 0; m < M; ++m) s += y[m * N + n];
    gb[n] = first ? s : gb[n] + s;
  }
}

// One layer's attention internals from its qkv [F, 3A]: per head h the
// softmax a [H, F, F] of q_h k_h^T / sqrt(hd), the dropped weights ad
// (ad may alias a), and o [F, A] = concat_h(ad_h @ v_h).  Ends synced.
__device__ void attend(const float* qkv, float* a, float* ad, float* o,
                       int F, int A, int H, int l, float sqrt_hd,
                       const Dropout& dp, uint32_t key) {
  const int hd = A / H;
  const int ld = 3 * A;  // row stride of qkv
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  // scores[h, f, g0..g0+3] = q_h[f] . k_h[g] / sqrt(hd)
  const int g_groups = (F + 3) / 4;
  for (int i = threadIdx.x; i < H * F * g_groups; i += blockDim.x) {
    const int g0 = (i % g_groups) * 4;
    const int f = (i / g_groups) % F;
    const int h = i / (g_groups * F);
    const float* q = qkv + f * ld + h * hd;
    const float* kr[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      kr[t] = qkv + min(g0 + t, F - 1) * ld + A + h * hd;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < hd; d += 4) {
      const float4 qv = ld4(q + d);
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[t] = dot4(qv, ld4(kr[t] + d), acc[t]);
    }
    float* sr = a + (h * F + f) * F;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (g0 + t < F) sr[g0 + t] = acc[t] / sqrt_hd;
  }
  __syncthreads();
  // softmax over g, one warp per (h, f) row, then dropout
  for (int r = warp; r < H * F; r += n_warps) {
    float* sr = a + r * F;
    float* dr = ad + r * F;
    const uint32_t ctr0 = static_cast<uint32_t>((l * H * F + r) * F);
    float m = -INFINITY;
    for (int g = lane; g < F; g += 32) m = fmaxf(m, sr[g]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int g = lane; g < F; g += 32) {
      const float ex = expf(sr[g] - m);
      sr[g] = ex;
      sum += ex;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int g = lane; g < F; g += 32) {
      const float p = sr[g] / sum;
      sr[g] = p;
      if (dp.on)
        dr[g] = kept(key, ctr0 + g, dp.thresh) ? p / dp.keep : 0.f;
      else
        dr[g] = p;
    }
  }
  __syncthreads();
  // o[f, c0..c0+3] = sum_g ad[h, f, g] * v[g, c0..c0+3]  (h = c0 / hd)
  for (int i = threadIdx.x; i < F * (A / 4); i += blockDim.x) {
    const int f = i / (A / 4), c0 = (i % (A / 4)) * 4;
    const float* p = ad + ((c0 / hd) * F + f) * F;
    const float* v = qkv + 2 * A + c0;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 0; g < F; ++g) fma4(acc, p[g], ld4(v + g * ld));
    st4(o + f * A + c0, acc);
  }
  __syncthreads();
}

__device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

// -- the stack forward (kernel 2): R batch rows a block ---------------------

constexpr int kFwdThreads = 512;  // 16 warps a block
constexpr int kFwdMTiles = 3;     // m16 row tiles of a warp's unit of work

// x = hi + lo for the 3xTF32 products: hi is x rounded to TF32 (10
// mantissa bits, half away from zero), lo = x - hi exactly, of which the
// tensor core reads the top 10 mantissa bits; three instructions, where
// cvt.rna.tf32.f32 takes several for each half
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b: one m16n8k8 TF32 tensor-core product, float32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy w [K, N] (16-byte aligned, N % 4 == 0) into shared memory at row
// stride ldw with cp.async, committed as one group
__device__ __forceinline__ void stage_weight(float* dst, int ldw,
                                             const float* __restrict__ src,
                                             int K, int N) {
  const int nq = N / 4;
  for (int i = threadIdx.x; i < K * nq; i += blockDim.x) {
    const int k = i / nq, c = (i - k * nq) * 4;
    const unsigned d = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + k * ldw + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                 "l"(src + static_cast<long long>(k) * N + c)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void commit_nothing() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most `pending` of this thread's copy groups are in flight
template <int pending>
__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_group %0;" ::"n"(pending) : "memory");
}

// out[m, n] = sum_{k < K} a[m, k] * ws[k, n] + b[n] for m < M (a multiple
// of 16 * kFwdMTiles) and n < N (a multiple of 4), handed over as epi(m,
// n, out[m, n], out[m, n + 1]).  a and ws are in shared memory, a at row
// stride lda (lda % 8 == 4) and ws at ldw (= 8 or 24 mod 32), so that a
// warp's A and B fragment loads each hit all 32 banks; b [N] is in device
// memory.  A unit of work is kFwdMTiles m16 row tiles by NG n8 column
// tiles; the block's warps take the units in turn.  A k step loads all
// its fragments first and then issues the 3xTF32 products pass by pass
// (a_lo*b_hi, a_hi*b_lo, a_hi*b_hi over all tiles), so that no product
// waits on the one before it.  Columns k >= K read as 0 on both sides.
template <int NG, typename Epi>
__device__ __forceinline__ void mma_dense(const float* a, int lda, int M,
                                          int K, const float* ws, int ldw,
                                          const float* __restrict__ b, int N,
                                          Epi epi) {
  constexpr int MT = kFwdMTiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_groups = ((N + 7) / 8 + NG - 1) / NG;
  const int m_groups = M / (16 * MT);
  for (int u = warp; u < m_groups * n_groups; u += n_warps) {
    const int m_base = (u / n_groups) * 16 * MT;
    const int n0 = (u % n_groups) * NG * 8;
    float bias[NG][2];
    bool n_ok[NG];
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int n = n0 + j * 8 + 2 * t;
      n_ok[j] = n < N;
      bias[j][0] = n_ok[j] ? __ldg(b + n) : 0.f;
      bias[j][1] = n_ok[j] ? __ldg(b + n + 1) : 0.f;
    }
    float acc[MT][NG][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
    const float* a0 = a + (m_base + g) * lda;
#pragma unroll 2
    for (int k0 = t; k0 < K + t; k0 += 8) {
      const int k1 = k0 + 4;
      const bool ok0 = k0 < K, ok1 = k1 < K;
      float av[MT][4], bv[NG][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* r0 = a0 + mt * 16 * lda;
        av[mt][0] = ok0 ? r0[k0] : 0.f;
        av[mt][1] = ok0 ? r0[8 * lda + k0] : 0.f;
        av[mt][2] = ok1 ? r0[k1] : 0.f;
        av[mt][3] = ok1 ? r0[8 * lda + k1] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int n = n0 + j * 8 + g;
        bv[j][0] = n < N && ok0 ? ws[k0 * ldw + n] : 0.f;
        bv[j][1] = n < N && ok1 ? ws[k1 * ldw + n] : 0.f;
      }
      uint32_t ah[MT][4], al[MT][4], bh[NG][2], bl[NG][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c) split_tf32(av[mt][c], ah[mt][c], al[mt][c]);
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) split_tf32(bv[j][c], bh[j][c], bl[j][c]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NG; ++j)
          mma_tf32(acc[mt][j], al[mt], bh[j][0], bh[j][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NG; ++j)
          mma_tf32(acc[mt][j], ah[mt], bl[j][0], bl[j][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NG; ++j)
          mma_tf32(acc[mt][j], ah[mt], bh[j][0], bh[j][1]);
    }
    // d[g][2t, 2t+1] and d[g + 8][2t, 2t+1] of each tile, plus the bias
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      if (!n_ok[j]) continue;
      const int n = n0 + j * 8 + 2 * t;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = m_base + mt * 16 + g;
        epi(m, n, acc[mt][j][0] + bias[j][0], acc[mt][j][1] + bias[j][1]);
        epi(m + 8, n, acc[mt][j][2] + bias[j][0], acc[mt][j][3] + bias[j][1]);
      }
    }
  }
}

// acc[j] += a b_j for four n8 tiles: one k step of 3xTF32 products from
// raw fragments (a: rows g, g + 8 by columns t, t + 4; b_j: rows t, t + 4
// by column g of tile j), the passes interleaved over the tiles
__device__ __forceinline__ void mma_k_step4(float (&acc)[4][4],
                                            const float (&av)[4],
                                            const float (&bv)[4][2]) {
  uint32_t ah[4], al[4], bh[4][2], bl[4][2];
#pragma unroll
  for (int c = 0; c < 4; ++c) split_tf32(av[c], ah[c], al[c]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split_tf32(bv[j][0], bh[j][0], bl[j][0]);
    split_tf32(bv[j][1], bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(acc[j], al, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(acc[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(acc[j], ah, bh[j][0], bh[j][1]);
}

// One layer's attention for the R batch rows stacked in qkv [R*F, ldq]
// (row r*F + f; q at column h*hd, k at A + h*hd, v at 2A + h*hd).  A warp
// takes one unit, 16 fields f of one batch row r and head h, through all
// three steps with no block barrier: the scores q_h[f] k_h^T / sqrt(hd)
// into its rows of s [R*H*F, lds], their softmax over the row (the row
// maximum subtracted), dropped in place, then o_h[f] = ad_h[f] @ v_h
// written over its q (only its own rows and head's columns: no other unit
// reads them).  Both products run on the tensor cores in 3xTF32; fields
// past F read as 0 and are not stored, so batch rows never mix.  row0 is
// the first batch row (it keys the dropout hash).  Ends synced.
__device__ void attend_rows(float* qkv, int ldq, float* s, int lds, int R,
                            int F, int A, int H, int l, float sqrt_hd,
                            const Dropout& dp, long long row0) {
  const int hd = A / H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int f_tiles = (F + 15) / 16;
  const float inv_sqrt_hd = 1.f / sqrt_hd, inv_keep = 1.f / dp.keep;
  for (int u = warp; u < R * H * f_tiles; u += n_warps) {
    const int rh = u / f_tiles, r = rh / H, h = rh - r * H;
    const int ft = (u - rh * f_tiles) * 16;
    const int f0 = ft + g, f1 = f0 + 8;
    float* q = qkv + r * F * ldq + h * hd;   // row f; o goes here
    const float* k = q + A;
    const float* v = q + 2 * A;
    float* p = s + rh * F * lds;             // row f of this (r, h)
    // scores s[f, gk] = q[f] . k[gk] / sqrt(hd), 32 keys at a time
    for (int n0 = 0; n0 < F; n0 += 32) {
      float acc[4][4] = {};
      for (int d0 = t; d0 < hd + t; d0 += 8) {
        const int d1 = d0 + 4;
        const bool ok0 = d0 < hd, ok1 = d1 < hd;
        float av[4], bv[4][2];
        av[0] = f0 < F && ok0 ? q[f0 * ldq + d0] : 0.f;
        av[1] = f1 < F && ok0 ? q[f1 * ldq + d0] : 0.f;
        av[2] = f0 < F && ok1 ? q[f0 * ldq + d1] : 0.f;
        av[3] = f1 < F && ok1 ? q[f1 * ldq + d1] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gk = n0 + j * 8 + g;
          bv[j][0] = gk < F && ok0 ? k[gk * ldq + d0] : 0.f;
          bv[j][1] = gk < F && ok1 ? k[gk * ldq + d1] : 0.f;
        }
        mma_k_step4(acc, av, bv);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gk = n0 + j * 8 + 2 * t;
        if (gk >= F) continue;
        float* s0 = p + f0 * lds + gk;
        float* s1 = s0 + 8 * lds;
        if (f0 < F) s0[0] = acc[j][0] * inv_sqrt_hd;
        if (f1 < F) s1[0] = acc[j][2] * inv_sqrt_hd;
        if (gk + 1 < F) {
          if (f0 < F) s0[1] = acc[j][1] * inv_sqrt_hd;
          if (f1 < F) s1[1] = acc[j][3] * inv_sqrt_hd;
        }
      }
    }
    __syncwarp();
    // softmax over gk, two lanes per row, then dropout
    {
      const int f = ft + (lane >> 1), half = lane & 1;
      const bool live = f < F;
      float* sr = p + (live ? f : 0) * lds;
      float m = -INFINITY;
      if (live)
        for (int gk = half; gk < F; gk += 2) m = fmaxf(m, sr[gk]);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      float sum = 0.f;
      if (live)
        for (int gk = half; gk < F; gk += 2) {
          const float ex = expf(sr[gk] - m);
          sr[gk] = ex;
          sum += ex;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (live) {
        const float inv_sum = 1.f / sum;
        const uint32_t key = row_key(dp, row0 + r);
        const uint32_t ctr0 =
            static_cast<uint32_t>(((l * H + h) * F + f) * F);
        for (int gk = half; gk < F; gk += 2) {
          const float pv = sr[gk] * inv_sum;
          if (dp.on)
            sr[gk] = kept(key, ctr0 + gk, dp.thresh) ? pv * inv_keep : 0.f;
          else
            sr[gk] = pv;
        }
      }
    }
    __syncwarp();
    // o[f, c] = sum_gk ad[f, gk] * v[gk, c], over q[f, c], 32 columns at
    // a time
    for (int n0 = 0; n0 < hd; n0 += 32) {
      float acc[4][4] = {};
      for (int k0 = t; k0 < F + t; k0 += 8) {
        const int k1 = k0 + 4;
        const bool ok0 = k0 < F, ok1 = k1 < F;
        float av[4], bv[4][2];
        av[0] = f0 < F && ok0 ? p[f0 * lds + k0] : 0.f;
        av[1] = f1 < F && ok0 ? p[f1 * lds + k0] : 0.f;
        av[2] = f0 < F && ok1 ? p[f0 * lds + k1] : 0.f;
        av[3] = f1 < F && ok1 ? p[f1 * lds + k1] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + j * 8 + g;
          bv[j][0] = c < hd && ok0 ? v[k0 * ldq + c] : 0.f;
          bv[j][1] = c < hd && ok1 ? v[k1 * ldq + c] : 0.f;
        }
        mma_k_step4(acc, av, bv);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + j * 8 + 2 * t;
        if (c >= hd) continue;
        if (f0 < F)
          *reinterpret_cast<float2*>(q + f0 * ldq + c) =
              make_float2(acc[j][0], acc[j][1]);
        if (f1 < F)
          *reinterpret_cast<float2*>(q + f1 * ldq + c) =
              make_float2(acc[j][2], acc[j][3]);
      }
    }
  }
  __syncthreads();
}

// Row stride of a [., k] operand in shared memory: room for k rounded up
// to 8 columns, and = 4 (mod 8)
__host__ __device__ inline int fwd_stride(int k) { return ((k + 7) & ~7) + 4; }

// Row stride of a [., n] weight in shared memory: n rounded up to 8, and
// = 8 or 24 (mod 32)
__host__ __device__ inline int fwd_wstride(int n) {
  const int c = (n + 7) & ~7;
  return c % 16 == 0 ? c + 8 : c;
}

// The forward's shared memory, in floats: x [M, A], or the scores [R*H*F,
// F] while x is dead; qkv [M, 3A], or emb [M, D] before the first layer
// and for the residual; weight buffer a (w_in [A, 3A], then w_res [D, A])
// and b (w_emb [D, A], then w_out [A, A]), when `stage` (else the
// products read each weight from device memory).  M = R*F padded to whole
// units of kFwdMTiles m16 tiles.
struct FwdLayout {
  int M, lde, ldx, ldq, lds, lwa, lwb;
  long long xs_floats, q_floats, wa_floats, wb_floats;
  __host__ __device__ FwdLayout(int R, int F, int D, int A, int H,
                                bool stage) {
    M = (R * F + 16 * kFwdMTiles - 1) / (16 * kFwdMTiles) * 16 * kFwdMTiles;
    lde = fwd_stride(D);
    ldx = fwd_stride(A);
    ldq = fwd_stride(3 * A);
    lwa = fwd_wstride(3 * A);
    lwb = fwd_wstride(A);
    const long long x_floats = static_cast<long long>(M) * ldx;
    lds = fwd_stride(F);
    const long long s_floats = static_cast<long long>(R) * H * F * lds;
    xs_floats = ((x_floats > s_floats ? x_floats : s_floats) + 3) & ~3LL;
    q_floats = static_cast<long long>(M) * (ldq > lde ? ldq : lde);
    const long long w_in = static_cast<long long>(A) * lwa;
    const long long w_res = static_cast<long long>(D) * lwb;
    wa_floats = stage ? (w_in > w_res ? w_in : w_res) : 0;
    wb_floats = stage ? static_cast<long long>(A > D ? A : D) * lwb : 0;
  }
  __host__ __device__ long long bytes() const {
    return 4 * (xs_floats + q_floats + wa_floats + wb_floats);
  }
};

// Blocks of R batch rows (the last one may reach past B; its missing rows
// are zeros and are not stored).  saved: null, or [L, B, F, A] for the
// layer inputs (training).  With `stage`, each projection's weights are
// staged by cp.async into their buffer while the step before it runs:
// w_in of layer l + 1 (or w_res) during layer l's attention and
// out-projection, w_out of layer l during its in-projection and attention.
// Without (shapes whose weights do not fit beside the activations), the
// products read the weights from device memory.
__global__ void __launch_bounds__(kFwdThreads, 1)
    field_attention_kernel(const float* __restrict__ emb, Weights w, int B,
                           int R, int F, int D, int A, int H, int L,
                           int stage, float sqrt_hd, Dropout dp,
                           float* __restrict__ y, float* __restrict__ saved) {
  extern __shared__ float4 smem4[];
  const FwdLayout lay(R, F, D, A, H, stage != 0);
  const int M = lay.M, lde = lay.lde, ldx = lay.ldx, ldq = lay.ldq;
  float* xs = reinterpret_cast<float*>(smem4);  // x; the scores
  float* qkv = xs + lay.xs_floats;              // qkv (o over q); emb
  float* wa = qkv + lay.q_floats;               // w_in; w_res
  float* wb = wa + lay.wa_floats;               // w_emb; w_out
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int n_real = static_cast<int>(min(static_cast<long long>(R),
                                          B - row0)) * F;  // stacked rows
  const long long FA = static_cast<long long>(F) * A;

  auto stage_emb = [&]() {
    const int dq = D / 4;
    for (int i = threadIdx.x; i < M * dq; i += blockDim.x) {
      const int m = i / dq, c = (i - m * dq) * 4;
      st4(qkv + m * lde + c,
          m < n_real ? ldg4(emb + (row0 * F + m) * D + c)
                     : make_float4(0.f, 0.f, 0.f, 0.f));
    }
  };
  auto to_x = [&](int m, int n, float v0, float v1) {
    *reinterpret_cast<float2*>(xs + m * ldx + n) = make_float2(v0, v1);
  };
  auto to_qkv = [&](int m, int n, float v0, float v1) {
    *reinterpret_cast<float2*>(qkv + m * ldq + n) = make_float2(v0, v1);
  };

  // the B operand of each projection, and its row stride
  const int lwa = stage ? lay.lwa : 3 * A, lwr = stage ? lay.lwb : A;
  const int lwb = stage ? lay.lwb : A;
  if (stage) {
    stage_weight(wb, lwb, w.w_emb, D, A);
    stage_weight(wa, lwa, w.w_in[0], A, 3 * A);
  }
  stage_emb();
  wait_staged<1>();                                   // w_emb
  __syncthreads();
  mma_dense<1>(qkv, lde, M, D, stage ? wb : w.w_emb, lwb, w.b_emb, A, to_x);
  __syncthreads();
  if (stage) stage_weight(wb, lwb, w.w_out[0], A, A);
  for (int l = 0; l < L; ++l) {
    if (saved != nullptr) {
      float* sv = saved + (l * static_cast<long long>(B) + row0) * FA;
      const int aq = A / 4;
      for (int i = threadIdx.x; i < n_real * aq; i += blockDim.x) {
        const int m = i / aq, c = (i - m * aq) * 4;
        st4(sv + static_cast<long long>(m) * A + c, ld4(xs + m * ldx + c));
      }
    }
    wait_staged<1>();                                 // w_in[l]
    __syncthreads();
    mma_dense<3>(xs, ldx, M, A, stage ? wa : w.w_in[l], lwa, w.b_in[l],
                 3 * A, to_qkv);
    __syncthreads();
    if (stage) {
      if (l + 1 < L)
        stage_weight(wa, lwa, w.w_in[l + 1], A, 3 * A);
      else if (w.w_res != nullptr)
        stage_weight(wa, lwr, w.w_res, D, A);
      else
        commit_nothing();
    }
    attend_rows(qkv, ldq, xs, lay.lds, R, F, A, H, l, sqrt_hd, dp, row0);
    wait_staged<1>();                                 // w_out[l]
    __syncthreads();
    mma_dense<1>(qkv, ldq, M, A, stage ? wb : w.w_out[l], lwb, w.b_out[l],
                 A, to_x);
    __syncthreads();
    if (stage) {
      if (l + 1 < L)
        stage_weight(wb, lwb, w.w_out[l + 1], A, A);
      else
        commit_nothing();
    }
  }

  // y = relu(x + (emb @ w_res + b_res)), the residual added in the
  // projection's epilogue
  float* yb = y + row0 * FA;
  if (w.w_res != nullptr) {
    stage_emb();
    wait_staged<0>();                                 // w_res
    __syncthreads();
    mma_dense<1>(qkv, lde, M, D, stage ? wa : w.w_res, lwr, w.b_res, A,
                 [&](int m, int n, float v0, float v1) {
                   if (m >= n_real) return;
                   const float2 x =
                       *reinterpret_cast<const float2*>(xs + m * ldx + n);
                   *reinterpret_cast<float2*>(
                       yb + static_cast<long long>(m) * A + n) =
                       make_float2(relu(x.x + v0), relu(x.y + v1));
                 });
  } else {
    const int aq = A / 4;
    for (int i = threadIdx.x; i < n_real * aq; i += blockDim.x) {
      const int m = i / aq, c = (i - m * aq) * 4;
      const float4 v = ld4(xs + m * ldx + c);
      st4(yb + static_cast<long long>(m) * A + c,
          make_float4(relu(v.x), relu(v.y), relu(v.z), relu(v.w)));
    }
  }
}

// Offsets of each weight's gradient in the flat [n_w] vector, in the
// Pallas kernel's order [w_emb, b_emb, w_res, b_res, (w_in, b_in, w_out,
// b_out) x L]; w_res and b_res take no room without a residual.
struct GradOffsets {
  long long w_emb, b_emb, w_res, b_res, layer0, layer_stride;
  __host__ __device__ GradOffsets(int D, int A, bool res) {
    w_emb = 0;
    b_emb = static_cast<long long>(D) * A;
    w_res = b_emb + A;
    b_res = w_res + (res ? static_cast<long long>(D) * A : 0);
    layer0 = b_res + (res ? A : 0);
    layer_stride = 4LL * A * A + 4LL * A;
  }
  __host__ __device__ long long w_in(int l, int A) const {
    return layer0 + l * layer_stride;
  }
  __host__ __device__ long long b_in(int l, int A) const {
    return w_in(l, A) + 3LL * A * A;
  }
  __host__ __device__ long long w_out(int l, int A) const {
    return b_in(l, A) + 3LL * A;
  }
  __host__ __device__ long long b_out(int l, int A) const {
    return w_out(l, A) + 1LL * A * A;
  }
  __host__ __device__ long long size(int L) const {
    return layer0 + L * layer_stride;
  }
};

// Floats of shared memory the backward needs per block.
__host__ __device__ long long bwd_smem_floats(int F, int D, int A, int H) {
  const long long fd = (F * D + 3) & ~3, fa = (F * A + 3) & ~3;
  const long long fa3 = (3 * F * A + 3) & ~3, hff = (H * F * F + 3) & ~3;
  return 2 * fd + 4 * fa + 2 * fa3 + 3 * hff;
}

// One attention layer's backward, in shared memory, for one batch row.  In:
// dx [F, A], the gradient at the layer's output; the layer's input xin
// [F, A] and its internals recomputed by dense + attend (qkv [F, 3A],
// softmax as and dropped weights ad [H, F, F], o [F, A]).  Adds the
// layer's weight gradients into this block's partial slices g_w_in [A,
// 3A], g_b_in [3A], g_w_out [A, A], g_b_out [A] (`first` writes instead)
// and leaves the gradient at the layer's input in dx.  dO [F, A], dqkv
// [F, 3A] and ds [H, F, F] are scratch.  Starts and ends synced.
__device__ void layer_backward(const float* xin, const float* qkv,
                               const float* as, const float* ad,
                               const float* o, float* dx, float* dO,
                               float* dqkv, float* ds, int F, int A, int H,
                               int l, float sqrt_hd, const Dropout& dp,
                               uint32_t key, const float* __restrict__ w_in,
                               const float* __restrict__ w_out,
                               float* g_w_in, float* g_b_in, float* g_w_out,
                               float* g_b_out, bool first) {
  const int hd = A / H;
  const int ld = 3 * A;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  // out-projection backward
  wgrad(o, dx, F, A, A, g_w_out, g_b_out, first);
  dense_t(dx, F, A, w_out, A, dO, false);
  __syncthreads();
  // d_adrop[h, f, g] = do_h[f] . v_h[g]  -> ds
  const int g_groups = (F + 3) / 4;
  for (int i = threadIdx.x; i < H * F * g_groups; i += blockDim.x) {
    const int g0 = (i % g_groups) * 4;
    const int f = (i / g_groups) % F;
    const int h = i / (g_groups * F);
    const float* dor = dO + f * A + h * hd;
    const float* vr[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      vr[t] = qkv + min(g0 + t, F - 1) * ld + 2 * A + h * hd;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < hd; d += 4) {
      const float4 dv = ld4(dor + d);
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[t] = dot4(dv, ld4(vr[t] + d), acc[t]);
    }
    float* sr = ds + (h * F + f) * F;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (g0 + t < F) sr[g0 + t] = acc[t];
  }
  // d_v[g, c] = sum_f ad[h, f, g] * do[f, c]  -> dqkv[g, 2A + c]
  for (int i = threadIdx.x; i < F * (A / 4); i += blockDim.x) {
    const int g = i / (A / 4), c0 = (i % (A / 4)) * 4;
    const float* p = ad + (c0 / hd) * F * F + g;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int f = 0; f < F; ++f) fma4(acc, p[f * F], ld4(dO + f * A + c0));
    st4(dqkv + g * ld + 2 * A + c0, acc);
  }
  __syncthreads();
  // d_s = (d_a - sum_g d_a * a) * a / sqrt(hd), d_a = keep ? d_adrop /
  // (1 - rate) : 0; one warp per (h, f) row
  for (int r = warp; r < H * F; r += n_warps) {
    float* dr = ds + r * F;
    const float* ar = as + r * F;
    const uint32_t ctr0 = static_cast<uint32_t>((l * H * F + r) * F);
    float sum = 0.f;
    for (int g = lane; g < F; g += 32) {
      float da = dr[g];
      if (dp.on) da = kept(key, ctr0 + g, dp.thresh) ? da / dp.keep : 0.f;
      dr[g] = da;
      sum = fmaf(da, ar[g], sum);
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int g = lane; g < F; g += 32)
      dr[g] = (dr[g] - sum) * ar[g] / sqrt_hd;
  }
  __syncthreads();
  // dq[f, c] = sum_g ds[h, f, g] k[g, c];  dk[g, c] = sum_f ds[h, f, g]
  // q[f, c]  -> dqkv[:, c] and dqkv[:, A + c]
  for (int i = threadIdx.x; i < F * (A / 4); i += blockDim.x) {
    const int f = i / (A / 4), c0 = (i % (A / 4)) * 4;
    const float* dsh = ds + (c0 / hd) * F * F;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 0; g < F; ++g)
      fma4(acc, dsh[f * F + g], ld4(qkv + g * ld + A + c0));
    st4(dqkv + f * ld + c0, acc);
    acc = make_float4(0.f, 0.f, 0.f, 0.f);   // f plays g here
    for (int f2 = 0; f2 < F; ++f2)
      fma4(acc, dsh[f2 * F + f], ld4(qkv + f2 * ld + c0));
    st4(dqkv + f * ld + A + c0, acc);
  }
  __syncthreads();
  // in-projection backward
  wgrad(xin, dqkv, F, A, 3 * A, g_w_in, g_b_in, first);
  dense_t(dqkv, F, 3 * A, w_in, A, dx, false);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    field_attention_bwd_kernel(const float* __restrict__ emb,
                               const float* __restrict__ dy,
                               const float* __restrict__ saved, Weights w,
                               int B, int F, int D, int A, int H, int L,
                               float sqrt_hd, Dropout dp,
                               float* __restrict__ demb,
                               float* __restrict__ partial, long long n_w) {
  extern __shared__ float4 smem4[];
  const bool res = w.w_res != nullptr;
  float* e = reinterpret_cast<float*>(smem4);   // [F, D] this row's emb
  float* de = e + pad4(F * D);                  // [F, D] its gradient
  float* xin = de + pad4(F * D);                // [F, A] layer input
  float* o = xin + pad4(F * A);                 // [F, A] attention out
  float* dx = o + pad4(F * A);                  // [F, A] grad at layer out
  float* dO = dx + pad4(F * A);                 // [F, A] grad at o
  float* qkv = dO + pad4(F * A);                // [F, 3A]
  float* dqkv = qkv + pad4(3 * F * A);          // [F, 3A]
  float* as = dqkv + pad4(3 * F * A);           // [H, F, F] softmax
  float* ad = as + pad4(H * F * F);             // [H, F, F] after dropout
  float* ds = ad + pad4(H * F * F);             // [H, F, F] score grads
  const long long FA = static_cast<long long>(F) * A;
  const GradOffsets go(D, A, res);
  float* part = partial + blockIdx.x * n_w;

  for (long long row = blockIdx.x; row < B; row += gridDim.x) {
    const bool first = row == blockIdx.x;
    const uint32_t key = row_key(dp, row);
    for (int i = threadIdx.x; i < F * D; i += blockDim.x)
      e[i] = emb[row * F * D + i];
    const float* sv = saved + ((L - 1) * static_cast<long long>(B) + row) * FA;
    for (int i = threadIdx.x; i < F * A / 4; i += blockDim.x)
      st4(xin + 4 * i, ld4(sv + 4 * i));
    __syncthreads();

    // the last layer's output, for the ReLU's mask (its internals stay
    // for the first step of the layer loop)
    dense(xin, F, A, w.w_in[L - 1], w.b_in[L - 1], 3 * A, qkv);
    __syncthreads();
    attend(qkv, as, ad, o, F, A, H, L - 1, sqrt_hd, dp, key);
    dense(o, F, A, w.w_out[L - 1], w.b_out[L - 1], A, dO);
    if (res) dense(e, F, D, w.w_res, w.b_res, A, dx);
    __syncthreads();
    // dz = dy where x_out + res > 0, else 0 (torch.relu's backward)
    for (int i = threadIdx.x; i < F * A; i += blockDim.x) {
      const float z = res ? dO[i] + dx[i] : dO[i];
      dx[i] = z > 0.f ? dy[row * FA + i] : 0.f;
    }
    __syncthreads();
    if (res) {
      wgrad(e, dx, F, D, A, part + go.w_res, part + go.b_res, first);
      dense_t(dx, F, A, w.w_res, D, de, false);
    } else {
      for (int i = threadIdx.x; i < F * D; i += blockDim.x) de[i] = 0.f;
    }
    __syncthreads();

    for (int l = L - 1; l >= 0; --l) {
      if (l != L - 1) {
        sv = saved + (l * static_cast<long long>(B) + row) * FA;
        for (int i = threadIdx.x; i < F * A / 4; i += blockDim.x)
          st4(xin + 4 * i, ld4(sv + 4 * i));
        __syncthreads();
        dense(xin, F, A, w.w_in[l], w.b_in[l], 3 * A, qkv);
        __syncthreads();
        attend(qkv, as, ad, o, F, A, H, l, sqrt_hd, dp, key);
      }
      layer_backward(xin, qkv, as, ad, o, dx, dO, dqkv, ds, F, A, H, l,
                     sqrt_hd, dp, key, w.w_in[l], w.w_out[l],
                     part + go.w_in(l, A), part + go.b_in(l, A),
                     part + go.w_out(l, A), part + go.b_out(l, A), first);
    }

    // embedding projection backward
    wgrad(e, dx, F, D, A, part + go.w_emb, part + go.b_emb, first);
    dense_t(dx, F, A, w.w_emb, D, de, true);
    __syncthreads();
    for (int i = threadIdx.x; i < F * D; i += blockDim.x)
      demb[row * F * D + i] = de[i];
    __syncthreads();
  }
}

// out[e] = sum_{g < G} partial[g, e], in order of g
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       int G, long long n,
                                       float* __restrict__ out) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += partial[g * n + e];
    out[e] = s;
  }
}

// -- one attention layer (kernels 4 and 5) ---------------------------------
//
// Replace tpurec/ops/attention_pallas.py::fused_attention_layer: the
// forward _layer_only_fwd_kernel (run by _run_layer_fwd) and the backward
// _layer_only_bwd_kernel (run by _run_layer_bwd through _fal_bwd), which
// fused_field_attention_layered calls once per layer.  They are the body
// of the stack kernels' layer loop as kernels of their own: x [B, F, A] ->
// y = attention(x) @ w_out + b_out, and back.  The layer index selects
// the dropout counters, so layer l drops the weights that the stack drops
// in its layer l for the same seed.  Weight gradients go through the
// partials and the ordered reduction of the stack's backward.
//
// Bound on the H100: float32 operations.  At F=23, A=64, H=2 the forward
// does 2*F*A*3A + 4*F*F*A + 2*F*A*A = 889,088 flops per row against 11.8
// KB of row input and output (B=512: 6.8 us of operations, 1.8 us of
// bytes); the backward, which recomputes the forward's attention, does
// 2,478,848 per row against 17.7 KB (B=512: 18.9 us, 2.7 us).

// Offsets of a layer's gradients in its flat vector: w_in [A, 3A], b_in
// [3A], w_out [A, A], b_out [A] (GradOffsets' layer block).
struct LayerGradOffsets {
  long long w_in, b_in, w_out, b_out, size;
  __host__ __device__ explicit LayerGradOffsets(int A) {
    w_in = 0;
    b_in = 3LL * A * A;
    w_out = b_in + 3LL * A;
    b_out = w_out + 1LL * A * A;
    size = b_out + A;
  }
};

// Floats of shared memory the layer backward needs per block.
__host__ __device__ long long layer_bwd_smem_floats(int F, int A, int H) {
  const long long fa = (F * A + 3) & ~3, fa3 = (3 * F * A + 3) & ~3;
  const long long hff = (H * F * F + 3) & ~3;
  return 4 * fa + 2 * fa3 + 3 * hff;
}

// One block per batch row: x, qkv, scores and o in shared memory, y
// written straight from the out-projection.  64 registers at most, as the
// stack forward.
__global__ void __launch_bounds__(kThreads, 4)
    attention_layer_kernel(const float* __restrict__ x,
                           const float* __restrict__ w_in,
                           const float* __restrict__ b_in,
                           const float* __restrict__ w_out,
                           const float* __restrict__ b_out, int F, int A,
                           int H, int layer, float sqrt_hd, Dropout dp,
                           float* __restrict__ y) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [F, A]
  float* qkv = xs + F * A;                      // [F, 3A]
  float* o = qkv + F * 3 * A;                   // [F, A]
  float* s = o + F * A;                         // [H, F, F]
  const long long row = blockIdx.x;
  const long long FA = static_cast<long long>(F) * A;
  const uint32_t key = row_key(dp, row);
  for (int i = threadIdx.x; i < F * A / 4; i += blockDim.x)
    st4(xs + 4 * i, ld4(x + row * FA + 4 * i));
  __syncthreads();
  dense(xs, F, A, w_in, b_in, 3 * A, qkv);
  __syncthreads();
  attend(qkv, s, s, o, F, A, H, layer, sqrt_hd, dp, key);
  dense(o, F, A, w_out, b_out, A, y + row * FA);
}

// A block walks the rows blockIdx.x, +gridDim.x, ...: recomputes the
// layer from x (qkv, softmax, dropped weights, o), then layer_backward
// from dy; dx is written per row, the weight gradients into the block's
// slice of partial [grid, n_w].
__global__ void __launch_bounds__(kThreads)
    attention_layer_bwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ dy,
                               const float* __restrict__ w_in,
                               const float* __restrict__ b_in,
                               const float* __restrict__ w_out,
                               int B, int F, int A, int H, int layer,
                               float sqrt_hd, Dropout dp,
                               float* __restrict__ dx_out,
                               float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float* xin = reinterpret_cast<float*>(smem4);  // [F, A] layer input
  float* o = xin + pad4(F * A);                   // [F, A] attention out
  float* dx = o + pad4(F * A);                    // [F, A] dy, then dx
  float* dO = dx + pad4(F * A);                   // [F, A] grad at o
  float* qkv = dO + pad4(F * A);                  // [F, 3A]
  float* dqkv = qkv + pad4(3 * F * A);            // [F, 3A]
  float* as = dqkv + pad4(3 * F * A);             // [H, F, F] softmax
  float* ad = as + pad4(H * F * F);               // [H, F, F] after dropout
  float* ds = ad + pad4(H * F * F);               // [H, F, F] score grads
  const long long FA = static_cast<long long>(F) * A;
  const LayerGradOffsets go(A);
  float* part = partial + blockIdx.x * go.size;

  for (long long row = blockIdx.x; row < B; row += gridDim.x) {
    const bool first = row == blockIdx.x;
    const uint32_t key = row_key(dp, row);
    for (int i = threadIdx.x; i < F * A / 4; i += blockDim.x) {
      st4(xin + 4 * i, ld4(x + row * FA + 4 * i));
      st4(dx + 4 * i, ld4(dy + row * FA + 4 * i));
    }
    __syncthreads();
    dense(xin, F, A, w_in, b_in, 3 * A, qkv);
    __syncthreads();
    attend(qkv, as, ad, o, F, A, H, layer, sqrt_hd, dp, key);
    layer_backward(xin, qkv, as, ad, o, dx, dO, dqkv, ds, F, A, H, layer,
                   sqrt_hd, dp, key, w_in, w_out, part + go.w_in,
                   part + go.b_in, part + go.w_out, part + go.b_out, first);
    for (int i = threadIdx.x; i < F * A / 4; i += blockDim.x)
      st4(dx_out + row * FA + 4 * i, ld4(dx + 4 * i));
    __syncthreads();
  }
}

bool bad_heads(int H, int A) {
  return H <= 0 || A % H != 0 || A % 4 != 0 || (A / H) % 4 != 0;
}

bool bad_shape(int L, int H, int D, int A) {
  return L < 1 || L > TPUREC_ATTN_MAX_LAYERS || D % 4 != 0 ||
         bad_heads(H, A);
}

Weights unpack(const float* const* weights, int L) {
  Weights w;
  w.w_emb = weights[0];
  w.b_emb = weights[1];
  w.w_res = weights[2];
  w.b_res = weights[3];
  for (int l = 0; l < L; ++l) {
    w.w_in[l] = weights[4 + 4 * l];
    w.b_in[l] = weights[5 + 4 * l];
    w.w_out[l] = weights[6 + 4 * l];
    w.b_out[l] = weights[7 + 4 * l];
  }
  return w;
}

Dropout make_dropout(const long long* seed, unsigned thresh, float keep,
                     int on) {
  Dropout dp;
  dp.on = on;
  dp.thresh = thresh;
  dp.keep = keep;
  dp.seed = seed;
  return dp;
}

}  // namespace

// Shared memory one forward block of R batch rows needs, in bytes (stage:
// with the weight buffers).
extern "C" long long tpurec_field_attention_smem_bytes(int R, int F, int D,
                                                       int A, int H,
                                                       int stage) {
  return FwdLayout(R, F, D, A, H, stage != 0).bytes();
}

// Shared memory one backward block needs, in bytes.
extern "C" long long tpurec_field_attention_bwd_smem_bytes(int F, int D,
                                                           int A, int H) {
  return sizeof(float) * bwd_smem_floats(F, D, A, H);
}

// weights: host array of 4 + 4*L device pointers in the Pallas kernel's
// order [w_emb, b_emb, w_res, b_res, (w_in, b_in, w_out, b_out) x L];
// w_res and b_res may be null.  dropout != 0 drops attention weights with
// the hash of the header (seed: device scalar; keep = 1 - rate); saved is
// null (eval) or [L, B, F, A] for the layer inputs.  R batch rows go to
// a block; stage: weights staged in shared memory.  Returns the
// cudaError_t of the launch.
extern "C" int tpurec_field_attention_fwd(
    const float* emb, const float* const* weights, int B, int R, int stage,
    int F, int D, int A, int H, int L, const long long* seed,
    unsigned thresh, float keep, int dropout, float* y, float* saved,
    void* stream) {
  if (bad_shape(L, H, D, A) || R < 1 || (dropout && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const long long smem =
      tpurec_field_attention_smem_bytes(R, F, D, A, H, stage);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        field_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float sqrt_hd = sqrtf(static_cast<float>(A / H));
  field_attention_kernel<<<(B + R - 1) / R, kFwdThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      emb, unpack(weights, L), B, R, F, D, A, H, L, stage, sqrt_hd,
      make_dropout(seed, thresh, keep, dropout), y, saved);
  return static_cast<int>(cudaGetLastError());
}

// The backward: dy [B, F, A] -> demb [B, F, D] and the weight gradients,
// flat in the weights' order, into wgrad [n_w].  saved [L, B, F, A] are
// the forward's layer inputs; seed/thresh/keep/dropout as in the forward.
// partial is [grid, n_w] scratch, grid <= B blocks.
extern "C" int tpurec_field_attention_bwd(
    const float* emb, const float* dy, const float* saved,
    const float* const* weights, int B, int F, int D, int A, int H, int L,
    const long long* seed, unsigned thresh, float keep, int dropout,
    int grid, float* demb, float* partial, float* wgrad, void* stream) {
  if (bad_shape(L, H, D, A) || (dropout && seed == nullptr) || grid < 1 ||
      grid > B)
    return static_cast<int>(cudaErrorInvalidValue);
  const Weights w = unpack(weights, L);
  const long long n_w = GradOffsets(D, A, w.w_res != nullptr).size(L);
  const long long smem = tpurec_field_attention_bwd_smem_bytes(F, D, A, H);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        field_attention_bwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float sqrt_hd = sqrtf(static_cast<float>(A / H));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  field_attention_bwd_kernel<<<grid, kThreads, smem, s>>>(
      emb, dy, saved, w, B, F, D, A, H, L, sqrt_hd,
      make_dropout(seed, thresh, keep, dropout), demb, partial, n_w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((n_w + 255) / 256);
  reduce_partials_kernel<<<blocks, 256, 0, s>>>(partial, grid, n_w, wgrad);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory one layer-forward block needs, in bytes.
extern "C" long long tpurec_attention_layer_smem_bytes(int F, int A, int H) {
  return sizeof(float) * (5LL * F * A + 1LL * H * F * F);
}

// Shared memory one layer-backward block needs, in bytes.
extern "C" long long tpurec_attention_layer_bwd_smem_bytes(int F, int A,
                                                           int H) {
  return sizeof(float) * layer_bwd_smem_floats(F, A, H);
}

// Kernel 4: one attention layer, x [B, F, A] -> y [B, F, A].  weights: host
// array of the 4 device pointers [w_in, b_in, w_out, b_out]; layer is the
// layer's index in the stack (it selects the dropout counters);
// seed/thresh/keep/dropout as in the stack's forward.
extern "C" int tpurec_attention_layer_fwd(
    const float* x, const float* const* weights, int B, int F, int A, int H,
    int layer, const long long* seed, unsigned thresh, float keep,
    int dropout, float* y, void* stream) {
  if (bad_heads(H, A) || layer < 0 || (dropout && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const long long smem = tpurec_attention_layer_smem_bytes(F, A, H);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float sqrt_hd = sqrtf(static_cast<float>(A / H));
  attention_layer_kernel<<<B, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      x, weights[0], weights[1], weights[2], weights[3], F, A, H, layer,
      sqrt_hd, make_dropout(seed, thresh, keep, dropout), y);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 5: its backward, dy [B, F, A] -> dx [B, F, A] and the layer's
// weight gradients flat [w_in, b_in, w_out, b_out] into wgrad, recomputing
// the layer from its input x.  partial is [grid, n_w] scratch, grid <= B.
extern "C" int tpurec_attention_layer_bwd(
    const float* x, const float* dy, const float* const* weights, int B,
    int F, int A, int H, int layer, const long long* seed, unsigned thresh,
    float keep, int dropout, int grid, float* dx, float* partial,
    float* wgrad, void* stream) {
  if (bad_heads(H, A) || layer < 0 || (dropout && seed == nullptr) ||
      grid < 1 || grid > B)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_w = LayerGradOffsets(A).size;
  const long long smem = tpurec_attention_layer_bwd_smem_bytes(F, A, H);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_layer_bwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float sqrt_hd = sqrtf(static_cast<float>(A / H));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  attention_layer_bwd_kernel<<<grid, kThreads, smem, s>>>(
      x, dy, weights[0], weights[1], weights[2], B, F, A, H, layer, sqrt_hd,
      make_dropout(seed, thresh, keep, dropout), dx, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((n_w + 255) / 256);
  reduce_partials_kernel<<<blocks, 256, 0, s>>>(partial, grid, n_w, wgrad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpurec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
