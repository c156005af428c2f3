// Field-attention stack: forward (kernel 2, eval and training) and its
// backward (kernel 3).
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
// all rows and stay in L2.
//
// Forward design: one block per batch row keeps all of that row's
// intermediates in shared memory (emb [F,D], x [F,A], qkv [F,3A], o [F,A],
// scores [H,F,F]: about 35 KB at the shapes above), so nothing but emb,
// y and the saved inputs touches device memory; the L layers loop inside
// the block.  Without tensor cores the work is float32 FMAs, and what
// holds them back is the loads that feed them: each projection gives a
// thread a 4x4 tile of outputs (four rows of the field stack by four
// columns) and walks k four at a time with 16-byte loads, so one load
// feeds four FMAs; the score and attention-weighted sums tile the same
// way over 4 keys or 4 columns.  Softmax subtracts the row maximum, as
// jax.nn.softmax does.
//
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

// saved: null, or [L, B, F, A] for the layer inputs (training).  At most
// 64 registers a thread, so that 4 blocks fit an SM and B=512 rows run in
// one wave on 132 SMs (at 66 registers only 3 fit, and B=512 took two).
__global__ void __launch_bounds__(kThreads, 4)
    field_attention_kernel(const float* __restrict__ emb, Weights w, int B,
                           int F, int D, int A, int H, int L, float sqrt_hd,
                           Dropout dp, float* __restrict__ y,
                           float* __restrict__ saved) {
  extern __shared__ float4 smem4[];
  float* e = reinterpret_cast<float*>(smem4);  // [F, D]
  float* x = e + F * D;                        // [F, A]
  float* qkv = x + F * A;                      // [F, 3A]
  float* o = qkv + F * 3 * A;                  // [F, A]
  float* s = o + F * A;                        // [H, F, F]
  const long long row = blockIdx.x;
  const uint32_t key = row_key(dp, row);
  const long long FA = static_cast<long long>(F) * A;

  for (int i = threadIdx.x; i < F * D; i += blockDim.x)
    e[i] = emb[row * F * D + i];
  __syncthreads();
  dense(e, F, D, w.w_emb, w.b_emb, A, x);
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    if (saved != nullptr) {
      float* sv = saved + (l * static_cast<long long>(B) + row) * FA;
      for (int i = threadIdx.x; i < F * A / 4; i += blockDim.x)
        st4(sv + 4 * i, ld4(x + 4 * i));
    }
    dense(x, F, A, w.w_in[l], w.b_in[l], 3 * A, qkv);
    __syncthreads();
    attend(qkv, s, s, o, F, A, H, l, sqrt_hd, dp, key);
    dense(o, F, A, w.w_out[l], w.b_out[l], A, x);
    __syncthreads();
  }

  // y = relu(x + (emb @ w_res + b_res)), the residual staged in o
  if (w.w_res != nullptr) {
    dense(e, F, D, w.w_res, w.b_res, A, o);
    __syncthreads();
  }
  float4* yr = reinterpret_cast<float4*>(y + row * FA);
  for (int i = threadIdx.x; i < F * A / 4; i += blockDim.x) {
    float4 v = reinterpret_cast<const float4*>(x)[i];
    if (w.w_res != nullptr) v = add4(v, reinterpret_cast<const float4*>(o)[i]);
    yr[i] = make_float4(relu(v.x), relu(v.y), relu(v.z), relu(v.w));
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

__global__ void __launch_bounds__(kThreads)
    field_attention_bwd_kernel(const float* __restrict__ emb,
                               const float* __restrict__ dy,
                               const float* __restrict__ saved, Weights w,
                               int B, int F, int D, int A, int H, int L,
                               float sqrt_hd, Dropout dp,
                               float* __restrict__ demb,
                               float* __restrict__ partial, long long n_w) {
  extern __shared__ float4 smem4[];
  const int hd = A / H;
  const int ld = 3 * A;
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
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
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
      // out-projection backward
      wgrad(o, dx, F, A, A, part + go.w_out(l, A), part + go.b_out(l, A),
            first);
      dense_t(dx, F, A, w.w_out[l], A, dO, false);
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
          for (int t = 0; t < 4; ++t)
            acc[t] = dot4(dv, ld4(vr[t] + d), acc[t]);
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
      wgrad(xin, dqkv, F, A, 3 * A, part + go.w_in(l, A),
            part + go.b_in(l, A), first);
      dense_t(dqkv, F, 3 * A, w.w_in[l], A, dx, false);
      __syncthreads();
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

bool bad_shape(int L, int H, int D, int A) {
  return L < 1 || L > TPUREC_ATTN_MAX_LAYERS || H <= 0 || A % H != 0 ||
         D % 4 != 0 || A % 4 != 0 || (A / H) % 4 != 0;
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

// Shared memory one forward block needs, in bytes.
extern "C" long long tpurec_field_attention_smem_bytes(int F, int D, int A,
                                                       int H) {
  return sizeof(float) *
         (static_cast<long long>(F) * D + 5LL * F * A + 1LL * H * F * F);
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
// null (eval) or [L, B, F, A] for the layer inputs.  Returns the
// cudaError_t of the launch.
extern "C" int tpurec_field_attention_fwd(
    const float* emb, const float* const* weights, int B, int F, int D,
    int A, int H, int L, const long long* seed, unsigned thresh, float keep,
    int dropout, float* y, float* saved, void* stream) {
  if (bad_shape(L, H, D, A) || (dropout && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const long long smem = tpurec_field_attention_smem_bytes(F, D, A, H);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        field_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float sqrt_hd = sqrtf(static_cast<float>(A / H));
  field_attention_kernel<<<B, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      emb, unpack(weights, L), B, F, D, A, H, L, sqrt_hd,
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

extern "C" const char* tpurec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
