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
// the attention (scores, softmax, dropout, ad @ v) runs per batch row
// over that row's F x F block (its products in 3xTF32 too), with the row
// maximum subtracted as jax.nn.softmax does.  Shared memory holds x [M,
// A] (the scores [R, H, F, F] reuse it while x is dead), qkv [M, 3A] (o
// overwrites q; emb is staged there before the first layer and again for
// the residual) and two weight buffers: about 171 KB at R=4 and the
// flagship shapes (where the weights do not fit beside a block's
// activations, the products read them from device memory instead).
// Strides keep a warp's MMA fragment loads
// on 32 distinct banks.  The attention of one (batch row, head, 16-field
// tile) is one warp's work from scores to ad @ v, with no block barrier;
// the three TF32 passes of a k step are issued tile by tile so that no
// product waits on the one before it.  Kernel 4, one layer, is this
// kernel's layer body (layer_rows) with the same layout and launch.

// Backward design (field_attention_bwd_kernel, kernel 3, and
// attention_layer_bwd_kernel, kernel 5): the forward's layout run
// backwards.  A block of 512 threads stacks R batch rows (the wrapper
// picks R: 2 at the flagship shapes) into M = R*F rows padded to 16, and
// every projection of the backward is one 3xTF32 tensor-core product over
// them: the recomputed x @ w_in, the last layer's o @ w_out and emb @
// w_res (one product over the concatenated [o | emb]), dx @ w_out^T, dqkv
// @ w_in^T, dx @ w_res^T, dx @ w_emb^T, and the weight gradients o^T @ dx,
// x^T @ dqkv, emb^T @ dx, whose reduction runs over the M stacked rows.
// w_in and w_out of a layer are staged in shared memory by cp.async, the
// next layer's once the current one's are read, so each weight crosses L2
// once per block of R rows (before, 6 times per row per product).  The
// attention of one (batch row, head, 16-field tile) is one warp's work:
// the recomputed softmax with row maxima and sums across the four lanes
// of a fragment row, kept with its dropout decision in the sign bit (a
// dropped weight is stored negated, so no buffer of dropped weights is
// needed); d_adrop = dO_h v_h^T, the mask and the softmax backward in
// registers, then dq = ds k; dk = ds^T q and dv = adrop^T dO reduce over
// the query fields, so they take units keyed by key-field tile after a
// barrier.  Warps the attention leaves idle take the out-projection's
// weight gradient meanwhile, and the bias gradients are column sums by
// the warps a phase's products leave without a unit.  Each k step's big
// and small 3xTF32 passes start from zero and are added in float32, and
// the backward rounds the low part to TF32 too: the tensor core's own
// truncated sums, accumulated, flipped ReLU masks and cost demb 1e-4.
// Shared memory at the flagship shapes and R=2: 225,408 B (220 KB).
// Shapes whose weights do not fit read them from device memory, or stack
// one row a group (BwdLayout).
//
// The weight gradients are sums over all rows.  The grid is persistent,
// at most one block per SM; a block walks its groups of R rows and adds
// each group's contribution into its own slice of a [grid, n_w] partial
// buffer (one thread always owns the same elements; the block's first
// group writes instead of adding, so nothing needs zeroing), 27.5 MB for
// kernel 3 at most, inside the 50 MB L2.  reduce_partials_kernel then sums
// the slices in a fixed order: deterministic, unlike float atomics.
// Batch rows never mix outside those sums: rows past the last batch row
// are zeros, and fields past F read as 0 and are not stored.

// The 16-byte loads need D, A and A/H to be multiples of 4 and 16-byte
// aligned tensors; the wrapper checks both.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TPUREC_ATTN_MAX_LAYERS 8

namespace {

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

// dst [M, ld] in shared memory = rows 0..n-1 of src [., width] (16-byte
// aligned, width % 4 == 0), zeros from row n on, by cp.async (a
// zero-filled copy past n); not committed: the caller's next commit takes
// these copies into its group
__device__ __forceinline__ void copy_rows(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int width, int M, int n) {
  const int wq = width / 4;
  for (int i = threadIdx.x; i < M * wq; i += blockDim.x) {
    const int m = i / wq, c = (i - m * wq) * 4;
    const unsigned d = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + m * ld + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(m < n ? src + static_cast<long long>(m) * width + c : src),
                 "r"(m < n ? 16 : 0)
                 : "memory");
  }
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

// One attention layer on R stacked batch rows, the body of kernel 2's
// layer loop and the whole of kernel 4: qkv = x @ w_in + b_in (x in xs,
// [M, ldx]), the attention of each batch row (o over q, the scores in xs
// while x is dead), then o @ w_out + b_out handed to out(m, n, v0, v1).
// The weights come from ops(): {w_in, b_in} before the in-projection and
// {w_out, b_out} before the out-projection, each weight in shared memory
// (or in device memory when not staged) at row stride lwi or lwo; asked
// for only where a product starts, so that no pointer stays live across
// the steps before it.  Copy groups: the one before the most recent
// holds what the in-projection reads (w_in, or kernel 4's x), the most
// recent w_out; after_in() commits one more group (the next weights, or
// none) between the two products.  Ends synced.
struct LayerOperands {
  const float* w;
  const float* b;
};

template <typename In, typename AfterIn, typename OutW, typename Out>
__device__ __forceinline__ void layer_rows(
    float* xs, int ldx, float* qkv, int ldq, int lds, int M, int R, int F,
    int A, int H, int l, float sqrt_hd, const Dropout& dp, long long row0,
    In in_ops, int lwi, AfterIn after_in, OutW out_ops, int lwo, Out out) {
  wait_staged<1>();                                   // w_in (and x)
  __syncthreads();
  const LayerOperands wi = in_ops();
  mma_dense<3>(xs, ldx, M, A, wi.w, lwi, wi.b, 3 * A,
               [&](int m, int n, float v0, float v1) {
                 *reinterpret_cast<float2*>(qkv + m * ldq + n) =
                     make_float2(v0, v1);
               });
  __syncthreads();
  after_in();
  attend_rows(qkv, ldq, xs, lds, R, F, A, H, l, sqrt_hd, dp, row0);
  wait_staged<1>();                                   // w_out
  __syncthreads();
  const LayerOperands wo = out_ops();
  mma_dense<1>(qkv, ldq, M, A, wo.w, lwo, wo.b, A, out);
  __syncthreads();
}

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
    layer_rows(xs, ldx, qkv, ldq, lay.lds, M, R, F, A, H, l, sqrt_hd, dp,
               row0,
               [&] { return LayerOperands{stage ? wa : w.w_in[l], w.b_in[l]}; },
               lwa,
               [&]() {
                 if (!stage) return;
                 if (l + 1 < L)
                   stage_weight(wa, lwa, w.w_in[l + 1], A, 3 * A);
                 else if (w.w_res != nullptr)
                   stage_weight(wa, lwr, w.w_res, D, A);
                 else
                   commit_nothing();
               },
               [&] {
                 return LayerOperands{stage ? wb : w.w_out[l], w.b_out[l]};
               },
               lwb, to_x);
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

// -- the backward (kernels 3 and 5): R batch rows a block --------------------

// split_tf32 with lo rounded to TF32 as well: the tensor core drops the
// low 13 bits of an operand, which for an unrounded lo costs up to 2^-21
// of |x|; rounded, 2^-22, about float32's own rounding of a product.  lo
// is rounded in floating point (Veltkamp's split by 2^13 + 1), not by the
// integer add hi uses: that add carries a NaN's payload into the sign and
// makes it -0, and lo is what carries a NaN (hi's add already lost it)
__device__ __forceinline__ void split_tf32_rn(float x, uint32_t& hi,
                                              uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const float r = x - __uint_as_float(hi);
  const float c = __fmul_rn(r, 8193.f);
  lo = __float_as_uint(__fsub_rn(c, __fsub_rn(c, r)));
}

// d = a b: one m16n8k8 TF32 product into a fresh accumulator
__device__ __forceinline__ void mma_tf32_fresh(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// acc[mt][j] += a_mt b_j: one k step of 3xTF32 products from raw fragments
// (a: rows g, g + 8 by columns t, t + 4; b_j: rows t, t + 4 by column g of
// tile j).  The tensor core truncates its sum to the larger addend's
// precision, so accumulating every pass into acc would lose about 2^-23
// of |acc| a pass, which the backward's long chains of products turn
// into ReLU-mask flips and demb errors near 1e-4.  So the step's small
// passes (a_lo b_hi + a_hi b_lo) and its big one (a_hi b_hi) each start
// from zero, two independent chains, and are added to acc in float32.
template <int MT, int NG>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NG][4],
                                         const float (&av)[MT][4],
                                         const float (&bv)[NG][2]) {
  uint32_t ah[MT][4], al[MT][4], bh[NG][2], bl[NG][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      split_tf32_rn(av[mt][c], ah[mt][c], al[mt][c]);
#pragma unroll
  for (int j = 0; j < NG; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) split_tf32_rn(bv[j][c], bh[j][c], bl[j][c]);
  float sm[MT][NG][4], bg[MT][NG][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NG; ++j)
      mma_tf32_fresh(sm[mt][j], al[mt], bh[j][0], bh[j][1]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NG; ++j)
      mma_tf32_fresh(bg[mt][j], ah[mt], bh[j][0], bh[j][1]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NG; ++j)
      mma_tf32(sm[mt][j], ah[mt], bl[j][0], bl[j][1]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][j][c] += bg[mt][j][c] + sm[mt][j][c];
}

// out[m, n] = sum_{k < K} a(m, k) b(k, n) for m < M and n < N (N even),
// handed over as epi(m, n, out[m, n], out[m, n + 1]).  The operands come
// from loaders, so one routine serves plain, transposed and concatenated
// operands in shared or device memory; a loader is called only inside the
// bounds, and what lies past them reads as 0.  A unit of work is MT m16
// row tiles by NG n8 column tiles; the warps take the units in turn,
// starting at warp `first`, so that two products of one phase share the
// warps out.  The k loop is not unrolled: unrolled, the backward kernels
// spill.  -> the number of units.
template <int MT, int NG, typename LA, typename LB, typename Epi>
__device__ __forceinline__ int mma_gemm(int M, int N, int K, LA la, LB lb,
                                        Epi epi, int first = 0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_groups = ((N + 7) / 8 + NG - 1) / NG;
  const int units = ((M + 15) / 16 + MT - 1) / MT * n_groups;
  for (int u = (warp + n_warps - first % n_warps) % n_warps; u < units;
       u += n_warps) {
    const int m0 = (u / n_groups) * 16 * MT + g;
    const int n0 = (u % n_groups) * NG * 8;
    float acc[MT][NG][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][j][c] = 0.f;
#pragma unroll 1
    for (int k0 = t; k0 < K + t; k0 += 8) {
      const int k1 = k0 + 4;
      const bool ok0 = k0 < K, ok1 = k1 < K;
      float av[MT][4], bv[NG][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = m0 + mt * 16, r1 = r0 + 8;
        av[mt][0] = ok0 && r0 < M ? la(r0, k0) : 0.f;
        av[mt][1] = ok0 && r1 < M ? la(r1, k0) : 0.f;
        av[mt][2] = ok1 && r0 < M ? la(r0, k1) : 0.f;
        av[mt][3] = ok1 && r1 < M ? la(r1, k1) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int c = n0 + j * 8 + g;
        bv[j][0] = ok0 && c < N ? lb(k0, c) : 0.f;
        bv[j][1] = ok1 && c < N ? lb(k1, c) : 0.f;
      }
      mma_step<MT, NG>(acc, av, bv);
    }
    // d[g][2t, 2t+1] and d[g + 8][2t, 2t+1] of each tile
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int n = n0 + j * 8 + 2 * t;
      if (n >= N) continue;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* v = acc[mt][j];
        const int m = m0 + mt * 16;
        if (m < M) epi(m, n, v[0], v[1]);
        if (m + 8 < M) epi(m + 8, n, v[2], v[3]);
      }
    }
  }
  return units;
}

// One warp's [16, 32] tile: acc = sum_{k < K} la(i, k) lb(k, j) for the
// fragment rows i (g, g + 8) and the tile's columns j (0..31); the loaders
// return 0 past their rows and columns.  acc[0][j][c] is row (c < 2 ? g :
// g + 8), column 8j + 2t + (c & 1).
template <typename LA, typename LB>
__device__ __forceinline__ void warp_tile(float (&acc)[1][4][4], int K, LA la,
                                          LB lb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[0][j][c] = 0.f;
  for (int k0 = t; k0 < K + t; k0 += 8) {
    const int k1 = k0 + 4;
    const bool ok0 = k0 < K, ok1 = k1 < K;
    float av[1][4], bv[4][2];
    av[0][0] = ok0 ? la(g, k0) : 0.f;
    av[0][1] = ok0 ? la(g + 8, k0) : 0.f;
    av[0][2] = ok1 ? la(g, k1) : 0.f;
    av[0][3] = ok1 ? la(g + 8, k1) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j][0] = ok0 ? lb(k0, j * 8 + g) : 0.f;
      bv[j][1] = ok1 ? lb(k1, j * 8 + g) : 0.f;
    }
    mma_step<1, 4>(acc, av, bv);
  }
}

// Calls fn(i, col, j, c) for the positions of a warp_tile fragment that
// lie inside rows < rows and columns < cols: tile row i and column col,
// held in acc[0][j][c]
template <typename Fn>
__device__ __forceinline__ void for_fragment(int rows, int cols, Fn fn) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = c < 2 ? g : g + 8, col = j * 8 + 2 * t + (c & 1);
      if (i < rows && col < cols) fn(i, col, j, c);
    }
}

// Sum (or max) of v over the four lanes that hold one fragment row
__device__ __forceinline__ float row_sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float row_max4(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ void st2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// A dropped weight from the softmax kept with its dropout decision in the
// sign bit (see BwdRows::attend)
__device__ __forceinline__ float dropped(float p, float inv_keep) {
  return __float_as_uint(p) >> 31 ? 0.f : p * inv_keep;
}

// The weight gradient of a projection y = x @ w + b over the block's
// stacked rows, added into this block's partial slice: g[k, n] (+)= sum_m
// x[m, k] y[m, n] for k < K, n < N, as an MMA whose reduction runs over
// the M rows (x read transposed).  x and y rows past the batch rows are
// zeros.  `first` writes instead of adding.  -> units, as mma_gemm.
template <int MT, int NG>
__device__ __forceinline__ int wgrad(const float* x, int ldx, const float* y,
                                     int ldy, int M, int K, int N, float* g,
                                     bool first, int first_warp) {
  return mma_gemm<MT, NG>(
      K, N, M, [&](int k, int m) { return x[m * ldx + k]; },
      [&](int m, int n) { return y[m * ldy + n]; },
      [&](int k, int n, float v0, float v1) {
        float* p = g + k * N + n;
        if (!first) {
          const float2 o = *reinterpret_cast<const float2*>(p);
          v0 = o.x + v0;
          v1 = o.y + v1;
        }
        st2(p, v0, v1);
      },
      first_warp);
}

// The backward's shared memory, in floats: w_in [A, 3A] and w_out [A, A]
// staged (with `stage`; else the products read them from device memory),
// qkv and dqkv [M, 3A], the layer input xin, o, dO and dx [M, A],
// the softmax with its dropout signs s and the score gradients ds [R*H*F,
// F], and for the stack (D > 0) emb and demb's residual part [M, D].  M =
// R*F padded to whole m16 tiles.  Row strides as the forward's.
constexpr int kBwdRowUnit = 16;

struct BwdLayout {
  int M, lde, ldx, ldq, lds, lwa, lwb;
  long long wa_floats, wb_floats, q_floats, x_floats, s_floats, e_floats;
  __host__ __device__ BwdLayout(int R, int F, int D, int A, int H,
                                bool stage) {
    M = (R * F + kBwdRowUnit - 1) / kBwdRowUnit * kBwdRowUnit;
    lde = fwd_stride(D);
    ldx = fwd_stride(A);
    ldq = fwd_stride(3 * A);
    lds = fwd_stride(F);
    lwa = fwd_wstride(3 * A);
    lwb = fwd_wstride(A);
    wa_floats = stage ? static_cast<long long>(A) * lwa : 0;
    wb_floats = stage ? static_cast<long long>(A) * lwb : 0;
    q_floats = static_cast<long long>(M) * ldq;
    x_floats = static_cast<long long>(M) * ldx;
    s_floats = static_cast<long long>(R) * H * F * lds;
    e_floats = D > 0 ? static_cast<long long>(M) * lde : 0;
  }
  __host__ __device__ long long bytes() const {
    return 4 * (wa_floats + wb_floats + 2 * q_floats + 4 * x_floats +
                2 * s_floats + 2 * e_floats);
  }
};

// The bias gradient beside a weight gradient: gb[n] (+)= sum_{m < rows}
// y[m, n] for n < N, one thread a column in a fixed order.  The threads
// are counted from warp `first_warp` on, the first that the phase's
// products left without a unit, so that idle warps take the sums.
// `first` writes instead of adding.
__device__ __forceinline__ void col_sums(const float* y, int ldy, int rows,
                                         int N, float* gb, bool first,
                                         int first_warp) {
  const int n_threads = blockDim.x;
  const int i = (threadIdx.x + n_threads -
                 32 * (first_warp % (n_threads >> 5))) % n_threads;
  for (int n = i; n < N; n += n_threads) {
    float s = 0.f;
    for (int m = 0; m < rows; ++m) s += y[m * ldy + n];
    gb[n] = first ? s : gb[n] + s;
  }
}

// One backward block's buffers in shared memory and its current group of
// R batch rows (from row0; n_real stacked rows of them lie before B).
struct BwdRows {
  float *wa, *wb, *qkv, *dqkv, *xin, *o, *dO, *dx, *s, *ds, *e, *de;
  int M, lde, ldx, ldq, lds, lwa, lwb;
  int R, F, A, H, n_real;
  long long row0;

  __device__ BwdRows(float4* smem, int R_, int F_, int D, int A_, int H_,
                     bool stage)
      : R(R_), F(F_), A(A_), H(H_), n_real(0), row0(0) {
    const BwdLayout lay(R, F, D, A, H, stage);
    M = lay.M;
    lde = lay.lde;
    ldx = lay.ldx;
    ldq = lay.ldq;
    lds = lay.lds;
    lwa = lay.lwa;
    lwb = lay.lwb;
    wa = reinterpret_cast<float*>(smem);
    wb = wa + lay.wa_floats;
    qkv = wb + lay.wb_floats;
    dqkv = qkv + lay.q_floats;
    xin = dqkv + lay.q_floats;
    o = xin + lay.x_floats;
    dO = o + lay.x_floats;
    dx = dO + lay.x_floats;
    s = dx + lay.x_floats;
    ds = s + lay.s_floats;
    e = ds + lay.s_floats;
    de = e + lay.e_floats;
    // rows R*F.. of o and dqkv: written by no attention unit, zero for
    // good
    const int tail = (M - R * F) * ldx, tailq = (M - R * F) * ldq;
    for (int i = threadIdx.x; i < tailq; i += blockDim.x) {
      if (i < tail) o[R * F * ldx + i] = 0.f;
      dqkv[R * F * ldq + i] = 0.f;
    }
  }

  // Starts group `grp`: its first batch row and its stacked rows before B
  __device__ void start(long long grp, int B) {
    row0 = grp * R;
    n_real = static_cast<int>(min(static_cast<long long>(R), B - row0)) * F;
  }

  // dst [M, ld] = this group's rows of src [., width], zeros past B, by
  // cp.async (a zero-filled copy past B), committed as one group: the
  // caller's wait_staged<0> and barrier make it visible
  __device__ void load(float* dst, int ld, const float* __restrict__ src,
                       int width) const {
    const int wq = width / 4;
    const float* base = src + row0 * F * width;
    for (int i = threadIdx.x; i < M * wq; i += blockDim.x) {
      const int m = i / wq, c = (i - m * wq) * 4;
      const unsigned d = static_cast<unsigned>(
          __cvta_generic_to_shared(dst + m * ld + c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                   "l"(m < n_real ? base + static_cast<long long>(m) * width + c
                                  : src),
                   "r"(m < n_real ? 16 : 0)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }

  // The layer's internals from xin: qkv = xin @ w_in + b_in, then attend.
  // Starts and ends synced.
  __device__ void recompute(const float* w_in, int lw,
                            const float* __restrict__ b_in, int l,
                            float sqrt_hd, const Dropout& dp) const {
    mma_gemm<3, 2>(
        M, 3 * A, A, [&](int m, int k) { return xin[m * ldx + k]; },
        [&](int k, int n) { return w_in[k * lw + n]; },
        [&](int m, int n, float v0, float v1) {
          st2(qkv + m * ldq + n, v0 + __ldg(b_in + n),
              v1 + __ldg(b_in + n + 1));
        });
    __syncthreads();
    attend(l, sqrt_hd, dp);
  }

  // The attention of one (batch row r, head h, 16 fields f) per warp: the
  // scores q_h[f] k_h^T / sqrt(hd) into s, their softmax over the row (the
  // row maximum subtracted; maxima and sums across the four lanes of a
  // row), kept in s with each dropped weight negated (its sign bit is the
  // dropout decision, -0 for a dropped 0), then o_h[f] = adrop_h[f] @ v_h.
  // Ends synced.
  __device__ void attend(int l, float sqrt_hd, const Dropout& dp) const {
    const int hd = A / H;
    const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
    const int f_tiles = (F + 15) / 16;
    const float inv_sqrt_hd = 1.f / sqrt_hd, inv_keep = 1.f / dp.keep;
    for (int u = warp; u < R * H * f_tiles; u += n_warps) {
      const int rh = u / f_tiles, r = rh / H, h = rh - r * H;
      const int ft = (u - rh * f_tiles) * 16, rows = min(16, F - ft);
      const float* q = qkv + (r * F + ft) * ldq + h * hd;
      const float* k = qkv + r * F * ldq + A + h * hd;
      const float* v = k + A;
      float* p = s + (rh * F + ft) * lds;
      float mx[2] = {-INFINITY, -INFINITY};
      for (int n0 = 0; n0 < F; n0 += 32) {
        float acc[1][4][4];
        warp_tile(
            acc, hd, [&](int i, int d) { return i < rows ? q[i * ldq + d] : 0.f; },
            [&](int d, int j) {
              return n0 + j < F ? k[(n0 + j) * ldq + d] : 0.f;
            });
        for_fragment(rows, F - n0, [&](int i, int col, int j, int c) {
          const float x = acc[0][j][c] * inv_sqrt_hd;
          p[i * lds + n0 + col] = x;
          mx[c >> 1] = fmaxf(mx[c >> 1], x);
        });
      }
      mx[0] = row_max4(mx[0]);
      mx[1] = row_max4(mx[1]);
      float sum[2] = {0.f, 0.f};
      for (int n0 = 0; n0 < F; n0 += 32)
        for_fragment(rows, F - n0, [&](int i, int col, int, int c) {
          float* x = p + i * lds + n0 + col;
          *x = expf(*x - mx[c >> 1]);
          sum[c >> 1] += *x;
        });
      const float inv_sum[2] = {1.f / row_sum4(sum[0]),
                                1.f / row_sum4(sum[1])};
      const uint32_t key = row_key(dp, row0 + r);
      for (int n0 = 0; n0 < F; n0 += 32)
        for_fragment(rows, F - n0, [&](int i, int col, int, int c) {
          float* x = p + i * lds + n0 + col;
          const float pv = *x * inv_sum[c >> 1];
          const uint32_t ctr = static_cast<uint32_t>(
              ((l * H + h) * F + ft + i) * F + n0 + col);
          *x = dp.on && !kept(key, ctr, dp.thresh) ? -pv : pv;
        });
      __syncwarp();
      float* ob = o + (r * F + ft) * ldx + h * hd;
      for (int n0 = 0; n0 < hd; n0 += 32) {
        float acc[1][4][4];
        warp_tile(
            acc, F,
            [&](int i, int gk) {
              return i < rows ? dropped(p[i * lds + gk], inv_keep) : 0.f;
            },
            [&](int gk, int j) {
              return n0 + j < hd ? v[gk * ldq + n0 + j] : 0.f;
            });
        for_fragment(rows, hd - n0, [&](int i, int col, int j, int c) {
          ob[i * ldx + n0 + col] = acc[0][j][c];
        });
      }
    }
    __syncthreads();
  }

  // The attention backward by query tile: for one (batch row, head, 16
  // fields f) a warp takes d_adrop = dO_h v_h^T, d_a = keep ? d_adrop /
  // (1 - rate) : 0 into ds with its row sums sum_g d_a * a, ds = (d_a -
  // row sum) * a / sqrt(hd) in place, then dq = ds k into dqkv.  -> the
  // number of units.
  __device__ int attn_bwd_queries(float sqrt_hd, const Dropout& dp) const {
    const int hd = A / H;
    const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
    const int f_tiles = (F + 15) / 16;
    const float inv_sqrt_hd = 1.f / sqrt_hd, inv_keep = 1.f / dp.keep;
    for (int u = warp; u < R * H * f_tiles; u += n_warps) {
      const int rh = u / f_tiles, r = rh / H, h = rh - r * H;
      const int ft = (u - rh * f_tiles) * 16, rows = min(16, F - ft);
      const float* dOh = dO + (r * F + ft) * ldx + h * hd;
      const float* k = qkv + r * F * ldq + A + h * hd;
      const float* v = k + A;
      const float* p = s + (rh * F + ft) * lds;
      float* d = ds + (rh * F + ft) * lds;
      float sum[2] = {0.f, 0.f};
      for (int n0 = 0; n0 < F; n0 += 32) {
        float acc[1][4][4];
        warp_tile(
            acc, hd, [&](int i, int c) { return i < rows ? dOh[i * ldx + c] : 0.f; },
            [&](int c, int j) {
              return n0 + j < F ? v[(n0 + j) * ldq + c] : 0.f;
            });
        for_fragment(rows, F - n0, [&](int i, int col, int j, int c) {
          const float pv = p[i * lds + n0 + col];
          const float da = __float_as_uint(pv) >> 31 ? 0.f
                                                      : acc[0][j][c] * inv_keep;
          d[i * lds + n0 + col] = da;
          sum[c >> 1] = fmaf(da, fabsf(pv), sum[c >> 1]);
        });
      }
      sum[0] = row_sum4(sum[0]);
      sum[1] = row_sum4(sum[1]);
      for (int n0 = 0; n0 < F; n0 += 32)
        for_fragment(rows, F - n0, [&](int i, int col, int, int c) {
          float* x = d + i * lds + n0 + col;
          *x = (*x - sum[c >> 1]) * fabsf(p[i * lds + n0 + col]) * inv_sqrt_hd;
        });
      __syncwarp();
      float* dq = dqkv + (r * F + ft) * ldq + h * hd;
      for (int n0 = 0; n0 < hd; n0 += 32) {
        float acc[1][4][4];
        warp_tile(
            acc, F, [&](int i, int gk) { return i < rows ? d[i * lds + gk] : 0.f; },
            [&](int gk, int j) {
              return n0 + j < hd ? k[gk * ldq + n0 + j] : 0.f;
            });
        for_fragment(rows, hd - n0, [&](int i, int col, int j, int c) {
          dq[i * ldq + n0 + col] = acc[0][j][c];
        });
      }
    }
    return R * H * f_tiles;
  }

  // The attention backward by key tile: for one (batch row, head, 16
  // fields gk) a warp takes dk = ds^T q or (the next unit) dv = adrop^T
  // dO, each a sum over the query fields, into dqkv.
  __device__ void attn_bwd_keys(const Dropout& dp) const {
    const int hd = A / H;
    const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
    const int f_tiles = (F + 15) / 16;
    const float inv_keep = 1.f / dp.keep;
    for (int u = warp; u < 2 * R * H * f_tiles; u += n_warps) {
      const bool dv = u & 1;
      const int w = u >> 1, rh = w / f_tiles, r = rh / H, h = rh - r * H;
      const int gt = (w - rh * f_tiles) * 16, rows = min(16, F - gt);
      // A [gk, f]: ds or the dropped weights, read transposed
      const float* at = (dv ? s : ds) + rh * F * lds + gt;
      const float* b = dv ? dO + r * F * ldx + h * hd
                          : qkv + r * F * ldq + h * hd;
      const int ldb = dv ? ldx : ldq;
      float* out = dqkv + (r * F + gt) * ldq + (dv ? 2 * A : A) + h * hd;
      for (int n0 = 0; n0 < hd; n0 += 32) {
        float acc[1][4][4];
        warp_tile(
            acc, F,
            [&](int i, int f) {
              if (i >= rows) return 0.f;
              const float x = at[f * lds + i];
              return dv ? dropped(x, inv_keep) : x;
            },
            [&](int f, int j) {
              return n0 + j < hd ? b[f * ldb + n0 + j] : 0.f;
            });
        for_fragment(rows, hd - n0, [&](int i, int col, int j, int c) {
          out[i * ldq + n0 + col] = acc[0][j][c];
        });
      }
    }
  }

  // One layer's backward from dx (the gradient at its output) and its
  // recomputed internals: dO = dx @ w_out^T; the attention backward into
  // dqkv, its query units on the first warps while the others take the
  // out-projection's weight gradients (and extra_a(units), a product of
  // the caller's); the in-projection's weight gradients and dqkv @ w_in^T
  // handed to dx_epi.  The next weights (null: none) are staged once the
  // current ones are read.  Starts and ends synced.
  template <typename ExtraA, typename DxEpi>
  __device__ void layer(const float* w_in, int lwi, const float* w_out,
                        int lwo, float sqrt_hd, const Dropout& dp,
                        float* g_w_in, float* g_b_in, float* g_w_out,
                        float* g_b_out, bool first,
                        const float* __restrict__ next_w_in,
                        const float* __restrict__ next_w_out, ExtraA extra_a,
                        DxEpi dx_epi) const {
    col_sums(dx, ldx, n_real, A, g_b_out, first,
             mma_gemm<1, 2>(
                 M, A, A, [&](int m, int k) { return dx[m * ldx + k]; },
                 [&](int k, int n) { return w_out[n * lwo + k]; },
                 [&](int m, int n, float v0, float v1) {
                   st2(dO + m * ldx + n, v0, v1);
                 }));
    __syncthreads();
    if (next_w_out != nullptr) stage_weight(wb, lwb, next_w_out, A, A);
    const int q_units = attn_bwd_queries(sqrt_hd, dp);
    extra_a(wgrad<1, 2>(o, ldx, dx, ldx, M, A, A, g_w_out, first, q_units) +
            q_units);
    __syncthreads();
    attn_bwd_keys(dp);
    __syncthreads();
    int u = wgrad<1, 4>(xin, ldx, dqkv, ldq, M, A, 3 * A, g_w_in, first, 0);
    u += mma_gemm<1, 2>(
        M, A, 3 * A, [&](int m, int k) { return dqkv[m * ldq + k]; },
        [&](int k, int n) { return w_in[n * lwi + k]; }, dx_epi, u);
    col_sums(dqkv, ldq, n_real, 3 * A, g_b_in, first, u);
    __syncthreads();
    if (next_w_in != nullptr) stage_weight(wa, lwa, next_w_in, A, 3 * A);
  }
};

// Kernel 3.  A persistent grid: block b takes the groups of R batch rows
// b, b + gridDim.x, ...  Per group: the last layer recomputed from its
// saved input, the ReLU's mask from the recomputed output (dx = dy where
// it passed), then layer by layer backwards (each layer's internals
// recomputed from its saved input), the residual's and the embedding
// projection's gradients, and demb written per row.  The weight gradients
// go into the block's slice of partial [grid, n_w].  kStage: w_in and
// w_out staged in shared memory, else read from device memory.
template <bool kStage>
__global__ void __launch_bounds__(kFwdThreads, 1)
    field_attention_bwd_kernel(const float* __restrict__ emb,
                               const float* __restrict__ dy,
                               const float* __restrict__ saved, Weights w,
                               int B, int R, int F, int D, int A, int H, int L,
                               float sqrt_hd, Dropout dp,
                               float* __restrict__ demb,
                               float* __restrict__ partial, long long n_w) {
  extern __shared__ float4 smem4[];
  BwdRows b(smem4, R, F, D, A, H, kStage);
  const bool res = w.w_res != nullptr;
  const GradOffsets go(D, A, res);
  float* part = partial + blockIdx.x * n_w;
  const long long groups = (B + R - 1) / R;
  const long long FA = static_cast<long long>(F) * A;
  if (kStage) {
    stage_weight(b.wa, b.lwa, w.w_in[L - 1], A, 3 * A);
    stage_weight(b.wb, b.lwb, w.w_out[L - 1], A, A);
  }
  const int lwi = kStage ? b.lwa : 3 * A, lwo = kStage ? b.lwb : A;
  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const bool first = grp == blockIdx.x;
    const bool more = grp + gridDim.x < groups;
    b.start(grp, B);
    b.load(b.e, b.lde, emb, D);
    b.load(b.dx, b.ldx, dy, A);
    for (int l = L - 1; l >= 0; --l) {
      b.load(b.xin, b.ldx, saved + static_cast<long long>(l) * B * FA, A);
      wait_staged<0>();
      __syncthreads();
      const float* w_in = kStage ? b.wa : w.w_in[l];
      const float* w_out = kStage ? b.wb : w.w_out[l];
      b.recompute(w_in, lwi, w.b_in[l], l, sqrt_hd, dp);
      const bool last = l == L - 1;
      if (last) {
        // z = o @ w_out + emb @ w_res + (b_out + b_res), one product over
        // [o | emb]; dx = dy where z > 0, else 0 (torch.relu's backward)
        const float* b_out = w.b_out[l];
        mma_gemm<1, 2>(
            b.M, A, A + (res ? D : 0),
            [&](int m, int k) {
              return k < A ? b.o[m * b.ldx + k] : b.e[m * b.lde + k - A];
            },
            [&](int k, int n) {
              return k < A ? w_out[k * lwo + n]
                           : __ldg(w.w_res + (k - A) * A + n);
            },
            [&](int m, int n, float v0, float v1) {
              float z0 = v0 + __ldg(b_out + n), z1 = v1 + __ldg(b_out + n + 1);
              if (res) {
                z0 += __ldg(w.b_res + n);
                z1 += __ldg(w.b_res + n + 1);
              }
              float* p = b.dx + m * b.ldx + n;
              st2(p, z0 > 0.f ? p[0] : 0.f, z1 > 0.f ? p[1] : 0.f);
            });
        __syncthreads();
      }
      const int nl = l > 0 ? l - 1 : L - 1;
      const bool next = kStage && (l > 0 || more);
      b.layer(
          w_in, lwi, w_out, lwo, sqrt_hd, dp, part + go.w_in(l, A),
          part + go.b_in(l, A), part + go.w_out(l, A), part + go.b_out(l, A),
          first, next ? w.w_in[nl] : nullptr, next ? w.w_out[nl] : nullptr,
          [&](int u) {
            if (!(last && res)) return;
            // the residual: its weight gradients and dz @ w_res^T
            u += wgrad<1, 2>(b.e, b.lde, b.dx, b.ldx, b.M, D, A,
                             part + go.w_res, first, u);
            u += mma_gemm<1, 2>(
                b.M, D, A, [&](int m, int k) { return b.dx[m * b.ldx + k]; },
                [&](int k, int n) { return __ldg(w.w_res + n * A + k); },
                [&](int m, int n, float v0, float v1) {
                  st2(b.de + m * b.lde + n, v0, v1);
                },
                u);
            col_sums(b.dx, b.ldx, b.n_real, A, part + go.b_res, first, u);
          },
          [&](int m, int n, float v0, float v1) {
            st2(b.dx + m * b.ldx + n, v0, v1);
          });
    }
    // the embedding projection: its weight gradients, demb = (dz @
    // w_res^T) + dx @ w_emb^T
    int u = wgrad<1, 2>(b.e, b.lde, b.dx, b.ldx, b.M, D, A, part + go.w_emb,
                        first, 0);
    float* de_out = demb + b.row0 * F * D;
    u += mma_gemm<1, 2>(
        b.M, D, A, [&](int m, int k) { return b.dx[m * b.ldx + k]; },
        [&](int k, int n) { return __ldg(w.w_emb + n * A + k); },
        [&](int m, int n, float v0, float v1) {
          if (m >= b.n_real) return;
          if (res) {
            const float2 r =
                *reinterpret_cast<const float2*>(b.de + m * b.lde + n);
            v0 = r.x + v0;
            v1 = r.y + v1;
          }
          st2(de_out + static_cast<long long>(m) * D + n, v0, v1);
        },
        u);
    col_sums(b.dx, b.ldx, b.n_real, A, part + go.b_emb, first, u);
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
// 2,478,848 per row against 17.7 KB (B=512: 18.9 us, 2.7 us).  Both issue
// their products in 3xTF32 on the tensor cores: 3 x the flops at the TF32
// peak is 2.8 us (forward) and 7.7 us (backward) at B=512.  Unlike the
// stack's layers, kernel 4 cannot hide its first weights' staging behind
// an earlier layer.

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

// Kernel 4: layer_rows as a kernel of its own, with kernel 2's layout
// (FwdLayout without the embedding operands) and launch: R batch rows a
// block stacked into M rows (the last block's rows past B are zeros and
// are not stored).  x arrives by cp.async with w_in, w_out in the next
// copy group while the in-projection runs (or both products read their
// weights from device memory, without `stage`); y is written from the
// out-projection's epilogue, real rows only.
__global__ void __launch_bounds__(kFwdThreads, 1)
    attention_layer_kernel(const float* __restrict__ x,
                           const float* __restrict__ w_in,
                           const float* __restrict__ b_in,
                           const float* __restrict__ w_out,
                           const float* __restrict__ b_out, int B, int R,
                           int F, int A, int H, int layer, int stage,
                           float sqrt_hd, Dropout dp, float* __restrict__ y) {
  extern __shared__ float4 smem4[];
  const FwdLayout lay(R, F, 0, A, H, stage != 0);
  float* xs = reinterpret_cast<float*>(smem4);  // x; the scores
  float* qkv = xs + lay.xs_floats;              // qkv (o over q)
  float* wa = qkv + lay.q_floats;               // w_in
  float* wb = wa + lay.wa_floats;               // w_out
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int n_real = static_cast<int>(min(static_cast<long long>(R),
                                          B - row0)) * F;  // stacked rows
  const long long FA = static_cast<long long>(F) * A;
  copy_rows(xs, lay.ldx, x + row0 * FA, A, lay.M, n_real);
  if (stage)
    stage_weight(wa, lay.lwa, w_in, A, 3 * A);        // with x
  else
    commit_nothing();                                 // x alone
  if (stage)
    stage_weight(wb, lay.lwb, w_out, A, A);
  else
    commit_nothing();
  float* yb = y + row0 * FA;
  layer_rows(xs, lay.ldx, qkv, lay.ldq, lay.lds, lay.M, R, F, A, H, layer,
             sqrt_hd, dp, row0,
             [&] { return LayerOperands{stage ? wa : w_in, b_in}; },
             stage ? lay.lwa : 3 * A, [] { commit_nothing(); },
             [&] { return LayerOperands{stage ? wb : w_out, b_out}; },
             stage ? lay.lwb : A,
             [&](int m, int n, float v0, float v1) {
               if (m < n_real)
                 st2(yb + static_cast<long long>(m) * A + n, v0, v1);
             });
}

// Kernel 5: the backward's layout for one layer.  A persistent grid: block
// b takes the groups of R batch rows b, b + gridDim.x, ...; per group it
// recomputes the layer from x and runs BwdRows::layer from dy; dx is
// written per row, the weight gradients into the block's slice of partial
// [grid, n_w].  kStage as kernel 3's.
template <bool kStage>
__global__ void __launch_bounds__(kFwdThreads, 1)
    attention_layer_bwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ dy,
                               const float* __restrict__ w_in,
                               const float* __restrict__ b_in,
                               const float* __restrict__ w_out, int B, int R,
                               int F, int A, int H, int layer, float sqrt_hd,
                               Dropout dp, float* __restrict__ dx_out,
                               float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  BwdRows b(smem4, R, F, 0, A, H, kStage);
  const LayerGradOffsets go(A);
  float* part = partial + blockIdx.x * go.size;
  const long long groups = (B + R - 1) / R;
  if (kStage) {
    stage_weight(b.wa, b.lwa, w_in, A, 3 * A);
    stage_weight(b.wb, b.lwb, w_out, A, A);
  }
  const float* wi = kStage ? b.wa : w_in;
  const float* wo = kStage ? b.wb : w_out;
  const int lwi = kStage ? b.lwa : 3 * A, lwo = kStage ? b.lwb : A;
  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const bool first = grp == blockIdx.x;
    const bool next = kStage && grp + gridDim.x < groups;
    b.start(grp, B);
    b.load(b.xin, b.ldx, x, A);
    b.load(b.dx, b.ldx, dy, A);
    wait_staged<0>();
    __syncthreads();
    b.recompute(wi, lwi, b_in, layer, sqrt_hd, dp);
    float* out = dx_out + b.row0 * F * A;
    b.layer(wi, lwi, wo, lwo, sqrt_hd, dp, part + go.w_in, part + go.b_in,
            part + go.w_out, part + go.b_out, first,
            next ? w_in : nullptr, next ? w_out : nullptr, [](int) {},
            [&](int m, int n, float v0, float v1) {
              if (m < b.n_real)
                st2(out + static_cast<long long>(m) * A + n, v0, v1);
            });
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

// Shared memory one backward block of R batch rows needs, in bytes
// (stage: with the weight buffers).
extern "C" long long tpurec_field_attention_bwd_smem_bytes(int R, int F,
                                                           int D, int A,
                                                           int H, int stage) {
  return BwdLayout(R, F, D, A, H, stage != 0).bytes();
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
// R batch rows go to a block (stage: weights staged in shared memory);
// partial is [grid, n_w] scratch, grid <= the B / R groups of rows.
extern "C" int tpurec_field_attention_bwd(
    const float* emb, const float* dy, const float* saved,
    const float* const* weights, int B, int R, int stage, int F, int D,
    int A, int H, int L, const long long* seed, unsigned thresh, float keep,
    int dropout, int grid, float* demb, float* partial, float* wgrad,
    void* stream) {
  if (bad_shape(L, H, D, A) || R < 1 || (dropout && seed == nullptr) ||
      grid < 1 || grid > (B + R - 1) / R)
    return static_cast<int>(cudaErrorInvalidValue);
  const Weights w = unpack(weights, L);
  const long long n_w = GradOffsets(D, A, w.w_res != nullptr).size(L);
  const long long smem =
      tpurec_field_attention_bwd_smem_bytes(R, F, D, A, H, stage);
  auto kernel = stage ? field_attention_bwd_kernel<true>
                      : field_attention_bwd_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float sqrt_hd = sqrtf(static_cast<float>(A / H));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<grid, kFwdThreads, smem, s>>>(
      emb, dy, saved, w, B, R, F, D, A, H, L, sqrt_hd,
      make_dropout(seed, thresh, keep, dropout), demb, partial, n_w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((n_w + 255) / 256);
  reduce_partials_kernel<<<blocks, 256, 0, s>>>(partial, grid, n_w, wgrad);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory one layer-forward block of R batch rows needs, in bytes
// (stage: with the weight buffers).
extern "C" long long tpurec_attention_layer_smem_bytes(int R, int F, int A,
                                                       int H, int stage) {
  return FwdLayout(R, F, 0, A, H, stage != 0).bytes();
}

// Shared memory one layer-backward block of R batch rows needs, in bytes.
extern "C" long long tpurec_attention_layer_bwd_smem_bytes(int R, int F,
                                                           int A, int H,
                                                           int stage) {
  return BwdLayout(R, F, 0, A, H, stage != 0).bytes();
}

// Kernel 4: one attention layer, x [B, F, A] -> y [B, F, A].  weights: host
// array of the 4 device pointers [w_in, b_in, w_out, b_out]; layer is the
// layer's index in the stack (it selects the dropout counters);
// seed/thresh/keep/dropout as in the stack's forward.  R batch rows go to
// a block; stage: w_in and w_out staged in shared memory.
extern "C" int tpurec_attention_layer_fwd(
    const float* x, const float* const* weights, int B, int R, int stage,
    int F, int A, int H, int layer, const long long* seed, unsigned thresh,
    float keep, int dropout, float* y, void* stream) {
  if (bad_heads(H, A) || R < 1 || layer < 0 || (dropout && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const long long smem = tpurec_attention_layer_smem_bytes(R, F, A, H, stage);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float sqrt_hd = sqrtf(static_cast<float>(A / H));
  attention_layer_kernel<<<(B + R - 1) / R, kFwdThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      x, weights[0], weights[1], weights[2], weights[3], B, R, F, A, H, layer,
      stage, sqrt_hd, make_dropout(seed, thresh, keep, dropout), y);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 5: its backward, dy [B, F, A] -> dx [B, F, A] and the layer's
// weight gradients flat [w_in, b_in, w_out, b_out] into wgrad, recomputing
// the layer from its input x.  R batch rows go to a block (stage: weights
// staged); partial is [grid, n_w] scratch, grid <= the B / R groups.
extern "C" int tpurec_attention_layer_bwd(
    const float* x, const float* dy, const float* const* weights, int B,
    int R, int stage, int F, int A, int H, int layer, const long long* seed,
    unsigned thresh, float keep, int dropout, int grid, float* dx,
    float* partial, float* wgrad, void* stream) {
  if (bad_heads(H, A) || R < 1 || layer < 0 ||
      (dropout && seed == nullptr) || grid < 1 || grid > (B + R - 1) / R)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_w = LayerGradOffsets(A).size;
  const long long smem =
      tpurec_attention_layer_bwd_smem_bytes(R, F, A, H, stage);
  auto kernel = stage ? attention_layer_bwd_kernel<true>
                      : attention_layer_bwd_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float sqrt_hd = sqrtf(static_cast<float>(A / H));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<grid, kFwdThreads, smem, s>>>(
      x, dy, weights[0], weights[1], weights[2], B, R, F, A, H, layer,
      sqrt_hd, make_dropout(seed, thresh, keep, dropout), dx, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((n_w + 255) / 256);
  reduce_partials_kernel<<<blocks, 256, 0, s>>>(partial, grid, n_w, wgrad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpurec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
