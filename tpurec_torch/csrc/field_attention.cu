// Field-attention stack, forward in eval mode (kernel 2).
//
// Replaces the forward of tpurec/ops/attention_pallas.py::
// fused_field_attention (_fwd_kernel, run by _run_fwd) with dropout off:
//
//   x = emb @ w_emb + b_emb                                   [F, A]
//   L times:  qkv = x @ w_in + b_in                           [F, 3A]
//             per head h: a = softmax(q_h k_h^T / sqrt(hd))   [F, F]
//                         o_h = a @ v_h                       [F, hd]
//             x = o @ w_out + b_out                           [F, A]
//   y = relu(x + emb @ w_res + b_res)     (no residual when w_res is null)
//
// for every batch row.  Weights are [in, out] as the JAX package stores
// them, in the Pallas kernel's flat order.
//
// Bound on the H100: float32 operations.  Per batch row the stack does
// 2*F*D*A*2 + L*(2*F*A*3A + 4*H*F*F*hd + 2*F*A*A) flops, about 2.76 MFLOP at
// F=23, D=16, A=64, H=2, L=3, against about 6 KB of input and output; the
// weights (about 210 KB) are shared by all rows and stay in L2.
//
// Design: one block per batch row keeps all of that row's intermediates in
// shared memory (emb [F,D], x [F,A], qkv [F,3A], o [F,A], scores [H,F,F]:
// about 35 KB at the shapes above), so nothing but emb and y touches
// device memory; the L layers loop inside the block.  Without tensor
// cores the work is float32 FMAs, and what holds them back is the loads
// that feed them: each projection gives a thread a 4x4 tile of outputs
// (four rows of the field stack by four columns) and walks k four at a
// time with 16-byte loads, so one shared-memory load of x and one load of
// w feed four FMAs each, instead of one FMA per load; the score and
// attention-weighted sums tile the same way over 4 keys or 4 columns.
// Sums run in order over k, as in the plain version.  Softmax subtracts
// the row maximum, as jax.nn.softmax does.  The 16-byte loads need D, A
// and A/H to be multiples of 4 and 16-byte aligned tensors; the wrapper
// checks both.

#include <cuda_runtime.h>
#include <math.h>

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

// acc += s * v, component-wise
__device__ __forceinline__ void fma4(float4& acc, float s, float4 v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
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
      if (m0 + t < M)
        *reinterpret_cast<float4*>(y + (m0 + t) * N + n0) =
            make_float4(acc[t].x + bn.x, acc[t].y + bn.y, acc[t].z + bn.z,
                        acc[t].w + bn.w);
  }
}

__global__ void __launch_bounds__(kThreads)
    field_attention_kernel(const float* __restrict__ emb, Weights w, int F,
                           int D, int A, int H, int L, float sqrt_hd,
                           float* __restrict__ y) {
  extern __shared__ float4 smem4[];
  float* e = reinterpret_cast<float*>(smem4);  // [F, D]
  float* x = e + F * D;                        // [F, A]
  float* qkv = x + F * A;                      // [F, 3A]
  float* o = qkv + F * 3 * A;                  // [F, A]
  float* s = o + F * A;                        // [H, F, F]
  const int hd = A / H;
  const int ld = 3 * A;  // row stride of qkv
  const long long row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int i = threadIdx.x; i < F * D; i += blockDim.x)
    e[i] = emb[row * F * D + i];
  __syncthreads();
  dense(e, F, D, w.w_emb, w.b_emb, A, x);
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    dense(x, F, A, w.w_in[l], w.b_in[l], 3 * A, qkv);
    __syncthreads();
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
        for (int t = 0; t < 4; ++t) {
          const float4 kv = ld4(kr[t] + d);
          acc[t] = fmaf(qv.x, kv.x, acc[t]);
          acc[t] = fmaf(qv.y, kv.y, acc[t]);
          acc[t] = fmaf(qv.z, kv.z, acc[t]);
          acc[t] = fmaf(qv.w, kv.w, acc[t]);
        }
      }
      float* sr = s + (h * F + f) * F;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (g0 + t < F) sr[g0 + t] = acc[t] / sqrt_hd;
    }
    __syncthreads();
    // softmax over g, one warp per (h, f) row
    for (int r = warp; r < H * F; r += n_warps) {
      float* sr = s + r * F;
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
      for (int g = lane; g < F; g += 32) sr[g] = sr[g] / sum;
    }
    __syncthreads();
    // o[f, c0..c0+3] = sum_g a[h, f, g] * v[g, c0..c0+3]  (h = c0 / hd)
    for (int i = threadIdx.x; i < F * (A / 4); i += blockDim.x) {
      const int f = i / (A / 4), c0 = (i % (A / 4)) * 4;
      const float* a = s + ((c0 / hd) * F + f) * F;
      const float* v = qkv + 2 * A + c0;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int g = 0; g < F; ++g) fma4(acc, a[g], ld4(v + g * ld));
      *reinterpret_cast<float4*>(o + f * A + c0) = acc;
    }
    __syncthreads();
    dense(o, F, A, w.w_out[l], w.b_out[l], A, x);
    __syncthreads();
  }

  // y = relu(x + (emb @ w_res + b_res)), the residual staged in o
  if (w.w_res != nullptr) {
    dense(e, F, D, w.w_res, w.b_res, A, o);
    __syncthreads();
  }
  float4* yr = reinterpret_cast<float4*>(y + row * F * A);
  for (int i = threadIdx.x; i < F * A / 4; i += blockDim.x) {
    float4 v = reinterpret_cast<const float4*>(x)[i];
    if (w.w_res != nullptr) {
      const float4 r = reinterpret_cast<const float4*>(o)[i];
      v = make_float4(v.x + r.x, v.y + r.y, v.z + r.z, v.w + r.w);
    }
    yr[i] = make_float4(relu(v.x), relu(v.y), relu(v.z), relu(v.w));
  }
}

}  // namespace

// Shared memory one block needs, in bytes.
extern "C" long long tpurec_field_attention_smem_bytes(int F, int D, int A,
                                                       int H) {
  return sizeof(float) *
         (static_cast<long long>(F) * D + 5LL * F * A + 1LL * H * F * F);
}

// weights: host array of 4 + 4*L device pointers in the Pallas kernel's
// order [w_emb, b_emb, w_res, b_res, (w_in, b_in, w_out, b_out) x L];
// w_res and b_res may be null.  Returns the cudaError_t of the launch.
extern "C" int tpurec_field_attention_fwd(const float* emb,
                                          const float* const* weights, int B,
                                          int F, int D, int A, int H, int L,
                                          float* y, void* stream) {
  if (L < 0 || L > TPUREC_ATTN_MAX_LAYERS || H <= 0 || A % H != 0 ||
      D % 4 != 0 || A % 4 != 0 || (A / H) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
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
      emb, w, F, D, A, H, L, sqrt_hd, y);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpurec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
