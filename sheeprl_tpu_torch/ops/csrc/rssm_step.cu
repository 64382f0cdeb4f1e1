// Fused RSSM step kernels for Hopper (sm_90a), with a plain C interface loaded
// through ctypes by sheeprl_tpu_torch/ops/rssm_step.py.
//
// Replaces: sheeprl_tpu/ops/pallas/rssm_step.py:_dyn_kernel (entry point
// rssm_dyn_step) and sheeprl_tpu/ops/pallas/rssm_step.py:_imag_kernel (entry
// point rssm_imag_step).
//
// What bounds it on this card: the dynamic step runs at the world model's batch
// (B=16 at DV3-S), so each product is a [16, K] x [K, N] with the ~5.8 M weights
// of the step read once from device memory (about 11.5 MB in bf16): it is bound
// by bytes (~3.5 us at 3.35 TB/s). The imagination step runs at B=1024 and is
// bound by operations (~6 GFLOP per step).
//
// What the design does about it: the TPU kernel holds the whole step in VMEM in
// one grid cell; a Hopper block has 227 KB of shared memory, far less than the
// step's weights. So each step is a short sequence of launches on one stream:
//   - gemm_nt2: a shared-memory tiled product with float32 accumulation,
//     C = A1 @ W1^T + A2 @ W2^T (+ bias), reading the two halves of a fused
//     [x1, x2] @ [W1; W2] product from their own pointers, so nothing is
//     concatenated; W keeps PyTorch's Linear layout [out, in], so both tiles
//     are read along K, contiguous in memory. Small batches take a 16-row tile
//     so more blocks share the weight stream; large batches a 64x64 tile.
//   - ln_rows: one block per row, LayerNorm with float32 statistics, fused with
//     the SiLU of a trunk or with the whole Hafner GRU gate algebra
//     (r, tanh(r*c), sigmoid(u-1), the blend with h0).
//   - unimix_rows: one warp per categorical, float32 softmax, the 1% uniform
//     mixture, its log, and the straight-through argmax(logits + gumbel) one-hot.
// Every intermediate is rounded to the compute dtype exactly where the plain
// PyTorch version rounds it, so kernel and plain version differ only by the
// order of float32 sums. The products use FMA on CUDA cores, not wgmma: a simple
// kernel that is right first; wgmma/TMA tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

typedef __nv_bfloat16 bf16;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// round a float32 value to the compute dtype and back (identity for float)
template <typename T> __device__ __forceinline__ float rt(float x) { return to_f<T>(from_f<T>(x)); }

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

constexpr int kBK = 32;
constexpr int kThreads = 256;

// acc += A[m0:m0+BM, :K] @ W[n0:n0+BN, :K]^T for this thread's TM x TN outputs
template <typename T, int BM, int BN, int TM, int TN>
__device__ __forceinline__ void accumulate(float (&acc)[TM][TN], float (*As)[BM + 1], float (*Ws)[BN + 1],
                                           const T* __restrict__ A, int lda, const T* __restrict__ W, int ldw,
                                           int K, int M, int N, int m0, int n0) {
  constexpr int NTX = BN / TN, NTY = BM / TM;
  const int tid = threadIdx.x, tx = tid % NTX, ty = tid / NTX;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int idx = tid; idx < BM * kBK; idx += kThreads) {
      const int r = idx / kBK, kk = idx % kBK, m = m0 + r, k = k0 + kk;
      As[kk][r] = (m < M && k < K) ? to_f<T>(A[(size_t)m * lda + k]) : 0.0f;
    }
    for (int idx = tid; idx < BN * kBK; idx += kThreads) {
      const int r = idx / kBK, kk = idx % kBK, n = n0 + r, k = k0 + kk;
      Ws[kk][r] = (n < N && k < K) ? to_f<T>(W[(size_t)n * ldw + k]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], w[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * NTY];
#pragma unroll
      for (int j = 0; j < TN; ++j) w[j] = Ws[kk][tx + j * NTX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// C[M,N] = round(round(A1 @ W1^T) + round(A2 @ W2^T)) (+ bias), rounding as the
// plain version's two products, their sum and the bias add each round.
template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads) gemm_nt2(int M, int N, const T* __restrict__ A1, int lda1,
                                                     const T* __restrict__ W1, int ldw1, int K1,
                                                     const T* __restrict__ A2, int lda2,
                                                     const T* __restrict__ W2, int ldw2, int K2,
                                                     const T* __restrict__ bias, T* __restrict__ C) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "tile shape must use every thread");
  constexpr int NTX = BN / TN, NTY = BM / TM;
  __shared__ float As[kBK][BM + 1];
  __shared__ float Ws[kBK][BN + 1];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc1[TM][TN], acc2[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc1[i][j] = acc2[i][j] = 0.0f;
  accumulate<T, BM, BN, TM, TN>(acc1, As, Ws, A1, lda1, W1, ldw1, K1, M, N, m0, n0);
  if (K2 > 0) accumulate<T, BM, BN, TM, TN>(acc2, As, Ws, A2, lda2, W2, ldw2, K2, M, N, m0, n0);
  const int tx = threadIdx.x % NTX, ty = threadIdx.x / NTX;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * NTY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * NTX;
      if (m < M && n < N) {
        float v = rt<T>(acc1[i][j]);
        if (K2 > 0) v = rt<T>(v + rt<T>(acc2[i][j]));
        if (bias != nullptr) v = rt<T>(v + to_f<T>(bias[n]));
        C[(size_t)m * N + n] = from_f<T>(v);
      }
    }
  }
}

// sum over the block, returned to every thread; red holds >= 32 floats
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = (blockDim.x + 31) >> 5;
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < nw ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

enum LnMode { kLnPlain = 0, kLnSilu = 1, kLnGru = 2 };

// One block per row of X [M, N]: y = LayerNorm(x) in float32, then
//   kLnPlain: Y = y                                   (Y [M, N])
//   kLnSilu:  Y = silu(round(y))                      (Y [M, N])
//   kLnGru:   gates = round(y) split in (r, c, u) thirds of R = N / 3,
//             Y = u*tanh(r*c) + (1-u)*H0, u = sigmoid(u - 1)   (Y [M, R])
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) ln_rows(int N, const T* __restrict__ X, const float* __restrict__ scale,
                                                    const float* __restrict__ bias, float eps, T* __restrict__ Y,
                                                    const T* __restrict__ H0) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const int m = blockIdx.x;
  const T* x = X + (size_t)m * N;
  float s = 0.0f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float v = to_f<T>(x[i]);
    row[i] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / (float)N;
  float s2 = 0.0f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float d = row[i] - mean;
    s2 += d * d;
  }
  const float inv = rsqrtf(block_sum(s2, red) / (float)N + eps);
  if (MODE == kLnGru) {
    for (int i = threadIdx.x; i < N; i += blockDim.x) row[i] = rt<T>((row[i] - mean) * inv * scale[i] + bias[i]);
    __syncthreads();
    const int R = N / 3;
    for (int j = threadIdx.x; j < R; j += blockDim.x) {
      const float r = rt<T>(sigmoidf_(row[j]));
      const float cand = rt<T>(tanhf(rt<T>(r * row[R + j])));
      const float u = rt<T>(sigmoidf_(rt<T>(row[2 * R + j] - 1.0f)));
      const float h0 = to_f<T>(H0[(size_t)m * R + j]);
      Y[(size_t)m * R + j] = from_f<T>(rt<T>(u * cand) + rt<T>(rt<T>(1.0f - u) * h0));
    }
  } else {
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      float y = (row[i] - mean) * inv * scale[i] + bias[i];
      if (MODE == kLnSilu) {
        const float v = rt<T>(y);
        y = v / (1.0f + expf(-v));
      }
      Y[(size_t)m * N + i] = from_f<T>(y);
    }
  }
}

// One block per row of raw [M, S*D]; one warp per categorical of D classes.
// logits = log((1-unimix) softmax(raw) + unimix/D) in float32 (raw itself when
// unimix == 0), written when logits != nullptr; when gumbel != nullptr, Z gets
// the one-hot of the first argmax of logits + gumbel.
template <typename T>
__global__ void __launch_bounds__(kThreads) unimix_rows(int S, int D, float mix_keep, float mix_uniform, int mix,
                                                        const T* __restrict__ raw, float* __restrict__ logits,
                                                        const float* __restrict__ gumbel, T* __restrict__ Z) {
  const int m = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int s = warp; s < S; s += nwarps) {
    const size_t base = ((size_t)m * S + s) * D;
    float mx = -INFINITY;
    for (int d = lane; d < D; d += 32) mx = fmaxf(mx, to_f<T>(raw[base + d]));
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int d = lane; d < D; d += 32) sum += expf(to_f<T>(raw[base + d]) - mx);
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    float best = -INFINITY;
    int best_i = D;
    for (int d = lane; d < D; d += 32) {
      const float x = to_f<T>(raw[base + d]);
      const float lg = mix ? logf(mix_keep * (expf(x - mx) / sum) + mix_uniform) : x;
      if (logits != nullptr) logits[base + d] = lg;
      if (gumbel != nullptr) {
        const float y = lg + gumbel[base + d];
        if (y > best) {
          best = y;
          best_i = d;
        }
      }
    }
    if (gumbel != nullptr) {
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
        if (ob > best || (ob == best && oi < best_i)) {
          best = ob;
          best_i = oi;
        }
      }
      for (int d = lane; d < D; d += 32) Z[base + d] = from_f<T>(d == best_i ? 1.0f : 0.0f);
    }
  }
}

// is_first blend: h0 = (1-f) h + f init_h, z0 likewise, am = (1-f) a
template <typename T>
__global__ void blend_first(int B, int R, int SD, int A, const T* __restrict__ init_h, const T* __restrict__ init_z,
                            const T* __restrict__ h, const T* __restrict__ z, const T* __restrict__ a,
                            const float* __restrict__ f, T* __restrict__ h0, T* __restrict__ z0, T* __restrict__ am) {
  const int W = R + SD + A;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < B * W; idx += gridDim.x * blockDim.x) {
    const int b = idx / W, c = idx % W;
    const float fb = rt<T>(f[b]), keep = rt<T>(1.0f - fb);
    if (c < R) {
      const size_t i = (size_t)b * R + c;
      h0[i] = from_f<T>(rt<T>(keep * to_f<T>(h[i])) + rt<T>(fb * to_f<T>(init_h[i])));
    } else if (c < R + SD) {
      const size_t i = (size_t)b * SD + (c - R);
      z0[i] = from_f<T>(rt<T>(keep * to_f<T>(z[i])) + rt<T>(fb * to_f<T>(init_z[i])));
    } else {
      const size_t i = (size_t)b * A + (c - R - SD);
      am[i] = from_f<T>(keep * to_f<T>(a[i]));
    }
  }
}

struct Dims {
  int B, A, E, DU, R, HT, HR, S, D;
  int ld_wi_z, ld_wi_a, ld_wg_h, ld_wg_f, ld_wt, ld_wt_head, ld_wr_h, ld_wr_e, ld_wr_head;
};

struct Scalars {
  float eps_in, eps_gru, eps_trans, eps_repr, mix_keep, mix_uniform, unimix;
};

// C[M,N] = A1 @ W1^T (+ A2 @ W2^T) (+ bias); the tile follows the batch
template <typename T>
cudaError_t gemm(cudaStream_t st, int M, int N, const void* A1, const void* W1, int ldw1, int K1, const void* A2,
                 const void* W2, int ldw2, int K2, const void* bias, void* C) {
  const T* a1 = static_cast<const T*>(A1);
  const T* a2 = static_cast<const T*>(A2);
  const T* w1 = static_cast<const T*>(W1);
  const T* w2 = static_cast<const T*>(W2);
  const T* b = static_cast<const T*>(bias);
  T* c = static_cast<T*>(C);
  if (M <= 16) {
    dim3 grid((N + 31) / 32, (M + 15) / 16);
    gemm_nt2<T, 16, 32, 1, 2><<<grid, kThreads, 0, st>>>(M, N, a1, K1, w1, ldw1, K1, a2, K2, w2, ldw2, K2, b, c);
  } else {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    gemm_nt2<T, 64, 64, 4, 4><<<grid, kThreads, 0, st>>>(M, N, a1, K1, w1, ldw1, K1, a2, K2, w2, ldw2, K2, b, c);
  }
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t layer_norm(cudaStream_t st, int M, int N, const void* X, const void* scale, const void* bias, float eps,
                       void* Y, const void* H0) {
  const size_t smem = (size_t)N * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(ln_rows<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  ln_rows<T, MODE><<<M, kThreads, smem, st>>>(N, static_cast<const T*>(X), static_cast<const float*>(scale),
                                              static_cast<const float*>(bias), eps, static_cast<T*>(Y),
                                              static_cast<const T*>(H0));
  return cudaGetLastError();
}

template <typename T>
cudaError_t unimix(cudaStream_t st, int M, const Dims& d, const Scalars& s, const void* raw, void* logits,
                   const void* gumbel, void* Z) {
  unimix_rows<T><<<M, kThreads, 0, st>>>(d.S, d.D, s.mix_keep, s.mix_uniform, s.unimix > 0.0f ? 1 : 0,
                                         static_cast<const T*>(raw), static_cast<float*>(logits),
                                         static_cast<const float*>(gumbel), static_cast<T*>(Z));
  return cudaGetLastError();
}

#define RETURN_ON_ERROR(call)            \
  do {                                   \
    cudaError_t err_ = (call);           \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

// parameter pointer slots, in PARAM_KEYS order
enum {
  P_WI_Z, P_WI_A, P_LN_I_S, P_LN_I_B, P_WG_H, P_WG_F, P_LN_G_S, P_LN_G_B, P_WT, P_LN_T_S, P_LN_T_B, P_WT_HEAD,
  P_BT_HEAD, P_WR_H, P_WR_E, P_LN_R_S, P_LN_R_B, P_WR_HEAD, P_BR_HEAD, N_PARAMS
};

// input projection -> LN -> GRU -> prior trunk -> prior head (shared by both steps)
template <typename T>
cudaError_t gru_prior(cudaStream_t st, const void* const* p, const Dims& d, const Scalars& s, const void* z0,
                      const void* am, const void* h0, void* t0, void* feat, void* u0, void* h_new, void* pt0,
                      void* pact, void* prior_raw) {
  const int B = d.B, SD = d.S * d.D;
  RETURN_ON_ERROR((gemm<T>(st, B, d.DU, z0, p[P_WI_Z], d.ld_wi_z, SD, am, p[P_WI_A], d.ld_wi_a, d.A, nullptr, t0)));
  RETURN_ON_ERROR((layer_norm<T, kLnPlain>(st, B, d.DU, t0, p[P_LN_I_S], p[P_LN_I_B], s.eps_in, feat, nullptr)));
  RETURN_ON_ERROR(
      (gemm<T>(st, B, 3 * d.R, h0, p[P_WG_H], d.ld_wg_h, d.R, feat, p[P_WG_F], d.ld_wg_f, d.DU, nullptr, u0)));
  RETURN_ON_ERROR((layer_norm<T, kLnGru>(st, B, 3 * d.R, u0, p[P_LN_G_S], p[P_LN_G_B], s.eps_gru, h_new, h0)));
  RETURN_ON_ERROR((gemm<T>(st, B, d.HT, h_new, p[P_WT], d.ld_wt, d.R, nullptr, nullptr, 0, 0, nullptr, pt0)));
  RETURN_ON_ERROR((layer_norm<T, kLnSilu>(st, B, d.HT, pt0, p[P_LN_T_S], p[P_LN_T_B], s.eps_trans, pact, nullptr)));
  RETURN_ON_ERROR(
      (gemm<T>(st, B, SD, pact, p[P_WT_HEAD], d.ld_wt_head, d.HT, nullptr, nullptr, 0, 0, p[P_BT_HEAD], prior_raw)));
  return cudaSuccess;
}

template <typename T>
cudaError_t dyn_step(cudaStream_t st, const void* const* p, const Dims& d, const Scalars& s) {
  const void* const* in = p + N_PARAMS;  // init_h init_z h z a e f g
  void* const* out = const_cast<void* const*>(p + N_PARAMS + 8);  // h_new z_new post_logits prior_logits
  void* const* scr = out + 4;  // h0 z0 am t0 feat u0 pt0 pact prior_raw q0 qact post_raw
  const int B = d.B, SD = d.S * d.D;
  const int threads = 256, total = B * (d.R + SD + d.A);
  blend_first<T><<<(total + threads - 1) / threads, threads, 0, st>>>(
      B, d.R, SD, d.A, static_cast<const T*>(in[0]), static_cast<const T*>(in[1]), static_cast<const T*>(in[2]),
      static_cast<const T*>(in[3]), static_cast<const T*>(in[4]), static_cast<const float*>(in[6]),
      static_cast<T*>(scr[0]), static_cast<T*>(scr[1]), static_cast<T*>(scr[2]));
  RETURN_ON_ERROR(cudaGetLastError());
  RETURN_ON_ERROR(gru_prior<T>(st, p, d, s, scr[1], scr[2], scr[0], scr[3], scr[4], scr[5], out[0], scr[6], scr[7],
                               scr[8]));
  RETURN_ON_ERROR(unimix<T>(st, B, d, s, scr[8], out[3], nullptr, nullptr));
  RETURN_ON_ERROR(
      (gemm<T>(st, B, d.HR, out[0], p[P_WR_H], d.ld_wr_h, d.R, in[5], p[P_WR_E], d.ld_wr_e, d.E, nullptr, scr[9])));
  RETURN_ON_ERROR((layer_norm<T, kLnSilu>(st, B, d.HR, scr[9], p[P_LN_R_S], p[P_LN_R_B], s.eps_repr, scr[10], nullptr)));
  RETURN_ON_ERROR(
      (gemm<T>(st, B, SD, scr[10], p[P_WR_HEAD], d.ld_wr_head, d.HR, nullptr, nullptr, 0, 0, p[P_BR_HEAD], scr[11])));
  return unimix<T>(st, B, d, s, scr[11], out[2], in[7], out[1]);
}

template <typename T>
cudaError_t imag_step(cudaStream_t st, const void* const* p, const Dims& d, const Scalars& s) {
  const void* const* in = p + N_PARAMS;  // h z a g
  void* const* out = const_cast<void* const*>(p + N_PARAMS + 4);  // h_new z_new
  void* const* scr = out + 2;  // t0 feat u0 pt0 pact prior_raw
  RETURN_ON_ERROR(gru_prior<T>(st, p, d, s, in[1], in[2], in[0], scr[0], scr[1], scr[2], out[0], scr[3], scr[4],
                               scr[5]));
  return unimix<T>(st, d.B, d, s, scr[5], nullptr, in[3], out[1]);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. ptrs: the 19 parameters in PARAM_KEYS order,
// then init_h init_z h z a e f g, then h_new z_new post_logits prior_logits,
// then 12 scratch buffers. Returns the first CUDA error of the launches, or 0.
int rssm_dyn_step(int dtype, const void* const* ptrs, const int* dims, const float* scalars, void* stream) {
  const Dims& d = *reinterpret_cast<const Dims*>(dims);
  const Scalars& s = *reinterpret_cast<const Scalars*>(scalars);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? dyn_step<float>(st, ptrs, d, s) : dyn_step<bf16>(st, ptrs, d, s));
}

// ptrs: the 19 parameters, then h z a g, then h_new z_new, then 6 scratch buffers.
int rssm_imag_step(int dtype, const void* const* ptrs, const int* dims, const float* scalars, void* stream) {
  const Dims& d = *reinterpret_cast<const Dims*>(dims);
  const Scalars& s = *reinterpret_cast<const Scalars*>(scalars);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? imag_step<float>(st, ptrs, d, s) : imag_step<bf16>(st, ptrs, d, s));
}

const char* rssm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
