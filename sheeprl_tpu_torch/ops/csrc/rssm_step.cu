// Fused RSSM step kernels for Hopper (sm_90a), with a plain C interface loaded
// through ctypes by sheeprl_tpu_torch/ops/rssm_step.py.
//
// Replaces: sheeprl_tpu/ops/pallas/rssm_step.py:_dyn_kernel (entry point
// rssm_dyn_step) and sheeprl_tpu/ops/pallas/rssm_step.py:_imag_kernel (entry
// point rssm_imag_step). The TPU kernels hold a whole step in VMEM in one grid
// cell; a Hopper block has 227 KB of shared memory, far less than the step's
// ~11.5 MB of bf16 weights, so each entry point is its own design.
//
// rssm_dyn_step runs at the world model's batch (B=16 at DV3-S). Its six
// products read ~5.8 M weights once for 16 rows: it is bound by bytes (~3.6 us
// at 3.35 TB/s). Design: ONE persistent cooperative launch (one 512-thread
// block per SM, grid-wide barriers between nine phases). In a product phase,
// each warp of the grid takes units of 16 rows x 8 columns x a K chunk (split-K
// planned in Python by rssm_step.dyn_plan, the one place that sizes and lays
// out the partial sums, so that each product spreads over every SM), streams
// its weight rows with 16-byte loads, four in flight, straight into
// mma.sync.m16n8k16 fragments (no shared memory: each weight is used once),
// and writes float32 partial sums. The next phase sums the partials in a fixed
// order (deterministic, no float atomics) inside the row pass that needs them:
// LayerNorm (+ SiLU, or the GRU gate algebra) one block per row, the unimix /
// sample one 8-lane group per categorical. The e @ wr_e half (41 % of the bytes) and
// the h0 @ wg_h half depend only on the step's inputs, so they run in the first
// two phases beside the blend and the input projection.
//
// rssm_imag_step runs at B=1024 and is bound by operations (~5.9 GFLOP). Design:
// each product is a bf16 tensor-core tile kernel: one warpgroup per 64x64
// output tile issues wgmma.m64n64k16 on operands in shared memory, fed by a
// four-stage ring of 16-byte cp.async copies in the 128-byte swizzled layout,
// float32 accumulation. 64x64 tiles give 128-384 blocks per product at M=1024:
// every product is one wave at three blocks per SM (larger tiles left SMs idle
// or ran slower, PERF.md). LayerNorm stays a row pass (one block per row) and
// unimix a pass of one 8-lane group per categorical: eight launches a step.
//
// Both: the action half of [z, a] @ [wi_z; wi_a] has K = action size (2 on
// discrete_dummy), far below an MMA's depth, so it is a rank-A update on CUDA
// cores in the epilogue. Each half of a two-operand product keeps its own
// accumulator, and every intermediate is rounded to the compute dtype exactly
// where the plain PyTorch version rounds it (each product, the sum of the two
// halves, the bias add, every GRU gate op); LayerNorm statistics, softmax,
// unimix and log stay float32. Kernel and plain version differ only by the
// order of float32 sums.
//
// float32 compute keeps CUDA-core FMA products (16-byte loads, the same grid
// layouts): no tensor-core path keeps float32 to rtol 1e-4 (TF32 keeps about
// three digits). That is a dtype specialisation, not a fallback.
//
// Preconditions, checked by the wrapper: every K width of a tensor-core operand
// is a multiple of 8 (16 bytes of bf16), matrices are contiguous and 16-byte
// aligned (rssm_step.compute_params repacks them once per scan/horizon), and
// the widest row pass fits the card's opt-in shared memory per block
// (rssm_step.smem_floats: 160 KB for dyn at DV3-XL, R = 4096, of 227 KB).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

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

// a value written earlier in the same launch: load through L2, not L1
template <typename T> __device__ __forceinline__ float ldcg_f(const T* p);
template <> __device__ __forceinline__ float ldcg_f<float>(const float* p) { return __ldcg(p); }
template <> __device__ __forceinline__ float ldcg_f<bf16>(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// ---------------------------------------------------------------------------
// tensor-core and copy primitives
// ---------------------------------------------------------------------------

// d += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulation
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                          uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy; src_bytes == 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// ---------------------------------------------------------------------------
// row math shared by both entry points
// ---------------------------------------------------------------------------

// sum over the block, returned to every thread; red holds >= 32 floats
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = (blockDim.x + 31) >> 5;
  __syncthreads();  // red may still be read from a previous call; row[] writes become visible
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

// The block holds one row x of width N (float values of the rounded product)
// in shared memory, visible to every thread (kLnGru: and the row of H0 after
// it, row[N:N+N/3]); y = LayerNorm(x) with float32 statistics, then
//   kLnPlain: Y = y                                   (Y [N])
//   kLnSilu:  Y = silu(round(y))                      (Y [N])
//   kLnGru:   gates = round(y) split in (r, c, u) thirds of R = N / 3,
//             Y = u*tanh(r*c) + (1-u)*H0, u = sigmoid(u - 1)   (Y [R])
// Every thread of the block calls it.
template <typename T, int MODE>
__device__ void ln_finish(float* row, int N, const float* __restrict__ scale, const float* __restrict__ bias,
                          float eps, T* __restrict__ Y, float* red) {
  const int t0 = threadIdx.x, nt = blockDim.x;
  float s = 0.0f;
  for (int i = t0; i < N; i += nt) s += row[i];
  const float mean = block_sum(s, red) / (float)N;
  float s2 = 0.0f;
  for (int i = t0; i < N; i += nt) {
    const float d = row[i] - mean;
    s2 += d * d;
  }
  const float inv = rsqrtf(block_sum(s2, red) / (float)N + eps);
  if (MODE == kLnGru) {
    for (int i = t0; i < N; i += nt) row[i] = rt<T>((row[i] - mean) * inv * scale[i] + bias[i]);
    __syncthreads();
    const int R = N / 3;
    for (int j = t0; j < R; j += nt) {
      const float r = rt<T>(sigmoidf_(row[j]));
      const float cand = rt<T>(tanhf(rt<T>(r * row[R + j])));
      const float u = rt<T>(sigmoidf_(rt<T>(row[2 * R + j] - 1.0f)));
      const float h0 = row[N + j];
      Y[j] = from_f<T>(rt<T>(u * cand) + rt<T>(rt<T>(1.0f - u) * h0));
    }
  } else {
    for (int i = t0; i < N; i += nt) {
      float y = (row[i] - mean) * inv * scale[i] + bias[i];
      if (MODE == kLnSilu) {
        const float v = rt<T>(y);
        y = v / (1.0f + expf(-v));
      }
      Y[i] = from_f<T>(y);
    }
  }
}

constexpr int kCatLanes = 8;  // lanes of one categorical

// One group of kCatLanes lanes, one categorical of D classes whose raw head
// outputs x (rounded, float) lie in shared memory: logits = log((1-unimix)
// softmax(x) + unimix/D) in float32 (x itself when unimix == 0), written when
// logits != nullptr; when gumbel != nullptr, Z gets the one-hot of the first
// argmax of logits + gumbel. Every lane of the warp calls it (the shuffles span
// the warp); a group with active == false computes nothing it writes.
template <typename T>
__device__ void unimix_cat(bool active, float* x, int D, float mix_keep, float mix_uniform, int mix,
                           float* logits, const float* __restrict__ gumbel, T* Z) {
  const int sub = threadIdx.x & (kCatLanes - 1), n = active ? D : 0;
  float mx = -INFINITY;
  for (int d = sub; d < n; d += kCatLanes) mx = fmaxf(mx, x[d]);
  for (int o = kCatLanes / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.0f;
  for (int d = sub; d < n; d += kCatLanes) {
    const float e = expf(x[d] - mx);
    sum += e;
    if (mix) x[d] = e;  // this lane's own element: read back below by the same lane
  }
  for (int o = kCatLanes / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  float best = -INFINITY;
  int best_i = D;
  for (int d = sub; d < n; d += kCatLanes) {
    const float lg = mix ? logf(mix_keep * (x[d] / sum) + mix_uniform) : x[d];
    if (logits != nullptr) logits[d] = lg;
    if (gumbel != nullptr) {
      const float y = lg + gumbel[d];
      if (y > best) {
        best = y;
        best_i = d;
      }
    }
  }
  if (gumbel != nullptr) {
    for (int o = kCatLanes / 2; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
      if (ob > best || (ob == best && oi < best_i)) {
        best = ob;
        best_i = oi;
      }
    }
    for (int d = sub; d < n; d += kCatLanes) Z[d] = from_f<T>(d == best_i ? 1.0f : 0.0f);
  }
}

// sum_j R[j] * W[j] over a rank-KR update (the action half), float32
template <typename T>
__device__ __forceinline__ float rank_dot(const T* r, const T* __restrict__ w, int KR) {
  float s = 0.0f;
  for (int j = 0; j < KR; ++j) s = fmaf(ldcg_f<T>(r + j), to_f<T>(w[j]), s);
  return s;
}

// C = round(round(round(acc1) + round(acc2)) + bias), acc2 the second half's
// product when there is one, as the plain version rounds its two products,
// their sum and the bias add
template <typename T>
__device__ __forceinline__ float epilogue(float acc1, float acc2, bool two, const T* bias, int n) {
  float v = rt<T>(acc1);
  if (two) v = rt<T>(v + rt<T>(acc2));
  if (bias != nullptr) v = rt<T>(v + to_f<T>(bias[n]));
  return v;
}

// ---------------------------------------------------------------------------
// rssm_imag_step: tile products for a large batch
// ---------------------------------------------------------------------------

// C[M,N] = A1 @ W1^T (+ A2 @ W2^T, or + R @ WR^T on CUDA cores) (+ bias)
struct TileArgs {
  int M, N;
  const void *A1, *W1;
  int lda1, ldw1, K1;
  const void *A2, *W2;
  int lda2, ldw2, K2;
  const void *R, *WR;
  int ldr, ldwr, KR;
  const void* bias;
  void* C;
};

// Tensor-core product: one warpgroup (four warps) per 64 x 64 output tile,
// wgmma.m64n64k16 reading both operands from shared memory. Each 64-deep K
// chunk of A [64 x 64] and W [64 x 64] arrives through a kWgStages-deep ring
// of 16-byte cp.async copies written in the 128-byte swizzled layout that the
// wgmma descriptors name (16-byte chunk c of row r at chunk c ^ (r % 8), each
// tile 1024-byte aligned), so no thread reads the operands into registers. The
// copies run kWgStages - 1 chunks ahead of the products. (Keeping one chunk's
// products in flight over the next copies, at two chunks ahead, and 64 x 32
// tiles both measured slower at the imagination step's shapes.)
constexpr int kWgStages = 4, kWgTile = 64 * 128;  // bytes of one 64 x 64 bf16 tile
constexpr int kWgSmem = kWgStages * 2 * kWgTile + 1024;  // the ring, plus alignment slack

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// cp.async's writes become visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// d[64 x 64] += A[64 x 16] W[64 x 16]^T; thread element (j, e) of d is row
// 16 warp + lane/4 + 8 (e/2), column 8 j + 2 (lane%4) + e%2
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(128) gemm_bf16_wgmma_64x64(const TileArgs t) {
  constexpr int BM = 64, BN = 64, BK = 64, STAGES = kWgStages, NJ = BN / 8;
  extern __shared__ __align__(1024) unsigned char ring_raw[];
  unsigned char* ring =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(ring_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int c1 = (t.K1 + BK - 1) / BK, nchunks = c1 + (t.K2 + BK - 1) / BK;
  // Thread tid copies 16-byte chunk ch = tid % 8 of rows r0 + 16 i (i < 4) of
  // both operands in every K chunk: its row pointers, masks and swizzled
  // offsets (chunk ch of row r at chunk ch ^ (r % 8)) are fixed for the launch.
  const int r0 = tid >> 3, ch = tid & 7, off0 = r0 * 128 + ((ch ^ (r0 & 7)) << 4);
  const bf16* A1 = static_cast<const bf16*>(t.A1) + (size_t)min(m0 + r0, t.M - 1) * t.lda1 + ch * 8;
  const bf16* W1 = static_cast<const bf16*>(t.W1) + (size_t)min(n0 + r0, t.N - 1) * t.ldw1 + ch * 8;
  const bf16* A2 = t.K2 > 0 ? static_cast<const bf16*>(t.A2) + (size_t)min(m0 + r0, t.M - 1) * t.lda2 + ch * 8 : A1;
  const bf16* W2 = t.K2 > 0 ? static_cast<const bf16*>(t.W2) + (size_t)min(n0 + r0, t.N - 1) * t.ldw2 + ch * 8 : W1;
  unsigned a_rows = 0, w_rows = 0;  // bit i: row r0 + 16 i lies inside the matrix
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a_rows |= (unsigned)(m0 + r0 + 16 * i < t.M) << i;
    w_rows |= (unsigned)(n0 + r0 + 16 * i < t.N) << i;
  }

  // chunk c of the concatenated K loop [half 1 | half 2]; masked rows and K
  // tails are filled with zeros
  auto load_chunk = [&](int c, int stage) {
    const bool first = c < c1;
    const int k0 = (first ? c : c - c1) * BK, K = first ? t.K1 : t.K2;
    const bool k_ok = k0 + ch * 8 < K;
    const bf16* A = (first ? A1 : A2) + k0;
    const bf16* W = (first ? W1 : W2) + k0;
    const size_t a_step = (size_t)16 * (first ? t.lda1 : t.lda2), w_step = (size_t)16 * (first ? t.ldw1 : t.ldw2);
    unsigned char* as = ring + (size_t)stage * 2 * kWgTile + off0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool a_ok = k_ok && ((a_rows >> i) & 1), w_ok = k_ok && ((w_rows >> i) & 1);
      cp_async16(as + i * 2048, a_ok ? A + i * a_step : A1, a_ok ? 16 : 0);
      cp_async16(as + kWgTile + i * 2048, w_ok ? W + i * w_step : W1, w_ok ? 16 : 0);
    }
  };

  float acc1[32], acc2[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc1[i] = acc2[i] = 0.0f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) load_chunk(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed
    fence_async_smem();
    __syncthreads();  // ... for every thread, and chunk c-1's stage is free
    const int next = c + STAGES - 1;
    if (next < nchunks) load_chunk(next, next % STAGES);
    cp_async_commit();
    const uint32_t a_addr = static_cast<uint32_t>(__cvta_generic_to_shared(ring + (size_t)(c % STAGES) * 2 * kWgTile));
    const uint32_t w_addr = a_addr + kWgTile;
    wg_fence();
    if (c < c1) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) wgmma_64x64(acc1, wg_desc(a_addr + kk * 2), wg_desc(w_addr + kk * 2));
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) wgmma_64x64(acc2, wg_desc(a_addr + kk * 2), wg_desc(w_addr + kk * 2));
    }
    wg_commit();
    wg_wait0();  // the stage is refilled next iteration
  }
  cp_async_wait<0>();

  // every value first (the loads of the rank update and the bias), then the
  // stores, which the compiler may not move loads across. The rank update
  // (K2 == 0 then) is the second half: two rows and 2 NJ columns a thread.
  const bf16* R = static_cast<const bf16*>(t.R);
  const bf16* WR = static_cast<const bf16*>(t.WR);
  const bf16* bias = static_cast<const bf16*>(t.bias);
  const int wm = warp * 16;
  for (int jr = 0; jr < t.KR; ++jr) {
    float rv[2], wv[NJ][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) rv[h] = to_f<bf16>(R[(size_t)min(m0 + wm + (lane >> 2) + h * 8, t.M - 1) * t.ldr + jr]);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wv[j][h] = to_f<bf16>(WR[(size_t)min(n0 + j * 8 + (lane & 3) * 2 + h, t.N - 1) * t.ldwr + jr]);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[4 * j + e] = fmaf(rv[e >> 1], wv[j][e & 1], acc2[4 * j + e]);
  }
  const bool two = t.K2 > 0 || t.KR > 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = min(n0 + j * 8 + (lane & 3) * 2 + (e & 1), t.N - 1);
      acc1[4 * j + e] = epilogue<bf16>(acc1[4 * j + e], acc2[4 * j + e], two, bias, n);
    }
  bf16* C = static_cast<bf16*>(t.C);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int m = m0 + wm + (lane >> 2) + (e >> 1) * 8, n = n0 + j * 8 + (lane & 3) * 2;
      if (m < t.M && n < t.N)
        *reinterpret_cast<__nv_bfloat162*>(C + (size_t)m * t.N + n) =
            __floats2bfloat162_rn(acc1[4 * j + e], acc1[4 * j + e + 1]);
    }
}

// float32 specialisation: the same tile on CUDA cores, FMA with float32
// operands loaded as 16-byte vectors into transposed shared-memory tiles
constexpr int kFmBM = 64, kFmBN = 64, kFmBK = 32, kFmThreads = 256, kFmTM = 4, kFmTN = 4;

__device__ __forceinline__ void fma_accumulate(float (&acc)[kFmTM][kFmTN], float (*As)[kFmBM + 4],
                                               float (*Ws)[kFmBN + 4], const float* __restrict__ A, int lda,
                                               const float* __restrict__ W, int ldw, int K, int M, int N, int m0,
                                               int n0) {
  constexpr int NTX = kFmBN / kFmTN, NTY = kFmBM / kFmTM;
  const int tid = threadIdx.x, tx = tid % NTX, ty = tid / NTX;
  for (int k0 = 0; k0 < K; k0 += kFmBK) {
    for (int i = tid; i < kFmBM * (kFmBK / 4); i += kFmThreads) {
      const int r = i / (kFmBK / 4), kq = (i % (kFmBK / 4)) * 4, k = k0 + kq;
      const int m = m0 + r, n = n0 + r;
      const float4 a = (m < M && k < K) ? *reinterpret_cast<const float4*>(A + (size_t)m * lda + k)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 w = (n < N && k < K) ? __ldg(reinterpret_cast<const float4*>(W + (size_t)n * ldw + k))
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
      As[kq][r] = a.x, As[kq + 1][r] = a.y, As[kq + 2][r] = a.z, As[kq + 3][r] = a.w;
      Ws[kq][r] = w.x, Ws[kq + 1][r] = w.y, Ws[kq + 2][r] = w.z, Ws[kq + 3][r] = w.w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kFmBK; ++kk) {
      float a[kFmTM], w[kFmTN];
#pragma unroll
      for (int i = 0; i < kFmTM; ++i) a[i] = As[kk][ty + i * NTY];
#pragma unroll
      for (int j = 0; j < kFmTN; ++j) w[j] = Ws[kk][tx + j * NTX];
#pragma unroll
      for (int i = 0; i < kFmTM; ++i)
#pragma unroll
        for (int j = 0; j < kFmTN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kFmThreads) gemm_f32_fma(const TileArgs t) {
  constexpr int NTX = kFmBN / kFmTN, NTY = kFmBM / kFmTM;
  static_assert(NTX * NTY == kFmThreads, "tile shape must use every thread");
  __shared__ __align__(16) float As[kFmBK][kFmBM + 4];
  __shared__ __align__(16) float Ws[kFmBK][kFmBN + 4];
  const int m0 = blockIdx.y * kFmBM, n0 = blockIdx.x * kFmBN;
  float acc1[kFmTM][kFmTN], acc2[kFmTM][kFmTN];
#pragma unroll
  for (int i = 0; i < kFmTM; ++i)
#pragma unroll
    for (int j = 0; j < kFmTN; ++j) acc1[i][j] = acc2[i][j] = 0.0f;
  fma_accumulate(acc1, As, Ws, static_cast<const float*>(t.A1), t.lda1, static_cast<const float*>(t.W1), t.ldw1,
                 t.K1, t.M, t.N, m0, n0);
  if (t.K2 > 0)
    fma_accumulate(acc2, As, Ws, static_cast<const float*>(t.A2), t.lda2, static_cast<const float*>(t.W2), t.ldw2,
                   t.K2, t.M, t.N, m0, n0);
  const float* R = static_cast<const float*>(t.R);
  const float* WR = static_cast<const float*>(t.WR);
  const float* bias = static_cast<const float*>(t.bias);
  const int tx = threadIdx.x % NTX, ty = threadIdx.x / NTX;
#pragma unroll
  for (int i = 0; i < kFmTM; ++i)
#pragma unroll
    for (int j = 0; j < kFmTN; ++j) {
      const int m = min(m0 + ty + i * NTY, t.M - 1), n = min(n0 + tx + j * NTX, t.N - 1);
      if (t.KR > 0) acc2[i][j] = rank_dot<float>(R + (size_t)m * t.ldr, WR + (size_t)n * t.ldwr, t.KR);
      acc1[i][j] = epilogue<float>(acc1[i][j], acc2[i][j], t.K2 > 0 || t.KR > 0, bias, n);
    }
  float* C = static_cast<float*>(t.C);
#pragma unroll
  for (int i = 0; i < kFmTM; ++i)
#pragma unroll
    for (int j = 0; j < kFmTN; ++j) {
      const int m = m0 + ty + i * NTY, n = n0 + tx + j * NTX;
      if (m < t.M && n < t.N) C[(size_t)m * t.N + n] = acc1[i][j];
    }
}

// threads of a row pass: the GRU row (3 R wide, its gate algebra on R) takes twice the plain row's
template <int MODE>
struct RowThreads {
  static constexpr int value = MODE == kLnGru ? 256 : 128;
};

// One block per row of X [M, N] (N a multiple of 8): the row pass of
// ln_finish, the row (and the row of H0) read as 16-byte vectors into shared
// memory before any store.
template <typename T, int MODE>
__global__ void __launch_bounds__(RowThreads<MODE>::value)
    ln_rows(int N, const T* __restrict__ X, const float* __restrict__ scale, const float* __restrict__ bias, float eps,
            T* __restrict__ Y, const T* __restrict__ H0) {
  extern __shared__ float row[];
  __shared__ float red[32];
  constexpr int V = 16 / sizeof(T);
  const int m = blockIdx.x;
  const int ny = MODE == kLnGru ? N / 3 : N, width = MODE == kLnGru ? N + ny : N;
  for (int i = threadIdx.x * V; i < width; i += RowThreads<MODE>::value * V) {
    const uint4 v = i < N ? *reinterpret_cast<const uint4*>(X + (size_t)m * N + i)
                          : *reinterpret_cast<const uint4*>(H0 + (size_t)m * ny + (i - N));
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int j = 0; j < V; ++j) row[i + j] = to_f<T>(e[j]);
  }
  __syncthreads();  // the vector layout differs from ln_finish's element layout
  ln_finish<T, MODE>(row, N, scale, bias, eps, Y + (size_t)m * ny, red);
}

// One block per row of raw [M, S*D]; one group of kCatLanes lanes per categorical.
template <typename T>
__global__ void __launch_bounds__(256) unimix_rows(int S, int D, float mix_keep, float mix_uniform, int mix,
                                                   const T* __restrict__ raw, float* __restrict__ logits,
                                                   const float* __restrict__ gumbel, T* __restrict__ Z) {
  extern __shared__ float xs[];
  constexpr int kGroups = 256 / kCatLanes;
  const int m = blockIdx.x, group = threadIdx.x / kCatLanes, sub = threadIdx.x % kCatLanes;
  float* x = xs + group * D;
  for (int s0 = 0; s0 < S; s0 += kGroups) {
    const int s = s0 + group;
    const bool active = s < S;
    const size_t base = ((size_t)m * S + (active ? s : 0)) * D;
    __syncwarp();
    if (active)
      for (int d = sub; d < D; d += kCatLanes) x[d] = to_f<T>(raw[base + d]);
    __syncwarp();
    unimix_cat<T>(active, x, D, mix_keep, mix_uniform, mix, logits == nullptr ? nullptr : logits + base,
                  gumbel == nullptr ? nullptr : gumbel + base, Z == nullptr ? nullptr : Z + base);
  }
}

// ---------------------------------------------------------------------------
// rssm_dyn_step: one persistent cooperative launch for a small batch
// ---------------------------------------------------------------------------

struct Dims {
  int B, A, E, DU, R, HT, HR, S, D;
  int ld_wi_z, ld_wi_a, ld_wg_h, ld_wg_f, ld_wt, ld_wt_head, ld_wr_h, ld_wr_e, ld_wr_head;
  // rssm_dyn_step's split-K plan (rssm_step.dyn_plan, its one source), per product half:
  int grid;         // blocks of the cooperative launch (one per SM)
  int kc[8];        // K chunk of one warp unit
  int splits[8];    // K chunks of a row
  int part_off[8];  // offset of the half's [splits, B, N] partial sums in the workspace, in floats
  int smem;         // bytes of dynamic shared memory of one block (rssm_step.dyn_smem_bytes, its one source)
};

struct Scalars {
  float eps_in, eps_gru, eps_trans, eps_repr, mix_keep, mix_uniform, unimix;
};

// parameter pointer slots, in PARAM_KEYS order
enum {
  P_WI_Z, P_WI_A, P_LN_I_S, P_LN_I_B, P_WG_H, P_WG_F, P_LN_G_S, P_LN_G_B, P_WT, P_LN_T_S, P_LN_T_B, P_WT_HEAD,
  P_BT_HEAD, P_WR_H, P_WR_E, P_LN_R_S, P_LN_R_B, P_WR_HEAD, P_BR_HEAD, N_PARAMS
};

// the tensor-core product halves of a dynamic step, in rssm_step.DYN_HALVES order
enum { H_WI_Z, H_WG_H, H_WG_F, H_WT, H_WT_HEAD, H_WR_H, H_WR_E, H_WR_HEAD };

constexpr int kDynThreads = 512, kDynWarps = kDynThreads / 32, kDynUnroll = 4;

struct DynArgs {
  const void* p[N_PARAMS];
  const void* in[8];  // init_h init_z h z a e f g
  void* out[4];       // h_new z_new post_logits prior_logits
  void* scr[6];       // h0 z0 am feat pact qact
  float* part;        // split-K partial sums of every half
  Dims d;
  Scalars s;
};

template <typename T>
struct Half {
  const T* a;  // [M, K] activations, contiguous
  const T* w;  // [N, K] weights, row stride ldw
  int ldw, K, N, kc, splits;
  float* part;  // [splits, M, N]
};

template <typename T>
__device__ Half<T> half_of(const DynArgs& g, int h) {
  const Dims& d = g.d;
  const int SD = d.S * d.D;
  const void* a = nullptr;
  int w = 0, ldw = 0, K = 0, N = 0;
  switch (h) {
    case H_WI_Z: a = g.scr[1], w = P_WI_Z, ldw = d.ld_wi_z, K = SD, N = d.DU; break;
    case H_WG_H: a = g.scr[0], w = P_WG_H, ldw = d.ld_wg_h, K = d.R, N = 3 * d.R; break;
    case H_WG_F: a = g.scr[3], w = P_WG_F, ldw = d.ld_wg_f, K = d.DU, N = 3 * d.R; break;
    case H_WT: a = g.out[0], w = P_WT, ldw = d.ld_wt, K = d.R, N = d.HT; break;
    case H_WT_HEAD: a = g.scr[4], w = P_WT_HEAD, ldw = d.ld_wt_head, K = d.HT, N = SD; break;
    case H_WR_H: a = g.out[0], w = P_WR_H, ldw = d.ld_wr_h, K = d.R, N = d.HR; break;
    case H_WR_E: a = g.in[5], w = P_WR_E, ldw = d.ld_wr_e, K = d.E, N = d.HR; break;
    default: a = g.scr[5], w = P_WR_HEAD, ldw = d.ld_wr_head, K = d.HR, N = SD; break;
  }
  Half<T> r;
  r.a = static_cast<const T*>(a);
  r.w = static_cast<const T*>(g.p[w]);
  r.ldw = ldw, r.K = K, r.N = N, r.kc = d.kc[h], r.splits = d.splits[h];
  r.part = g.part + d.part_off[h];
  return r;
}

template <typename T>
__device__ __forceinline__ int units_of(const Half<T>& h, int M) {
  return ((M + 15) / 16) * ((h.N + 7) / 8) * h.splits;
}

// One warp: part[s, m0:m0+16, n0:n0+8] = A[m0:m0+16, kb:ke] @ W[n0:n0+8, kb:ke]^T.
// bf16 on tensor cores. Lane (g, q) = (lane / 4, lane % 4) loads 8 consecutive
// k of weight row n0+g and of activation rows m0+g and m0+g+8 as 16-byte
// vectors; two mma.sync.m16n8k16 take them as fragments of a K order permuted
// the same way for both operands (mma k 2q,2q+1 | 2q+8,2q+9 <- k 8q..8q+3, then
// 8q+4..8q+7), so the sum over the chunk is unchanged.
__device__ __forceinline__ void warp_unit(const Half<bf16>& h, int M, int m0, int n0, int s) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int kb = s * h.kc, ke = min(h.K, kb + h.kc);
  const int n = n0 + g, ma = m0 + g, mb = ma + 8;
  const bool w_ok = n < h.N, a_ok = ma < M, b_ok = mb < M;
  const bf16* wrow = h.w + (size_t)(w_ok ? n : 0) * h.ldw;
  const bf16* arow = h.a + (size_t)(a_ok ? ma : 0) * h.K;
  const bf16* brow = h.a + (size_t)(b_ok ? mb : 0) * h.K;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = kb; k0 < ke; k0 += 32 * kDynUnroll) {
    uint4 w[kDynUnroll], xa[kDynUnroll], xb[kDynUnroll];
#pragma unroll
    for (int u = 0; u < kDynUnroll; ++u) {
      const int k = k0 + u * 32 + q * 8;
      const bool kin = k < ke;
      w[u] = (w_ok && kin) ? __ldg(reinterpret_cast<const uint4*>(wrow + k)) : zero;
      xa[u] = (a_ok && kin) ? __ldcg(reinterpret_cast<const uint4*>(arow + k)) : zero;
      xb[u] = (b_ok && kin) ? __ldcg(reinterpret_cast<const uint4*>(brow + k)) : zero;
    }
#pragma unroll
    for (int u = 0; u < kDynUnroll; ++u) {
      mma_16816(acc, xa[u].x, xb[u].x, xa[u].y, xb[u].y, w[u].x, w[u].y);
      mma_16816(acc, xa[u].z, xb[u].z, xa[u].w, xb[u].w, w[u].z, w[u].w);
    }
  }
  float* out = h.part + (size_t)s * M * h.N;
  const int col = n0 + 2 * q;
  if (a_ok) {
    if (col < h.N) out[(size_t)ma * h.N + col] = acc[0];
    if (col + 1 < h.N) out[(size_t)ma * h.N + col + 1] = acc[1];
  }
  if (b_ok) {
    if (col < h.N) out[(size_t)mb * h.N + col] = acc[2];
    if (col + 1 < h.N) out[(size_t)mb * h.N + col + 1] = acc[3];
  }
}

// float32 on CUDA cores: lane (g, q) takes weight row n0+g at k 8q..8q+7 of
// every 32-wide step against all 16 activation rows, 16-byte loads; the four q
// lanes of a column are summed by shuffles at the end.
__device__ __forceinline__ void warp_unit(const Half<float>& h, int M, int m0, int n0, int s) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int kb = s * h.kc, ke = min(h.K, kb + h.kc);
  const int n = n0 + g;
  const bool w_ok = n < h.N;
  const float* wrow = h.w + (size_t)(w_ok ? n : 0) * h.ldw;
  float acc[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r] = 0.0f;
  for (int k0 = kb; k0 < ke; k0 += 32) {
    const int k = k0 + q * 8;
    if (w_ok && k < ke) {
      const float4 w0 = __ldg(reinterpret_cast<const float4*>(wrow + k));
      const float4 w1 = __ldg(reinterpret_cast<const float4*>(wrow + k + 4));
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        if (m0 + r < M) {
          const float* arow = h.a + (size_t)(m0 + r) * h.K + k;
          const float4 x0 = __ldcg(reinterpret_cast<const float4*>(arow));
          const float4 x1 = __ldcg(reinterpret_cast<const float4*>(arow + 4));
          float v = acc[r];
          v = fmaf(x0.x, w0.x, v), v = fmaf(x0.y, w0.y, v), v = fmaf(x0.z, w0.z, v), v = fmaf(x0.w, w0.w, v);
          v = fmaf(x1.x, w1.x, v), v = fmaf(x1.y, w1.y, v), v = fmaf(x1.z, w1.z, v), v = fmaf(x1.w, w1.w, v);
          acc[r] = v;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
    acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 2);
  }
  float* out = h.part + (size_t)s * M * h.N;
#pragma unroll
  for (int r = 0; r < 16; ++r)
    if ((r >> 2) == q && w_ok && m0 + r < M) out[(size_t)(m0 + r) * h.N + n] = acc[r];
}

template <typename T>
__device__ __forceinline__ void run_unit(const Half<T>& h, int M, int v) {
  const int mt = (M + 15) / 16, nt = (h.N + 7) / 8;
  warp_unit(h, M, (v % mt) * 16, ((v / mt) % nt) * 8, v / (mt * nt));
}

// every warp of the grid takes units of the given halves in turn; consecutive
// units go to warps of different blocks, so each half spreads over every SM
template <typename T>
__device__ void product_phase(const DynArgs& g, int h1, int h2) {
  const int M = g.d.B;
  const Half<T> a = half_of<T>(g, h1);
  const Half<T> b = half_of<T>(g, h2 >= 0 ? h2 : h1);
  const int ua = units_of(a, M), total = ua + (h2 >= 0 ? units_of(b, M) : 0);
  for (int u = (threadIdx.x >> 5) * gridDim.x + blockIdx.x; u < total; u += gridDim.x * kDynWarps) {
    if (u < ua)
      run_unit(a, M, u);
    else
      run_unit(b, M, u - ua);
  }
}

// The block: dst[n] = the sum over splits, in split order, of half h's
// partials of row m, every n < h.N. Each thread keeps C columns x U splits of
// loads in flight, so a row costs a few L2 round trips, not one per split.
template <typename T, int C, int U>
__device__ void row_partials_cu(const Half<T>& h, int M, int m, float* dst) {
  const float* p = h.part + (size_t)m * h.N;
  const size_t stride = (size_t)M * h.N;
  const int nt = blockDim.x;
  for (int n0 = threadIdx.x; n0 < h.N; n0 += C * nt) {
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    for (int i0 = 0; i0 < h.splits; i0 += U) {
      float v[U][C];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int n = n0 + c * nt;
          v[u][c] = (i0 + u < h.splits && n < h.N) ? __ldcg(p + (i0 + u) * stride + n) : 0.0f;
        }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += v[u][c];
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (n0 + c * nt < h.N) dst[n0 + c * nt] = acc[c];
  }
}

// one column a thread: sixteen splits in flight; wider rows: 4 columns x 4 splits
template <typename T>
__device__ void row_partials(const Half<T>& h, int M, int m, float* dst) {
  if (h.N <= (int)blockDim.x)
    row_partials_cu<T, 1, 16>(h, M, m, dst);
  else
    row_partials_cu<T, 4, 4>(h, M, m, dst);
}

// sum of the split partials of half h at (m, n), in split order
template <typename T>
__device__ __forceinline__ float part_sum(const Half<T>& h, int M, int m, int n) {
  const float* p = h.part + (size_t)m * h.N + n;
  const size_t stride = (size_t)M * h.N;
  float s = 0.0f;
#pragma unroll 8
  for (int i = 0; i < h.splits; ++i) s += __ldcg(p + i * stride);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kDynThreads, 1) dyn_step_coop(const DynArgs g) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  cg::grid_group grid = cg::this_grid();
  const Dims& d = g.d;
  const Scalars& sc = g.s;
  const int M = d.B, SD = d.S * d.D;
  const T* const* P = reinterpret_cast<const T* const*>(g.p);
  const float* const* PF = reinterpret_cast<const float* const*>(g.p);
  T* h0 = static_cast<T*>(g.scr[0]);
  T* z0 = static_cast<T*>(g.scr[1]);
  T* am = static_cast<T*>(g.scr[2]);
  T* feat = static_cast<T*>(g.scr[3]);
  T* pact = static_cast<T*>(g.scr[4]);
  T* qact = static_cast<T*>(g.scr[5]);
  T* h_new = static_cast<T*>(g.out[0]);

  // 1. is_first blend (h0 = (1-f) h + f init_h, z0 likewise, am = (1-f) a) and
  //    e @ wr_e, which reads only the step's input
  {
    const T* init_h = static_cast<const T*>(g.in[0]);
    const T* init_z = static_cast<const T*>(g.in[1]);
    const T* h = static_cast<const T*>(g.in[2]);
    const T* z = static_cast<const T*>(g.in[3]);
    const T* a = static_cast<const T*>(g.in[4]);
    const float* f = static_cast<const float*>(g.in[6]);
    const int W = d.R + SD + d.A;
    for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < M * W; idx += gridDim.x * blockDim.x) {
      const int b = idx / W, c = idx % W;
      const float fb = rt<T>(f[b]), keep = rt<T>(1.0f - fb);
      if (c < d.R) {
        const size_t i = (size_t)b * d.R + c;
        h0[i] = from_f<T>(rt<T>(keep * to_f<T>(h[i])) + rt<T>(fb * to_f<T>(init_h[i])));
      } else if (c < d.R + SD) {
        const size_t i = (size_t)b * SD + (c - d.R);
        z0[i] = from_f<T>(rt<T>(keep * to_f<T>(z[i])) + rt<T>(fb * to_f<T>(init_z[i])));
      } else {
        const size_t i = (size_t)b * d.A + (c - d.R - SD);
        am[i] = from_f<T>(keep * to_f<T>(a[i]));
      }
    }
    product_phase<T>(g, H_WR_E, -1);
  }
  grid.sync();
  // 2. z0 @ wi_z and h0 @ wg_h
  product_phase<T>(g, H_WI_Z, H_WG_H);
  grid.sync();
  // 3. input projection: + am @ wi_a (rank A), LayerNorm -> feat
  {
    const Half<T> hz = half_of<T>(g, H_WI_Z);
    for (int m = blockIdx.x; m < M; m += gridDim.x) {
      __syncthreads();  // smem may still be read from the previous row
      row_partials(hz, M, m, smem + d.DU);
      for (int n = threadIdx.x; n < d.DU; n += blockDim.x) {  // each thread reads back its own columns
        const float rank = rank_dot<T>(am + (size_t)m * d.A, P[P_WI_A] + (size_t)n * d.ld_wi_a, d.A);
        smem[n] = epilogue<T>(smem[d.DU + n], rank, d.A > 0, (const T*)nullptr, n);
      }
      ln_finish<T, kLnPlain>(smem, d.DU, PF[P_LN_I_S], PF[P_LN_I_B], sc.eps_in, feat + (size_t)m * d.DU, red);
    }
  }
  grid.sync();
  // 4. feat @ wg_f
  product_phase<T>(g, H_WG_F, -1);
  grid.sync();
  // 5. GRU: LayerNorm of [h0, feat] @ [wg_h; wg_f], gate algebra -> h_new
  {
    const Half<T> hh = half_of<T>(g, H_WG_H), hf = half_of<T>(g, H_WG_F);
    const int N = 3 * d.R;
    for (int m = blockIdx.x; m < M; m += gridDim.x) {
      __syncthreads();
      float* sh = smem + N + d.R;  // [row | h0 | sum of wg_h | sum of wg_f]
      float* sf = sh + N;
      row_partials(hh, M, m, sh);
      row_partials(hf, M, m, sf);
      for (int n = threadIdx.x; n < N; n += blockDim.x) smem[n] = epilogue<T>(sh[n], sf[n], true, (const T*)nullptr, n);
      for (int j = threadIdx.x; j < d.R; j += blockDim.x) smem[N + j] = ldcg_f<T>(h0 + (size_t)m * d.R + j);
      ln_finish<T, kLnGru>(smem, N, PF[P_LN_G_S], PF[P_LN_G_B], sc.eps_gru, h_new + (size_t)m * d.R, red);
    }
  }
  grid.sync();
  // 6. h_new @ wt and h_new @ wr_h
  product_phase<T>(g, H_WT, H_WR_H);
  grid.sync();
  // 7. prior and posterior trunks: LayerNorm + SiLU -> pact, qact
  {
    const Half<T> ht = half_of<T>(g, H_WT), hrh = half_of<T>(g, H_WR_H), hre = half_of<T>(g, H_WR_E);
    for (int u = blockIdx.x; u < 2 * M; u += gridDim.x) {
      const int m = u % M;
      __syncthreads();
      if (u < M) {
        row_partials(ht, M, m, smem + d.HT);
        for (int n = threadIdx.x; n < d.HT; n += blockDim.x)
          smem[n] = epilogue<T>(smem[d.HT + n], 0.0f, false, (const T*)nullptr, n);
        ln_finish<T, kLnSilu>(smem, d.HT, PF[P_LN_T_S], PF[P_LN_T_B], sc.eps_trans, pact + (size_t)m * d.HT, red);
      } else {
        row_partials(hrh, M, m, smem + d.HR);
        row_partials(hre, M, m, smem + 2 * d.HR);
        for (int n = threadIdx.x; n < d.HR; n += blockDim.x)
          smem[n] = epilogue<T>(smem[d.HR + n], smem[2 * d.HR + n], true, (const T*)nullptr, n);
        ln_finish<T, kLnSilu>(smem, d.HR, PF[P_LN_R_S], PF[P_LN_R_B], sc.eps_repr, qact + (size_t)m * d.HR, red);
      }
    }
  }
  grid.sync();
  // 8. pact @ wt_head and qact @ wr_head
  product_phase<T>(g, H_WT_HEAD, H_WR_HEAD);
  grid.sync();
  // 9. heads + bias, unimix -> prior logits; posterior logits and the sample,
  //    one lane group per (branch, row, categorical)
  {
    const Half<T> hp = half_of<T>(g, H_WT_HEAD), hq = half_of<T>(g, H_WR_HEAD);
    const int group = threadIdx.x / kCatLanes, sub = threadIdx.x % kCatLanes;
    const int groups = gridDim.x * (kDynThreads / kCatLanes), total = 2 * M * d.S;
    float* x = smem + group * d.D;
    const int mix = sc.unimix > 0.0f ? 1 : 0;
    for (int u0 = 0; u0 < total; u0 += groups) {
      const int u = u0 + group * gridDim.x + blockIdx.x;
      const bool active = u < total, post = u >= M * d.S;
      const int v = active ? (post ? u - M * d.S : u) : 0, m = v / d.S, s = v % d.S;
      const T* bias = P[post ? P_BR_HEAD : P_BT_HEAD];
      __syncwarp();
      if (active)
        for (int c = sub; c < d.D; c += kCatLanes) {
          const int n = s * d.D + c;
          x[c] = epilogue<T>(post ? part_sum(hq, M, m, n) : part_sum(hp, M, m, n), 0.0f, false, bias, n);
        }
      __syncwarp();
      const size_t base = ((size_t)m * d.S + s) * d.D;
      float* logits = static_cast<float*>(g.out[post ? 2 : 3]) + base;
      const float* gumbel = post ? static_cast<const float*>(g.in[7]) + base : nullptr;
      T* z = post ? static_cast<T*>(g.out[1]) + base : nullptr;
      unimix_cat<T>(active, x, d.D, sc.mix_keep, sc.mix_uniform, mix, logits, gumbel, z);
    }
  }
}

#define RETURN_ON_ERROR(call)            \
  do {                                   \
    cudaError_t err_ = (call);           \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

// returned instead of a cudaError_t when the occupancy calculator finds that
// the cooperative launch cannot hold one block on each of its SMs
constexpr int kErrCoopOccupancy = 100001;

// blocks of dyn_step_coop<T> that the current device holds at once with
// `smem` bytes of dynamic shared memory. Found once per (device, size):
// nothing else moves it. The kernel's shared-memory limit only ever rises, to
// the widest size seen on the device, so every cached size stays launchable.
template <typename T>
cudaError_t coop_capacity(size_t smem, long long* blocks) {
  struct Seen {
    int dev;
    size_t smem;
    long long blocks;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  int dev = 0;
  RETURN_ON_ERROR(cudaGetDevice(&dev));
  std::lock_guard<std::mutex> lock(mu);
  for (const Seen& c : seen)
    if (c.dev == dev && c.smem == smem) {
      *blocks = c.blocks;
      return cudaSuccess;
    }
  size_t widest = smem;
  for (const Seen& c : seen)
    if (c.dev == dev && c.smem > widest) widest = c.smem;
  if (widest > 48 * 1024)
    RETURN_ON_ERROR(cudaFuncSetAttribute(dyn_step_coop<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)widest));
  int sms = 0, per_sm = 0;
  RETURN_ON_ERROR(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  RETURN_ON_ERROR(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dyn_step_coop<T>, kDynThreads, smem));
  *blocks = (long long)per_sm * sms;
  seen.push_back({dev, smem, *blocks});
  return cudaSuccess;
}

template <typename T>
cudaError_t dyn_step(cudaStream_t st, const void* const* p, const Dims& d, const Scalars& s) {
  DynArgs a;
  for (int i = 0; i < N_PARAMS; ++i) a.p[i] = p[i];
  for (int i = 0; i < 8; ++i) a.in[i] = p[N_PARAMS + i];
  for (int i = 0; i < 4; ++i) a.out[i] = const_cast<void*>(p[N_PARAMS + 8 + i]);
  for (int i = 0; i < 6; ++i) a.scr[i] = const_cast<void*>(p[N_PARAMS + 12 + i]);
  a.part = static_cast<float*>(const_cast<void*>(p[N_PARAMS + 18]));
  a.d = d;
  a.s = s;
  // the widest row pass ([row | sums] x2 plain, x3 posterior; [row | h0 | two
  // sums] of the GRU; 64 categoricals), sized by rssm_step.smem_floats
  const size_t smem = (size_t)d.smem;
  // every block must be resident at once: check before the launch, so that a
  // width the SMs cannot hold is named, not a bare launch error
  long long capacity = 0;
  RETURN_ON_ERROR(coop_capacity<T>(smem, &capacity));
  if (capacity < d.grid) return (cudaError_t)kErrCoopOccupancy;
  void* args[] = {&a};
  RETURN_ON_ERROR(
      cudaLaunchCooperativeKernel((const void*)dyn_step_coop<T>, dim3(d.grid), dim3(kDynThreads), args, smem, st));
  return cudaGetLastError();
}

template <typename T>
cudaError_t tile_product(cudaStream_t st, int M, int N, const void* A1, const void* W1, int ldw1, int K1,
                         const void* A2, const void* W2, int ldw2, int K2, const void* R, const void* WR, int ldwr,
                         int KR, const void* bias, void* C) {
  const TileArgs t{M, N, A1, W1, K1, ldw1, K1, A2, W2, K2, ldw2, K2, R, WR, KR, ldwr, KR, bias, C};
  if (sizeof(T) == 2) {
    RETURN_ON_ERROR(cudaFuncSetAttribute(gemm_bf16_wgmma_64x64, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem));
    gemm_bf16_wgmma_64x64<<<dim3((N + 63) / 64, (M + 63) / 64), 128, kWgSmem, st>>>(t);
    return cudaGetLastError();
  }
  gemm_f32_fma<<<dim3((N + kFmBN - 1) / kFmBN, (M + kFmBM - 1) / kFmBM), kFmThreads, 0, st>>>(t);
  return cudaGetLastError();
}

// the row of X (and of H0 after it for the GRU): rssm_step.smem_floats("imag")
// states these sizes for the wrapper's shared-memory check; keep both in step
template <typename T, int MODE>
cudaError_t layer_norm(cudaStream_t st, int M, int N, const void* X, const void* scale, const void* bias, float eps,
                       void* Y, const void* H0) {
  const size_t smem = (size_t)(MODE == kLnGru ? N + N / 3 : N) * sizeof(float);
  if (smem > 48 * 1024)
    RETURN_ON_ERROR(cudaFuncSetAttribute(ln_rows<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  ln_rows<T, MODE><<<M, RowThreads<MODE>::value, smem, st>>>(
      N, static_cast<const T*>(X), static_cast<const float*>(scale), static_cast<const float*>(bias), eps,
      static_cast<T*>(Y), static_cast<const T*>(H0));
  return cudaGetLastError();
}

template <typename T>
cudaError_t imag_step(cudaStream_t st, const void* const* p, const Dims& d, const Scalars& s) {
  const void* const* in = p + N_PARAMS;  // h z a g
  void* const* out = const_cast<void* const*>(p + N_PARAMS + 4);  // h_new z_new
  void* const* scr = out + 2;  // t0 feat u0 pt0 pact prior_raw
  const int B = d.B, SD = d.S * d.D;
  RETURN_ON_ERROR(tile_product<T>(st, B, d.DU, in[1], p[P_WI_Z], d.ld_wi_z, SD, nullptr, nullptr, 0, 0, in[2],
                                  p[P_WI_A], d.ld_wi_a, d.A, nullptr, scr[0]));
  RETURN_ON_ERROR((layer_norm<T, kLnPlain>(st, B, d.DU, scr[0], p[P_LN_I_S], p[P_LN_I_B], s.eps_in, scr[1], nullptr)));
  RETURN_ON_ERROR(tile_product<T>(st, B, 3 * d.R, in[0], p[P_WG_H], d.ld_wg_h, d.R, scr[1], p[P_WG_F], d.ld_wg_f,
                                  d.DU, nullptr, nullptr, 0, 0, nullptr, scr[2]));
  RETURN_ON_ERROR((layer_norm<T, kLnGru>(st, B, 3 * d.R, scr[2], p[P_LN_G_S], p[P_LN_G_B], s.eps_gru, out[0], in[0])));
  RETURN_ON_ERROR(tile_product<T>(st, B, d.HT, out[0], p[P_WT], d.ld_wt, d.R, nullptr, nullptr, 0, 0, nullptr,
                                  nullptr, 0, 0, nullptr, scr[3]));
  RETURN_ON_ERROR(
      (layer_norm<T, kLnSilu>(st, B, d.HT, scr[3], p[P_LN_T_S], p[P_LN_T_B], s.eps_trans, scr[4], nullptr)));
  RETURN_ON_ERROR(tile_product<T>(st, B, SD, scr[4], p[P_WT_HEAD], d.ld_wt_head, d.HT, nullptr, nullptr, 0, 0,
                                  nullptr, nullptr, 0, 0, p[P_BT_HEAD], scr[5]));
  // 32 categoricals a block (rssm_step.smem_floats("imag")["discrete"])
  const size_t smem = (size_t)(256 / kCatLanes) * d.D * sizeof(float);
  if (smem > 48 * 1024)
    RETURN_ON_ERROR(cudaFuncSetAttribute(unimix_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  unimix_rows<T><<<B, 256, smem, st>>>(d.S, d.D, s.mix_keep, s.mix_uniform, s.unimix > 0.0f ? 1 : 0,
                                       static_cast<const T*>(scr[5]), nullptr, static_cast<const float*>(in[3]),
                                       static_cast<T*>(out[1]));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. ptrs: the 19 parameters in PARAM_KEYS order,
// then init_h init_z h z a e f g, then h_new z_new post_logits prior_logits,
// then the scratch buffers h0 z0 am feat pact qact and the float32 split-K
// workspace. One cooperative launch. Returns the CUDA error of the launch, or 0.
int rssm_dyn_step(int dtype, const void* const* ptrs, const int* dims, const float* scalars, void* stream) {
  const Dims& d = *reinterpret_cast<const Dims*>(dims);
  const Scalars& s = *reinterpret_cast<const Scalars*>(scalars);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? dyn_step<float>(st, ptrs, d, s) : dyn_step<bf16>(st, ptrs, d, s));
}

// ptrs: the 19 parameters, then h z a g, then h_new z_new, then 6 scratch
// buffers. Eight launches. Returns the first CUDA error of the launches, or 0.
int rssm_imag_step(int dtype, const void* const* ptrs, const int* dims, const float* scalars, void* stream) {
  const Dims& d = *reinterpret_cast<const Dims*>(dims);
  const Scalars& s = *reinterpret_cast<const Scalars*>(scalars);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? imag_step<float>(st, ptrs, d, s) : imag_step<bf16>(st, ptrs, d, s));
}

const char* rssm_error_string(int err) {
  if (err == kErrCoopOccupancy)
    return "rssm_dyn_step: the cooperative launch needs one resident block on each SM of its grid, and the "
           "occupancy calculator allows fewer at this shared memory size";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// *bytes = the device's opt-in shared memory per block. Returns the CUDA error, or 0.
int rssm_smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

}  // extern "C"
