// W8A8 prefill projections: the fused QKV and the fused SwiGLU MLP.
//
// Replaces the TPU kernels neutts_tpu/ops/mlp.py `_qkv_kernel` / `fused_qkv`
// and `_mlp_kernel` / `fused_mlp`, with the semantics of `fused_mlp_xla`
// (exact division in the sigmoid, one ff scale per token over all of F).
//
//   fused_qkv: h = rms_norm(x) * w_norm; per-token int8 quant (amax/127);
//              acc = hq @ Wqkv (int8 x int8 -> int32);
//              out = cast(acc * xs * ws) + cast(bias)      (cast = model dtype)
//   fused_mlp: h, hq as above; g = (hq @ Wg) * xs * sg, u = (hq @ Wu) * xs * su;
//              ff = silu(g) * u (f32) and its row amax; ff quant (amax/127);
//              out = x + cast((ffq @ Wd) * ffs * sd)
//
// What bounds it on the H100: operations for the MLP — at M = 4096 tokens it
// does 2*M*D*F*3 ~ 107 G int8 ops on ~13 MB of weights; the QKV projection
// (N = 1152) sits near the ridge, its bound set by its 17 MB of activations
// in and out. Each op runs as launches of its own: a row pass (norm + quant,
// one block per token), then tiled int8 GEMMs whose epilogues apply the
// scales, the SiLU product with the row amax of ff, or the residual add.
//
// The MLP's two GEMMs (imma_gemm_kernel) run on the int8 tensor cores:
// mma.sync m16n8k32 s8 x s8 -> s32, fragments loaded by ldmatrix from
// shared-memory rows padded by 16 bytes (conflict-free), 16-byte cp.async
// tiles double-buffered over 64-byte k steps, 256 threads as 2 x 4 warps.
// Both operands are K-contiguous: the activations by nature, the weights
// because the port stores them K-major ([N, K] storage, backbone.k_major).
// - gate/up: 128 token rows x 64 columns of gate AND of up per block (the
//   two B tiles share the A tile), warp tiles 64 x (16 + 16); the epilogue
//   writes ff = silu(g) * u in f32 and gathers each row's amax |ff| with one
//   atomicMax per row and warp.
// - down: N = D is narrow (896 = 7 x 128 at Air) and K = F long, so 128-row
//   tiles would give only 7 x 32 = 224 blocks at M 4096 (1.7 waves on 132
//   SMs): it takes 64 token rows x 128 columns per block (448 blocks, warp
//   tiles 32 x 32). Its A loader reads the f32 ff tile, multiplies by the
//   row's 1/ffs (ffs = max(amax, 1e-8) / 127 from the gate/up amax) and
//   rounds half to even into int8 in shared memory: the ff quantization has
//   no launch and no int8 copy of ff of its own. The f32 ff still makes one
//   round trip through device memory (keeping it on chip is later work).
// The QKV projection (gemm_s8_kernel) still runs a __dp4a tile on the CUDA
// cores (64 x 64 output tiles, 4 x 4 outputs per thread).
#include "common.cuh"

namespace {

// --- row pass: rms_norm + per-token int8 quantization ----------------------

constexpr int ROW_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS) norm_quant_kernel(
    const T* __restrict__ x, const float* __restrict__ nw, int8_t* __restrict__ xq,
    float* __restrict__ xs, unsigned* __restrict__ amax_zero, int D, float eps) {
  __shared__ float scratch[32];
  const T* xr = x + (size_t)blockIdx.x * D;
  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float v = to_f32(xr[d]);
    ss += v * v;
  }
  ss = block_sum(ss, scratch);
  const float r = 1.0f / sqrtf(ss / (float)D + eps);
  float amax = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    amax = fmaxf(amax, fabsf(to_f32(xr[d]) * r * nw[d]));
  amax = block_max(amax, scratch);
  const float s = fmaxf(amax, 1e-8f) * (1.0f / 127.0f);
  const float inv = 1.0f / s;
  int8_t* qr = xq + (size_t)blockIdx.x * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float h = to_f32(xr[d]) * r * nw[d];
    qr[d] = (int8_t)fminf(fmaxf(rintf(h * inv), -127.f), 127.f);
  }
  if (threadIdx.x == 0) xs[blockIdx.x] = s;
  // the MLP: this row's ff amax starts at 0 for the gate/up epilogue's atomicMax
  if (amax_zero != nullptr && threadIdx.x == 0) amax_zero[blockIdx.x] = 0u;
}

// --- tiled int8 GEMM: C[M, N] = A[M, K] @ B[K, N], both row-major ----------

constexpr int GBM = 64, GBN = 64, GBK = 32;  // tile; GBK in bytes of k
constexpr int KW = GBK / 4;                  // packed 4-byte k words per row
constexpr int KWP = KW + 1;                  // padded: conflict-free reads
constexpr int GTHREADS = 256;                // 16 x 16 threads, 4 x 4 outputs each

// NB = 1 or 2 B matrices sharing the A tile (gate and up share the input).
// Thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j, i, j < 4.
template <int NB, typename Epi>
__global__ void __launch_bounds__(GTHREADS) gemm_s8_kernel(
    const int8_t* __restrict__ A, const int8_t* __restrict__ B0,
    const int8_t* __restrict__ B1, int M, int N, int K, Epi epi) {
  __shared__ int As[GBM][KWP];
  __shared__ int Bs[NB][GBN][KWP];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int kw_total = K / 4;  // K % 4 == 0 (checked by the wrapper)
  int acc[NB][4][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nb][i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += GBK) {
    for (int idx = threadIdx.x; idx < GBM * KW; idx += GTHREADS) {
      const int r = idx / KW, w = idx - r * KW;
      const int m = m0 + r, kw = k0 / 4 + w;
      As[r][w] = (m < M && kw < kw_total)
                     ? *reinterpret_cast<const int*>(A + (size_t)m * K + (size_t)kw * 4)
                     : 0;
    }
    for (int idx = threadIdx.x; idx < KW * GBN; idx += GTHREADS) {
      const int w = idx / GBN, c = idx - w * GBN;
      const int n = n0 + c, kk = k0 + 4 * w;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int8_t* Bp = nb == 0 ? B0 : B1;
        int packed = 0;
        if (n < N) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kk + e < K)
              packed |= (int)(uint8_t)Bp[(size_t)(kk + e) * N + n] << (8 * e);
        }
        Bs[nb][c][w] = packed;
      }
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      int a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][w];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int bv = Bs[nb][tx + 16 * j][w];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nb][i][j] = __dp4a(a[i], bv, acc[nb][i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    float row_max = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N)
        row_max = fmaxf(row_max, epi.store(m, n, acc[0][i][j], acc[NB - 1][i][j]));
    }
    if (Epi::kRowMax) {
      // the 16 threads of a half-warp share row m: reduce, then one atomic
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, o));
      if (tx == 0 && m < M) epi.row_max(m, row_max);
    }
  }
}

template <typename T>
struct EpiQKV {
  static constexpr bool kRowMax = false;
  const float* xs;
  const float* ws;
  const float* bias;
  T* out;
  int N;
  __device__ float store(int m, int n, int a, int) const {
    // dequant -> model dtype, then the bias added in that dtype
    const float d = round_to<T>((float)a * xs[m] * ws[n]);
    out[(size_t)m * N + n] = from_f32<T>(d + round_to<T>(bias[n]));
    return 0.f;
  }
  __device__ void row_max(int, float) const {}
};

dim3 gemm_grid(int M, int N) { return dim3((N + GBN - 1) / GBN, (M + GBM - 1) / GBM); }

// --- int8 tensor-core GEMM (the MLP): C[M, N] = A[M, K] @ B[N, K]^T ---------

constexpr int TC_BK = 64;             // k bytes per stage (two m16n8k32 steps)
constexpr int TC_BKP = TC_BK + 16;    // padded shared row: ldmatrix conflict-free
constexpr int TC_BN = 128;            // B rows (product columns) per block
constexpr int TC_THREADS = 256;       // 8 warps: 2 along M x 4 along N
constexpr int GU_BM = 128;            // gate/up token rows per block
constexpr int DN_BM = 64;             // down token rows per block

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// 16 bytes global -> shared, asynchronously; zero-filled when !pred (src
// then is only a valid address, not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 16-byte matrices; thread t gets the 4 bytes at row t/4, bytes
// 4*(t%4) of each (the m16n8k32 fragment layout of 8-bit operands)
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ff_scale(unsigned amax_bits) {
  return fmaxf(__uint_as_float(amax_bits), 1e-8f) * (1.0f / 127.0f);
}

// Block tile BM rows x TC_BN B rows. NB = 2: B rows [0, 64) come from B0
// (gate) and [64, 128) from B1 (up), both at columns n0 .. n0+63, so each
// thread holds gate and up of the same outputs. A_F32: A is the f32 ff,
// quantized per row with the scale from a_amax while it is staged. Thread
// (warp wm, wn; lane g*4 + t) owns, of m16 tile i and n8 tile j, rows g and
// g+8 at columns 2t, 2t+1 (the m16n8 accumulator layout).
template <int BM, int NB, bool A_F32, typename Epi>
__global__ void __launch_bounds__(TC_THREADS) imma_gemm_kernel(
    const void* __restrict__ A_, const unsigned* __restrict__ a_amax,
    const int8_t* __restrict__ B0, const int8_t* __restrict__ B1, int M, int N, int K, Epi epi) {
  constexpr int WM = BM / 2, MI = WM / 16, NJ = 4;  // warp: WM rows x 4 n8 tiles
  constexpr int AF = A_F32 ? BM * (TC_BK / 4) / TC_THREADS : 1;  // f32 A: float4s per thread
  __shared__ __align__(128) int8_t As[2][BM][TC_BKP];
  __shared__ __align__(128) int8_t Bs[2][TC_BN][TC_BKP];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * (TC_BN / NB);
  const int KT = (K + TC_BK - 1) / TC_BK;

  int acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  auto load_b = [&](int stage, int k0) {
#pragma unroll
    for (int c = tid; c < TC_BN * (TC_BK / 16); c += TC_THREADS) {
      const int r = c >> 2, k = k0 + (c & 3) * 16;
      const int8_t* Bp = (NB == 2 && r >= 64) ? B1 : B0;
      const int n = n0 + (NB == 2 ? (r & 63) : r);
      const bool ok = n < N && k < K;
      cp_async16(&Bs[stage][r][(c & 3) * 16], ok ? Bp + (size_t)n * K + k : Bp, ok);
    }
  };
  auto load_a8 = [&](int stage, int k0) {
    const int8_t* A = static_cast<const int8_t*>(A_);
#pragma unroll
    for (int c = tid; c < BM * (TC_BK / 16); c += TC_THREADS) {
      const int r = c >> 2, m = m0 + r, k = k0 + (c & 3) * 16;
      const bool ok = m < M && k < K;
      cp_async16(&As[stage][r][(c & 3) * 16], ok ? A + (size_t)m * K + k : A, ok);
    }
  };
  // f32 A: thread tid stages float4 column tid % 16 of rows tid / 16 + 16 i
  float inv[AF];
  float4 af[AF];
  if constexpr (A_F32) {
#pragma unroll
    for (int i = 0; i < AF; ++i) {
      const int m = m0 + (tid >> 4) + 16 * i;
      inv[i] = m < M ? 1.0f / ff_scale(a_amax[m]) : 0.f;
    }
  }
  auto fetch_af = [&](int k0) {
    const float* A = static_cast<const float*>(A_);
    const int k = k0 + (tid & 15) * 4;
#pragma unroll
    for (int i = 0; i < AF; ++i) {
      const int m = m0 + (tid >> 4) + 16 * i;
      af[i] = (m < M && k < K) ? __ldg(reinterpret_cast<const float4*>(A + (size_t)m * K + k))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_af = [&](int stage) {
#pragma unroll
    for (int i = 0; i < AF; ++i) {
      const float x[4] = {af[i].x, af[i].y, af[i].z, af[i].w};
      unsigned packed = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // quantize_act: round(ff * (1/ffs)), clip to +-127
        const int qv = (int)fminf(fmaxf(rintf(x[e] * inv[i]), -127.f), 127.f);
        packed |= (unsigned)(qv & 0xff) << (8 * e);
      }
      *reinterpret_cast<unsigned*>(&As[stage][(tid >> 4) + 16 * i][(tid & 15) * 4]) = packed;
    }
  };
  auto compute = [&](int stage) {
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 32) {
      unsigned a[MI][4], b[NJ][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(a[i], &As[stage][wm * WM + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                             [kk + (lane >> 4) * 16]);
#pragma unroll
      for (int jp = 0; jp < NJ; jp += 2) {
        // n8 tiles jp, jp+1 are 16 consecutive B rows
        const int row0 = NB == 2 ? (jp < 2 ? wn * 16 : 64 + wn * 16) : wn * 32 + jp * 8;
        unsigned t[4];
        ldmatrix_x4(t, &Bs[stage][row0 + (lane & 7) + (lane >> 4) * 8]
                          [kk + ((lane >> 3) & 1) * 16]);
        b[jp][0] = t[0];
        b[jp][1] = t[1];
        b[jp + 1][0] = t[2];
        b[jp + 1][1] = t[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  };

  // two-stage pipeline: stage kt+1 loads while stage kt computes
  if constexpr (A_F32) {
    fetch_af(0);
    store_af(0);
  } else {
    load_a8(0, 0);
  }
  load_b(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < KT;
    if (more) {
      if constexpr (A_F32) {
        fetch_af((kt + 1) * TC_BK);  // in flight through this stage's products
      } else {
        load_a8(cur ^ 1, (kt + 1) * TC_BK);
      }
      load_b(cur ^ 1, (kt + 1) * TC_BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    compute(cur);
    if constexpr (A_F32) {
      if (more) store_af(cur ^ 1);  // that buffer's last readers passed the barrier below
    }
    __syncthreads();
  }

  // epilogue
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + wm * WM + i * 16 + g + 8 * hh;
      if constexpr (NB == 2) {
        float row_max = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn * 16 + j * 8 + t2;
          if (m < M && n < N)
            row_max = fmaxf(row_max, epi.store2(m, n, acc[i][j][2 * hh], acc[i][j][2 * hh + 1],
                                                acc[i][j + 2][2 * hh], acc[i][j + 2][2 * hh + 1]));
        }
        // the 4 threads of a quad share row m: reduce, then one atomic
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
        if ((lane & 3) == 0 && m < M) epi.row_max(m, row_max);
      } else {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = n0 + wn * 32 + j * 8 + t2;
          if (m < M && n < N) epi.store2(m, n, acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
        }
      }
    }
  }
}

// gate/up: ff = silu(g) * u for columns n, n+1 of row m; returns their max |ff|
struct EpiGateUpTC {
  const float* xs;
  const float* sg;
  const float* su;
  float* ff;
  unsigned* amax_bits;  // f32 bits of the row amax (non-negative: uint order)
  int N;
  __device__ float store2(int m, int n, int g0, int g1, int u0, int u1) const {
    const float x = xs[m];
    const float g[2] = {(float)g0 * x * sg[n], (float)g1 * x * sg[n + 1]};
    const float u[2] = {(float)u0 * x * su[n], (float)u1 * x * su[n + 1]};
    float f[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) f[e] = g[e] * (1.0f / (1.0f + expf(-g[e]))) * u[e];
    *reinterpret_cast<float2*>(ff + (size_t)m * N + n) = make_float2(f[0], f[1]);
    return fmaxf(fabsf(f[0]), fabsf(f[1]));
  }
  __device__ void row_max(int m, float v) const { atomicMax(amax_bits + m, __float_as_uint(v)); }
};

// down: out = x + cast(acc * ffs * sd), the residual add in the model dtype
template <typename T>
struct EpiDownTC {
  const T* x;
  const unsigned* amax_bits;
  const float* sd;
  T* out;
  int N;
  __device__ void store2(int m, int n, int a0, int a1) const {
    const float fs = ff_scale(amax_bits[m]);
    const size_t o = (size_t)m * N + n;
    out[o] = from_f32<T>(to_f32(x[o]) + round_to<T>((float)a0 * fs * sd[n]));
    out[o + 1] = from_f32<T>(to_f32(x[o + 1]) + round_to<T>((float)a1 * fs * sd[n + 1]));
  }
};

template <typename T>
cudaError_t qkv(const void* x, const void* nw, const void* w, const void* ws, const void* bias,
                void* xq, void* xs, void* out, int M, int D, int N, float eps,
                cudaStream_t st) {
  norm_quant_kernel<T><<<M, ROW_THREADS, 0, st>>>((const T*)x, (const float*)nw, (int8_t*)xq,
                                                  (float*)xs, nullptr, D, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  EpiQKV<T> epi{(const float*)xs, (const float*)ws, (const float*)bias, (T*)out, N};
  gemm_s8_kernel<1, EpiQKV<T>><<<gemm_grid(M, N), GTHREADS, 0, st>>>(
      (const int8_t*)xq, (const int8_t*)w, nullptr, M, N, D, epi);
  return cudaGetLastError();
}

template <typename T>
cudaError_t mlp(const void* x, const void* nw, const void* wg, const void* sg, const void* wu,
                const void* su, const void* wd, const void* sd, void* xq, void* xs, void* ff,
                void* amax, void* out, int M, int D, int F, float eps, cudaStream_t st) {
  norm_quant_kernel<T><<<M, ROW_THREADS, 0, st>>>((const T*)x, (const float*)nw, (int8_t*)xq,
                                                  (float*)xs, (unsigned*)amax, D, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  EpiGateUpTC gu{(const float*)xs, (const float*)sg, (const float*)su, (float*)ff,
                 (unsigned*)amax, F};
  imma_gemm_kernel<GU_BM, 2, false, EpiGateUpTC>
      <<<dim3(cdiv(F, TC_BN / 2), cdiv(M, GU_BM)), TC_THREADS, 0, st>>>(
          xq, nullptr, (const int8_t*)wg, (const int8_t*)wu, M, F, D, gu);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  EpiDownTC<T> dn{(const T*)x, (const unsigned*)amax, (const float*)sd, (T*)out, D};
  imma_gemm_kernel<DN_BM, 1, true, EpiDownTC<T>>
      <<<dim3(cdiv(D, TC_BN), cdiv(M, DN_BM)), TC_THREADS, 0, st>>>(
          ff, (const unsigned*)amax, (const int8_t*)wd, nullptr, M, D, F, dn);
  return cudaGetLastError();
}

}  // namespace

// x [M, D] (dtype DT_F32 or DT_BF16), nw [D] f32, w [D, N] int8, ws/bias [N]
// f32; scratch xq [M, D] int8 and xs [M] f32; out [M, N] in x's dtype.
extern "C" int neutts_fused_qkv(const void* x, const void* nw, const void* w, const void* ws,
                                const void* bias, void* xq, void* xs, void* out, int M, int D,
                                int N, int dtype, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32) return qkv<float>(x, nw, w, ws, bias, xq, xs, out, M, D, N, eps, st);
  if (dtype == DT_BF16)
    return qkv<__nv_bfloat16>(x, nw, w, ws, bias, xq, xs, out, M, D, N, eps, st);
  return (int)cudaErrorInvalidValue;
}

// x [M, D] (DT_F32 or DT_BF16); wg/wu int8 [D, F] and wd int8 [F, D] stored
// K-major (as [F, D] and [D, F] row-major buffers), 16-byte aligned, with
// f32 per-channel scales sg/su [F], sd [D]; D % 16 == 0 and F % 16 == 0;
// scratch xq [M, D] int8, xs [M] f32, ff [M, F] f32, amax [M] u32 (zeroed
// by the row pass); out [M, D] in x's dtype.
extern "C" int neutts_fused_mlp(const void* x, const void* nw, const void* wg, const void* sg,
                                const void* wu, const void* su, const void* wd, const void* sd,
                                void* xq, void* xs, void* ff, void* amax, void* out, int M,
                                int D, int F, int dtype, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || D % 16 || F % 16 || D < 16 || F < 16) return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32)
    return mlp<float>(x, nw, wg, sg, wu, su, wd, sd, xq, xs, ff, amax, out, M, D, F, eps, st);
  if (dtype == DT_BF16)
    return mlp<__nv_bfloat16>(x, nw, wg, sg, wu, su, wd, sd, xq, xs, ff, amax, out, M, D, F,
                              eps, st);
  return (int)cudaErrorInvalidValue;
}

// The MLP's GEMM tiles, for reports: gate/up rows and columns (of gate and
// of up) per block, down rows and columns per block, k bytes per stage,
// stages, threads per block.
extern "C" int neutts_fused_mlp_tile(int* shape) {
  const int v[7] = {GU_BM, TC_BN / 2, DN_BM, TC_BN, TC_BK, 2, TC_THREADS};
  for (int i = 0; i < 7; ++i) shape[i] = v[i];
  return 0;
}
