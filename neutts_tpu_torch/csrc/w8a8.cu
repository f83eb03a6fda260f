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
// one warp per token), then tiled int8 GEMMs whose epilogues apply the
// scales, the bias, the SiLU product with the row amax of ff, or the
// residual add.
//
// All three GEMMs (imma_gemm_kernel) run on the int8 tensor cores:
// mma.sync m16n8k32 s8 x s8 -> s32, fragments loaded by ldmatrix from
// shared-memory rows padded by 16 bytes (conflict-free), 16-byte cp.async
// tiles in a ring of 64-byte k steps, 256 threads as 2 x 4 warps.
// Both operands are K-contiguous: the activations by nature, the weights
// because the port stores them K-major ([N, K] storage, backbone.k_major).
// - QKV: 128 columns of [Q | K | V] per block (N = 1152 at Air is 9 column
//   tiles) and a row tile picked by M: 64 token rows with 3 k steps in
//   flight below QKV_WIDE_M rows (80 registers: 3 blocks an SM), 128 rows
//   with 2 from there (96 registers: 2 blocks; 3 steps would pass the 48 KB
//   of static shared memory). Both are kept because each is the faster at
//   the shapes that take it (tools/probe_qkv_tile.py on an H100, N 1152,
//   L2 flushed): 64 rows at M 4096 (0.052 against 0.061 ms; 576 blocks,
//   1.5 waves, against 288 blocks, 1.1 waves) and 8192, 128 rows at 16384
//   and 32768 (0.256 against 0.284 ms: a 64 x 32 warp tile loads fewer
//   ldmatrix fragments and shared bytes per mma). One threshold leaves M
//   3072 (a bucket-384 prefill of 8) on 64 rows, where 216 blocks of 128
//   rows, one wave, were the faster (0.039 against 0.046 ms). The epilogue dequantizes
//   two adjacent columns (acc * xs * ws, rounded to the model dtype), adds
//   the bias rounded to the model dtype, and stores them as one pair.
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
#include "common.cuh"

// Token rows from which the QKV GEMM takes its 128-row tile; the probe
// tools/probe_qkv_tile.py builds the library with 0 and INT_MAX as well.
#ifndef NEUTTS_QKV_WIDE_M
#define NEUTTS_QKV_WIDE_M 16384
#endif

namespace {

// --- row pass: rms_norm + per-token int8 quantization ----------------------
//
// One warp per token row, ROW_THREADS / 32 rows per block; each lane reads
// its share of the row as 16-byte vectors (D % 16 == 0, rows 16-byte
// aligned) three times (sum of squares, amax, quantization: the second
// and third reads hit L1) and writes its int8 values as one 8- (bf16) or
// 4-byte (f32) word per vector. (Unrolling the loops by 4 measured slower
// on an H100: 0.0089 against 0.0070 ms at M 4096.)

constexpr int ROW_THREADS = 256;
constexpr int ROWS_PER_BLOCK = ROW_THREADS / 32;

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS) norm_quant_kernel(
    const T* __restrict__ x, const float* __restrict__ nw, int8_t* __restrict__ xq,
    float* __restrict__ xs, unsigned* __restrict__ amax_zero, int M, int D, float eps) {
  constexpr int V = 16 / sizeof(T);  // elements per vector: 8 bf16 or 4 f32
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (m >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)m * D);
  const float4* nw4 = reinterpret_cast<const float4*>(nw);
  const int nv = D / V;
  auto load = [&](int j, float (&h)[V]) {  // elements j*V .. j*V+V-1 of the row
    const uint4 u = __ldg(xr + j);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) h[k] = to_f32(e[k]);
  };
  auto weight = [&](int j, float (&w)[V]) {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 f = __ldg(nw4 + (j * V + k) / 4);
      w[k] = f.x, w[k + 1] = f.y, w[k + 2] = f.z, w[k + 3] = f.w;
    }
  };
  float ss = 0.f;
  for (int j = lane; j < nv; j += 32) {
    float h[V];
    load(j, h);
#pragma unroll
    for (int k = 0; k < V; ++k) ss += h[k] * h[k];
  }
  ss = warp_sum(ss);
  const float r = 1.0f / sqrtf(ss / (float)D + eps);
  float amax = 0.f;
  for (int j = lane; j < nv; j += 32) {
    float h[V], w[V];
    load(j, h);
    weight(j, w);
#pragma unroll
    for (int k = 0; k < V; ++k) amax = fmaxf(amax, fabsf(h[k] * r * w[k]));
  }
  amax = warp_max(amax);
  const float s = fmaxf(amax, 1e-8f) * (1.0f / 127.0f);
  const float inv = 1.0f / s;
  int8_t* qr = xq + (size_t)m * D;
  for (int j = lane; j < nv; j += 32) {
    float h[V], w[V];
    load(j, h);
    weight(j, w);
    unsigned q[V / 4] = {};
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int qv = (int)fminf(fmaxf(rintf(h[k] * r * w[k] * inv), -127.f), 127.f);
      q[k / 4] |= (unsigned)(qv & 0xff) << (8 * (k % 4));
    }
    if constexpr (V == 8) {
      *reinterpret_cast<uint2*>(qr + j * V) = make_uint2(q[0], q[1]);
    } else {
      *reinterpret_cast<unsigned*>(qr + j * V) = q[0];
    }
  }
  if (lane == 0) {
    xs[m] = s;
    // the MLP: this row's ff amax starts at 0 for the gate/up epilogue's atomicMax
    if (amax_zero != nullptr) amax_zero[m] = 0u;
  }
}

inline dim3 row_grid(int M) { return dim3((M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK); }

// --- int8 tensor-core GEMM: C[M, N] = A[M, K] @ B[N, K]^T -------------------

constexpr int TC_BK = 64;             // k bytes per stage (two m16n8k32 steps)
constexpr int TC_BKP = TC_BK + 16;    // padded shared row: ldmatrix conflict-free
constexpr int TC_BN = 128;            // B rows (product columns) per block
constexpr int TC_THREADS = 256;       // 8 warps: 2 along M x 4 along N
constexpr int QKV_BM = 64;            // QKV token rows per block below QKV_WIDE_M
constexpr int QKV_STAGES = 3;         // and its k steps in flight
constexpr int QKV_WIDE_BM = 128;      // from QKV_WIDE_M rows on
constexpr int QKV_WIDE_STAGES = 2;
constexpr int QKV_WIDE_M = NEUTTS_QKV_WIDE_M;
constexpr int GU_BM = 128;            // gate/up token rows per block
constexpr int DN_BM = 64;             // down token rows per block
// static shared memory (48 KB) holds STAGES x (BM + 128) rows of 80 bytes
static_assert(QKV_STAGES * (QKV_BM + TC_BN) * TC_BKP <= 48 * 1024 &&
              QKV_WIDE_STAGES * (QKV_WIDE_BM + TC_BN) * TC_BKP <= 48 * 1024, "QKV stages");

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

// Block tile BM rows x TC_BN B rows, STAGES k steps in flight (int8 A: a
// cp.async ring, one barrier a step; f32 A: 2, its next tile staged through
// registers). NB = 2: B rows [0, 64) come from B0
// (gate) and [64, 128) from B1 (up), both at columns n0 .. n0+63, so each
// thread holds gate and up of the same outputs. A_F32: A is the f32 ff,
// quantized per row with the scale from a_amax while it is staged. Thread
// (warp wm, wn; lane g*4 + t) owns, of m16 tile i and n8 tile j, rows g and
// g+8 at columns 2t, 2t+1 (the m16n8 accumulator layout).
template <int BM, int NB, bool A_F32, int STAGES, typename Epi>
__global__ void __launch_bounds__(TC_THREADS) imma_gemm_kernel(
    const void* __restrict__ A_, const unsigned* __restrict__ a_amax,
    const int8_t* __restrict__ B0, const int8_t* __restrict__ B1, int M, int N, int K, Epi epi) {
  constexpr int WM = BM / 2, MI = WM / 16, NJ = 4;  // warp: WM rows x 4 n8 tiles
  constexpr int AF = A_F32 ? BM * (TC_BK / 4) / TC_THREADS : 1;  // f32 A: float4s per thread
  static_assert(STAGES >= 2 && (!A_F32 || STAGES == 2), "stages: f32 A takes 2");
  __shared__ __align__(128) int8_t As[STAGES][BM][TC_BKP];
  __shared__ __align__(128) int8_t Bs[STAGES][TC_BN][TC_BKP];
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

  if constexpr (A_F32) {
    // two stages: stage kt+1 loads (B by cp.async, A into registers) while
    // stage kt computes
    fetch_af(0);
    store_af(0);
    load_b(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < KT; ++kt) {
      const int cur = kt & 1;
      const bool more = kt + 1 < KT;
      if (more) {
        fetch_af((kt + 1) * TC_BK);  // in flight through this stage's products
        load_b(cur ^ 1, (kt + 1) * TC_BK);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      compute(cur);
      if (more) store_af(cur ^ 1);  // that buffer's last readers passed the barrier below
      __syncthreads();
    }
  } else {
    // ring of STAGES: stage kt + STAGES-1 loads while stage kt computes
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < KT) {
        load_a8(s, s * TC_BK);
        load_b(s, s * TC_BK);
      }
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of stage kt landed
      __syncthreads();  // everyone's did, and stage kt-1's readers are done
      const int nxt = kt + STAGES - 1;
      if (nxt < KT) {  // into the slot stage kt-1 computed from
        load_a8(nxt % STAGES, nxt * TC_BK);
        load_b(nxt % STAGES, nxt * TC_BK);
      }
      cp_async_commit();
      compute(kt % STAGES);
    }
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

// two adjacent outputs of one row as one 8- or 4-byte store (n even, N even)
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// QKV: out = cast(acc * xs * ws) + cast(bias) for columns n, n+1 of row m,
// the add in the model dtype (cast = round to T)
template <typename T>
struct EpiQKV {
  const float* xs;
  const float* ws;
  const float* bias;
  T* out;
  int N;
  __device__ void store2(int m, int n, int a0, int a1) const {
    const float x = xs[m];
    store_pair(out + (size_t)m * N + n,
               round_to<T>((float)a0 * x * ws[n]) + round_to<T>(bias[n]),
               round_to<T>((float)a1 * x * ws[n + 1]) + round_to<T>(bias[n + 1]));
  }
};

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
  norm_quant_kernel<T><<<row_grid(M), ROW_THREADS, 0, st>>>(
      (const T*)x, (const float*)nw, (int8_t*)xq, (float*)xs, nullptr, M, D, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  EpiQKV<T> epi{(const float*)xs, (const float*)ws, (const float*)bias, (T*)out, N};
  if (M >= QKV_WIDE_M) {
    imma_gemm_kernel<QKV_WIDE_BM, 1, false, QKV_WIDE_STAGES, EpiQKV<T>>
        <<<dim3(cdiv(N, TC_BN), cdiv(M, QKV_WIDE_BM)), TC_THREADS, 0, st>>>(
            xq, nullptr, (const int8_t*)w, nullptr, M, N, D, epi);
  } else {
    imma_gemm_kernel<QKV_BM, 1, false, QKV_STAGES, EpiQKV<T>>
        <<<dim3(cdiv(N, TC_BN), cdiv(M, QKV_BM)), TC_THREADS, 0, st>>>(
            xq, nullptr, (const int8_t*)w, nullptr, M, N, D, epi);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t mlp(const void* x, const void* nw, const void* wg, const void* sg, const void* wu,
                const void* su, const void* wd, const void* sd, void* xq, void* xs, void* ff,
                void* amax, void* out, int M, int D, int F, float eps, cudaStream_t st) {
  norm_quant_kernel<T><<<row_grid(M), ROW_THREADS, 0, st>>>(
      (const T*)x, (const float*)nw, (int8_t*)xq, (float*)xs, (unsigned*)amax, M, D, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  EpiGateUpTC gu{(const float*)xs, (const float*)sg, (const float*)su, (float*)ff,
                 (unsigned*)amax, F};
  imma_gemm_kernel<GU_BM, 2, false, 2, EpiGateUpTC>
      <<<dim3(cdiv(F, TC_BN / 2), cdiv(M, GU_BM)), TC_THREADS, 0, st>>>(
          xq, nullptr, (const int8_t*)wg, (const int8_t*)wu, M, F, D, gu);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  EpiDownTC<T> dn{(const T*)x, (const unsigned*)amax, (const float*)sd, (T*)out, D};
  imma_gemm_kernel<DN_BM, 1, true, 2, EpiDownTC<T>>
      <<<dim3(cdiv(D, TC_BN), cdiv(M, DN_BM)), TC_THREADS, 0, st>>>(
          ff, (const unsigned*)amax, (const int8_t*)wd, nullptr, M, D, F, dn);
  return cudaGetLastError();
}

}  // namespace

// x [M, D] (dtype DT_F32 or DT_BF16), nw [D] f32; w int8 [D, N] stored
// K-major (as an [N, D] row-major buffer), 16-byte aligned, with f32 ws and
// bias [N]; D % 16 == 0 and N % 16 == 0; scratch xq [M, D] int8 and xs [M]
// f32; out [M, N] in x's dtype.
extern "C" int neutts_fused_qkv(const void* x, const void* nw, const void* w, const void* ws,
                                const void* bias, void* xq, void* xs, void* out, int M, int D,
                                int N, int dtype, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || D % 16 || N % 16 || D < 16 || N < 16) return (int)cudaErrorInvalidValue;
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

// The GEMM tiles, for reports: QKV rows and k steps in flight per block
// below QKV_WIDE_M rows, the same from there, QKV_WIDE_M, QKV columns per
// block; gate/up rows and columns (of gate and of up) per block; down rows
// and columns per block; k bytes per step; the MLP's k steps in flight;
// threads per block.
extern "C" int neutts_w8a8_tiles(int* shape) {
  const int v[13] = {QKV_BM, QKV_STAGES, QKV_WIDE_BM, QKV_WIDE_STAGES, QKV_WIDE_M,
                     TC_BN,  GU_BM,      TC_BN / 2,   DN_BM,           TC_BN,
                     TC_BK,  2,          TC_THREADS};
  for (int i = 0; i < 13; ++i) shape[i] = v[i];
  return 0;
}
