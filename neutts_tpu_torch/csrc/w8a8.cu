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
// in and out. Both are limited in practice by the CUDA-core int8 rate of
// __dp4a, so the design reuses each staged tile 64-fold. Each op runs as a launch
// of its own: a row pass (norm + quant, one block per token), then tiled
// int8 GEMMs written by hand with __dp4a (64x64 output tiles, 32-byte k
// steps staged in shared memory, 4x4 outputs per thread), whose epilogues
// apply the scales, the SiLU product with the row amax of ff, or the
// residual add. __dp4a runs on the CUDA cores, far below the int8 tensor
// cores; mma.sync / wgmma tiles are for a later change. This first version
// also writes the f32 ff [M, F] to device memory and reads it back for the
// quant pass, where the TPU kernel keeps it on chip; keeping it on chip is
// likewise later work.
#include "common.cuh"

namespace {

// --- row pass: rms_norm + per-token int8 quantization ----------------------

constexpr int ROW_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS) norm_quant_kernel(
    const T* __restrict__ x, const float* __restrict__ nw, int8_t* __restrict__ xq,
    float* __restrict__ xs, int D, float eps) {
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
}

// ff quantization with the row amax gathered by the gate/up epilogue
__global__ void quant_rows_kernel(const float* __restrict__ ff,
                                  const unsigned* __restrict__ amax_bits,
                                  int8_t* __restrict__ q, float* __restrict__ s, int M, int N) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(i / N);
    const float sc = fmaxf(__uint_as_float(amax_bits[m]), 1e-8f) * (1.0f / 127.0f);
    q[i] = (int8_t)fminf(fmaxf(rintf(ff[i] * (1.0f / sc)), -127.f), 127.f);
    if (i - (size_t)m * N == 0) s[m] = sc;
  }
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

struct EpiGateUp {
  static constexpr bool kRowMax = true;
  const float* xs;
  const float* sg;
  const float* su;
  float* ff;
  unsigned* amax_bits;  // f32 bits of the row amax (non-negative: uint order)
  int N;
  __device__ float store(int m, int n, int ag, int au) const {
    const float g = (float)ag * xs[m] * sg[n];
    const float u = (float)au * xs[m] * su[n];
    const float f = g * (1.0f / (1.0f + expf(-g))) * u;
    ff[(size_t)m * N + n] = f;
    return fabsf(f);
  }
  __device__ void row_max(int m, float v) const { atomicMax(amax_bits + m, __float_as_uint(v)); }
};

template <typename T>
struct EpiDown {
  static constexpr bool kRowMax = false;
  const T* x;
  const float* fs;
  const float* sd;
  T* out;
  int N;
  __device__ float store(int m, int n, int a, int) const {
    const size_t o = (size_t)m * N + n;
    const float d = round_to<T>((float)a * fs[m] * sd[n]);
    out[o] = from_f32<T>(to_f32(x[o]) + d);  // residual add in the model dtype
    return 0.f;
  }
  __device__ void row_max(int, float) const {}
};

dim3 gemm_grid(int M, int N) { return dim3((N + GBN - 1) / GBN, (M + GBM - 1) / GBM); }

template <typename T>
cudaError_t qkv(const void* x, const void* nw, const void* w, const void* ws, const void* bias,
                void* xq, void* xs, void* out, int M, int D, int N, float eps,
                cudaStream_t st) {
  norm_quant_kernel<T><<<M, ROW_THREADS, 0, st>>>((const T*)x, (const float*)nw, (int8_t*)xq,
                                                  (float*)xs, D, eps);
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
                void* amax, void* ffq, void* ffs, void* out, int M, int D, int F, float eps,
                cudaStream_t st) {
  norm_quant_kernel<T><<<M, ROW_THREADS, 0, st>>>((const T*)x, (const float*)nw, (int8_t*)xq,
                                                  (float*)xs, D, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  EpiGateUp gu{(const float*)xs, (const float*)sg, (const float*)su, (float*)ff,
               (unsigned*)amax, F};
  gemm_s8_kernel<2, EpiGateUp><<<gemm_grid(M, F), GTHREADS, 0, st>>>(
      (const int8_t*)xq, (const int8_t*)wg, (const int8_t*)wu, M, F, D, gu);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t total = (size_t)M * F;
  const int blocks = (int)((total + 255) / 256 < 65535 * 8 ? (total + 255) / 256 : 65535 * 8);
  quant_rows_kernel<<<blocks, 256, 0, st>>>((const float*)ff, (const unsigned*)amax,
                                            (int8_t*)ffq, (float*)ffs, M, F);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  EpiDown<T> dn{(const T*)x, (const float*)ffs, (const float*)sd, (T*)out, D};
  gemm_s8_kernel<1, EpiDown<T>><<<gemm_grid(M, D), GTHREADS, 0, st>>>(
      (const int8_t*)ffq, (const int8_t*)wd, nullptr, M, D, F, dn);
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

// x [M, D]; wg/wu [D, F] and wd [F, D] int8 with f32 per-channel scales;
// scratch xq [M, D] int8, xs [M] f32, ff [M, F] f32, amax [M] zeroed u32,
// ffq [M, F] int8, ffs [M] f32; out [M, D] in x's dtype.
extern "C" int neutts_fused_mlp(const void* x, const void* nw, const void* wg, const void* sg,
                                const void* wu, const void* su, const void* wd, const void* sd,
                                void* xq, void* xs, void* ff, void* amax, void* ffq, void* ffs,
                                void* out, int M, int D, int F, int dtype, float eps,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32)
    return mlp<float>(x, nw, wg, sg, wu, su, wd, sd, xq, xs, ff, amax, ffq, ffs, out, M, D, F,
                      eps, st);
  if (dtype == DT_BF16)
    return mlp<__nv_bfloat16>(x, nw, wg, sg, wu, su, wd, sd, xq, xs, ff, amax, ffq, ffs, out, M,
                              D, F, eps, st);
  return (int)cudaErrorInvalidValue;
}
