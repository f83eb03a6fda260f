// Causal, left-pad-masked GQA self-attention over a fresh prompt window.
//
// Replaces the TPU kernel neutts_tpu/ops/attention.py `_prefill_kernel` /
// `prefill_attention`.
//
// For batch row b with left pad p = pads[b], query position i attends keys
// j with p <= j <= i; f32 scores and softmax; rows i < p (pad rows) are
// written as zeros. q [B, S, H, D], k/v [B, S, K, D], H = K * G.
//
// What bounds it on the H100: at the path's shapes (S = 512, D = 64, ragged
// pads) the causal work is ~140 flops per byte of q/k/v/out, under the
// bf16 tensor-core ridge (~295), so the card's bound is memory traffic; in
// practice this f32 CUDA-core version is limited by its arithmetic, so the
// design keeps every score on chip and does only the causal, non-pad part
// of the work. The TPU kernel held a whole [G*QB, S] score tile in
// 100 MB of VMEM; 227 KB of shared memory cannot, so this kernel tiles the
// keys with an f32 online softmax (flash attention). One block per
// (q tile of QB positions, KV head, batch row) holds the G*QB query rows of
// all G query heads of that KV head, so each K/V tile staged in shared
// memory serves all of them. Key tiles entirely inside the left pad, and
// those past the causal diagonal of the q tile, are skipped; a q tile made
// only of pad rows writes zeros and stops.
//
// This first version multiplies in f32 on the CUDA cores; tensor-core
// products (mma/wgmma on bf16 tiles) are for a later change. It normalises
// at the end, where the JAX code casts the normalised probabilities to the
// v dtype before the PV product, so the rounding differs slightly.
#include "common.cuh"

namespace {

constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // 8 warps

template <typename T>
__global__ void __launch_bounds__(THREADS) prefill_attention_kernel(
    const T* __restrict__ q,        // [B, S, H, D]
    const T* __restrict__ k,        // [B, S, K, D]
    const T* __restrict__ v,        // [B, S, K, D]
    const int* __restrict__ pads,   // [B]
    T* __restrict__ out,            // [B, S, H, D]
    int S, int K, int G, int D, int QB) {
  extern __shared__ float smem[];
  const int R = G * QB;  // query rows in this block: r = g * QB + i
  const int DP = D + 1;
  float* q_s = smem;             // [R][D], pre-scaled by 1/sqrt(D)
  float* k_s = q_s + R * D;      // [BK][DP]
  float* v_s = k_s + BK * DP;    // [BK][D]
  float* s_s = v_s + BK * D;     // [R][BK]
  float* acc_s = s_s + R * BK;   // [R][D]
  float* m_s = acc_s + R * D;    // [R]
  float* l_s = m_s + R;          // [R]
  float* a_s = l_s + R;          // [R]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = K * G;
  const int pad = pads[b];
  const int r0 = qt * QB;                    // first query position
  const int r_last = min(r0 + QB, S) - 1;   // last query position
  const float scale = 1.0f / sqrtf((float)D);

  if (r_last < pad) {  // every row of the tile is left pad
    for (int idx = tid; idx < R * D; idx += THREADS) {
      const int r = idx / D, d = idx - r * D;
      const int g = r / QB, pos = r0 + (r - g * QB);
      if (pos < S) out[(((size_t)b * S + pos) * H + h * G + g) * D + d] = from_f32<T>(0.f);
    }
    return;
  }

  for (int idx = tid; idx < R * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    const int g = r / QB, pos = r0 + (r - g * QB);
    q_s[idx] = pos < S ? to_f32(q[(((size_t)b * S + pos) * H + h * G + g) * D + d]) * scale : 0.f;
    acc_s[idx] = 0.f;
  }
  for (int r = tid; r < R; r += THREADS) {
    m_s[r] = -1e30f;
    l_s[r] = 0.f;
  }
  __syncthreads();

  for (int k0 = (pad / BK) * BK; k0 <= r_last; k0 += BK) {
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int j = idx / D, d = idx - j * D, key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < S) {
        const size_t off = (((size_t)b * S + key) * K + h) * D + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      k_s[j * DP + d] = kv;
      v_s[j * D + d] = vv;
    }
    __syncthreads();

    for (int idx = tid; idx < R * BK; idx += THREADS) {
      const int r = idx / BK, j = idx - r * BK;
      const int pos = r0 + (r % QB), key = k0 + j;
      float s = -1e30f;
      if (key <= pos && key >= pad && pos < S) {
        const float* qr = q_s + r * D;
        const float* kr = k_s + j * DP;
        s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      }
      s_s[idx] = s;
    }
    __syncthreads();

    for (int r = warp; r < R; r += THREADS / 32) {
      float* sr = s_s + r * BK;
      float mx = -1e30f;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, sr[j]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = expf(sr[j] - m_new);
        sr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < R * D; idx += THREADS) {
      const int r = idx / D, d = idx - r * D;
      const float* pr = s_s + r * BK;
      float o = 0.f;
      for (int j = 0; j < BK; ++j) o = fmaf(pr[j], v_s[j * D + d], o);
      acc_s[idx] = acc_s[idx] * a_s[r] + o;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < R * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    const int g = r / QB, pos = r0 + (r - g * QB);
    if (pos >= S) continue;
    const float o = pos >= pad ? acc_s[idx] / fmaxf(l_s[r], 1e-30f) : 0.f;
    out[(((size_t)b * S + pos) * H + h * G + g) * D + d] = from_f32<T>(o);
  }
}

size_t smem_bytes(int G, int D, int QB) {
  const size_t R = (size_t)G * QB;
  return sizeof(float) * (R * D + BK * (D + 1) + BK * D + R * BK + R * D + 3 * R);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pads, void* out,
                   int B, int S, int K, int G, int D, cudaStream_t st) {
  const int QB = G <= 8 ? 16 : 8;
  const size_t smem = smem_bytes(G, D, QB);
  auto kern = prefill_attention_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + QB - 1) / QB, K, B);
  kern<<<grid, THREADS, smem, st>>>((const T*)q, (const T*)k, (const T*)v, (const int*)pads,
                                    (T*)out, S, K, G, D, QB);
  return cudaGetLastError();
}

}  // namespace

// dtype: DT_F32 or DT_BF16 (q, k, v and out share it).
extern "C" int neutts_prefill_attention(const void* q, const void* k, const void* v,
                                        const void* pads, void* out, int B, int S, int K,
                                        int G, int D, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32) return launch<float>(q, k, v, pads, out, B, S, K, G, D, st);
  if (dtype == DT_BF16) return launch<__nv_bfloat16>(q, k, v, pads, out, B, S, K, G, D, st);
  return (int)cudaErrorInvalidValue;
}
