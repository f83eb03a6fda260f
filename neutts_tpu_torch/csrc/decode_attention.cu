// Flash-decode attention over one layer of the stacked KV cache.
//
// Replaces the TPU kernel neutts_tpu/ops/attention.py `_kernel` /
// `decode_attention_stacked` (bf16 and int8 cache modes; the int4 mode is
// still to be ported).
//
// Computes, for each batch row b and query head (h, g) of KV head h:
//   out = softmax_t(q . k_t / sqrt(D)) . v_t   over the live slots t in
//   [pad[b], lens[b]), with an online f32 softmax. The int8 cache holds
//   per-token symmetric values with f32 scales [L, B, T]: k_t = kq_t * ks_t,
//   v_t = vq_t * vs_t. As in the TPU kernel, ks_t is folded into the scores
//   and vs_t into the probabilities (G multiplies per token instead of D).
//
// What bounds it on the H100: bytes. Each (row, KV head) reads its live K/V
// prefix once (int8: 128 B per token per head pair, bf16: 256 B) and does
// ~4 flops per byte read, far below the card's ~295 flop/byte ridge.
// The design therefore reads only the live prefix [pad, lens) — never the
// whole preallocated cache — and reads it exactly once: one block per
// (batch row, KV head) stages a 64-token K/V tile in shared memory, and all
// G query heads of that KV head (GQA) score against the same tile. G is a
// runtime value (Air 7, Nano 4, the test config 2).
//
// This first version is simple: with B = 8 and K = 2 it runs only 16
// blocks, far too few to pull the card's bandwidth. Splitting the time axis
// across blocks (split-K flash-decode) is the next step, in a later change.
// Masked scores use the finite -1e30 as the JAX code does.
#include "common.cuh"

namespace {

constexpr int BT = 64;        // cache tokens per tile
constexpr int THREADS = 128;  // 4 warps

template <typename QT, typename CT>
__global__ void __launch_bounds__(THREADS) decode_attention_kernel(
    const QT* __restrict__ q,           // [B, K, G, D]
    const CT* __restrict__ all_k,       // [L, B, T, K*D]
    const CT* __restrict__ all_v,       // [L, B, T, K*D]
    const float* __restrict__ k_scale,  // [L, B, T] or null (float cache)
    const float* __restrict__ v_scale,
    const int* __restrict__ lens,       // [B]
    const int* __restrict__ pad,        // [B]
    QT* __restrict__ out,               // [B, K, G, D]
    int B, int K, int G, int D, int T, int layer) {
  extern __shared__ float smem[];
  const int DP = D + 1;  // padded K rows: conflict-free score reads
  float* q_s = smem;            // [G][D], pre-scaled by 1/sqrt(D)
  float* k_s = q_s + G * D;     // [BT][DP]
  float* v_s = k_s + BT * DP;   // [BT][D]
  float* s_s = v_s + BT * D;    // [G][BT] scores, then probabilities
  float* acc_s = s_s + G * BT;  // [G][D]
  float* m_s = acc_s + G * D;   // [G] running max
  float* l_s = m_s + G;         // [G] running sum
  float* a_s = l_s + G;         // [G] this tile's rescale factor
  float* ks_s = a_s + G;        // [BT] int8 mode: per-token K scales
  float* vs_s = ks_s + BT;      // [BT] int8 mode: per-token V scales

  const int b = blockIdx.x / K, h = blockIdx.x % K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int KD = K * D;
  const float scale = 1.0f / sqrtf((float)D);
  const size_t row0 = ((size_t)layer * B + b) * T;  // cache row of slot 0
  const CT* kb = all_k + row0 * KD + (size_t)h * D;
  const CT* vb = all_v + row0 * KD + (size_t)h * D;
  const float* ksb = k_scale ? k_scale + row0 : nullptr;
  const float* vsb = v_scale ? v_scale + row0 : nullptr;
  const QT* qb = q + ((size_t)b * K + h) * G * D;

  for (int i = tid; i < G * D; i += THREADS) {
    q_s[i] = to_f32(qb[i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = -1e30f;
    l_s[g] = 0.f;
  }
  const int lo = pad[b];
  const int hi = min(lens[b], T);
  __syncthreads();

  for (int t0 = lo; t0 < hi; t0 += BT) {
    for (int i = tid; i < BT * D; i += THREADS) {
      const int tt = i / D, d = i - tt * D, t = t0 + tt;
      float kv = 0.f, vv = 0.f;
      if (t < hi) {
        kv = to_f32(kb[(size_t)t * KD + d]);
        vv = to_f32(vb[(size_t)t * KD + d]);
      }
      k_s[tt * DP + d] = kv;
      v_s[tt * D + d] = vv;
    }
    if (ksb != nullptr) {
      for (int tt = tid; tt < BT; tt += THREADS) {
        const int t = t0 + tt;
        ks_s[tt] = t < hi ? ksb[t] : 0.f;
        vs_s[tt] = t < hi ? vsb[t] : 0.f;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * BT; i += THREADS) {
      const int g = i / BT, tt = i - g * BT;
      float s = -1e30f;
      if (t0 + tt < hi) {
        const float* qr = q_s + g * D;
        const float* kr = k_s + tt * DP;
        s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
        if (ksb != nullptr) s *= ks_s[tt];  // K scale folded into the score
      }
      s_s[i] = s;
    }
    __syncthreads();

    // online softmax update, one warp per query head
    for (int g = warp; g < G; g += THREADS / 32) {
      float* sr = s_s + g * BT;
      float mx = -1e30f;
      for (int tt = lane; tt < BT; tt += 32) mx = fmaxf(mx, sr[tt]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int tt = lane; tt < BT; tt += 32) {
        const float p = expf(sr[tt] - m_new);
        sr[tt] = vsb != nullptr ? p * vs_s[tt] : p;  // V scale folded into p
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, d = i - g * D;
      const float* pr = s_s + g * BT;
      float o = 0.f;
      for (int tt = 0; tt < BT; ++tt) o = fmaf(pr[tt], v_s[tt * D + d], o);
      acc_s[i] = acc_s[i] * a_s[g] + o;
    }
    __syncthreads();
  }

  QT* ob = out + ((size_t)b * K + h) * G * D;
  for (int i = tid; i < G * D; i += THREADS)
    ob[i] = from_f32<QT>(acc_s[i] / fmaxf(l_s[i / D], 1e-30f));
}

template <typename QT, typename CT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* lens, const void* pad, void* out,
                   int B, int K, int G, int D, int T, int layer, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)2 * G * D + BT * (D + 1) + BT * D + G * BT + 3 * G + 2 * BT);
  auto kern = decode_attention_kernel<QT, CT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<B * K, THREADS, smem, st>>>(
      (const QT*)q, (const CT*)k, (const CT*)v, (const float*)ks,
      (const float*)vs, (const int*)lens, (const int*)pad, (QT*)out, B, K, G,
      D, T, layer);
  return cudaGetLastError();
}

}  // namespace

// q_dtype: DT_F32 or DT_BF16; c_dtype: the same float type, or DT_I8 with
// ks/vs non-null. Returns cudaGetLastError() after the launch.
extern "C" int neutts_decode_attention(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    const void* lens, const void* pad, void* out, int B, int K, int G, int D,
    int T, int layer, int q_dtype, int c_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == DT_F32 && c_dtype == DT_F32)
    return launch<float, float>(q, k, v, ks, vs, lens, pad, out, B, K, G, D, T, layer, st);
  if (q_dtype == DT_BF16 && c_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, ks, vs, lens, pad, out, B, K, G, D, T,
                                                layer, st);
  if (q_dtype == DT_F32 && c_dtype == DT_I8)
    return launch<float, int8_t>(q, k, v, ks, vs, lens, pad, out, B, K, G, D, T, layer, st);
  if (q_dtype == DT_BF16 && c_dtype == DT_I8)
    return launch<__nv_bfloat16, int8_t>(q, k, v, ks, vs, lens, pad, out, B, K, G, D, T, layer,
                                         st);
  return (int)cudaErrorInvalidValue;
}
