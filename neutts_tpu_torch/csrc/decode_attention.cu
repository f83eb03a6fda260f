// Split-K flash-decode attention over one layer of the stacked KV cache.
//
// Replaces the TPU kernel neutts_tpu/ops/attention.py `_kernel` /
// `decode_attention_stacked` (bf16, int8 and int4 cache modes).
//
// Computes, for each batch row b and query head (h, g) of KV head h:
//   out = softmax_t(q . k_t / sqrt(D)) . v_t   over the live slots t in
//   [pad[b], lens[b]), with an online f32 softmax. The int8 cache holds
//   per-token symmetric values with f32 scales [L, B, T]: k_t = kq_t * ks_t,
//   v_t = vq_t * vs_t. The int4 cache holds the same per-token values as
//   nibble pairs [L, B, T/2, K*D] with deinterleaved scales [L, B, T]
//   (token t's scale at t/2 + (t&1)*T/2); the rest is the int8 mode. A row
//   with an empty range writes zeros.
//
// What bounds it on the H100 (bytes), and the design that answers it, are
// those of flash_decode.cuh, which holds the tile loop and the merge: grid
// (B * K, NSPLIT), block `split` taking chunk `split` of [pad, lens), the
// NSPLIT partials merged in the same launch by the last block to arrive.
#include "flash_decode.cuh"

namespace {

using namespace flash_decode;

// T counts tokens; an int4 cache row holds T/2 byte rows. ws:
// [B*K][NSPLIT][G][D] partial sums then [B*K][NSPLIT][2][G] (m, l).
template <typename QT, typename CT, bool INT4>
__global__ void __launch_bounds__(THREADS) decode_attention_kernel(
    const QT* __restrict__ q,           // [B, K, G, D]
    const CT* __restrict__ all_k,       // [L, B, T, K*D] (int4: [L, B, T/2, K*D])
    const CT* __restrict__ all_v,
    const float* __restrict__ k_scale,  // [L, B, T] or null (float cache)
    const float* __restrict__ v_scale,
    const int* __restrict__ lens,       // [B]
    const int* __restrict__ pad,        // [B]
    QT* __restrict__ out,               // [B, K, G, D]
    float* __restrict__ ws,
    int* __restrict__ counters,         // [B*K], 0 between launches
    int B, int K, int G, int D, int T, int layer, int nsplit) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm = carve(smem, G, D);
  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / K, h = bh - b * K;
  const int KD = K * D;
  int clo, chi;
  chunk_of<INT4>(pad[b], min(lens[b], T), split, nsplit, clo, chi);

  State st;
  start_block(sm, st, q + (size_t)bh * G * D, G, D);
  const size_t srow0 = ((size_t)layer * B + b) * T;  // scale row of slot 0
  const size_t row0 = INT4 ? srow0 / 2 : srow0;      // value row of slot 0
  const bool quant = k_scale != nullptr;
  attend_chunk<CT, INT4>(sm, st, all_k + row0 * KD + (size_t)h * D,
                         all_v + row0 * KD + (size_t)h * D, quant ? k_scale + srow0 : nullptr,
                         quant ? v_scale + srow0 : nullptr, KD, G, D, clo, chi, T / 2);
  merge_partials(sm, st, ws, counters, out, bh, split, nsplit, B * K, G, D);
}

template <typename QT, typename CT, bool INT4 = false>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* lens, const void* pad, void* out, void* ws,
                   void* counters, int B, int K, int G, int D, int T, int layer, int nsplit,
                   cudaStream_t st) {
  const size_t smem = smem_bytes(G, D);
  auto kern = decode_attention_kernel<QT, CT, INT4>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(B * K, nsplit), THREADS, smem, st>>>(
      (const QT*)q, (const CT*)k, (const CT*)v, (const float*)ks, (const float*)vs,
      (const int*)lens, (const int*)pad, (QT*)out, (float*)ws, (int*)counters, B, K, G, D, T,
      layer, nsplit);
  return cudaGetLastError();
}

}  // namespace

// q_dtype: DT_F32 or DT_BF16; c_dtype: the same float type, or DT_I8 / DT_I4
// (packed pairs, T even) with ks/vs non-null. T counts tokens. D % 16 == 0,
// D <= 128, G <= 16, cache buffers 16-byte aligned; 1 <= nsplit <= 32, a
// workspace ws of B*K*nsplit*(G*D + 2*G) floats and B*K int counters that
// are 0. Returns cudaGetLastError() after the launch.
extern "C" int neutts_decode_attention(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    const void* lens, const void* pad, void* out, void* ws, void* counters, int B, int K,
    int G, int D, int T, int layer, int nsplit, int q_dtype, int c_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D % 16 || D > 128 || G < 1 || G > GMAX || nsplit < 1 || nsplit > MAX_SPLIT ||
      ws == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
#define NEUTTS_LAUNCH(QT, CT, I4) \
  launch<QT, CT, I4>(q, k, v, ks, vs, lens, pad, out, ws, counters, B, K, G, D, T, layer, \
                     nsplit, st)
  if (q_dtype == DT_F32 && c_dtype == DT_F32) return NEUTTS_LAUNCH(float, float, false);
  if (q_dtype == DT_BF16 && c_dtype == DT_BF16)
    return NEUTTS_LAUNCH(__nv_bfloat16, __nv_bfloat16, false);
  if (q_dtype == DT_F32 && c_dtype == DT_I8) return NEUTTS_LAUNCH(float, int8_t, false);
  if (q_dtype == DT_BF16 && c_dtype == DT_I8) return NEUTTS_LAUNCH(__nv_bfloat16, int8_t, false);
  if (T % 2 == 0 && q_dtype == DT_F32 && c_dtype == DT_I4)
    return NEUTTS_LAUNCH(float, int8_t, true);
  if (T % 2 == 0 && q_dtype == DT_BF16 && c_dtype == DT_I4)
    return NEUTTS_LAUNCH(__nv_bfloat16, int8_t, true);
#undef NEUTTS_LAUNCH
  return (int)cudaErrorInvalidValue;
}
