// Flash-decode attention over one layer of the stacked KV cache.
//
// Replaces the TPU kernel neutts_tpu/ops/attention.py `_kernel` /
// `decode_attention_stacked` (bf16, int8 and int4 cache modes).
//
// Computes, for each batch row b and query head (h, g) of KV head h:
//   out = softmax_t(q . k_t / sqrt(D)) . v_t   over the live slots t in
//   [pad[b], lens[b]), with an online f32 softmax. The int8 cache holds
//   per-token symmetric values with f32 scales [L, B, T]: k_t = kq_t * ks_t,
//   v_t = vq_t * vs_t. As in the TPU kernel, ks_t is folded into the scores
//   and vs_t into the probabilities (G multiplies per token instead of D).
//   The int4 cache holds the same per-token values as nibble pairs
//   [L, B, T/2, K*D] with deinterleaved scales [L, B, T]; the tile loader
//   unpacks them (flash_decode.cuh), the rest is the int8 mode.
//
// What bounds it on the H100: bytes. Each (row, KV head) reads its live K/V
// prefix once (int8: 128 B per token per head pair, bf16: 256 B) and does
// ~4 flops per byte read, far below the card's ~295 flop/byte ridge; int4
// halves the value bytes again (64 B per token per head pair).
// The design therefore reads only the live prefix [pad, lens) — never the
// whole preallocated cache — and reads it exactly once: one block per
// (batch row, KV head) stages a 64-token K/V tile in shared memory, and all
// G query heads of that KV head (GQA) score against the same tile. G is a
// runtime value (Air 7, Nano 4, the test config 2).
//
// This first version is simple: with B = 8 and K = 2 it runs only 16
// blocks, far too few to pull the card's bandwidth. Splitting the time axis
// across blocks (split-K flash-decode) is the next step, in a later change.
// The tile loop lives in flash_decode.cuh, shared with staged_attention.cu.
#include "flash_decode.cuh"

namespace {

using flash_decode::THREADS;

// T counts tokens; an int4 cache row holds T/2 byte rows.
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
    int B, int K, int G, int D, int T, int layer) {
  extern __shared__ float smem[];
  const flash_decode::Smem sm = flash_decode::carve(smem, G, D);
  const int b = blockIdx.x / K, h = blockIdx.x % K;
  const int KD = K * D;
  const size_t srow0 = ((size_t)layer * B + b) * T;         // scale row of slot 0
  const size_t row0 = INT4 ? srow0 / 2 : srow0;              // value row of slot 0
  flash_decode::begin(sm, q + ((size_t)b * K + h) * G * D, G, D);
  flash_decode::attend<CT, INT4>(
      sm, all_k + row0 * KD + (size_t)h * D, all_v + row0 * KD + (size_t)h * D,
      k_scale ? k_scale + srow0 : nullptr, v_scale ? v_scale + srow0 : nullptr, KD, pad[b],
      min(lens[b], T), G, D, T / 2);
  flash_decode::finish(sm, out + ((size_t)b * K + h) * G * D, G, D);
}

template <typename QT, typename CT, bool INT4 = false>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* lens, const void* pad, void* out,
                   int B, int K, int G, int D, int T, int layer, cudaStream_t st) {
  const size_t smem = flash_decode::smem_bytes(G, D);
  auto kern = decode_attention_kernel<QT, CT, INT4>;
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

// q_dtype: DT_F32 or DT_BF16; c_dtype: the same float type, or DT_I8 / DT_I4
// (packed pairs, T even) with ks/vs non-null. T counts tokens. Returns
// cudaGetLastError() after the launch.
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
  if (T % 2 == 0 && q_dtype == DT_F32 && c_dtype == DT_I4)
    return launch<float, int8_t, true>(q, k, v, ks, vs, lens, pad, out, B, K, G, D, T, layer, st);
  if (T % 2 == 0 && q_dtype == DT_BF16 && c_dtype == DT_I4)
    return launch<__nv_bfloat16, int8_t, true>(q, k, v, ks, vs, lens, pad, out, B, K, G, D, T,
                                               layer, st);
  return (int)cudaErrorInvalidValue;
}
