// Staged flash-decode attention for the serving engine's int8 KV cache.
//
// Replaces the TPU kernel neutts_tpu/ops/attention.py `_staged_kernel` /
// `decode_attention_staged` (int8 mode; the int4 mode is still to be
// ported).
//
// During an S-step serving segment each step's quantized K/V is written to
// a small staging buffer at the segment column `step`, shared by every row,
// and reconciled into the cache once at segment end (slot_copy.cu). So
// each query (b, h, g) attends two ranges inside one online f32 softmax:
//   the settled cache slots [pad[b], base[b]) of layer `layer`, int8 values
//   with per-token f32 scales [L, B, T], and
//   the staging columns [0, step], int8 [L, B, S, K*D] with scales
//   [L, B, SEG_PAD] (columns [0, S) live).
// The scales are folded into scores and probabilities as in
// decode_attention.cu. Rows with base == 0 (empty or retired slots) attend
// the staging columns alone and stay finite.
//
// What bounds it on the H100: bytes, as for decode_attention.cu: each
// (row, KV head) reads its settled prefix and its staging columns once.
// The TPU kernel's block-diagonal query layout, cross-program DMA pipeline
// and lane-padded scale views are TPU artefacts and are not carried over:
// one block per (row, KV head) runs the shared tile loop of
// flash_decode.cuh over the cache range, then once more over the staging
// range. At the serving shape (B = 128, K = 2) that is 256 blocks.
#include "flash_decode.cuh"

namespace {

using flash_decode::THREADS;

template <typename QT>
__global__ void __launch_bounds__(THREADS) staged_attention_kernel(
    const QT* __restrict__ q,             // [B, K, G, D]
    const int8_t* __restrict__ all_k,     // [L, B, T, K*D]
    const int8_t* __restrict__ all_v,
    const float* __restrict__ k_scale,    // [L, B, T]
    const float* __restrict__ v_scale,
    const int8_t* __restrict__ stag_k,    // [L, B, S, K*D]
    const int8_t* __restrict__ stag_v,
    const float* __restrict__ stag_ks,    // [L, B, seg_pad]
    const float* __restrict__ stag_vs,
    const int* __restrict__ base,         // [B] settled length (exclusive)
    const int* __restrict__ pad,          // [B]
    QT* __restrict__ out,                 // [B, K, G, D]
    int B, int K, int G, int D, int T, int S, int seg_pad, int layer, int step) {
  extern __shared__ float smem[];
  const flash_decode::Smem sm = flash_decode::carve(smem, G, D);
  const int b = blockIdx.x / K, h = blockIdx.x % K;
  const int KD = K * D;
  const size_t lb = (size_t)layer * B + b;
  flash_decode::begin(sm, q + ((size_t)b * K + h) * G * D, G, D);
  // settled cache [pad, base)
  const size_t row0 = lb * T;
  flash_decode::attend(sm, all_k + row0 * KD + (size_t)h * D, all_v + row0 * KD + (size_t)h * D,
                       k_scale + row0, v_scale + row0, KD, pad[b], min(base[b], T), G, D);
  // staging columns [0, step]
  const size_t srow0 = lb * S;
  flash_decode::attend(sm, stag_k + srow0 * KD + (size_t)h * D,
                       stag_v + srow0 * KD + (size_t)h * D, stag_ks + lb * seg_pad,
                       stag_vs + lb * seg_pad, KD, 0, min(step + 1, S), G, D);
  flash_decode::finish(sm, out + ((size_t)b * K + h) * G * D, G, D);
}

template <typename QT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                   const void* sk, const void* sv, const void* sks, const void* svs,
                   const void* base, const void* pad, void* out, int B, int K, int G, int D,
                   int T, int S, int seg_pad, int layer, int step, cudaStream_t st) {
  const size_t smem = flash_decode::smem_bytes(G, D);
  auto kern = staged_attention_kernel<QT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<B * K, THREADS, smem, st>>>(
      (const QT*)q, (const int8_t*)k, (const int8_t*)v, (const float*)ks, (const float*)vs,
      (const int8_t*)sk, (const int8_t*)sv, (const float*)sks, (const float*)svs,
      (const int*)base, (const int*)pad, (QT*)out, B, K, G, D, T, S, seg_pad, layer, step);
  return cudaGetLastError();
}

}  // namespace

// q_dtype: DT_F32 or DT_BF16 (the output's type too); cache and staging are
// int8 with f32 scales. Returns cudaGetLastError() after the launch.
extern "C" int neutts_decode_attention_staged(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    const void* sk, const void* sv, const void* sks, const void* svs, const void* base,
    const void* pad, void* out, int B, int K, int G, int D, int T, int S, int seg_pad,
    int layer, int step, int q_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == DT_F32)
    return launch<float>(q, k, v, ks, vs, sk, sv, sks, svs, base, pad, out, B, K, G, D, T, S,
                         seg_pad, layer, step, st);
  if (q_dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, k, v, ks, vs, sk, sv, sks, svs, base, pad, out, B, K, G, D,
                                 T, S, seg_pad, layer, step, st);
  return (int)cudaErrorInvalidValue;
}
