// Staged flash-decode attention for the serving engine's int8 and int4 KV
// caches.
//
// Replaces the TPU kernel neutts_tpu/ops/attention.py `_staged_kernel` /
// `decode_attention_staged` (int8 and int4 modes).
//
// During an S-step serving segment each step's quantized K/V is written to
// a small staging buffer at the segment column `step`, shared by every row,
// and reconciled into the cache once at segment end (slot_copy.cu). So
// each query (b, h, g) attends two ranges inside one online f32 softmax:
//   the settled cache slots [pad[b], base[b]) of layer `layer`, int8 values
//   with per-token f32 scales [L, B, T] (int4: nibble pairs [L, B, T/2, K*D]
//   with deinterleaved scales [L, B, T], through the int4 tile loader of
//   flash_decode.cuh), and
//   the staging columns [0, step], int8 [L, B, S, K*D] with scales
//   [L, B, SEG_PAD] (columns [0, S) live). An int4 cache stages UNPACKED
//   int4 values there, so this range is the int8 mode's in both.
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

// T counts tokens; an int4 cache row holds T/2 byte rows.
template <typename QT, bool INT4>
__global__ void __launch_bounds__(THREADS) staged_attention_kernel(
    const QT* __restrict__ q,             // [B, K, G, D]
    const int8_t* __restrict__ all_k,     // [L, B, T, K*D] (int4: [L, B, T/2, K*D])
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
  const size_t crow0 = lb * T;                       // scale row of slot 0
  const size_t row0 = INT4 ? crow0 / 2 : crow0;      // value row of slot 0
  flash_decode::attend<int8_t, INT4>(
      sm, all_k + row0 * KD + (size_t)h * D, all_v + row0 * KD + (size_t)h * D,
      k_scale + crow0, v_scale + crow0, KD, pad[b], min(base[b], T), G, D, T / 2);
  // staging columns [0, step]
  const size_t srow0 = lb * S;
  flash_decode::attend(sm, stag_k + srow0 * KD + (size_t)h * D,
                       stag_v + srow0 * KD + (size_t)h * D, stag_ks + lb * seg_pad,
                       stag_vs + lb * seg_pad, KD, 0, min(step + 1, S), G, D);
  flash_decode::finish(sm, out + ((size_t)b * K + h) * G * D, G, D);
}

template <typename QT, bool INT4>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                   const void* sk, const void* sv, const void* sks, const void* svs,
                   const void* base, const void* pad, void* out, int B, int K, int G, int D,
                   int T, int S, int seg_pad, int layer, int step, cudaStream_t st) {
  const size_t smem = flash_decode::smem_bytes(G, D);
  auto kern = staged_attention_kernel<QT, INT4>;
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

// q_dtype: DT_F32 or DT_BF16 (the output's type too); staging is int8 with
// f32 scales, the cache int8 with f32 scales or, with int4 != 0, packed int4
// pairs (T even) with deinterleaved f32 scales. T counts tokens. Returns
// cudaGetLastError() after the launch.
extern "C" int neutts_decode_attention_staged(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    const void* sk, const void* sv, const void* sks, const void* svs, const void* base,
    const void* pad, void* out, int B, int K, int G, int D, int T, int S, int seg_pad,
    int layer, int step, int q_dtype, int int4, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (int4 && T % 2) return (int)cudaErrorInvalidValue;
  if (q_dtype == DT_F32)
    return int4 ? launch<float, true>(q, k, v, ks, vs, sk, sv, sks, svs, base, pad, out, B, K, G,
                                      D, T, S, seg_pad, layer, step, st)
                : launch<float, false>(q, k, v, ks, vs, sk, sv, sks, svs, base, pad, out, B, K, G,
                                       D, T, S, seg_pad, layer, step, st);
  if (q_dtype == DT_BF16)
    return int4 ? launch<__nv_bfloat16, true>(q, k, v, ks, vs, sk, sv, sks, svs, base, pad, out,
                                               B, K, G, D, T, S, seg_pad, layer, step, st)
                : launch<__nv_bfloat16, false>(q, k, v, ks, vs, sk, sv, sks, svs, base, pad, out,
                                                B, K, G, D, T, S, seg_pad, layer, step, st);
  return (int)cudaErrorInvalidValue;
}
