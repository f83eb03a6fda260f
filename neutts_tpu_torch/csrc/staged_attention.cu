// Staged split-K flash-decode attention for the serving engine's int8 and
// int4 KV caches.
//
// Replaces the TPU kernel neutts_tpu/ops/attention.py `_staged_kernel` /
// `decode_attention_staged` (int8 and int4 modes).
//
// During an S-step serving segment each step's quantized K/V is written to
// a small staging buffer at the segment column `step`, shared by every row,
// and reconciled into the cache once at segment end (slot_copy.cu). So
// each query (b, h, g) attends two ranges inside one softmax:
//   the settled cache slots [pad[b], base[b]) of layer `layer`, int8 values
//   with per-token f32 scales [L, B, T] (int4: nibble pairs [L, B, T/2, K*D]
//   with deinterleaved scales [L, B, T]), and
//   the staging columns [0, step], int8 [L, B, S, K*D] with scales
//   [L, B, SEG_PAD] (columns [0, S) live). An int4 cache stages UNPACKED
//   int4 values there, so this range is the int8 mode's in both.
// Rows with base == 0 (empty or retired slots) attend the staging columns
// alone and stay finite.
//
// What bounds it on the H100: bytes, as for decode_attention.cu, and it
// runs the same split-K flash-decode (flash_decode.cuh). The TPU kernel's
// block-diagonal query layout, cross-program DMA pipeline and lane-padded
// scale views are TPU artefacts and are not carried over. Grid
// (B * K, NSPLIT + 1): blocks 0 .. NSPLIT-1 of a (row, KV head) take the
// chunks of its settled range [pad, min(base, T)) (empty chunks write the
// empty partial), and block NSPLIT, a split index of its own, takes the
// staging columns [0, step] (never empty: step + 1 >= 1 columns) through
// the int8 loader with the staging stride and scales. The NSPLIT + 1
// partials are merged in index order in the same launch.
#include "flash_decode.cuh"

namespace {

using namespace flash_decode;

// T counts tokens; an int4 cache row holds T/2 byte rows. ws:
// [B*K][NSPLIT+1][G][D] partial sums then [B*K][NSPLIT+1][2][G] (m, l).
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
    float* __restrict__ ws,
    int* __restrict__ counters,           // [B*K], 0 between launches
    int B, int K, int G, int D, int T, int S, int seg_pad, int layer, int step, int nsplit) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm = carve(smem, G, D);
  const int bh = blockIdx.x, part = blockIdx.y;
  const int b = bh / K, h = bh - b * K;
  const int KD = K * D;
  const size_t lb = (size_t)layer * B + b;

  State st;
  start_block(sm, st, q + (size_t)bh * G * D, G, D);
  if (part < nsplit) {  // a chunk of the settled cache [pad, base)
    int clo, chi;
    chunk_of<INT4>(pad[b], min(base[b], T), part, nsplit, clo, chi);
    const size_t crow0 = lb * T;                   // scale row of slot 0
    const size_t row0 = INT4 ? crow0 / 2 : crow0;  // value row of slot 0
    attend_chunk<int8_t, INT4>(sm, st, all_k + row0 * KD + (size_t)h * D,
                               all_v + row0 * KD + (size_t)h * D, k_scale + crow0,
                               v_scale + crow0, KD, G, D, clo, chi, T / 2);
  } else {  // the staging columns [0, step]
    const size_t srow0 = lb * S;
    attend_chunk<int8_t, false>(sm, st, stag_k + srow0 * KD + (size_t)h * D,
                                stag_v + srow0 * KD + (size_t)h * D, stag_ks + lb * seg_pad,
                                stag_vs + lb * seg_pad, KD, G, D, 0, min(step + 1, S), 0);
  }
  merge_partials(sm, st, ws, counters, out, bh, part, nsplit + 1, B * K, G, D);
}

template <typename QT, bool INT4>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                   const void* sk, const void* sv, const void* sks, const void* svs,
                   const void* base, const void* pad, void* out, void* ws, void* counters,
                   int B, int K, int G, int D, int T, int S, int seg_pad, int layer, int step,
                   int nsplit, cudaStream_t st) {
  const size_t smem = smem_bytes(G, D);
  auto kern = staged_attention_kernel<QT, INT4>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(B * K, nsplit + 1), THREADS, smem, st>>>(
      (const QT*)q, (const int8_t*)k, (const int8_t*)v, (const float*)ks, (const float*)vs,
      (const int8_t*)sk, (const int8_t*)sv, (const float*)sks, (const float*)svs,
      (const int*)base, (const int*)pad, (QT*)out, (float*)ws, (int*)counters, B, K, G, D, T, S,
      seg_pad, layer, step, nsplit);
  return cudaGetLastError();
}

}  // namespace

// q_dtype: DT_F32 or DT_BF16 (the output's type too); staging is int8 with
// f32 scales, the cache int8 with f32 scales or, with int4 != 0, packed int4
// pairs (T even) with deinterleaved f32 scales. T counts tokens. D % 16 == 0,
// D <= 128, G <= 16, cache and staging buffers 16-byte aligned;
// 1 <= nsplit <= 32, a workspace ws of B*K*(nsplit+1)*(G*D + 2*G) floats and
// B*K int counters that are 0. Returns cudaGetLastError() after the launch.
extern "C" int neutts_decode_attention_staged(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    const void* sk, const void* sv, const void* sks, const void* svs, const void* base,
    const void* pad, void* out, void* ws, void* counters, int B, int K, int G, int D, int T,
    int S, int seg_pad, int layer, int step, int nsplit, int q_dtype, int int4, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D % 16 || D > 128 || G < 1 || G > GMAX || nsplit < 1 || nsplit > MAX_SPLIT ||
      (int4 && T % 2) || ws == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
#define NEUTTS_LAUNCH(QT, I4)                                                                  \
  launch<QT, I4>(q, k, v, ks, vs, sk, sv, sks, svs, base, pad, out, ws, counters, B, K, G, D, \
                 T, S, seg_pad, layer, step, nsplit, st)
  if (q_dtype == DT_F32) return int4 ? NEUTTS_LAUNCH(float, true) : NEUTTS_LAUNCH(float, false);
  if (q_dtype == DT_BF16)
    return int4 ? NEUTTS_LAUNCH(__nv_bfloat16, true) : NEUTTS_LAUNCH(__nv_bfloat16, false);
#undef NEUTTS_LAUNCH
  return (int)cudaErrorInvalidValue;
}
