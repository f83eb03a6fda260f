// Slot copies of the serving engine's int8 KV cache: the segment
// reconcile and the admission-group prefill write.
//
// Replace the TPU kernels neutts_tpu/ops/attention.py `_reconcile_kernel` /
// `reconcile_segment_kv` and `_scatter_prefill_kernel` /
// `_scatter_prefill_kv` (int8 mode; the int4 modes are still to be ported).
// On the TPU they exist because Mosaic cannot scatter, and there the
// per-token f32 scales go through a dense one-hot fold outside the kernel
// (Mosaic DMA cannot address single f32 lanes). Here each kernel copies the
// values and the scales of both buffers in one launch.
//
//   reconcile: for each row b with active[b], the staging columns [0, S)
//     of every layer (K and V values [L, B, S, KD], scales [L, B, seg_pad])
//     land in cache slots [base[b], base[b] + S) of row b.
//   scatter-prefill: for each admission row j with primary[j], prompt K/V
//     [L, G, Lp, KD] and scales [L, G, Lp] land in cache row slots[j],
//     slots [0, Lp). Duplicate slots (group padding) carry identical data
//     and only their first occurrence (primary) is written.
// Rows not named are left untouched, byte for byte. A column outside
// [0, T) is skipped, as the JAX one-hot fold drops it.
//
// What bounds them on the H100: bytes, nothing else (a copy). The grid is
// (row, layer), so a 64-row admission of 24 layers runs 1,536 blocks; each
// block moves its token range with 16-byte vector loads and stores (the
// wrapper checks KD % 16 == 0 and 16-byte aligned buffers).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// Copy tokens [0, n) of one (row, layer): values as uint4 (KD/16 per
// token), then scales. Token i goes to destination column c0 + i and is
// skipped unless 0 <= c0 + i < T.
__device__ __forceinline__ void copy_tokens(
    const int8_t* __restrict__ src_k, const int8_t* __restrict__ src_v,
    const float* __restrict__ src_ks, const float* __restrict__ src_vs,
    int8_t* __restrict__ dst_k, int8_t* __restrict__ dst_v,
    float* __restrict__ dst_ks, float* __restrict__ dst_vs,
    int n, int c0, int T, int KD) {
  const int vpt = KD / 16;  // uint4 per token
  const uint4* sk = reinterpret_cast<const uint4*>(src_k);
  const uint4* sv = reinterpret_cast<const uint4*>(src_v);
  uint4* dk = reinterpret_cast<uint4*>(dst_k);
  uint4* dv = reinterpret_cast<uint4*>(dst_v);
  for (int i = threadIdx.x; i < n * vpt; i += THREADS) {
    const int c = c0 + i / vpt;
    if (c < 0 || c >= T) continue;
    const size_t o = (size_t)c * vpt + (i % vpt);
    dk[o] = sk[i];
    dv[o] = sv[i];
  }
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int c = c0 + i;
    if (c < 0 || c >= T) continue;
    dst_ks[c] = src_ks[i];
    dst_vs[c] = src_vs[i];
  }
}

__global__ void __launch_bounds__(THREADS) reconcile_kernel(
    const int8_t* __restrict__ stag_k,  // [L, B, S, KD]
    const int8_t* __restrict__ stag_v,
    const float* __restrict__ stag_ks,  // [L, B, seg_pad]
    const float* __restrict__ stag_vs,
    const int* __restrict__ base,       // [B]
    const bool* __restrict__ active,    // [B]
    int8_t* __restrict__ all_k,         // [L, B, T, KD]
    int8_t* __restrict__ all_v,
    float* __restrict__ k_scale,        // [L, B, T]
    float* __restrict__ v_scale,
    int B, int T, int S, int KD, int seg_pad) {
  const int b = blockIdx.x, l = blockIdx.y;
  if (!active[b]) return;
  const size_t lb = (size_t)l * B + b;
  copy_tokens(stag_k + lb * S * KD, stag_v + lb * S * KD, stag_ks + lb * seg_pad,
              stag_vs + lb * seg_pad, all_k + lb * T * KD, all_v + lb * T * KD,
              k_scale + lb * T, v_scale + lb * T, S, base[b], T, KD);
}

__global__ void __launch_bounds__(THREADS) scatter_prefill_kernel(
    const int8_t* __restrict__ new_k,   // [L, G, Lp, KD]
    const int8_t* __restrict__ new_v,
    const float* __restrict__ new_ks,   // [L, G, Lp]
    const float* __restrict__ new_vs,
    const int* __restrict__ slots,      // [G] destination cache rows
    const bool* __restrict__ primary,   // [G] first occurrence of each slot
    int8_t* __restrict__ all_k,         // [L, B, T, KD]
    int8_t* __restrict__ all_v,
    float* __restrict__ k_scale,        // [L, B, T]
    float* __restrict__ v_scale,
    int G, int B, int T, int Lp, int KD) {
  const int j = blockIdx.x, l = blockIdx.y;
  const int slot = slots[j];
  if (!primary[j] || slot < 0 || slot >= B) return;
  const size_t src = (size_t)l * G + j;
  const size_t dst = (size_t)l * B + slot;
  copy_tokens(new_k + src * Lp * KD, new_v + src * Lp * KD, new_ks + src * Lp,
              new_vs + src * Lp, all_k + dst * T * KD, all_v + dst * T * KD, k_scale + dst * T,
              v_scale + dst * T, Lp, 0, T, KD);
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaSuccess for an empty grid).
extern "C" int neutts_reconcile_segment(
    const void* sk, const void* sv, const void* sks, const void* svs, const void* base,
    const void* active, void* k, void* v, void* ks, void* vs, int L, int B, int T, int S,
    int KD, int seg_pad, void* stream) {
  if (L == 0 || B == 0 || S == 0) return (int)cudaSuccess;
  reconcile_kernel<<<dim3(B, L), THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)sk, (const int8_t*)sv, (const float*)sks, (const float*)svs,
      (const int*)base, (const bool*)active, (int8_t*)k, (int8_t*)v, (float*)ks, (float*)vs,
      B, T, S, KD, seg_pad);
  return (int)cudaGetLastError();
}

extern "C" int neutts_scatter_prefill(
    const void* nk, const void* nv, const void* nks, const void* nvs, const void* slots,
    const void* primary, void* k, void* v, void* ks, void* vs, int L, int G, int B, int T,
    int Lp, int KD, void* stream) {
  if (L == 0 || G == 0 || Lp == 0) return (int)cudaSuccess;
  scatter_prefill_kernel<<<dim3(G, L), THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)nk, (const int8_t*)nv, (const float*)nks, (const float*)nvs,
      (const int*)slots, (const bool*)primary, (int8_t*)k, (int8_t*)v, (float*)ks, (float*)vs,
      G, B, T, Lp, KD);
  return (int)cudaGetLastError();
}
