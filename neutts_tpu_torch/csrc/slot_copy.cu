// Slot copies of the serving engine's int8 and int4 KV caches: the segment
// reconcile and the admission-group prefill write.
//
// Replace the TPU kernels neutts_tpu/ops/attention.py `_reconcile_kernel` /
// `reconcile_segment_kv` (int8 mode, and the int4 mode of
// `reconcile_segment4`) and `_scatter_prefill_kernel` /
// `_scatter_prefill_kv` (int8 mode, and the int4 mode of
// `scatter_prefill4`).
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
// int4 modes: the cache holds nibble pairs [L, B, T/2, KD] (byte = lo +
// 16*hi, token 2i lo, 2i+1 hi) with token t's scale at the deinterleaved
// column t/2 + (t&1)*T/2 of [L, B, T].
//   reconcile4: the staging holds UNPACKED int4 values [L, B, S, KD]; the
//     kernel packs the pairs (2j, 2j+1) of an active row itself and stores
//     byte row base/2 + j (base and S even, so every byte holds a complete
//     pair); the S scales go to their deinterleaved columns. An odd base in
//     an active row would split a pair: the kernel traps (the JAX asserts),
//     which the next synchronisation reports.
//   scatter-prefill4: copies Lp/2 packed byte rows and writes the Lp
//     token-order prompt scales to their deinterleaved columns.
//
// What bounds them on the H100: bytes, nothing else (a copy; int4 moves
// half the value bytes of int8 and the same scale bytes). The grid is
// (row, layer), so a 64-row admission of 24 layers runs 1,536 blocks; each
// block moves its token range with 16-byte vector loads and stores (the
// wrapper checks KD % 16 == 0 and 16-byte aligned buffers).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// Copy value rows [0, n) of one (row, layer) as uint4 (KD/16 per row): row
// i goes to destination row c0 + i and is skipped unless 0 <= c0 + i < R.
__device__ __forceinline__ void copy_rows(
    const int8_t* __restrict__ src_k, const int8_t* __restrict__ src_v,
    int8_t* __restrict__ dst_k, int8_t* __restrict__ dst_v, int n, int c0, int R, int KD) {
  const int vpt = KD / 16;  // uint4 per row
  const uint4* sk = reinterpret_cast<const uint4*>(src_k);
  const uint4* sv = reinterpret_cast<const uint4*>(src_v);
  uint4* dk = reinterpret_cast<uint4*>(dst_k);
  uint4* dv = reinterpret_cast<uint4*>(dst_v);
  for (int i = threadIdx.x; i < n * vpt; i += THREADS) {
    const int c = c0 + i / vpt;
    if (c < 0 || c >= R) continue;
    const size_t o = (size_t)c * vpt + (i % vpt);
    dk[o] = sk[i];
    dv[o] = sv[i];
  }
}

// Copy the scales of tokens [0, n) of one (row, layer): token i is token
// t = t0 + i of the row, stored at column t (int8 layout) or at its
// deinterleaved column t/2 + (t&1)*T/2 (INT4), and skipped unless that
// column lies in [0, T).
template <bool INT4>
__device__ __forceinline__ void copy_scales(
    const float* __restrict__ src_ks, const float* __restrict__ src_vs,
    float* __restrict__ dst_ks, float* __restrict__ dst_vs, int n, int t0, int T) {
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int t = t0 + i;
    const int c = INT4 ? (t >> 1) + (t & 1) * (T >> 1) : t;
    if (c < 0 || c >= T) continue;
    dst_ks[c] = src_ks[i];
    dst_vs[c] = src_vs[i];
  }
}

// One int4 byte lo + 16*hi of each of 16 lanes: int8 arithmetic as in the
// JAX pack4 (inputs in [-7, 7] give [-119, 119]).
__device__ __forceinline__ uint4 pack4(uint4 lo, uint4 hi) {
  uint4 out;
  const int8_t* l = reinterpret_cast<const int8_t*>(&lo);
  const int8_t* h = reinterpret_cast<const int8_t*>(&hi);
  int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
  for (int j = 0; j < 16; ++j) o[j] = (int8_t)(l[j] + 16 * h[j]);
  return out;
}

// Pack staging rows (2j, 2j+1), j in [0, n), of one (row, layer) into byte
// row c0 + j, skipped unless 0 <= c0 + j < R.
__device__ __forceinline__ void pack_rows(
    const int8_t* __restrict__ src_k, const int8_t* __restrict__ src_v,
    int8_t* __restrict__ dst_k, int8_t* __restrict__ dst_v, int n, int c0, int R, int KD) {
  const int vpt = KD / 16;
  const uint4* sk = reinterpret_cast<const uint4*>(src_k);
  const uint4* sv = reinterpret_cast<const uint4*>(src_v);
  uint4* dk = reinterpret_cast<uint4*>(dst_k);
  uint4* dv = reinterpret_cast<uint4*>(dst_v);
  for (int i = threadIdx.x; i < n * vpt; i += THREADS) {
    const int j = i / vpt, w = i - j * vpt, c = c0 + j;
    if (c < 0 || c >= R) continue;
    const size_t o = (size_t)c * vpt + w, s0 = (size_t)2 * j * vpt + w;
    dk[o] = pack4(sk[s0], sk[s0 + vpt]);
    dv[o] = pack4(sv[s0], sv[s0 + vpt]);
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
  copy_rows(stag_k + lb * S * KD, stag_v + lb * S * KD, all_k + lb * T * KD, all_v + lb * T * KD,
            S, base[b], T, KD);
  copy_scales<false>(stag_ks + lb * seg_pad, stag_vs + lb * seg_pad, k_scale + lb * T,
                     v_scale + lb * T, S, base[b], T);
}

// T counts tokens: the packed cache rows hold T/2 byte rows.
__global__ void __launch_bounds__(THREADS) reconcile4_kernel(
    const int8_t* __restrict__ stag_k,  // [L, B, S, KD] unpacked int4 values
    const int8_t* __restrict__ stag_v,
    const float* __restrict__ stag_ks,  // [L, B, seg_pad]
    const float* __restrict__ stag_vs,
    const int* __restrict__ base,       // [B] even
    const bool* __restrict__ active,    // [B]
    int8_t* __restrict__ all_k,         // [L, B, T/2, KD] packed pairs
    int8_t* __restrict__ all_v,
    float* __restrict__ k_scale,        // [L, B, T] deinterleaved
    float* __restrict__ v_scale,
    int B, int T, int S, int KD, int seg_pad) {
  const int b = blockIdx.x, l = blockIdx.y;
  if (!active[b]) return;
  const int b0 = base[b];
  if (b0 & 1) __trap();
  const size_t lb = (size_t)l * B + b;
  pack_rows(stag_k + lb * S * KD, stag_v + lb * S * KD, all_k + lb * (T / 2) * KD,
            all_v + lb * (T / 2) * KD, S / 2, b0 >> 1, T / 2, KD);
  copy_scales<true>(stag_ks + lb * seg_pad, stag_vs + lb * seg_pad, k_scale + lb * T,
                    v_scale + lb * T, S, b0, T);
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
  copy_rows(new_k + src * Lp * KD, new_v + src * Lp * KD, all_k + dst * T * KD,
            all_v + dst * T * KD, Lp, 0, T, KD);
  copy_scales<false>(new_ks + src * Lp, new_vs + src * Lp, k_scale + dst * T, v_scale + dst * T,
                     Lp, 0, T);
}

// T and Lp count tokens: byte rows are T/2 per cache row, Lp/2 per prompt.
__global__ void __launch_bounds__(THREADS) scatter_prefill4_kernel(
    const int8_t* __restrict__ new_k,   // [L, G, Lp/2, KD] packed pairs
    const int8_t* __restrict__ new_v,
    const float* __restrict__ new_ks,   // [L, G, Lp] token order
    const float* __restrict__ new_vs,
    const int* __restrict__ slots,      // [G]
    const bool* __restrict__ primary,   // [G]
    int8_t* __restrict__ all_k,         // [L, B, T/2, KD]
    int8_t* __restrict__ all_v,
    float* __restrict__ k_scale,        // [L, B, T] deinterleaved
    float* __restrict__ v_scale,
    int G, int B, int T, int Lp, int KD) {
  const int j = blockIdx.x, l = blockIdx.y;
  const int slot = slots[j];
  if (!primary[j] || slot < 0 || slot >= B) return;
  const size_t src = (size_t)l * G + j;
  const size_t dst = (size_t)l * B + slot;
  copy_rows(new_k + src * (Lp / 2) * KD, new_v + src * (Lp / 2) * KD,
            all_k + dst * (T / 2) * KD, all_v + dst * (T / 2) * KD, Lp / 2, 0, T / 2, KD);
  copy_scales<true>(new_ks + src * Lp, new_vs + src * Lp, k_scale + dst * T, v_scale + dst * T,
                    Lp, 0, T);
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

// int4 modes: T and Lp count tokens (both even).
extern "C" int neutts_reconcile_segment4(
    const void* sk, const void* sv, const void* sks, const void* svs, const void* base,
    const void* active, void* k, void* v, void* ks, void* vs, int L, int B, int T, int S,
    int KD, int seg_pad, void* stream) {
  if (T % 2 || S % 2) return (int)cudaErrorInvalidValue;
  if (L == 0 || B == 0 || S == 0) return (int)cudaSuccess;
  reconcile4_kernel<<<dim3(B, L), THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)sk, (const int8_t*)sv, (const float*)sks, (const float*)svs,
      (const int*)base, (const bool*)active, (int8_t*)k, (int8_t*)v, (float*)ks, (float*)vs,
      B, T, S, KD, seg_pad);
  return (int)cudaGetLastError();
}

extern "C" int neutts_scatter_prefill4(
    const void* nk, const void* nv, const void* nks, const void* nvs, const void* slots,
    const void* primary, void* k, void* v, void* ks, void* vs, int L, int G, int B, int T,
    int Lp, int KD, void* stream) {
  if (T % 2 || Lp % 2 || Lp > T) return (int)cudaErrorInvalidValue;
  if (L == 0 || G == 0 || Lp == 0) return (int)cudaSuccess;
  scatter_prefill4_kernel<<<dim3(G, L), THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)nk, (const int8_t*)nv, (const float*)nks, (const float*)nvs,
      (const int*)slots, (const bool*)primary, (int8_t*)k, (int8_t*)v, (float*)ks, (float*)vs,
      G, B, T, Lp, KD);
  return (int)cudaGetLastError();
}
