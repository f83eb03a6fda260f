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
// half the value bytes of int8 and the same scale bytes). Both move values
// with 16-byte vector loads and stores (the wrapper checks KD % 16 == 0 and
// 16-byte aligned buffers). The admission write's grid is (row, layer): a
// 64-row admission of 24 layers runs 1,536 blocks, each a 64 KB token
// range. A segment's reconcile is short (S 32 rows of 128 bytes a layer):
// its blocks take several layers of a row each and issue every load
// before a store (see reconcile_kernel). Neither reads `active`, `base` or
// `primary` on the host: a serving segment is queued without a
// synchronisation.
#include <algorithm>

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

// --- segment reconcile ---------------------------------------------------------
//
// Grid (B, ceil(L / lpb)): block (b, g) moves layers [g*lpb, +lpb) of
// cache row b. An inactive row's blocks read active[b] and exit; that read
// (with base[b]) is the only one before the block's loads. Warps 0-7 move
// the values: each thread issues all of its 16-byte loads (RC_UNROLL
// vectors of K and of V; int4: both staging rows of each packed pair)
// before its first store, and lpb is the layer count that fills that round
// (reconcile_lpb). Warp 8 moves the block's scales, RC_SCALES per lane and
// buffer loaded before they are stored. At the Air serving shape (L 24,
// S 32, KD 128) an active block moves 4 layers x 8 KB (int8; int4 8 layers
// of 4 KB of packed pairs) in one round of 8 loads a thread (int4: 16 of
// half the bytes), and an inactive row costs 6 (int4 3) blocks that read
// two words.
//
// Measured on an H100 (against the one block per (row, layer) of 256
// threads that it replaced, at the Air serving shape):
// no faster where it counts. The replaced kernel already moved the data
// near the card's rate; this one launches 4-8x fewer blocks, so with no
// row active it takes ~0.0025 ms against ~0.0038 (warm L2), but with half
// the rows active it is 4-5% faster after a 256 MB memset (L2 full of
// dirty lines: every line brought in or written first writes one back,
// about twice the call's own bytes), as fast in int8 and ~7% slower in
// int4 after a 256 MB read (clean L2), and 7-11% slower with warm L2. Of
// the variants measured, a grid of 2 blocks an SM striding over the
// (layer, active row) pairs a warp each was slower still.

constexpr int RC_UNROLL = 4;                      // value vectors per thread and buffer
constexpr int RC_VALUE_THREADS = THREADS;         // warps 0-7: values
constexpr int RC_THREADS = RC_VALUE_THREADS + 32; // warp 8: scales
constexpr int RC_SCALES = 4;                      // scales per lane and buffer in flight

// INT4: the staging holds unpacked values, packed here in pairs (2j, 2j+1)
// into byte row base/2 + j; T counts tokens (T/2 byte rows per cache row).
template <bool INT4>
__global__ void __launch_bounds__(RC_THREADS) reconcile_kernel(
    const int8_t* __restrict__ stag_k,  // [L, B, S, KD]
    const int8_t* __restrict__ stag_v,
    const float* __restrict__ stag_ks,  // [L, B, seg_pad]
    const float* __restrict__ stag_vs,
    const int* __restrict__ base,       // [B] (INT4: even in active rows)
    const bool* __restrict__ active,    // [B]
    int8_t* __restrict__ all_k,         // [L, B, T, KD]; INT4 [L, B, T/2, KD]
    int8_t* __restrict__ all_v,
    float* __restrict__ k_scale,        // [L, B, T]; INT4 deinterleaved
    float* __restrict__ v_scale,
    int L, int B, int T, int S, int KD, int seg_pad, int lpb) {
  const int b = blockIdx.x;
  const bool act = active[b];
  const int b0 = base[b];
  if (!act) return;
  if (INT4 && (b0 & 1)) __trap();
  const int l0 = blockIdx.y * lpb, nl = min(lpb, L - l0);
  const int tid = threadIdx.x;

  if (tid >= RC_VALUE_THREADS) {  // warp 8: the scales of tokens [0, S) of nl layers
    const int lane = tid - RC_VALUE_THREADS, n = nl * S;
    for (int i0 = lane; i0 < n; i0 += 32 * RC_SCALES) {
      float ks[RC_SCALES], vs[RC_SCALES];
#pragma unroll
      for (int u = 0; u < RC_SCALES; ++u) {
        const int i = i0 + 32 * u;
        if (i < n) {
          const size_t src = ((size_t)(l0 + i / S) * B + b) * seg_pad + i % S;
          ks[u] = stag_ks[src];
          vs[u] = stag_vs[src];
        }
      }
#pragma unroll
      for (int u = 0; u < RC_SCALES; ++u) {
        const int i = i0 + 32 * u;
        const int t = b0 + i % S;
        const int c = INT4 ? (t >> 1) + (t & 1) * (T >> 1) : t;
        if (i < n && c >= 0 && c < T) {
          const size_t dst = ((size_t)(l0 + i / S) * B + b) * T + c;
          k_scale[dst] = ks[u];
          v_scale[dst] = vs[u];
        }
      }
    }
    return;
  }

  // warps 0-7: value vectors; destination row r of a layer takes staging
  // row r (int8) or rows 2r, 2r+1 (int4)
  constexpr int P = INT4 ? 2 : 1;         // staging rows per destination row
  const int vpr = KD / 16;                // uint4 per row
  const int rows = S / P;                 // destination rows per layer
  const int R = T / P;                    // destination rows per cache row
  const int c0 = b0 / P;                  // the segment's first destination row
  const int per_layer = rows * vpr, n = nl * per_layer;
  const uint4* sk = reinterpret_cast<const uint4*>(stag_k);
  const uint4* sv = reinterpret_cast<const uint4*>(stag_v);
  uint4* dk = reinterpret_cast<uint4*>(all_k);
  uint4* dv = reinterpret_cast<uint4*>(all_v);
  for (int i0 = tid; i0 < n; i0 += RC_VALUE_THREADS * RC_UNROLL) {
    uint4 k[RC_UNROLL][P], v[RC_UNROLL][P];
#pragma unroll
    for (int u = 0; u < RC_UNROLL; ++u) {
      const int i = i0 + RC_VALUE_THREADS * u;
      if (i < n) {
        const int l = l0 + i / per_layer, e = i % per_layer, r = e / vpr;
        const size_t src = (((size_t)l * B + b) * S + P * r) * vpr + e % vpr;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          k[u][p] = sk[src + p * vpr];
          v[u][p] = sv[src + p * vpr];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < RC_UNROLL; ++u) {
      const int i = i0 + RC_VALUE_THREADS * u;
      const int l = l0 + i / per_layer, e = i % per_layer, c = c0 + e / vpr;
      if (i < n && c >= 0 && c < R) {
        const size_t dst = (((size_t)l * B + b) * R + c) * vpr + e % vpr;
        if constexpr (INT4) {
          dk[dst] = pack4(k[u][0], k[u][1]);
          dv[dst] = pack4(v[u][0], v[u][1]);
        } else {
          dk[dst] = k[u][0];
          dv[dst] = v[u][0];
        }
      }
    }
  }
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

// Layers per reconcile block: as many as give each value thread RC_UNROLL
// vectors of K and of V (S/2 packed rows a layer in int4).
int reconcile_lpb(int L, int S, int KD, bool int4) {
  const int per_layer = (int4 ? S / 2 : S) * (KD / 16);
  return std::max(1, std::min(L, RC_VALUE_THREADS * RC_UNROLL / per_layer));
}

template <bool INT4>
int reconcile(const void* sk, const void* sv, const void* sks, const void* svs,
              const void* base, const void* active, void* k, void* v, void* ks, void* vs, int L,
              int B, int T, int S, int KD, int seg_pad, cudaStream_t st) {
  if (L == 0 || B == 0 || S == 0) return (int)cudaSuccess;
  const int lpb = reconcile_lpb(L, S, KD, INT4);
  reconcile_kernel<INT4><<<dim3(B, (L + lpb - 1) / lpb), RC_THREADS, 0, st>>>(
      (const int8_t*)sk, (const int8_t*)sv, (const float*)sks, (const float*)svs,
      (const int*)base, (const bool*)active, (int8_t*)k, (int8_t*)v, (float*)ks, (float*)vs,
      L, B, T, S, KD, seg_pad, lpb);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaSuccess for an empty grid).
extern "C" int neutts_reconcile_segment(
    const void* sk, const void* sv, const void* sks, const void* svs, const void* base,
    const void* active, void* k, void* v, void* ks, void* vs, int L, int B, int T, int S,
    int KD, int seg_pad, void* stream) {
  return reconcile<false>(sk, sv, sks, svs, base, active, k, v, ks, vs, L, B, T, S, KD, seg_pad,
                          (cudaStream_t)stream);
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
  return reconcile<true>(sk, sv, sks, svs, base, active, k, v, ks, vs, L, B, T, S, KD, seg_pad,
                         (cudaStream_t)stream);
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

// The reconcile's launch for L layers, S staging steps and K*D = KD, int8
// or int4, for reports: layers per block, value threads and scale threads
// per block, value vectors per thread and buffer in flight.
extern "C" int neutts_reconcile_geometry(int L, int S, int KD, int int4, int* shape) {
  const int v[4] = {reconcile_lpb(L, S, KD, int4 != 0), RC_VALUE_THREADS,
                    RC_THREADS - RC_VALUE_THREADS, RC_UNROLL};
  for (int i = 0; i < 4; ++i) shape[i] = v[i];
  return 0;
}
