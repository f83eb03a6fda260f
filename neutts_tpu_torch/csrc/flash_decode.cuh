// Flash-decode building blocks of staged_attention.cu (the settled cache
// range, then the staging columns of the current serving segment);
// decode_attention.cu takes only the int4 unpack from here.
//
// One block per (batch row, KV head): the G query heads of that KV head
// (GQA) score against one 64-token K/V tile staged in shared memory, and an
// online f32 softmax carries across tiles and across ranges. For int8
// values with per-token f32 scales, the K scale is folded into the scores
// and the V scale into the probabilities (G multiplies per token, not D).
// Masked scores use the finite -1e30, as the JAX code does.
//
// int4 values (the INT4 loader): byte row i of a [T/2, K*D] cache holds
// tokens 2i and 2i+1 arithmetic-coded as lo + 16*hi. A 64-token tile is 32
// byte rows; each byte is read once and unpacked exactly in integer
// arithmetic (hi = (b + 8) >> 4 on a widened signed int, lo = b - 16*hi),
// both nibbles going to their own token rows of the tile. Token t's scale
// sits at the deinterleaved column t/2 + (t&1)*T/2. A tile of this loader
// starts at an even token, so a range [lo, hi) with an odd lo or hi masks
// the nibble outside it: that token's score is -1e30 and its V row 0. (The
// TPU kernel's hi-only bf16 combine exists because Mosaic lacks int8
// shifts; a direct unpack is simpler here and exact.)
#pragma once

#include "common.cuh"

namespace flash_decode {

constexpr int BT = 64;        // cache tokens per tile
constexpr int THREADS = 128;  // 4 warps

// Shared memory of one block, all f32.
struct Smem {
  float* q;    // [G][D], pre-scaled by 1/sqrt(D)
  float* k;    // [BT][D+1] padded K rows: conflict-free score reads
  float* v;    // [BT][D]
  float* s;    // [G][BT] scores, then probabilities
  float* acc;  // [G][D]
  float* m;    // [G] running max
  float* l;    // [G] running sum
  float* a;    // [G] this tile's rescale factor
  float* ks;   // [BT] int8 mode: per-token K scales
  float* vs;   // [BT] int8 mode: per-token V scales
};

inline size_t smem_bytes(int G, int D) {
  return sizeof(float) * ((size_t)2 * G * D + BT * (D + 1) + BT * D + G * BT + 3 * G + 2 * BT);
}

__device__ __forceinline__ Smem carve(float* smem, int G, int D) {
  Smem sm;
  sm.q = smem;
  sm.k = sm.q + G * D;
  sm.v = sm.k + BT * (D + 1);
  sm.s = sm.v + BT * D;
  sm.acc = sm.s + G * BT;
  sm.m = sm.acc + G * D;
  sm.l = sm.m + G;
  sm.a = sm.l + G;
  sm.ks = sm.a + G;
  sm.vs = sm.ks + BT;
  return sm;
}

// Load the block's G query rows (pre-scaled) and reset the softmax state.
// Ends with a barrier.
template <typename QT>
__device__ __forceinline__ void begin(const Smem& sm, const QT* __restrict__ qb, int G, int D) {
  const int tid = threadIdx.x;
  const float scale = 1.0f / sqrtf((float)D);
  for (int i = tid; i < G * D; i += THREADS) {
    sm.q[i] = to_f32(qb[i]) * scale;
    sm.acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    sm.m[g] = -1e30f;
    sm.l[g] = 0.f;
  }
  __syncthreads();
}

// Exact unpack of one arithmetic-coded int4 pair (the JAX unpack4).
__device__ __forceinline__ void unpack4(int8_t byte, float& lo, float& hi) {
  const int b = byte;            // widened, signed: >> is an arithmetic shift
  const int h = (b + 8) >> 4;    // floor((b + 8) / 16)
  lo = (float)(b - 16 * h);
  hi = (float)h;
}

// Attend tokens [lo, hi) of one K/V range. Float or int8 values (INT4
// false): token t's head vector starts at kb + t * stride (likewise vb) and
// its scale at ksb[t]. Packed int4 values (INT4 true): token t's byte row
// starts at kb + (t / 2) * stride and its scale at ksb[t/2 + (t&1)*t_half].
// ksb/vsb are null for float values. Every thread of the block calls it
// with the same bounds; each tile ends with a barrier.
template <typename CT, bool INT4 = false>
__device__ void attend(const Smem& sm, const CT* __restrict__ kb, const CT* __restrict__ vb,
                       const float* __restrict__ ksb, const float* __restrict__ vsb,
                       size_t stride, int lo, int hi, int G, int D, int t_half = 0) {
  if (lo >= hi) return;  // an empty range leaves the softmax state as it is
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int DP = D + 1;
  for (int t0 = INT4 ? (lo & ~1) : lo; t0 < hi; t0 += BT) {
    if constexpr (INT4) {
      // BT/2 byte rows; byte row r holds tile tokens 2r (lo) and 2r+1 (hi)
      for (int i = tid; i < (BT / 2) * D; i += THREADS) {
        const int r = i / D, d = i - r * D, t = t0 + 2 * r;
        float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
        if (t < hi) {
          const size_t o = (size_t)(t >> 1) * stride + d;
          unpack4(kb[o], k0, k1);
          unpack4(vb[o], v0, v1);
        }
        const bool in0 = t >= lo, in1 = t + 1 < hi;
        sm.k[2 * r * DP + d] = in0 ? k0 : 0.f;
        sm.k[(2 * r + 1) * DP + d] = in1 ? k1 : 0.f;
        sm.v[2 * r * D + d] = in0 ? v0 : 0.f;
        sm.v[(2 * r + 1) * D + d] = in1 ? v1 : 0.f;
      }
      for (int tt = tid; tt < BT; tt += THREADS) {
        const int t = t0 + tt;
        const bool in = t >= lo && t < hi;
        const int c = (t >> 1) + (t & 1) * t_half;
        sm.ks[tt] = in ? ksb[c] : 0.f;
        sm.vs[tt] = in ? vsb[c] : 0.f;
      }
    } else {
      for (int i = tid; i < BT * D; i += THREADS) {
        const int tt = i / D, d = i - tt * D, t = t0 + tt;
        float kv = 0.f, vv = 0.f;
        if (t < hi) {
          kv = to_f32(kb[(size_t)t * stride + d]);
          vv = to_f32(vb[(size_t)t * stride + d]);
        }
        sm.k[tt * DP + d] = kv;
        sm.v[tt * D + d] = vv;
      }
      if (ksb != nullptr) {
        for (int tt = tid; tt < BT; tt += THREADS) {
          const int t = t0 + tt;
          sm.ks[tt] = t < hi ? ksb[t] : 0.f;
          sm.vs[tt] = t < hi ? vsb[t] : 0.f;
        }
      }
    }
    __syncthreads();

    for (int i = tid; i < G * BT; i += THREADS) {
      const int g = i / BT, tt = i - g * BT;
      float s = -1e30f;
      if (t0 + tt >= lo && t0 + tt < hi) {
        const float* qr = sm.q + g * D;
        const float* kr = sm.k + tt * DP;
        s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
        if (ksb != nullptr) s *= sm.ks[tt];  // K scale folded into the score
      }
      sm.s[i] = s;
    }
    __syncthreads();

    // online softmax update, one warp per query head
    for (int g = warp; g < G; g += THREADS / 32) {
      float* sr = sm.s + g * BT;
      float mx = -1e30f;
      for (int tt = lane; tt < BT; tt += 32) mx = fmaxf(mx, sr[tt]);
      mx = warp_max(mx);
      const float m_old = sm.m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int tt = lane; tt < BT; tt += 32) {
        const float p = expf(sr[tt] - m_new);
        sr[tt] = vsb != nullptr ? p * sm.vs[tt] : p;  // V scale folded into p
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sm.a[g] = alpha;
        sm.l[g] = sm.l[g] * alpha + sum;
        sm.m[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, d = i - g * D;
      const float* pr = sm.s + g * BT;
      float o = 0.f;
      for (int tt = 0; tt < BT; ++tt) o = fmaf(pr[tt], sm.v[tt * D + d], o);
      sm.acc[i] = sm.acc[i] * sm.a[g] + o;
    }
    __syncthreads();
  }
}

// Normalise and store the block's [G, D] output.
template <typename QT>
__device__ __forceinline__ void finish(const Smem& sm, QT* __restrict__ ob, int G, int D) {
  for (int i = threadIdx.x; i < G * D; i += THREADS)
    ob[i] = from_f32<QT>(sm.acc[i] / fmaxf(sm.l[i / D], 1e-30f));
}

}  // namespace flash_decode
