// Split-K flash-decode over chunks of a KV cache: the one implementation
// behind decode_attention.cu (kernel #1, one layer of the stacked cache) and
// staged_attention.cu (kernel #2, the settled cache plus a serving
// segment's staging columns).
//
// A block owns one (batch row b, KV head h) and one chunk of tokens; its G
// query heads (GQA) score against the chunk's 64-token tiles with an online
// f32 softmax. For int8 and int4 values with per-token f32 scales, the K
// scale is folded into the scores and the V scale into the probabilities
// (G multiplies per token instead of D). Masked scores use the finite
// -1e30, as the JAX code does.
//
// What bounds it on the H100: bytes. Each (row, KV head) reads its live K/V
// once (bf16: 256 B per token per head pair, int8: 128 B + scales, int4:
// 64 B + scales) and does ~4 flops per byte, far below the card's ~295
// flop/byte ridge. There are only B * K (row, KV head) pairs, so the card's
// bandwidth is reached only if the time axis is split over many blocks:
// - The host picks NSPLIT from B * K alone (decode_splits in
//   ops/attention.py); it never reads the lengths, which would wait on the
//   device. Block `split` reads its row's range [lo, hi) itself and takes
//   chunk `split` of it (chunk_of): chunks of a multiple of 64 tokens from
//   lo, so the work spreads over the live prefix, not over the allocated T.
//   An int4 tile starts at an even token (each byte holds a token pair), so
//   int4 chunks count from lo rounded down to even; an odd lo or hi masks
//   the nibble outside the range, so every token is counted once. An empty
//   chunk writes the empty partial (acc = 0, m = -1e30, l = 0).
// - load_tile: loads of 16 bytes a thread, neighbouring threads on
//   neighbouring addresses (4 f32, 8 bf16, 16 int8, or 16 packed int4 bytes
//   = 32 values of two tokens), converted once to f32 into a shared tile.
// - Scores: warp w owns query heads w, w+4, w+8, w+12 and lane l tokens l
//   and l+32, so max and sum of a head's 64 scores are one warp reduction
//   and no barrier. Each K float4 read feeds 4 FMAs per head held; q rows
//   are broadcast float4 reads (one address per warp).
// - PV: thread (d4, tg) owns 4 output columns of all G heads in registers
//   (up to 64 accumulators) for the tokens of token group tg; per token one
//   V float4 and G/4 probability float4s feed 4 G FMAs. The token groups are
//   summed once per block, in a fixed order. Three barriers per tile.
// - merge_partials: the partials of one (row, KV head) are merged in the
//   same launch, with no second kernel and no memset. Each block writes its
//   unnormalised acc [G, D], m [G] and l [G] to an f32 workspace, fences,
//   and one thread takes a ticket from a per-(b, h) counter with atomicAdd.
//   The last block to arrive merges the partials in index order (so the
//   result is bit-equal from run to run), reading them with L1-bypassing
//   loads, writes `out`, and resets the counter to 0 for the next launch.
//   This assumes that launches on one stream run in order: the wrappers
//   keep one workspace per (device, stream, B, K, G, D, partials), which
//   kernels #1 and #2 share at equal keys. A lone partial is merged by its
//   own block (ticket 0).
//
// int4 values (load_tile with INT4): byte row i of a [T/2, K*D] cache holds
// tokens 2i and 2i+1 arithmetic-coded as lo + 16*hi, unpacked exactly in
// integer arithmetic (unpack4). Token t's scale sits at the deinterleaved
// column t/2 + (t&1)*T/2. (The TPU kernel's hi-only bf16 combine exists
// because Mosaic lacks int8 shifts; a direct unpack is simpler here and
// exact.)
#pragma once

#include "common.cuh"

namespace flash_decode {

constexpr int BT = 64;                    // cache tokens per tile
constexpr int THREADS = 128;              // 4 warps
constexpr int GMAX = 16;                  // query heads per KV head
constexpr int HPW = GMAX / 4;             // heads per warp in the score phase
constexpr int MAX_SPLIT = 32;             // chunks of one (row, KV head)'s range
constexpr int MAX_PARTS = MAX_SPLIT + 1;  // + kernel #2's staging chunk

// Shared memory of one block (f32 words); every region starts 16-byte aligned.
struct Smem {
  float* q;    // [G][D] pre-scaled by 1/sqrt(D)
  float* k;    // [BT][D+4]; after the last tile: the token-group sums [NTG][G][D]
  float* v;    // [BT][D+4]
  float* p;    // [BT][GP] probabilities (V scale folded), GP = G rounded up to 4
  float* ks;   // [BT] per-token K scales (int8/int4)
  float* vs;   // [BT]
  float* a;    // [GMAX] this tile's rescale factor per head
  float* m;    // [GMAX] block max per head
  float* l;    // [GMAX] block sum per head; in the merge, the merged sum
  float* w;    // [MAX_PARTS][GMAX] merge weights
  int* flag;   // last block to arrive
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline int kv_words(int G, int D) {
  const int tiles = 2 * BT * (D + 4), sums = (THREADS / (D / 4)) * G * D;
  return tiles > sums ? tiles : sums;
}

inline size_t smem_bytes(int G, int D) {
  return sizeof(float) * ((size_t)G * D + kv_words(G, D) + BT * round4(G) + 2 * BT +
                          3 * GMAX + MAX_PARTS * GMAX + 4);
}

__device__ __forceinline__ Smem carve(float* smem, int G, int D) {
  Smem sm;
  sm.q = smem;
  sm.k = sm.q + G * D;
  sm.v = sm.k + BT * (D + 4);
  sm.p = sm.k + kv_words(G, D);
  sm.ks = sm.p + BT * round4(G);
  sm.vs = sm.ks + BT;
  sm.a = sm.vs + BT;
  sm.m = sm.a + GMAX;
  sm.l = sm.m + GMAX;
  sm.w = sm.l + GMAX;
  sm.flag = reinterpret_cast<int*>(sm.w + MAX_PARTS * GMAX);
  return sm;
}

// Exact unpack of one arithmetic-coded int4 pair (the JAX unpack4).
__device__ __forceinline__ void unpack4(int8_t byte, float& lo, float& hi) {
  const int b = byte;            // widened, signed: >> is an arithmetic shift
  const int h = (b + 8) >> 4;    // floor((b + 8) / 16)
  lo = (float)(b - 16 * h);
  hi = (float)h;
}

// 16 bytes of cache values -> f32 (N = 16 / sizeof(CT) values)
template <typename CT> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void cvt(const uint4& r, float* o) {
    o[0] = __uint_as_float(r.x); o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z); o[3] = __uint_as_float(r.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void cvt(const uint4& r, float* o) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // exact: a bf16 is the high half of an f32
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ static void cvt(const uint4& r, float* o) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[4 * i + j] = (float)(int8_t)(w[i] >> (8 * j));
  }
};

__device__ __forceinline__ void store_f32(float* dst, const float* src, int n) {
  for (int i = 0; i < n; i += 4)
    *reinterpret_cast<float4*>(dst + i) = make_float4(src[i], src[i + 1], src[i + 2], src[i + 3]);
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Chunk `split` of `nsplit` of the range [lo, hi), as [clo, chi) (empty
// when clo >= chi).
template <bool INT4>
__device__ __forceinline__ void chunk_of(int lo, int hi, int split, int nsplit, int& clo,
                                         int& chi) {
  const int base = INT4 ? (lo & ~1) : lo;
  const int n = max(hi - base, 0);
  const int chunk = ((n + nsplit - 1) / nsplit + BT - 1) / BT * BT;
  const int cs = base + min(split * chunk, n);
  clo = max(cs, lo);
  chi = min(cs + chunk, base + n);
}

// Stage tokens [t0, t0 + BT) of the chunk [clo, chi) as f32 rows; tokens
// outside the chunk get zeros (and, with scales, zero scales). Token t's
// values start at kb + t * stride (INT4: its byte row at kb + (t/2) *
// stride), its scale at ksb[t] (INT4: ksb[t/2 + (t&1)*t_half]); ksb/vsb
// are null for float values.
template <typename CT, bool INT4>
__device__ __forceinline__ void load_tile(const Smem& sm, const CT* __restrict__ kb,
                                          const CT* __restrict__ vb,
                                          const float* __restrict__ ksb,
                                          const float* __restrict__ vsb, int stride, int D,
                                          int t0, int clo, int chi, int t_half) {
  const int tid = threadIdx.x, KS = D + 4;
  if constexpr (INT4) {
    // byte row r of the tile holds tokens t0 + 2r (low nibble) and t0 + 2r + 1
    const int cpr = D / 16;
    for (int c = tid; c < (BT / 2) * cpr; c += THREADS) {
      const int r = c / cpr, ch = c - r * cpr, t = t0 + 2 * r;
      const bool in0 = t >= clo && t < chi, in1 = t + 1 >= clo && t + 1 < chi;
      uint4 rk = make_uint4(0, 0, 0, 0), rv = rk;
      if (in0 || in1) {
        const size_t o = (size_t)(t >> 1) * stride + ch * 16;
        rk = ld16(kb + o);
        rv = ld16(vb + o);
      }
      const uint32_t wk[4] = {rk.x, rk.y, rk.z, rk.w}, wv[4] = {rv.x, rv.y, rv.z, rv.w};
      float k0[16], k1[16], v0[16], v1[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        unpack4((int8_t)(wk[i >> 2] >> (8 * (i & 3))), k0[i], k1[i]);
        unpack4((int8_t)(wv[i >> 2] >> (8 * (i & 3))), v0[i], v1[i]);
        if (!in0) k0[i] = v0[i] = 0.f;
        if (!in1) k1[i] = v1[i] = 0.f;
      }
      store_f32(sm.k + (2 * r) * KS + ch * 16, k0, 16);
      store_f32(sm.k + (2 * r + 1) * KS + ch * 16, k1, 16);
      store_f32(sm.v + (2 * r) * KS + ch * 16, v0, 16);
      store_f32(sm.v + (2 * r + 1) * KS + ch * 16, v1, 16);
    }
  } else {
    constexpr int N = Vec<CT>::N;
    const int cpr = D / N;
    for (int c = tid; c < BT * cpr; c += THREADS) {
      const int tt = c / cpr, ch = c - tt * cpr, t = t0 + tt;
      float kv[N], vv[N];
      if (t >= clo && t < chi) {
        const size_t o = (size_t)t * stride + ch * N;
        Vec<CT>::cvt(ld16(kb + o), kv);
        Vec<CT>::cvt(ld16(vb + o), vv);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) kv[i] = vv[i] = 0.f;
      }
      store_f32(sm.k + tt * KS + ch * N, kv, N);
      store_f32(sm.v + tt * KS + ch * N, vv, N);
    }
  }
  if (ksb != nullptr) {
    for (int tt = tid; tt < BT; tt += THREADS) {
      const int t = t0 + tt;
      const bool in = t >= clo && t < chi;
      const int c = INT4 ? (t >> 1) + (t & 1) * t_half : t;
      sm.ks[tt] = in ? ksb[c] : 0.f;
      sm.vs[tt] = in ? vsb[c] : 0.f;
    }
  }
}

// One block's softmax state in registers: m and l of the heads warp + 4i
// (score phase), acc of columns 4*d4 .. 4*d4+3 of every head (PV phase).
struct State {
  float m[HPW], l[HPW];
  float acc[GMAX][4];
};

// Load the block's G query rows (pre-scaled), clear the probability tile
// (padding heads stay 0) and reset the state. The first tile's barrier
// orders these writes before their reads.
template <typename QT>
__device__ __forceinline__ void start_block(const Smem& sm, State& st,
                                            const QT* __restrict__ qb, int G, int D) {
  const int tid = threadIdx.x;
  const float scale = 1.0f / sqrtf((float)D);
  for (int i = tid; i < G * D; i += THREADS) sm.q[i] = to_f32(qb[i]) * scale;
  for (int i = tid; i < BT * round4(G); i += THREADS) sm.p[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    st.m[i] = -1e30f;
    st.l[i] = 0.f;
  }
#pragma unroll
  for (int g = 0; g < GMAX; ++g) st.acc[g][0] = st.acc[g][1] = st.acc[g][2] = st.acc[g][3] = 0.f;
}

// Attend the chunk [clo, chi) (empty: the state stays as it is). Every
// thread of the block calls it with the same bounds.
template <typename CT, bool INT4>
__device__ __forceinline__ void attend_chunk(const Smem& sm, State& st,
                                             const CT* __restrict__ kb,
                                             const CT* __restrict__ vb,
                                             const float* __restrict__ ksb,
                                             const float* __restrict__ vsb, int stride, int G,
                                             int D, int clo, int chi, int t_half) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int KS = D + 4, GP = round4(G);
  const bool quant = ksb != nullptr;
  const int nd4 = D / 4, ntg = THREADS / nd4;
  const int d4 = tid % nd4, tg = tid / nd4;

  for (int t0 = INT4 ? (clo & ~1) : clo; t0 < chi; t0 += BT) {
    load_tile<CT, INT4>(sm, kb, vb, ksb, vsb, stride, D, t0, clo, chi, t_half);
    __syncthreads();

    // scores: heads warp + 4i, tokens lane and lane + 32
    float s[HPW][2];
#pragma unroll
    for (int i = 0; i < HPW; ++i) s[i][0] = s[i][1] = 0.f;
    const float* ka = sm.k + lane * KS;
    const float* kc = sm.k + (lane + 32) * KS;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(ka + d);
      const float4 y = *reinterpret_cast<const float4*>(kc + d);
#pragma unroll
      for (int i = 0; i < HPW; ++i) {
        if (warp + 4 * i < G) {
          const float4 qv = *reinterpret_cast<const float4*>(sm.q + (warp + 4 * i) * D + d);
          s[i][0] = fmaf(qv.x, x.x, fmaf(qv.y, x.y, fmaf(qv.z, x.z, fmaf(qv.w, x.w, s[i][0]))));
          s[i][1] = fmaf(qv.x, y.x, fmaf(qv.y, y.y, fmaf(qv.z, y.z, fmaf(qv.w, y.w, s[i][1]))));
        }
      }
    }
    const bool in_a = t0 + lane >= clo && t0 + lane < chi;
    const bool in_b = t0 + lane + 32 >= clo && t0 + lane + 32 < chi;
    const float ks_a = quant ? sm.ks[lane] : 1.f, ks_b = quant ? sm.ks[lane + 32] : 1.f;
    const float vs_a = quant ? sm.vs[lane] : 1.f, vs_b = quant ? sm.vs[lane + 32] : 1.f;
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const int g = warp + 4 * i;
      if (g < G) {
        const float xa = in_a ? s[i][0] * ks_a : -1e30f;  // K scale folded into the score
        const float xb = in_b ? s[i][1] * ks_b : -1e30f;
        const float m_new = fmaxf(st.m[i], warp_max(fmaxf(xa, xb)));
        const float pa = expf(xa - m_new), pb = expf(xb - m_new);
        const float alpha = expf(st.m[i] - m_new);
        st.l[i] = st.l[i] * alpha + warp_sum(pa + pb);
        st.m[i] = m_new;
        sm.p[lane * GP + g] = pa * vs_a;  // V scale folded into the probability
        sm.p[(lane + 32) * GP + g] = pb * vs_b;
        if (lane == 0) sm.a[g] = alpha;
      }
    }
    __syncthreads();

    // PV: columns 4*d4 .. 4*d4+3 of every head, tokens tg + ntg*j
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        const float a = sm.a[g];
        st.acc[g][0] *= a;
        st.acc[g][1] *= a;
        st.acc[g][2] *= a;
        st.acc[g][3] *= a;
      }
    }
    for (int t = tg; t < BT; t += ntg) {
      const float4 vv = *reinterpret_cast<const float4*>(sm.v + t * KS + 4 * d4);
#pragma unroll
      for (int g4 = 0; g4 < GMAX; g4 += 4) {
        if (g4 < GP) {
          const float4 pp = *reinterpret_cast<const float4*>(sm.p + t * GP + g4);
          const float pr[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st.acc[g4 + j][0] = fmaf(pr[j], vv.x, st.acc[g4 + j][0]);
            st.acc[g4 + j][1] = fmaf(pr[j], vv.y, st.acc[g4 + j][1]);
            st.acc[g4 + j][2] = fmaf(pr[j], vv.z, st.acc[g4 + j][2]);
            st.acc[g4 + j][3] = fmaf(pr[j], vv.w, st.acc[g4 + j][3]);
          }
        }
      }
    }
    __syncthreads();
  }
}

// Write this block's partial `part` of `nparts` for (row, KV head) `bh`
// and, in the last block to arrive, merge all of them into out [G, D].
// ws: [n_bh][nparts][G][D] partial sums, then [n_bh][nparts][2][G] (m, l);
// counters [n_bh], 0 between launches.
template <typename QT>
__device__ __forceinline__ void merge_partials(const Smem& sm, const State& st,
                                               float* __restrict__ ws, int* __restrict__ counters,
                                               QT* __restrict__ out, int bh, int part,
                                               int nparts, int n_bh, int G, int D) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nd4 = D / 4, ntg = THREADS / nd4;
  const int d4 = tid % nd4, tg = tid / nd4;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      if (warp + 4 * i < G) {
        sm.m[warp + 4 * i] = st.m[i];
        sm.l[warp + 4 * i] = st.l[i];
      }
    }
  }
  float* sums = sm.k;  // [NTG][G][D], over the K/V tiles
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G)
      *reinterpret_cast<float4*>(sums + ((size_t)tg * G + g) * D + 4 * d4) =
          make_float4(st.acc[g][0], st.acc[g][1], st.acc[g][2], st.acc[g][3]);
  }
  __syncthreads();
  const int GD = G * D;
  QT* ob = out + (size_t)bh * GD;
  float* ws_acc = ws;                                    // [n_bh][nparts][G][D]
  float* ws_ml = ws + (size_t)n_bh * nparts * GD;        // [n_bh][nparts][2][G]
  float* my_acc = ws_acc + ((size_t)bh * nparts + part) * GD;
  float* my_ml = ws_ml + ((size_t)bh * nparts + part) * 2 * G;
  for (int i = tid; i < GD; i += THREADS) {
    float o = 0.f;
    for (int j = 0; j < ntg; ++j) o += sums[j * GD + i];
    my_acc[i] = o;
  }
  for (int g = tid; g < G; g += THREADS) {
    my_ml[g] = sm.m[g];
    my_ml[G + g] = sm.l[g];
  }
  __threadfence();  // the partial is visible before the ticket is taken
  __syncthreads();
  if (tid == 0) *sm.flag = atomicAdd(counters + bh, 1) == nparts - 1;
  __syncthreads();
  if (!*sm.flag) return;
  __threadfence();

  // the last block: merge the partials in index order
  const float* all_acc = ws_acc + (size_t)bh * nparts * GD;
  const float* all_ml = ws_ml + (size_t)bh * nparts * 2 * G;
  for (int g = tid; g < G; g += THREADS) {
    float mx = -1e30f;
    for (int s = 0; s < nparts; ++s) mx = fmaxf(mx, __ldcg(all_ml + s * 2 * G + g));
    float L = 0.f;
    for (int s = 0; s < nparts; ++s) {
      const float w = expf(__ldcg(all_ml + s * 2 * G + g) - mx);
      sm.w[s * GMAX + g] = w;
      L += w * __ldcg(all_ml + s * 2 * G + G + g);
    }
    sm.l[g] = L;
  }
  __syncthreads();
  for (int i = tid; i < GD; i += THREADS) {
    const int g = i / D;
    float o = 0.f;
    for (int s = 0; s < nparts; ++s)
      o = fmaf(sm.w[s * GMAX + g], __ldcg(all_acc + (size_t)s * GD + i), o);
    ob[i] = from_f32<QT>(o / fmaxf(sm.l[g], 1e-30f));
  }
  if (tid == 0) counters[bh] = 0;  // ready for the next launch on this stream
}

}  // namespace flash_decode
