// Staged split-K flash-decode of absorbed multi-head latent attention (MLA)
// over the serving engine's int8 latent cache (Moonlight / DeepSeek-V3
// block).
//
// A port-only kernel: the JAX package has no latent attention, so no TPU
// kernel stands behind it. Its plain version is
// neutts_tpu_torch/ops/attention.py `mla_decode_staged_plain`.
//
// A latent cache keeps one row of R = 576 values a token (the normed latent
// c of 512 values, then the rotary key of 64), int8 with one f32 scale a
// token over the row, shared by K and V and by all H = 16 heads. In the
// absorbed form each head's query is a row of the same width (the latent
// query W_UK q_nope, then the rotary query), so for row b and head h:
//   score(t) = scale * (q[b, h] . row(t)),  out[b, h] = sum_t p(t) row(t)[:DV]
// over the settled slots [pad[b], base[b]) of layer `layer` and the
// segment's staging columns [0, step], in one softmax, as kernel #2 does
// for GQA. DV = 512: the value is the latent c itself.
//
// What bounds it on the H100: bytes, if both products run on the tensor
// cores. Each latent row (576 bytes + a scale) is read once for 16 heads'
// scores over 576 values and their outputs over 512: 16 x (576 + 512) x 2
// = 34.8 kFLOP a row, ~60 FLOP a byte, under the bf16 tensor-core ridge
// (~295) but above the FP32 CUDA cores' (~20). So:
// - Both products are `mma.sync.m16n8k16` bf16 -> f32: the 16 heads are the
//   16 rows of the A tile, so one head group is one MMA row tile.
// - The int8 values are converted to bf16 exactly (|x| <= 127 needs 8
//   significant bits): each byte goes into an f32 as 2^23 + (x + 128) by a
//   byte permute, one subtraction makes x, and the bf16 is the f32's high
//   half. The per-token scale is folded into the score after the product
//   and into the probability before the PV product, as #2 folds K and V
//   scales.
// - A block owns one (row, chunk) and walks its chunk in 64-token tiles.
//   Each tile is read from global memory once (a contiguous 36 KB block of
//   16-byte loads), converted into one bf16 shared tile [64][576 + 8] that
//   serves the score product (all 576 dims) and the output product (the
//   first 512 dims of the same rows).
// - Score product: 8 warps as 2 key halves x 4 depth groups. Warp (kh, kg)
//   keeps the A fragments of its 9 of the 36 16-deep steps of q in
//   registers for the whole chunk and multiplies them by the B fragments
//   (ldmatrix) of its 32 keys; the 4 depth groups' partial scores meet in
//   shared memory and are summed, scaled (softmax scale x log2(e) x the
//   token's scale) and masked by 256 threads, 4 each.
// - Softmax and output product: every warp reads the 16 x 64 scores, keeps
//   the online softmax state of all 16 heads (the same in each warp), and
//   multiplies the bf16 probabilities (times the token's scale) by the V
//   fragments (ldmatrix.trans) of its 64 of the 512 output columns, keeping
//   16 x 64 f32 accumulators in registers.
// - Split-K as flash_decode.cuh: NSPLIT chunks of the settled range (from
//   `chunk_of`) and one block for the staging columns; each block writes its
//   unnormalised partial, m and l to a workspace, and the last block to
//   take a ticket merges the partials in index order (bit-equal from run to
//   run) and resets its counter.
// Nothing here reads a length on the host: a serving segment is queued and
// captured without a synchronisation.
#include "flash_decode.cuh"

namespace {

constexpr int H = 16;            // query heads: the MMA tile's 16 rows
constexpr int R = 576;           // values of a latent row (scores' depth)
constexpr int DV = 512;          // output width: the row's first DV values
constexpr int BT = 64;           // tokens a tile
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int RS = R + 8;        // shared tile row stride (bf16): 16-byte pad
constexpr int KSTEPS = R / 16;   // 36 depth steps of the score product
constexpr int KGROUPS = 4;       // depth groups of the score product
constexpr int KPER = KSTEPS / KGROUPS;  // 9 steps a warp
constexpr int SS = BT + 8;       // f32 score row stride
constexpr int CHUNKS = R / 16;   // 16-byte int8 chunks of a row
constexpr int DW = DV / WARPS;   // output columns a warp: 64
static_assert(KSTEPS % KGROUPS == 0 && DW == 64, "tile shape");

struct Smem {
  __nv_bfloat16* tile;  // [BT][RS]
  float* part;          // [KGROUPS][H][SS] partial scores
  float* s;             // [H][SS] scores, log2 domain, masked
  float* sc;            // [BT] per-token scales (0 outside the chunk)
  float* w;             // [MAX_PARTS][H] merge weights
  float* l;             // [H] merged sums
  int* flag;
};

inline size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * BT * RS +
         sizeof(float) * (KGROUPS * H * SS + H * SS + BT + flash_decode::MAX_PARTS * H + H + 4);
}

__device__ __forceinline__ Smem carve(unsigned char* raw) {
  Smem sm;
  sm.tile = reinterpret_cast<__nv_bfloat16*>(raw);
  sm.part = reinterpret_cast<float*>(sm.tile + BT * RS);
  sm.s = sm.part + KGROUPS * H * SS;
  sm.sc = sm.s + H * SS;
  sm.w = sm.sc + BT;
  sm.l = sm.w + flash_decode::MAX_PARTS * H;
  sm.flag = reinterpret_cast<int*>(sm.l + H);
  return sm;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four int8 values of a word -> two bf16 pairs, exactly: byte i becomes the
// f32 2^23 + (x_i + 128) (0x4B0000uu), minus 2^23 + 128 gives x_i, whose f32
// has zero low 16 bits, so its high half is the bf16.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.0f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.0f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.0f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// Stage tokens [t0, t0 + BT) of the chunk [clo, chi) as bf16 rows with
// their scales; tokens outside the chunk get zero values and scale 0.
// Token t's row starts at rows + t * R, its scale at scales[t].
__device__ __forceinline__ void load_tile(const Smem& sm, const int8_t* __restrict__ rows,
                                          const float* __restrict__ scales, int t0, int clo,
                                          int chi) {
  const int tid = threadIdx.x;
  constexpr int PER = (BT * CHUNKS + THREADS - 1) / THREADS;  // 9
  uint4 raw[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {  // every load in flight before the first store
    const int c = tid + i * THREADS, r = c / CHUNKS, t = t0 + r;
    raw[i] = make_uint4(0, 0, 0, 0);
    if (c < BT * CHUNKS && t >= clo && t < chi)
      raw[i] = flash_decode::ld16(rows + (size_t)t * R + (c - r * CHUNKS) * 16);
  }
  if (tid < BT) {
    const int t = t0 + tid;
    sm.sc[tid] = t >= clo && t < chi ? scales[t] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = tid + i * THREADS, r = c / CHUNKS;
    if (c < BT * CHUNKS) {
      uint4 a, b;
      i8x4_to_bf16(raw[i].x, a.x, a.y);
      i8x4_to_bf16(raw[i].y, a.z, a.w);
      i8x4_to_bf16(raw[i].z, b.x, b.y);
      i8x4_to_bf16(raw[i].w, b.z, b.w);
      uint4* dst = reinterpret_cast<uint4*>(sm.tile + r * RS + (c - r * CHUNKS) * 16);
      dst[0] = a;
      dst[1] = b;
    }
  }
}

// ws: [B][nparts][H][DV] partial sums, then [B][nparts][2][H] (m, l), m in
// the log2 domain; counters [B], 0 between launches.
__global__ void __launch_bounds__(THREADS, 2) mla_decode_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, H, R]
    const int8_t* __restrict__ lat,       // [L, B, T, R]
    const float* __restrict__ lat_s,      // [L, B, T]
    const int8_t* __restrict__ stag,      // [L, B, S, R]
    const float* __restrict__ stag_s,     // [L, B, seg_pad]
    const int* __restrict__ base,         // [B] settled length (exclusive)
    const int* __restrict__ pad,          // [B]
    __nv_bfloat16* __restrict__ out,      // [B, H, DV]
    float* __restrict__ ws, int* __restrict__ counters, int B, int T, int S, int seg_pad,
    int layer, int step, int nsplit, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int b = blockIdx.x, part = blockIdx.y, nparts = nsplit + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tq = lane & 3;       // mma fragment row group / column pair
  const int mi = lane >> 3, mr = lane & 7;        // ldmatrix matrix / row
  const int kh = warp / KGROUPS, kg = warp % KGROUPS;  // score phase: key half, depth group
  const size_t lb = (size_t)layer * B + b;

  // this block's tokens
  const int8_t* rows;
  const float* scales;
  int clo, chi;
  if (part < nsplit) {
    flash_decode::chunk_of<false>(pad[b], min(base[b], T), part, nsplit, clo, chi);
    rows = lat + lb * T * R;
    scales = lat_s + lb * T;
  } else {
    clo = 0;
    chi = min(step + 1, S);
    rows = stag + lb * S * R;
    scales = stag_s + lb * seg_pad;
  }

  // q's A fragments of this warp's depth steps kk = kg + KGROUPS * j
  uint32_t qa[KPER][4];
  {
    const __nv_bfloat16* q0 = q + ((size_t)b * H + gid) * R + 2 * tq;
    const __nv_bfloat16* q1 = q0 + 8 * R;
#pragma unroll
    for (int j = 0; j < KPER; ++j) {
      const int c = 16 * (kg + KGROUPS * j);
      qa[j][0] = *reinterpret_cast<const uint32_t*>(q0 + c);
      qa[j][1] = *reinterpret_cast<const uint32_t*>(q1 + c);
      qa[j][2] = *reinterpret_cast<const uint32_t*>(q0 + c + 8);
      qa[j][3] = *reinterpret_cast<const uint32_t*>(q1 + c + 8);
    }
  }

  float o[DW / 8][4];
#pragma unroll
  for (int nt = 0; nt < DW / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;  // rows gid, gid + 8 (log2 domain)

  for (int t0 = clo; t0 < chi; t0 += BT) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(sm, rows, scales, t0, clo, chi);
    __syncthreads();

    // partial scores of keys [32 kh, 32 kh + 32) over this warp's depth steps
    float s[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int j = 0; j < KPER; ++j) {
      const int kk = kg + KGROUPS * j;
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        // matrices: (keys 16jp + [0,8), dims lo), (same keys, dims hi),
        //           (keys 16jp + [8,16), dims lo), (same keys, dims hi)
        uint32_t kb[4];
        ldmatrix_x4(kb, sm.tile + (32 * kh + 16 * jp + (mi >> 1) * 8 + mr) * RS + 16 * kk +
                            (mi & 1) * 8);
        mma_bf16(s[2 * jp], qa[j], kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qa[j], kb[2], kb[3]);
      }
    }
    {
      float* pp = sm.part + kg * H * SS;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = 32 * kh + 8 * nt + 2 * tq;
        *reinterpret_cast<float2*>(pp + gid * SS + col) = make_float2(s[nt][0], s[nt][1]);
        *reinterpret_cast<float2*>(pp + (gid + 8) * SS + col) = make_float2(s[nt][2], s[nt][3]);
      }
    }
    __syncthreads();
    {  // sum the depth groups, scale to the log2 domain, mask: 4 scores a thread
      const int row = tid / (BT / 4), col = 4 * (tid % (BT / 4));
      float4 acc = *reinterpret_cast<const float4*>(sm.part + row * SS + col);
#pragma unroll
      for (int g = 1; g < KGROUPS; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(sm.part + (g * H + row) * SS + col);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      const float a[4] = {acc.x, acc.y, acc.z, acc.w};
      float r4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + col + i;
        r4[i] = t >= clo && t < chi ? a[i] * sm.sc[col + i] * scale_log2 : -1e30f;
      }
      *reinterpret_cast<float4*>(sm.s + row * SS + col) = make_float4(r4[0], r4[1], r4[2], r4[3]);
    }
    __syncthreads();

    // online softmax over the tile's 64 scores of rows gid and gid + 8: a
    // quad of threads holds a row; every warp keeps the same state
    float x0[4][4], x1[4][4];  // [k-step][a-fragment column]: keys 16kk + 2tq + {0, 1, 8, 9}
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = 16 * kk + 2 * tq;
      const float2 a0 = *reinterpret_cast<const float2*>(sm.s + gid * SS + c);
      const float2 a2 = *reinterpret_cast<const float2*>(sm.s + gid * SS + c + 8);
      const float2 a1 = *reinterpret_cast<const float2*>(sm.s + (gid + 8) * SS + c);
      const float2 a3 = *reinterpret_cast<const float2*>(sm.s + (gid + 8) * SS + c + 8);
      x0[kk][0] = a0.x; x0[kk][1] = a0.y; x0[kk][2] = a2.x; x0[kk][3] = a2.y;
      x1[kk][0] = a1.x; x1[kk][1] = a1.y; x1[kk][2] = a3.x; x1[kk][3] = a3.y;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mx0 = fmaxf(mx0, x0[kk][e]);
        mx1 = fmaxf(mx1, x1[kk][e]);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float al0 = exp2f(m0 - mx0), al1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int nt = 0; nt < DW / 8; ++nt) {
      o[nt][0] *= al0;
      o[nt][1] *= al0;
      o[nt][2] *= al1;
      o[nt][3] *= al1;
    }
    // P (unnormalised, times the token's scale, rounded to bf16) as the A
    // operand of key step kk
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = 16 * kk + 2 * tq;
      const float sc[4] = {sm.sc[c], sm.sc[c + 1], sm.sc[c + 8], sm.sc[c + 9]};
      float e0[4], e1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        e0[e] = exp2f(x0[kk][e] - m0);
        e1[e] = exp2f(x1[kk][e] - m1);
        l0 += e0[e];
        l1 += e1[e];
      }
      pa[kk][0] = pack_bf16(e0[0] * sc[0], e0[1] * sc[1]);
      pa[kk][1] = pack_bf16(e1[0] * sc[0], e1[1] * sc[1]);
      pa[kk][2] = pack_bf16(e0[2] * sc[2], e0[3] * sc[3]);
      pa[kk][3] = pack_bf16(e1[2] * sc[2], e1[3] * sc[3]);
    }

    // O += P V over this warp's 64 output columns
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DW / 16; ++dp) {
        // matrices: (keys 16kk + [0,8), dims 16dp + [0,8)), (keys + 8, same
        //           dims), (keys, dims + 8), (keys + 8, dims + 8)
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, sm.tile + (16 * kk + (mi & 1) * 8 + mr) * RS + DW * warp +
                                  16 * dp + (mi >> 1) * 8);
        mma_bf16(o[2 * dp], pa[kk], vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa[kk], vb[2], vb[3]);
      }
    }
  }

  // this block's partial: unnormalised sums, m and l of the 16 heads
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  constexpr int HD = H * DV;
  float* ws_acc = ws;                                 // [B][nparts][H][DV]
  float* ws_ml = ws + (size_t)B * nparts * HD;        // [B][nparts][2][H]
  float* my_acc = ws_acc + ((size_t)b * nparts + part) * HD;
  float* my_ml = ws_ml + ((size_t)b * nparts + part) * 2 * H;
#pragma unroll
  for (int nt = 0; nt < DW / 8; ++nt) {
    const int col = DW * warp + 8 * nt + 2 * tq;
    *reinterpret_cast<float2*>(my_acc + gid * DV + col) = make_float2(o[nt][0], o[nt][1]);
    *reinterpret_cast<float2*>(my_acc + (gid + 8) * DV + col) = make_float2(o[nt][2], o[nt][3]);
  }
  if (warp == 0 && tq == 0) {
    my_ml[gid] = m0;
    my_ml[gid + 8] = m1;
    my_ml[H + gid] = l0;
    my_ml[H + gid + 8] = l1;
  }
  __threadfence();  // the partial is visible before the ticket is taken
  __syncthreads();
  if (tid == 0) *sm.flag = atomicAdd(counters + b, 1) == nparts - 1;
  __syncthreads();
  if (!*sm.flag) return;
  __threadfence();

  // the last block: merge the partials in index order
  const float* all_acc = ws_acc + (size_t)b * nparts * HD;
  const float* all_ml = ws_ml + (size_t)b * nparts * 2 * H;
  if (tid < H) {
    float mx = -1e30f;
    for (int p = 0; p < nparts; ++p) mx = fmaxf(mx, __ldcg(all_ml + p * 2 * H + tid));
    float L = 0.f;
    for (int p = 0; p < nparts; ++p) {
      const float w = exp2f(__ldcg(all_ml + p * 2 * H + tid) - mx);
      sm.w[p * H + tid] = w;
      L += w * __ldcg(all_ml + p * 2 * H + H + tid);
    }
    sm.l[tid] = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  __nv_bfloat16* ob = out + (size_t)b * HD;
  for (int i = 2 * tid; i < HD; i += 2 * THREADS) {
    const int h = i / DV;
    float a0 = 0.f, a1 = 0.f;
    for (int p = 0; p < nparts; ++p) {
      const float2 x = __ldcg(reinterpret_cast<const float2*>(all_acc + (size_t)p * HD + i));
      a0 = fmaf(sm.w[p * H + h], x.x, a0);
      a1 = fmaf(sm.w[p * H + h], x.y, a1);
    }
    *reinterpret_cast<uint32_t*>(ob + i) = pack_bf16(a0 * sm.l[h], a1 * sm.l[h]);
  }
  if (tid == 0) counters[b] = 0;  // ready for the next launch on this stream
}

}  // namespace

// q bf16 [B, 16, 576], 4-byte aligned; lat int8 [L, B, T, 576] with f32
// scales [L, B, T]; stag int8 [L, B, S, 576] with f32 scales [L, B, seg_pad]
// (columns [0, S) live); value buffers 16-byte aligned; out bf16 [B, 16,
// 512]. 1 <= nsplit <= 32, a workspace ws of B*(nsplit+1)*(16*512 + 32)
// floats and B int counters that are 0. scale_log2 is the softmax scale
// times log2(e). Returns cudaGetLastError() after the launch.
extern "C" int neutts_mla_decode(const void* q, const void* lat, const void* lat_s,
                                 const void* stag, const void* stag_s, const void* base,
                                 const void* pad, void* out, void* ws, void* counters, int B,
                                 int T, int S, int seg_pad, int layer, int step, int nsplit,
                                 float scale_log2, void* stream) {
  if (nsplit < 1 || nsplit > flash_decode::MAX_SPLIT || S < 1 || S > seg_pad ||
      ws == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(mla_decode_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  mla_decode_kernel<<<dim3(B, nsplit + 1), THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)lat, (const float*)lat_s, (const int8_t*)stag,
      (const float*)stag_s, (const int*)base, (const int*)pad, (__nv_bfloat16*)out, (float*)ws,
      (int*)counters, B, T, S, seg_pad, layer, step, nsplit, scale_log2);
  return (int)cudaGetLastError();
}

// The launch's shape, for reports: threads a block, dynamic shared bytes.
extern "C" int neutts_mla_decode_shape(int* shape) {
  shape[0] = THREADS;
  shape[1] = (int)smem_bytes();
  return 0;
}
