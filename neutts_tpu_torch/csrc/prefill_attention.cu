// Causal, left-pad-masked GQA self-attention over a fresh prompt window.
//
// Replaces the TPU kernel neutts_tpu/ops/attention.py `_prefill_kernel` /
// `prefill_attention`.
//
// For batch row b with left pad p = pads[b], query position i attends keys
// j with p <= j <= i; f32 scores and softmax with the finite -1e30 mask;
// rows i < p (pad rows) are written as zeros. q [B, S, H, D], k/v
// [B, S, K, D], H = K * G. S need not be a multiple of any tile.
//
// bf16 mode: tensor cores, FlashAttention-2 style.
// What bounds it on the H100: at the path's shapes (S = 512, D = 64, ragged
// pads) the causal work is ~140 flops per byte of q/k/v/out, under the
// bf16 tensor-core ridge (~295 flop/byte), so the card's floor is memory
// traffic; a kernel that multiplies on the CUDA cores (PR 1's, 5 TFLOP/s)
// is bound by its arithmetic instead. So every product runs on the tensor
// cores with `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32` (f32
// accumulation). `mma.sync` was chosen over `wgmma`: the block's unit of
// work is 16 query rows of one head per warp (the G = 7 heads of a KV head
// make 7 warps), which fits m16 tiles exactly, while `wgmma` needs 64-row
// warpgroup tiles that a 7-head GQA group and ragged causal rows fill
// badly; and `mma.sync` keeps P in registers as the A operand of the PV
// product without a trip through shared memory.
// - One block per (16-position query tile, KV head, batch row) with one
//   warp per query head of that KV head (G <= 8; larger groups are split
//   over blocks). Each 64-key K/V tile staged in shared memory serves all
//   G heads: the TPU kernel's one [G*QB, S] dot, as GQA reuse. A group of
//   fewer heads gives each head more 16-row slices (up to 8 warps a block).
// - Q fragments stay in registers for the whole key loop; K fragments come
//   from shared memory by `ldmatrix`, V fragments by `ldmatrix.trans`.
// - K/V tiles are double-buffered: `cp.async` (16 bytes a thread) fetches
//   tile i+1 while tile i is multiplied. Rows are padded to D + 8 elements
//   (16 bytes), so the eight 16-byte rows an `ldmatrix` reads fall in eight
//   different bank groups.
// - Online softmax in registers: row max and sum over the quad of threads
//   that holds a row (two shuffles). P is rounded to bf16 as the A operand
//   of the PV product, as the JAX kernel rounds p.astype(v.dtype), but left
//   unnormalised; the output is divided by the f32 row sum at the end.
// - Key tiles wholly below pads[b] or past the query tile's diagonal are
//   never loaded; the mask is applied only on tiles that cross the pad or
//   the diagonal. A query tile made only of pad rows writes zeros and
//   returns. Blocks of the longest query tiles (the last positions) are
//   launched first, since causal work grows with the tile index.
// - Ragged S: the key tile past S is zero-filled by `cp.async` (source
//   size 0) and masked by the causal rule; query rows past S load zeros
//   and store nothing.
//
// f32 mode (small test configurations only; no Air path runs it): f32
// arithmetic on the CUDA cores, one block per (query tile of 16 positions,
// 8 for G > 8; KV head; row) holding all G heads' rows, with a key-tiled
// f32 online softmax; it normalises at the end.
#include "common.cuh"

namespace {

constexpr int BK = 64;  // keys per tile (both modes)

// --- f32 mode: CUDA cores ------------------------------------------------------

constexpr int F32_THREADS = 256;  // 8 warps

__global__ void __launch_bounds__(F32_THREADS) prefill_attention_f32_kernel(
    const float* __restrict__ q,    // [B, S, H, D]
    const float* __restrict__ k,    // [B, S, K, D]
    const float* __restrict__ v,    // [B, S, K, D]
    const int* __restrict__ pads,   // [B]
    float* __restrict__ out,        // [B, S, H, D]
    int S, int K, int G, int D, int QB) {
  extern __shared__ float smem[];
  const int R = G * QB;  // query rows in this block: r = g * QB + i
  const int DP = D + 1;
  float* q_s = smem;             // [R][D], pre-scaled by 1/sqrt(D)
  float* k_s = q_s + R * D;      // [BK][DP]
  float* v_s = k_s + BK * DP;    // [BK][D]
  float* s_s = v_s + BK * D;     // [R][BK]
  float* acc_s = s_s + R * BK;   // [R][D]
  float* m_s = acc_s + R * D;    // [R]
  float* l_s = m_s + R;          // [R]
  float* a_s = l_s + R;          // [R]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = K * G;
  const int pad = pads[b];
  const int r0 = qt * QB;                    // first query position
  const int r_last = min(r0 + QB, S) - 1;   // last query position
  const float scale = 1.0f / sqrtf((float)D);

  if (r_last < pad) {  // every row of the tile is left pad
    for (int idx = tid; idx < R * D; idx += F32_THREADS) {
      const int r = idx / D, d = idx - r * D;
      const int g = r / QB, pos = r0 + (r - g * QB);
      if (pos < S) out[(((size_t)b * S + pos) * H + h * G + g) * D + d] = 0.f;
    }
    return;
  }

  for (int idx = tid; idx < R * D; idx += F32_THREADS) {
    const int r = idx / D, d = idx - r * D;
    const int g = r / QB, pos = r0 + (r - g * QB);
    q_s[idx] = pos < S ? q[(((size_t)b * S + pos) * H + h * G + g) * D + d] * scale : 0.f;
    acc_s[idx] = 0.f;
  }
  for (int r = tid; r < R; r += F32_THREADS) {
    m_s[r] = -1e30f;
    l_s[r] = 0.f;
  }
  __syncthreads();

  for (int k0 = (pad / BK) * BK; k0 <= r_last; k0 += BK) {
    for (int idx = tid; idx < BK * D; idx += F32_THREADS) {
      const int j = idx / D, d = idx - j * D, key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < S) {
        const size_t off = (((size_t)b * S + key) * K + h) * D + d;
        kv = k[off];
        vv = v[off];
      }
      k_s[j * DP + d] = kv;
      v_s[j * D + d] = vv;
    }
    __syncthreads();

    for (int idx = tid; idx < R * BK; idx += F32_THREADS) {
      const int r = idx / BK, j = idx - r * BK;
      const int pos = r0 + (r % QB), key = k0 + j;
      float s = -1e30f;
      if (key <= pos && key >= pad && pos < S) {
        const float* qr = q_s + r * D;
        const float* kr = k_s + j * DP;
        s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      }
      s_s[idx] = s;
    }
    __syncthreads();

    for (int r = warp; r < R; r += F32_THREADS / 32) {
      float* sr = s_s + r * BK;
      float mx = -1e30f;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, sr[j]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = expf(sr[j] - m_new);
        sr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < R * D; idx += F32_THREADS) {
      const int r = idx / D, d = idx - r * D;
      const float* pr = s_s + r * BK;
      float o = 0.f;
      for (int j = 0; j < BK; ++j) o = fmaf(pr[j], v_s[j * D + d], o);
      acc_s[idx] = acc_s[idx] * a_s[r] + o;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < R * D; idx += F32_THREADS) {
    const int r = idx / D, d = idx - r * D;
    const int g = r / QB, pos = r0 + (r - g * QB);
    if (pos >= S) continue;
    const float o = pos >= pad ? acc_s[idx] / fmaxf(l_s[r], 1e-30f) : 0.f;
    out[(((size_t)b * S + pos) * H + h * G + g) * D + d] = o;
  }
}

int f32_qb(int G) { return G <= 8 ? 16 : 8; }

size_t f32_smem_bytes(int G, int D) {
  const size_t R = (size_t)G * f32_qb(G);
  return sizeof(float) * (R * D + BK * (D + 1) + BK * D + R * BK + R * D + 3 * R);
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* pads, void* out,
                       int B, int S, int K, int G, int D, cudaStream_t st) {
  const int QB = f32_qb(G);
  const size_t smem = f32_smem_bytes(G, D);
  cudaError_t e = cudaFuncSetAttribute(
      prefill_attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + QB - 1) / QB, K, B);
  prefill_attention_f32_kernel<<<grid, F32_THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)pads, (float*)out, S, K, G,
      D, QB);
  return cudaGetLastError();
}

// --- bf16 mode: tensor cores -----------------------------------------------------

constexpr int MAX_WARPS = 8;  // heads x 16-row slices of one block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte global -> shared copy; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
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

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Block: KV head h of row b, query heads [gb * GB, gb * GB + GB) of it, and
// query positions [qt * QB, qt * QB + QB) with QB = 16 * QW. Warp w serves
// head gb * GB + w % GB at positions qt * QB + 16 * (w / GB) + [0, 16).
// Grid: (B * K * NGB, n_query_tiles), blockIdx.y counting down the tiles.
template <int D>
__global__ void __launch_bounds__(32 * MAX_WARPS) prefill_attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, S, H, D]
    const __nv_bfloat16* __restrict__ k,   // [B, S, K, D]
    const __nv_bfloat16* __restrict__ v,   // [B, S, K, D]
    const int* __restrict__ pads,          // [B]
    __nv_bfloat16* __restrict__ out,       // [B, S, H, D]
    int S, int K, int G, int GB, int QW) {
  constexpr int RS = D + 8;       // shared row stride in elements (16-byte pad)
  constexpr int CPR = D / 8;      // 16-byte chunks per key row
  constexpr int KSTEPS = D / 16;  // k-steps of the QK^T product
  constexpr int DT = D / 8;       // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][K|V][BK][RS]

  const int nthreads = blockDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tq = lane & 3;  // mma fragment row group / column pair
  const int NGB = (G + GB - 1) / GB;
  const int gb = blockIdx.x % NGB, h = (blockIdx.x / NGB) % K, b = blockIdx.x / (NGB * K);
  const int QB = 16 * QW;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest query tiles first
  const int H = K * G;
  const int pad = pads[b];
  const int r0 = qt * QB;
  const int r_last = min(r0 + QB, S) - 1;
  const int g = gb * GB + warp % GB;           // this warp's head in the group (valid if < G)
  const int hq = h * G + min(g, G - 1);        // ... and its index among the H query heads
  const int rw0 = r0 + 16 * (warp / GB);       // this warp's first query position
  const int p0 = rw0 + gid, p1 = p0 + 8;       // this thread's two rows
  const bool warp_live = g < G && rw0 < S && rw0 + 15 >= pad;
  const float sl2 = (1.0f / sqrtf((float)D)) * 1.4426950408889634f;  // 1/sqrt(D) * log2(e)

  const int kt0 = pad / BK, kt1 = r_last / BK;
  const int n_tiles = r_last < pad ? 0 : kt1 - kt0 + 1;

  auto load_tile = [&](int kt, int stage) {
    __nv_bfloat16* ks = kv_s + stage * 2 * BK * RS;
    __nv_bfloat16* vs = ks + BK * RS;
    const int k0 = kt * BK;
    for (int c = tid; c < BK * CPR; c += nthreads) {
      const int r = c / CPR, ch = c - r * CPR, key = k0 + r;
      const int ok = key < S ? 16 : 0;
      const size_t off = (((size_t)b * S + (key < S ? key : 0)) * K + h) * D + ch * 8;
      cp_async16(ks + r * RS + ch * 8, k + off, ok);
      cp_async16(vs + r * RS + ch * 8, v + off, ok);
    }
  };
  if (n_tiles > 0) {
    load_tile(kt0, 0);
    cp_async_commit();
  }

  // Q fragments (A operand, row-major 16 x 16 per k-step), kept for the loop
  uint32_t qa[KSTEPS][4];
  {
    const __nv_bfloat16* q0 = q + (((size_t)b * S + min(p0, S - 1)) * H + hq) * D;
    const __nv_bfloat16* q1 = q + (((size_t)b * S + min(p1, S - 1)) * H + hq) * D;
    const bool ok0 = warp_live && p0 < S, ok1 = warp_live && p1 < S;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int c = 16 * kk + 2 * tq;
      qa[kk][0] = ok0 ? ld_u32(q0 + c) : 0u;
      qa[kk][1] = ok1 ? ld_u32(q1 + c) : 0u;
      qa[kk][2] = ok0 ? ld_u32(q0 + c + 8) : 0u;
      qa[kk][3] = ok1 ? ld_u32(q1 + c + 8) : 0u;
    }
  }

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;  // log2-domain max, partial sums
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix index, row within it

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      load_tile(kt0 + i + 1, (i + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = (kt0 + i) * BK;
    if (warp_live && k0 <= rw0 + 15) {
      const __nv_bfloat16* ks = kv_s + (i & 1) * 2 * BK * RS;
      const __nv_bfloat16* vs = ks + BK * RS;

      // S = Q K^T over 64 keys: 8 column tiles of 8 keys
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          // matrices: (keys 16jp + [0,8), dims lo), (same keys, dims hi),
          //           (keys 16jp + [8,16), dims lo), (same keys, dims hi)
          uint32_t kb[4];
          ldmatrix_x4(kb, ks + (16 * jp + (mi >> 1) * 8 + mr) * RS + 16 * kk + (mi & 1) * 8);
          mma_bf16(s[2 * jp], qa[kk], kb[0], kb[1]);
          mma_bf16(s[2 * jp + 1], qa[kk], kb[2], kb[3]);
        }
      }

      // scale to the log2 domain; mask only tiles crossing the pad or the diagonal
      const bool need_mask = k0 < pad || k0 + BK - 1 > rw0;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * sl2;
          if (need_mask) {
            const int j = k0 + 8 * nt + 2 * tq + (e & 1);
            const int row = e < 2 ? p0 : p1;
            if (j < pad || j > row) x = -1e30f;
          }
          s[nt][e] = x;
        }
      }

      // online softmax: the four threads of a quad hold one row's 64 scores
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][0] *= a0;
        o[dt][1] *= a0;
        o[dt][2] *= a1;
        o[dt][3] *= a1;
      }
      // P (unnormalised, rounded to bf16) as the A operand: key k-step kk
      // takes column tiles 2kk (a0..a3) and 2kk + 1 (a4..a7)
      uint32_t pa[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float e0 = exp2f(s[nt][0] - m0), e1 = exp2f(s[nt][1] - m0);
        const float e2 = exp2f(s[nt][2] - m1), e3 = exp2f(s[nt][3] - m1);
        l0 += e0 + e1;
        l1 += e2 + e3;
        pa[nt >> 1][(nt & 1) * 2] = pack_bf16(e0, e1);
        pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(e2, e3);
      }

      // O += P V: V fragments by ldmatrix.trans from the [key][dim] tile
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          // matrices: (keys 16kk + [0,8), dims 16dp + [0,8)), (keys + 8, same
          //           dims), (keys, dims + 8), (keys + 8, dims + 8)
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vs + (16 * kk + (mi & 1) * 8 + mr) * RS + 16 * dp + (mi >> 1) * 8);
          mma_bf16(o[2 * dp], pa[kk], vb[0], vb[1]);
          mma_bf16(o[2 * dp + 1], pa[kk], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();
  }

  if (g >= G) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = p0 >= pad ? 1.f / fmaxf(l0, 1e-30f) : 0.f;  // pad rows: zeros
  const float inv1 = p1 >= pad ? 1.f / fmaxf(l1, 1e-30f) : 0.f;
  __nv_bfloat16* out0 = out + (((size_t)b * S + p0) * H + hq) * D + 2 * tq;
  __nv_bfloat16* out1 = out + (((size_t)b * S + p1) * H + hq) * D + 2 * tq;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    if (p0 < S)
      *reinterpret_cast<uint32_t*>(out0 + 8 * dt) = pack_bf16(o[dt][0] * inv0, o[dt][1] * inv0);
    if (p1 < S)
      *reinterpret_cast<uint32_t*>(out1 + 8 * dt) = pack_bf16(o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

// The bf16 tile shape: heads per block, 16-row slices per head, threads,
// dynamic shared memory.
struct Bf16Tile {
  int gb, qw, threads;
  size_t smem;
};

Bf16Tile bf16_tile(int G, int D) {
  Bf16Tile t;
  t.gb = G < MAX_WARPS ? G : MAX_WARPS;
  t.qw = MAX_WARPS / t.gb;
  if (t.qw > 4) t.qw = 4;
  t.threads = 32 * t.gb * t.qw;
  t.smem = (size_t)2 * 2 * BK * (D + 8) * sizeof(__nv_bfloat16);
  return t;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* pads, void* out,
                        int B, int S, int K, int G, cudaStream_t st) {
  const Bf16Tile t = bf16_tile(G, D);
  auto kern = prefill_attention_bf16_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)t.smem);
  if (e != cudaSuccess) return e;
  const int ngb = (G + t.gb - 1) / t.gb, qb = 16 * t.qw;
  dim3 grid(B * K * ngb, (S + qb - 1) / qb);
  kern<<<grid, t.threads, t.smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const int*)pads, (__nv_bfloat16*)out, S, K, G, t.gb, t.qw);
  return cudaGetLastError();
}

}  // namespace

// dtype: DT_F32 (CUDA cores) or DT_BF16 (tensor cores, D in {16, 32, 64,
// 128, 192}, k/v 16-byte aligned); q, k, v and out share it. D 192 is
// multi-head latent attention's query/key head (128 + 64 rotary) in a
// prefill, whose 128-wide values the caller zero-pads to 192.
extern "C" int neutts_prefill_attention(const void* q, const void* k, const void* v,
                                        const void* pads, void* out, int B, int S, int K,
                                        int G, int D, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32) return launch_f32(q, k, v, pads, out, B, S, K, G, D, st);
  if (dtype == DT_BF16) {
    switch (D) {
      case 16: return launch_bf16<16>(q, k, v, pads, out, B, S, K, G, st);
      case 32: return launch_bf16<32>(q, k, v, pads, out, B, S, K, G, st);
      case 64: return launch_bf16<64>(q, k, v, pads, out, B, S, K, G, st);
      case 128: return launch_bf16<128>(q, k, v, pads, out, B, S, K, G, st);
      case 192: return launch_bf16<192>(q, k, v, pads, out, B, S, K, G, st);
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The tile shape a launch of the given mode takes: query positions per
// block, query heads per block, threads per block and dynamic shared bytes.
extern "C" int neutts_prefill_tile(int G, int D, int dtype, int* shape) {
  if (dtype == DT_F32) {
    shape[0] = f32_qb(G);
    shape[1] = G;
    shape[2] = F32_THREADS;
    shape[3] = (int)f32_smem_bytes(G, D);
    return 0;
  }
  if (dtype == DT_BF16) {
    const Bf16Tile t = bf16_tile(G, D);
    shape[0] = 16 * t.qw;
    shape[1] = t.gb;
    shape[2] = t.threads;
    shape[3] = (int)t.smem;
    return 0;
  }
  return (int)cudaErrorInvalidValue;
}
