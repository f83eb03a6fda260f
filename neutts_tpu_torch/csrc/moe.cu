// Grouped SwiGLU experts of an LFM2-MoE layer (ops/moe.py
// `grouped_swiglu`): for each (token, expert) pair p = t*k + j routed to
// expert e, y[p] = down_e(silu(gate_e(x[t])) * up_e(x[t])).
//
// A port-only kernel: the JAX package has no expert layer, so it replaces
// no TPU kernel. It exists because no kernel of the port multiplies rows by
// a weight chosen per row.
//
// Bound: at decode (256 slots x top 4 = 1,024 pairs over 32 experts, ~32
// rows each) it reads every touched expert's three [2048 x 1792] bf16
// matrices once, 22 MB an expert and 704 MB a layer, against 2.2 GFLOP:
// memory bound. At an admission (32,768 tokens, ~4,000 rows an expert) the
// same weights serve 64 row tiles each: bound by the tensor cores.
//
// Design:
// - The pairs come sorted by expert (`perm`, stable) with per-expert
//   offsets on the device, so the grid is static: grid.x covers
//   ceil(P / BM) + E row tiles (each expert adds at most one partial tile),
//   and each block finds its expert and rows by scanning the E + 1 offsets;
//   blocks past the last tile return. Nothing is read back to the host, and
//   the launch can be captured in a CUDA graph.
// - Two kernels. gate/up: a block takes BM sorted rows (gathered from x by
//   token, t = pair / k) and GU_BN columns of both gate and up, and writes
//   h = silu(g) * u rounded to bf16 in sorted order [P, F]. down: a block
//   takes BM rows of h and DN_BN columns of the expert's down matrix and
//   writes the f32 result to the pair's own row of y, so the combine over a
//   token's k pairs (in ops/moe.py) is deterministic.
// - bf16 tensor cores by `mma.sync.m16n8k16` (f32 accumulation), A
//   fragments by `ldmatrix`, B fragments by `ldmatrix.trans` from the
//   row-major [K, N] weight tile; a 3-stage `cp.async` ring of BK = 32
//   deep tiles, rows padded by 16 bytes (conflict-free ldmatrix). Each
//   weight tile row is 128 (gate/up) or 256 (down) contiguous bytes.
// - Every block covers a whole weight column block over K, so a touched
//   expert's weights are read once at decode whatever its row count
//   (<= BM); x (1 MB at decode) is read again per column block from L2.
#include "common.cuh"

namespace {

constexpr int BM = 64;         // sorted pair rows per block (ops/moe.py BLOCK_ROWS)
constexpr int BK = 32;         // K per pipeline stage (K_STEP)
constexpr int GU_BN = 64;      // gate and up columns per block (GATE_UP_COLS)
constexpr int DN_BN = 128;     // down columns per block (DOWN_COLS)
constexpr int STAGES = 3;
constexpr int THREADS = 128;   // 4 warps: 2 along rows x 2 along columns
constexpr int AS = BK + 8;     // padded A row (bf16 elements)
constexpr int GS = GU_BN + 8;  // padded gate/up weight row
constexpr int DS = DN_BN + 8;  // padded down weight row

typedef __nv_bfloat16 bf16;

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

// The block's row tile: expert, first sorted row, row count (0 past the
// last tile). Tiles are numbered expert by expert, BM rows each.
__device__ __forceinline__ void find_tile(const int* offsets, int E, int tile, int* s) {
  if (threadIdx.x == 0) {
    int acc = 0, e = -1, r0 = 0, n = 0;
    for (int i = 0; i < E; ++i) {
      const int a = offsets[i], b = offsets[i + 1];
      const int t = (b - a + BM - 1) / BM;
      if (tile < acc + t) {
        e = i;
        r0 = a + (tile - acc) * BM;
        n = min(BM, b - r0);
        break;
      }
      acc += t;
    }
    s[0] = e;
    s[1] = r0;
    s[2] = n;
  }
  __syncthreads();
}

// A fragments of the warp's two 16-row slices at k-step kk of a stage
__device__ __forceinline__ void load_a(uint32_t (&af)[2][4], const bf16* as, int wm, int kk,
                                       int lane) {
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    ldmatrix_x4(af[mt], as + (wm * 32 + mt * 16 + (mi & 1) * 8 + mr) * AS + kk * 16 + (mi >> 1) * 8);
}

// acc[mt][nt] += A (32 rows) x B (16 k, NT*8 columns from col0) of a stage
template <int NT, int RS>
__device__ __forceinline__ void mma_tile(float (&acc)[2][NT][4], const uint32_t (&af)[2][4],
                                         const bf16* bs, int col0, int kk, int lane) {
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    // matrices: (k [0,8), cols [0,8)), (k [8,16), same cols), (k, cols + 8), (k + 8, cols + 8)
    uint32_t b[4];
    ldmatrix_x4_trans(b, bs + (kk * 16 + (mi & 1) * 8 + mr) * RS + col0 + np * 16 + (mi >> 1) * 8);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      mma_bf16(acc[mt][2 * np], af[mt], b[0], b[1]);
      mma_bf16(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
moe_gate_up_kernel(const bf16* __restrict__ x, const int* __restrict__ perm,
                   const int* __restrict__ offsets, const bf16* __restrict__ wg,
                   const bf16* __restrict__ wu, bf16* __restrict__ h, int E, int D, int F,
                   int top_k) {
  __shared__ int tile[3];
  find_tile(offsets, E, blockIdx.x, tile);
  const int e = tile[0], r0 = tile[1], n = tile[2];
  if (e < 0) return;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [STAGES][BM][AS]
  bf16* Gs = As + STAGES * BM * AS;          // [STAGES][BK][GS]
  bf16* Us = Gs + STAGES * BK * GS;          // [STAGES][BK][GS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.y * GU_BN;
  const bf16* wge = wg + (size_t)e * D * F + n0;
  const bf16* wue = wu + (size_t)e * D * F + n0;

  // this thread's A chunks: 2 of the tile's BM rows x 4 chunks of 8
  const bf16* a_src[2];
  int a_dst[2], a_bytes[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS, r = c >> 2, ch = c & 3;
    const bool ok = r < n;
    const int tok = ok ? perm[r0 + r] / top_k : 0;
    a_src[i] = x + (size_t)tok * D + ch * 8;
    a_dst[i] = r * AS + ch * 8;
    a_bytes[i] = ok ? 16 : 0;
  }
  auto load_stage = [&](int kt, int s) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) cp_async16(As + s * BM * AS + a_dst[i], a_src[i] + k0, a_bytes[i]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // BK rows x 8 chunks of each weight
      const int c = tid + i * THREADS, r = c >> 3, ch = c & 7;
      const size_t off = (size_t)(k0 + r) * F + ch * 8;
      cp_async16(Gs + s * BK * GS + r * GS + ch * 8, wge + off, 16);
      cp_async16(Us + s * BK * GS + r * GS + ch * 8, wue + off, 16);
    }
  };

  float ag[2][4][4], au[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) ag[mt][nt][q] = au[mt][nt][q] = 0.f;

  const int nk = D / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free for the next load
    if (kt + STAGES - 1 < nk) load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const int s = kt % STAGES;
    const bf16* as = As + s * BM * AS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[2][4];
      load_a(af, as, wm, kk, lane);
      mma_tile<4, GS>(ag, af, Gs + s * BK * GS, wn * 32, kk, lane);
      mma_tile<4, GS>(au, af, Us + s * BK * GS, wn * 32, kk, lane);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 32 + mt * 16 + g + half * 8;
      if (r >= n) continue;
      bf16* out = h + (size_t)(r0 + r) * F + n0 + wn * 32 + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float gv = ag[mt][nt][half * 2 + q], uv = au[mt][nt][half * 2 + q];
          v[q] = gv / (1.f + expf(-gv)) * uv;
        }
        *reinterpret_cast<uint32_t*>(out + nt * 8) = pack_bf16(v[0], v[1]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
moe_down_kernel(const bf16* __restrict__ h, const int* __restrict__ perm,
                const int* __restrict__ offsets, const bf16* __restrict__ wd,
                float* __restrict__ y, int E, int D, int F) {
  __shared__ int tile[3];
  find_tile(offsets, E, blockIdx.x, tile);
  const int e = tile[0], r0 = tile[1], n = tile[2];
  if (e < 0) return;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [STAGES][BM][AS]
  bf16* Bs = As + STAGES * BM * AS;          // [STAGES][BK][DS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.y * DN_BN;
  const bf16* wde = wd + (size_t)e * F * D + n0;

  const bf16* a_src[2];
  int a_dst[2], a_bytes[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS, r = c >> 2, ch = c & 3;
    const bool ok = r < n;
    a_src[i] = h + (size_t)(r0 + (ok ? r : 0)) * F + ch * 8;
    a_dst[i] = r * AS + ch * 8;
    a_bytes[i] = ok ? 16 : 0;
  }
  auto load_stage = [&](int kt, int s) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) cp_async16(As + s * BM * AS + a_dst[i], a_src[i] + k0, a_bytes[i]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // BK rows x 16 chunks
      const int c = tid + i * THREADS, r = c >> 4, ch = c & 15;
      cp_async16(Bs + s * BK * DS + r * DS + ch * 8, wde + (size_t)(k0 + r) * D + ch * 8, 16);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  const int nk = F / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const int s = kt % STAGES;
    const bf16* as = As + s * BM * AS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[2][4];
      load_a(af, as, wm, kk, lane);
      mma_tile<8, DS>(acc, af, Bs + s * BK * DS, wn * 64, kk, lane);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 32 + mt * 16 + g + half * 8;
      if (r >= n) continue;
      float* out = y + (size_t)perm[r0 + r] * D + n0 + wn * 64 + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<float2*>(out + nt * 8) =
            make_float2(acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);
    }
  }
}

constexpr int GU_SMEM = STAGES * (BM * AS + 2 * BK * GS) * (int)sizeof(bf16);  // 43,008
constexpr int DN_SMEM = STAGES * (BM * AS + BK * DS) * (int)sizeof(bf16);      // 41,472

}  // namespace

// x [T, D] bf16; perm [P] int32 (pair ids in expert order); offsets [E + 1]
// int32; wg/wu [E, D, F], wd [E, F, D] bf16; h [P, F] bf16 scratch; y [P, D]
// f32 out; tiles: grid rows, ceil(P / BM) + E. D % 128 == 0, F % 64 == 0.
extern "C" int neutts_moe_experts(const void* x, const void* perm, const void* offsets,
                                  const void* wg, const void* wu, const void* wd, void* h,
                                  void* y, int P, int E, int D, int F, int top_k, int tiles,
                                  cudaStream_t stream) {
  if (P <= 0) return 0;
  const int* pm = static_cast<const int*>(perm);
  const int* of = static_cast<const int*>(offsets);
  moe_gate_up_kernel<<<dim3(tiles, F / GU_BN), THREADS, GU_SMEM, stream>>>(
      static_cast<const bf16*>(x), pm, of, static_cast<const bf16*>(wg),
      static_cast<const bf16*>(wu), static_cast<bf16*>(h), E, D, F, top_k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_down_kernel<<<dim3(tiles, D / DN_BN), THREADS, DN_SMEM, stream>>>(
      static_cast<const bf16*>(h), pm, of, static_cast<const bf16*>(wd), static_cast<float*>(y),
      E, D, F);
  return (int)cudaGetLastError();
}
