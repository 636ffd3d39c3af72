// K6 on Hopper: the whole eval forward of DualEncoderEpsNetwork in one
// launch, edge encoder included, over the pairs of each graph's working
// graph.
//
// Replaces the TPU kernel _mono_kernel (agdiff_tpu/ops/pallas/
// monolithic.py:240). One CTA per graph runs:
//   0. the graph's working list: its pairs with em or lm nonzero, in pair
//      order (a ballot-and-popcount scan of its P mask entries), and its
//      own incidence lists, each node's entries on those pairs in their
//      order, re-coded as (row in the working list) << shift | other
//      endpoint; both score planes are written 0 off the list;
//   1. the edge encoder on the working pairs, 32 at a time, into rows
//      [0, Pe) of an f32 per-graph scratch e32 (P x H, row r the list's
//      r-th pair) that the wrapper allocates;
//   2. NB SchNet interaction blocks: per pair tile the distance weights
//      (sigmoid(sum relu(d dw1k + dw1b) dw2k + dw2b) times the envelope,
//      per conv), both filter MLPs on the cd-rounded e32 tile, and the
//      messages wp * x_other summed onto each node in pair order; then the
//      node tail;
//   3. NL GIN layers on the f32 e32;
//   4. both pair-score heads, masked by em (global) and lm (local).
// Every pair phase walks tiles of consecutive working pairs. Off the list
// em = lm = 0, where every message is +-0 and both heads are multiplied by
// 0, so each per-node sum (which starts at +0) and each plane holds the
// bits the whole triangle gives; every product row depends on its own
// operand row only.
// The function and its rounding points are documented beside the wrapper
// (kernels/monolithic.py); `mono_forward_plain` there is the plain
// version this kernel is held to.
//
// The cd type T is a template parameter. At bf16, the SchNet filter MLPs
// run on 64-pair tiles through K2's and K3's tensor-core tile
// (filter_mlp.cuh filter_tile_tc: mma.sync.m16n8k16, bias, ssp and the
// bf16 rounding on the accumulators, the filter weights packed once per
// block set by the wrapper in lane order); the other products are wmma
// 16x16x16 fragments with f32 accumulators on rows padded by 16 bytes;
// weights are staged in shared memory where they fit (the filter set once
// per block), as in K1 (csrc/stack_packed.cu), else read from L2 with the
// same loads and the same bits. At f32 they are f32 fused multiply-adds on CUDA
// cores, each thread a 4 x 4 tile, weights read from global memory: no
// TF32. Every other value is f32; rnd<T> rounds where the TPU kernel
// rounds (a no-op at f32). The envelope (cosine or Gaussian) and the head
// activation (relu or gelu) are template parameters too.
//
// What bounds it: operations. At B=128, N=32, H=128 with the working
// graphs of chip_smoke.py's K6 case (14990 of 63488 pairs in em), the
// products are ~18 GFLOP, 0.018 ms at 989 TFLOP/s bf16, and the bytes
// (distances, masks, types, embeddings, weights, planes) ~8 MB, 0.002 ms.
// It runs far above that (PERF.md): legacy mma.sync through wmma, not
// wgmma; the encoder's weights restaged for every 32-pair tile; barriers
// between every step of a tile; one CTA per graph (B = 48 leaves SMs idle).
//
// Node regions (h, hl, the node temporaries NF and XB, the small per-node
// arrays) live in shared memory or, by layout level, in a per-graph
// global scratch (kernels/monolithic.py layout mirrors Regions): the same
// code at every level, and the same bits. Aggregation walks each node's
// incidence list in increasing pair order (ops/pairs.py): no atomics, so
// two launches give the same bits. The working lists live in shared
// memory where they fit beside the rest, else in the graph's scratch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (kernels/build.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

#include "filter_mlp.cuh"

using namespace nvcuda;

#define TP 32             // pairs per tile (kernels/monolithic.py TILE_P)
#define NTHREADS 512
#define NWARPS (NTHREADS / 32)
#define MAX_SMEM_BYTES 232448  // shared memory a block may use on Hopper
#define TYPE_ROWS 128          // rows of the bond-type tables
#define LN2F 0.6931471805599453f
#define PIF 3.14159265358979323846f

// Offset table (int32, kernels/monolithic.py::_pack), each entry an element
// offset into the cd buffer wt or the f32 buffer wf:
//   [E_PER cd][EF_PER f32][NB x W_PER_BLOCK cd][NB x F_PER_BLOCK f32]
//   [NL x G_PER_LAYER cd][2 x S_PER_HEAD cd]
//   [NL x GF_PER_LAYER f32][2 x SF_PER_HEAD f32]
enum { E_KFE, E_T0, E_W0A, E_W1, E_T2, E_W2A, E_W3, E_PER };
enum { EF_BFE, EF_B1, EF_B3, EF_PER };
// W_TC: fa, fb1, fb2 packed for filter_tile_tc (bf16; empty at f32)
enum { W_FA, W_FB1, W_FB2, W_L1, W_L2A, W_L2B, W_LIN, W_ATT0, W_SE0, W_SE1,
       W_TC, W_PER_BLOCK };
// F_BETA: beta1, beta2, act_beta; F_DW: dw1k, dw1b, dw2k of conv 1, then
// of conv 2 (DW each); F_DWB: dw2b of conv 1 and 2
enum { F_BA, F_BB, F_L1B, F_L2AB, F_L2BB, F_LINB, F_ATT0B, F_ATT1K, F_ATT1B,
       F_BETA, F_DW, F_DWB, F_PER_BLOCK };
enum { G_L0, G_L1, G_PER_LAYER };
enum { GF_B0, GF_B1, GF_PER_LAYER };
enum { S_W1H, S_W1E, S_W2, S_PER_HEAD };
enum { SF_B1, SF_B2, SF_W3, SF_B3, SF_PER_HEAD };

struct Args {
  const float* dp;         // (B, P) pair distances
  const float* em;         // (B, P) working-graph mask
  const float* lm;         // (B, P) bond-graph mask
  const int* tp;           // (B, P) bond types
  const float* h0;         // (B, N, H) cd-rounded SchNet embedding
  const float* hl0;        // (B, N, H) cd-rounded GIN embedding
  const long long* pi;     // (P,) endpoint i
  const long long* pj;     // (P,) endpoint j
  const int* inc_ptr;      // (N + 1,) CSR offsets
  const unsigned* inc;     // (2P,) pair << shift | other endpoint (triu)
  const void* wt;          // cd weights
  const float* wf;         // f32 weights, biases and scalars
  const int* offs;         // offset table
  float* out0;             // (B, P) global plane
  float* out1;             // (B, P) local plane
  float* e32;              // (B, P, H) encoder output scratch
  unsigned char* scratch;  // per-graph node regions that are not shared
  long long scratch_stride;
  int B, N, P, H, DW, NB, NL, NP;
  int inc_shift;
  int lists_offset;        // byte offset of the working lists in shared
                           // memory, or -1: at lists_goffset in scratch
  long long lists_goffset;
  int level;               // 0: node regions shared; 1: NF, XB global;
                           // 2: every node-sized region global
  int resident;            // bf16 weights staged in shared memory (WR)
  int wr_offset;
  float cutoff;
};

// Padded strides (elements) for hidden width H.
struct Strides {
  int LDF, LDX, LDE, LDV, LDB;
  __host__ __device__ explicit Strides(int H)
      : LDF(2 * H + 4), LDX(2 * H + 8), LDE(H + 8), LDV(H + H / 2 + 4),
        LDB(H + H / 2 + 8) {}
};

// Four consecutive values as float4 (generic pointers: shared or global
// memory; every caller's column is a multiple of 4 and rows are aligned).
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
// store four values, rounded to the destination type
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float sigmoid_(float x) {
  return 1.f / (1.f + expf(-x));
}
__device__ __forceinline__ float ssp(float x, float beta) {
  return softplus_<false>(beta * x) - LN2F;
}
// jax.nn.gelu's default, the tanh form
__device__ __forceinline__ float gelu_(float x) {
  return 0.5f * x * (1.f + tanhf(0.7978845608028654f
                                 * (x + 0.044715f * x * x * x)));
}
template <bool GELU>
__device__ __forceinline__ float act_(float x) {
  return GELU ? gelu_(x) : relu(x);
}
template <bool SMOOTH>
__device__ __forceinline__ float envelope(float d, float cutoff) {
  float env;
  if (SMOOTH)
    env = 0.5f * (cosf(d * (PIF / cutoff)) + 1.f)
          * (d <= cutoff ? 1.f : 0.f);
  else
    env = expf(-((d - cutoff) * (d - cutoff)) / (2.f * cutoff * cutoff));
  return env * (d <= cutoff ? 1.f : 0.f) * (d >= 0.f ? 1.f : 0.f);
}
__device__ __forceinline__ float4 f4(float a, float b, float c, float d) {
  return make_float4(a, b, c, d);
}

// ---- products ---------------------------------------------------------------

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ void mma_k(FragC& acc0, FragC& acc1, bool two,
                                      const bf16* A, int lda, const bf16* B,
                                      int ldb, int K) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
  for (int k = 0; k < K; k += 16) {
    wmma::load_matrix_sync(fb, B + k * ldb, ldb);
    wmma::load_matrix_sync(fa, A + k, lda);
    wmma::mma_sync(acc0, fa, fb, acc0);
    if (two) {
      wmma::load_matrix_sync(fa, A + 16 * lda + k, lda);
      wmma::mma_sync(acc1, fa, fb, acc1);
    }
  }
}

// C (f32, ldc) = A1 @ B1 (+ A2 @ B2); bf16 operands, row-major, M, Nc, K
// multiples of 16. A warp's unit is a 16-column tile of two 16-row tiles;
// units go round-robin from warp `wofs`. Callers synchronise.
__device__ void mma_tiles(float* C, int ldc, int M, int Nc, const bf16* A1,
                          int lda1, const bf16* B1, int ldb1, int K1,
                          const bf16* A2 = nullptr, int lda2 = 0,
                          const bf16* B2 = nullptr, int ldb2 = 0, int K2 = 0,
                          int wofs = 0) {
  const int warp = threadIdx.x >> 5;
  const int tn = Nc >> 4, units = ((M + 31) >> 5) * tn;
  for (int u = (warp + NWARPS - wofs) % NWARPS; u < units; u += NWARPS) {
    const int r = (u / tn) << 5, c = (u % tn) << 4;
    const bool two = r + 16 < M;
    FragC acc0, acc1;
    wmma::fill_fragment(acc0, 0.0f);
    wmma::fill_fragment(acc1, 0.0f);
    mma_k(acc0, acc1, two, A1 + r * lda1, lda1, B1 + c, ldb1, K1);
    if (K2 > 0)
      mma_k(acc0, acc1, two, A2 + r * lda2, lda2, B2 + c, ldb2, K2);
    wmma::store_matrix_sync(C + r * ldc + c, acc0, ldc, wmma::mem_row_major);
    if (two)
      wmma::store_matrix_sync(C + (r + 16) * ldc + c, acc1, ldc,
                              wmma::mem_row_major);
  }
}

// acc[i][j] += sum_k A[i][k] B[k][j], i, j < 4 (f32, B rows 16-byte
// aligned)
__device__ __forceinline__ void fma_k(float acc[4][4], const float* A,
                                      int lda, const float* B, int ldb,
                                      int K) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 w = ld4(B + (size_t)k * ldb);
    const float a[4] = {A[k], A[lda + k], A[2 * lda + k], A[3 * lda + k]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][0] = fmaf(a[i], w.x, acc[i][0]);
      acc[i][1] = fmaf(a[i], w.y, acc[i][1]);
      acc[i][2] = fmaf(a[i], w.z, acc[i][2]);
      acc[i][3] = fmaf(a[i], w.w, acc[i][3]);
    }
  }
}

// The same product in true f32 on CUDA cores: a thread's unit is 4 rows x
// 4 columns (M, Nc multiples of 4). Callers synchronise.
__device__ void mma_tiles(float* C, int ldc, int M, int Nc, const float* A1,
                          int lda1, const float* B1, int ldb1, int K1,
                          const float* A2 = nullptr, int lda2 = 0,
                          const float* B2 = nullptr, int ldb2 = 0,
                          int K2 = 0, int wofs = 0) {
  const int tn = Nc >> 2, units = (M >> 2) * tn;
  const int start = (threadIdx.x + 32 * wofs) % NTHREADS;
  for (int u = start; u < units; u += NTHREADS) {
    const int r = (u / tn) << 2, c = (u % tn) << 2;
    float acc[4][4] = {};
    fma_k(acc, A1 + r * lda1, lda1, B1 + c, ldb1, K1);
    if (K2 > 0) fma_k(acc, A2 + r * lda2, lda2, B2 + c, ldb2, K2);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st4(C + (r + i) * ldc + c, f4(acc[i][0], acc[i][1], acc[i][2],
                                    acc[i][3]));
  }
}

// Cooperative copy of a K x Nc bf16 matrix into rows of Nc + 8 (the
// padded stride wmma reads without bank conflicts); returns that stride.
__device__ int stage_w(bf16* dst, const bf16* src, int K, int Nc) {
  const int vpr = Nc / 8, ld = Nc + 8;
#pragma unroll 4
  for (int e = threadIdx.x; e < K * vpr; e += NTHREADS) {
    const int r = e / vpr, v = e % vpr;
    reinterpret_cast<uint4*>(dst + r * ld)[v] =
        __ldg(reinterpret_cast<const uint4*>(src + r * Nc) + v);
  }
  return ld;
}

// C = A @ W for a weight matrix W (K x Nc, global), between two barriers:
// at bf16 W is staged in WR first when there is a weight region.
template <typename T>
__device__ void product(float* C, int ldc, int M, int Nc, const T* A,
                        int lda, const T* W, int K, T* WR) {
  int ldw = Nc;
  __syncthreads();
  if constexpr (std::is_same<T, bf16>::value) {
    if (WR != nullptr) {
      ldw = stage_w(WR, W, K, Nc);
      __syncthreads();
      W = WR;
    }
  }
  mma_tiles(C, ldc, M, Nc, A, lda, W, ldw, K);
  __syncthreads();
}

// TP rows of an f32 (P, C) plane from pair p0 into rows of stride ld at
// type T (rounded); rows past `nrows` are zero. C % 4 == 0.
template <typename T>
__device__ void load_rows(T* dst, int ld, const float* src, int p0,
                          int nrows, int C) {
  const int vpr = C / 4;
  for (int e = threadIdx.x; e < TP * vpr; e += NTHREADS) {
    const int r = e / vpr, c = 4 * (e % vpr);
    float4 v = f4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows) v = ld4(src + (size_t)(p0 + r) * C + c);
    st4(dst + r * ld + c, v);
  }
}

// Each node's incidence entries in the tile of working rows ending at
// `pend` (K1's ballot cursors, csrc/stack_packed.cu): from endq[n] to the
// first entry at or past pend, which becomes the new endq[n]; cur[n] keeps
// the start; ince[n] ends the node's list.
__device__ void tile_cursors(const unsigned* inc, int shift, const int* ince,
                             int* cur, int* endq, int N, int pend) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int n = warp; n < N; n += NWARPS) {
    int q = endq[n];
    const int q0 = q, qe = ince[n];
    unsigned in;
    do {
      in = __ballot_sync(0xffffffffu, q + lane < qe
                         && (int)(inc[q + lane] >> shift) < pend);
      q += __popc(in);
    } while (in == 0xffffffffu);
    if (lane == 0) {
      cur[n] = q0;
      endq[n] = q;
    }
  }
}

__host__ __device__ inline size_t round16(size_t x) { return (x + 15) & ~15; }

// A graph's working lists (kernels/monolithic.py lists_bytes mirrors
// this): the working pairs (16-bit), the scan's bit words and bases per 32
// pairs, each node's list end, the working count, and the re-coded
// incidence entries (2P at most)
struct Lists {
  size_t plist, bits, base, ince, meta, inc, total;
  __host__ __device__ Lists(int P, int NP) {
    const size_t nc = (P + 31) / 32;
    plist = 0;
    bits = plist + round16(2 * (size_t)P);
    base = bits + round16(4 * nc);
    ince = base + round16(4 * nc);
    meta = ince + round16(4 * (size_t)NP);
    inc = meta + 16;
    total = inc + 8 * (size_t)P;
  }
};

// Bytes of each group of regions for cd values of S bytes (kernels/
// monolithic.py region_bytes mirrors this). The pair tile holds the
// 32-pair tile of the wmma phases or, at bf16, the 64-pair filter tile
// (E | Tt, V, the distance weights), whichever is larger.
__host__ __device__ inline size_t tc_tile_bytes(int H) {
  const TcDims d = tc_dims(H, H, H / 2);
  return tc_r1_bytes(d) + tc_v_bytes(d) + 2 * TC_ROWS * 4;
}
struct Regions {
  size_t states, small, temps, tile;
  __host__ __device__ Regions(int NP, int H, int S) {
    const Strides st(H);
    states = 2 * (size_t)NP * H * 4;
    small = (4 * (size_t)NP + 1) * 4;
    temps = (size_t)NP * st.LDF * 4 + (size_t)NP * st.LDX * S;
    tile = (size_t)TP * st.LDE * S + (size_t)TP * st.LDV * 4
           + (size_t)TP * st.LDB * S + 2 * TP * 4;
    if (S == 2 && tc_tile_bytes(H) > tile) tile = tc_tile_bytes(H);
  }
  size_t shared(int level) const {
    return tile + (level < 1 ? temps : 0) + (level < 2 ? states + small : 0);
  }
  size_t global(int level) const {
    return (level >= 1 ? temps : 0) + (level >= 2 ? states + small : 0);
  }
};

template <typename T, bool SMOOTH, bool GELU>
__global__ void __launch_bounds__(NTHREADS) mono_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x;
  const int H = a.H, N = a.N, NP = a.NP, P = a.P, C = a.H, DW = a.DW;
  const int F1 = H, F2 = H / 2, FW = F1 + F2, R = H / 16;
  const Strides S(H);
  const int LDF = S.LDF, LDX = S.LDX, LDE = S.LDE, LDV = S.LDV, LDB = S.LDB;
  const float cutoff = a.cutoff;

  // carve the regions from shared memory or this graph's scratch
  unsigned char* sp = smem;
  unsigned char* gp = a.scratch + (size_t)b * a.scratch_stride;
  auto take = [&](bool glob, size_t bytes) {
    unsigned char*& p = glob ? gp : sp;
    unsigned char* r = p;
    p += bytes;
    return r;
  };
  const bool sg = a.level >= 2, tg = a.level >= 1;
  float* h = reinterpret_cast<float*>(take(sg, (size_t)NP * H * 4));
  float* hl = reinterpret_cast<float*>(take(sg, (size_t)NP * H * 4));
  float* NF = reinterpret_cast<float*>(take(tg, (size_t)NP * LDF * 4));
  T* XB = reinterpret_cast<T*>(take(tg, (size_t)NP * LDX * sizeof(T)));
  unsigned char* tile =
      take(false, Regions(NP, H, sizeof(T)).tile);   // the pair tile
  T* EPT = reinterpret_cast<T*>(tile);
  float* VF = reinterpret_cast<float*>(tile + TP * LDE * sizeof(T));
  T* VB = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(VF)
                               + TP * LDV * 4);
  float* WE = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(VB)
                                       + TP * LDB * sizeof(T));
  int* cur = reinterpret_cast<int*>(take(sg, (size_t)NP * 4));
  int* endq = reinterpret_cast<int*>(take(sg, (size_t)NP * 4));
  float* gate = reinterpret_cast<float*>(take(sg, (size_t)NP * 4));
  int* incp = reinterpret_cast<int*>(take(sg, ((size_t)NP + 1) * 4));
  T* WR = a.resident ? reinterpret_cast<T*>(smem + a.wr_offset) : nullptr;
  // the SchNet pair loop's tile: at bf16 filter_tile_tc's (TR = TC_ROWS
  // pairs; E | Tt, V, the distance weights), at f32 the 32-pair one
  constexpr bool TC = std::is_same<T, bf16>::value;
  constexpr int TR = TC ? TC_ROWS : TP;
  const TcDims td = tc_dims(C, F1, F2);
  bf16* ET = reinterpret_cast<bf16*>(tile);
  float* TT = reinterpret_cast<float*>(tile);
  bf16* VT = reinterpret_cast<bf16*>(tile + tc_r1_bytes(td));
  float* WT = TC ? reinterpret_cast<float*>(tile + tc_r1_bytes(td)
                                            + tc_v_bytes(td))
                 : WE;

  const T* wt = static_cast<const T*>(a.wt);
  const float* wf = a.wf;
  const int* offs = a.offs;
  const int o_ef = E_PER;
  const int o_blk = o_ef + EF_PER;
  const int o_fblk = o_blk + a.NB * W_PER_BLOCK;
  const int o_gin = o_fblk + a.NB * F_PER_BLOCK;
  const int o_head = o_gin + a.NL * G_PER_LAYER;
  const int o_fgin = o_head + 2 * S_PER_HEAD;
  const int o_fhead = o_fgin + a.NL * GF_PER_LAYER;

  const int shift = a.inc_shift;
  const unsigned omask = (1u << shift) - 1u;
  for (int n = threadIdx.x; n <= NP; n += NTHREADS)
    incp[n] = a.inc_ptr[n < N ? n : N];
  const size_t node_base = (size_t)b * N * H;
  for (int e = threadIdx.x; e < NP * H; e += NTHREADS) {
    const bool real = e / H < N;
    h[e] = real ? a.h0[node_base + e] : 0.f;
    hl[e] = real ? a.hl0[node_base + e] : 0.f;
  }
  const float* dpg = a.dp + (size_t)b * P;
  const float* emg = a.em + (size_t)b * P;
  const float* lmg = a.lm + (size_t)b * P;
  const int* tpg = a.tp + (size_t)b * P;
  float* E = a.e32 + (size_t)b * P * H;

  // ---- 0. the working list and this graph's incidence lists ----------------
  const Lists ls(P, NP);
  unsigned char* lmem = a.lists_offset >= 0
      ? smem + a.lists_offset
      : a.scratch + (size_t)b * a.scratch_stride + a.lists_goffset;
  unsigned short* plist = reinterpret_cast<unsigned short*>(lmem + ls.plist);
  unsigned* wbits = reinterpret_cast<unsigned*>(lmem + ls.bits);
  int* wbase = reinterpret_cast<int*>(lmem + ls.base);
  int* ince = reinterpret_cast<int*>(lmem + ls.ince);
  int* meta = reinterpret_cast<int*>(lmem + ls.meta);
  unsigned* inc = reinterpret_cast<unsigned*>(lmem + ls.inc);
  {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int NC = (P + 31) / 32;
    for (int k = warp; k < NC; k += NWARPS) {
      const int p = 32 * k + lane;
      const unsigned m = __ballot_sync(
          0xffffffffu, p < P && (emg[p] != 0.f || lmg[p] != 0.f));
      if (lane == 0) {
        wbits[k] = m;
        wbase[k] = __popc(m);
      }
    }
    __syncthreads();
    if (warp == 0) {   // exclusive scan of the counts, 32 words at a time
      int run = 0;
      for (int k0 = 0; k0 < NC; k0 += 32) {
        const int k = k0 + lane, c = k < NC ? wbase[k] : 0;
        int s = c;
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, s, o);
          if (lane >= o) s += t;
        }
        if (k < NC) wbase[k] = run + s - c;
        run += __shfl_sync(0xffffffffu, s, 31);
      }
      if (lane == 0) meta[0] = run;
    }
    __syncthreads();
    for (int p = threadIdx.x; p < P; p += NTHREADS) {
      const unsigned m = wbits[p >> 5], bit = 1u << (p & 31);
      if (m & bit) {
        plist[wbase[p >> 5] + __popc(m & (bit - 1u))] = (unsigned short)p;
      } else {
        a.out0[(size_t)b * P + p] = 0.f;
        a.out1[(size_t)b * P + p] = 0.f;
      }
    }
    // each node's entries on working pairs, in order, from its own start
    for (int n = warp; n < N; n += NWARPS) {
      const int q1 = a.inc_ptr[n + 1];
      int w = a.inc_ptr[n];
      for (int q = w; q < q1; q += 32) {
        bool keep = false;
        unsigned code = 0u;
        if (q + lane < q1) {
          const unsigned iq = a.inc[q + lane];
          const int p = (int)(iq >> shift);
          const unsigned m = wbits[p >> 5], bit = 1u << (p & 31);
          keep = (m & bit) != 0u;
          code = ((unsigned)(wbase[p >> 5] + __popc(m & (bit - 1u)))
                  << shift) | (iq & omask);
        }
        const unsigned km = __ballot_sync(0xffffffffu, keep);
        if (keep) inc[w + __popc(km & ((1u << lane) - 1u))] = code;
        w += __popc(km);
      }
      if (lane == 0) ince[n] = w;
    }
    __syncthreads();
  }
  const int Pe = meta[0];

  // ---- 1. edge encoder: e32 = MLP(gelu(d kfe + bfe), type tables) ---------
  {
    const T* kfe = wt + offs[E_KFE];
    const T* t0 = wt + offs[E_T0];
    const T* t2 = wt + offs[E_T2];
    const T* w0a = wt + offs[E_W0A];
    const T* w1 = wt + offs[E_W1];
    const T* w2a = wt + offs[E_W2A];
    const T* w3 = wt + offs[E_W3];
    const float* bfe = wf + offs[o_ef + EF_BFE];
    const float* b1 = wf + offs[o_ef + EF_B1];
    const float* b3 = wf + offs[o_ef + EF_B3];
    const int H4 = H / 4;
    for (int p0 = 0; p0 < Pe; p0 += TP) {
      const int rows = min(TP, Pe - p0);
      __syncthreads();
      for (int e = threadIdx.x; e < TP * H4; e += NTHREADS) {
        const int r = e / H4, c = 4 * (e % H4);
        float4 v = f4(0.f, 0.f, 0.f, 0.f);
        if (r < rows) {
          const float d = dpg[plist[p0 + r]];
          const float4 k = ld4(kfe + c), bb = ldg4(bfe + c);
          v = f4(gelu_(d * k.x + bb.x), gelu_(d * k.y + bb.y),
                 gelu_(d * k.z + bb.z), gelu_(d * k.w + bb.w));
        }
        st4(VB + r * LDB + c, v);
      }
      // x = gelu(expanded @ w0a + table0[type]) and y likewise with
      // table2, each rounded to cd
      for (int layer = 0; layer < 4; ++layer) {
        const T* W = layer == 0 ? w0a : layer == 1 ? w1 : layer == 2 ? w2a
                                                                    : w3;
        product(VF, LDV, TP, H, VB, LDB, W, H, WR);
        if (layer == 3) break;
        const T* table = layer == 0 ? t0 : t2;
        for (int e = threadIdx.x; e < TP * H4; e += NTHREADS) {
          const int r = e / H4, c = 4 * (e % H4);
          float4 v = f4(0.f, 0.f, 0.f, 0.f);
          if (r < rows) {
            const float4 x = ld4(VF + r * LDV + c);
            if (layer == 1) {
              const float4 bias = ldg4(b1 + c);
              v = f4(x.x + bias.x, x.y + bias.y, x.z + bias.z, x.w + bias.w);
            } else {
              const int t = tpg[plist[p0 + r]];
              const float4 row = (unsigned)t < TYPE_ROWS
                  ? ld4(table + (size_t)t * H + c) : f4(0.f, 0.f, 0.f, 0.f);
              v = f4(gelu_(x.x + row.x), gelu_(x.y + row.y),
                     gelu_(x.z + row.z), gelu_(x.w + row.w));
            }
          }
          st4(VB + r * LDB + c, v);
        }
      }
      for (int e = threadIdx.x; e < rows * H4; e += NTHREADS) {
        const int r = e / H4, c = 4 * (e % H4);
        const float4 x = ld4(VF + r * LDV + c), bias = ldg4(b3 + c);
        st4(E + (size_t)(p0 + r) * H + c,
            f4(x.x + bias.x, x.y + bias.y, x.z + bias.z, x.w + bias.w));
      }
    }
  }
  __syncthreads();

  // ---- 2. SchNet interaction blocks ---------------------------------------
  for (int blk = 0; blk < a.NB; ++blk) {
    const int* ob = offs + o_blk + blk * W_PER_BLOCK;
    const int* of = offs + o_fblk + blk * F_PER_BLOCK;
    const T* w_fa = wt + ob[W_FA];
    const T* w_fb1 = wt + ob[W_FB1];
    const T* w_fb2 = wt + ob[W_FB2];
    const T* w_l1 = wt + ob[W_L1];
    const T* w_l2a = wt + ob[W_L2A];
    const T* w_l2b = wt + ob[W_L2B];
    const T* w_lin = wt + ob[W_LIN];
    const T* w_att0 = wt + ob[W_ATT0];
    const T* w_se0 = wt + ob[W_SE0];
    const T* w_se1 = wt + ob[W_SE1];
    const float* f_ba = wf + of[F_BA];
    const float* f_bb = wf + of[F_BB];
    const float* f_l1b = wf + of[F_L1B];
    const float* f_l2ab = wf + of[F_L2AB];
    const float* f_l2bb = wf + of[F_L2BB];
    const float* f_linb = wf + of[F_LINB];
    const float* f_att0b = wf + of[F_ATT0B];
    const float* f_att1k = wf + of[F_ATT1K];
    const float att1b = wf[of[F_ATT1B]];
    const float beta1 = wf[of[F_BETA]], beta2 = wf[of[F_BETA] + 1];
    const float act_beta = wf[of[F_BETA] + 2];
    const float* f_dw = wf + of[F_DW];
    const float* f_dwb = wf + of[F_DWB];

    // node input x = leaky(h @ [l1k conv1 | l1k conv2] + b), rounded to cd
    for (int e = threadIdx.x; e < NP * H; e += NTHREADS)
      XB[(e / H) * LDX + e % H] = T(rnd<T>(h[e]));
    product(NF, LDF, NP, FW, XB, LDX, w_l1, H, WR);
    for (int e = threadIdx.x; e < NP * FW; e += NTHREADS) {
      const int n = e / FW, c = e % FW;
      float v = NF[n * LDF + c] + f_l1b[c];
      v = v > 0.f ? v : 0.2f * v;
      XB[n * LDX + c] = T(rnd<T>(v));
      NF[n * LDF + c] = 0.f;  // aggregation sums start at zero
    }
    for (int n = threadIdx.x; n < N; n += NTHREADS) endq[n] = incp[n];
    // the filter weights: at bf16 the packed set for filter_tile_tc,
    // staged once per block where the weight region is
    const bf16* w_tc = nullptr;
    if constexpr (TC) {
      w_tc = wt + ob[W_TC];
      if (WR != nullptr) {
        stage_tc_weights(WR, w_tc, tc_weight_elems(td));
        w_tc = WR;
      }
    }
    const FilterTC ftc{nullptr, f_ba, f_ba + F1, f_bb, f_bb + F1,
                       wf + of[F_BETA], wf + of[F_BETA] + 1};
    __syncthreads();

    for (int p0 = 0; p0 < Pe; p0 += TR) {
      const int rows = min(TR, Pe - p0);
      if constexpr (TC) {   // TC_ROWS rows of e32 at bf16, zero past rows
        for (int e = threadIdx.x; e < TC_ROWS * (C / 4); e += NTHREADS) {
          const int r = e / (C / 4), c = 4 * (e % (C / 4));
          float4 v = f4(0.f, 0.f, 0.f, 0.f);
          if (r < rows) v = ld4(E + (size_t)(p0 + r) * H + c);
          st4(ET + r * td.lde + c, v);
        }
      } else {
        load_rows(EPT, LDE, E, p0, rows, C);
      }
      // the distance weight times the envelope, per conv and pair
      if (threadIdx.x < 2 * TR) {
        const int conv = threadIdx.x / TR, r = threadIdx.x % TR;
        float wv = 0.f;
        if (r < rows) {
          const int p = plist[p0 + r];
          const float d = dpg[p];
          const float* k1 = f_dw + conv * 3 * DW;
          const float* b1 = k1 + DW;
          const float* k2 = b1 + DW;
          float s = 0.f;
          for (int k = 0; k < DW; ++k)
            s += relu(d * k1[k] + b1[k]) * k2[k];
          wv = sigmoid_(s + f_dwb[conv])
               * (envelope<SMOOTH>(d, cutoff) * emg[p]);
        }
        WT[threadIdx.x] = wv;
      }
      tile_cursors(inc, shift, ince, cur, endq, N, p0 + TR);
      __syncthreads();
      // filter MLPs: v = ssp(e @ [fa1 | fa2] + ba) rounded; f = v @ fb + bb
      if constexpr (TC) {
        if (WR != nullptr)
          filter_tile_tc<false, true>(ET, VT, TT, rows, w_tc, ftc, td);
        else
          filter_tile_tc<false, false>(ET, VT, TT, rows, w_tc, ftc, td);
      } else {
        mma_tiles(VF, LDV, TP, FW, EPT, LDE, w_fa, FW, C);
        __syncthreads();
        for (int e = threadIdx.x; e < TP * FW / 4; e += NTHREADS) {
          const int r = e / (FW / 4), c = 4 * (e % (FW / 4));
          const float beta = c < F1 ? beta1 : beta2;
          const float4 v = ld4(VF + r * LDV + c), bias = ldg4(f_ba + c);
          st4(VB + r * LDB + c,
              f4(ssp(v.x + bias.x, beta), ssp(v.y + bias.y, beta),
                 ssp(v.z + bias.z, beta), ssp(v.w + bias.w, beta)));
        }
        __syncthreads();
        mma_tiles(VF, LDV, TP, F1, VB, LDB, w_fb1, F1, F1);
        mma_tiles(VF + F1, LDV, TP, F2, VB + F1, LDB, w_fb2, F2, F2,
                  nullptr, 0, nullptr, 0, 0, F1 / 16);
        __syncthreads();
      }
      // agg_n += cd(wp_p * x_other), wp_p = cd(f_p * wedge_p), over this
      // tile's working pairs incident to n, in pair order (f: the filter
      // output with its bias bb, which filter_tile_tc adds)
      for (int e = threadIdx.x; e < N * FW / 4; e += NTHREADS) {
        const int n = e / (FW / 4), c = 4 * (e % (FW / 4));
        const float* wep = WT + (c < F1 ? 0 : TR);
        const float4 bias = ldg4(f_bb + c);
        float4 acc = ld4(NF + n * LDF + c);
        const int qe = endq[n];
#pragma unroll 4
        for (int q = cur[n]; q < qe; ++q) {
          const unsigned iq = inc[q];
          const int lp = (int)(iq >> shift) - p0, o = iq & omask;
          const float w = wep[lp];
          float4 v;
          if constexpr (TC) {
            v = ld4(TT + lp * td.ldt + c);
          } else {
            const float4 u = ld4(VF + lp * LDV + c);
            v = f4(u.x + bias.x, u.y + bias.y, u.z + bias.z, u.w + bias.w);
          }
          const float4 x = ld4(XB + o * LDX + c);
          acc.x += rnd<T>(rnd<T>(v.x * w) * x.x);
          acc.y += rnd<T>(rnd<T>(v.y * w) * x.y);
          acc.z += rnd<T>(rnd<T>(v.z * w) * x.z);
          acc.w += rnd<T>(rnd<T>(v.w * w) * x.w);
        }
        st4(NF + n * LDF + c, acc);
      }
      __syncthreads();
    }

    // node tail: lin2 per conv, ssp(act_beta), lin, the attention gate,
    // the SE gate, the residual
    for (int e = threadIdx.x; e < NP * FW; e += NTHREADS) {
      const int n = e / FW, c = e % FW;
      XB[n * LDX + c] = T(rnd<T>(NF[n * LDF + c]));
    }
    product(NF, LDF, NP, H, XB, LDX, w_l2a, F1, WR);
    product(NF + H, LDF, NP, H, XB + F1, LDX, w_l2b, F2, WR);
    for (int e = threadIdx.x; e < NP * 2 * H; e += NTHREADS) {
      const int n = e / (2 * H), c = e % (2 * H);
      const float v = NF[n * LDF + c] + (c < H ? f_l2ab[c] : f_l2bb[c - H]);
      XB[n * LDX + c] = T(rnd<T>(ssp(v, act_beta)));
    }
    product(NF, LDF, NP, H, XB, LDX, w_lin, 2 * H, WR);
    for (int e = threadIdx.x; e < NP * H; e += NTHREADS) {
      const int n = e / H, c = e % H;
      const float v = NF[n * LDF + c] + f_linb[c];
      NF[n * LDF + c] = v;
      XB[n * LDX + c] = T(rnd<T>(v));
    }
    product(NF + H, LDF, NP, H / 2, XB, LDX, w_att0, H, WR);
    {
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      for (int n = warp; n < NP; n += NWARPS) {
        float s = 0.f;
        for (int k = lane; k < H / 2; k += 32)
          s += relu(NF[n * LDF + H + k] + f_att0b[k]) * f_att1k[k];
        for (int o = 16; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) gate[n] = sigmoid_(s + att1b);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < NP * H; e += NTHREADS) {
      const int n = e / H, c = e % H;
      const float v = NF[n * LDF + c] * gate[n];
      NF[n * LDF + c] = v;
      XB[n * LDX + c] = T(rnd<T>(v));
    }
    __syncthreads();
    for (int e = threadIdx.x; e < NP * R; e += NTHREADS) {
      const int n = e / R, k = e % R;
      float s = 0.f;
      for (int c = 0; c < H; ++c)
        s += to_f(XB[n * LDX + c]) * to_f(w_se0[c * R + k]);
      NF[n * LDF + H + k] = rnd<T>(relu(s));
    }
    __syncthreads();
    for (int e = threadIdx.x; e < NP * H; e += NTHREADS) {
      const int n = e / H, c = e % H;
      float s = 0.f;
      for (int k = 0; k < R; ++k)
        s += NF[n * LDF + H + k] * to_f(w_se1[k * H + c]);
      h[e] += NF[n * LDF + c] * sigmoid_(s);
    }
    __syncthreads();
  }

  // ---- 3. GIN layers ------------------------------------------------------
  for (int li = 0; li < a.NL; ++li) {
    const T* w_g0 = wt + offs[o_gin + li * G_PER_LAYER + G_L0];
    const T* w_g1 = wt + offs[o_gin + li * G_PER_LAYER + G_L1];
    const float* f_g0 = wf + offs[o_fgin + li * GF_PER_LAYER + GF_B0];
    const float* f_g1 = wf + offs[o_fgin + li * GF_PER_LAYER + GF_B1];
    // agg_n = sum over incident pairs of cd(relu(cd(hl_other) + e32_p) m_p)
    for (int e = threadIdx.x; e < NP * H; e += NTHREADS)
      NF[(e / H) * LDF + e % H] = 0.f;
    for (int n = threadIdx.x; n < N; n += NTHREADS) endq[n] = incp[n];
    __syncthreads();
    for (int p0 = 0; p0 < Pe; p0 += TP) {
      const int rows = min(TP, Pe - p0);
      if (threadIdx.x < TP)
        WE[threadIdx.x] =
            threadIdx.x < rows ? lmg[plist[p0 + threadIdx.x]] : 0.f;
      tile_cursors(inc, shift, ince, cur, endq, N, p0 + TP);
      __syncthreads();
      for (int e = threadIdx.x; e < N * H / 4; e += NTHREADS) {
        const int n = e / (H / 4), c = 4 * (e % (H / 4));
        float4 acc = ld4(NF + n * LDF + c);
        const int qe = endq[n];
#pragma unroll 4
        for (int q = cur[n]; q < qe; ++q) {
          const unsigned iq = inc[q];
          const int p = (int)(iq >> shift), o = iq & omask;
          const float m = WE[p - p0];
          const float4 x = ld4(hl + o * H + c);
          const float4 ev = ld4(E + (size_t)p * H + c);
          acc.x += rnd<T>(relu(rnd<T>(x.x) + ev.x) * m);
          acc.y += rnd<T>(relu(rnd<T>(x.y) + ev.y) * m);
          acc.z += rnd<T>(relu(rnd<T>(x.z) + ev.z) * m);
          acc.w += rnd<T>(relu(rnd<T>(x.w) + ev.w) * m);
        }
        st4(NF + n * LDF + c, acc);
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < NP * H; e += NTHREADS) {
      const int n = e / H, c = e % H;
      XB[n * LDX + c] = T(rnd<T>(hl[e] + NF[n * LDF + c]));
    }
    product(NF, LDF, NP, H, XB, LDX, w_g0, H, WR);
    for (int e = threadIdx.x; e < NP * H; e += NTHREADS) {
      const int n = e / H, c = e % H;
      XB[n * LDX + c] = T(rnd<T>(relu(NF[n * LDF + c] + f_g0[c])));
    }
    product(NF, LDF, NP, H, XB, LDX, w_g1, H, WR);
    for (int e = threadIdx.x; e < NP * H; e += NTHREADS) {
      const int n = e / H, c = e % H;
      float v = NF[n * LDF + c] + f_g1[c];
      if (li < a.NL - 1) v = relu(v);
      hl[e] += v;
    }
    __syncthreads();
  }

  // ---- 4. pair-score heads ----------------------------------------------------
  for (int head = 0; head < 2; ++head) {
    const float* hs = head == 0 ? h : hl;
    const float* mask = head == 0 ? emg : lmg;
    float* out = (head == 0 ? a.out0 : a.out1) + (size_t)b * P;
    const int* ob = offs + o_head + head * S_PER_HEAD;
    const int* of = offs + o_fhead + head * SF_PER_HEAD;
    const T *b_w1h = wt + ob[S_W1H], *b_w1e = wt + ob[S_W1E];
    const T* b_w2 = wt + ob[S_W2];
    const float* f_b1 = wf + of[SF_B1];
    const float* f_b2 = wf + of[SF_B2];
    const float* f_w3 = wf + of[SF_W3];
    const float b3 = wf[of[SF_B3]];
    int ld_w1 = H, ld_w2 = H / 2;
    __syncthreads();
    if constexpr (std::is_same<T, bf16>::value) {
      if (WR != nullptr) {
        bf16* w = WR;
        const bf16* src_h = b_w1h;
        const bf16* src_e = b_w1e;
        const bf16* src_2 = b_w2;
        b_w1h = w;
        ld_w1 = stage_w(w, src_h, H, H);
        w += H * ld_w1;
        b_w1e = w;
        stage_w(w, src_e, C, H);
        w += C * ld_w1;
        b_w2 = w;
        ld_w2 = stage_w(w, src_2, H, H / 2);
      }
    }
    for (int e = threadIdx.x; e < NP * H; e += NTHREADS)
      XB[(e / H) * LDX + e % H] = T(rnd<T>(hs[e]));
    __syncthreads();
    for (int p0 = 0; p0 < Pe; p0 += TP) {
      const int rows = min(TP, Pe - p0);
      load_rows(EPT, LDE, E, p0, rows, C);
      for (int e = threadIdx.x; e < TP * H / 4; e += NTHREADS) {
        const int r = e / (H / 4), c = 4 * (e % (H / 4));
        float4 v = f4(0.f, 0.f, 0.f, 0.f);
        if (r < rows) {
          const int p = plist[p0 + r];
          const int i = (int)a.pi[p], j = (int)a.pj[p];
          const float4 xi = ld4(XB + i * LDX + c), xj = ld4(XB + j * LDX + c);
          v = f4(xi.x * xj.x, xi.y * xj.y, xi.z * xj.z, xi.w * xj.w);
        }
        st4(VB + r * LDB + c, v);
      }
      __syncthreads();
      mma_tiles(VF, LDV, TP, H, VB, LDB, b_w1h, ld_w1, H, EPT, LDE, b_w1e,
                ld_w1, C);
      __syncthreads();
      for (int e = threadIdx.x; e < TP * H / 4; e += NTHREADS) {
        const int r = e / (H / 4), c = 4 * (e % (H / 4));
        const float4 v = ld4(VF + r * LDV + c), bias = ldg4(f_b1 + c);
        st4(VB + r * LDB + c,
            f4(act_<GELU>(v.x + bias.x), act_<GELU>(v.y + bias.y),
               act_<GELU>(v.z + bias.z), act_<GELU>(v.w + bias.w)));
      }
      __syncthreads();
      mma_tiles(VF, LDV, TP, H / 2, VB, LDB, b_w2, ld_w2, H);
      __syncthreads();
      {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        for (int r = warp; r < rows; r += NWARPS) {
          float s = 0.f;
          for (int k = lane; k < H / 2; k += 32)
            s += act_<GELU>(VF[r * LDV + k] + f_b2[k]) * f_w3[k];
          for (int o = 16; o > 0; o >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
          if (lane == 0) {
            const int p = plist[p0 + r];
            out[p] = (s + b3) * mask[p];
          }
        }
      }
      __syncthreads();
    }
  }
}

// The bf16 weight region holds the largest set staged at once, at padded
// rows: the filter trio (C x FW, F1 x F1, F2 x F2), a score head (H x H,
// C x H, H x H/2), or one node-side or encoder matrix (at most 2H x H).
static size_t weight_region_bytes(int H) {
  const size_t fw = H + H / 2;
  const size_t filters = (size_t)H * (fw + 8) + (size_t)H * (H + 8)
                         + (size_t)(H / 2) * (H / 2 + 8);
  const size_t head = 2 * (size_t)H * (H + 8) + (size_t)H * (H / 2 + 8);
  const size_t lin = 2 * (size_t)H * (H + 8);
  size_t m = filters > head ? filters : head;
  m = m > lin ? m : lin;
  return 2 * m;
}

typedef void (*KernelFn)(Args);

template <typename T>
static KernelFn pick(int smooth, int gelu) {
  if (smooth)
    return gelu ? mono_kernel<T, true, true> : mono_kernel<T, true, false>;
  return gelu ? mono_kernel<T, false, true> : mono_kernel<T, false, false>;
}

// f32: 1 for cd f32 (wt holds f32), 0 for bf16. scratch holds
// scratch_stride bytes per graph for the regions `level` moves to global
// memory; e32 holds B x P x H floats (kernels/monolithic.py chooses and
// allocates both; scratch also holds the working lists where shared
// memory does not). The pair list is the bucket's full triangle, P pairs.
extern "C" int mono_launch(
    int f32, int smooth, int gelu, const void* dp, const void* em,
    const void* lm, const void* tp, const void* h0, const void* hl0,
    const void* pi, const void* pj, const void* inc_ptr, const void* inc,
    const void* wt, const void* wf, const void* offs, void* out0, void* out1,
    void* e32, void* scratch, long long scratch_stride, int B, int N, int P,
    int H, int DW, int NB, int NL, int inc_shift, int level, float cutoff,
    void* stream) {
  Args a;
  a.dp = static_cast<const float*>(dp);
  a.em = static_cast<const float*>(em);
  a.lm = static_cast<const float*>(lm);
  a.tp = static_cast<const int*>(tp);
  a.h0 = static_cast<const float*>(h0);
  a.hl0 = static_cast<const float*>(hl0);
  a.pi = static_cast<const long long*>(pi);
  a.pj = static_cast<const long long*>(pj);
  a.inc_ptr = static_cast<const int*>(inc_ptr);
  a.inc = static_cast<const unsigned*>(inc);
  a.wt = wt;
  a.wf = static_cast<const float*>(wf);
  a.offs = static_cast<const int*>(offs);
  a.out0 = static_cast<float*>(out0);
  a.out1 = static_cast<float*>(out1);
  a.e32 = static_cast<float*>(e32);
  a.scratch = static_cast<unsigned char*>(scratch);
  a.scratch_stride = scratch_stride;
  a.B = B; a.N = N; a.P = P; a.H = H; a.DW = DW; a.NB = NB; a.NL = NL;
  a.inc_shift = inc_shift;
  a.NP = (N + 15) / 16 * 16;
  a.level = level;
  a.cutoff = cutoff;
  const int S = f32 ? 4 : 2;
  const Regions rg(a.NP, H, S);
  const Lists ls(P, a.NP);
  if (level < 0 || level > 2 || H % 32 != 0 || DW < 1 || B < 1
      || P != N * (N - 1) / 2 || P > 65535 || inc_shift < 1
      || inc_shift > 31 || (size_t)scratch_stride < rg.global(level))
    return (int)cudaErrorInvalidValue;
  if (rg.shared(level) > MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  const size_t base = (rg.shared(level) + 127) / 128 * 128;
  a.resident = !f32 && base + weight_region_bytes(H) <= MAX_SMEM_BYTES;
  a.wr_offset = (int)base;
  size_t smem = a.resident ? base + weight_region_bytes(H) : rg.shared(level);
  // the working lists: in shared memory after the rest where they fit,
  // else after the node regions in the graph's scratch
  const size_t lists_off = round16(smem);
  a.lists_offset = -1;
  a.lists_goffset = (long long)((rg.global(level) + 255) / 256 * 256);
  if (lists_off + ls.total <= MAX_SMEM_BYTES) {
    a.lists_offset = (int)lists_off;
    smem = lists_off + ls.total;
  } else if ((size_t)scratch_stride < a.lists_goffset + ls.total) {
    return (int)cudaErrorInvalidValue;
  }
  if ((rg.global(level) > 0 || a.lists_offset < 0) && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const KernelFn fn = f32 ? pick<float>(smooth, gelu)
                          : pick<bf16>(smooth, gelu);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<B, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* mono_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
