// K1 on Hopper: the whole-stack packed-pair forward, modes 'schnet', 'gin'
// and 'full', each exact or with the polynomial transcendentals ('-approx');
// in mode 'full' the score heads' activation is relu or gelu (GELU, the
// config's mlp_act).
//
// Replaces the TPU kernel _stack_kernel (agdiff_tpu/ops/pallas/
// stack_packed.py:104). A cluster of R CTAs per graph runs, after the edge
// encoder, NB SchNet interaction blocks ('schnet' stops there and writes
// h), NL GIN layers ('gin' writes h and hl) and both pair-score heads
// ('full' writes the two packed (B, P) score planes). The pair list is the
// bucket's full upper triangle or a molecule's tight list padded to a
// capacity; pad slots carry zero weights and appear in no incidence list.
// The function and its rounding are documented beside the wrapper
// (kernels/stack_packed.py).
//
// What bounds it: not arithmetic (~50 GFLOP a launch is ~0.05 ms of the
// card's bf16 rate) but latency inside each CTA: a CTA walks its pair
// tiles one after another, each a chain of loads, small wmma products,
// elementwise passes and per-node sums between five block-wide barriers,
// and its node regions take most of an SM's shared memory, so one CTA
// fits an SM. With one CTA per graph, a Drugs-sized chunk of 48 graphs
// left 84 of the 132 SMs idle. So each graph runs on a cluster of R CTAs
// (kernels/stack_packed.py ranks_for: the largest power of two with
// B x R <= the SMs, at most 8; 2 at B = 48, 1 at B = 128), launched
// together with cudaLaunchKernelEx (at R = 1 a plain launch of one CTA per
// graph: no cluster, no occupancy query). Rank r takes the r-th contiguous
// share of the pair tiles, starting each node's cursor at its first
// incidence entry in that share. After each SchNet block's and each GIN layer's pair
// loop the ranks hold partial node sums; after a cluster barrier each rank
// adds all R of them in rank order (sum_ranks: a peer's shared memory
// through the cluster's distributed shared memory at level 0, its global
// scratch at levels 1 and 2), so every rank gets the same bits and runs
// the same node tail (the node side is ~0.12 of the cycles at N = 64,
// PERF.md). The heads split the slots and need no exchange.
//
// Layout of one CTA (NP = N rounded up to 16, FW = 1.5H):
//   h, hl    f32  NP x H      node states, resident for the whole launch
//   NF       f32  NP x LDF    node-side f32 results / aggregation sums
//   XB       bf16 NP x LDX    bf16 operands of node-side products
//   tile     TP pairs: e rows (bf16), filter values (f32 and bf16), we
//   small    per-node cursors, gates and CSR offsets
//   WR       bf16 weights staged from global memory, when they fit
// The node-sized regions live in shared memory (level 0), or NF and XB
// move to a per-CTA scratch in global memory (level 1), or h, hl and the
// small arrays too (level 2, which fits any N). The wrapper picks the
// smallest level that leaves room to stage the weights (at H = 128: level
// 0 to N = 32, 1 to N = 80, then 2) and allocates the scratch; at B = 48,
// R = 2, N = 128 it is 32 MB, which stays in the 50 MB L2. The code is the
// same at every level, and so are the results: wmma fragments and the
// vector accesses below take generic pointers.
// Every matrix a wmma fragment reads or writes has its rows padded by 16
// bytes (the LD* strides below and the staged weights' Nc + 8): unpadded,
// rows of 256, 384 or 512 bytes all start on the same shared-memory bank
// and each fragment load is an 8-way bank conflict.
// Elementwise passes and the aggregation work on 4 consecutive columns
// per thread (float4 / 4 x bf16 accesses, biases through the read-only
// path), so each thread has a few short dependency chains, not many
// scalar ones.
// Products are bf16 wmma 16x16x16 fragments with f32 accumulators. The
// weights are copied into WR with coalesced 16-byte loads before use
// where shared memory has room for WR; otherwise the B fragments load
// straight from global memory, which is latency-bound. Aggregation walks
// each node's incidence list in increasing pair order, so sums are in a
// fixed order and need no atomics; the lists (one 32-bit entry per
// incident pair: pair << shift | other endpoint) are staged in shared
// memory after the weight region where that has room, else read from
// global memory. The SchNet and GIN loops stop at the last valid pair;
// the heads score every slot.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (kernels/build.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <map>
#include <tuple>

using namespace nvcuda;
namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

#define TP 32             // pairs per tile (kernels/stack_packed.py TILE_P)
#define NTHREADS 512      // 16 warps: twice 8 warps' speed (PERF.md)
#define NWARPS (NTHREADS / 32)
#define MAX_SMEM_BYTES 232448  // shared memory a block may use on Hopper

enum { MODE_SCHNET = 0, MODE_GIN = 1, MODE_FULL = 2 };

// Offset table (int32, built by kernels/stack_packed.py::_pack):
//   [NB x W_PER_BLOCK bf16][NB x F_PER_BLOCK f32]
//   [NL x G_PER_LAYER bf16][2 x S_PER_HEAD bf16]
//   [NL x GF_PER_LAYER f32][2 x SF_PER_HEAD f32]
// Each entry is an element offset into the bf16 or the f32 weight buffer.
enum { W_FA, W_FB1, W_FB2, W_L1, W_L2A, W_L2B, W_LIN, W_ATT0, W_ATT1,
       W_SE0, W_SE1, W_PER_BLOCK };
enum { F_BA, F_BB, F_L1B, F_L2AB, F_L2BB, F_LINB, F_ATT0B, F_ATT1B, F_BETA,
       F_PER_BLOCK };
enum { G_L0, G_L1, G_PER_LAYER };
enum { GF_B0, GF_B1, GF_PER_LAYER };
enum { S_W1H, S_W1E, S_W2, S_PER_HEAD };
enum { SF_B1, SF_B2, SF_W3, SF_B3, SF_PER_HEAD };

struct Args {
  const bf16* ep;          // (B, P, C) global-branch edge features
  const bf16* epl;         // (B, P, C) local-branch edge features
  const float* we;         // (2NB, B, P) distance weight x envelope x mask
  const float* h0;         // (B, N, H)
  const float* hl0;        // (B, N, H)
  const float* lm;         // (B, P) local (bond-graph) mask
  const long long* pi;     // (P,) endpoint i (pad slots: 0)
  const long long* pj;     // (P,) endpoint j
  const int* inc_ptr;      // (N + 1,) CSR offsets
  const unsigned* inc;     // (2V,) incident valid pair << shift | other
                           // endpoint, increasing per node
  const bf16* wbf;         // bf16 weights
  const float* wf;         // f32 weights, biases and scalars
  const int* offs;         // offset table
  float* out0;             // full: (B, P) global plane; schnet/gin: h
  float* out1;             // full: (B, P) local plane; gin: hl
  unsigned char* scratch;  // per-CTA node regions that are not shared
  long long scratch_stride;  // bytes of scratch per CTA
  int B, N, P, V, H, NB, NL, NP;
  int ranks;               // CTAs per graph: one cluster of `ranks` CTAs
  int inc_shift;           // bits of the other endpoint in an entry
  int inc_offset;          // byte offset of the staged lists, 0: global
  int level;               // 0: node regions shared; 1: NF, XB global;
                           // 2: every node-sized region global
  int resident;            // weights staged in shared memory (WR region)
  int wr_offset;           // byte offset of WR in shared memory
};

// Padded shared-memory strides (elements) for hidden width H.
struct Strides {
  int LDF, LDX, LDE, LDV, LDB;
  __host__ __device__ explicit Strides(int H)
      : LDF(2 * H + 4), LDX(2 * H + 8), LDE(H + 8), LDV(H + H / 2 + 4),
        LDB(H + H / 2 + 8) {}
};

__device__ __forceinline__ float bfr(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float b2f(bf16 x) { return __bfloat162float(x); }

// Four consecutive values: f32 in shared memory, f32 weights in global
// memory (read-only path), bf16 in shared memory. Every caller's column is
// a multiple of 4 and every row starts 16-byte aligned.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldb4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void stb4(bf16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
// acc += bf16(t * x), componentwise
__device__ __forceinline__ void add_msg(float4& acc, float4 t, float4 x) {
  acc.x += bfr(t.x * x.x);
  acc.y += bfr(t.y * x.y);
  acc.z += bfr(t.z * x.z);
  acc.w += bfr(t.w * x.w);
}
// max and min that keep NaN, as the reference's relu and clamps do (CUDA's
// fmaxf(NaN, 0.f) is 0, which hid a diverging graph from the sampler's
// guard): PTX max.NaN / min.NaN (sm_80 and later), the bits of fmaxf and
// fminf on every other input. relu(x) is the kernel's relu.
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float fmin_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float relu(float x) { return fmax_nan(x, 0.f); }
// '-approx' (ops/approx.py, same coefficients): max(x, 0) plus a degree-8
// polynomial in min(|x|, 8); sigmoid through an odd Pade [5/4] tanh; a
// NaN goes through both, as through the plain version's torch.clamp.
__device__ __forceinline__ float softplus_approx(float x) {
  const float t = fmin_nan(fabsf(x), 8.f);
  float acc = -5.52531068e-07f;
  acc = acc * t + 2.03902123e-05f;
  acc = acc * t - 3.09991317e-04f;
  acc = acc * t + 2.42865434e-03f;
  acc = acc * t - 9.28887060e-03f;
  acc = acc * t + 3.08196131e-03f;
  acc = acc * t + 1.24495898e-01f;
  acc = acc * t - 5.00341100e-01f;
  acc = acc * t + 6.93209096e-01f;
  return relu(x) + acc;
}
__device__ __forceinline__ float tanh_approx(float x) {
  const float y = fmin_nan(fmax_nan(x, -4.f), 4.f), y2 = y * y;
  const float r = y * (945.f + 105.f * y2 + y2 * y2)
                  / (945.f + 420.f * y2 + 15.f * y2 * y2);
  return fmin_nan(fmax_nan(r, -1.f), 1.f);
}
template <bool APPROX>
__device__ __forceinline__ float softplus_(float x) {
  if (APPROX) return softplus_approx(x);
  return relu(x) + __logf(1.f + __expf(-fabsf(x)));
}
template <bool APPROX>
__device__ __forceinline__ float sigmoid_(float x) {
  if (APPROX) return 0.5f * (1.f + tanh_approx(0.5f * x));
  return 1.f / (1.f + __expf(-x));
}
template <bool APPROX>
__device__ __forceinline__ float ssp(float x, float beta) {
  return softplus_<APPROX>(beta * x) - 0.6931471805599453f;
}
// The score heads' activation on an f32 accumulator: relu, or gelu in
// jax.nn.gelu's tanh form, 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715
// x^3))), with tanhf, or under APPROX with the rational tanh (ops/
// approx.py gelu). NaN goes through both forms.
template <bool GELU, bool APPROX>
__device__ __forceinline__ float head_act(float x) {
  if (!GELU) return relu(x);
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + (APPROX ? tanh_approx(inner) : tanhf(inner)));
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// acc0 (+ acc1, 16 rows further down when `two`) += A @ B over K.
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

// C (f32, ldc) = A1 @ B1 (+ A2 @ B2). A in shared memory (bf16, row-major),
// B in shared or global memory (bf16, row-major K x Nc). M, Nc, K multiples
// of 16. A warp's unit is one 16-column tile of two 16-row tiles, which
// share each B fragment and give the warp two independent mma chains;
// units are dealt to the warps round-robin from warp `wofs` (so two
// products issued back to back land on different warps). Callers
// synchronise.
__device__ void mma_tiles(float* C, int ldc, int M, int Nc,
                          const bf16* A1, int lda1, const bf16* B1, int ldb1,
                          int K1, const bf16* A2 = nullptr, int lda2 = 0,
                          const bf16* B2 = nullptr, int ldb2 = 0,
                          int K2 = 0, int wofs = 0) {
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

// Copies from global memory below read through the read-only path
// (__ldg), so the compiler may issue a thread's loads back to back.

// Cooperative copy of n bf16 (n % 8 == 0, both ends 16-byte aligned).
__device__ void stage(bf16* dst, const bf16* src, int n) {
#pragma unroll 4
  for (int e = threadIdx.x; e < n / 8; e += NTHREADS)
    reinterpret_cast<uint4*>(dst)[e] =
        __ldg(reinterpret_cast<const uint4*>(src) + e);
}

// Cooperative copy of a K x Nc bf16 matrix into rows of Nc + 8 (the
// padded stride wmma reads without bank conflicts). Returns that stride.
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

// C = A @ W for a weight matrix W (K x Nc, global). With a weight region
// WR in shared memory, W is first copied there with coalesced loads, so
// the fragment loads hit shared memory instead of waiting on L2 one
// fragment at a time; without one (large N), fragments load from global.
__device__ void gemm_w(float* C, int ldc, int M, int Nc, const bf16* A,
                       int lda, const bf16* W, int K, bf16* WR) {
  int ldw = Nc;
  if (WR != nullptr) {
    __syncthreads();
    ldw = stage_w(WR, W, K, Nc);
    __syncthreads();
    W = WR;
  }
  mma_tiles(C, ldc, M, Nc, A, lda, W, ldw, K);
}

// TP rows of a (P, C) plane starting at pair p0 into rows of stride ld;
// rows past the plane's end are zero. C % 8 == 0, rows 16-byte aligned.
__device__ void load_rows(bf16* dst, int ld, const bf16* src, int p0,
                          int nrows, int C) {
  const int vpr = C / 8;
  for (int e = threadIdx.x; e < TP * vpr; e += NTHREADS) {
    const int r = e / vpr, v = e % vpr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows)
      val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(p0 + r) * C)
                  + v);
    reinterpret_cast<uint4*>(dst + r * ld)[v] = val;
  }
}

// Each node's incidence entries in the pair tile ending at `pend`: they
// run from the previous tile's end, endq[n], to the first entry at or past
// pend, which becomes the new endq[n] (cur[n] keeps the start). A node's
// entries are sorted by pair, so the tile's are a prefix of the rest: one
// warp per node counts them 32 at a time with a ballot (a node can have
// a whole tile of entries, so a one-thread scan would be a long chain of
// dependent loads). Callers initialise endq[n] = incp[n] and synchronise.
__device__ void tile_cursors(const unsigned* inc, int shift, const int* incp,
                             int* cur, int* endq, int N, int pend) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int n = warp; n < N; n += NWARPS) {
    int q = endq[n];
    const int q0 = q, qe = incp[n + 1];
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

// The first of a rank's contiguous share of `ntiles` tiles (the share of
// rank r runs to split(ntiles, ranks, r + 1); kernels/stack_packed.py
// rank_tiles mirrors this).
__device__ __forceinline__ int split(int ntiles, int ranks, int r) {
  return (int)((long long)ntiles * r / ranks);
}

// A barrier of the whole cluster when a graph has several ranks (release
// and acquire at cluster scope: it orders shared and global writes of
// every CTA of the cluster), else of the block.
__device__ __forceinline__ void ranks_sync(int ranks) {
  if (ranks > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// XB[n][c] = bf16(base[n][c] + sum of NF[n][c] over the ranks of the
// cluster), c < cols, n < rows, base optional (f32, row stride ldb). Each
// rank's NF holds the partial sums of its pair tiles; they are added in
// rank order 0..R-1, so every rank gets the same bits, and at R = 1 the
// sum is NF itself. A peer's NF is read through distributed shared memory
// when NF is shared (level 0), else from the peer's scratch, `stride`
// bytes per rank, through L2 (ld.global.cg: this SM's L1 may hold a stale
// line of it). The caller ends with ranks_sync, so that no rank
// overwrites its NF while a peer still reads it.
__device__ void sum_ranks(bf16* XB, int ldx, const float* base, int ldb,
                          const float* NF, int ldf, int rows, int cols,
                          int ranks, bool glob, long long stride) {
  cg::cluster_group cluster = cg::this_cluster();
  const int me = ranks > 1 ? (int)cluster.block_rank() : 0;
  if (ranks > 1) cluster.sync();
  const int vpr = cols / 4;
  for (int e = threadIdx.x; e < rows * vpr; e += NTHREADS) {
    const int n = e / vpr, c = 4 * (e % vpr);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < ranks; ++r) {
      float4 v;
      if (r == me) {
        v = ld4(NF + n * ldf + c);
      } else if (glob) {
        const float* peer = reinterpret_cast<const float*>(
            reinterpret_cast<const unsigned char*>(NF) + (r - me) * stride);
        v = __ldcg(reinterpret_cast<const float4*>(peer + n * ldf + c));
      } else {
        v = ld4(cluster.map_shared_rank(NF, r) + n * ldf + c);
      }
      if (r == 0) {
        s = v;
      } else {
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
    }
    if (base != nullptr) {
      const float4 h = ld4(base + n * ldb + c);
      s = make_float4(h.x + s.x, h.y + s.y, h.z + s.z, h.w + s.w);
    }
    stb4(XB + n * ldx + c, s);
  }
}

// Bytes of each group of regions (kernels/stack_packed.py region_bytes
// mirrors this): node states and the small per-node arrays, node
// temporaries, and the pair tile. Each group is a multiple of 128 bytes
// except the small arrays, which come last wherever they live.
struct Regions {
  size_t states, small, temps, tile;
  __host__ __device__ Regions(int NP, int H) {
    const Strides S(H);
    states = 2 * (size_t)NP * H * 4;
    small = (4 * (size_t)NP + 1) * 4;
    temps = (size_t)NP * S.LDF * 4 + (size_t)NP * S.LDX * 2;
    tile = (size_t)TP * S.LDE * 2 + (size_t)TP * S.LDV * 4
           + (size_t)TP * S.LDB * 2 + 2 * TP * 4;
  }
  size_t shared(int level) const {
    return tile + (level < 1 ? temps : 0) + (level < 2 ? states + small : 0);
  }
  size_t global(int level) const {
    return (level >= 1 ? temps : 0) + (level >= 2 ? states + small : 0);
  }
};

template <int MODE, bool APPROX, bool GELU>
__global__ void __launch_bounds__(NTHREADS) stack_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  // this CTA is rank `rank` of the `NR` CTAs (one cluster) of graph b
  const int NR = a.ranks;
  const int rank = NR > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int b = blockIdx.x / NR;
  const int H = a.H, N = a.N, NP = a.NP, P = a.P, C = a.H;
  const int F1 = H, F2 = H / 2, FW = F1 + F2, R = H / 16;
  const Strides S(H);
  const int LDF = S.LDF, LDX = S.LDX, LDE = S.LDE, LDV = S.LDV, LDB = S.LDB;

  // carve the regions from shared memory or this CTA's scratch
  unsigned char* sp = smem;
  unsigned char* gp = a.scratch + (size_t)blockIdx.x * a.scratch_stride;
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
  bf16* XB = reinterpret_cast<bf16*>(take(tg, (size_t)NP * LDX * 2));
  bf16* EPT = reinterpret_cast<bf16*>(take(false, TP * LDE * 2));
  float* VF = reinterpret_cast<float*>(take(false, TP * LDV * 4));
  bf16* VB = reinterpret_cast<bf16*>(take(false, TP * LDB * 2));
  float* WE = reinterpret_cast<float*>(take(false, 2 * TP * 4));
  int* cur = reinterpret_cast<int*>(take(sg, (size_t)NP * 4));
  int* endq = reinterpret_cast<int*>(take(sg, (size_t)NP * 4));
  float* gate = reinterpret_cast<float*>(take(sg, (size_t)NP * 4));
  int* incp = reinterpret_cast<int*>(take(sg, ((size_t)NP + 1) * 4));
  // weight region (a.resident): the block's three filter matrices, or one
  // node-side matrix, or one score head's three matrices at a time
  bf16* WR = a.resident
      ? reinterpret_cast<bf16*>(smem + a.wr_offset) : nullptr;

  const int* offs = a.offs;
  const int of_blk = a.NB * W_PER_BLOCK;
  const int obf_gin = of_blk + a.NB * F_PER_BLOCK;
  const int obf_head = obf_gin + a.NL * G_PER_LAYER;
  const int of_gin = obf_head + 2 * S_PER_HEAD;
  const int of_head = of_gin + a.NL * GF_PER_LAYER;

  const unsigned* inc = a.inc;
  if (a.inc_offset) {
    unsigned* staged = reinterpret_cast<unsigned*>(smem + a.inc_offset);
    for (int q = threadIdx.x; q < 2 * a.V; q += NTHREADS) staged[q] = inc[q];
    inc = staged;
  }
  const int shift = a.inc_shift;
  const unsigned omask = (1u << shift) - 1u;
  for (int n = threadIdx.x; n <= NP; n += NTHREADS)
    incp[n] = a.inc_ptr[n < N ? n : N];
  const size_t node_base = (size_t)b * N * H;
  for (int e = threadIdx.x; e < NP * H; e += NTHREADS) {
    const bool real = e / H < N;
    h[e] = real ? a.h0[node_base + e] : 0.f;
    if (MODE != MODE_SCHNET) hl[e] = real ? a.hl0[node_base + e] : 0.f;
  }
  __syncthreads();

  const bf16* epg = a.ep + (size_t)b * P * C;
  const bf16* eplg = a.epl + (size_t)b * P * C;
  // this rank's pair tiles: [vt0, vt1) of the valid pairs' tiles (SchNet
  // and GIN), [pt0, pt1) of every slot's tiles (the heads)
  const int vtiles = (a.V + TP - 1) / TP, ptiles = (P + TP - 1) / TP;
  const int vt0 = split(vtiles, NR, rank), vt1 = split(vtiles, NR, rank + 1);
  const int pt0 = split(ptiles, NR, rank), pt1 = split(ptiles, NR, rank + 1);

  // ---- SchNet interaction blocks ------------------------------------------
  for (int blk = 0; blk < a.NB; ++blk) {
    const int* ob = offs + blk * W_PER_BLOCK;
    const int* of = offs + of_blk + blk * F_PER_BLOCK;
    const bf16* w_fa = a.wbf + ob[W_FA];
    const bf16* w_fb1 = a.wbf + ob[W_FB1];
    const bf16* w_fb2 = a.wbf + ob[W_FB2];
    const bf16* w_l1 = a.wbf + ob[W_L1];
    const bf16* w_l2a = a.wbf + ob[W_L2A];
    const bf16* w_l2b = a.wbf + ob[W_L2B];
    const bf16* w_lin = a.wbf + ob[W_LIN];
    const bf16* w_att0 = a.wbf + ob[W_ATT0];
    const bf16* w_att1 = a.wbf + ob[W_ATT1];
    const bf16* w_se0 = a.wbf + ob[W_SE0];
    const bf16* w_se1 = a.wbf + ob[W_SE1];
    const float* f_ba = a.wf + of[F_BA];
    const float* f_bb = a.wf + of[F_BB];
    const float* f_l1b = a.wf + of[F_L1B];
    const float* f_l2ab = a.wf + of[F_L2AB];
    const float* f_l2bb = a.wf + of[F_L2BB];
    const float* f_linb = a.wf + of[F_LINB];
    const float* f_att0b = a.wf + of[F_ATT0B];
    const float* f_att1b = a.wf + of[F_ATT1B];
    const float beta1 = a.wf[of[F_BETA]], beta2 = a.wf[of[F_BETA] + 1];
    const float act_beta = a.wf[of[F_BETA] + 2];

    // node input x = leaky(h @ [lin1a | lin1b] + b), kept as bf16
    for (int e = threadIdx.x; e < NP * H; e += NTHREADS)
      XB[(e / H) * LDX + e % H] = __float2bfloat16(h[e]);
    __syncthreads();
    gemm_w(NF, LDF, NP, FW, XB, LDX, w_l1, H, WR);
    __syncthreads();
    for (int e = threadIdx.x; e < NP * FW; e += NTHREADS) {
      const int n = e / FW, c = e % FW;
      float v = NF[n * LDF + c] + f_l1b[c];
      v = v > 0.f ? v : 0.2f * v;
      XB[n * LDX + c] = __float2bfloat16(v);
      NF[n * LDF + c] = 0.f;  // aggregation sums start at zero
    }
    for (int n = threadIdx.x; n < N; n += NTHREADS) endq[n] = incp[n];
    const bf16 *b_fa = w_fa, *b_fb1 = w_fb1, *b_fb2 = w_fb2;
    int ld_fa = FW, ld_fb1 = F1, ld_fb2 = F2;
    if (WR != nullptr) {
      bf16* w = WR;
      b_fa = w;
      ld_fa = stage_w(w, w_fa, C, FW);
      w += C * ld_fa;
      b_fb1 = w;
      ld_fb1 = stage_w(w, w_fb1, F1, F1);
      w += F1 * ld_fb1;
      b_fb2 = w;
      ld_fb2 = stage_w(w, w_fb2, F2, F2);
    }
    __syncthreads();
    if (vt0 > 0) {  // each node's cursor from its first entry in this share
      tile_cursors(inc, shift, incp, cur, endq, N, vt0 * TP);
      __syncthreads();
    }

    const float* we1 = a.we + ((size_t)(2 * blk) * a.B + b) * P;
    const float* we2 = a.we + ((size_t)(2 * blk + 1) * a.B + b) * P;
    for (int t = vt0; t < vt1; ++t) {
      const int p0 = t * TP, rows = min(TP, P - p0);
      load_rows(EPT, LDE, epg, p0, rows, C);
      if (threadIdx.x < TP) {
        const int r = threadIdx.x;
        WE[r] = r < rows ? we1[p0 + r] : 0.f;
        WE[TP + r] = r < rows ? we2[p0 + r] : 0.f;
      }
      tile_cursors(inc, shift, incp, cur, endq, N, p0 + TP);
      __syncthreads();
      // filter MLPs: v = ssp(e @ [fa1 | fa2] + ba), t = (v @ fb + bb) * we
      mma_tiles(VF, LDV, TP, FW, EPT, LDE, b_fa, ld_fa, C);
      __syncthreads();
      for (int e = threadIdx.x; e < TP * FW / 4; e += NTHREADS) {
        const int r = e / (FW / 4), c = 4 * (e % (FW / 4));
        const float beta = c < F1 ? beta1 : beta2;
        const float4 v = ld4(VF + r * LDV + c), bias = ldg4(f_ba + c);
        stb4(VB + r * LDB + c,
             make_float4(ssp<APPROX>(v.x + bias.x, beta),
                         ssp<APPROX>(v.y + bias.y, beta),
                         ssp<APPROX>(v.z + bias.z, beta),
                         ssp<APPROX>(v.w + bias.w, beta)));
      }
      __syncthreads();
      mma_tiles(VF, LDV, TP, F1, VB, LDB, b_fb1, ld_fb1, F1);
      mma_tiles(VF + F1, LDV, TP, F2, VB + F1, LDB, b_fb2, ld_fb2, F2,
                nullptr, 0, nullptr, 0, 0, F1 / 16);
      __syncthreads();
      // agg_n += bf16(t_p * x_other) over this tile's pairs incident to n,
      // t_p = (v_p @ fb + bb) * we_p
      for (int e = threadIdx.x; e < N * FW / 4; e += NTHREADS) {
        const int n = e / (FW / 4), c = 4 * (e % (FW / 4));
        const float* wep = WE + (c < F1 ? 0 : TP);
        const float4 bias = ldg4(f_bb + c);
        float4 acc = ld4(NF + n * LDF + c);
        const int qe = endq[n];
#pragma unroll 4
        for (int q = cur[n]; q < qe; ++q) {
          const unsigned iq = inc[q];
          const int lp = (int)(iq >> shift) - p0, o = iq & omask;
          const float w = wep[lp];
          const float4 v = ld4(VF + lp * LDV + c);
          add_msg(acc,
                  make_float4((v.x + bias.x) * w, (v.y + bias.y) * w,
                              (v.z + bias.z) * w, (v.w + bias.w) * w),
                  ldb4(XB + o * LDX + c));
        }
        st4(NF + n * LDF + c, acc);
      }
      __syncthreads();
    }

    // node tail: lin2, ssp(act_beta), lin, attention gate, SE gate,
    // residual, on the sums of every rank's pairs
    sum_ranks(XB, LDX, nullptr, 0, NF, LDF, NP, FW, NR, tg, a.scratch_stride);
    ranks_sync(NR);
    gemm_w(NF, LDF, NP, H, XB, LDX, w_l2a, F1, WR);
    gemm_w(NF + H, LDF, NP, H, XB + F1, LDX, w_l2b, F2, WR);
    __syncthreads();
    for (int e = threadIdx.x; e < NP * 2 * H; e += NTHREADS) {
      const int n = e / (2 * H), c = e % (2 * H);
      const float v = NF[n * LDF + c] + (c < H ? f_l2ab[c] : f_l2bb[c - H]);
      XB[n * LDX + c] = __float2bfloat16(ssp<APPROX>(v, act_beta));
    }
    __syncthreads();
    gemm_w(NF, LDF, NP, H, XB, LDX, w_lin, 2 * H, WR);
    __syncthreads();
    for (int e = threadIdx.x; e < NP * H; e += NTHREADS) {
      const int n = e / H, c = e % H;
      const float v = NF[n * LDF + c] + f_linb[c];
      NF[n * LDF + c] = v;
      XB[n * LDX + c] = __float2bfloat16(v);
    }
    __syncthreads();
    gemm_w(NF + H, LDF, NP, H / 2, XB, LDX, w_att0, H, WR);
    __syncthreads();
    // the gate and SE weights are small; stage them together, unpadded
    const bf16 *s_att1 = w_att1, *s_se0 = w_se0, *s_se1 = w_se1;
    if (WR != nullptr) {
      s_att1 = WR;
      s_se0 = WR + H / 2;
      s_se1 = s_se0 + H * R;
      stage(const_cast<bf16*>(s_att1), w_att1, H / 2);
      stage(const_cast<bf16*>(s_se0), w_se0, H * R);
      stage(const_cast<bf16*>(s_se1), w_se1, R * H);
      __syncthreads();
    }
    {
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      for (int n = warp; n < NP; n += NWARPS) {
        float s = 0.f;
        for (int k = lane; k < H / 2; k += 32)
          s += bfr(relu(NF[n * LDF + H + k] + f_att0b[k]))
               * b2f(s_att1[k]);
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) gate[n] = sigmoid_<APPROX>(s + f_att1b[0]);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < NP * H; e += NTHREADS) {
      const int n = e / H, c = e % H;
      const float v = NF[n * LDF + c] * gate[n];
      NF[n * LDF + c] = v;
      XB[n * LDX + c] = __float2bfloat16(v);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < NP * R; e += NTHREADS) {
      const int n = e / R, k = e % R;
      float s = 0.f;
      for (int c = 0; c < H; ++c)
        s += b2f(XB[n * LDX + c]) * b2f(s_se0[c * R + k]);
      NF[n * LDF + H + k] = bfr(relu(s));
    }
    __syncthreads();
    for (int e = threadIdx.x; e < NP * H; e += NTHREADS) {
      const int n = e / H, c = e % H;
      float s = 0.f;
      for (int k = 0; k < R; ++k)
        s += NF[n * LDF + H + k] * b2f(s_se1[k * H + c]);
      h[e] += NF[n * LDF + c] * sigmoid_<APPROX>(s);
    }
    __syncthreads();
  }

  // every rank holds the same h and hl (the same bits from the same sums)
  if (MODE == MODE_SCHNET) {
    if (rank == 0)
      for (int e = threadIdx.x; e < N * H; e += NTHREADS)
        a.out0[node_base + e] = h[e];
    return;
  }

  // ---- GIN layers -----------------------------------------------------------
  const float* lmg = a.lm + (size_t)b * P;
  for (int li = 0; li < a.NL; ++li) {
    const bf16* w_g0 = a.wbf + offs[obf_gin + li * G_PER_LAYER + G_L0];
    const bf16* w_g1 = a.wbf + offs[obf_gin + li * G_PER_LAYER + G_L1];
    const float* f_g0 = a.wf + offs[of_gin + li * GF_PER_LAYER + GF_B0];
    const float* f_g1 = a.wf + offs[of_gin + li * GF_PER_LAYER + GF_B1];
    // agg_n = sum over incident pairs of bf16(relu((hl_other + e_p) m_p)),
    // over pair tiles of the local edge features, in increasing pair order
    for (int e = threadIdx.x; e < NP * H; e += NTHREADS)
      NF[(e / H) * LDF + e % H] = 0.f;
    for (int n = threadIdx.x; n < N; n += NTHREADS) endq[n] = incp[n];
    __syncthreads();
    if (vt0 > 0) {
      tile_cursors(inc, shift, incp, cur, endq, N, vt0 * TP);
      __syncthreads();
    }
    for (int t = vt0; t < vt1; ++t) {
      const int p0 = t * TP, rows = min(TP, P - p0);
      load_rows(EPT, LDE, eplg, p0, rows, C);
      if (threadIdx.x < TP)
        WE[threadIdx.x] = threadIdx.x < rows ? lmg[p0 + threadIdx.x] : 0.f;
      tile_cursors(inc, shift, incp, cur, endq, N, p0 + TP);
      __syncthreads();
      for (int e = threadIdx.x; e < N * H / 4; e += NTHREADS) {
        const int n = e / (H / 4), c = 4 * (e % (H / 4));
        float4 acc = ld4(NF + n * LDF + c);
        const int qe = endq[n];
#pragma unroll 4
        for (int q = cur[n]; q < qe; ++q) {
          const unsigned iq = inc[q];
          const int lp = (int)(iq >> shift) - p0, o = iq & omask;
          const float m = WE[lp];
          const float4 x = ld4(hl + o * H + c), ev = ldb4(EPT + lp * LDE + c);
          acc.x += bfr(relu((bfr(x.x) + ev.x) * m));
          acc.y += bfr(relu((bfr(x.y) + ev.y) * m));
          acc.z += bfr(relu((bfr(x.z) + ev.z) * m));
          acc.w += bfr(relu((bfr(x.w) + ev.w) * m));
        }
        st4(NF + n * LDF + c, acc);
      }
      __syncthreads();
    }
    sum_ranks(XB, LDX, hl, H, NF, LDF, NP, H, NR, tg, a.scratch_stride);
    ranks_sync(NR);
    gemm_w(NF, LDF, NP, H, XB, LDX, w_g0, H, WR);
    __syncthreads();
    for (int e = threadIdx.x; e < NP * H; e += NTHREADS) {
      const int n = e / H, c = e % H;
      XB[n * LDX + c] = __float2bfloat16(relu(NF[n * LDF + c] + f_g0[c]));
    }
    __syncthreads();
    gemm_w(NF, LDF, NP, H, XB, LDX, w_g1, H, WR);
    __syncthreads();
    for (int e = threadIdx.x; e < NP * H; e += NTHREADS) {
      const int n = e / H, c = e % H;
      float v = NF[n * LDF + c] + f_g1[c];
      if (li < a.NL - 1) v = relu(v);
      hl[e] += v;
    }
    __syncthreads();
  }

  if (MODE == MODE_GIN) {
    if (rank == 0)
      for (int e = threadIdx.x; e < N * H; e += NTHREADS) {
        a.out0[node_base + e] = h[e];
        a.out1[node_base + e] = hl[e];
      }
    return;
  }

  // ---- pair-score heads -------------------------------------------------------
  for (int head = 0; head < 2; ++head) {
    const float* hs = head == 0 ? h : hl;
    const bf16* eg = head == 0 ? epg : eplg;
    float* out = (head == 0 ? a.out0 : a.out1) + (size_t)b * P;
    const int* ob = offs + obf_head + head * S_PER_HEAD;
    const int* of = offs + of_head + head * SF_PER_HEAD;
    const bf16* w_w1h = a.wbf + ob[S_W1H];
    const bf16* w_w1e = a.wbf + ob[S_W1E];
    const bf16* w_w2 = a.wbf + ob[S_W2];
    const float* f_b1 = a.wf + of[SF_B1];
    const float* f_b2 = a.wf + of[SF_B2];
    const float* f_w3 = a.wf + of[SF_W3];
    const float b3 = a.wf[of[SF_B3]];
    const bf16 *b_w1h = w_w1h, *b_w1e = w_w1e, *b_w2 = w_w2;
    int ld_w1 = H, ld_w2 = H / 2;
    if (WR != nullptr) {
      bf16* w = WR;
      b_w1h = w;
      ld_w1 = stage_w(w, w_w1h, H, H);
      w += H * ld_w1;
      b_w1e = w;
      stage_w(w, w_w1e, C, H);
      w += C * ld_w1;
      b_w2 = w;
      ld_w2 = stage_w(w, w_w2, H, H / 2);
    }
    for (int e = threadIdx.x; e < NP * H; e += NTHREADS)
      XB[(e / H) * LDX + e % H] = __float2bfloat16(hs[e]);
    __syncthreads();
    for (int t = pt0; t < pt1; ++t) {
      const int p0 = t * TP, rows = min(TP, P - p0);
      load_rows(EPT, LDE, eg, p0, rows, C);
      for (int e = threadIdx.x; e < TP * H / 4; e += NTHREADS) {
        const int r = e / (H / 4), c = 4 * (e % (H / 4));
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < rows) {
          const int i = (int)a.pi[p0 + r], j = (int)a.pj[p0 + r];
          const float4 xi = ldb4(XB + i * LDX + c), xj = ldb4(XB + j * LDX + c);
          v = make_float4(xi.x * xj.x, xi.y * xj.y, xi.z * xj.z, xi.w * xj.w);
        }
        stb4(VB + r * LDB + c, v);
      }
      __syncthreads();
      mma_tiles(VF, LDV, TP, H, VB, LDB, b_w1h, ld_w1, H, EPT, LDE, b_w1e,
                ld_w1, C);
      __syncthreads();
      for (int e = threadIdx.x; e < TP * H / 4; e += NTHREADS) {
        const int r = e / (H / 4), c = 4 * (e % (H / 4));
        const float4 v = ld4(VF + r * LDV + c), bias = ldg4(f_b1 + c);
        stb4(VB + r * LDB + c,
             make_float4(head_act<GELU, APPROX>(v.x + bias.x),
                         head_act<GELU, APPROX>(v.y + bias.y),
                         head_act<GELU, APPROX>(v.z + bias.z),
                         head_act<GELU, APPROX>(v.w + bias.w)));
      }
      __syncthreads();
      mma_tiles(VF, LDV, TP, H / 2, VB, LDB, b_w2, ld_w2, H);
      __syncthreads();
      {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        for (int r = warp; r < rows; r += NWARPS) {
          float s = 0.f;
          for (int k = lane; k < H / 2; k += 32)
            s += head_act<GELU, APPROX>(VF[r * LDV + k] + f_b2[k])
                 * f_w3[k];
          for (int o = 16; o > 0; o >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
          if (lane == 0) out[p0 + r] = s + b3;
        }
      }
      __syncthreads();
    }
  }
}

// The weight region holds the largest set staged at once, at padded row
// strides: the filter trio (C x FW, F1 x F1, F2 x F2), a score head
// (H x H, C x H, H x H/2), or one node-side matrix (lin: 2H x H).
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

template <int MODE, bool GELU = false>
static KernelFn pick(int approx) {
  return approx ? stack_kernel<MODE, true, GELU>
                : stack_kernel<MODE, false, GELU>;
}

// mode: 0 schnet, 1 gin, 2 full; approx: 0 or 1; gelu: 1 for gelu score
// heads (mode 'full' only: the other modes stop before the heads, and
// their instantiations take gelu = 0). out0/out1 as in Args;
// scratch holds scratch_stride bytes per CTA (B x ranks of them) for the
// regions `level` moves to global memory (kernels/stack_packed.py layout
// chooses both). V valid pairs come first in the list; inc holds their 2V
// entries. One launch of B clusters of `ranks` CTAs (kernels/
// stack_packed.py ranks_for chooses it), or at ranks = 1 of B CTAs with
// no cluster attribute. A cluster size the card cannot launch returns an
// error.
extern "C" int stack_launch(
    int mode, int approx, int gelu, const void* ep, const void* epl,
    const void* we, const void* h0, const void* hl0, const void* lm,
    const void* pi, const void* pj, const void* inc_ptr, const void* inc,
    const void* wbf, const void* wf, const void* offs,
    void* out0, void* out1, void* scratch, long long scratch_stride, int B,
    int N, int P, int V, int inc_shift, int H, int NB, int NL, int level,
    int ranks, void* stream) {
  Args a;
  a.ep = static_cast<const bf16*>(ep);
  a.epl = static_cast<const bf16*>(epl);
  a.we = static_cast<const float*>(we);
  a.h0 = static_cast<const float*>(h0);
  a.hl0 = static_cast<const float*>(hl0);
  a.lm = static_cast<const float*>(lm);
  a.pi = static_cast<const long long*>(pi);
  a.pj = static_cast<const long long*>(pj);
  a.inc_ptr = static_cast<const int*>(inc_ptr);
  a.inc = static_cast<const unsigned*>(inc);
  a.wbf = static_cast<const bf16*>(wbf);
  a.wf = static_cast<const float*>(wf);
  a.offs = static_cast<const int*>(offs);
  a.out0 = static_cast<float*>(out0);
  a.out1 = static_cast<float*>(out1);
  a.scratch = static_cast<unsigned char*>(scratch);
  a.scratch_stride = scratch_stride;
  a.B = B; a.N = N; a.P = P; a.V = V; a.H = H; a.NB = NB; a.NL = NL;
  a.inc_shift = inc_shift;
  a.NP = (N + 15) / 16 * 16;
  a.level = level;
  a.ranks = ranks;
  const Regions rg(a.NP, H);
  if (mode < 0 || mode > 2 || level < 0 || level > 2 || H % 32 != 0
      || (gelu && mode != MODE_FULL)
      || ranks < 1
      || V > P || inc_shift < 1 || inc_shift > 31
      || (size_t)scratch_stride < rg.global(level)
      || (level > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t base = (rg.shared(level) + 127) / 128 * 128;
  const size_t wr = weight_region_bytes(H);
  if (rg.shared(level) > MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  a.resident = base + wr <= MAX_SMEM_BYTES;
  a.wr_offset = (int)base;
  size_t smem = a.resident ? base + wr : rg.shared(level);
  const size_t inc_off = (smem + 15) / 16 * 16;
  a.inc_offset = 0;
  if (inc_off + 8 * (size_t)V <= MAX_SMEM_BYTES) {
    a.inc_offset = (int)inc_off;
    smem = inc_off + 8 * (size_t)V;
  }
  const KernelFn fn = mode == MODE_SCHNET ? pick<MODE_SCHNET>(approx)
                      : mode == MODE_GIN  ? pick<MODE_GIN>(approx)
                      : gelu              ? pick<MODE_FULL, true>(approx)
                                          : pick<MODE_FULL>(approx);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ranks == 1) {  // one CTA per graph: no cluster to ask for
    fn<<<B, NTHREADS, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * ranks);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // whether a cluster fits depends only on the card, the kernel, its
  // shared memory and the cluster size: ask once for each
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  static std::map<std::tuple<int, KernelFn, size_t, int>, int> known;
  const auto key = std::make_tuple(device, fn, smem, ranks);
  auto hit = known.find(key);
  if (hit == known.end()) {
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
    if (err != cudaSuccess) return (int)err;
    hit = known.emplace(key, n).first;
  }
  if (hit->second < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, fn, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* stack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
