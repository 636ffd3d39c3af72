// K3, K4 and K5 on Hopper: the dense-layout (B, N, N, C) edge consumers
// of engine 'pallas'. Each replaces a TPU kernel of
// agdiff_tpu/ops/pallas/fused.py:
//   K3 block_agg_kernel   <- _block_agg_kernel (:181): both CFConv filter
//      MLPs of one interaction block on every ordered pair, times the
//      distance-weight planes, aggregated against the node inputs:
//      out[b, i, f] = sum_j t(e_ij)[f] w_ij h_j[f];
//   K4 pair_score_kernel  <- _pair_score_kernel (:82): the pair-score MLP
//      on every ordered pair, MLP3(concat(h_i h_j, e_ij)), zero off the
//      mask, with relu or (GELU) gelu activations;
//   K5 gine_kernel        <- _gine_kernel (:142): the GINE aggregation
//      sum_j mask_ij relu(x_j + e_ij), in f32.
// The functions and where their operands round are documented beside the
// wrappers (kernels/fused.py).
//
// Design. K4: R blocks of TC_THREADS per graph (R from the occupancy
// query: one at B = 128, more for fewer graphs). Every block of a graph
// lists the graph's masked cells (i N + j, row-major) with a ballot of 32
// cells a warp and a scan of the words' counts, in shared memory where the
// list fits (else in the wrapper's scratch), writes 0 to its share of the
// cells off the list, and takes 64-pair (bf16) or 32-pair (f32) tiles r,
// r + R, ... of the list: (i, j) and (j, i) are separate entries (neither
// the mask nor e is symmetric), and each cell is written by one block, in
// one order, so the bits do not depend on R. At bf16 a tile [bf16(h_i h_j)
// | e_ij] (the product from the graph's h, staged once; e gathered a
// 256-byte row at a time in 16-byte loads) runs both layers on the tensor
// cores (filter_mlp.cuh tc_unit, mma.sync.m16n8k16) with w1 and w2 packed
// and staged once per block (level 0; level 1 reads them from L2), relu or
// gelu epilogues on the accumulators, and the head (times w3, a quad's
// shuffles, then the strips of a row in strip order) in f32. At f32 the
// tile is k-major in shared memory and each layer runs 4 x 2 register
// units of f32 fused multiply-adds on CUDA cores, k in increasing order,
// and the head is one warp a row (a lane-strided sum and a butterfly):
// the one-block-per-row form's order for every sum of a pair, so its
// bits; w1 and w2 are staged once per block (level 0), w1 only (1) or
// neither (2). K3, both forms: a
// persistent grid of as many blocks of TC_THREADS as the card holds at
// once (one an SM at the default widths), each walking a contiguous share
// of the groups of node rows. At bf16 a group is two rows, one 64-pair
// tile, at N = 32, through filter_tile_tc on the tensor cores, with the
// packed filter weights staged once per block (layout level 0; level 1,
// for C above 288 at F1 = 128, F2 = 64, reads them from L2). At f32 a
// group is two rows, one 64-pair tile, at N = 32, through register units
// of f32 fused multiply-adds on CUDA cores (no TF32), with fa and fb1
// staged once per block (level 0; level 1 fa only; level 2 neither; level
// 3, 32-pair tiles, takes the widths and C the others do not). K3 sums
// each column f of a row in one thread, over j in increasing order, and
// every product over k in increasing order, so the result reproduces bit
// for bit at any grid and level, and at f32 the one-block-per-row form's
// bits. K5 is a streaming pass: one thread per four columns of a row
// (b, i), over j in increasing order.
//
// Bounds at B = 128, N = 32, C = H = 128 (chip_smoke.py computes them from
// each run's shapes): K3 does ~12 GFLOP a launch; at f32 on CUDA cores
// (67 TFLOP/s) it is bound by operations, ~0.18 ms; at bf16 by the bytes,
// ~0.012 ms (the 33.5 MB of edge features). K4 counts its masked pairs
// only: with every real pair masked (46848 of 131072 cells) 3.85 GFLOP,
// bound by operations at f32 (0.058 ms) and by bytes at bf16 (0.004 ms,
// 13.8 MB). On an H100 80GB HBM3 at 700 W it reads 0.227 ms (f32) and
// 0.055 ms (bf16) behind a card spin (PERF.md): one block a graph at B =
// 128 makes the largest graph's tiles (16 f32 tiles for 23 atoms; the
// mean is 11.75) the critical path; at f32 the first layer takes 0.65 of
// a block's cycles (no register-unit shape read faster), at bf16 the
// gathered tile load (0.38) waits un-overlapped beside the products
// (0.37 + 0.15). K3 bf16 runs ~15x above its bound: a block's
// cycles go to the first layer's products and its softplus (~0.47),
// the second layer (~0.20), the tile load (~0.19) and the aggregation
// (~0.14) (PERF.md, chip_stamps.py); mma.sync leaves the products
// latency-bound at 16 warps an SM, the tile load is not overlapped (a
// cp.async ring measured no faster), and wgmma is the next step. K5
// reads 67 MB of f32 edge features for ~50
// MFLOP: bound by bytes, ~0.02 ms.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (kernels/build.py).

#include <type_traits>

#include "filter_mlp.cuh"

// K4's activation on an f32 accumulator: relu, or gelu in jax.nn.gelu's
// tanh form with tanhf (the TPU kernel's _act("gelu"), fused.py:62-64);
// NaN goes through both
template <bool GELU>
__device__ __forceinline__ float head_act(float x) {
  if (!GELU) return relu(x);
  return 0.5f * x * (1.f + tanhf(0.7978845608028654f
                                 * (x + 0.044715f * x * x * x)));
}

// ---- K3 --------------------------------------------------------------------

template <typename T>
struct BlockAggArgs {
  const T* e;              // (B, N, N, C) edge features
  const float* w1;         // (B, N, N) distance weight x envelope x mask
  const float* w2;
  const float* h1;         // (B, N, F1) node inputs of conv 1
  const float* h2;         // (B, N, F2) node inputs of conv 2
  FilterW<T> fw;
  FilterTC tc;             // bf16: the packed weights, biases and betas
  float* out1;             // (B, N, F1)
  float* out2;             // (B, N, F2)
  int B, N;
};

// The f32 form (kernels/fused.py block_agg_smem_f32 and f32_one_pass
// mirror its sizes). Levels 0-2 take F32_ROWS = 64 pairs a tile and keep
// each layer's results in registers until the whole block has read the
// layer's operand, so that E, V and Tt share one region (one pass of
// units a layer); level 3 takes 32 pairs, with V in a region of its own
// and any number of passes (the widths and C the one-pass levels do not
// take). Shared memory: [fa = fa1 | fa2, C x F6 (levels 0, 1)] [fb1, F1 x
// F1 (level 0)] [E | V | Tt, or E | Tt then V] [w1, w2 of the tile]; F6
// is F1 + F2 rounded up to 6 (zero columns), E k-major C x (R + 4), V
// k-major FW x (R + 4), Tt row-major R x (FW + 4). fb2, and fa and fb1
// where they are not staged, are read through L1.
#define F32_ROWS 64
__host__ __device__ inline int f32_rows(int level) {
  return level < 3 ? F32_ROWS : FT_ROWS;
}
__host__ __device__ inline int f32_f6(int F1, int F2) {
  return (F1 + F2 + 5) / 6 * 6;
}
// warp tiles of a layer at R pairs a tile (8 row groups of F32_RU rows by
// 4 column groups a warp): layer 1 (units 4 x 6), and fb1 (4 x 4) and fb2
// (4 x 2) of layer 2. Larger units spill at 512 threads (128 registers).
#define F32_RU 4
__host__ __device__ inline int f32_tiles1(int R, int F1, int F2) {
  return R / (8 * F32_RU) * ((f32_f6(F1, F2) + 23) / 24);
}
__host__ __device__ inline int f32_tiles2(int R, int F1, int F2) {
  const int wtr = R / (8 * F32_RU);
  const int a = wtr * ((F1 + 15) / 16), b = wtr * ((F2 + 7) / 8);
  return a > b ? a : b;
}
__host__ __device__ inline size_t f32_r1_bytes(int C, int FW, int level) {
  const int R = f32_rows(level);
  size_t m = (size_t)C * (R + 4);
  const size_t t = (size_t)R * (FW + 4), v = (size_t)FW * (R + 4);
  m = m > t ? m : t;
  if (level < 3) m = m > v ? m : v;
  return 4 * m;
}

// acc[i][j] += sum_k A[k][r0 + i] W[k][j] (i < RU, j < CU), k in
// increasing order, fused multiply-adds: A k-major in shared memory
// (stride lda), W row-major (stride ldw) at the unit's first column, in
// shared memory or (GLOBAL) read through L1. RU is a multiple of 4; CU = 6
// (three float2 loads), 4 or 2.
template <int RU, int CU, bool GLOBAL>
__device__ __forceinline__ void unit_fma(const float* A, int lda,
                                         const float* W, int ldw, int K,
                                         int r0, float acc[RU][CU]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[RU], w[CU];
#pragma unroll
    for (int i = 0; i < RU; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(A + k * lda + r0 + i);
      a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
    }
    const float* wk = W + (size_t)k * ldw;
    if constexpr (CU == 4) {
      const float4 v = GLOBAL ? __ldg(reinterpret_cast<const float4*>(wk))
                              : *reinterpret_cast<const float4*>(wk);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < CU; j += 2) {
        const float2 v =
            GLOBAL ? __ldg(reinterpret_cast<const float2*>(wk + j))
                   : *reinterpret_cast<const float2*>(wk + j);
        w[j] = v.x;
        w[j + 1] = v.y;
      }
    }
#pragma unroll
    for (int i = 0; i < RU; ++i)
#pragma unroll
      for (int j = 0; j < CU; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
}

// f32 on CUDA cores, true f32 (no TF32): a persistent block walks its
// contiguous share of the groups of node rows (block_agg_groups at R rows
// a tile), as the bf16 form does. Per tile:
//   layer 1, V = ssp(E @ [fa1 | fa2] + ba) (units of RU rows x 6
//     columns);
//   layer 2, Tt = [V1 @ fb1 + bb1 | V2 @ fb2 + bb2] (RU x 4 and RU x 2);
//   each output (b, i, f) summed by one thread over j in increasing order;
// a warp's units are 8 row groups (lane & 7) by 4 column groups
// (lane >> 3). The next tile's edge features load into registers under
// the second layer and the aggregation. Every product takes k in
// increasing order from 0 and the sums take j in increasing order, as the
// one-block-per-row form did: the same bits. LEVEL 0 stages fa and fb1
// once per block, 1 fa only; 2 and 3 read fa column by column from fa1,
// fa2 through L1.
template <int LEVEL>
__device__ void block_agg_f32(const BlockAggArgs<float>& a, char* smem) {
  constexpr bool ALIAS = LEVEL < 3;
  constexpr int R = ALIAS ? F32_ROWS : FT_ROWS, LDA = R + 4;
  constexpr int RU = F32_RU;
  constexpr int PF = 4;   // float4 loads a thread holds for the next tile
  const int C = a.fw.C, F1 = a.fw.F1, F2 = a.fw.F2, FW = F1 + F2;
  const int F6 = f32_f6(F1, F2), N = a.N, ldt = FW + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = TC_THREADS / 32, wtr = R / (8 * RU);
  char* p = smem;
  float* fa_s = reinterpret_cast<float*>(p);
  if (LEVEL <= 1) p += 4 * (size_t)C * F6;
  float* fb1_s = reinterpret_cast<float*>(p);
  if (LEVEL == 0) p += 4 * (size_t)F1 * F1;
  float* E = reinterpret_cast<float*>(p);
  float* Tt = E;
  p += f32_r1_bytes(C, FW, LEVEL);
  float* V = ALIAS ? E : reinterpret_cast<float*>(p);
  if (!ALIAS) p += 4 * (size_t)FW * LDA;
  float* Wt = reinterpret_cast<float*>(p);
  if (LEVEL <= 1)
    for (int q = threadIdx.x; q < C * F6; q += TC_THREADS) {
      const int k = q / F6, c = q % F6;
      fa_s[q] = c < F1 ? a.fw.fa1[(size_t)k * F1 + c]
                       : c < FW ? a.fw.fa2[(size_t)k * F2 + c - F1] : 0.f;
    }
  if (LEVEL == 0)
    for (int q = threadIdx.x; q < F1 * F1; q += TC_THREADS)
      fb1_s[q] = a.fw.fb1[q];
  const float beta1 = *a.fw.beta1, beta2 = *a.fw.beta2;
  const int rows_total = a.B * N;
  const int rpg = N <= R ? R / N : 1;
  const int tiles = N <= R ? 1 : (N + R - 1) / R;
  const int groups = (rows_total + rpg - 1) / rpg;
  const int per = groups / gridDim.x, extra = groups % gridDim.x;
  const int g0 = blockIdx.x * per + min((int)blockIdx.x, extra);
  const int g1 = g0 + per + ((int)blockIdx.x < extra ? 1 : 0);
  const int n1 = f32_tiles1(R, F1, F2), n2 = f32_tiles2(R, F1, F2);
  const int n2a = wtr * ((F1 + 15) / 16), n2b = wtr * ((F2 + 7) / 8);
  const int C4 = C / 4;
  const bool prefetch = R * C4 <= PF * TC_THREADS;
  // the tile (grp, tile) k-major into E (rows across lanes, zero rows past
  // `rows`), through registers (pf) when `prefetch`
  float4 pf[PF];
  float pw = 0.f;   // thread t < 2R: w1 (t < R) or w2 of row t % R
  auto fetch = [&](int grp, int tile) {
    const int row0 = grp * rpg, nrows = min(rpg, rows_total - row0);
    const int rows = N <= R ? nrows * N : min(R, N - tile * R);
    const size_t q0 = (size_t)row0 * N + tile * R;
    const float* src = a.e + q0 * C;
    if (threadIdx.x < 2 * R) {
      const int r = threadIdx.x % R;
      pw = r < rows ? (threadIdx.x < R ? a.w1 : a.w2)[q0 + r] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      const int q = threadIdx.x + u * TC_THREADS, r = q % R, k = 4 * (q / R);
      pf[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < R * C4 && r < rows)
        pf[u] = __ldg(reinterpret_cast<const float4*>(src + (size_t)r * C + k));
    }
  };
  auto put = [&]() {
    if (threadIdx.x < 2 * R) Wt[threadIdx.x] = pw;
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      const int q = threadIdx.x + u * TC_THREADS, r = q % R, k = 4 * (q / R);
      if (q < R * C4) {
        E[k * LDA + r] = pf[u].x;
        E[(k + 1) * LDA + r] = pf[u].y;
        E[(k + 2) * LDA + r] = pf[u].z;
        E[(k + 3) * LDA + r] = pf[u].w;
      }
    }
  };
  if (prefetch && g0 < g1) {
    fetch(g0, 0);
    put();
  }
  float carry = 0.f;   // N > R: thread f's sum over earlier tiles
  for (int grp = g0; grp < g1; ++grp) {
    const int row0 = grp * rpg, nrows = min(rpg, rows_total - row0);
    for (int tile = 0; tile < tiles; ++tile) {
      const int j0 = tile * R;
      const int rows = N <= R ? nrows * N : min(R, N - j0);
      const size_t q0 = (size_t)row0 * N + j0;
      if (!prefetch) {
        const float* src = a.e + q0 * C;
        for (int q = threadIdx.x; q < R * C4; q += TC_THREADS) {
          const int r = q % R, k = 4 * (q / R);
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < rows)
            v = __ldg(reinterpret_cast<const float4*>(src + (size_t)r * C + k));
          E[k * LDA + r] = v.x;
          E[(k + 1) * LDA + r] = v.y;
          E[(k + 2) * LDA + r] = v.z;
          E[(k + 3) * LDA + r] = v.w;
        }
        for (int r = threadIdx.x; r < R; r += TC_THREADS) {
          Wt[r] = r < rows ? a.w1[q0 + r] : 0.f;
          Wt[R + r] = r < rows ? a.w2[q0 + r] : 0.f;
        }
      }
      __syncthreads();
      for (int ps = 0; ps * nwarps < n1; ++ps) {
        const int wt = warp + ps * nwarps;
        const int r0 = RU * ((wt % wtr) * 8 + (lane & 7));
        const int c0 = 6 * ((wt / wtr) * 4 + (lane >> 3));
        const bool on = wt < n1 && c0 < F6;
        float acc[RU][6] = {};
        if (on) {
          if (LEVEL <= 1) {
            unit_fma<RU, 6, false>(E, LDA, fa_s + c0, F6, C, r0, acc);
          } else {   // fa1, fa2 through L1, column by column
            const float* col[6];
            int ld[6];
#pragma unroll
            for (int j = 0; j < 6; ++j) {
              const int c = min(c0 + j, FW - 1);
              col[j] = c < F1 ? a.fw.fa1 + c : a.fw.fa2 + (c - F1);
              ld[j] = c < F1 ? F1 : F2;
            }
#pragma unroll 2
            for (int k = 0; k < C; ++k) {
              float av[RU];
#pragma unroll
              for (int i = 0; i < RU; i += 4) {
                const float4 v =
                    *reinterpret_cast<const float4*>(E + k * LDA + r0 + i);
                av[i] = v.x; av[i + 1] = v.y; av[i + 2] = v.z;
                av[i + 3] = v.w;
              }
#pragma unroll
              for (int j = 0; j < 6; ++j) {
                const float w = __ldg(col[j] + (size_t)k * ld[j]);
#pragma unroll
                for (int i = 0; i < RU; ++i)
                  acc[i][j] = fmaf(av[i], w, acc[i][j]);
              }
            }
          }
        }
        if (ALIAS) __syncthreads();   // every unit has read E
        if (on) {
#pragma unroll
          for (int j = 0; j < 6; ++j) {
            const int c = c0 + j;
            if (c >= FW) break;
            const bool first = c < F1;
            const float ba = first ? a.fw.ba1[c] : a.fw.ba2[c - F1];
            const float beta = first ? beta1 : beta2;
#pragma unroll
            for (int i = 0; i < RU; i += 4) {
              float v[4];
#pragma unroll
              for (int u = 0; u < 4; ++u)
                v[u] = rnd<float>(
                    softplus_<false>(beta * (acc[i + u][j] + ba)) - FT_LN2);
              *reinterpret_cast<float4*>(V + c * LDA + r0 + i) =
                  make_float4(v[0], v[1], v[2], v[3]);
            }
          }
        }
      }
      __syncthreads();
      // the next tile's edge features, under the second layer
      const bool more = tile + 1 < tiles || grp + 1 < g1;
      if (prefetch && more)
        fetch(tile + 1 < tiles ? grp : grp + 1,
              tile + 1 < tiles ? tile + 1 : 0);
      for (int ps = 0; ps * nwarps < n2; ++ps) {
        const int wt = warp + ps * nwarps;
        const int r0 = RU * ((wt % wtr) * 8 + (lane & 7));
        const int cg = (wt / wtr) * 4 + (lane >> 3);
        const bool on1 = wt < n2a && 4 * cg < F1;
        const bool on2 = wt < n2b && 2 * cg < F2;
        float acc1[RU][4] = {}, acc2[RU][2] = {};
        if (on1)
          unit_fma<RU, 4, LEVEL != 0>(V, LDA,
                                      (LEVEL == 0 ? fb1_s : a.fw.fb1) + 4 * cg,
                                      F1, F1, r0, acc1);
        if (on2)
          unit_fma<RU, 2, true>(V + F1 * LDA, LDA, a.fw.fb2 + 2 * cg, F2, F2,
                                r0, acc2);
        if (ALIAS) __syncthreads();   // every unit has read V
        if (on1) {
          const int c0 = 4 * cg;
#pragma unroll
          for (int i = 0; i < RU; ++i)
            *reinterpret_cast<float4*>(Tt + (r0 + i) * ldt + c0) =
                make_float4(acc1[i][0] + a.fw.bb1[c0],
                            acc1[i][1] + a.fw.bb1[c0 + 1],
                            acc1[i][2] + a.fw.bb1[c0 + 2],
                            acc1[i][3] + a.fw.bb1[c0 + 3]);
        }
        if (on2) {
          const int c0 = 2 * cg;
#pragma unroll
          for (int i = 0; i < RU; ++i)
            *reinterpret_cast<float2*>(Tt + (r0 + i) * ldt + F1 + c0) =
                make_float2(acc2[i][0] + a.fw.bb2[c0],
                            acc2[i][1] + a.fw.bb2[c0 + 1]);
        }
      }
      __syncthreads();
      const int jn = N <= R ? N : rows;
      for (int o = threadIdx.x; o < nrows * FW; o += TC_THREADS) {
        const int rl = o / FW, f = o % FW, row = row0 + rl, b = row / N;
        const bool first = f < F1;
        const float* h = first ? a.h1 + (size_t)b * N * F1 + f
                               : a.h2 + (size_t)b * N * F2 + (f - F1);
        const int ldh = first ? F1 : F2;
        const float* w = Wt + (first ? 0 : R);
        const int rb = N <= R ? rl * N : 0;
        float acc = tile ? carry : 0.f;
#pragma unroll 8
        for (int r = 0; r < jn; ++r)
          acc += (Tt[(rb + r) * ldt + f] * w[rb + r])
                 * __ldg(h + (size_t)(j0 + r) * ldh);
        if (tile + 1 < tiles)
          carry = acc;
        else if (first)
          a.out1[(size_t)row * F1 + f] = acc;
        else
          a.out2[(size_t)row * F2 + (f - F1)] = acc;
      }
      __syncthreads();
      if (prefetch && more) put();
    }
  }
}

// bf16: a persistent block walks its contiguous share of the groups of
// node rows (block_agg_groups); a group is floor(TC_ROWS / N) whole node
// rows, one tile, when N <= TC_ROWS, else one node row in
// ceil(N / TC_ROWS) tiles. The pairs of consecutive node rows are
// consecutive in e, so a tile is one contiguous run of pairs, and a
// block's tiles run through one or two graphs, whose node inputs stay in
// L1. Each output (b, i, f) is summed by one
// thread over j in increasing order (across a row's tiles in a register).
// Regions: [staged weights (W_SMEM)] [E | Tt] [V] [w1, w2 of the tile].
template <bool W_SMEM>
__device__ void block_agg_tc(const BlockAggArgs<bf16>& a, char* smem) {
  const TcDims d = tc_dims(a.fw.C, a.fw.F1, a.fw.F2);
  const int N = a.N, F1 = d.F1, F2 = d.F2, FW = F1 + F2;
  char* p = smem + (W_SMEM ? 2 * tc_weight_elems(d) : 0);
  bf16* E = reinterpret_cast<bf16*>(p);
  float* Tt = reinterpret_cast<float*>(p);
  bf16* V = reinterpret_cast<bf16*>(p + tc_r1_bytes(d));
  float* Wt = reinterpret_cast<float*>(p + tc_r1_bytes(d) + tc_v_bytes(d));
  const bf16* W = a.tc.wp;
  if (W_SMEM) {
    stage_tc_weights(reinterpret_cast<bf16*>(smem), a.tc.wp,
                     tc_weight_elems(d));
    W = reinterpret_cast<const bf16*>(smem);
  }
  const int rows_total = a.B * N;
  const int rpg = N <= TC_ROWS ? TC_ROWS / N : 1;
  const int tiles = N <= TC_ROWS ? 1 : (N + TC_ROWS - 1) / TC_ROWS;
  const int groups = (rows_total + rpg - 1) / rpg;
  float carry = 0.f;   // N > TC_ROWS: thread f's sum over the earlier tiles
  const int per = groups / gridDim.x, extra = groups % gridDim.x;
  const int g0 = blockIdx.x * per + min((int)blockIdx.x, extra);
  const int g1 = g0 + per + ((int)blockIdx.x < extra ? 1 : 0);
  for (int grp = g0; grp < g1; ++grp) {
    const int row0 = grp * rpg, nrows = min(rpg, rows_total - row0);
    for (int tile = 0; tile < tiles; ++tile) {
      const int j0 = tile * TC_ROWS;
      const int rows = N <= TC_ROWS ? nrows * N : min(TC_ROWS, N - j0);
      const size_t q0 = (size_t)row0 * N + j0;
      load_tile_tc(E, a.e + q0 * d.C, rows, d);
      for (int r = threadIdx.x; r < rows; r += TC_THREADS) {
        Wt[r] = a.w1[q0 + r];
        Wt[TC_ROWS + r] = a.w2[q0 + r];
      }
      __syncthreads();
      filter_tile_tc<false, W_SMEM>(E, V, Tt, rows, W, a.tc, d);
      const int jn = N <= TC_ROWS ? N : rows;
      // one output a thread at F1 + F2 <= 256 (nrows * FW <= 2 * 256 when
      // N > 21; nrows == 1 when N > TC_ROWS, so o == threadIdx.x there)
      for (int o = threadIdx.x; o < nrows * FW; o += TC_THREADS) {
        const int rl = o / FW, f = o % FW, row = row0 + rl, b = row / N;
        const bool first = f < F1;
        const int col = first ? f : d.F1p + (f - F1);
        const float* h = first ? a.h1 + (size_t)b * N * F1 + f
                               : a.h2 + (size_t)b * N * F2 + (f - F1);
        const int ldh = first ? F1 : F2;
        const float* w = Wt + (first ? 0 : TC_ROWS);
        const int rb = N <= TC_ROWS ? rl * N : 0;
        float acc = tile ? carry : 0.f;
#pragma unroll 8
        for (int jj = 0; jj < jn; ++jj)
          acc += (Tt[(rb + jj) * d.ldt + col] * w[rb + jj])
                 * __ldg(h + (size_t)(j0 + jj) * ldh);
        if (tile + 1 < tiles)
          carry = acc;
        else if (first)
          a.out1[(size_t)row * F1 + f] = acc;
        else
          a.out2[(size_t)row * F2 + (f - F1)] = acc;
      }
      __syncthreads();
    }
  }
}

// LEVEL (kernels/fused.py block_agg_level): at bf16 0 stages the packed
// weights in shared memory, 1 reads them from global memory; at f32 0
// stages fa and fb1, 1 fa, 2 neither (64-pair tiles, one pass of units),
// 3 neither (32-pair tiles, any widths)
template <typename T, int LEVEL>
__global__ void __launch_bounds__(TC_THREADS)
    block_agg_kernel(BlockAggArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (std::is_same<T, bf16>::value)
    block_agg_tc<LEVEL == 0>(a, reinterpret_cast<char*>(smem));
  else
    block_agg_f32<LEVEL>(a, reinterpret_cast<char*>(smem));
}

// kernels/fused.py block_agg_smem_f32 and block_agg_smem mirror these
static size_t block_agg_smem_f32(int C, int F1, int F2, int level) {
  const int FW = F1 + F2, R = f32_rows(level);
  return (level <= 1 ? 4 * (size_t)C * f32_f6(F1, F2) : 0)
         + (level == 0 ? 4 * (size_t)F1 * F1 : 0)
         + f32_r1_bytes(C, FW, level)
         + (level == 3 ? 4 * (size_t)FW * (R + 4) : 0) + 4 * 2 * (size_t)R;
}

static size_t block_agg_smem_tc(int C, int F1, int F2, int level) {
  const TcDims d = tc_dims(C, F1, F2);
  return (level == 0 ? 2 * tc_weight_elems(d) : 0) + tc_r1_bytes(d)
         + tc_v_bytes(d) + 2 * TC_ROWS * 4;
}

// Blocks of a kernel that fit on the card at once (SMs x blocks per SM at
// this shared memory), asked once per kernel, device and size
static int resident_blocks(const void* kernel, int threads, size_t smem,
                           int* out) {
  struct Seen { const void* kernel; int dev; size_t smem; int blocks; };
  static Seen seen[32];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].kernel == kernel && seen[i].dev == dev
        && seen[i].smem == smem) {
      *out = seen[i].blocks;
      return 0;
    }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (n_seen < 32) seen[n_seen++] = Seen{kernel, dev, smem, sms * per_sm};
  *out = sms * per_sm;
  return 0;
}

template <typename T, int LEVEL>
static int block_agg_run(const BlockAggArgs<T>& a, int* grid_out,
                         cudaStream_t stream) {
  const int C = a.fw.C, F1 = a.fw.F1, F2 = a.fw.F2;
  const bool tc = std::is_same<T, bf16>::value;
  const size_t smem = tc ? block_agg_smem_tc(C, F1, F2, LEVEL)
                         : block_agg_smem_f32(C, F1, F2, LEVEL);
  cudaError_t err = cudaFuncSetAttribute(
      block_agg_kernel<T, LEVEL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int N = a.N, tile = tc ? TC_ROWS : f32_rows(LEVEL);
  const int rpg = N <= tile ? tile / N : 1;
  const int groups = (a.B * N + rpg - 1) / rpg;
  int resident = 0;
  const int rc = resident_blocks(
      reinterpret_cast<const void*>(block_agg_kernel<T, LEVEL>), TC_THREADS,
      smem, &resident);
  if (rc) return rc;
  const int grid = min(groups, resident);
  block_agg_kernel<T, LEVEL><<<grid, TC_THREADS, smem, stream>>>(a);
  *grid_out = grid;
  return (int)cudaGetLastError();
}

template <typename T>
static void fill_args(BlockAggArgs<T>& a, const void* e, const void* w1,
                      const void* w2, const void* h1, const void* h2,
                      const void* const* wts, const void* packed, void* out1,
                      void* out2, int B, int N, int C, int F1, int F2) {
  a.e = static_cast<const T*>(e);
  a.w1 = static_cast<const float*>(w1);
  a.w2 = static_cast<const float*>(w2);
  a.h1 = static_cast<const float*>(h1);
  a.h2 = static_cast<const float*>(h2);
  a.fw.fa1 = static_cast<const T*>(wts[0]);
  a.fw.fa2 = static_cast<const T*>(wts[1]);
  a.fw.fb1 = static_cast<const T*>(wts[2]);
  a.fw.fb2 = static_cast<const T*>(wts[3]);
  a.fw.ba1 = a.tc.ba1 = static_cast<const float*>(wts[4]);
  a.fw.ba2 = a.tc.ba2 = static_cast<const float*>(wts[5]);
  a.fw.bb1 = a.tc.bb1 = static_cast<const float*>(wts[6]);
  a.fw.bb2 = a.tc.bb2 = static_cast<const float*>(wts[7]);
  a.fw.beta1 = a.tc.beta1 = static_cast<const float*>(wts[8]);
  a.fw.beta2 = a.tc.beta2 = static_cast<const float*>(wts[9]);
  a.tc.wp = static_cast<const bf16*>(packed);
  a.fw.C = C; a.fw.F1 = F1; a.fw.F2 = F2;
  a.out1 = static_cast<float*>(out1);
  a.out2 = static_cast<float*>(out2);
  a.B = B; a.N = N;
}

// bf16_: 0 for f32 operands (CUDA cores; level 0 to 3), 1 for bf16
// (tensor cores; level 0 or 1); both on a persistent grid. wts: fa1,
// fa2, fb1, fb2 (of the operand type), ba1, ba2, bb1, bb2, beta1, beta2
// (f32); packed: the bf16 weights as pack_filter_weights lays them out
// (bf16 only). *grid_out: the blocks launched.
extern "C" int block_agg_launch(int bf16_, const void* e, const void* w1,
                                const void* w2, const void* h1,
                                const void* h2, const void* const* wts,
                                const void* packed, void* out1, void* out2,
                                int B, int N, int C, int F1, int F2,
                                int level, int* grid_out, void* stream) {
  if (C % 4 || F1 % 4 || F2 % 4 || F1 + F2 > FT_THREADS || N < 1 || B < 1
      || level < 0 || level > (bf16_ ? 1 : 3)
      // the one-pass f32 levels: every unit of a layer in one pass
      || (!bf16_ && level < 3
          && (f32_tiles1(F32_ROWS, F1, F2) > TC_THREADS / 32
              || f32_tiles2(F32_ROWS, F1, F2) > TC_THREADS / 32))
      || (bf16_ && (packed == nullptr
                    || reinterpret_cast<uintptr_t>(packed) % 16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16_) {
    BlockAggArgs<float> a;
    fill_args(a, e, w1, w2, h1, h2, wts, packed, out1, out2, B, N, C, F1,
              F2);
    return level == 0 ? block_agg_run<float, 0>(a, grid_out, s)
           : level == 1 ? block_agg_run<float, 1>(a, grid_out, s)
           : level == 2 ? block_agg_run<float, 2>(a, grid_out, s)
                        : block_agg_run<float, 3>(a, grid_out, s);
  }
  BlockAggArgs<bf16> a;
  fill_args(a, e, w1, w2, h1, h2, wts, packed, out1, out2, B, N, C, F1, F2);
  return level == 0 ? block_agg_run<bf16, 0>(a, grid_out, s)
                    : block_agg_run<bf16, 1>(a, grid_out, s);
}

// ---- K4 --------------------------------------------------------------------

// The pair lists of one graph (csrc side of kernels/fused.py
// pair_lists_bytes): the mask's ballot words and their exclusive bases,
// one word per 32 cells, the masked count, and the masked cells (i N + j)
// in increasing order, as 16-bit indices (N <= 256). In shared memory
// where they fit, else in the CTA's share of the wrapper's scratch.
__host__ __device__ inline size_t r16(size_t x) {
  return (x + 15) & ~(size_t)15;
}
__host__ __device__ inline size_t pair_lists_bytes(int N) {
  const size_t nc = ((size_t)N * N + 31) / 32;
  return 2 * r16(4 * nc) + 16 + r16(2 * (size_t)N * N);
}

struct PairLists {
  unsigned* bits;
  int* base;
  int* count;
  unsigned short* cells;
};

__device__ inline PairLists pair_lists_at(char* p, int N) {
  const size_t nc = ((size_t)N * N + 31) / 32;
  PairLists l;
  l.bits = reinterpret_cast<unsigned*>(p);
  l.base = reinterpret_cast<int*>(p + r16(4 * nc));
  l.count = reinterpret_cast<int*>(p + 2 * r16(4 * nc));
  l.cells = reinterpret_cast<unsigned short*>(p + 2 * r16(4 * nc) + 16);
  return l;
}

template <typename T>
struct PairScoreArgs {
  const T* h;              // (B, N, C) node states at the operand type
  const T* e;              // (B, N, N, C) edge features
  const unsigned char* mask;  // (B, N, N) bool
  const T* w1;             // (2C, H1): rows [0, C) take h_i h_j, [C, 2C) e
  const float* b1;         // (H1,)
  const T* w2;             // (H1, H2)
  const float* b2;         // (H2,)
  const T* w3;             // (H2, 1)
  const float* b3;         // (1,)
  const bf16* wp;          // bf16: w1 and w2 packed (pack_pair_score_weights)
  float* out;              // (B, N, N)
  char* scratch;           // the lists of each CTA when not in shared memory
  int B, N, C, H1, H2;
  int R;                   // CTAs per graph
  size_t lists_at;         // byte offset of the lists in shared memory
  int lists_smem;          // 1: lists in shared memory, 0: in the scratch
  int vec8;                // bf16: 16-byte loads of e (C % 8, aligned)
};

// The graph's masked cells, listed by every CTA of the graph: a ballot of
// 32 cells a warp, an exclusive scan of the words' counts, then each cell
// at its rank; CTA r writes 0 to the cells off the list in its share
// (cells q with q / TC_THREADS = r mod R). Returns the count; starts after
// the caller's staging, ends with the block synchronised.
__device__ int pair_list(const unsigned char* m, float* out, int NN, int r,
                         int R, const PairLists& l) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int NC = (NN + 31) / 32;
  // K4: stage and scan the mask
  for (int k = warp; k < NC; k += TC_THREADS / 32) {
    const int q = 32 * k + lane;
    const unsigned bits = __ballot_sync(0xffffffffu, q < NN && m[q] != 0);
    if (lane == 0) {
      l.bits[k] = bits;
      l.base[k] = __popc(bits);
    }
  }
  __syncthreads();
  if (warp == 0) {   // exclusive scan of the counts, 32 words at a time
    int run = 0;
    for (int k0 = 0; k0 < NC; k0 += 32) {
      const int k = k0 + lane, c = k < NC ? l.base[k] : 0;
      int s = c;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += t;
      }
      if (k < NC) l.base[k] = run + s - c;
      run += __shfl_sync(0xffffffffu, s, 31);
    }
    if (lane == 0) *l.count = run;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < NN; q += TC_THREADS) {
    const unsigned bits = l.bits[q >> 5], bit = 1u << (q & 31);
    if (bits & bit)
      l.cells[l.base[q >> 5] + __popc(bits & (bit - 1u))] =
          (unsigned short)q;
  }
  // K4: zero fill
  for (int q = r * TC_THREADS + threadIdx.x; q < NN; q += R * TC_THREADS)
    if (!(l.bits[q >> 5] & (1u << (q & 31)))) out[q] = 0.f;
  __syncthreads();
  return *l.count;
}

// bf16 x bf16 products of two packed pairs, each rounded to bf16
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t x, uint32_t y) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&y));
  const __nv_bfloat162 p = __floats2bfloat162_rn(a.x * b.x, a.y * b.y);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The bf16 tile: rows [0, rows) are the list's entries q0.., each
// [bf16(h_i h_j) in columns [0, Cp) | e_ij in [Cp, 2Cp)], zero-padded;
// rows past `rows` that the products read (to 32 or TC_ROWS) are 0. V
// elements (8: 16-byte loads, 4: 8-byte) a thread at a time.
template <int V>
__device__ void load_pair_tile(bf16* A, int lda, const bf16* hs,
                               const bf16* eb, const unsigned short* cells,
                               int rows, int N, int C, int Cp) {
  typedef typename std::conditional<V == 8, uint4, uint2>::type Vec;
  constexpr int W = V / 2;   // 32-bit words a chunk
  const int cpv = Cp / V, rows_read = rows > 32 ? TC_ROWS : 32;
  for (int q = threadIdx.x; q < rows_read * 2 * cpv; q += TC_THREADS) {
    const int rr = q / (2 * cpv), c = q % (2 * cpv);
    const bool edge = c >= cpv;
    const int k = V * (edge ? c - cpv : c);
    Vec v;
    uint32_t* vw = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int u = 0; u < W; ++u) vw[u] = 0u;
    if (rr < rows && k < C) {
      const int p = cells[rr], i = p / N, j = p - i * N;
      if (edge) {
        v = __ldg(reinterpret_cast<const Vec*>(eb + (size_t)p * C + k));
      } else {
        const Vec x = *reinterpret_cast<const Vec*>(hs + i * C + k);
        const Vec y = *reinterpret_cast<const Vec*>(hs + j * C + k);
        const uint32_t* xw = reinterpret_cast<const uint32_t*>(&x);
        const uint32_t* yw = reinterpret_cast<const uint32_t*>(&y);
#pragma unroll
        for (int u = 0; u < W; ++u) vw[u] = mul_bf16x2(xw[u], yw[u]);
      }
    }
    *reinterpret_cast<Vec*>(A + rr * lda + (edge ? Cp : 0) + k) = v;
  }
}

// Shared memory of a K4 block without h and the lists (kernels/fused.py
// pair_score_smem mirrors it). bf16: [w1 | w2 packed (level 0)] then,
// after h, [A: TC_ROWS x (2Cp + TC_PAD)] [X: TC_ROWS x (H1p + TC_PAD)]
// [the head's partial sums: H2p / 16 x TC_ROWS f32]. f32: [w1 (levels 0,
// 1)] [w2 (level 0)] [A k-major, 2C x FT_LD, later Y, FT_ROWS x (H2 + 4)]
// [X k-major, H1 x FT_LD].
static size_t pair_score_smem(bool bf, int C, int H1, int H2, int level) {
  if (bf) {
    const size_t Cp = pad16(C), H1p = pad16(H1), H2p = pad16(H2);
    return (level == 0 ? 2 * (2 * Cp * H1p + H1p * H2p) : 0)
           + 2 * (size_t)TC_ROWS * (2 * Cp + TC_PAD)
           + 2 * (size_t)TC_ROWS * (H1p + TC_PAD)
           + 4 * (size_t)TC_ROWS * (H2p / 16);
  }
  const size_t a = (size_t)2 * C * FT_LD, y = (size_t)FT_ROWS * (H2 + 4);
  return (level <= 1 ? 4 * (size_t)2 * C * H1 : 0)
         + (level == 0 ? 4 * (size_t)H1 * H2 : 0) + 4 * (a > y ? a : y)
         + 4 * (size_t)H1 * FT_LD;
}
// the graph's h staged at bf16 (f32 reads it through L1)
__host__ __device__ inline size_t pair_score_h_bytes(bool bf, int N,
                                                     int C) {
  return bf ? r16(2 * (size_t)N * C) : 0;
}

// bf16 on the tensor cores. Per tile of TC_ROWS list entries:
//   layer 1, X = bf16(act([h_i h_j | e] @ w1 + b1)), mma over K = 2Cp;
//   layer 2, y = act(X @ w2 + b2) in f32 on the accumulators, times w3,
//     summed over a lane's columns, its quad (shuffles) and, through
//     shared memory, the strips of its rows in strip order; + b3.
// W_SMEM stages the packed w1, w2 once per block (level 0); else they are
// read from L2 with the same loads and products.
template <bool W_SMEM, bool GELU>
__device__ void pair_score_tc(const PairScoreArgs<bf16>& a, char* smem) {
  const int N = a.N, NN = N * N, C = a.C, H1 = a.H1, H2 = a.H2;
  const int Cp = pad16(C), H1p = pad16(H1), H2p = pad16(H2);
  const int lda = 2 * Cp + TC_PAD, ldx = H1p + TC_PAD, s2 = H2p / 16;
  const int b = blockIdx.x / a.R, r = blockIdx.x % a.R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, nw = TC_THREADS / 32;
  const size_t w1n = (size_t)2 * Cp * H1p, wn = w1n + (size_t)H1p * H2p;
  char* p = smem;
  const bf16* W = a.wp;
  if (W_SMEM) {
    stage_tc_weights(reinterpret_cast<bf16*>(p), a.wp, wn);
    W = reinterpret_cast<const bf16*>(p);
    p += 2 * wn;
  }
  bf16* hs = reinterpret_cast<bf16*>(p);
  p += pair_score_h_bytes(true, N, C);
  bf16* A = reinterpret_cast<bf16*>(p);
  p += 2 * (size_t)TC_ROWS * lda;
  bf16* X = reinterpret_cast<bf16*>(p);
  p += 2 * (size_t)TC_ROWS * ldx;
  float* part = reinterpret_cast<float*>(p);
  const PairLists l = pair_lists_at(
      a.lists_smem ? smem + a.lists_at
                   : a.scratch + blockIdx.x * pair_lists_bytes(N), N);
  {
    const uint2* src = reinterpret_cast<const uint2*>(a.h + (size_t)b * N * C);
    uint2* dst = reinterpret_cast<uint2*>(hs);
    for (int q = threadIdx.x; q < N * C / 4; q += TC_THREADS)
      dst[q] = __ldg(src + q);
  }
  float* out = a.out + (size_t)b * NN;
  const int count = pair_list(a.mask + (size_t)b * NN, out, NN, r, a.R, l);
  const bf16* eb = a.e + (size_t)b * NN * C;
  const bf16* W2 = W + w1n;
  const float b3 = a.b3[0];
  const int tiles = (count + TC_ROWS - 1) / TC_ROWS;
  for (int tile = r; tile < tiles; tile += a.R) {
    const int q0 = tile * TC_ROWS, rows = min(TC_ROWS, count - q0);
    const int halves = rows > 32 ? 2 : 1;
    // K4: tile load with the product
    if (a.vec8)
      load_pair_tile<8>(A, lda, hs, eb, l.cells + q0, rows, N, C, Cp);
    else
      load_pair_tile<4>(A, lda, hs, eb, l.cells + q0, rows, N, C, Cp);
    __syncthreads();
    // K4: layer 1
    for (int u = warp; u < halves * (H1p / 16); u += nw) {
      const int ct = u / halves, r0 = 32 * (u % halves);
      float acc[2][2][4] = {};
      tc_unit<W_SMEM>(acc, A + r0 * lda, lda,
                      W + (size_t)ct * (2 * Cp / 16) * TC_BLOCK, 2 * Cp / 16,
                      lane);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int c = 16 * ct + 8 * n + 2 * t;   // H1 % 4 == 0: c + 1 too
        const bool real = c < H1;
        const float b0 = real ? a.b1[c] : 0.f, b1 = real ? a.b1[c + 1] : 0.f;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<__nv_bfloat162*>(
                X + (r0 + 16 * m + g + 8 * h) * ldx + c) =
                real ? __floats2bfloat162_rn(
                           head_act<GELU>(acc[m][n][2 * h] + b0),
                           head_act<GELU>(acc[m][n][2 * h + 1] + b1))
                     : __floats2bfloat162_rn(0.f, 0.f);
      }
    }
    __syncthreads();
    // K4: layer 2 and the head
    for (int u = warp; u < halves * s2; u += nw) {
      const int ct = u / halves, r0 = 32 * (u % halves);
      float acc[2][2][4] = {};
      tc_unit<W_SMEM>(acc, X + r0 * ldx, ldx,
                      W2 + (size_t)ct * (H1p / 16) * TC_BLOCK, H1p / 16, lane);
      float s[2][2] = {};   // rows 16m + g + 8h
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int c = 16 * ct + 8 * n + 2 * t;
        if (c < H2) {
          const float b0 = a.b2[c], b1 = a.b2[c + 1];
          const float v0 = to_f(a.w3[c]), v1 = to_f(a.w3[c + 1]);
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              s[m][h] += head_act<GELU>(acc[m][n][2 * h] + b0) * v0
                         + head_act<GELU>(acc[m][n][2 * h + 1] + b1) * v1;
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = s[m][h];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (t == 0) part[ct * TC_ROWS + r0 + 16 * m + g + 8 * h] = v;
        }
    }
    __syncthreads();
    for (int q = threadIdx.x; q < rows; q += TC_THREADS) {
      float s = part[q];
      for (int ct = 1; ct < s2; ++ct) s += part[ct * TC_ROWS + q];
      out[l.cells[q0 + q]] = s + b3;
    }
  }
}

// One f32 layer of K4 on a tile of FT_ROWS rows: out = act(A @ W + bias)
// for rows [0, rows), A k-major (stride FT_LD), W (K x H) row-major in
// shared memory or (GLOBAL) read through L1; out k-major (KMAJOR, stride
// ldo, the next layer's operand) or row-major. Units of RU rows x CU
// columns, k in increasing order from 0 (unit_fma); a warp's FT_ROWS / RU
// row groups by 32 RU / FT_ROWS column groups, warps round-robin over
// the column strips.
template <int RU, int CU, bool GLOBAL, bool KMAJOR, bool GELU>
__device__ __forceinline__ void pair_score_layer(const float* A,
                                                 const float* W,
                                                 const float* bias, int K,
                                                 int H, float* out, int ldo,
                                                 int rows) {
  constexpr int G = FT_ROWS / RU, CW = 32 / G * CU;
  const int lane = threadIdx.x & 31, r0 = RU * (lane % G);
  for (int wt = threadIdx.x >> 5; wt * CW < H; wt += TC_THREADS / 32) {
    const int c0 = wt * CW + CU * (lane / G);
    if (c0 >= H || r0 >= rows) continue;
    float acc[RU][CU] = {};
    unit_fma<RU, CU, GLOBAL>(A, FT_LD, W + c0, H, K, r0, acc);
#pragma unroll
    for (int j = 0; j < CU; ++j) {
      const float bj = bias[c0 + j];
#pragma unroll
      for (int i = 0; i < RU; ++i) {
        const float v = head_act<GELU>(acc[i][j] + bj);
        if (KMAJOR)
          out[(c0 + j) * ldo + r0 + i] = v;
        else
          out[(r0 + i) * ldo + c0 + j] = v;
      }
    }
  }
}

// f32 on CUDA cores, true f32 (no TF32), in the one-block-per-row form's
// order for every sum of a pair (so its bits): per tile of FT_ROWS list
// entries (A k-major, rows across lanes),
//   layer 1, X = act(A @ w1 + b1), k = 0 .. 2C - 1 (units of 4 rows x 4
//     columns, f32 fused multiply-adds, pair_score_layer);
//   layer 2, Y = act(X @ w2 + b2), k = 0 .. H1 - 1, Y in A's region;
//   the head, one warp a row: a lane-strided sum of Y w3 and a butterfly,
//     + b3;
// the next tile's operands load into registers under the layers.
// LEVEL 0 stages w1 and w2 once per block, 1 w1, 2 neither (read through
// L1).
template <int LEVEL, bool GELU>
__device__ void pair_score_f32(const PairScoreArgs<float>& a, char* smem) {
  // 4 x 4 units: 8 warps a layer at H1 = 128 (4 at H2 = 64); 4 x 2 and
  // 8 x 4 units read no faster on the card (PERF.md, K4 findings)
  constexpr int R = FT_ROWS, LDA = FT_LD, RU = 4, CU = 4;
  const int N = a.N, NN = N * N, C = a.C, H1 = a.H1, H2 = a.H2;
  const int K1 = 2 * C, ldy = H2 + 4;
  const int b = blockIdx.x / a.R, r = blockIdx.x % a.R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = TC_THREADS / 32;
  char* p = smem;
  float* w1s = reinterpret_cast<float*>(p);
  if (LEVEL <= 1) p += 4 * (size_t)K1 * H1;
  float* w2s = reinterpret_cast<float*>(p);
  if (LEVEL == 0) p += 4 * (size_t)H1 * H2;
  float* A = reinterpret_cast<float*>(p);
  float* Y = A;
  {
    const size_t ka = (size_t)K1 * LDA, ky = (size_t)R * ldy;
    p += 4 * (ka > ky ? ka : ky);
  }
  float* X = reinterpret_cast<float*>(p);
  const PairLists l = pair_lists_at(
      a.lists_smem ? smem + a.lists_at
                   : a.scratch + blockIdx.x * pair_lists_bytes(N), N);
  if (LEVEL <= 1)
    for (int q = threadIdx.x; q < K1 * H1 / 4; q += TC_THREADS)
      reinterpret_cast<float4*>(w1s)[q] = ldg4(a.w1 + 4 * q);
  if (LEVEL == 0)
    for (int q = threadIdx.x; q < H1 * H2 / 4; q += TC_THREADS)
      reinterpret_cast<float4*>(w2s)[q] = ldg4(a.w2 + 4 * q);
  float* out = a.out + (size_t)b * NN;
  const int count = pair_list(a.mask + (size_t)b * NN, out, NN, r, a.R, l);
  const float* hb = a.h + (size_t)b * N * C;
  const float* eb = a.e + (size_t)b * NN * C;
  const float* W1 = LEVEL <= 1 ? w1s : a.w1;
  const float* W2 = LEVEL == 0 ? w2s : a.w2;
  const int tiles = (count + R - 1) / R;
  // A tile's operands, k-major into A (zero rows past `rows`): a thread's
  // first PF float4s through registers (pf), loaded for the next tile
  // under this tile's layers (all of them at C <= 128), the rest at put
  // time
  constexpr int PF = 4;
  const int total = R * (K1 / 4);
  float4 pf[PF];
  auto operand = [&](int q, int q0, int rows) {
    const int rr = q % R, k = 4 * (q / R);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rr < rows) {
      const int pc = l.cells[q0 + rr], i = pc / N, j = pc - i * N;
      if (k < C) {
        const float4 x = ldg4(hb + (size_t)i * C + k);
        const float4 y = ldg4(hb + (size_t)j * C + k);
        v = make_float4(x.x * y.x, x.y * y.y, x.z * y.z, x.w * y.w);
      } else {
        v = ldg4(eb + (size_t)pc * C + (k - C));
      }
    }
    return v;
  };
  auto put = [&](int q, const float4& v) {
    const int rr = q % R, k = 4 * (q / R);
    A[k * LDA + rr] = v.x;
    A[(k + 1) * LDA + rr] = v.y;
    A[(k + 2) * LDA + rr] = v.z;
    A[(k + 3) * LDA + rr] = v.w;
  };
  auto fetch = [&](int tile) {
    const int q0 = tile * R, rows = min(R, count - q0);
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      const int q = threadIdx.x + u * TC_THREADS;
      if (q < total) pf[u] = operand(q, q0, rows);
    }
  };
  if (r < tiles) fetch(r);
  for (int tile = r; tile < tiles; tile += a.R) {
    const int q0 = tile * R, rows = min(R, count - q0);
    // K4: tile load with the product
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      const int q = threadIdx.x + u * TC_THREADS;
      if (q < total) put(q, pf[u]);
    }
    for (int q = threadIdx.x + PF * TC_THREADS; q < total; q += TC_THREADS)
      put(q, operand(q, q0, rows));
    __syncthreads();
    if (tile + a.R < tiles) fetch(tile + a.R);
    // K4: layer 1
    pair_score_layer<RU, CU, LEVEL == 2, true, GELU>(A, W1, a.b1, K1, H1, X,
                                                     LDA, rows);
    __syncthreads();
    // K4: layer 2 and the head
    pair_score_layer<RU, CU, LEVEL != 0, false, GELU>(X, W2, a.b2, H1, H2, Y,
                                                      ldy, rows);
    __syncthreads();
    for (int rr = warp; rr < rows; rr += nw) {
      float s = 0.f;
      for (int c = lane; c < H2; c += 32) s += Y[rr * ldy + c] * a.w3[c];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) out[l.cells[q0 + rr]] = s + a.b3[0];
    }
    __syncthreads();
  }
}

// LEVEL (kernels/fused.py pair_score_level): at bf16 0 stages the packed
// weights, 1 reads them from L2; at f32 0 stages w1 and w2, 1 w1, 2
// neither; GELU: gelu activations, else relu
template <typename T, int LEVEL, bool GELU>
__global__ void __launch_bounds__(TC_THREADS)
    pair_score_kernel(PairScoreArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (std::is_same<T, bf16>::value)
    pair_score_tc<LEVEL == 0, GELU>(a, reinterpret_cast<char*>(smem));
  else
    pair_score_f32<LEVEL, GELU>(a, reinterpret_cast<char*>(smem));
}

// The launch at a level: its CTAs per graph R are `ranks` when > 0, else
// as many as fill the card's resident blocks (SMs x blocks an SM at this
// shared memory) over the B graphs, at most one a tile of the full N x N
// list; *ranks_out gets R. launch = 0 only plans.
template <typename T, int LEVEL, bool GELU>
static int pair_score_run(PairScoreArgs<T> a, int ranks, int launch,
                          int* ranks_out, cudaStream_t stream) {
  const size_t smem = a.lists_at + (a.lists_smem ? pair_lists_bytes(a.N) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      pair_score_kernel<T, LEVEL, GELU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (ranks <= 0) {
    int resident = 0;
    const int rc = resident_blocks(
        reinterpret_cast<const void*>(pair_score_kernel<T, LEVEL, GELU>),
        TC_THREADS, smem, &resident);
    if (rc) return rc;
    const int tile = std::is_same<T, bf16>::value ? TC_ROWS : FT_ROWS;
    ranks = max(1, min(resident / a.B, (a.N * a.N + tile - 1) / tile));
  }
  *ranks_out = ranks;
  if (!launch) return 0;
  a.R = ranks;
  pair_score_kernel<T, LEVEL, GELU>
      <<<a.B * a.R, TC_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool GELU>
static int pair_score_at_level(const PairScoreArgs<T>& a, int level,
                               int ranks, int launch, int* ranks_out,
                               cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value)
    return level == 0
               ? pair_score_run<T, 0, GELU>(a, ranks, launch, ranks_out, s)
               : pair_score_run<T, 1, GELU>(a, ranks, launch, ranks_out, s);
  else
    return level == 0
               ? pair_score_run<T, 0, GELU>(a, ranks, launch, ranks_out, s)
           : level == 1
               ? pair_score_run<T, 1, GELU>(a, ranks, launch, ranks_out, s)
               : pair_score_run<T, 2, GELU>(a, ranks, launch, ranks_out, s);
}

template <typename T>
static int pair_score_go(int gelu, const void* h, const void* e,
                         const void* mask, const void* const* wts,
                         const void* packed,
                         void* out, void* scratch, int B, int N, int C,
                         int H1, int H2, int level, int lists_smem,
                         int ranks, int launch, int* ranks_out,
                         cudaStream_t s) {
  const bool bf = std::is_same<T, bf16>::value;
  PairScoreArgs<T> a;
  a.h = static_cast<const T*>(h);
  a.e = static_cast<const T*>(e);
  a.mask = static_cast<const unsigned char*>(mask);
  a.w1 = static_cast<const T*>(wts[0]);
  a.b1 = static_cast<const float*>(wts[1]);
  a.w2 = static_cast<const T*>(wts[2]);
  a.b2 = static_cast<const float*>(wts[3]);
  a.w3 = static_cast<const T*>(wts[4]);
  a.b3 = static_cast<const float*>(wts[5]);
  a.wp = static_cast<const bf16*>(packed);
  a.out = static_cast<float*>(out);
  a.scratch = static_cast<char*>(scratch);
  a.B = B; a.N = N; a.C = C; a.H1 = H1; a.H2 = H2; a.R = 1;
  a.lists_at = pair_score_smem(bf, C, H1, H2, level)
               + pair_score_h_bytes(bf, N, C);
  a.lists_smem = lists_smem;
  a.vec8 = (C % 8 == 0) && (reinterpret_cast<uintptr_t>(e) % 16 == 0);
  if (gelu) return pair_score_at_level<T, true>(a, level, ranks, launch,
                                                ranks_out, s);
  return pair_score_at_level<T, false>(a, level, ranks, launch, ranks_out,
                                        s);
}

// bf16_: 0 for f32 operands (CUDA cores; level 0 to 2), 1 for bf16
// (tensor cores; level 0 or 1). gelu: 1 for gelu activations, 0 for
// relu. wts: w1, b1, w2, b2, w3, b3 (weights of the operand type, biases
// f32); packed: w1 and w2 as
// pack_pair_score_weights lays them out (bf16 only). lists_smem: 1 keeps
// each CTA's pair lists in shared memory, 0 in `scratch`
// (pair_lists_bytes(N) a CTA, B x R CTAs). ranks: CTAs per graph, 0 to
// let the card's occupancy choose; *ranks_out: those launched. launch = 0
// only plans (sets *ranks_out).
extern "C" int pair_score_launch(int bf16_, int gelu, const void* h,
                                 const void* e, const void* mask,
                                 const void* const* wts,
                                 const void* packed, void* out,
                                 void* scratch, int B, int N, int C, int H1,
                                 int H2, int level, int lists_smem,
                                 int ranks, int launch, int* ranks_out,
                                 void* stream) {
  if (C % 4 || H1 % 4 || H2 % 4 || N < 1 || N > 256 || B < 1
      || level < 0 || level > (bf16_ ? 1 : 2)
      || (launch && !lists_smem && scratch == nullptr)
      || (bf16_ && (packed == nullptr
                    || reinterpret_cast<uintptr_t>(packed) % 16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_ ? pair_score_go<bf16>(gelu, h, e, mask, wts, packed, out,
                                     scratch, B, N, C, H1, H2, level,
                                     lists_smem, ranks, launch, ranks_out, s)
               : pair_score_go<float>(gelu, h, e, mask, wts, packed, out,
                                      scratch, B, N, C, H1, H2, level,
                                      lists_smem, ranks, launch, ranks_out,
                                      s);
}

// ---- K5 --------------------------------------------------------------------

// out[b, i, c] = sum_j mask[b, i, j] relu(x[b, j, c] + e[b, i, j, c]), f32;
// a thread per four columns of a row (b, i), j in increasing order
__global__ void __launch_bounds__(256)
    gine_kernel(const float* x, const float* e, const unsigned char* mask,
                float* out, int B, int N, int C) {
  const int c4 = C / 4;
  const size_t unit = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (unit >= (size_t)B * N * c4) return;
  const size_t row = unit / c4;
  const int c = 4 * (int)(unit % c4);
  const size_t b = row / N;
  const float* xb = x + b * N * C + c;
  const float* er = e + row * N * C + c;
  const unsigned char* m = mask + row * N;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < N; ++j) {
    const float mj = m[j] ? 1.f : 0.f;
    const float4 xv = ldg4(xb + (size_t)j * C);
    const float4 ev = ldg4(er + (size_t)j * C);
    acc.x += relu(xv.x + ev.x) * mj;
    acc.y += relu(xv.y + ev.y) * mj;
    acc.z += relu(xv.z + ev.z) * mj;
    acc.w += relu(xv.w + ev.w) * mj;
  }
  *reinterpret_cast<float4*>(out + row * C + c) = acc;
}

extern "C" int gine_launch(const void* x, const void* e, const void* mask,
                           void* out, int B, int N, int C, void* stream) {
  if (C % 4 || N < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const size_t units = (size_t)B * N * (C / 4);
  const int grid = (int)((units + 255) / 256);
  gine_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(e),
      static_cast<const unsigned char*>(mask), static_cast<float*>(out), B, N,
      C);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
