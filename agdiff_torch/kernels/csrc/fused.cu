// K3, K4 and K5 on Hopper: the dense-layout (B, N, N, C) edge consumers
// of engine 'pallas'. Each replaces a TPU kernel of
// agdiff_tpu/ops/pallas/fused.py:
//   K3 block_agg_kernel   <- _block_agg_kernel (:181): both CFConv filter
//      MLPs of one interaction block on every ordered pair, times the
//      distance-weight planes, aggregated against the node inputs:
//      out[b, i, f] = sum_j t(e_ij)[f] w_ij h_j[f];
//   K4 pair_score_kernel  <- _pair_score_kernel (:82): the pair-score MLP
//      on every ordered pair, MLP3(concat(h_i h_j, e_ij)), zero off the
//      mask;
//   K5 gine_kernel        <- _gine_kernel (:142): the GINE aggregation
//      sum_j mask_ij relu(x_j + e_ij), in f32.
// The functions and where their operands round are documented beside the
// wrappers (kernels/fused.py).
//
// Design. K3 at f32 and K4: one block of FT_THREADS threads per node
// row (b, i); its N pairs (b, i, j) run in tiles of FT_ROWS rows through
// the matrix products of filter_mlp.cuh on CUDA cores (f32 fused
// multiply-adds on f32 or bf16-valued operands: true f32 at f32). K3 at
// bf16: a persistent grid of as many blocks of TC_THREADS as the card
// holds at once (one an SM at the default widths), each walking a
// contiguous share of the groups of node rows (two rows, one 64-pair
// tile, at N = 32) through filter_tile_tc on the tensor cores, with the
// packed filter weights staged once per block (layout level 0; level 1,
// for C above 288 at F1 = 128, F2 = 64, reads them from L2). K3 sums each
// column f of a row in one thread, over j in increasing order, so the
// result reproduces bit for bit at any grid. K5 is a streaming pass: one
// thread per four columns of a row (b, i), over j in increasing order.
//
// Bounds at B = 128, N = 32, C = H = 128 (chip_smoke.py computes them from
// each run's shapes): K3 and K4 do ~11-12 GFLOP a launch; at f32 on CUDA
// cores (67 TFLOP/s) they are bound by operations, ~0.17 ms; at bf16 by
// the bytes, ~0.012 ms (the 33.5 MB of edge features; the products take
// ~0.012 ms at 989 TFLOP/s). K3 bf16 runs ~15x above that: a block's
// cycles go to the first layer's products and its softplus (~0.47),
// the second layer (~0.20), the tile load (~0.19) and the aggregation
// (~0.14) (PERF.md, chip_stamps.py); mma.sync leaves the products
// latency-bound at 16 warps an SM, the tile load is not overlapped (a
// cp.async ring measured no faster), and wgmma is the next step. K4 bf16
// still runs on CUDA cores. K5 reads 67 MB of f32 edge features for ~50
// MFLOP: bound by bytes, ~0.02 ms.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (kernels/build.py).

#include <type_traits>

#include "filter_mlp.cuh"

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

// f32: one block per node row, on CUDA cores (filter_tile)
__device__ void block_agg_cuda_cores(const BlockAggArgs<float>& a,
                                     float* smem) {
  const int C = a.fw.C, F1 = a.fw.F1, F2 = a.fw.F2, FW = F1 + F2;
  const int N = a.N, ldt = FW + 4;
  float* E = smem;                      // C x FT_LD
  float* V = E + C * FT_LD;             // FW x FT_LD
  float* Tt = V + FW * FT_LD;           // FT_ROWS x ldt
  float* W = Tt + FT_ROWS * ldt;        // 2 x FT_ROWS
  const int row = blockIdx.x, b = row / N;
  const float* e = a.e + (size_t)row * N * C;
  const int f = threadIdx.x;
  float acc = 0.f;
  for (int j0 = 0; j0 < N; j0 += FT_ROWS) {
    const int rows = min(FT_ROWS, N - j0);
    load_tile_kmajor(E, e + (size_t)j0 * C, rows, C);
    if (threadIdx.x < FT_ROWS) {
      const int r = threadIdx.x;
      W[r] = r < rows ? a.w1[(size_t)row * N + j0 + r] : 0.f;
      W[FT_ROWS + r] = r < rows ? a.w2[(size_t)row * N + j0 + r] : 0.f;
    }
    __syncthreads();
    filter_tile<float, false>(E, V, Tt, ldt, a.fw);
    if (f < FW) {
      const bool first = f < F1;
      const float* h = first ? a.h1 + (size_t)b * N * F1 + f
                             : a.h2 + (size_t)b * N * F2 + (f - F1);
      const int ldh = first ? F1 : F2;
      const float* w = W + (first ? 0 : FT_ROWS);
      for (int r = 0; r < rows; ++r)
        acc += (Tt[r * ldt + f] * w[r]) * h[(size_t)(j0 + r) * ldh];
    }
    __syncthreads();
  }
  if (f < F1)
    a.out1[(size_t)row * F1 + f] = acc;
  else if (f < FW)
    a.out2[(size_t)row * F2 + (f - F1)] = acc;
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

// LEVEL (bf16): 0 stages the packed weights in shared memory, 1 reads
// them from global memory (kernels/fused.py block_agg_level)
template <typename T, int LEVEL>
__global__ void __launch_bounds__(sizeof(T) == 2 ? TC_THREADS : FT_THREADS)
    block_agg_kernel(BlockAggArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (std::is_same<T, bf16>::value)
    block_agg_tc<LEVEL == 0>(a, reinterpret_cast<char*>(smem));
  else
    block_agg_cuda_cores(a, smem);
}

// kernels/fused.py block_agg_smem mirrors these
static size_t block_agg_smem_f32(int C, int F1, int F2) {
  const size_t fw = F1 + F2;
  return 4 * ((size_t)C * FT_LD + fw * FT_LD + FT_ROWS * (fw + 4)
              + 2 * FT_ROWS);
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
  static Seen seen[8];
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
  if (n_seen < 8) seen[n_seen++] = Seen{kernel, dev, smem, sms * per_sm};
  *out = sms * per_sm;
  return 0;
}

template <typename T, int LEVEL>
static int block_agg_run(const BlockAggArgs<T>& a, int* grid_out,
                         cudaStream_t stream) {
  const int C = a.fw.C, F1 = a.fw.F1, F2 = a.fw.F2;
  const bool tc = std::is_same<T, bf16>::value;
  const size_t smem = tc ? block_agg_smem_tc(C, F1, F2, LEVEL)
                         : block_agg_smem_f32(C, F1, F2);
  cudaError_t err = cudaFuncSetAttribute(
      block_agg_kernel<T, LEVEL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = tc ? TC_THREADS : FT_THREADS;
  int grid = a.B * a.N;
  if (tc) {
    const int N = a.N, rpg = N <= TC_ROWS ? TC_ROWS / N : 1;
    const int groups = (a.B * N + rpg - 1) / rpg;
    int resident = 0;
    const int rc = resident_blocks(
        reinterpret_cast<const void*>(block_agg_kernel<T, LEVEL>), threads,
        smem, &resident);
    if (rc) return rc;
    grid = min(groups, resident);
  }
  block_agg_kernel<T, LEVEL><<<grid, threads, smem, stream>>>(a);
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

// bf16_: 0 for f32 operands (CUDA cores, level 0, a block per node row),
// 1 for bf16 (tensor cores, a persistent grid; level 0 or 1). wts: fa1,
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
      || level < 0 || level > (bf16_ ? 1 : 0)
      || (bf16_ && (packed == nullptr
                    || reinterpret_cast<uintptr_t>(packed) % 16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16_) {
    BlockAggArgs<float> a;
    fill_args(a, e, w1, w2, h1, h2, wts, packed, out1, out2, B, N, C, F1,
              F2);
    return block_agg_run<float, 0>(a, grid_out, s);
  }
  BlockAggArgs<bf16> a;
  fill_args(a, e, w1, w2, h1, h2, wts, packed, out1, out2, B, N, C, F1, F2);
  return level == 0 ? block_agg_run<bf16, 0>(a, grid_out, s)
                    : block_agg_run<bf16, 1>(a, grid_out, s);
}

// ---- K4 --------------------------------------------------------------------

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
  float* out;              // (B, N, N)
  int N, C, H1, H2;
};

template <typename T>
__global__ void __launch_bounds__(FT_THREADS)
    pair_score_kernel(PairScoreArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N, C = a.C, H1 = a.H1, H2 = a.H2, ldy = H2 + 4;
  float* A = smem;                      // 2C x FT_LD: h_i h_j, then e
  float* X = A + 2 * C * FT_LD;         // H1 x FT_LD
  float* Y = X + H1 * FT_LD;            // FT_ROWS x ldy
  float* hi = Y + FT_ROWS * ldy;        // C
  const int row = blockIdx.x, b = row / N;
  for (int k = threadIdx.x; k < C; k += FT_THREADS)
    hi[k] = to_f(a.h[(size_t)row * C + k]);
  __syncthreads();
  const T* hb = a.h + (size_t)b * N * C;
  const T* e = a.e + (size_t)row * N * C;
  for (int j0 = 0; j0 < N; j0 += FT_ROWS) {
    const int rows = min(FT_ROWS, N - j0);
    // prod = h_i h_j at the operand type (rounded when bf16)
    for (int q = threadIdx.x; q < FT_ROWS * C; q += FT_THREADS) {
      const int r = q / C, k = q % C;
      A[k * FT_LD + r] =
          r < rows ? rnd<T>(hi[k] * to_f(hb[(size_t)(j0 + r) * C + k]))
                   : 0.f;
    }
    load_tile_kmajor(A + C * FT_LD, e + (size_t)j0 * C, rows, C);
    __syncthreads();
    // x = relu([prod | e] @ w1 + b1), rounded to the operand type
    const int g1 = H1 / 4, g2 = H2 / 4;
    for (int u = threadIdx.x; u < (FT_ROWS / 8) * g1; u += FT_THREADS) {
      const int c = 4 * (u % g1), r0 = 8 * (u / g1);
      float acc[8][4];
      zero_acc(acc);
      gemm_unit(A, a.w1 + c, H1, 2 * C, r0, acc);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          X[(c + j) * FT_LD + r0 + i] =
              rnd<T>(fmaxf(acc[i][j] + a.b1[c + j], 0.f));
    }
    __syncthreads();
    // y = relu(x @ w2 + b2), f32
    for (int u = threadIdx.x; u < (FT_ROWS / 8) * g2; u += FT_THREADS) {
      const int c = 4 * (u % g2), r0 = 8 * (u / g2);
      float acc[8][4];
      zero_acc(acc);
      gemm_unit(X, a.w2 + c, H2, H1, r0, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Y[(r0 + i) * ldy + c + j] = fmaxf(acc[i][j] + a.b2[c + j], 0.f);
    }
    __syncthreads();
    // s = sum_c y w3 + b3 in f32, one warp a row; zero off the mask
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < rows; r += FT_THREADS / 32) {
      float s = 0.f;
      for (int c = lane; c < H2; c += 32) s += Y[r * ldy + c] * to_f(a.w3[c]);
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) {
        const size_t cell = (size_t)row * N + j0 + r;
        a.out[cell] = a.mask[cell] ? s + a.b3[0] : 0.f;
      }
    }
    __syncthreads();
  }
}

template <typename T>
static int pair_score_run(const void* h, const void* e, const void* mask,
                          const void* const* wts, void* out, int B, int N,
                          int C, int H1, int H2, cudaStream_t stream) {
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
  a.out = static_cast<float*>(out);
  a.N = N; a.C = C; a.H1 = H1; a.H2 = H2;
  const size_t smem = 4 * ((size_t)2 * C * FT_LD + (size_t)H1 * FT_LD
                           + (size_t)FT_ROWS * (H2 + 4) + C);
  cudaError_t err = cudaFuncSetAttribute(
      pair_score_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pair_score_kernel<T><<<B * N, FT_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// wts: w1, b1, w2, b2, w3, b3 (weights of the operand type, biases f32)
extern "C" int pair_score_launch(int bf16_, const void* h, const void* e,
                                 const void* mask, const void* const* wts,
                                 void* out, int B, int N, int C, int H1,
                                 int H2, void* stream) {
  if (C % 4 || H1 % 4 || H2 % 4 || N < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_ ? pair_score_run<bf16>(h, e, mask, wts, out, B, N, C, H1, H2,
                                      s)
               : pair_score_run<float>(h, e, mask, wts, out, B, N, C, H1, H2,
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
    acc.x += fmaxf(xv.x + ev.x, 0.f) * mj;
    acc.y += fmaxf(xv.y + ev.y, 0.f) * mj;
    acc.z += fmaxf(xv.z + ev.z, 0.f) * mj;
    acc.w += fmaxf(xv.w + ev.w, 0.f) * mj;
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
