// K2 on Hopper: one interaction block's two CFConv filter MLPs on the
// packed upper-triangle pairs of each graph, times the per-pair distance
// weights, aggregated to both endpoints of every pair (engine 'pk').
//
// Replaces the TPU kernel _packed_block_kernel (agdiff_tpu/ops/pallas/
// block_packed.py:53, entered through packed_block_aggregate :109):
//   t_p = [filter1(e_p) we1_p | filter2(e_p) we2_p]
//   agg[i] += t_p x_j,  agg[j] += t_p x_i   for every pair p = (i, j)
// with x = [x1 | x2] the node inputs (of the operand type) taken as f32;
// each message stays f32, unrounded. The function and where its operands
// round are documented beside the wrapper (kernels/block_packed.py).
//
// Design. One block per graph; the graph's pairs run in tiles through
// the filter MLPs of filter_mlp.cuh. The node sums are kept in shared
// memory; one thread owns a column f of every node's sum and adds the
// tile's messages in increasing pair order, so each sum is taken in a
// fixed order (no atomics) and the result reproduces bit for bit. The TPU
// kernel's one-hot endpoint selector products ([EJ; EI] x, then
// [EI^T | EJ^T] m) would be N/2 times the work here; the endpoints come
// from the pair list.
// - bf16 (engines 'pk', 'pk-approx'): tiles of TC_ROWS = 64 pairs, both
//   layers on the tensor cores (mma.sync.m16n8k16; the CUDA-core form
//   reached ~7.8 TFLOP/s of the 989 on offer); the node inputs stay bf16
//   in shared memory. Layout level 0 stages the packed
//   filter weights (88 KB at C = 128, F1 = 128, F2 = 64) once per block,
//   which with the node arrays fits to N = 56 at those widths; level 1
//   (to N = 134) reads them from L2 instead. kernels/block_packed.py
//   level_for picks the level by shape; both give the same bits.
// - f32 (tests only): tiles of FT_ROWS = 32 on CUDA cores, true f32, with
//   the node inputs widened to f32 in shared memory.
//
// Bound at B = 128, N = 32 (P = 496), C = H = 128, bf16: ~5.8 GFLOP a
// launch, 0.006 ms at the tensor cores' 989 TFLOP/s; the bytes (e 16 MB)
// take 0.005 ms. The bf16 kernel runs ~18x above that: one block of 16
// warps per graph leaves 4 of 132 SMs idle at B = 128 and does not hide
// the tile loads (~0.14 of a block's cycles), the first layer and its
// softplus take ~0.39, the second ~0.16, and the aggregation ~0.30: each
// column's sums are a serial read-modify-write chain through shared
// memory (the run of pairs sharing endpoint i sums in a register), which
// more blocks per graph would split (PERF.md, chip_stamps.py).
// chip_smoke.py computes the bounds from each run's shapes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (kernels/build.py).

#include <type_traits>

#include "filter_mlp.cuh"

template <typename T>
struct PackedBlockArgs {
  const T* e;              // (B, P, C) packed edge features
  const float* we1;        // (B, P) distance weight x envelope x mask
  const float* we2;
  const T* x1;             // (B, N, F1) node inputs of conv 1
  const T* x2;             // (B, N, F2)
  const long long* pi;     // (P,) endpoint i
  const long long* pj;     // (P,) endpoint j
  FilterW<T> fw;
  FilterTC tc;             // bf16: the packed weights, biases and betas
  float* out1;             // (B, N, F1)
  float* out2;             // (B, N, F2)
  int N, P;
};

// f32: the graph's pairs in tiles of FT_ROWS on CUDA cores (filter_tile)
template <bool APPROX>
__device__ void packed_block_cuda_cores(const PackedBlockArgs<float>& a,
                                        float* smem) {
  const int C = a.fw.C, F1 = a.fw.F1, F2 = a.fw.F2, FW = F1 + F2;
  const int N = a.N, P = a.P, ldt = FW + 4;
  float* E = smem;                      // C x FT_LD
  float* V = E + C * FT_LD;             // FW x FT_LD
  float* Tt = V + FW * FT_LD;           // FT_ROWS x ldt
  float* X = Tt + FT_ROWS * ldt;        // N x FW node inputs
  float* S = X + (size_t)N * FW;        // N x FW node sums
  float* W = S + (size_t)N * FW;        // 2 x FT_ROWS
  int* ep = reinterpret_cast<int*>(W + 2 * FT_ROWS);  // 2 x FT_ROWS
  const int b = blockIdx.x;
  for (int q = threadIdx.x; q < N * FW; q += FT_THREADS) {
    const int n = q / FW, f = q % FW;
    X[q] = f < F1 ? a.x1[((size_t)b * N + n) * F1 + f]
                  : a.x2[((size_t)b * N + n) * F2 + (f - F1)];
    S[q] = 0.f;
  }
  const float* e = a.e + (size_t)b * P * C;
  for (int p0 = 0; p0 < P; p0 += FT_ROWS) {
    const int rows = min(FT_ROWS, P - p0);
    load_tile_kmajor(E, e + (size_t)p0 * C, rows, C);
    if (threadIdx.x < FT_ROWS) {
      const int r = threadIdx.x;
      W[r] = r < rows ? a.we1[(size_t)b * P + p0 + r] : 0.f;
      W[FT_ROWS + r] = r < rows ? a.we2[(size_t)b * P + p0 + r] : 0.f;
      ep[r] = r < rows ? (int)a.pi[p0 + r] : 0;
      ep[FT_ROWS + r] = r < rows ? (int)a.pj[p0 + r] : 0;
    }
    __syncthreads();
    filter_tile<float, APPROX>(E, V, Tt, ldt, a.fw);
    for (int f = threadIdx.x; f < FW; f += FT_THREADS) {
      const float* w = W + (f < F1 ? 0 : FT_ROWS);
      for (int r = 0; r < rows; ++r) {
        const int i = ep[r], j = ep[FT_ROWS + r];
        const float t = Tt[r * ldt + f] * w[r];
        S[i * FW + f] += t * X[j * FW + f];
        S[j * FW + f] += t * X[i * FW + f];
      }
    }
    __syncthreads();
  }
  for (int q = threadIdx.x; q < N * FW; q += FT_THREADS) {
    const int n = q / FW, f = q % FW;
    if (f < F1)
      a.out1[((size_t)b * N + n) * F1 + f] = S[q];
    else
      a.out2[((size_t)b * N + n) * F2 + (f - F1)] = S[q];
  }
}

// bf16: the graph's pairs in tiles of TC_ROWS through filter_tile_tc, the
// messages summed as in the f32 form; node inputs X stay bf16 (they
// arrive so). Regions: [staged weights (W_SMEM)] [E | Tt] [V] [we1, we2 of
// the tile] [the tile's endpoints i, j] [S: N x FW f32] [X: N x FW bf16].
template <bool APPROX, bool W_SMEM>
__device__ void packed_block_tc(const PackedBlockArgs<bf16>& a, char* smem) {
  const TcDims d = tc_dims(a.fw.C, a.fw.F1, a.fw.F2);
  const int N = a.N, P = a.P, F1 = d.F1, F2 = d.F2, FW = F1 + F2;
  char* p = smem + (W_SMEM ? 2 * tc_weight_elems(d) : 0);
  bf16* E = reinterpret_cast<bf16*>(p);
  float* Tt = reinterpret_cast<float*>(p);
  p += tc_r1_bytes(d);
  bf16* V = reinterpret_cast<bf16*>(p);
  p += tc_v_bytes(d);
  float* Wt = reinterpret_cast<float*>(p);                  // 2 x TC_ROWS
  int* ep = reinterpret_cast<int*>(Wt + 2 * TC_ROWS);       // 2 x TC_ROWS
  float* S = reinterpret_cast<float*>(ep + 2 * TC_ROWS);    // N x FW
  bf16* X = reinterpret_cast<bf16*>(S + (size_t)N * FW);    // N x FW
  const bf16* W = a.tc.wp;
  if (W_SMEM) {
    stage_tc_weights(reinterpret_cast<bf16*>(smem), a.tc.wp,
                     tc_weight_elems(d));
    W = reinterpret_cast<const bf16*>(smem);
  }
  const int b = blockIdx.x;
  for (int q = threadIdx.x; q < N * FW; q += TC_THREADS) {
    const int n = q / FW, f = q % FW;
    X[q] = f < F1 ? a.x1[((size_t)b * N + n) * F1 + f]
                  : a.x2[((size_t)b * N + n) * F2 + (f - F1)];
    S[q] = 0.f;
  }
  const bf16* e = a.e + (size_t)b * P * d.C;
  for (int p0 = 0; p0 < P; p0 += TC_ROWS) {
    const int rows = min(TC_ROWS, P - p0);
    load_tile_tc(E, e + (size_t)p0 * d.C, rows, d);
    for (int r = threadIdx.x; r < rows; r += TC_THREADS) {
      Wt[r] = a.we1[(size_t)b * P + p0 + r];
      Wt[TC_ROWS + r] = a.we2[(size_t)b * P + p0 + r];
      ep[r] = (int)a.pi[p0 + r];
      ep[TC_ROWS + r] = (int)a.pj[p0 + r];
    }
    __syncthreads();
    filter_tile_tc<APPROX, W_SMEM>(E, V, Tt, rows, W, a.tc, d);
    // the pairs of a run that shares endpoint i add to S[i] in a
    // register, stored when i changes: the same sums in the same order
    // as adding to S[i] in shared memory (no pair has j == i)
    for (int f = threadIdx.x; f < FW; f += TC_THREADS) {
      const int col = f < F1 ? f : d.F1p + (f - F1);
      const float* w = Wt + (f < F1 ? 0 : TC_ROWS);
      int ci = ep[0];
      float si = S[ci * FW + f], xi = __bfloat162float(X[ci * FW + f]);
      for (int r = 0; r < rows; ++r) {
        const int i = ep[r], j = ep[TC_ROWS + r];
        if (i != ci) {
          S[ci * FW + f] = si;
          ci = i;
          si = S[i * FW + f];
          xi = __bfloat162float(X[i * FW + f]);
        }
        const float t = Tt[r * d.ldt + col] * w[r];
        si += t * __bfloat162float(X[j * FW + f]);
        S[j * FW + f] += t * xi;
      }
      S[ci * FW + f] = si;
    }
    __syncthreads();
  }
  for (int q = threadIdx.x; q < N * FW; q += TC_THREADS) {
    const int n = q / FW, f = q % FW;
    if (f < F1)
      a.out1[((size_t)b * N + n) * F1 + f] = S[q];
    else
      a.out2[((size_t)b * N + n) * F2 + (f - F1)] = S[q];
  }
}

// One block per graph. LEVEL (bf16): 0 stages the packed weights in
// shared memory, 1 reads them from global memory (kernels/block_packed.py
// level_for)
template <typename T, bool APPROX, int LEVEL>
__global__ void __launch_bounds__(sizeof(T) == 2 ? TC_THREADS : FT_THREADS)
    packed_block_kernel(PackedBlockArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (std::is_same<T, bf16>::value)
    packed_block_tc<APPROX, LEVEL == 0>(a, reinterpret_cast<char*>(smem));
  else
    packed_block_cuda_cores<APPROX>(a, smem);
}

// kernels/block_packed.py smem_bytes mirrors these
static size_t packed_block_smem_f32(int N, int C, int F1, int F2) {
  const size_t fw = F1 + F2;
  return 4 * ((size_t)C * FT_LD + fw * FT_LD + FT_ROWS * (fw + 4)
              + 2 * (size_t)N * fw + 4 * FT_ROWS);
}

static size_t packed_block_smem_tc(int N, int C, int F1, int F2,
                                   int level) {
  const TcDims d = tc_dims(C, F1, F2);
  const size_t fw = F1 + F2;
  return (level == 0 ? 2 * tc_weight_elems(d) : 0) + tc_r1_bytes(d)
         + tc_v_bytes(d) + 4 * TC_ROWS * 4 + (size_t)N * fw * (4 + 2);
}

template <typename T, bool APPROX, int LEVEL>
static int packed_block_run(const PackedBlockArgs<T>& a, int B,
                            cudaStream_t stream) {
  const int C = a.fw.C, F1 = a.fw.F1, F2 = a.fw.F2;
  const size_t smem = std::is_same<T, bf16>::value
                          ? packed_block_smem_tc(a.N, C, F1, F2, LEVEL)
                          : packed_block_smem_f32(a.N, C, F1, F2);
  cudaError_t err = cudaFuncSetAttribute(
      packed_block_kernel<T, APPROX, LEVEL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = std::is_same<T, bf16>::value ? TC_THREADS : FT_THREADS;
  packed_block_kernel<T, APPROX, LEVEL><<<B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static void fill_args(PackedBlockArgs<T>& a, const void* e, const void* we1,
                      const void* we2, const void* x1, const void* x2,
                      const void* pi, const void* pj, const void* const* wts,
                      const void* packed, void* out1, void* out2, int N,
                      int P, int C, int F1, int F2) {
  a.e = static_cast<const T*>(e);
  a.we1 = static_cast<const float*>(we1);
  a.we2 = static_cast<const float*>(we2);
  a.x1 = static_cast<const T*>(x1);
  a.x2 = static_cast<const T*>(x2);
  a.pi = static_cast<const long long*>(pi);
  a.pj = static_cast<const long long*>(pj);
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
  a.N = N; a.P = P;
}

template <typename T, bool APPROX>
static int packed_block_level(const PackedBlockArgs<T>& a, int B, int level,
                              cudaStream_t s) {
  return level == 0 ? packed_block_run<T, APPROX, 0>(a, B, s)
                    : packed_block_run<T, APPROX, 1>(a, B, s);
}

// bf16_: 0 for f32 operands (CUDA cores, level 0), 1 for bf16 (tensor
// cores, level 0 or 1); approx: the polynomial softplus. wts: fa1, fa2,
// fb1, fb2 (of the operand type), ba1, ba2, bb1, bb2, beta1, beta2 (f32);
// packed: the bf16 weights as pack_filter_weights lays them out (bf16
// only).
extern "C" int packed_block_launch(int bf16_, int approx, const void* e,
                                   const void* we1, const void* we2,
                                   const void* x1, const void* x2,
                                   const void* pi, const void* pj,
                                   const void* const* wts,
                                   const void* packed, void* out1,
                                   void* out2, int B, int N, int P, int C,
                                   int F1, int F2, int level, void* stream) {
  if (C % 4 || F1 % 4 || F2 % 4 || N < 2 || B < 1
      || P != N * (N - 1) / 2 || level < 0 || level > (bf16_ ? 1 : 0)
      || (bf16_ && (packed == nullptr
                    || reinterpret_cast<uintptr_t>(packed) % 16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_) {
    PackedBlockArgs<bf16> a;
    fill_args(a, e, we1, we2, x1, x2, pi, pj, wts, packed, out1, out2, N, P,
              C, F1, F2);
    return approx ? packed_block_level<bf16, true>(a, B, level, s)
                  : packed_block_level<bf16, false>(a, B, level, s);
  }
  PackedBlockArgs<float> a;
  fill_args(a, e, we1, we2, x1, x2, pi, pj, wts, packed, out1, out2, N, P, C,
            F1, F2);
  return approx ? packed_block_run<float, true, 0>(a, B, s)
                : packed_block_run<float, false, 0>(a, B, s);
}

extern "C" const char* packed_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
