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
// Design. One block per graph. The graph's pairs run in tiles of FT_ROWS
// through the filter MLPs of filter_mlp.cuh (CUDA-core f32 fused
// multiply-adds on bf16- or f32-valued operands). The node inputs are
// staged in shared memory as f32 and the node sums kept there; one thread
// owns a column f of every node's sum and adds the tile's messages in
// increasing pair order, so each sum is taken in a fixed order (no
// atomics) and the result reproduces bit for bit. The TPU kernel's
// one-hot endpoint selector products ([EJ; EI] x, then [EI^T | EJ^T] m)
// would be N/2 times the work here; the endpoints come from the pair list.
//
// Bound at B = 128, N = 32 (P = 496), C = H = 128, bf16: ~5.8 GFLOP a
// launch, 0.006 ms at the tensor cores' 989 TFLOP/s, which these CUDA-core
// products do not reach (a later PR's work: wmma or wgmma tiles, more
// blocks per graph); the bytes (e 16 MB) take 0.005 ms. chip_smoke.py
// computes both from each run's shapes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (kernels/build.py).

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
  float* out1;             // (B, N, F1)
  float* out2;             // (B, N, F2)
  int N, P;
};

template <typename T, bool APPROX>
__global__ void __launch_bounds__(FT_THREADS)
    packed_block_kernel(PackedBlockArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
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
    X[q] = f < F1 ? to_f(a.x1[((size_t)b * N + n) * F1 + f])
                  : to_f(a.x2[((size_t)b * N + n) * F2 + (f - F1)]);
    S[q] = 0.f;
  }
  const T* e = a.e + (size_t)b * P * C;
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
    filter_tile<T, APPROX>(E, V, Tt, ldt, a.fw);
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

// kernels/block_packed.py smem_bytes mirrors this
static size_t packed_block_smem(int N, int C, int F1, int F2) {
  const size_t fw = F1 + F2;
  return 4 * ((size_t)C * FT_LD + fw * FT_LD + FT_ROWS * (fw + 4)
              + 2 * (size_t)N * fw + 4 * FT_ROWS);
}

template <typename T, bool APPROX>
static int packed_block_run(const void* e, const void* we1, const void* we2,
                            const void* x1, const void* x2, const void* pi,
                            const void* pj, const void* const* wts,
                            void* out1, void* out2, int B, int N, int P,
                            int C, int F1, int F2, cudaStream_t stream) {
  PackedBlockArgs<T> a;
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
  a.fw.ba1 = static_cast<const float*>(wts[4]);
  a.fw.ba2 = static_cast<const float*>(wts[5]);
  a.fw.bb1 = static_cast<const float*>(wts[6]);
  a.fw.bb2 = static_cast<const float*>(wts[7]);
  a.fw.beta1 = static_cast<const float*>(wts[8]);
  a.fw.beta2 = static_cast<const float*>(wts[9]);
  a.fw.C = C; a.fw.F1 = F1; a.fw.F2 = F2;
  a.out1 = static_cast<float*>(out1);
  a.out2 = static_cast<float*>(out2);
  a.N = N; a.P = P;
  const size_t smem = packed_block_smem(N, C, F1, F2);
  cudaError_t err = cudaFuncSetAttribute(
      packed_block_kernel<T, APPROX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  packed_block_kernel<T, APPROX><<<B, FT_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// bf16_: 0 for f32 operands, 1 for bf16; approx: the polynomial softplus.
// wts: fa1, fa2, fb1, fb2 (of the operand type), ba1, ba2, bb1, bb2,
// beta1, beta2 (f32).
extern "C" int packed_block_launch(int bf16_, int approx, const void* e,
                                   const void* we1, const void* we2,
                                   const void* x1, const void* x2,
                                   const void* pi, const void* pj,
                                   const void* const* wts, void* out1,
                                   void* out2, int B, int N, int P, int C,
                                   int F1, int F2, void* stream) {
  if (C % 4 || F1 % 4 || F2 % 4 || N < 2 || B < 1
      || P != N * (N - 1) / 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_)
    return approx ? packed_block_run<bf16, true>(e, we1, we2, x1, x2, pi, pj,
                                                 wts, out1, out2, B, N, P, C,
                                                 F1, F2, s)
                  : packed_block_run<bf16, false>(e, we1, we2, x1, x2, pi,
                                                  pj, wts, out1, out2, B, N,
                                                  P, C, F1, F2, s);
  return approx ? packed_block_run<float, true>(e, we1, we2, x1, x2, pi, pj,
                                                wts, out1, out2, B, N, P, C,
                                                F1, F2, s)
                : packed_block_run<float, false>(e, we1, we2, x1, x2, pi, pj,
                                                 wts, out1, out2, B, N, P, C,
                                                 F1, F2, s);
}

extern "C" const char* packed_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
