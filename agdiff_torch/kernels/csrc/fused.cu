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
// Design. K3 and K4: one block of FT_THREADS threads per node row (b, i);
// its N pairs (b, i, j) run in tiles of FT_ROWS rows through the matrix
// products of filter_mlp.cuh on CUDA cores (f32 fused multiply-adds on
// f32 or bf16-valued operands: true f32 at f32). K3 sums each column f of
// its row in one thread, over j in increasing order, so the result
// reproduces bit for bit. K5 is a streaming pass: one thread per four
// columns of a row (b, i), over j in increasing order.
//
// Bounds at B = 128, N = 32, C = H = 128 (chip_smoke.py computes them from
// each run's shapes): K3 and K4 do ~11-12 GFLOP a launch; at f32 on CUDA
// cores (67 TFLOP/s) they are bound by operations, ~0.17 ms; at bf16 the
// same work bounds them at ~0.012 ms on the tensor cores, which these
// kernels do not use (a later PR's work). K5 reads 67 MB of f32 edge
// features for ~50 MFLOP: bound by bytes, ~0.02 ms.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (kernels/build.py).

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
  float* out1;             // (B, N, F1)
  float* out2;             // (B, N, F2)
  int N;
};

template <typename T>
__global__ void __launch_bounds__(FT_THREADS)
    block_agg_kernel(BlockAggArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  const int C = a.fw.C, F1 = a.fw.F1, F2 = a.fw.F2, FW = F1 + F2;
  const int N = a.N, ldt = FW + 4;
  float* E = smem;                      // C x FT_LD
  float* V = E + C * FT_LD;             // FW x FT_LD
  float* Tt = V + FW * FT_LD;           // FT_ROWS x ldt
  float* W = Tt + FT_ROWS * ldt;        // 2 x FT_ROWS
  const int row = blockIdx.x, b = row / N;
  const T* e = a.e + (size_t)row * N * C;
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
    filter_tile<T, false>(E, V, Tt, ldt, a.fw);
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

static size_t block_agg_smem(int C, int F1, int F2) {
  const size_t fw = F1 + F2;
  return 4 * ((size_t)C * FT_LD + fw * FT_LD + FT_ROWS * (fw + 4)
              + 2 * FT_ROWS);
}

template <typename T>
static int block_agg_run(const void* e, const void* w1, const void* w2,
                         const void* h1, const void* h2,
                         const void* const* wts, void* out1, void* out2,
                         int B, int N, int C, int F1, int F2,
                         cudaStream_t stream) {
  BlockAggArgs<T> a;
  a.e = static_cast<const T*>(e);
  a.w1 = static_cast<const float*>(w1);
  a.w2 = static_cast<const float*>(w2);
  a.h1 = static_cast<const float*>(h1);
  a.h2 = static_cast<const float*>(h2);
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
  a.N = N;
  const size_t smem = block_agg_smem(C, F1, F2);
  cudaError_t err = cudaFuncSetAttribute(
      block_agg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  block_agg_kernel<T><<<B * N, FT_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// bf16: 0 for f32 operands, 1 for bf16. wts: fa1, fa2, fb1, fb2 (of the
// operand type), ba1, ba2, bb1, bb2, beta1, beta2 (f32).
extern "C" int block_agg_launch(int bf16_, const void* e, const void* w1,
                                const void* w2, const void* h1,
                                const void* h2, const void* const* wts,
                                void* out1, void* out2, int B, int N, int C,
                                int F1, int F2, void* stream) {
  if (C % 4 || F1 % 4 || F2 % 4 || F1 + F2 > FT_THREADS || N < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_ ? block_agg_run<bf16>(e, w1, w2, h1, h2, wts, out1, out2, B,
                                     N, C, F1, F2, s)
               : block_agg_run<float>(e, w1, w2, h1, h2, wts, out1, out2, B,
                                      N, C, F1, F2, s);
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
