// Device code shared by K2 (block_packed.cu) and K3, K4 (fused.cu): the
// CFConv filter MLPs of one interaction block, and the matrix product on
// CUDA cores they are built from, on a tile of FT_ROWS rows (pairs).
//
// Operands are held in shared memory as f32 in k-major order (row k of a
// tile is its k-th feature, FT_LD floats apart), so that a thread reads
// the eight rows of its unit as two float4 loads. A value of type T
// (float or bf16) is held as the f32 value it is, so one f32 fused
// multiply-add loop serves both: a product of two bf16 values is exact in
// f32, and every sum is an f32 sum, which is what a bf16 product with an
// f32 accumulator computes. At f32 the products are true f32, not TF32.
//
// Build: included by the sources above, each compiled on its own with
// nvcc -gencode arch=compute_90a,code=sm_90a (kernels/build.py, which
// hashes this header into each library's name).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define FT_ROWS 32                // rows (pairs) per tile
#define FT_THREADS 256            // threads of every block that uses a tile
#define FT_LD (FT_ROWS + 4)       // k-major stride of a tile operand (floats)
#define FT_LN2 0.6931471805599453f

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// x rounded to T, returned as f32
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<bf16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// four consecutive values from global memory (read-only path) as float4;
// p is 16-byte (f32) or 8-byte (bf16) aligned
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// softplus(x) = max(x, 0) + log1p(exp(-|x|)); '-approx' (ops/approx.py,
// same coefficients): max(x, 0) plus a degree-8 polynomial in min(|x|, 8)
template <bool APPROX>
__device__ __forceinline__ float softplus_(float x) {
  if (APPROX) {
    const float t = fminf(fabsf(x), 8.f);
    float acc = -5.52531068e-07f;
    acc = acc * t + 2.03902123e-05f;
    acc = acc * t - 3.09991317e-04f;
    acc = acc * t + 2.42865434e-03f;
    acc = acc * t - 9.28887060e-03f;
    acc = acc * t + 3.08196131e-03f;
    acc = acc * t + 1.24495898e-01f;
    acc = acc * t - 5.00341100e-01f;
    acc = acc * t + 6.93209096e-01f;
    return fmaxf(x, 0.f) + acc;
  }
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// acc[i][j] += sum_k A[k][r0 + i] * W[k][j] for i < 8, j < 4: A k-major in
// shared memory (stride FT_LD), W (global, row stride ldw, type T) already
// offset to the unit's first column.
template <typename T>
__device__ __forceinline__ void gemm_unit(const float* A, const T* W, int ldw,
                                          int K, int r0, float acc[8][4]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + k * FT_LD + r0);
    const float4 a1 =
        *reinterpret_cast<const float4*>(A + k * FT_LD + r0 + 4);
    const float4 w = ldg4(W + (size_t)k * ldw);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i][0] = fmaf(a[i], w.x, acc[i][0]);
      acc[i][1] = fmaf(a[i], w.y, acc[i][1]);
      acc[i][2] = fmaf(a[i], w.z, acc[i][2]);
      acc[i][3] = fmaf(a[i], w.w, acc[i][3]);
    }
  }
}

__device__ __forceinline__ void zero_acc(float acc[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// Rows [0, rows) of a row-major (rows, C) plane of T, k-major into E
// (C x FT_LD floats); rows past `rows` are zero.
template <typename T>
__device__ void load_tile_kmajor(float* E, const T* src, int rows, int C) {
  for (int e = threadIdx.x; e < FT_ROWS * C; e += FT_THREADS) {
    const int r = e / C, k = e % C;
    E[k * FT_LD + r] = r < rows ? to_f(src[(size_t)r * C + k]) : 0.f;
  }
}

// Weights of one block's two filter MLPs: first layers fa1 (C x F1), fa2
// (C x F2) and second layers fb1 (F1 x F1), fb2 (F2 x F2), all of type T,
// row-major; f32 biases and the two learnable betas.
template <typename T>
struct FilterW {
  const T *fa1, *fa2, *fb1, *fb2;
  const float *ba1, *ba2, *bb1, *bb2, *beta1, *beta2;
  int C, F1, F2;
};

// Both filter MLPs on one tile (E: the tile's edge features, k-major):
//   V = ssp(E @ [fa1 | fa2] + [ba1 | ba2]) rounded to T  (k-major, FW rows)
//   Tt[r] = [V1 @ fb1 + bb1 | V2 @ fb2 + bb2]            (row-major, ldt)
// with ssp(x) = softplus(beta x) - ln 2, beta1 on the first F1 columns and
// beta2 on the rest. Every column group of 4 lies in one conv (F1 % 4 ==
// 0). Starts and ends with the block synchronised.
template <typename T, bool APPROX>
__device__ void filter_tile(const float* E, float* V, float* Tt, int ldt,
                            const FilterW<T>& w) {
  const int F1 = w.F1, FW = w.F1 + w.F2, groups = FW / 4;
  const float beta1 = *w.beta1, beta2 = *w.beta2;
  for (int u = threadIdx.x; u < (FT_ROWS / 8) * groups; u += FT_THREADS) {
    const int c = 4 * (u % groups), r0 = 8 * (u / groups);
    const bool first = c < F1;
    float acc[8][4];
    zero_acc(acc);
    if (first)
      gemm_unit(E, w.fa1 + c, F1, w.C, r0, acc);
    else
      gemm_unit(E, w.fa2 + (c - F1), w.F2, w.C, r0, acc);
    const float* ba = first ? w.ba1 + c : w.ba2 + (c - F1);
    const float beta = first ? beta1 : beta2;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        V[(c + j) * FT_LD + r0 + i] = rnd<T>(
            softplus_<APPROX>(beta * (acc[i][j] + ba[j])) - FT_LN2);
  }
  __syncthreads();
  for (int u = threadIdx.x; u < (FT_ROWS / 8) * groups; u += FT_THREADS) {
    const int c = 4 * (u % groups), r0 = 8 * (u / groups);
    const bool first = c < F1;
    float acc[8][4];
    zero_acc(acc);
    if (first)
      gemm_unit(V, w.fb1 + c, F1, F1, r0, acc);
    else
      gemm_unit(V + F1 * FT_LD, w.fb2 + (c - F1), w.F2, w.F2, r0, acc);
    const float* bb = first ? w.bb1 + c : w.bb2 + (c - F1);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Tt[(r0 + i) * ldt + c + j] = acc[i][j] + bb[j];
  }
  __syncthreads();
}
