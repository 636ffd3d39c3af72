// Device code shared by K2 (block_packed.cu), K3, K4 (fused.cu) and K6
// (mono.cu): the CFConv filter MLPs of one interaction block, in two
// forms, and the tensor-core unit that K4's bf16 layers also run on.
//
// On CUDA cores (filter_tile and gemm_unit, K2's f32 variant), on a tile
// of FT_ROWS rows (pairs). Operands are held in
// shared memory as f32 in k-major order (row k of a tile is its k-th
// feature, FT_LD floats apart), so that a thread reads the eight rows of
// its unit as two float4 loads. A value of type T (float or bf16) is held
// as the f32 value it is, so one f32 fused multiply-add loop serves both: a
// product of two bf16 values is exact in f32, and every sum is an f32 sum,
// which is what a bf16 product with an f32 accumulator computes. At f32
// the products are true f32, not TF32: the tensor cores offer only TF32
// for f32 operands, so the f32 variants stay here.
//
// On the tensor cores (filter_tile_tc, the bf16 variants of K2, K3 and
// K6's filters; K4 at bf16 calls tc_unit with its own relu epilogues), on
// a tile of TC_ROWS rows: bf16 x bf16 -> f32 products through
// mma.sync.m16n8k16 in PTX, whose fragment layout is documented, so that
// the epilogues (bias, ssp, bf16 rounding; bias) work on the accumulators
// where they are, with no f32 staging tile. The operand tiles E and V are
// bf16, row-major, rows padded by TC_PAD elements (16 bytes), so that the
// eight rows an ldmatrix reads fall on eight different bank groups. The
// four filter matrices arrive packed by the wrapper
// (kernels/fused.py pack_filter_weights) in the order a warp reads its B
// fragments; a block stages them once into shared memory (layout level 0)
// or reads them from global memory through L2 (level 1) with the same
// loads and products, so both levels give the same bits. Widths are
// zero-padded to multiples of 16 (C to Cp, F1 to F1p, F2 to F2p); padded
// weights are 0, so padded columns add nothing. Bounded by bytes (the edge
// features) at the main shapes, not by these products (fused.cu,
// block_packed.cu).
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
#define FT_THREADS 256            // threads of a block that uses such tiles
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

// max and min that keep NaN, as the reference's relu and clamps do (CUDA's
// fmaxf(NaN, 0.f) is 0, which hid a diverging graph from the sampler's
// guard): PTX max.NaN / min.NaN (sm_80 and later), the bits of fmaxf and
// fminf on every other input. relu(x) is every kernel's relu.
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
  return relu(x) + log1pf(expf(-fabsf(x)));
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

// ---- the bf16 filter MLPs on the tensor cores ------------------------------

#define TC_ROWS 64                // rows (pairs) per tensor-core tile
#define TC_THREADS 512            // threads of a block that uses such tiles
#define TC_PAD 8                  // bf16 elements padding each operand row
#define TC_BLOCK 256              // bf16 values of one packed 16 x 16 block

__host__ __device__ __forceinline__ int pad16(int x) { return (x + 15) & ~15; }

// Widths, padded widths and strides of a tensor-core filter tile; the
// region sizes below are mirrored by kernels/fused.py (tc_regions)
struct TcDims {
  int C, F1, F2, Cp, F1p, F2p, FWp;  // FWp = F1p + F2p
  int lde, ldv, ldt;                 // strides of E, V (bf16), Tt (f32)
};

__host__ __device__ inline TcDims tc_dims(int C, int F1, int F2) {
  TcDims d;
  d.C = C; d.F1 = F1; d.F2 = F2;
  d.Cp = pad16(C); d.F1p = pad16(F1); d.F2p = pad16(F2);
  d.FWp = d.F1p + d.F2p;
  d.lde = d.Cp + TC_PAD;
  d.ldv = d.FWp + TC_PAD;
  d.ldt = d.FWp + 8;   // float2 stores of a half-warp hit 16 banks apart
  return d;
}

// bf16 values of the packed weights: fa = [fa1 | fa2] (Cp x FWp), then
// fb1 (F1p x F1p), then fb2 (F2p x F2p)
__host__ __device__ inline size_t tc_weight_elems(const TcDims& d) {
  return (size_t)d.Cp * d.FWp + (size_t)d.F1p * d.F1p
         + (size_t)d.F2p * d.F2p;
}
// R1 holds the tile's edge features E, then (after the first layer) Tt
__host__ __device__ inline size_t tc_r1_bytes(const TcDims& d) {
  const size_t e = (size_t)TC_ROWS * d.lde * 2;
  const size_t t = (size_t)TC_ROWS * d.ldt * 4;
  return e > t ? e : t;
}
__host__ __device__ inline size_t tc_v_bytes(const TcDims& d) {
  return (size_t)TC_ROWS * d.ldv * 2;
}

// Biases, betas and packed weights of one block's two filter MLPs at bf16
struct FilterTC {
  const bf16* wp;          // packed weights (global memory)
  const float *ba1, *ba2, *bb1, *bb2, *beta1, *beta2;
};

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address
// of row (l & 15), column 8 (l >> 4) of a 16 x 16 A tile, and r[0..3] are
// then the a0..a3 registers of mma.m16n8k16's A fragment
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16 x 16, row-major) x b (16 x 8), bf16 in, f32 accumulate;
// lane (g, t) = (lane / 4, lane % 4) holds d at rows g, g + 8, columns
// 2t, 2t + 1
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One lane's B fragments of a packed 16 x 16 block: (b0, b1) of the left
// n8 half in x, y and of the right half in z, w
template <bool W_SMEM>
__device__ __forceinline__ uint4 ld_bfrag(const bf16* p) {
  if (!W_SMEM) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 v;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}

// acc[m][n] += A[rows 16m.., all k] x strip[all k, columns 8n..] for a
// warp's unit of 32 rows x 16 columns: A bf16 row-major in shared memory
// (stride lda, its first row), the strip KT packed blocks of one 16-column
// strip
template <bool W_SMEM>
__device__ __forceinline__ void tc_unit(float acc[2][2][4], const bf16* A,
                                        int lda, const bf16* strip, int KT,
                                        int lane) {
  const bf16* a = A + (lane & 15) * lda + (lane >> 4) * 8;
  const bf16* b = strip + lane * 8;
#pragma unroll 2
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t a0[4], a1[4];
    ldsm_x4(a0, a + kt * 16);
    ldsm_x4(a1, a + 16 * lda + kt * 16);
    const uint4 w = ld_bfrag<W_SMEM>(b + (size_t)kt * TC_BLOCK);
    mma_bf16(acc[0][0], a0, w.x, w.y);
    mma_bf16(acc[0][1], a0, w.z, w.w);
    mma_bf16(acc[1][0], a1, w.x, w.y);
    mma_bf16(acc[1][1], a1, w.z, w.w);
  }
}

// The packed weights (global) into shared memory, 16 bytes a thread at a
// time; the caller's next barrier publishes them
__device__ void stage_tc_weights(bf16* dst, const bf16* src, size_t elems) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* t = reinterpret_cast<uint4*>(dst);
  for (size_t q = threadIdx.x; q < elems / 8; q += TC_THREADS)
    t[q] = __ldg(s + q);
}

// Rows [0, rows) of a row-major (rows, C) bf16 plane into E (stride lde),
// with zeros in columns [C, Cp) and in the rows past `rows` that the
// products read (to 32 or TC_ROWS). 16-byte loads where C % 8 == 0 and
// src is 16-byte aligned, else 8-byte (C % 4 == 0; the wrapper checks the
// alignment).
__device__ void load_tile_tc(bf16* E, const bf16* src, int rows,
                             const TcDims& d) {
  const int rows_read = rows > 32 ? TC_ROWS : 32;
  if ((d.C & 7) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int vpr = d.Cp / 8;
    for (int q = threadIdx.x; q < rows_read * vpr; q += TC_THREADS) {
      const int r = q / vpr, c = 8 * (q % vpr);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && c < d.C)
        v = __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * d.C + c));
      *reinterpret_cast<uint4*>(E + r * d.lde + c) = v;
    }
  } else {
    const int vpr = d.Cp / 4;
    for (int q = threadIdx.x; q < rows_read * vpr; q += TC_THREADS) {
      const int r = q / vpr, c = 4 * (q % vpr);
      uint2 v = make_uint2(0u, 0u);
      if (r < rows && c < d.C)
        v = __ldg(reinterpret_cast<const uint2*>(src + (size_t)r * d.C + c));
      *reinterpret_cast<uint2*>(E + r * d.lde + c) = v;
    }
  }
}

// Both filter MLPs on a tile of `rows` (<= TC_ROWS) rows, E as
// load_tile_tc leaves it:
//   V  = ssp(E @ [fa1 | fa2] + [ba1 | ba2]) rounded to bf16   (stride ldv)
//   Tt = [V1 @ fb1 + bb1 | V2 @ fb2 + bb2]                     (f32, ldt)
// conv 1 in columns [0, F1p) of V and Tt, conv 2 in [F1p, FWp); padded
// columns hold 0. ssp(x) = softplus(beta x) - ln 2 with beta1 or beta2.
// A warp's unit is 32 rows x 16 columns, units round-robin over the
// warps; the second 32-row half runs only when rows > 32. Tt may alias E
// (it is written after the first layer's barrier). W: the packed weights,
// staged in shared memory (W_SMEM) or in global memory. Starts and ends
// with the block synchronised.
template <bool APPROX, bool W_SMEM>
__device__ void filter_tile_tc(const bf16* E, bf16* V, float* Tt, int rows,
                               const bf16* W, const FilterTC& w,
                               const TcDims& d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, nw = TC_THREADS / 32;
  const int halves = rows > 32 ? 2 : 1;
  const int ct1 = d.F1p / 16, ct2 = d.F2p / 16;
  const float beta1 = *w.beta1, beta2 = *w.beta2;
  // first layers: strips of [fa1 | fa2], K = Cp
  for (int u = warp; u < halves * (ct1 + ct2); u += nw) {
    const int ct = u / halves, r0 = 32 * (u % halves);
    float acc[2][2][4] = {};
    tc_unit<W_SMEM>(acc, E + r0 * d.lde, d.lde,
                    W + (size_t)ct * (d.Cp / 16) * TC_BLOCK, d.Cp / 16, lane);
    const bool first = ct < ct1;
    const float beta = first ? beta1 : beta2;
    const float* ba = first ? w.ba1 : w.ba2;
    const int F = first ? d.F1 : d.F2;
    const int c0 = 16 * ct - (first ? 0 : d.F1p);   // column in its conv
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int cl = c0 + 8 * n + 2 * t;          // F % 4 == 0: cl + 1 < F too
      const bool real = cl < F;
      const float b0 = real ? ba[cl] : 0.f, b1 = real ? ba[cl + 1] : 0.f;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x0 = acc[m][n][2 * h], x1 = acc[m][n][2 * h + 1];
          const __nv_bfloat162 v =
              real ? __floats2bfloat162_rn(
                         softplus_<APPROX>(beta * (x0 + b0)) - FT_LN2,
                         softplus_<APPROX>(beta * (x1 + b1)) - FT_LN2)
                   : __floats2bfloat162_rn(0.f, 0.f);
          *reinterpret_cast<__nv_bfloat162*>(
              V + (r0 + 16 * m + g + 8 * h) * d.ldv + 16 * ct + 8 * n
              + 2 * t) = v;
        }
    }
  }
  __syncthreads();
  // second layers: strips of fb1 (K = F1p) on V1, of fb2 (K = F2p) on V2
  const bf16* fb1 = W + (size_t)d.Cp * d.FWp;
  const bf16* fb2 = fb1 + (size_t)d.F1p * d.F1p;
  for (int u = warp; u < halves * (ct1 + ct2); u += nw) {
    const bool first = u < halves * ct1;
    const int v = first ? u : u - halves * ct1;
    const int ct = v / halves, r0 = 32 * (v % halves);
    const int KT = (first ? d.F1p : d.F2p) / 16;
    float acc[2][2][4] = {};
    tc_unit<W_SMEM>(acc, V + r0 * d.ldv + (first ? 0 : d.F1p), d.ldv,
                    (first ? fb1 : fb2) + (size_t)ct * KT * TC_BLOCK, KT,
                    lane);
    const float* bb = first ? w.bb1 : w.bb2;
    const int F = first ? d.F1 : d.F2;
    const int col0 = (first ? 0 : d.F1p) + 16 * ct;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int cl = 16 * ct + 8 * n + 2 * t;
      const bool real = cl < F;
      const float b0 = real ? bb[cl] : 0.f, b1 = real ? bb[cl + 1] : 0.f;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              Tt + (r0 + 16 * m + g + 8 * h) * d.ldt + col0 + 8 * n
              + 2 * t) =
              real ? make_float2(acc[m][n][2 * h] + b0,
                                 acc[m][n][2 * h + 1] + b1)
                   : make_float2(0.f, 0.f);
    }
  }
  __syncthreads();
}
