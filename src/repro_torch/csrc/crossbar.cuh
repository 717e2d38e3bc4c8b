// Pieces shared by the crossbar-MLP kernels: K1 (fused_mlp.cu), K2
// (fused_mlp_mtiled.cu), K3 (fused_mlp_wstat.cu) and K6 (reram_mlp.cu).
//
// All of them compute integer products of int8 activations with 8-bit
// weights stored as four 2-bit offset-binary cell planes:
//   y_int = sum_k x[k] * u[k][n] - (sum_k x[k]) << (weight_bits - 1),
//   u = sum_p plane_p << (cell_bits * p)  (the planes combined into one u8)
// with dp4a (s8 x u8 -> s32, four products per instruction). One block of
// THREADS threads owns a BM x BN output tile; thread (tx, ty) accumulates
// rows ty + TY * i and columns tx + TX * j. Operands are staged in shared
// memory as packed 32-bit words of four consecutive K values: activations
// row-major (word w of row r), weights column-major (word w of column n),
// each with a pitch of one extra word so that the reads of a warp fall in
// distinct banks.
//
// The float steps round exactly as the plain torch versions: rintf (half to
// even), __fdiv_rn, and __fmul_rn/__fadd_rn in the dequantization so that
// nvcc cannot contract it into an FMA.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace xbar {

constexpr int BM = 64;           // output rows per tile
constexpr int BN = 64;           // output columns per tile
constexpr int BK = 32;           // K slab, in int8 values
constexpr int KW = BK / 4;       // packed 32-bit words per slab row
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int THREADS = TX * TY;
constexpr int RM = BM / TY;      // rows per thread: ty + TY * i
constexpr int RN = BN / TX;      // columns per thread: tx + TX * j

__device__ __forceinline__ int dp4a_su(int a, unsigned b, int c) {
  int d;
  asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// clip(rint(a / s), -qmax, qmax) as one int8 byte.
__device__ __forceinline__ unsigned requant(float a, float s, float qmax) {
  float q = rintf(__fdiv_rn(a, s));
  q = fminf(fmaxf(q, -qmax), qmax);
  return static_cast<unsigned>(static_cast<int>(q)) & 0xffu;
}

// Four consecutive activations requantized and packed into one word.
__device__ __forceinline__ int requant4(float4 a, float s, float qmax) {
  return static_cast<int>(
      requant(a.x, s, qmax) | (requant(a.y, s, qmax) << 8) |
      (requant(a.z, s, qmax) << 16) | (requant(a.w, s, qmax) << 24));
}

// The input scale of layer `layer` for batch element b: the external scale
// sx[b] at layer 0, else max(max|y_{l-1}| / qmax, 1e-12) from the max the
// previous launch published in mx (float bits, (B, n_layers)).
__device__ __forceinline__ float layer_scale(bool first, const float* sx,
                                             const int* mx, int b, int layer,
                                             int n_layers, float qmax) {
  return first ? sx[b]
               : fmaxf(__fdiv_rn(__int_as_float(mx[b * n_layers + layer - 1]),
                                 qmax),
                       1e-12f);
}

// The u8 offset-binary weight at element `idx` of one (K, N) plane, its
// n_planes cell planes `plane_stride` bytes apart, combined by shift-and-add.
__device__ __forceinline__ unsigned combined_weight(
    const int8_t* __restrict__ planes, size_t plane_stride, size_t idx,
    int n_planes, int cell_bits) {
  unsigned u = 0;
  for (int p = 0; p < n_planes; ++p)
    u += static_cast<unsigned>(static_cast<uint8_t>(
             planes[static_cast<size_t>(p) * plane_stride + idx]))
         << (cell_bits * p);
  return u;
}

// Four consecutive K values (k .. k+3) of column n of a (d, d) layer of
// planes, combined and packed into one word.
__device__ __forceinline__ unsigned combined_word(
    const int8_t* __restrict__ planes, int d, int k, int n, int n_planes,
    int cell_bits) {
  const size_t stride = static_cast<size_t>(d) * d;
  unsigned packed = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    packed |= combined_weight(planes, stride,
                              static_cast<size_t>(k + q) * d + n, n_planes,
                              cell_bits)
              << (8 * q);
  return packed;
}

// One K slab (KW words) of the product: xs points at word 0 of the slab in
// row 0 of the activation tile (row pitch xp words), ws at word 0 of the
// slab in column 0 of the weight tile (column pitch wp words). ROWSUMS also
// accumulates each row's sum of activations (dp4a against 0x01010101).
template <bool ROWSUMS>
__device__ __forceinline__ void dot_slab(const int* xs, int xp,
                                         const unsigned* ws, int wp, int tx,
                                         int ty, int (&acc)[RM][RN],
                                         int (&rs)[RM]) {
#pragma unroll
  for (int w = 0; w < KW; ++w) {
    int a[RM];
    unsigned wb[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = xs[(ty + TY * i) * xp + w];
#pragma unroll
    for (int j = 0; j < RN; ++j) wb[j] = ws[(tx + TX * j) * wp + w];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      if (ROWSUMS) rs[i] = dp4a_su(a[i], 0x01010101u, rs[i]);
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = dp4a_su(a[i], wb[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero_acc(int (&acc)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0;
}

// The dequantization epilogue of one thread's RM x RN patch of a tile whose
// first row is panel row `row0` (row m0 of its batch element) and first
// column n0:
//   y = float(acc - rs << (weight_bits - 1)) * c + bias; ReLU; * col_mask;
//   rows >= m_real zeroed
// written to out (row pitch d floats). Returns the patch's max |y|.
__device__ __forceinline__ float store_patch(
    const int (&acc)[RM][RN], const int (&rs)[RM], float* __restrict__ out,
    size_t row0, int m0, int n0, int d, int m_real, float c, int weight_bits,
    const float* __restrict__ bias, const float* __restrict__ mask, int relu,
    int tx, int ty) {
  const int offset = 1 << (weight_bits - 1);
  float local = 0.0f;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = m0 + ty + TY * i;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + tx + TX * j;
      const int yi = acc[i][j] - rs[i] * offset;
      float y = __fadd_rn(__fmul_rn(static_cast<float>(yi), c), bias[n]);
      if (relu) y = fmaxf(y, 0.0f);
      y = __fmul_rn(y, mask[n]);
      if (r >= m_real) y = 0.0f;
      local = fmaxf(local, fabsf(y));
      out[(row0 + ty + TY * i) * d + n] = y;
    }
  }
  return local;
}

// Reduce the block's max |y| and publish it with one atomicMax on the
// float's bits (valid because |y| >= 0). Every thread of the block must
// call it; red holds THREADS / 32 floats of shared memory.
__device__ __forceinline__ void publish_max(float local, float* red,
                                            int* dst) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    local = fmaxf(local, __shfl_xor_sync(0xffffffffu, local, o));
  if ((tid & 31) == 0) red[tid >> 5] = local;
  __syncthreads();
  if (tid == 0) {
    float m = red[0];
    for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, red[w]);
    atomicMax(dst, __float_as_int(m));
  }
  __syncthreads();
}

// Allow `bytes` of dynamic shared memory for `kernel` (above 48 KB a launch
// is refused without it). Returns the cudaError_t.
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace xbar
