// K1 on Hopper: one layer of the fused bit-sliced INT8 crossbar MLP.
//
// Replaces the TPU kernel src/repro/kernels/fused_mlp.py::_kernel (the
// 'whole'/'tiled' dataflows, launched from reram_mlp_fused[_batched]).
//
// What it computes, for one batch element b and one layer l of the
// programmed MLP (every integer step exact, every float step one IEEE
// operation rounded to nearest, so the result equals the plain torch
// version in repro_torch/kernels/fused_mlp.py bit for bit):
//   s      = sx[b] (layer 0) or max(max|y_{l-1}| / qmax, 1e-12)
//   x      = layer 0: the pre-quantized int8 input;
//            else clip(rint(act / s), -qmax, qmax)       (half to even)
//   y_int  = sum_k x[k] * u[k][n] - (sum_k x[k]) << (weight_bits - 1),
//            u = sum_p plane_p << (cell_bits * p), the offset-binary weight
//   y      = float(y_int) * (s * w_scale) + bias; ReLU; * col_mask;
//            rows >= m_real zeroed
//   mx[b][l] = max |y| over the layer (feeds layer l+1's scale).
//
// Design. The TPU kernel ran the whole MLP in one sequential grid and
// carried the next layer's scale — a max over the whole layer's output —
// in SMEM. Blocks on Hopper run in no order, so this is one launch per
// layer: each block reduces its tile's max|y| and publishes it with one
// atomicMax on the float's bits (valid because |y| >= 0), and the next
// launch on the same stream reads the finished max and derives its scale
// on the device. Activations ping-pong between two float32 panels in
// device memory (a layer's output cannot overwrite its input: blocks of
// other N-tiles still read those rows). The integer product stages a
// BLOCK_K-byte K slab of the input (requantized on load) and of the
// weights (the four 2-bit planes combined into one u8 per weight on load)
// in shared memory, and each thread accumulates a 4x4 output patch with
// dp4a (s8 x u8 -> s32, four products per instruction). Sums stay below
// 2^24, so int32 never overflows and the float conversion is exact.
//
// Bound on the H100: at model1's widths the MLP does 100-260 int8 ops per
// byte of its f32 output, below the card's ~590 ops/byte balance point
// (1,979 TOP/s over 3.35 TB/s), so the function is bound by bytes. This
// first version
// also moves each intermediate panel through L2/HBM once per layer and
// re-stages the planes per block; wgmma and TMA are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;           // output rows per block
constexpr int BN = 64;           // output columns per block
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

__device__ __forceinline__ unsigned requant(float a, float s, float qmax) {
  float q = rintf(__fdiv_rn(a, s));
  q = fminf(fmaxf(q, -qmax), qmax);
  return static_cast<unsigned>(static_cast<int>(q)) & 0xffu;
}

template <bool FIRST>
__global__ void __launch_bounds__(THREADS)
fused_mlp_layer_kernel(const int8_t* __restrict__ x0,
                       const float* __restrict__ act_in,
                       float* __restrict__ act_out,
                       const int8_t* __restrict__ planes,
                       const float* __restrict__ bias,
                       const float* __restrict__ mask,
                       const float* __restrict__ w_scale,
                       const float* __restrict__ sx,
                       int* __restrict__ mx,
                       int layer, int n_layers, int n_planes, int cell_bits,
                       int weight_bits, int m_pad, int m_real, int d,
                       int k_lim, int relu) {
  __shared__ int xs[BM][KW + 1];
  __shared__ unsigned ws[BN][KW + 1];
  __shared__ float red[THREADS / 32];

  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const float qmax = static_cast<float>((1 << (weight_bits - 1)) - 1);
  const float s = FIRST
      ? sx[b]
      : fmaxf(__fdiv_rn(__int_as_float(mx[b * n_layers + layer - 1]), qmax),
              1e-12f);
  const size_t row0 = static_cast<size_t>(b) * m_pad + m0;

  int acc[RM][RN];
  int rs[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    rs[i] = 0;
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0;
  }

  for (int k0 = 0; k0 < k_lim; k0 += BK) {
    for (int e = tid; e < BM * KW; e += THREADS) {
      const int r = e / KW, w = e % KW;
      const size_t off = (row0 + r) * d + k0 + 4 * w;
      if (FIRST) {
        xs[r][w] = *reinterpret_cast<const int*>(x0 + off);
      } else {
        const float4 a = *reinterpret_cast<const float4*>(act_in + off);
        xs[r][w] = static_cast<int>(
            requant(a.x, s, qmax) | (requant(a.y, s, qmax) << 8) |
            (requant(a.z, s, qmax) << 16) | (requant(a.w, s, qmax) << 24));
      }
    }
    for (int e = tid; e < BN * KW; e += THREADS) {
      const int n = e % BN, w = e / BN;
      unsigned packed = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + 4 * w + q;
        unsigned u = 0;
        for (int p = 0; p < n_planes; ++p)
          u += static_cast<unsigned>(static_cast<uint8_t>(
                   planes[(static_cast<size_t>(p) * d + k) * d + n0 + n]))
               << (cell_bits * p);
        packed |= u << (8 * q);
      }
      ws[n][w] = packed;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      int a[RM];
      unsigned wb[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = xs[ty + TY * i][w];
#pragma unroll
      for (int j = 0; j < RN; ++j) wb[j] = ws[tx + TX * j][w];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        rs[i] = dp4a_su(a[i], 0x01010101u, rs[i]);
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = dp4a_su(a[i], wb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  const float c = __fmul_rn(s, *w_scale);
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
      act_out[(row0 + ty + TY * i) * d + n] = y;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    local = fmaxf(local, __shfl_xor_sync(0xffffffffu, local, o));
  if ((tid & 31) == 0) red[tid >> 5] = local;
  __syncthreads();
  if (tid == 0) {
    float m = red[0];
    for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, red[w]);
    atomicMax(&mx[b * n_layers + layer], __float_as_int(m));
  }
}

}  // namespace

extern "C" {

// Tile edges the wrapper's launch geometry must agree with.
int fused_mlp_tile(int which) {
  return which == 0 ? BM : which == 1 ? BN : BK;
}

// One layer over the grid (n_lim / BN, m_pad / BM, batch). Returns the
// cudaError_t of the launch (0 on success).
int fused_mlp_layer(const void* x0, const void* act_in, void* act_out,
                    const void* planes, const void* bias, const void* mask,
                    const void* w_scale, const void* sx, void* mx,
                    int layer, int n_layers, int n_planes, int cell_bits,
                    int weight_bits, int batch, int m_pad, int m_real, int d,
                    int k_lim, int n_lim, int relu, void* stream) {
  const dim3 grid(n_lim / BN, m_pad / BM, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layer == 0) {
    fused_mlp_layer_kernel<true><<<grid, THREADS, 0, st>>>(
        static_cast<const int8_t*>(x0), static_cast<const float*>(act_in),
        static_cast<float*>(act_out), static_cast<const int8_t*>(planes),
        static_cast<const float*>(bias), static_cast<const float*>(mask),
        static_cast<const float*>(w_scale), static_cast<const float*>(sx),
        static_cast<int*>(mx), layer, n_layers, n_planes, cell_bits,
        weight_bits, m_pad, m_real, d, k_lim, relu);
  } else {
    fused_mlp_layer_kernel<false><<<grid, THREADS, 0, st>>>(
        static_cast<const int8_t*>(x0), static_cast<const float*>(act_in),
        static_cast<float*>(act_out), static_cast<const int8_t*>(planes),
        static_cast<const float*>(bias), static_cast<const float*>(mask),
        static_cast<const float*>(w_scale), static_cast<const float*>(sx),
        static_cast<int*>(mx), layer, n_layers, n_planes, cell_bits,
        weight_bits, m_pad, m_real, d, k_lim, relu);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
