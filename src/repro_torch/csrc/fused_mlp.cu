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
// 2^24, so int32 never overflows and the float conversion is exact. The
// pieces shared with K2, K3 and K6 are in crossbar.cuh.
//
// Bound on the H100: at model1's widths the MLP does 100-260 int8 ops per
// byte of its f32 output, below the card's ~590 ops/byte balance point
// (1,979 TOP/s over 3.35 TB/s), so the function is bound by bytes. This
// first version
// also moves each intermediate panel through L2/HBM once per layer and
// re-stages the planes per block; wgmma and TMA are later work.

#include "crossbar.cuh"

namespace {

using namespace xbar;

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
  const float s = layer_scale(FIRST, sx, mx, b, layer, n_layers, qmax);
  const size_t row0 = static_cast<size_t>(b) * m_pad + m0;

  int acc[RM][RN];
  int rs[RM] = {};
  zero_acc(acc);

  for (int k0 = 0; k0 < k_lim; k0 += BK) {
    for (int e = tid; e < BM * KW; e += THREADS) {
      const int r = e / KW, w = e % KW;
      const size_t off = (row0 + r) * d + k0 + 4 * w;
      if (FIRST) {
        xs[r][w] = *reinterpret_cast<const int*>(x0 + off);
      } else {
        xs[r][w] = requant4(*reinterpret_cast<const float4*>(act_in + off),
                            s, qmax);
      }
    }
    for (int e = tid; e < BN * KW; e += THREADS) {
      const int n = e % BN, w = e / BN;
      ws[n][w] = combined_word(planes, d, k0 + 4 * w, n0 + n, n_planes,
                               cell_bits);
    }
    __syncthreads();
    dot_slab<true>(&xs[0][0], KW + 1, &ws[0][0], KW + 1, tx, ty, acc, rs);
    __syncthreads();
  }

  const float local = store_patch(acc, rs, act_out, row0, m0, n0, d, m_real,
                                  __fmul_rn(s, *w_scale), weight_bits, bias,
                                  mask, relu, tx, ty);
  publish_max(local, red, &mx[b * n_layers + layer]);
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
  auto kernel = layer == 0 ? &fused_mlp_layer_kernel<true>
                           : &fused_mlp_layer_kernel<false>;
  kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const int8_t*>(x0), static_cast<const float*>(act_in),
      static_cast<float*>(act_out), static_cast<const int8_t*>(planes),
      static_cast<const float*>(bias), static_cast<const float*>(mask),
      static_cast<const float*>(w_scale), static_cast<const float*>(sx),
      static_cast<int*>(mx), layer, n_layers, n_planes, cell_bits,
      weight_bits, m_pad, m_real, d, k_lim, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
