// K6 on Hopper: the bit-sliced INT8 crossbar matmul of the per-layer
// 'reram' backend.
//
// Replaces the TPU kernel src/repro/kernels/reram_mlp.py::_kernel
// (reram_matmul_int). It computes, exactly in int32,
//   y[m][n] = sum_k x[m][k] * u[k][n] - (sum_k x[m][k]) << (weight_bits - 1)
// with u = sum_p plane_p << (cell_bits * p), the offset-binary weight held
// as four 2-bit cell planes (P, K, N) — that is, x @ (combine(planes) -
// 2^(weight_bits - 1)).
//
// Design. The TPU kernel walked a (M/128, N/128, K/128) grid with K
// innermost and carried the int32 sum in VMEM across K steps, on operands
// padded to the 128 x 128 crossbar. Here a block owns a BM x BN output tile
// and loops over K itself, staging each BK-wide slab of the activations and
// of the weights (the planes combined into u8 on load) in shared memory;
// dp4a does the s8 x u8 products and the row sums, as in K1 (crossbar.cuh).
// No padding is needed: the ragged edges of M, N and K are masked while
// staging (zeros) and while storing.
//
// Bound on the H100: at the model2 'reram' path's shapes the product reads
// its int8 rows and writes int32 outputs of similar size, with N to K int8
// ops per output: bytes for the narrow first layers, close to the balance
// point for the 512-wide ones. No tensor cores yet.

#include "crossbar.cuh"

namespace {

using namespace xbar;

__global__ void __launch_bounds__(THREADS)
reram_matmul_kernel(const int8_t* __restrict__ x,
                    const int8_t* __restrict__ planes,
                    int* __restrict__ out, int m, int k, int n,
                    int n_planes, int cell_bits, int weight_bits) {
  __shared__ int xs[BM][KW + 1];
  __shared__ unsigned ws[BN][KW + 1];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const size_t plane_stride = static_cast<size_t>(k) * n;

  int acc[RM][RN];
  int rs[RM] = {};
  zero_acc(acc);

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int e = tid; e < BM * KW; e += THREADS) {
      const int r = e / KW, w = e % KW;
      unsigned packed = 0;
      if (m0 + r < m) {
        const int8_t* row = x + static_cast<size_t>(m0 + r) * k;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = k0 + 4 * w + q;
          if (kk < k)
            packed |= static_cast<unsigned>(static_cast<uint8_t>(row[kk]))
                      << (8 * q);
        }
      }
      xs[r][w] = static_cast<int>(packed);
    }
    for (int e = tid; e < BN * KW; e += THREADS) {
      const int c = e % BN, w = e / BN;
      unsigned packed = 0;
      if (n0 + c < n) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = k0 + 4 * w + q;
          if (kk < k)
            packed |= combined_weight(planes, plane_stride,
                                      static_cast<size_t>(kk) * n + n0 + c,
                                      n_planes, cell_bits)
                      << (8 * q);
        }
      }
      ws[c][w] = packed;
    }
    __syncthreads();
    dot_slab<true>(&xs[0][0], KW + 1, &ws[0][0], KW + 1, tx, ty, acc, rs);
    __syncthreads();
  }

  const int offset = 1 << (weight_bits - 1);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = m0 + ty + TY * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = n0 + tx + TX * j;
      if (c < n) out[static_cast<size_t>(r) * n + c] = acc[i][j] - rs[i] * offset;
    }
  }
}

}  // namespace

extern "C" {

// y (m, n) int32 = x (m, k) int8 times the (n_planes, k, n) int8 planes,
// over the grid (ceil(m / BM), ceil(n / BN)). Returns the cudaError_t of
// the launch (0 on success).
int reram_matmul_int(const void* x, const void* planes, void* out, int m,
                     int k, int n, int n_planes, int cell_bits,
                     int weight_bits, void* stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  reram_matmul_kernel<<<grid, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(planes),
      static_cast<int*>(out), m, k, n, n_planes, cell_bits, weight_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
