// K3 on Hopper: one layer of the fused crossbar MLP, weight-resident (the
// 'wstat' dataflow).
//
// Replaces the TPU kernel src/repro/kernels/fused_mlp.py::_kernel_wstat.
// It computes exactly what K1 (fused_mlp.cu) computes — the same function,
// bit for bit — with another dataflow. On the TPU, 'wstat' iterated the
// N-tiles outermost so that each plane tile crossed HBM once per layer,
// reading the layer's input from a full int8 snapshot panel written at the
// first N-tile (later N-tiles must not see rows already overwritten).
//
// Design. Per layer, two launches on one stream:
//   1. wstat_requant (layers > 0): the int8 snapshot panel (B, m_pad, d)
//      from the float32 panel under each batch element's scale, derived on
//      the device from the max the previous layer published. Layer 0 uses
//      the int8 input x0 as its snapshot.
//   2. wstat_layer: each block owns one N-tile. It combines its
//      (k_lim x BN) tile of the four 2-bit planes into u8 weights in
//      dynamic shared memory once (64 KB at d_pad 1024 and BN 64), then
//      streams BM-row stripes of the snapshot through it: its share of all
//      B x m_pad rows, across batch elements, in K slabs. The row sums of
//      the offset correction come from dp4a against 0x01010101, as in K1.
//      Outputs go into the float32 panel in place — the snapshot already
//      consumed it. Each block publishes the max |y| of each batch element
//      it touched with one atomicMax on the float's bits.
// The grid is (n_tiles, row_groups), sized by the wrapper to fill the SMs.
// Each weight byte crosses device memory once per block instead of once
// per (row tile, N-tile) block as in K1.
//
// Bound on the H100: bytes, like K1 (the float32 output and the int8
// weights); this version also round-trips the panel and the snapshot
// through L2 each layer.

#include "crossbar.cuh"

namespace {

using namespace xbar;

__global__ void __launch_bounds__(THREADS)
wstat_requant_kernel(const float* __restrict__ panel,
                     int8_t* __restrict__ xq, const int* __restrict__ mx,
                     int layer, int n_layers, int weight_bits, int m_pad,
                     int d, int k_lim, size_t n_words) {
  const float qmax = static_cast<float>((1 << (weight_bits - 1)) - 1);
  const int ks = k_lim / 4;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < n_words; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t row = e / ks;
    const int w = static_cast<int>(e % ks);
    const int b = static_cast<int>(row / m_pad);
    const float s = layer_scale(false, nullptr, mx, b, layer, n_layers, qmax);
    const size_t off = row * d + 4 * w;
    *reinterpret_cast<int*>(xq + off) =
        requant4(*reinterpret_cast<const float4*>(panel + off), s, qmax);
  }
}

__global__ void __launch_bounds__(THREADS)
wstat_layer_kernel(const int8_t* __restrict__ xq,
                   float* __restrict__ panel,
                   const int8_t* __restrict__ planes,
                   const float* __restrict__ bias,
                   const float* __restrict__ mask,
                   const float* __restrict__ w_scale,
                   const float* __restrict__ sx,
                   int* __restrict__ mx,
                   int layer, int n_layers, int n_planes, int cell_bits,
                   int weight_bits, int m_pad, int m_real, int d, int k_lim,
                   int row_tiles, int relu) {
  extern __shared__ unsigned wres[];         // BN x (k_lim / 4 + 1) words
  __shared__ int xs[BM][KW + 1];
  __shared__ float red[THREADS / 32];

  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int ks = k_lim / 4;
  const int wp = ks + 1;
  const float qmax = static_cast<float>((1 << (weight_bits - 1)) - 1);
  const bool first = layer == 0;

  for (int e = tid; e < BN * ks; e += THREADS) {
    const int n = e % BN, w = e / BN;
    wres[n * wp + w] = combined_word(planes, d, 4 * w, n0 + n, n_planes,
                                     cell_bits);
  }
  __syncthreads();

  float local = 0.0f;
  int cur_b = -1;
  for (int t = blockIdx.y; t < row_tiles; t += gridDim.y) {
    const size_t row0 = static_cast<size_t>(t) * BM;
    const int b = static_cast<int>(row0 / m_pad);
    const int m0 = static_cast<int>(row0 - static_cast<size_t>(b) * m_pad);
    if (b != cur_b) {                       // uniform across the block
      if (cur_b >= 0) publish_max(local, red, &mx[cur_b * n_layers + layer]);
      local = 0.0f;
      cur_b = b;
    }
    const float s = layer_scale(first, sx, mx, b, layer, n_layers, qmax);
    int acc[RM][RN];
    int rs[RM] = {};
    zero_acc(acc);
    for (int k0 = 0; k0 < k_lim; k0 += BK) {
      for (int e = tid; e < BM * KW; e += THREADS) {
        const int r = e / KW, w = e % KW;
        xs[r][w] = *reinterpret_cast<const int*>(xq + (row0 + r) * d + k0 +
                                                 4 * w);
      }
      __syncthreads();
      dot_slab<true>(&xs[0][0], KW + 1, wres + k0 / 4, wp, tx, ty, acc, rs);
      __syncthreads();
    }
    local = fmaxf(local, store_patch(acc, rs, panel, row0, m0, n0, d, m_real,
                                     __fmul_rn(s, *w_scale), weight_bits,
                                     bias, mask, relu, tx, ty));
  }
  if (cur_b >= 0) publish_max(local, red, &mx[cur_b * n_layers + layer]);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one product block at input extent k_lim, bytes.
int fused_mlp_wstat_smem(int k_lim) {
  return BN * (k_lim / 4 + 1) * static_cast<int>(sizeof(unsigned));
}

// Layer l > 0's int8 snapshot (B, m_pad, d) of the float32 panel's first
// k_lim columns. Returns the cudaError_t of the launch (0 on success).
int fused_mlp_wstat_requant(const void* panel, void* xq, const void* mx,
                            int layer, int n_layers, int weight_bits,
                            int batch, int m_pad, int d, int k_lim,
                            void* stream) {
  const size_t n_words =
      static_cast<size_t>(batch) * m_pad * static_cast<size_t>(k_lim / 4);
  const size_t blocks = (n_words + THREADS - 1) / THREADS;
  const unsigned grid = static_cast<unsigned>(blocks < 65535 ? blocks : 65535);
  wstat_requant_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(panel), static_cast<int8_t*>(xq),
      static_cast<const int*>(mx), layer, n_layers, weight_bits, m_pad, d,
      k_lim, n_words);
  return static_cast<int>(cudaGetLastError());
}

// The layer's product over the grid (n_lim / BN, row_groups): snapshot xq
// (B, m_pad, d) int8 in, float32 panel (B, m_pad, d) out, in place.
// Returns the cudaError_t of the launch (0 on success).
int fused_mlp_wstat_layer(const void* xq, void* panel, const void* planes,
                          const void* bias, const void* mask,
                          const void* w_scale, const void* sx, void* mx,
                          int layer, int n_layers, int n_planes,
                          int cell_bits, int weight_bits, int batch,
                          int m_pad, int m_real, int d, int k_lim, int n_lim,
                          int row_groups, int relu, void* stream) {
  const dim3 grid(n_lim / BN, row_groups);
  const size_t smem = static_cast<size_t>(fused_mlp_wstat_smem(k_lim));
  const int err = allow_smem(&wstat_layer_kernel, smem);
  if (err) return err;
  wstat_layer_kernel<<<grid, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<float*>(panel),
      static_cast<const int8_t*>(planes), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const float*>(w_scale),
      static_cast<const float*>(sx), static_cast<int*>(mx), layer, n_layers,
      n_planes, cell_bits, weight_bits, m_pad, m_real, d, k_lim,
      batch * (m_pad / BM), relu);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
