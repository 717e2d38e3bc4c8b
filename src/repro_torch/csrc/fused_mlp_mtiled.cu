// K2 on Hopper: one layer of the fused crossbar MLP, stripe-resident and in
// place (the 'mtiled' dataflow).
//
// Replaces the TPU kernel src/repro/kernels/fused_mlp.py::_kernel_mtiled.
// It computes exactly what K1 (fused_mlp.cu) computes — the same function,
// bit for bit — with another dataflow. On the TPU, 'mtiled' kept the
// activation panel in HBM (the output buffer doubling as the panel) and
// one (block_m, d) stripe in VMEM, requantized once into an int snapshot
// so that the N-tiles could overwrite the stripe's own rows.
//
// Design. One launch per layer, as K1: the next layer's scale is a max over
// the whole grid, published with atomicMax on the float's bits. Each block
// owns BM rows of one batch element. It requantizes its stripe once into
// dynamic shared memory as packed int8 (layer 0 reads the int8 input x0
// directly and skips the panel read), then walks every N-tile of the layer
// over that stripe, staging only K slabs of the combined u8 weights, and
// writes the outputs back into the same float32 panel over its own rows:
// the int8 snapshot decouples the block's reads from its writes, and no
// other block touches those rows. So K2 needs one panel where K1 needs
// two, and reads each input row once per layer where K1 reads it once per
// N-tile block. The row sums of the offset correction are taken during the
// first N-tile and kept in registers.
//
// Shared memory: BM x (k_lim / 4 + 1) words of stripe, 33 KB at d_pad 512
// (model2 SA-1), 66 KB at 1024 (needs the opt-in above 48 KB).
//
// Bound on the H100: like K1, bytes at model2's widths (the float32 output
// and the int8 weights); the panel's round trip through L2 per layer and
// the per-N-tile restaging of the planes are what this version spends
// beyond the bound.

#include "crossbar.cuh"

namespace {

using namespace xbar;

template <bool FIRST>
__global__ void __launch_bounds__(THREADS)
fused_mlp_mtiled_kernel(const int8_t* __restrict__ x0,
                        float* __restrict__ panel,
                        const int8_t* __restrict__ planes,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask,
                        const float* __restrict__ w_scale,
                        const float* __restrict__ sx,
                        int* __restrict__ mx,
                        int layer, int n_layers, int n_planes, int cell_bits,
                        int weight_bits, int m_pad, int m_real, int d,
                        int k_lim, int n_lim, int relu) {
  extern __shared__ int stripe[];            // BM x (k_lim / 4 + 1) words
  __shared__ unsigned ws[BN][KW + 1];
  __shared__ float red[THREADS / 32];

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int ks = k_lim / 4;
  const int sp = ks + 1;
  const float qmax = static_cast<float>((1 << (weight_bits - 1)) - 1);
  const float s = layer_scale(FIRST, sx, mx, b, layer, n_layers, qmax);
  const size_t row0 = static_cast<size_t>(b) * m_pad + m0;

  for (int e = tid; e < BM * ks; e += THREADS) {
    const int r = e / ks, w = e % ks;
    const size_t off = (row0 + r) * d + 4 * w;
    stripe[r * sp + w] =
        FIRST ? *reinterpret_cast<const int*>(x0 + off)
              : requant4(*reinterpret_cast<const float4*>(panel + off), s,
                         qmax);
  }
  __syncthreads();

  const float c = __fmul_rn(s, *w_scale);
  int rs[RM] = {};
  float local = 0.0f;
  for (int n0 = 0; n0 < n_lim; n0 += BN) {
    int acc[RM][RN];
    zero_acc(acc);
    for (int k0 = 0; k0 < k_lim; k0 += BK) {
      for (int e = tid; e < BN * KW; e += THREADS) {
        const int n = e % BN, w = e / BN;
        ws[n][w] = combined_word(planes, d, k0 + 4 * w, n0 + n, n_planes,
                                 cell_bits);
      }
      __syncthreads();
      if (n0 == 0)
        dot_slab<true>(stripe + k0 / 4, sp, &ws[0][0], KW + 1, tx, ty, acc,
                       rs);
      else
        dot_slab<false>(stripe + k0 / 4, sp, &ws[0][0], KW + 1, tx, ty, acc,
                        rs);
      __syncthreads();
    }
    local = fmaxf(local, store_patch(acc, rs, panel, row0, m0, n0, d, m_real,
                                     c, weight_bits, bias, mask, relu, tx,
                                     ty));
  }
  publish_max(local, red, &mx[b * n_layers + layer]);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at input extent k_lim, in bytes.
int fused_mlp_mtiled_smem(int k_lim) {
  return BM * (k_lim / 4 + 1) * static_cast<int>(sizeof(int));
}

// One layer over the grid (m_pad / BM, batch), in place on `panel`
// (B, m_pad, d) float32; layer 0 reads x0 (B, m_pad, d) int8 instead.
// Returns the cudaError_t of the launch (0 on success).
int fused_mlp_mtiled_layer(const void* x0, void* panel, const void* planes,
                           const void* bias, const void* mask,
                           const void* w_scale, const void* sx, void* mx,
                           int layer, int n_layers, int n_planes,
                           int cell_bits, int weight_bits, int batch,
                           int m_pad, int m_real, int d, int k_lim, int n_lim,
                           int relu, void* stream) {
  const dim3 grid(m_pad / BM, batch);
  const size_t smem = static_cast<size_t>(fused_mlp_mtiled_smem(k_lim));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = layer == 0 ? &fused_mlp_mtiled_kernel<true>
                           : &fused_mlp_mtiled_kernel<false>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const int8_t*>(x0), static_cast<float*>(panel),
      static_cast<const int8_t*>(planes), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const float*>(w_scale),
      static_cast<const float*>(sx), static_cast<int*>(mx), layer, n_layers,
      n_planes, cell_bits, weight_bits, m_pad, m_real, d, k_lim, n_lim, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
