// K2 on Hopper: the fused crossbar MLP, stripe-resident (the 'mtiled'
// dataflow), on the tensor cores, with the stripe's intermediate layers
// kept on chip.
//
// Replaces the TPU kernel src/repro/kernels/fused_mlp.py::_kernel_mtiled
// (launched at fused_mlp.py:360). It computes exactly what K1
// (fused_mlp.cu) computes — the same function, bit for bit — with another
// dataflow. On the TPU, 'mtiled' kept one (block_m, d) stripe in VMEM and
// the activation panel in HBM.
//
// Design. The next layer's requant scale is a max over the whole grid, so
// each layer still needs a launch of its own; but launch j does not need
// layer j-1's float32 output, because the maxima published by launches
// 0 .. j-1 already fix the scales s_1 .. s_j. So in launch j each block,
// owning BM rows of one batch element:
//   1. copies its int8 input stripe of x0 into shared memory (cp.async);
//   2. recomputes layers 0 .. j-1 on it, requantizing each output straight
//      into the other of two int8 stripes in shared memory (ping-pong);
//   3. computes layer j, N-chunk by N-chunk, and publishes its max |y|
//      (atomicMax on the float's bits);
//   4. in the last launch only, writes the float32 output.
// The integer and float steps and the scales are those of K1, and a max
// does not depend on order, so the result is the same bit for bit. The
// weights come combined once per MLP call by the s8 pre-pass
// (crossbar_mma.cuh's combine_weights_kernel); every product is mma.sync
// m16n8k32 s8 x s8 -> s32 over a cp.async ring of weight slabs
// (crossbar_mma.cuh). The layers' extents come as a device array, so an
// MLP may have any number of layers.
//
// Shared memory: two stripes of BM x (kmax + 16) bytes, kmax the widest
// k_lim of the MLP (35 KB at kmax 256, as at model2 SA-1; 133 KB at 1024),
// plus the 30 KB weight ring: up to kmax 1536 within a block's 227 KB.
// Beyond it the two stripes do not fit, and the wrapper
// (kernels/fused_mlp.py) runs such an MLP through K1's panel dataflow,
// which computes the same function at any width.
//
// Bound on the H100: bytes (the float32 output): 0.040 ms at model2 SA-1
// at 3.35 TB/s. Device-memory traffic is the int8 input once per launch
// plus the output once: at model2 SA-1, 3 x 1 MB + 134 MB, within 5% of
// the function's bytes; no intermediate panel leaves the chip. The price
// is the prefix recompute, about 1.4x the products of the three layers
// and 1.75x their epilogues, and weights re-read from L2 by every block
// (up to 200 KB per block and launch at model2 SA-1).

#include "crossbar_mma.cuh"

namespace {

using namespace xmma;

// At most 80 registers a thread, so that three blocks share an SM where
// shared memory allows (the widest k_lim up to 256, as at model2 SA-1):
// the epilogues of one block then overlap the products of another.
__global__ void __launch_bounds__(THREADS, 3)
fused_mlp_mtiled_mma_kernel(const int8_t* __restrict__ x0,
                            float* __restrict__ out,
                            const int8_t* __restrict__ wt,
                            const float* __restrict__ bias,
                            const float* __restrict__ mask,
                            const float* __restrict__ w_scale,
                            const float* __restrict__ sx,
                            int* __restrict__ mx,
                            const int* __restrict__ lims, int j,
                            int n_layers, int weight_bits, int m_pad,
                            int m_real, int d, int kmax, int relu) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ float red[THREADS / 32];
  const int sp = stripe_pitch(kmax);
  int8_t* const buf0 = smem;
  int8_t* const buf1 = smem + BM * sp;
  int8_t* ring = smem + 2 * BM * sp;

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * BM;
  const float qmax = static_cast<float>((1 << (weight_bits - 1)) - 1);
  const size_t row0 = static_cast<size_t>(b) * m_pad + m0;
  const size_t plane = static_cast<size_t>(d) * d;
  const bool last = j == n_layers - 1;
  const int* n_lims = lims + n_layers;   // k_lims are lims[0 .. L-1]
  const int out_pitch = n_lims[n_layers - 1];

  load_rows(buf0, sp, x0 + row0 * d, d, BM, lims[0]);
  cp_async_commit();
  chunk_prefetch(wt, d, 0, n_lims[0], 0, lims[0], ring);
  cp_async_wait<STAGES - 1>();

  const Lane ln = lane_of();
  float local = 0.0f;
  for (int l = 0; l <= j; ++l) {
    const int8_t* in = (l & 1) ? buf1 : buf0;
    int8_t* nxt = (l & 1) ? buf0 : buf1;
    const float s = xbar::layer_scale(l == 0, sx, mx, b, l, n_layers, qmax);
    const float c = __fmul_rn(s, w_scale[l]);
    const bool prefix = l < j;
    const float s_next =
        prefix ? xbar::layer_scale(false, sx, mx, b, l + 1, n_layers, qmax)
               : 1.0f;
    const float r_next = __frcp_rn(s_next);
    const int k_next = prefix ? lims[l + 1] : 0;
    const bool act = prefix || relu;
    const float* bias_l = bias + static_cast<size_t>(l) * d;
    const float* mask_l = mask + static_cast<size_t>(l) * d;
    const int n_lim = n_lims[l], k_lim = lims[l];
    for (int n0 = 0; n0 < n_lim; n0 += BN) {
      int acc[2][4][4];
      clear(acc);
      chunk_product(in, sp, wt + l * plane, d, n0, n_lim, 0, k_lim, ring, ln,
                    acc);
      // the next chunk's first slabs load during this chunk's epilogue
      if (n0 + BN < n_lim)
        chunk_prefetch(wt + l * plane, d, n0 + BN, n_lim, 0, k_lim, ring);
      else if (l < j)
        chunk_prefetch(wt + (l + 1) * plane, d, 0, n_lims[l + 1], 0,
                       lims[l + 1], ring);
      if (prefix) {
        for_each_pair(acc, ln, n0, k_next, bias_l, mask_l,
                      [&](int r, int n, int y0, int y1, float2 b2,
                          float2 m2) {
          const bool row_ok = m0 + r < m_real;
          const float a0 = dequant(y0, c, b2.x, m2.x, true, row_ok);
          const float a1 = dequant(y1, c, b2.y, m2.y, true, row_ok);
          *reinterpret_cast<uint16_t*>(nxt + r * sp + n) =
              static_cast<uint16_t>(
                  requant_fast(a0, s_next, r_next, qmax) |
                  (requant_fast(a1, s_next, r_next, qmax) << 8));
        });
        continue;
      }
      for_each_pair(acc, ln, n0, n_lim, bias_l, mask_l,
                    [&](int r, int n, int y0, int y1, float2 b2, float2 m2) {
        const bool row_ok = m0 + r < m_real;
        float2 y;
        y.x = dequant(y0, c, b2.x, m2.x, act, row_ok);
        y.y = dequant(y1, c, b2.y, m2.y, act, row_ok);
        local = fmaxf(local, fmaxf(fabsf(y.x), fabsf(y.y)));
        if (last)
          *reinterpret_cast<float2*>(out + (row0 + r) * out_pitch + n) = y;
      });
    }
  }
  xbar::publish_max(local, red, &mx[b * n_layers + j]);
}

}  // namespace

extern "C" {

// Tile edges the wrapper's launch geometry must agree with (rows, N-chunk,
// K slab), and K1's widest stripe (shared with K1's header).
int fused_mlp_mtiled_tile(int which) {
  return which == 0 ? BM : which == 1 ? BN : which == 2 ? BK : STRIPE_K;
}

// Dynamic shared memory of one block when the widest k_lim is kmax, bytes.
int fused_mlp_mtiled_smem(int kmax) {
  return 2 * BM * stripe_pitch(kmax) + RING_BYTES;
}

// One K2 call: the s8 pre-pass (which also zeroes mx (B, L)), then launch
// j = 0 .. L-1 over the grid (m_pad / BM, batch), all on `stream`. x0
// (B, m_pad, d) int8; planes (L, n_planes, d, d); wt (L, d, d) int8
// scratch; bias, mask (L, d); w_scale (L,); sx (B,); out
// (B, m_pad, n_lim[L-1]) float32, written by the last launch only.
// lims, lims_host: L k_lims then L n_lims, on the device and on the host.
// Returns the cudaError_t of the first launch that failed (0 on success).
int fused_mlp_mtiled_run(const void* x0, void* out, void* wt, void* mx,
                         const void* planes, const void* bias,
                         const void* mask, const void* w_scale,
                         const void* sx, const void* lims,
                         const void* lims_host, int n_layers, int n_planes,
                         int cell_bits, int weight_bits, int batch,
                         int m_pad, int m_real, int d, int final_relu,
                         void* stream) {
  const int* host = static_cast<const int*>(lims_host);
  const int* dev = static_cast<const int*>(lims);
  const dim3 grid(m_pad / BM, batch);
  const size_t smem =
      static_cast<size_t>(fused_mlp_mtiled_smem(widest(host, n_layers)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_combine(planes, wt, mx, batch * n_layers, dev, host,
                           n_layers, n_planes, cell_bits, weight_bits, d, d, d,
                           st);
  if (!err) err = xbar::allow_smem(&fused_mlp_mtiled_mma_kernel, smem);
  for (int j = 0; j < n_layers && !err; ++j) {
    fused_mlp_mtiled_mma_kernel<<<grid, THREADS, smem, st>>>(
        static_cast<const int8_t*>(x0), static_cast<float*>(out),
        static_cast<const int8_t*>(wt), static_cast<const float*>(bias),
        static_cast<const float*>(mask), static_cast<const float*>(w_scale),
        static_cast<const float*>(sx), static_cast<int*>(mx), dev, j,
        n_layers, weight_bits, m_pad, m_real, d, widest(host, n_layers),
        j < n_layers - 1 || final_relu);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

}  // extern "C"
