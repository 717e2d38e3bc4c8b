// K1 on Hopper: one layer of the fused bit-sliced INT8 crossbar MLP, on
// the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/fused_mlp.py::_kernel (the
// 'whole'/'tiled' dataflows, launched from reram_mlp_fused[_batched] at
// fused_mlp.py:391).
//
// What it computes, for one batch element b and one layer l of the
// programmed MLP (every integer step exact, every float step one IEEE
// operation rounded to nearest, so the result equals the plain torch
// version in repro_torch/kernels/fused_mlp.py bit for bit):
//   s      = sx[b] (layer 0) or max(max|y_{l-1}| / qmax, 1e-12)
//   x      = layer 0: the pre-quantized int8 input;
//            else clip(rint(act / s), -qmax, qmax)       (half to even)
//   y_int  = sum_k x[k] * w[k][n],  w = combine_planes(planes), s8
//            (= sum_k x[k] * u[k][n] - (sum_k x[k]) << (weight_bits - 1))
//   y      = float(y_int) * (s * w_scale) + bias; ReLU; * col_mask;
//            rows >= m_real zeroed
//   mx[b][l] = max |y| over the layer (feeds layer l+1's scale).
//
// Design. The TPU kernel ran the whole MLP in one sequential grid and
// carried the next layer's scale — a max over the whole layer's output —
// in SMEM. Blocks on Hopper run in no order, so this is one launch per
// layer: each block publishes its chunk's max|y| with one atomicMax on the
// float's bits, and the next launch on the same stream derives its scale
// on the device. The weights come combined once per MLP call by the s8
// pre-pass (crossbar_mma.cuh's combine_weights_kernel; combine_weights
// below launches it alone). A block owns one BM x BN output chunk of one
// batch element: it stages its BM-row input stripe in shared memory as
// int8 (cp.async from x0 at layer 0, else the float32 panel requantized on
// load) while the chunk's first s8 weight slabs are already in flight,
// streams the slabs through a cp.async ring and multiplies on the tensor
// cores (mma.sync m16n8k32 s8 x s8 -> s32; crossbar_mma.cuh). The stripe
// holds the layer's whole k_lim up to STRIPE_K = 2048 bytes; a wider layer
// runs K in ranges of STRIPE_K, each staged and multiplied in turn into the
// same accumulators, so K1 takes any width and any number of layers. The
// ranges are an instantiation of their own (RANGES), launched only for
// such layers: carried across ranges, the accumulators take the kernel
// from 64 registers a thread to up to 114 (ptxas), which would halve the
// blocks per SM at every width. Sums
// stay below 2^24, so int32 never overflows and the float conversion is
// exact.
// Activations ping-pong between two float32 panels in device memory (a
// layer's output cannot overwrite its input: blocks of other N-chunks
// still read those rows).
//
// Bound on the H100: bytes. At model1's widths the MLP does 100-260 int8
// operations per byte of its float32 output, below the card's ~590 ops per
// byte (1,979 TOP/s over 3.35 TB/s): 0.032 ms over model1's three MLPs.
// Beyond the bound this design moves each intermediate float32 panel
// through L2/HBM once per layer (at model1 SA-1 about 3x the function's
// bytes), and reads a layer's input once per N-chunk (BN = 128 columns,
// so once for layers up to 128 wide). K2's prefix recompute removes the
// panel; K1 keeps it, as the 'whole' dataflow's kernel.

#include "crossbar_mma.cuh"

namespace {

using namespace xmma;

template <bool FIRST, bool RANGES>
__global__ void __launch_bounds__(THREADS)
fused_mlp_mma_kernel(const int8_t* __restrict__ x0,
                     const float* __restrict__ act_in,
                     float* __restrict__ act_out,
                     const int8_t* __restrict__ wt,
                     const float* __restrict__ bias,
                     const float* __restrict__ mask,
                     const float* __restrict__ w_scale,
                     const float* __restrict__ sx,
                     int* __restrict__ mx,
                     int layer, int n_layers, int weight_bits, int m_pad,
                     int m_real, int d, int k_lim, int n_lim, int relu) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ float red[THREADS / 32];
  const int ap = stripe_pitch(k_lim < STRIPE_K ? k_lim : STRIPE_K);
  int8_t* stripe = smem;
  int8_t* ring = smem + BM * ap;

  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const float qmax = static_cast<float>((1 << (weight_bits - 1)) - 1);
  const float s = xbar::layer_scale(FIRST, sx, mx, b, layer, n_layers, qmax);
  const size_t row0 = static_cast<size_t>(b) * m_pad + m0;

  const float rs = __frcp_rn(s);
  const Lane ln = lane_of();
  int acc[2][4][4];
  for (int k0 = 0; k0 < k_lim; k0 += STRIPE_K) {
    const int k1 = k_lim - k0 < STRIPE_K ? k_lim : k0 + STRIPE_K;
    if (FIRST) {
      load_rows(stripe, ap, x0 + row0 * d + k0, d, BM, k1 - k0);
      cp_async_commit();
      chunk_prefetch(wt, d, n0, n_lim, k0, k1, ring);
      cp_async_wait<STAGES - 1>();
    } else {
      chunk_prefetch(wt, d, n0, n_lim, k0, k1, ring);
      // each thread issues up to 4 float4 loads before it requantizes any
      const int kw = (k1 - k0) / 4, words = BM * kw;
      for (int e0 = threadIdx.x; e0 < words; e0 += 4 * THREADS) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * THREADS, r = e / kw, w = e % kw;
          if (e < words)
            v[u] = *reinterpret_cast<const float4*>(
                act_in + (row0 + r) * d + k0 + 4 * w);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * THREADS, r = e / kw, w = e % kw;
          if (e < words)
            *reinterpret_cast<int*>(stripe + r * ap + 4 * w) =
                requant4_fast(v[u], s, rs, qmax);
        }
      }
    }
    if (k0 == 0) clear(acc);
    chunk_product(stripe, ap, wt, d, n0, n_lim, k0, k1, ring, ln, acc);
    if (!RANGES) break;   // k_lim <= STRIPE_K: one range
  }

  const float c = __fmul_rn(s, *w_scale);
  float local = 0.0f;
  for_each_pair(acc, ln, n0, n_lim, bias, mask,
                [&](int r, int n, int y0, int y1, float2 b2, float2 m2) {
    const bool row_ok = m0 + r < m_real;
    float2 y;
    y.x = dequant(y0, c, b2.x, m2.x, relu, row_ok);
    y.y = dequant(y1, c, b2.y, m2.y, relu, row_ok);
    local = fmaxf(local, fmaxf(fabsf(y.x), fabsf(y.y)));
    *reinterpret_cast<float2*>(act_out + (row0 + r) * d + n) = y;
  });
  xbar::publish_max(local, red, &mx[b * n_layers + layer]);
}

using Kernel = decltype(&fused_mlp_mma_kernel<true, false>);

// The instantiation for layer `layer` at input extent k_lim.
Kernel kernel_of(int layer, int k_lim) {
  const bool ranges = k_lim > STRIPE_K;
  if (layer == 0)
    return ranges ? &fused_mlp_mma_kernel<true, true>
                  : &fused_mlp_mma_kernel<true, false>;
  return ranges ? &fused_mlp_mma_kernel<false, true>
                : &fused_mlp_mma_kernel<false, false>;
}

}  // namespace

extern "C" {

// Tile edges the wrapper's launch geometry must agree with (rows, N-chunk,
// K slab), and the widest K range of one stripe.
int fused_mlp_tile(int which) {
  return which == 0 ? BM : which == 1 ? BN : which == 2 ? BK : STRIPE_K;
}

// Dynamic shared memory of one block at input extent k_lim, in bytes.
int fused_mlp_smem(int k_lim) {
  return BM * stripe_pitch(k_lim < STRIPE_K ? k_lim : STRIPE_K) + RING_BYTES;
}

// One K1 call: the s8 pre-pass (which also zeroes mx (B, L)), then layer
// l = 0 .. L-1 over the grid (ceil(n_lim / BN), m_pad / BM, batch), all on
// `stream`. x0 (B, m_pad, d) int8; planes (L, n_planes, d, d); wt (L, d, d)
// int8 scratch; bias, mask (L, d); w_scale (L,); sx (B,). Layer l reads
// panel (l - 1) % 2 (layer 0 reads x0) and writes panel l % 2, both
// (B, m_pad, d) float32 (panel 1 unused for one layer). lims, lims_host:
// L k_lims then L n_lims, on the device and on the host. Returns the
// cudaError_t of the first launch that failed (0 on success).
int fused_mlp_run(const void* x0, void* panel0, void* panel1, void* wt,
                  void* mx, const void* planes, const void* bias,
                  const void* mask, const void* w_scale, const void* sx,
                  const void* lims, const void* lims_host, int n_layers,
                  int n_planes, int cell_bits, int weight_bits, int batch,
                  int m_pad, int m_real, int d, int final_relu,
                  void* stream) {
  const int* host = static_cast<const int*>(lims_host);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_combine(planes, wt, mx, batch * n_layers,
                           static_cast<const int*>(lims), host, n_layers,
                           n_planes, cell_bits, weight_bits, d, d, d, st);
  float* panels[2] = {static_cast<float*>(panel0),
                      static_cast<float*>(panel1)};
  const size_t plane = static_cast<size_t>(d) * d;
  for (int l = 0; l < n_layers && !err; ++l) {
    const int k_lim = host[l], n_lim = host[n_layers + l];
    const dim3 grid((n_lim + BN - 1) / BN, m_pad / BM, batch);
    const size_t smem = static_cast<size_t>(fused_mlp_smem(k_lim));
    const Kernel kernel = kernel_of(l, k_lim);
    err = xbar::allow_smem(kernel, smem);
    if (err) break;
    kernel<<<grid, THREADS, smem, st>>>(
        static_cast<const int8_t*>(x0), l ? panels[(l - 1) % 2] : nullptr,
        panels[l % 2], static_cast<const int8_t*>(wt) + l * plane,
        static_cast<const float*>(bias) + static_cast<size_t>(l) * d,
        static_cast<const float*>(mask) + static_cast<size_t>(l) * d,
        static_cast<const float*>(w_scale) + l,
        static_cast<const float*>(sx), static_cast<int*>(mx), l, n_layers,
        weight_bits, m_pad, m_real, d, k_lim, n_lim,
        l < n_layers - 1 || final_relu);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

// The s8 weight pre-pass alone, for tests and timing (K1, K2 and K3 launch
// it from their own entry points): planes (L, n_planes, d, d) int8 -> wt
// (L, d, d) int8 over each layer's (k_lim, n_lim); also zeroes n_zero ints
// at `zero`. lims, lims_host as for fused_mlp_run. Returns the
// cudaError_t of the launch (0 on success).
int combine_weights(const void* planes, void* wt, void* zero,
                    const void* lims, const void* lims_host, int n_zero,
                    int n_layers, int n_planes, int cell_bits,
                    int weight_bits, int d, void* stream) {
  return launch_combine(planes, wt, zero, n_zero,
                        static_cast<const int*>(lims),
                        static_cast<const int*>(lims_host), n_layers,
                        n_planes, cell_bits, weight_bits, d, d, d,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
