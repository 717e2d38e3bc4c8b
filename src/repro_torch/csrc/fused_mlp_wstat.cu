// K3 on Hopper: the fused crossbar MLP, weight-resident (the 'wstat'
// dataflow), on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/fused_mlp.py::_kernel_wstat
// (launched at fused_mlp.py:330). It computes exactly what K1
// (fused_mlp.cu) computes — the same function, bit for bit — with another
// dataflow. On the TPU, 'wstat' iterated the N-tiles outermost so that each
// plane tile crossed HBM once per layer, reading the layer's input from a
// full int8 snapshot panel written at the first N-tile (later N-tiles must
// not see rows already overwritten).
//
// Design. One C call launches the s8 pre-pass (crossbar_mma.cuh's
// combine_weights_kernel, once per MLP call; it also zeroes the running
// maxima), then per layer two kernels on one stream:
//   1. wstat_requant (layers > 0): the int8 snapshot panel (B, m_pad, d)
//      from the float32 panel under each batch element's scale, derived on
//      the device from the max the previous layer published (requant_fast:
//      a multiply by the rounded reciprocal, the exact division near a
//      tie). Layer 0 uses the int8 input x0 as its snapshot.
//   2. wstat_mma_kernel: each block owns one chunk of NB output columns. It
//      loads the chunk's s8 weights ([n][k], all of the layer's k_lim) into
//      shared memory once, then streams its share of all B x m_pad rows,
//      BM-row tile by tile, through a cp.async ring of BM x ABK activation
//      slabs, multiplying on the tensor cores (mma.sync m16n8k32 s8 x s8 ->
//      s32: crossbar_mma.cuh's warp_step, K1's product with the operands'
//      roles swapped). The next tile's first slabs load during a tile's
//      epilogue, which dequantizes as K1 does into the float32 panel, in
//      place (the snapshot already holds the layer's input). Each block
//      publishes the max |y| of each batch element it touched with one
//      atomicMax on the float's bits.
// The grid is (chunks, row_groups), sized by the wrapper to fill the SMs
// (kernels/program.py::wstat_row_groups). Each weight byte crosses device
// memory once per block instead of once per (row tile, chunk) block as in
// K1.
//
// Width. A chunk's resident weights take NB x (k_lim + 16) bytes beside the
// 20 KB ring: NB is 128 columns up to a k_lim of 1632, then 64 (up to 3264)
// and 32 (up to 6560). Past that a block runs K in ranges of STRIPE_K bytes
// at 64 columns and reloads each range's weights, from L2, for every row
// tile: an instantiation of its own (RANGES), launched only for such
// layers, so the resident path keeps its weights loaded once per block.
// So K3 takes any width, and every model width stays on the resident
// 128-column path (114 registers a thread, two blocks an SM).
//
// Bound on the H100: bytes, like K1 (the int8 input and weights, the
// float32 output): 0.023 ms at model2 SA-2 at 3.35 TB/s. Beyond the bound
// this design moves every intermediate float32 panel through device memory
// twice (written by the product, read by the snapshot pass) and reads the
// snapshot once per chunk (from L2: 8 MB at model2 SA-2).

#include "crossbar_mma.cuh"

namespace {

using namespace xmma;

constexpr int NB_MAX = 128;      // widest chunk of output columns
constexpr int ABK = 64;          // K bytes of one activation slab
constexpr int ASTAGES = 4;       // activation slabs in flight
constexpr int ABP = ABK + 16;    // slab row pitch, bytes
constexpr int ASLAB = BM * ABP;
constexpr int ARING_BYTES = ASTAGES * ASLAB;
// Dynamic shared memory a block may take: 227 KB less 1 KB kept for the
// static shared memory (kernels/program.py's MAX_SMEM_BYTES).
constexpr int SMEM_LIMIT = 232448 - 1024;
static_assert(STRIPE_K % ABK == 0, "K ranges split at slab edges");

// A layer's chunk: its output columns, and whether K runs in ranges.
struct Chunk {
  int cols;
  bool ranges;
};

inline Chunk chunk_of(int k_lim) {
  for (int cols = NB_MAX; cols >= 32; cols /= 2)
    if (cols * (k_lim + 16) + ARING_BYTES <= SMEM_LIMIT) return {cols, false};
  return {64, true};
}

inline int smem_of(int k_lim) {
  const Chunk c = chunk_of(k_lim);
  return c.cols * ((c.ranges ? STRIPE_K : k_lim) + 16) + ARING_BYTES;
}

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
    const float s =
        xbar::layer_scale(false, nullptr, mx, b, layer, n_layers, qmax);
    const size_t off = row * d + 4 * w;
    *reinterpret_cast<int*>(xq + off) =
        requant4_fast(*reinterpret_cast<const float4*>(panel + off), s,
                      __frcp_rn(s), qmax);
  }
}

// Issue the cp.async copies of one BM x ABK activation slab: rows row0 ..
// row0 + BM of the snapshot (pitch d) from k0; K from k_end on is filled
// with zeros. The caller commits.
__device__ __forceinline__ void load_aslab(int8_t* buf, const int8_t* xq,
                                           size_t row0, int d, int k0,
                                           int k_end) {
  constexpr int CH = ABK / 16;
  for (int e = threadIdx.x; e < BM * CH; e += THREADS) {
    const int r = e / CH, c = e % CH;
    const int k = k0 + 16 * c;
    const bool ok = k < k_end;
    cp_async16(buf + r * ABP + 16 * c, ok ? xq + (row0 + r) * d + k : xq,
               ok);
  }
}

// Issue the first ASTAGES - 1 slabs of a row tile over K [k_begin, k_end)
// (one commit group each, empty where the range has fewer slabs).
__device__ __forceinline__ void tile_prefetch(const int8_t* xq, size_t row0,
                                              int d, int k_begin, int k_end,
                                              int8_t* ring) {
  const int nk = (k_end - k_begin + ABK - 1) / ABK;
#pragma unroll
  for (int s = 0; s < ASTAGES - 1; ++s) {
    if (s < nk)
      load_aslab(ring + s * ASLAB, xq, row0, d, k_begin + s * ABK, k_end);
    cp_async_commit();
  }
}

// Issue the copies of the chunk's resident weights: columns n0 .. n0 +
// cols of the layer's [n][k] weights (pitch d) over K [k_begin, k_end)
// into wres (pitch wp); columns >= n_lim are filled with zeros. The caller
// commits.
__device__ __forceinline__ void load_weights(int8_t* wres, int wp,
                                             const int8_t* wt, int d, int n0,
                                             int cols, int n_lim, int k_begin,
                                             int k_end) {
  const int chunks = (k_end - k_begin) / 16;
  for (int e = threadIdx.x; e < cols * chunks; e += THREADS) {
    const int n = e / chunks, c = e % chunks;
    const bool ok = n0 + n < n_lim;
    cp_async16(wres + n * wp + 16 * c,
               ok ? wt + static_cast<size_t>(n0 + n) * d + k_begin + 16 * c
                  : wt,
               ok);
  }
}

// acc += the row tile at row0 (K [k_begin, k_end), streamed through the
// ring) x the resident weights (wres, pitch wp, holding K from k_begin).
// The tile's first slabs must have been issued by tile_prefetch, and no
// copy committed since. Every thread of the block must call it; it starts
// and ends with a block barrier, so the ring and wres may be reused after
// it.
template <int NT>
__device__ __forceinline__ void tile_product(const int8_t* xq, size_t row0,
                                             int d, int k_begin, int k_end,
                                             const int8_t* wres, int wp,
                                             int8_t* ring, Lane ln,
                                             bool active,
                                             int (&acc)[2][NT][4]) {
  const int kw = k_end - k_begin;
  const int nk = (kw + ABK - 1) / ABK;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<ASTAGES - 2>();
    __syncthreads();
    const int nxt = kt + ASTAGES - 1;
    if (nxt < nk)
      load_aslab(ring + (nxt % ASTAGES) * ASLAB, xq, row0, d,
                 k_begin + nxt * ABK, k_end);
    cp_async_commit();
    if (!active) continue;
    const int8_t* as = ring + (kt % ASTAGES) * ASLAB;
    const int k0 = kt * ABK;
#pragma unroll
    for (int ks = 0; ks < ABK / 32; ++ks)
      if (k0 + ks * 32 < kw)   // k_lim is a multiple of 32
        warp_step<NT>(as + ks * 32, ABP, wres + k0 + ks * 32, wp, ln, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// At most 128 registers a thread, so that two blocks share an SM (as the
// resident weights allow up to a k_lim of about 760 at 128 columns).
template <int NT, bool RANGES>
__global__ void __launch_bounds__(THREADS, 2)
wstat_mma_kernel(const int8_t* __restrict__ xq, float* __restrict__ panel,
                 const int8_t* __restrict__ wt,
                 const float* __restrict__ bias,
                 const float* __restrict__ mask,
                 const float* __restrict__ w_scale,
                 const float* __restrict__ sx, int* __restrict__ mx,
                 int layer, int n_layers, int weight_bits, int m_pad,
                 int m_real, int d, int k_lim, int n_lim, int row_tiles,
                 int relu) {
  constexpr int NB = 32 * NT;
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ float red[THREADS / 32];
  const int wp = (RANGES ? STRIPE_K : k_lim) + 16;
  int8_t* wres = smem;
  int8_t* ring = smem + NB * wp;

  const int n0 = blockIdx.x * NB;
  const float qmax = static_cast<float>((1 << (weight_bits - 1)) - 1);
  const bool first = layer == 0;
  const Lane ln = lane_of();
  const bool active = n0 + ln.wn * 8 * NT < n_lim;   // warp has real columns
  const float ws = *w_scale;

  int t = blockIdx.y;
  if (t >= row_tiles) return;                          // uniform per block
  if (!RANGES) {
    load_weights(wres, wp, wt, d, n0, NB, n_lim, 0, k_lim);
    cp_async_commit();
    tile_prefetch(xq, static_cast<size_t>(t) * BM, d, 0, k_lim, ring);
  }
  float local = 0.0f;
  int cur_b = -1;
  for (; t < row_tiles; t += gridDim.y) {
    const size_t row0 = static_cast<size_t>(t) * BM;
    const int b = static_cast<int>(row0 / m_pad);
    const int m0 = static_cast<int>(row0 - static_cast<size_t>(b) * m_pad);
    int acc[2][NT][4];
    clear(acc);
    if (RANGES) {
      for (int kb = 0; kb < k_lim; kb += STRIPE_K) {
        const int ke = k_lim - kb < STRIPE_K ? k_lim : kb + STRIPE_K;
        load_weights(wres, wp, wt, d, n0, NB, n_lim, kb, ke);
        cp_async_commit();
        tile_prefetch(xq, row0, d, kb, ke, ring);
        tile_product<NT>(xq, row0, d, kb, ke, wres, wp, ring, ln, active,
                         acc);
      }
    } else {
      tile_product<NT>(xq, row0, d, 0, k_lim, wres, wp, ring, ln, active,
                       acc);
      // the next tile's first slabs load during this tile's epilogue
      if (t + gridDim.y < row_tiles)
        tile_prefetch(xq, row0 + static_cast<size_t>(gridDim.y) * BM, d, 0,
                      k_lim, ring);
    }
    if (b != cur_b) {                                  // uniform per block
      if (cur_b >= 0)
        xbar::publish_max(local, red, &mx[cur_b * n_layers + layer]);
      local = 0.0f;
      cur_b = b;
    }
    const float s =
        xbar::layer_scale(first, sx, mx, b, layer, n_layers, qmax);
    const float c = __fmul_rn(s, ws);
    for_each_pair(acc, ln, n0, n_lim, bias, mask,
                  [&](int r, int n, int y0, int y1, float2 b2, float2 m2) {
      const bool row_ok = m0 + r < m_real;
      float2 y;
      y.x = dequant(y0, c, b2.x, m2.x, relu, row_ok);
      y.y = dequant(y1, c, b2.y, m2.y, relu, row_ok);
      local = fmaxf(local, fmaxf(fabsf(y.x), fabsf(y.y)));
      *reinterpret_cast<float2*>(panel + (row0 + r) * d + n) = y;
    });
  }
  xbar::publish_max(local, red, &mx[cur_b * n_layers + layer]);
}

using Kernel = decltype(&wstat_mma_kernel<4, false>);

// The instantiation of a layer's chunk.
Kernel kernel_of(Chunk c) {
  if (c.ranges) return &wstat_mma_kernel<2, true>;
  return c.cols == 128  ? &wstat_mma_kernel<4, false>
         : c.cols == 64 ? &wstat_mma_kernel<2, false>
                        : &wstat_mma_kernel<1, false>;
}

}  // namespace

extern "C" {

// Tile edges the wrapper's launch geometry must agree with (rows, widest
// chunk, activation slab), and the widest K range of the ranged variant.
int fused_mlp_wstat_tile(int which) {
  return which == 0 ? BM : which == 1 ? NB_MAX : which == 2 ? ABK : STRIPE_K;
}

// Dynamic shared memory of one product block at input extent k_lim, bytes.
int fused_mlp_wstat_smem(int k_lim) { return smem_of(k_lim); }

// One K3 call: the s8 pre-pass (which also zeroes mx (B, L)), then per
// layer l the snapshot pass (l > 0) and the product over the grid
// (ceil(n_lim / cols), groups[l]), all on `stream`. x0 (B, m_pad, d) int8
// (layer 0's snapshot); panel (B, m_pad, d) float32, written in place by
// every layer (the output); xq (B, m_pad, d) int8 scratch (unused for one
// layer); wt (L, d, d) int8 scratch; groups: the L row-group counts, on the
// host (kernels/program.py::wstat_row_groups); planes (L, n_planes, d, d);
// bias, mask (L, d); w_scale (L,); sx (B,); lims, lims_host: L k_lims then
// L n_lims, on the device and on the host. Returns the cudaError_t of the
// first launch that failed (0 on success).
int fused_mlp_wstat_run(const void* x0, void* panel, void* xq, void* wt,
                        void* mx, const void* groups, const void* planes,
                        const void* bias, const void* mask,
                        const void* w_scale, const void* sx, const void* lims,
                        const void* lims_host, int n_layers, int n_planes,
                        int cell_bits, int weight_bits, int batch, int m_pad,
                        int m_real, int d, int final_relu, void* stream) {
  const int* host = static_cast<const int*>(lims_host);
  const int* grp = static_cast<const int*>(groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_combine(planes, wt, mx, batch * n_layers,
                           static_cast<const int*>(lims), host, n_layers,
                           n_planes, cell_bits, weight_bits, d, d, d, st);
  const size_t plane = static_cast<size_t>(d) * d;
  const int row_tiles = batch * (m_pad / BM);
  for (int l = 0; l < n_layers && !err; ++l) {
    const int k_lim = host[l], n_lim = host[n_layers + l];
    const int8_t* src = static_cast<const int8_t*>(x0);
    if (l) {
      const size_t n_words =
          static_cast<size_t>(batch) * m_pad * static_cast<size_t>(k_lim / 4);
      const size_t blocks = (n_words + THREADS - 1) / THREADS;
      wstat_requant_kernel<<<static_cast<unsigned>(
                                 blocks < 65535 ? blocks : 65535),
                             THREADS, 0, st>>>(
          static_cast<const float*>(panel), static_cast<int8_t*>(xq),
          static_cast<const int*>(mx), l, n_layers, weight_bits, m_pad, d,
          k_lim, n_words);
      err = static_cast<int>(cudaGetLastError());
      if (err) break;
      src = static_cast<const int8_t*>(xq);
    }
    const Chunk c = chunk_of(k_lim);
    const Kernel kernel = kernel_of(c);
    const size_t smem = static_cast<size_t>(smem_of(k_lim));
    err = xbar::allow_smem(kernel, smem);
    if (err) break;
    const dim3 grid((n_lim + c.cols - 1) / c.cols, grp[l]);
    kernel<<<grid, THREADS, smem, st>>>(
        src, static_cast<float*>(panel),
        static_cast<const int8_t*>(wt) + l * plane,
        static_cast<const float*>(bias) + static_cast<size_t>(l) * d,
        static_cast<const float*>(mask) + static_cast<size_t>(l) * d,
        static_cast<const float*>(w_scale) + l,
        static_cast<const float*>(sx), static_cast<int*>(mx), l, n_layers,
        weight_bits, m_pad, m_real, d, k_lim, n_lim, row_tiles,
        l < n_layers - 1 || final_relu);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

}  // extern "C"
