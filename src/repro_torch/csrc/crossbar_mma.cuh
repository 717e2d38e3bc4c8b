// Tensor-core pieces of the crossbar kernels K1 (fused_mlp.cu), K2
// (fused_mlp_mtiled.cu), K3 (fused_mlp_wstat.cu) and K6 (reram_mlp.cu), and
// the s8 weight pre-pass they launch (alone: fused_mlp.cu's combine_weights
// and reram_mlp.cu's reram_combine).
//
// The weights are signed int8. combine_planes(planes) = u - (1 << (wb - 1))
// lies in [-128, 127] for weight_bits <= 8, so
//   sum_k x[k] * u[k][n] - (sum_k x[k]) << (wb - 1) = sum_k x[k] * w_s8[k][n]
// exactly: the row sums of the offset-binary product go away and both
// operands of the product are s8. The pre-pass writes the s8 weights once
// per call (every layer of an MLP for K1-K3, the one product's for K6),
// transposed to [n][k]: the "col" layout of the MMA's B operand, K
// contiguous for each column.
//
// The product is mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 on the
// tensor cores. A block of THREADS threads owns BM rows; its 8 warps tile
// an output chunk 2 (rows) x 4 (columns), each warp a 32 x 8·NT patch, i.e.
// 2 x NT MMAs per 32-deep K step (warp_step; NT = 4 but in K3's narrowed
// chunks). In K1, K2 and K6 the activations sit in shared memory as an
// int8 stripe (BM rows, row pitch k + 16 bytes) and the weights stream
// through a STAGES-deep ring of BN x BK slabs filled by cp.async
// (chunk_product), so the next slabs load while the tensor cores work on
// the current one, and a chunk's first slabs load during the previous
// chunk's epilogue; K3 swaps the operands' roles (resident weights, a ring
// of activation slabs: fused_mlp_wstat.cu). A product runs over one K range
// [k_begin, k_end) of the stripe; K1 splits a layer wider than STRIPE_K
// bytes into such ranges and accumulates, and K6 gives each range to a
// block of its own, so no width is too wide for them. The per-layer extents
// (k_lims then n_lims) come as a device array, so an MLP may have any
// number of layers. Fragments are read with 32-bit shared loads; every
// pitch is an odd multiple of 16 bytes (4 banks), so the 8 rows x 4 words
// a warp reads fall in distinct banks.
//
// The epilogues dequantize as the plain version does and requantize with
// a multiply by the scale's reciprocal, falling back to the exact division
// where the two could round apart (requant_fast), so every step stays bit
// for bit.
//
// Fragment layout of m16n8k32 (g = lane / 4, t = lane % 4):
//   A regs 0..3: (row g, k 4t..4t+3), (g + 8, 4t..), (g, 16 + 4t..),
//                (g + 8, 16 + 4t..)
//   B regs 0..1: (k 4t..4t+3, col g), (k 16 + 4t.., col g)
//   C regs 0..3: (row g, cols 2t, 2t + 1), (row g + 8, cols 2t, 2t + 1)
// so the epilogue's row mask, column mask, bias and max follow that layout.
#pragma once

#include "crossbar.cuh"

namespace xmma {

constexpr int BM = 64;            // rows of a block: one stripe
constexpr int BN = 128;           // output columns of one chunk
constexpr int BK = 64;            // K bytes of one weight slab
constexpr int STAGES = 3;         // weight slabs in flight
constexpr int THREADS = 256;      // 8 warps, 2 x 4 over the chunk
constexpr int BP = BK + 16;       // slab row pitch, bytes
constexpr int RING_BYTES = STAGES * BN * BP;
constexpr int STRIPE_K = 2048;    // widest K range of K1's stripe, bytes
static_assert(THREADS == xbar::THREADS, "publish_max reduces THREADS lanes");
static_assert(STRIPE_K % BK == 0, "K ranges split at slab edges");

// The largest of n ints (a host array).
inline int widest(const int* v, int n) {
  int w = 0;
  for (int i = 0; i < n; ++i) w = v[i] > w ? v[i] : w;
  return w;
}

// Row pitch of an int8 stripe holding k bytes a row (k a multiple of 32).
__host__ __device__ constexpr int stripe_pitch(int k) { return k + 16; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;   // 0: fill 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int lds32(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}

// Copy `rows` rows of `k` int8 bytes (k a multiple of 16) from global rows
// of pitch `gp` into a shared stripe of pitch `sp`. The caller commits.
__device__ __forceinline__ void load_rows(int8_t* dst, int sp,
                                          const int8_t* src, size_t gp,
                                          int rows, int k) {
  const int chunks = k / 16;
  for (int e = threadIdx.x; e < rows * chunks; e += THREADS) {
    const int r = e / chunks, c = e % chunks;
    cp_async16(dst + r * sp + 16 * c, src + r * gp + 16 * c, true);
  }
}

// Issue the cp.async copies of one BN x BK weight slab: columns n0.. of the
// layer's [n][k] weights (pitch d) from k0; columns >= n_lim and K from
// k_end on are filled with zeros. The caller commits.
__device__ __forceinline__ void load_slab(int8_t* buf, const int8_t* wt,
                                          int d, int n0, int n_lim, int k0,
                                          int k_end) {
  constexpr int CH = BK / 16;
  for (int e = threadIdx.x; e < BN * CH; e += THREADS) {
    const int n = e / CH, c = e % CH;
    const int k = k0 + 16 * c;
    const bool ok = n0 + n < n_lim && k < k_end;
    cp_async16(buf + n * BP + 16 * c,
               ok ? wt + static_cast<size_t>(n0 + n) * d + k : wt, ok);
  }
}

// The warp's place in the chunk and its lane's place in the fragments.
struct Lane {
  int wm, wn, g, t;
};

__device__ __forceinline__ Lane lane_of() {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return {warp / 4, warp % 4, lane / 4, lane % 4};
}

// Issue the first STAGES - 1 slabs of a chunk over K [k_begin, k_end) (one
// commit group each, empty where the range has fewer slabs). Called after
// the previous product returned, so the copies overlap its epilogue.
__device__ __forceinline__ void chunk_prefetch(const int8_t* wt, int d, int n0,
                                               int n_lim, int k_begin,
                                               int k_end, int8_t* ring) {
  const int nk = (k_end - k_begin + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_slab(ring + s * BN * BP, wt, d, n0, n_lim, k_begin + s * BK,
                k_end);
    cp_async_commit();
  }
}

template <int NT>
__device__ __forceinline__ void clear(int (&acc)[2][NT][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;
}

// One 32-deep K step of the warp's 32 x 8·NT patch: A points at the
// block's BM rows at this step's k (row pitch ap bytes), B at the chunk's
// columns ([n][k], pitch bp) at the same k. acc is [m16 tile][n8 tile][C
// reg].
template <int NT>
__device__ __forceinline__ void warp_step(const int8_t* A, int ap,
                                          const int8_t* B, int bp, Lane ln,
                                          int (&acc)[2][NT][4]) {
  int a[2][4], b[NT][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int8_t* p = A + (ln.wm * 32 + i * 16 + ln.g) * ap + 4 * ln.t;
    a[i][0] = lds32(p);
    a[i][1] = lds32(p + 8 * ap);
    a[i][2] = lds32(p + 16);
    a[i][3] = lds32(p + 8 * ap + 16);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int8_t* q = B + (ln.wn * 8 * NT + j * 8 + ln.g) * bp + 4 * ln.t;
    b[j][0] = lds32(q);
    b[j][1] = lds32(q + 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
}

// acc += stripe x the layer's weights over K [k_begin, k_end), for output
// columns n0 .. n0 + BN: the stripe holds BM rows of that K range at As
// (pitch ap), each warp's 32 x 32 patch is [m16 tile][n8 tile][C reg]. The
// range's first slabs must have been issued by chunk_prefetch, and no copy
// committed since. Every thread of the block must call it; it starts and
// ends with a block barrier, so the stripe may be written up to the call
// and the stripe and the ring reused after it.
__device__ __forceinline__ void chunk_product(const int8_t* As, int ap,
                                              const int8_t* wt, int d, int n0,
                                              int n_lim, int k_begin,
                                              int k_end, int8_t* ring,
                                              Lane ln, int (&acc)[2][4][4]) {
  const int nk = (k_end - k_begin + BK - 1) / BK;
  const bool active = n0 + ln.wn * 32 < n_lim;   // warp has real columns
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = kt + STAGES - 1;
    if (nxt < nk)
      load_slab(ring + (nxt % STAGES) * BN * BP, wt, d, n0, n_lim,
                k_begin + nxt * BK, k_end);
    cp_async_commit();
    if (!active) continue;
    const int8_t* bs = ring + (kt % STAGES) * BN * BP;
    const int k0 = kt * BK;   // within the stripe
    // A slab that passes k_end (by 32 bytes) holds zero weights there, so
    // whatever the stripe holds beyond k_end (the next row, or the next
    // buffer: it stays inside the block's shared memory) adds nothing.
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks)
      warp_step<4>(As + k0 + ks * 32, ap, bs + ks * 32, BP, ln, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The s8 weight pre-pass (one launch per call): layer l's planes are
// (n_planes, rows, pitch) int8, and for k < k_lim, n < n_lim
//   wt[l][n][k] = sum_p planes[l][p][k][n] << (cell_bits * p)
//                 - (1 << (weight_bits - 1))       (k < rows)
//   wt[l][n][k] = 0                                 (k >= rows)
// with row pitch dst_pitch (layer stride pitch * dst_pitch). K1-K3 give the
// extents as the device array lims (k_lim = lims[l], n_lim = lims[n_layers
// + l]) over square (d, d) planes; K6 gives none (lims null): one layer, the
// whole plane, k_lim = dst_pitch (K rounded up to 16, so that 16-byte
// copies stay aligned: the pad is zeros) and n_lim = pitch = N. The values
// lie in [-128, 127] for weight_bits <= 8 (K1's padded columns, whose
// planes are zero, give -128; the product masks them). Nothing else of wt
// is written. A block transposes one 32 x 32 tile through shared memory, so
// the plane reads (along n) and the writes (along k) are both coalesced.
// The blocks also zero `n_zero` ints at `zero`, grid-stride: the running
// maxima of a K1-K3 call, or the output K6's split-K blocks add into, which
// the launches queued after it then raise.
__global__ void __launch_bounds__(256)
combine_weights_kernel(const int8_t* __restrict__ planes,
                       int8_t* __restrict__ wt, int* __restrict__ zero,
                       int n_zero, const int* __restrict__ lims,
                       int n_layers, int n_planes, int cell_bits,
                       int weight_bits, int rows, int pitch, int dst_pitch) {
  __shared__ int8_t tile[32][33];
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                  blockIdx.x;
  const int step = gridDim.x * gridDim.y * gridDim.z * 256;
  for (int i = blk * 256 + tid; i < n_zero; i += step) zero[i] = 0;
  const int l = blockIdx.z;
  const int k_lim = lims ? lims[l] : dst_pitch;
  const int n_lim = lims ? lims[n_layers + l] : pitch;
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  if (n0 >= n_lim || k0 >= k_lim) return;           // uniform per block
  const size_t plane = static_cast<size_t>(rows) * pitch;
  const int8_t* src = planes + static_cast<size_t>(l) * n_planes * plane;
  const int offset = 1 << (weight_bits - 1);
  const int n = n0 + threadIdx.x;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int k = k0 + i;
    int w = 0;
    if (k < rows && n < pitch) {
      const size_t idx = static_cast<size_t>(k) * pitch + n;
      int u = 0;
      for (int p = 0; p < n_planes; ++p)
        u += static_cast<int>(static_cast<uint8_t>(src[p * plane + idx]))
             << (cell_bits * p);
      w = u - offset;
    }
    tile[i][threadIdx.x] = static_cast<int8_t>(w);
  }
  __syncthreads();
  int8_t* dst = wt + static_cast<size_t>(l) * pitch * dst_pitch;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int nn = n0 + i, k = k0 + threadIdx.x;
    if (nn < n_lim && k < k_lim)
      dst[static_cast<size_t>(nn) * dst_pitch + k] = tile[threadIdx.x][i];
  }
}

// Launch the pre-pass over n_layers layers of (n_planes, rows, pitch)
// planes into wt (row pitch dst_pitch). `lims` is the extents' device
// array and `lims_host` the same on the host (it sizes the grid), or both
// null for K6's one whole plane (see combine_weights_kernel). Returns the
// cudaError_t.
inline int launch_combine(const void* planes, void* wt, void* zero,
                          int n_zero, const int* lims, const int* lims_host,
                          int n_layers, int n_planes, int cell_bits,
                          int weight_bits, int rows, int pitch, int dst_pitch,
                          cudaStream_t stream) {
  if (n_layers < 1 || n_layers > 65535 || (!lims && n_layers != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kmax = lims ? widest(lims_host, n_layers) : dst_pitch;
  const int nmax = lims ? widest(lims_host + n_layers, n_layers) : pitch;
  const dim3 grid((nmax + 31) / 32, (kmax + 31) / 32, n_layers);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  combine_weights_kernel<<<grid, dim3(32, 8), 0, stream>>>(
      static_cast<const int8_t*>(planes), static_cast<int8_t*>(wt),
      static_cast<int*>(zero), n_zero, lims, n_layers, n_planes, cell_bits,
      weight_bits, rows, pitch, dst_pitch);
  return static_cast<int>(cudaGetLastError());
}

// Call f(row, col, y0_int, y1_int, bias2, mask2) for each pair of adjacent
// outputs (col, col + 1) the lane holds with col < n_end; row within the
// stripe, col within the layer (chunk start n0 added). A lane's 8·NT
// outputs fall in NT column pairs, so each pair's bias and mask are loaded
// once.
template <int NT, typename F>
__device__ __forceinline__ void for_each_pair(const int (&acc)[2][NT][4],
                                              Lane ln, int n0, int n_end,
                                              const float* bias,
                                              const float* mask, F f) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + ln.wn * 8 * NT + j * 8 + 2 * ln.t;
    if (n >= n_end) continue;
    const float2 b2 = *reinterpret_cast<const float2*>(bias + n);
    const float2 m2 = *reinterpret_cast<const float2*>(mask + n);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(ln.wm * 32 + i * 16 + ln.g + 8 * h, n, acc[i][j][2 * h],
          acc[i][j][2 * h + 1], b2, m2);
  }
}

// y = float(y_int) * c + bias; ReLU; * col_mask; rows >= m_real zeroed —
// each float step one IEEE operation rounded to nearest, as the plain
// version.
__device__ __forceinline__ float dequant(int yi, float c, float bias,
                                         float mask, bool relu, bool row_ok) {
  float y = __fadd_rn(__fmul_rn(static_cast<float>(yi), c), bias);
  if (relu) y = fmaxf(y, 0.0f);
  y = __fmul_rn(y, mask);
  return row_ok ? y : 0.0f;
}

// clip(rint(a / s), -qmax, qmax) as one int8 byte, bit for bit as the
// exactly rounded division (rintf(__fdiv_rn(a, s)), half to even), with
// r = 1 / s rounded (__frcp_rn). q0 = a * r lies within
// 2^-15 of the rounded quotient while |a / s| < 128 (two roundings of
// relative 2^-24, plus the quotient's own half ulp of 2^-18), so where q0
// is more than 2^-12 from a half-integer both round to the same integer;
// elsewhere (and beyond 128, inf or NaN) the exactly rounded division
// decides. It saves the division for all but about 1 in 2000 values.
__device__ __forceinline__ unsigned requant_fast(float a, float s, float r,
                                                 float qmax) {
  const float q0 = __fmul_rn(a, r);
  const float f = q0 - floorf(q0);
  const float q = fabsf(q0) < 128.0f && fabsf(f - 0.5f) > 0x1p-12f
                      ? rintf(q0)
                      : rintf(__fdiv_rn(a, s));
  const float c = fminf(fmaxf(q, -qmax), qmax);
  return static_cast<unsigned>(static_cast<int>(c)) & 0xffu;
}

// Four consecutive activations requantized and packed into one word.
__device__ __forceinline__ int requant4_fast(float4 a, float s, float r,
                                             float qmax) {
  return static_cast<int>(
      requant_fast(a.x, s, r, qmax) | (requant_fast(a.y, s, r, qmax) << 8) |
      (requant_fast(a.z, s, r, qmax) << 16) |
      (requant_fast(a.w, s, r, qmax) << 24));
}

}  // namespace xmma
