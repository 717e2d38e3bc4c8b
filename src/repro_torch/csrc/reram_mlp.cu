// K6 on Hopper: the bit-sliced INT8 crossbar matmul of the per-layer
// 'reram' backend, on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/reram_mlp.py::_kernel
// (reram_matmul_int, launched at reram_mlp.py:83). It computes, exactly in
// int32,
//   y[m][n] = sum_k x[m][k] * u[k][n] - (sum_k x[m][k]) << (weight_bits - 1)
// with u = sum_p plane_p << (cell_bits * p), the offset-binary weight held
// as cell planes (P, K, N) — that is, x @ w_s8, w_s8 = combine_planes(planes)
// (crossbar_mma.cuh's identity: the row sums go away).
//
// Design. The TPU kernel walked a (M/128, N/128, K/128) grid with K
// innermost and carried the int32 sum in VMEM across K steps, on operands
// padded to the 128 x 128 crossbar. Here one C call makes two launches on
// one stream:
//   1. the s8 pre-pass (crossbar_mma.cuh's combine_weights_kernel): the
//      planes combined once per product into w_s8[n][k], row pitch kp = K
//      rounded up to 16 with zeros in the pad, so that the 16-byte copies
//      stay aligned. The planes stay the only input: the 'reram' backend
//      quantizes and encodes the weights anew on every call.
//   2. the product: a block owns BM rows, one BN-column chunk and one K
//      range [kb, ke) of at most STRIPE_K bytes. It stages its int8 row
//      stripe in shared memory (cp.async where K is a multiple of 16; else
//      byte loads that zero the ragged edge), streams the chunk's weight
//      slabs through the cp.async ring and multiplies on the tensor cores
//      (chunk_product: mma.sync m16n8k32 s8 x s8 -> s32), then writes int32
//      straight from the accumulator layout (rows g and g + 8, columns 2t
//      and 2t + 1), masking rows >= M and columns >= N; a column pair is one
//      8-byte store where N is even. No dequantization here: reram_linear
//      does it in torch.
// Split K. Where the (N / BN) x (M / BM) blocks would leave most SMs idle
// (the head's M = 8 and M = 1), or K is wider than one stripe, the wrapper
// splits K into ranges (kernels/program.py::plan_reram), one grid layer
// each. Those blocks add their partial sums into the output with int32
// atomicAdd, exact in any order, so the result is the same integer; the
// pre-pass zeroes the output first.
//
// Bound on the H100: bytes, set by the int32 output (4 bytes an output
// against at most K = 1024 int8 multiply-adds): 0.139 ms over the 8
// products of one model2 'reram' batched_forward at 3.35 TB/s. The design
// reads each weight slab once per row tile (from L2) and each row stripe
// once per N chunk (from L2, as the chunks of a row tile run side by side).

#include "crossbar_mma.cuh"

namespace {

using namespace xmma;

__host__ __device__ constexpr int pad16(int k) { return (k + 15) / 16 * 16; }

// Dynamic shared memory of one product block at K range k_step, bytes.
constexpr int smem_of(int k_step) {
  return BM * stripe_pitch(k_step) + RING_BYTES;
}

// The block's int8 row stripe: rows m0 .. m0 + BM of x (m x k, row pitch
// k) over K [kb, ke) (ke - kb a multiple of 16), rows >= m and K >= k
// zeros. ALIGNED (k a multiple of 16, x 16-byte aligned): 16-byte cp.async
// copies, committed as one group; else byte loads (the narrow first layers,
// K = 3 .. 8, and ragged K).
template <bool ALIGNED>
__device__ __forceinline__ void load_stripe(int8_t* stripe, int ap,
                                            const int8_t* x, int m, int k,
                                            int m0, int kb, int ke) {
  if (ALIGNED) {
    const int chunks = (ke - kb) / 16;
    for (int e = threadIdx.x; e < BM * chunks; e += THREADS) {
      const int r = e / chunks, c = e % chunks;
      const bool ok = m0 + r < m;
      cp_async16(stripe + r * ap + 16 * c,
                 ok ? x + static_cast<size_t>(m0 + r) * k + kb + 16 * c : x,
                 ok);
    }
    cp_async_commit();
  } else {
    const int w = ke - kb;
    for (int e = threadIdx.x; e < BM * w; e += THREADS) {
      const int r = e / w, c = e % w;
      const bool ok = m0 + r < m && kb + c < k;
      stripe[r * ap + c] =
          ok ? x[static_cast<size_t>(m0 + r) * k + kb + c] : int8_t{0};
    }
  }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
reram_matmul_mma_kernel(const int8_t* __restrict__ x,
                        const int8_t* __restrict__ wt,
                        int* __restrict__ out, int m, int k, int n, int kp,
                        int k_step) {
  extern __shared__ __align__(16) int8_t smem[];
  const int ap = stripe_pitch(k_step);
  int8_t* stripe = smem;
  int8_t* ring = smem + BM * ap;

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * k_step;
  const int ke = kp - kb < k_step ? kp : kb + k_step;

  load_stripe<ALIGNED>(stripe, ap, x, m, k, m0, kb, ke);
  chunk_prefetch(wt, kp, n0, n, kb, ke, ring);
  if (ALIGNED) cp_async_wait<STAGES - 1>();   // the stripe's group
  const Lane ln = lane_of();
  int acc[2][4][4];
  clear(acc);
  chunk_product(stripe, ap, wt, kp, n0, n, kb, ke, ring, ln, acc);

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = n0 + ln.wn * 32 + j * 8 + 2 * ln.t;
    if (c >= n) continue;
    const bool second = c + 1 < n;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + ln.wm * 32 + i * 16 + ln.g + 8 * h;
        if (r >= m) continue;
        int* o = out + static_cast<size_t>(r) * n + c;
        const int y0 = acc[i][j][2 * h], y1 = acc[i][j][2 * h + 1];
        if (split) {
          atomicAdd(o, y0);
          if (second) atomicAdd(o + 1, y1);
        } else if ((n & 1) == 0) {   // c even: the pair is 8-byte aligned
          *reinterpret_cast<int2*>(o) = make_int2(y0, y1);
        } else {
          o[0] = y0;
          if (second) o[1] = y1;
        }
      }
  }
}

}  // namespace

extern "C" {

// Tile edges the wrapper's split must agree with (rows, N-chunk, K slab),
// and the widest K range of one block.
int reram_mlp_tile(int which) {
  return which == 0 ? BM : which == 1 ? BN : which == 2 ? BK : STRIPE_K;
}

// The s8 pre-pass alone, for tests and timing (reram_matmul_int launches
// it itself): planes (n_planes, k, n) int8 -> wt (n, kp) int8, kp = k
// rounded up to 16, zeros in columns k .. kp. Returns the cudaError_t of
// the launch (0 on success).
int reram_combine(const void* planes, void* wt, int k, int n, int n_planes,
                  int cell_bits, int weight_bits, void* stream) {
  return launch_combine(planes, wt, nullptr, 0, nullptr, nullptr, 1,
                        n_planes, cell_bits, weight_bits, k, n, pad16(k),
                        static_cast<cudaStream_t>(stream));
}

// y (m, n) int32 = x (m, k) int8 times the (n_planes, k, n) int8 planes:
// the pre-pass into wt, an (n, kp) int8 scratch buffer, then the product
// over the grid (ceil(n / BN), ceil(m / BM), ceil(kp / k_step)), both on
// `stream`. k_step, each block's K range, is a multiple of BK of at most
// STRIPE_K (kernels/program.py::plan_reram); with more than one range the
// pre-pass zeroes `out` and the blocks add into it. Returns the
// cudaError_t of the first launch that failed (0 on success).
int reram_matmul_int(const void* x, const void* planes, void* wt, void* out,
                     int m, int k, int n, int n_planes, int cell_bits,
                     int weight_bits, int k_step, void* stream) {
  const int kp = pad16(k);
  if (k_step <= 0 || k_step % BK || k_step > STRIPE_K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int split = (kp + k_step - 1) / k_step;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, split);
  if (grid.y > 65535 || grid.z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_combine(planes, wt, out, split > 1 ? m * n : 0, nullptr,
                           nullptr, 1, n_planes, cell_bits, weight_bits, k, n,
                           kp, st);
  if (err) return err;
  const bool aligned =
      k % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const auto kernel = aligned ? &reram_matmul_mma_kernel<true>
                              : &reram_matmul_mma_kernel<false>;
  const size_t smem = static_cast<size_t>(smem_of(k_step));
  err = xbar::allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
      static_cast<int*>(out), m, k, n, kp, k_step);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
