// K4/K5 on Hopper: plan-ordered neighbor gather + difference.
//
// Replaces the TPU kernels src/repro/kernels/aggregate.py::_kernel_batched
// (aggregate_diff_batched, K4) and ::_kernel (aggregate_diff, K5, launched
// here as batch 1):
//   out[b, i, j, :] = F[b, nbr[b, o_i, j], :] - F[b, ctr[b, o_i], :],
//   o_i = order[b, i] (or i where no order is given).
// Exact: one float32 subtraction per element, as in the plain version.
//
// What bounds it. Almost no arithmetic: the bytes, mostly the (B, M, K, C)
// float32 output, and at the main path's sizes (K5's 128 x 16 x 256, K4's
// 8 x 512 x 16 x 8) not even those: a launch of a few microseconds, and
// the host work around it. So the design cuts launches and fills the card:
// - the kernel composes the plan itself: it reads the plan order (int32)
//   and the geometry's own index-order indices (int64 kNN and FPS outputs,
//   or int32; strided, so kNN's sliced (M, K) view needs no copy). The
//   main path no longer permutes and casts the indices first (two
//   take_along_dim and two casts a layer before this kernel);
// - one thread a 16-byte chunk of one output row (C a multiple of 4 and
//   16-byte aligned rows; else one float a thread): a centre's K rows are
//   spread over warps and blocks, never walked serially by one block, so
//   batch 1 at 128 centres still gives hundreds of blocks. Consecutive
//   threads write consecutive addresses; the three index loads a thread
//   makes are shared by the threads of its row (one transaction a warp);
//   the centre row a row subtracts is read through L1.
// Indices are clamped into [0, n) (the order into [0, m)) as a memory
// guard only: the model never passes others.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int VEC, typename IDX>
__global__ void __launch_bounds__(kThreads)
aggregate_diff_kernel(const float* __restrict__ feats,
                      const IDX* __restrict__ nbr, const IDX* __restrict__ ctr,
                      const int* __restrict__ order, float* __restrict__ out,
                      int n, int m, int k, int c, long long nbr_bs,
                      long long nbr_rs, long long ctr_bs, long long order_bs) {
  const unsigned cv = static_cast<unsigned>(c / VEC);
  const unsigned e = blockIdx.x * kThreads + threadIdx.x;
  const unsigned per_cloud = static_cast<unsigned>(m) * k * cv;
  if (e >= per_cloud) return;
  const long long b = blockIdx.y;
  const unsigned cc = e % cv;
  const unsigned t = e / cv;                 // (plan position, neighbor)
  const unsigned j = t % k;
  const unsigned i = t / k;
  int row = static_cast<int>(i);
  if (order != nullptr)
    row = min(max(order[b * order_bs + i], 0), m - 1);
  const long long nb = min(max(static_cast<long long>(
                                   nbr[b * nbr_bs + row * nbr_rs + j]), 0LL),
                           static_cast<long long>(n - 1));
  const long long ct = min(max(static_cast<long long>(ctr[b * ctr_bs + row]),
                               0LL), static_cast<long long>(n - 1));
  const float* fb = feats + b * n * c;
  float* o = out + (b * m * k + t) * c + static_cast<long long>(cc) * VEC;
  if constexpr (VEC == 4) {
    float4 v = reinterpret_cast<const float4*>(fb + nb * c)[cc];
    const float4 s = reinterpret_cast<const float4*>(fb + ct * c)[cc];
    v.x = __fsub_rn(v.x, s.x);
    v.y = __fsub_rn(v.y, s.y);
    v.z = __fsub_rn(v.z, s.z);
    v.w = __fsub_rn(v.w, s.w);
    *reinterpret_cast<float4*>(o) = v;
  } else {
    *o = __fsub_rn(fb[nb * c + cc], fb[ct * c + cc]);
  }
}

template <typename IDX>
void launch(int vec, dim3 grid, cudaStream_t st, const void* feats,
            const void* nbr, const void* ctr, const void* order, void* out,
            int n, int m, int k, int c, long long nbr_bs, long long nbr_rs,
            long long ctr_bs, long long order_bs) {
  const auto* f = static_cast<const float*>(feats);
  const auto* nb = static_cast<const IDX*>(nbr);
  const auto* ct = static_cast<const IDX*>(ctr);
  const auto* od = static_cast<const int*>(order);
  auto* o = static_cast<float*>(out);
  if (vec == 4)
    aggregate_diff_kernel<4, IDX><<<grid, kThreads, 0, st>>>(
        f, nb, ct, od, o, n, m, k, c, nbr_bs, nbr_rs, ctr_bs, order_bs);
  else
    aggregate_diff_kernel<1, IDX><<<grid, kThreads, 0, st>>>(
        f, nb, ct, od, o, n, m, k, c, nbr_bs, nbr_rs, ctr_bs, order_bs);
}

}  // namespace

extern "C" {

// out (batch, m, k, c) float32 from feats (batch, n, c) float32, the
// neighbor indices nbr (element strides nbr_bs a cloud, nbr_rs a row, 1
// along k) and centre indices ctr (ctr_bs a cloud), int64 where idx64 else
// int32, and the plan order (batch, m) int32 (order_bs a cloud; null: the
// identity). The launch, planned by kernels/aggregate.py::gather_launch:
// `vec` floats a thread, 4 (c a multiple of 4, feats and out 16-byte
// aligned) or 1, and a grid of (blocks, batch), blocks * 256 * vec >=
// m k c. Returns the cudaError_t of the launch (0 on success).
int aggregate_diff(const void* feats, const void* nbr, const void* ctr,
                   const void* order, void* out, int batch, int n, int m,
                   int k, int c, long long nbr_bs, long long nbr_rs,
                   long long ctr_bs, long long order_bs, int idx64, int vec,
                   int blocks, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || m < 1 || k < 1 || c < 1 ||
      (vec != 1 && vec != 4) || c % vec != 0 ||
      static_cast<long long>(m) * k * c >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4 && ((reinterpret_cast<uintptr_t>(feats) |
                    reinterpret_cast<uintptr_t>(out)) & 15u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = static_cast<long long>(m) * k * (c / vec);
  if (blocks < 1 || static_cast<long long>(blocks) * kThreads < chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx64)
    launch<long long>(vec, grid, st, feats, nbr, ctr, order, out, n, m, k, c,
                      nbr_bs, nbr_rs, ctr_bs, order_bs);
  else
    launch<int>(vec, grid, st, feats, nbr, ctr, order, out, n, m, k, c,
                nbr_bs, nbr_rs, ctr_bs, order_bs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
