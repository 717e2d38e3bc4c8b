// K4/K5 on Hopper: plan-ordered neighbor gather + difference.
//
// Replaces the TPU kernels src/repro/kernels/aggregate.py::_kernel_batched
// (aggregate_diff_batched, K4) and ::_kernel (aggregate_diff, K5, launched
// here as batch 1):
//   out[b, i, j, :] = F[b, nbr[b, i, j], :] - F[b, ctr[b, i], :]
// Exact: one float32 subtraction per element, as in the plain version.
//
// Design. On the TPU each grid step DMA'd one feature row, and the plan
// order let consecutive steps reuse a row already in VMEM. Here a block
// owns `cpb` consecutive centers of the plan order: it loads their center
// rows into shared memory once, then walks their K neighbor rows with
// threads spread over the C channels (16-byte loads and stores when C is a
// multiple of 4), so each row read and each output row written is
// coalesced. At narrow C (8 at model1 SA-1) one center is only K*C floats,
// so the wrapper packs several centers per block. Rows shared between
// nearby centers of the plan order are served from L1/L2.
//
// Bound on the H100: no arithmetic to speak of; bound by bytes, mostly the
// (B, M, K, C) float32 output. Indices are clamped into [0, n) as a memory
// guard only: the model never passes others.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <int VEC>
__global__ void __launch_bounds__(THREADS)
aggregate_diff_kernel(const float* __restrict__ feats,
                      const int* __restrict__ nbr,
                      const int* __restrict__ ctr,
                      float* __restrict__ out,
                      int n, int m, int k, int c, int cpb) {
  extern __shared__ float ctr_rows[];  // cpb * c
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * cpb;
  const int nc = min(cpb, m - i0);
  const float* fb = feats + static_cast<size_t>(b) * n * c;
  const size_t center0 = static_cast<size_t>(b) * m + i0;

  for (int e = threadIdx.x; e < nc * c; e += THREADS) {
    const int ii = e / c, cc = e % c;
    const int row = min(max(ctr[center0 + ii], 0), n - 1);
    ctr_rows[e] = fb[static_cast<size_t>(row) * c + cc];
  }
  __syncthreads();

  const int cv = c / VEC;
  const int total = nc * k * cv;
  for (int e = threadIdx.x; e < total; e += THREADS) {
    const int cc = e % cv;
    const int t = e / cv;                   // (center, neighbor) pair
    const int ii = t / k;
    const int row = min(max(nbr[center0 * k + t], 0), n - 1);
    const size_t o = (center0 * k + t) * c + static_cast<size_t>(cc) * VEC;
    if constexpr (VEC == 4) {
      float4 v = reinterpret_cast<const float4*>(
          fb + static_cast<size_t>(row) * c)[cc];
      const float4 s = reinterpret_cast<const float4*>(ctr_rows + ii * c)[cc];
      v.x = __fsub_rn(v.x, s.x);
      v.y = __fsub_rn(v.y, s.y);
      v.z = __fsub_rn(v.z, s.z);
      v.w = __fsub_rn(v.w, s.w);
      *reinterpret_cast<float4*>(out + o) = v;
    } else {
      out[o] = __fsub_rn(fb[static_cast<size_t>(row) * c + cc],
                         ctr_rows[ii * c + cc]);
    }
  }
}

}  // namespace

extern "C" {

// Grid (ceil(m / cpb), batch); cpb * c floats of shared memory per block.
// Returns the cudaError_t of the launch (0 on success).
int aggregate_diff(const void* feats, const void* nbr, const void* ctr,
                   void* out, int batch, int n, int m, int k, int c, int cpb,
                   void* stream) {
  const dim3 grid((m + cpb - 1) / cpb, batch);
  const size_t smem = static_cast<size_t>(cpb) * c * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c % 4 == 0) {
    aggregate_diff_kernel<4><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(feats), static_cast<const int*>(nbr),
        static_cast<const int*>(ctr), static_cast<float*>(out), n, m, k, c,
        cpb);
  } else {
    aggregate_diff_kernel<1><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(feats), static_cast<const int*>(nbr),
        static_cast<const int*>(ctr), static_cast<float*>(out), n, m, k, c,
        cpb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
