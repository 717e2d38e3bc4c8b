// Pieces shared by the fused crossbar-MLP kernels K1 (fused_mlp.cu), K2
// (fused_mlp_mtiled.cu) and K3 (fused_mlp_wstat.cu), and the shared-memory
// opt-in of every launch of those and of K6 (reram_mlp.cu).
//
// The fused kernels run one launch per layer: the next layer's requant
// scale is a max over the whole layer's output, which each block publishes
// with one atomicMax on the float's bits (publish_max) and the next launch
// on the same stream reads back (layer_scale). Their products are on the
// tensor cores (crossbar_mma.cuh).
//
// The float steps round exactly as the plain torch versions: __fdiv_rn in
// the scale, so that nvcc cannot turn it into a multiply by the reciprocal.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace xbar {

constexpr int THREADS = 256;     // threads of a block (publish_max reduces)

// The input scale of layer `layer` for batch element b: the external scale
// sx[b] at layer 0, else max(max|y_{l-1}| / qmax, 1e-12) from the max the
// previous launch published in mx (float bits, (B, n_layers)).
__device__ __forceinline__ float layer_scale(bool first, const float* sx,
                                             const int* mx, int b, int layer,
                                             int n_layers, float qmax) {
  return first ? sx[b]
               : fmaxf(__fdiv_rn(__int_as_float(mx[b * n_layers + layer - 1]),
                                 qmax),
                       1e-12f);
}

// Reduce the block's max |y| and publish it with one atomicMax on the
// float's bits (valid because |y| >= 0). Every thread of the block must
// call it; red holds THREADS / 32 floats of shared memory.
__device__ __forceinline__ void publish_max(float local, float* red,
                                            int* dst) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    local = fmaxf(local, __shfl_xor_sync(0xffffffffu, local, o));
  if ((tid & 31) == 0) red[tid >> 5] = local;
  __syncthreads();
  if (tid == 0) {
    float m = red[0];
    for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, red[w]);
    atomicMax(dst, __float_as_int(m));
  }
  __syncthreads();
}

// Allow `bytes` of dynamic shared memory for `kernel`. Without it a launch
// is refused once dynamic plus static shared memory pass 48 KB — so at
// exactly 48 KB of dynamic memory beside a kernel's own few static bytes
// (K2 at a widest k_lim of 128) — and the attribute, once raised, stays for
// the process: set it on every call, so that no launch depends on an
// earlier, larger one. Returns the cudaError_t.
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace xbar
