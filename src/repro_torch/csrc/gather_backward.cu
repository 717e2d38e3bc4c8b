// P4 on Hopper: the backward of the feature gather, summed in a fixed order.
//
// The port's own kernel; no pallas_call is replaced. The forward of
// models/pointnet2.py::gather_rows is torch.take_along_dim; the backward
// that autograd gives it is a scatter-add, whose order of summation on the
// card follows its atomics and changes from run to run, so training was not
// reproducible. The JAX package's jitted step (examples/train_pointnet.py)
// is. This kernel computes the same gradient in one order:
//   out[r, c] = (((0.0f + g[p_0, c]) + g[p_1, c]) + ...) + g[p_last, c],
// p_0 < p_1 < ... the positions whose flat key (batch row times the row
// count, plus the gathered row index) is r: the order the CPU's sequential
// scatter-add uses, so the card and the CPU give the same bits.
//
// The wrapper (kernels/gather_backward.py) sorts the keys with a stable
// sort (perm: positions ordered by key, within a key by position) and
// finds each key's segment [starts[r], starts[r + 1]) in the sorted keys
// (torch ops). Here one thread owns one (row, channel) output and walks its
// segment in order: consecutive threads take consecutive channels of one
// row, so each step's read g[perm[j], c..] is one coalesced row and perm[j]
// one broadcast load. No atomics; every output is written exactly once,
// rows no position gathered with 0.0f.
//
// What bounds it: the bytes, the upstream gradient (positions x C float32)
// read once, the permutation and the offsets, and the (rows x C) output
// written once; one addition per gradient element. At the training path's
// SA-2 (16 clouds, 2048 + 128 positions a cloud into 512 rows of 64
// floats) that is a few MB: microseconds, near the launch floor.
//
// Positions and offsets are clamped into range as a memory guard only: the
// wrapper never passes others.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_rows_backward_kernel(const float* __restrict__ grad,
                            const long long* __restrict__ perm,
                            const long long* __restrict__ starts,
                            float* __restrict__ out, long long rows, int c,
                            long long positions) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (e >= rows * c) return;
  const long long r = e / c;
  const int cc = static_cast<int>(e - r * c);
  const long long lo = min(max(starts[r], 0LL), positions);
  const long long hi = min(max(starts[r + 1], lo), positions);
  float acc = 0.0f;
  for (long long j = lo; j < hi; ++j) {
    const long long p = min(max(perm[j], 0LL), positions - 1);
    acc = __fadd_rn(acc, grad[p * c + cc]);
  }
  out[e] = acc;
}

}  // namespace

extern "C" {

// out (rows, c) float32, from grad (positions, c) float32, perm
// (positions,) int64 (the positions in key order, stably) and starts
// (rows + 1,) int64 (row r's segment of perm is [starts[r], starts[r+1])).
// All contiguous. Returns the cudaError_t of the launch (0 on success).
int gather_rows_backward(const void* grad, const void* perm,
                         const void* starts, void* out, int rows, int c,
                         int positions, void* stream) {
  if (rows < 1 || c < 1 || positions < 0 ||
      static_cast<long long>(rows) * c >= (1LL << 31) ||
      static_cast<long long>(positions) * c >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(rows) * c;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  gather_rows_backward_kernel<<<blocks, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grad), static_cast<const long long*>(perm),
      static_cast<const long long*>(starts), static_cast<float*>(out), rows,
      c, positions);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
