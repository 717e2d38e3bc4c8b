// K7 on Hopper: farthest point sampling.
//
// Replaces the TPU kernel src/repro/kernels/fps_update.py::_kernel (one
// relaxation step, d = min(d, |p - c|^2), over (3, N) points) and the
// fori_loop of src/repro/kernels/ops.py::fps that drives it once per
// sample, with an argmax over the relaxed distances between steps.
//
// Two entry points share the relaxation and the argmax:
// - fps_update_kernel is the Pallas step itself, elementwise over N with a
//   masked ragged edge (the TPU kernel pads N to 128). Nothing on the main
//   path launches it; it is the counterpart of repro.kernels.fps_update.
// - fps_loop_kernel runs the whole sampling loop in one launch, one block
//   per cloud. Each step relaxes the running distances against the current
//   center, takes a block-wide argmax (a thread-local scan, warp shuffles on
//   (value, index) pairs, then one warp over the per-warp winners in shared
//   memory), and thread 0 writes the winner's index: two __syncthreads a
//   step. The winner's coordinates are read by every thread from the
//   cloud's copy in shared memory.
//
// Layout. The running distances stay in registers for the whole loop:
// PER per thread, point p = tid + j * T for j < PER. The coordinates are
// copied once into dynamic shared memory as three planes x[N], y[N], z[N]
// (12 bytes a point). 256 threads take N <= 4096 (PER <= 16), 1024 threads
// take N <= 16384 (PER 8 or 16, at most 64 registers a thread); at
// N = 16384 the planes fill 192 KB of the 227 KB a block may have. Larger
// clouds are refused (fps_max_points(); the wrapper raises before).
//
// Exactness. The indices must equal the plain torch loop's bit for bit:
// - the squared distance is (dx*dx + dy*dy) + dz*dz with every operation
//   rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn), so nvcc cannot
//   contract it into FMAs;
// - the minimum is torch.minimum's: NaN if either side is NaN;
// - the argmax is torch.argmax's: the largest value, NaN above all, and on
//   ties the lowest index, in every comparison of the reduction;
// - pad rows (index >= n_valid) start at -inf and stay there; real rows
//   start at +inf.
//
// Bound on the H100. The bytes (B*N*12 in, B*n_samples*8 out) and the 9
// float operations per point and step are far below a microsecond at the
// main path's shapes. What bounds the loop is its chain of n_samples
// dependent block-wide reductions: each step waits for the previous
// step's winner. At batch 8 only 8 SMs work; splitting a cloud over a
// thread-block cluster is later work.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

// Points a thread holds at most, and the largest cloud a block takes.
constexpr int kMaxPerThread = 16;
constexpr int kMaxPoints = 1024 * kMaxPerThread;
constexpr int kUpdateThreads = 256;

__device__ __forceinline__ float sq_dist(float px, float py, float pz,
                                         float cx, float cy, float cz) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  const float dz = __fsub_rn(pz, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// torch.minimum(d, dn): NaN when either is NaN, else the smaller.
__device__ __forceinline__ float relax(float d, float dn) {
  return (dn < d || isnan(dn)) ? dn : d;
}

// (v, i) comes before (best, best_i) in torch.argmax's order: the larger
// value, NaN above every number, and the lower index on ties.
__device__ __forceinline__ bool beats(float v, int i, float best,
                                      int best_i) {
  const bool v_nan = isnan(v), best_nan = isnan(best);
  if (v_nan || best_nan) return v_nan && (!best_nan || i < best_i);
  return v > best || (v == best && i < best_i);
}

// Butterfly argmax over a warp; every lane ends with the winner.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kUpdateThreads)
fps_update_kernel(const float* __restrict__ points_t,
                  const float* __restrict__ centroid,
                  const float* __restrict__ dist, float* __restrict__ out,
                  int n) {
  const int p = blockIdx.x * kUpdateThreads + threadIdx.x;
  if (p >= n) return;
  out[p] = relax(dist[p], sq_dist(points_t[p], points_t[n + p],
                                  points_t[2 * n + p], centroid[0],
                                  centroid[1], centroid[2]));
}

template <int T, int PER>
__global__ void __launch_bounds__(T)
fps_loop_kernel(const float* __restrict__ points,
                const int* __restrict__ n_valid, int64_t* __restrict__ out,
                int n, int n_samples, int start) {
  extern __shared__ float coords[];  // x[n], y[n], z[n]
  __shared__ float warp_v[T / 32];
  __shared__ int warp_i[T / 32];
  __shared__ int chosen;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* cloud = points + static_cast<size_t>(blockIdx.x) * n * 3;
  for (int e = tid; e < 3 * n; e += T) coords[(e % 3) * n + e / 3] = cloud[e];
  const float* xs = coords;
  const float* ys = coords + n;
  const float* zs = coords + 2 * n;

  const int nv = n_valid == nullptr ? n : n_valid[blockIdx.x];
  float d[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) d[j] = tid + j * T < nv ? INFINITY : -INFINITY;
  int64_t* idx = out + static_cast<size_t>(blockIdx.x) * n_samples;
  int cur = start;
  __syncthreads();

  for (int s = 0;; ++s) {
    if (tid == 0) idx[s] = cur;
    if (s + 1 == n_samples) break;
    const float cx = xs[cur], cy = ys[cur], cz = zs[cur];
    float best = -INFINITY;
    int best_i = INT_MAX;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int p = tid + j * T;
      if (p < n) {
        d[j] = relax(d[j], sq_dist(xs[p], ys[p], zs[p], cx, cy, cz));
        if (beats(d[j], p, best, best_i)) {
          best = d[j];
          best_i = p;
        }
      }
    }
    warp_argmax(best, best_i);
    if (lane == 0) {
      warp_v[warp] = best;
      warp_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < T / 32 ? warp_v[lane] : -INFINITY;
      best_i = lane < T / 32 ? warp_i[lane] : INT_MAX;
      warp_argmax(best, best_i);
      if (lane == 0) chosen = best_i;
    }
    __syncthreads();
    cur = chosen;
  }
}

template <int T, int PER>
cudaError_t launch_loop(const float* points, const int* n_valid,
                        int64_t* out, int batch, int n, int n_samples,
                        int start, cudaStream_t stream) {
  const size_t smem = 3 * static_cast<size_t>(n) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_loop_kernel<T, PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fps_loop_kernel<T, PER><<<batch, T, smem, stream>>>(points, n_valid, out, n,
                                                      n_samples, start);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest cloud fps_loop takes.
int fps_max_points() { return kMaxPoints; }

// out (1, n) = min(dist (1, n), |points_t (3, n) - centroid (3, 1)|^2).
// Returns the cudaError_t of the launch (0 on success).
int fps_update(const void* points_t, const void* centroid, const void* dist,
               void* out, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kUpdateThreads - 1) / kUpdateThreads;
  fps_update_kernel<<<blocks, kUpdateThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points_t),
      static_cast<const float*>(centroid), static_cast<const float*>(dist),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// out (batch, n_samples) int64: FPS over points (batch, n, 3) float32 from
// index `start`, each cloud's rows >= n_valid[b] masked (n_valid may be
// null: no pad rows). One block per cloud. Returns the cudaError_t.
int fps_loop(const void* points, const void* n_valid, void* out, int batch,
             int n, int n_samples, int start, void* stream) {
  if (batch <= 0 || n <= 0 || n > kMaxPoints || n_samples <= 0 ||
      n_samples > n || start < 0 || start >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const float*>(points);
  const auto* nv = static_cast<const int*>(n_valid);
  auto* o = static_cast<int64_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n <= 256)
    err = launch_loop<256, 1>(p, nv, o, batch, n, n_samples, start, s);
  else if (n <= 512)
    err = launch_loop<256, 2>(p, nv, o, batch, n, n_samples, start, s);
  else if (n <= 1024)
    err = launch_loop<256, 4>(p, nv, o, batch, n, n_samples, start, s);
  else if (n <= 2048)
    err = launch_loop<256, 8>(p, nv, o, batch, n, n_samples, start, s);
  else if (n <= 4096)
    err = launch_loop<256, 16>(p, nv, o, batch, n, n_samples, start, s);
  else if (n <= 8192)
    err = launch_loop<1024, 8>(p, nv, o, batch, n, n_samples, start, s);
  else
    err = launch_loop<1024, 16>(p, nv, o, batch, n, n_samples, start, s);
  return static_cast<int>(err);
}

}  // extern "C"
