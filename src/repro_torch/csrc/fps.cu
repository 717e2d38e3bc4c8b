// K7 on Hopper: farthest point sampling.
//
// Replaces the TPU kernel src/repro/kernels/fps_update.py::_kernel (one
// relaxation step, d = min(d, |p - c|^2), over (3, N) points) and the
// fori_loop of src/repro/kernels/ops.py::fps that drives it once per
// sample, with an argmax over the relaxed distances between steps.
//
// Entry points:
// - fps_update runs fps_update_kernel, the Pallas step itself, elementwise
//   over N with a masked ragged edge (the TPU kernel pads N to 128).
//   Nothing on the main path launches it; it is the counterpart of
//   repro.kernels.fps_update.
// - fps_run runs the whole sampling loop in one launch, under a plan made
//   in Python (kernels/fps_update.py::plan_fps), in one of three tiers:
//   * block: one block per cloud (fps_loop_kernel<T, PER, false, CHAIN>);
//   * cluster: one cloud over a thread-block cluster of up to 16 blocks
//     (fps_loop_kernel<T, PER, true, CHAIN>);
//   * streamed: one cloud over a cluster, its points and running distances
//     in device memory, read from L2 every step (fps_stream_kernel).
// - fps_chain_run, a measurement only, runs fps_run's launch with the
//   relaxation left out (the kernels' CHAIN instantiations).
//
// What bounds the loop. The bytes (the points in, the indices out) and the
// 9 float operations per point and step are far below a microsecond at the
// main path's shapes. What bounds it is the chain of n_samples dependent
// reductions: each step needs the previous step's winner. The design cuts
// the cost of one link of that chain:
// - the points' coordinates and running distances stay in registers for the
//   whole loop (block and cluster tiers), loaded once: warp w of block r
//   holds the contiguous points [(r W + w) 32 PER, +32 PER), lane l the
//   points l + 32 j. So the order of the warps' slots is the order of the
//   points they hold;
// - a step's relaxation is 9 rounded float operations and one min.NaN a
//   point, its key two integer instructions (order_key), and a thread's
//   candidate the first largest key of its points, taken as a tree;
// - the argmax runs on order-preserving integer keys (order_key): a warp's
//   winner is __reduce_max_sync over the keys, then __reduce_min_sync over
//   the indices of the lanes that hold the maximum: two REDUX instructions;
// - each warp writes its candidate (key and the point's coordinates, so the
//   next center needs no lookup) into a slot of a double-buffered array
//   [2][S], S the warps of the block or cluster, in every block of the
//   cluster through distributed shared memory; then one barrier
//   (__syncthreads, or barrier.cluster arrive.release / wait.acquire), and
//   every warp reduces the slots itself: the key maximum, and the first
//   slot holding it by a ballot. Double buffering makes the one barrier
//   safe: a fast warp writes step s+1's buffer while a slow one still reads
//   step s's, and step s+2 rewrites it only after step s+1's barrier.
// On an H100 the reductions, the barrier and the center's broadcast still
// take about three quarters of a step at the main path's shapes, and a
// cluster barrier costs about three block barriers (chip_smoke.py's
// chain_us_per_step; PERF.md). So a cloud takes one block up to 8192
// points (the registers of 512 threads x 16 points), a cluster only past
// that, and a streamed cluster past 16 blocks' registers.
//
// Exactness. The indices must equal the plain torch loop's bit for bit:
// - the squared distance is (dx*dx + dy*dy) + dz*dz with every operation
//   rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn), so nvcc cannot
//   contract it into FMAs;
// - the minimum is torch.minimum's: NaN if either side is NaN;
// - the argmax is torch.argmax's: the largest value, NaN above every
//   number, and on ties the lowest index. Keys are equal exactly where the
//   floats are, and ties go to the lowest index inside a warp and to the
//   first slot between warps;
// - pad rows (index >= n_valid) start at -inf, real rows at +inf; rows a
//   tier holds beyond N are pad rows past the cloud's last index.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUpdateThreads = 256;
constexpr int kMaxCluster = 16;
// Threads of a streamed-tier block (kernels/fps_update.py's
// FPS_STREAM_THREADS).
constexpr int kStreamThreads = 1024;

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
  return ((dn < d) | (dn != dn)) ? dn : d;
}

// relax() in one instruction (FMNMX.NAN), for the loops' distances: the
// same result wherever neither operand is -0.0, and a loop's never is (it
// starts at +-inf and takes sums of squares, which are +0.0 at least).
__device__ __forceinline__ float relax_min(float d, float dn) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(d), "f"(dn));
  return r;
}

// A uint32 whose order is torch.argmax's order of the loops' distances:
// bits | 0x80000000 for numbers >= +0.0, ~bits for -inf (pad rows), and
// 0xFFFFFFFF, above +inf, for NaN. Two instructions, exact on every value
// a loop's distance takes: +-inf, numbers >= +0.0 (never -0.0, see
// relax_min) and the canonical NaN 0x7FFFFFFF, the only NaN the card's
// arithmetic returns, whatever NaN the points hold. Equal keys are equal
// distances, and the least key, ~bits(-inf) = 0x007FFFFF, is a pad row's.
__device__ __forceinline__ uint32_t order_key(float d) {
  const int32_t b = __float_as_int(d);
  return static_cast<uint32_t>(b ^ ((b >> 31) | INT32_MIN));
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

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A thread's candidate: the first of its points with the largest key,
// `rel` its index within the warp's range, and its coordinates.
struct Cand {
  uint32_t key, rel;
  float x, y, z;
};

// The first of a and b with the larger key (a holds the lower indices).
__device__ __forceinline__ Cand first_max(const Cand& a, const Cand& b) {
  const bool take = b.key > a.key;
  return {take ? b.key : a.key, take ? b.rel : a.rel, take ? b.x : a.x,
          take ? b.y : a.y, take ? b.z : a.z};
}

// The slots of a block, in dynamic shared memory: float4 {key bits, x, y,
// z} [2][S], then the candidates' indices in the cloud, int64 [2][S]. A
// warp's candidate goes to slot `pos` (its rank in the cluster) of the
// buffer at offset `off` (0 or S) in every block of the cluster.
struct Slots {
  float4* cand;
  long long* index;
  int n;  // S
};

__device__ __forceinline__ Slots slots_of(int n_slots) {
  extern __shared__ float4 smem[];
  return {smem, reinterpret_cast<long long*>(smem + 2 * n_slots), n_slots};
}

// One link of the chain, after each thread has its candidate c: the warp's
// winner into its slots (`cand`, `index`: this block's, or for lane r <
// cluster block r's, at buffer offset 0), the barrier, and the winner of
// the block or cluster out of the slots at offset `off`. Returns the
// winner's coordinates in c*; lane 0 of the writer warp stores its index
// at *out.
template <bool CLUSTER>
__device__ __forceinline__ void link(const Cand& c, long long warp_base,
                                     const Slots& sl, float4* cand,
                                     long long* index, int off, int lane,
                                     bool writer_warp, long long* out,
                                     float& cx, float& cy, float& cz) {
  // the warp's winner: the largest key, then the lowest index holding it;
  // rel = lane + 32 j, so the winner is lane wi & 31
  const uint32_t kmax = __reduce_max_sync(kFull, c.key);
  const uint32_t wi = __reduce_min_sync(kFull, c.key == kmax ? c.rel : kFull);
  if constexpr (!CLUSTER) {
    if (c.rel == wi) {
      cand[off] = make_float4(__uint_as_float(kmax), c.x, c.y, c.z);
      index[off] = warp_base + wi;
    }
    __syncthreads();
  } else {
    const int wl = static_cast<int>(wi & 31u);
    const float x = __shfl_sync(kFull, c.x, wl);
    const float y = __shfl_sync(kFull, c.y, wl);
    const float z = __shfl_sync(kFull, c.z, wl);
    if (cand != nullptr) {
      cand[off] = make_float4(__uint_as_float(kmax), x, y, z);
      index[off] = warp_base + wi;
    }
    __syncwarp();
    cluster_barrier();
  }
  // every warp: lane l takes the first best of slots [l g, l g + g), then
  // the largest key over the warp, and the first lane holding it
  const int g = CLUSTER ? (sl.n + 31) >> 5 : 1;  // a block has <= 32 warps
  const float4* row = sl.cand + off;
  uint32_t k = 0;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  int at = lane * g;
  for (int i = 0; i < g; ++i) {
    const int q = lane * g + i;
    if (q < sl.n) {
      const float4 w = row[q];
      const uint32_t kq = __float_as_uint(w.x);
      if (i == 0 || kq > k) {
        k = kq;
        v = w;
        at = q;
      }
    }
  }
  long long idx = 0;
  if (writer_warp && at < sl.n) idx = sl.index[off + at];
  const uint32_t kbest = __reduce_max_sync(kFull, k);
  const int fl = __ffs(__ballot_sync(kFull, k == kbest)) - 1;
  cx = __shfl_sync(kFull, v.y, fl);
  cy = __shfl_sync(kFull, v.z, fl);
  cz = __shfl_sync(kFull, v.w, fl);
  if (writer_warp) {
    idx = __shfl_sync(kFull, idx, fl);
    if (lane == 0) *out = idx;
  }
}

// Where a warp writes its candidate: its slot in this block (the block
// tier), or, for lane r < cluster, in block r of the cluster (null for the
// other lanes).
template <bool CLUSTER>
__device__ __forceinline__ void slot_targets(const Slots& sl, int pos,
                                             int lane, int cluster,
                                             float4*& cand,
                                             long long*& index) {
  cand = sl.cand + pos;
  index = sl.index + pos;
  if constexpr (CLUSTER) {
    if (lane < cluster) {
      cg::cluster_group cl = cg::this_cluster();
      cand = cl.map_shared_rank(cand, lane);
      index = cl.map_shared_rank(index, lane);
    } else {
      cand = nullptr;
      index = nullptr;
    }
  }
}

// The block and cluster tiers: PER points a thread, in registers. Rows
// past N hold the coordinates 0 and the distance -inf of a pad row: their
// keys never exceed a real row's (which starts at +inf, and is NaN when
// theirs is) and ties go to the lower index, so they are never chosen.
template <int T, int PER, bool CLUSTER, bool CHAIN>
__global__ void __launch_bounds__(T, 1)
fps_loop_kernel(const float* __restrict__ points,
                const long long* __restrict__ n_valid,
                long long* __restrict__ out, int n, int n_samples, int start,
                int cluster) {
  static_assert((PER & (PER - 1)) == 0, "PER is a power of two");
  constexpr int W = T / 32;
  const Slots sl = slots_of(W * cluster);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int rank = 0;
  if constexpr (CLUSTER)
    rank = static_cast<int>(cg::this_cluster().block_rank());
  const long long cloud = blockIdx.x / cluster;
  const float* pts = points + cloud * 3 * n;
  const long long nv = n_valid == nullptr ? n : n_valid[cloud];
  const int pos = rank * W + warp;
  const int base = pos * (32 * PER);

  float px[PER], py[PER], pz[PER], d[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int p = base + lane + 32 * j;
    px[j] = py[j] = pz[j] = 0.f;
    if (p < n) {
      px[j] = pts[3 * p];
      py[j] = pts[3 * p + 1];
      pz[j] = pts[3 * p + 2];
    }
    d[j] = p < nv ? INFINITY : -INFINITY;
  }
  float cx = pts[3 * start], cy = pts[3 * start + 1], cz = pts[3 * start + 2];
  long long* o = out + cloud * n_samples;
  const bool writer_warp = rank == 0 && warp == 0;
  if (writer_warp && lane == 0) o[0] = start;
  float4* cand;
  long long* index;
  slot_targets<CLUSTER>(sl, pos, lane, cluster, cand, index);
  // every block of the cluster runs before any is written to
  if constexpr (CLUSTER) cluster_barrier();

  int off = 0;
  for (int s = 1; s < n_samples; ++s) {
    Cand c[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if constexpr (!CHAIN)
        d[j] = relax_min(d[j], sq_dist(px[j], py[j], pz[j], cx, cy, cz));
      c[j] = {order_key(d[j]), static_cast<uint32_t>(lane + 32 * j), px[j],
              py[j], pz[j]};
    }
    // the thread's first largest key, as a tree over its points
#pragma unroll
    for (int w = 1; w < PER; w <<= 1)
#pragma unroll
      for (int j = 0; j + w < PER; j += 2 * w)
        c[j] = first_max(c[j], c[j + w]);
    link<CLUSTER>(c[0], base, sl, cand, index, off, lane, writer_warp, o + s,
                  cx, cy, cz);
    off = sl.n - off;
  }
  // no block leaves while another may still read the cluster's slots
  if constexpr (CLUSTER) cluster_barrier();
}

// The streamed tier: warp w of block r visits the points [(r W + w) L,
// +L) of its cloud, lane l the points l + 32 j, their coordinates read
// from `points` and their running distances from `dist` every step.
template <int T, bool CHAIN>
__global__ void __launch_bounds__(T, 1)
fps_stream_kernel(const float* __restrict__ points,
                  const long long* __restrict__ n_valid,
                  long long* __restrict__ out, float* __restrict__ dist,
                  long long n, int n_samples, long long start, int cluster,
                  int warp_len) {
  constexpr int W = T / 32;
  const Slots sl = slots_of(W * cluster);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const long long cloud = blockIdx.x / cluster;
  const float* pts = points + cloud * 3 * n;
  float* dc = dist + cloud * n;
  const long long nv = n_valid == nullptr ? n : n_valid[cloud];
  const int pos = rank * W + warp;
  const long long base = static_cast<long long>(pos) * warp_len;
  const int len = static_cast<int>(
      n - base < warp_len ? (n - base > 0 ? n - base : 0) : warp_len);

  for (int r = lane; r < len; r += 32)
    dc[base + r] = base + r < nv ? INFINITY : -INFINITY;
  float cx = pts[3 * start], cy = pts[3 * start + 1], cz = pts[3 * start + 2];
  long long* o = out + cloud * n_samples;
  const bool writer_warp = rank == 0 && warp == 0;
  if (writer_warp && lane == 0) o[0] = start;
  float4* cand;
  long long* index;
  slot_targets<true>(sl, pos, lane, cluster, cand, index);
  cluster_barrier();

  int off = 0;
  for (int s = 1; s < n_samples; ++s) {
    // a lane without points keeps key 0, below every real key
    Cand c = {0u, static_cast<uint32_t>(lane), 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int r = lane; r < len; r += 32) {
      const long long p = base + r;
      const float x = pts[3 * p], y = pts[3 * p + 1], z = pts[3 * p + 2];
      float dd = dc[p];
      if constexpr (!CHAIN) {
        dd = relax_min(dd, sq_dist(x, y, z, cx, cy, cz));
        dc[p] = dd;
      }
      c = first_max(c, {order_key(dd), static_cast<uint32_t>(r), x, y, z});
    }
    link<true>(c, base, sl, cand, index, off, lane, writer_warp, o + s, cx,
               cy, cz);
    off = sl.n - off;
  }
  cluster_barrier();
}

size_t slot_bytes(int threads, int cluster) {
  return 2 * static_cast<size_t>(threads / 32) * cluster *
         (sizeof(float4) + sizeof(long long));
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, long long blocks, int threads, int cluster,
                   bool as_cluster, cudaStream_t stream, Args... args) {
  if (as_cluster && cluster > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = slot_bytes(threads, cluster);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = as_cluster ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The (threads, points a thread) pairs of the register tiers, as
// kernels/fps_update.py::FPS_PER_THREAD lists them.
#define FPS_SHAPES(X)                                \
  X(128, 1) X(128, 2) X(128, 4) X(128, 8)            \
  X(256, 1) X(256, 2) X(256, 4) X(256, 8) X(256, 16) \
  X(512, 1) X(512, 2) X(512, 4) X(512, 8) X(512, 16)

template <bool CLUSTER, bool CHAIN>
cudaError_t launch_loop(int threads, int per, long long blocks, int cluster,
                        cudaStream_t stream, const float* p,
                        const long long* nv, long long* o, int n,
                        int n_samples, int start) {
#define FPS_CASE(T, P)                                                     \
  if (threads == T && per == P)                                            \
    return launch(fps_loop_kernel<T, P, CLUSTER, CHAIN>, blocks, T,        \
                  cluster, CLUSTER, stream, p, nv, o, n, n_samples, start, \
                  cluster);
  FPS_SHAPES(FPS_CASE)
#undef FPS_CASE
  return cudaErrorInvalidValue;
}

// The sampling loop under a plan: fps_run's contract; `chain` skips the
// relaxation (fps_chain_run).
cudaError_t run(const void* points, const void* n_valid, void* out,
                void* dist, long long batch, long long n, long long n_samples,
                long long start, int tier, int threads, int per, int cluster,
                bool chain, cudaStream_t s) {
  if (batch <= 0 || n <= 0 || n_samples <= 0 || n_samples > n ||
      n_samples > INT32_MAX || start < 0 || start >= n || cluster < 1 ||
      cluster > kMaxCluster || threads % 32 != 0 || threads <= 0 ||
      threads > 1024 || batch * cluster > INT32_MAX)
    return cudaErrorInvalidValue;
  const auto* p = static_cast<const float*>(points);
  const auto* nv = static_cast<const long long*>(n_valid);
  auto* o = static_cast<long long*>(out);
  const long long blocks = batch * cluster;
  const int ns = static_cast<int>(n_samples);
  if (tier == 0 || tier == 1) {
    if ((tier == 0) != (cluster == 1) ||
        static_cast<long long>(threads) * per * cluster < n)
      return cudaErrorInvalidValue;
    const int nn = static_cast<int>(n), st = static_cast<int>(start);
    if (tier == 0)
      return chain ? launch_loop<false, true>(threads, per, blocks, 1, s, p,
                                              nv, o, nn, ns, st)
                   : launch_loop<false, false>(threads, per, blocks, 1, s, p,
                                               nv, o, nn, ns, st);
    return chain ? launch_loop<true, true>(threads, per, blocks, cluster, s,
                                           p, nv, o, nn, ns, st)
                 : launch_loop<true, false>(threads, per, blocks, cluster, s,
                                            p, nv, o, nn, ns, st);
  }
  if (tier != 2) return cudaErrorInvalidValue;
  const long long warps = static_cast<long long>(threads / 32) * cluster;
  const long long warp_len = 32 * ((n + 32 * warps - 1) / (32 * warps));
  if (dist == nullptr || threads != kStreamThreads || warp_len > INT32_MAX)
    return cudaErrorInvalidValue;
  auto* dd = static_cast<float*>(dist);
  const int wl = static_cast<int>(warp_len);
  return chain ? launch(fps_stream_kernel<kStreamThreads, true>, blocks,
                        threads, cluster, true, s, p, nv, o, dd, n, ns, start,
                        cluster, wl)
               : launch(fps_stream_kernel<kStreamThreads, false>, blocks,
                        threads, cluster, true, s, p, nv, o, dd, n, ns, start,
                        cluster, wl);
}

}  // namespace

extern "C" {

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
// index `start`, each cloud's rows >= n_valid[b] (int64) masked; n_valid
// may be null (no pad rows). The plan: tier 0 block, 1 cluster (threads,
// per points a thread, cluster blocks a cloud), 2 streamed (threads,
// cluster; dist a float32 (batch, n) scratch). Returns the cudaError_t.
int fps_run(const void* points, const void* n_valid, void* out, void* dist,
            long long batch, long long n, long long n_samples,
            long long start, int tier, int threads, int per, int cluster,
            void* stream) {
  return static_cast<int>(run(points, n_valid, out, dist, batch, n,
                              n_samples, start, tier, threads, per, cluster,
                              false, static_cast<cudaStream_t>(stream)));
}

// A measurement, not part of the library's interface: fps_run's launch
// with the relaxation left out, so the running distances never change and
// a step is the chain of reductions, the barrier and the center's
// broadcast alone. Its indices mean nothing. chip_smoke.py binds it for
// chain_us_per_step.
int fps_chain_run(const void* points, void* out, void* dist, long long batch,
                  long long n, long long n_samples, int tier, int threads,
                  int per, int cluster, void* stream) {
  return static_cast<int>(run(points, nullptr, out, dist, batch, n,
                              n_samples, 0, tier, threads, per, cluster, true,
                              static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
