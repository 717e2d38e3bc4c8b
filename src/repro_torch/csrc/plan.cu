// P1 and P2 on Hopper: the execution plan's greedy order and coordination
// walk (paper Algorithm 1), built on the card.
//
// Replace the jnp/lax loops of src/repro/core/schedule.py that build a
// plan inside a trace (no pallas_call there):
// - P1, plan_greedy: device_order_greedy, a fori_loop of n masked argmins
//   over rows of the precomputed n x n squared-distance matrix;
// - P2, plan_coordinate: device_coordinate, a recursive lax.scan/lax.cond
//   walk of the receptive fields, and _device_complete/_device_inverse.
//
// P1 design. The loop is n - 1 dependent argmins, the shape of K7's FPS
// loop (fps.cu), so it takes K7's design: one block per cloud, its points
// in registers (thread t holds the points t + T j), one barrier a step.
// Row `cur` of the distance matrix is computed in the step it is needed,
// as ((x - x_c)^2 + (y - y_c)^2) + (z - z_c)^2 with every operation
// rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn: no FMA), the same
// float32 values as the reference's matrix; the matrix is never built.
// The argmin runs on integer keys: a removed point's key is that of +inf,
// a NaN distance's key 0 (np.argmin and jnp.argmin return the first NaN),
// any other distance (>= +0.0) its bits + 1. A warp's winner is the least
// key, then the least index holding it (two REDUX); warps post theirs to a
// double-buffered slot array, and after the one barrier every warp reduces
// the slots itself (two more REDUX), so ties go to the first index as in
// the reference. Bound: the chain of n - 1 reductions, not the bytes (the
// points in, the order out) nor the 8 float operations a point and step.
//
// P2 design. The recursion is not carried over: a serial walk whose every
// step is a branch would leave the card idle. The walk splits into one
// pass per layer, from the last down. Layer L's partial order is the
// first-occurrence order of the last-layer order; layer k-1's is the
// first-occurrence order of the stream neighbors_k[o_k[s / K]][s % K],
// o_k layer k's partial order (a point runs at its first visit; a visited
// point, or one met again in its own row, is skipped and never walks its
// members again); the orphans follow in ascending order. One block per
// cloud runs every layer: an atomicMin over stream positions gives each
// point its first position (shared memory), a block scan over the stream
// compacts the first occurrences into the order, a second scan over the
// points places the orphans, and a last pass writes the inverse. Bound:
// the stream (128 x 16 entries a cloud at the main path) read three times
// from L1/L2 and a few barriers; microseconds.
//
// Indices are clamped into range as a memory guard only: the model never
// passes others.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGreedyThreads = 256;
constexpr int kCoordThreads = 1024;
constexpr int kMaxLayers = 8;
constexpr uint32_t kNone = 0xffffffffu;
// The argmin key of +inf: a removed point's, above every finite distance.
constexpr uint32_t kKeyInf = 0x7f800001u;

__device__ __forceinline__ float sq_dist(float px, float py, float pz,
                                         float cx, float cy, float cz) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  const float dz = __fsub_rn(pz, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// np.argmin's order of a squared distance (+0.0 <= d <= +inf, or NaN):
// NaN first, then the numbers ascending.
__device__ __forceinline__ uint32_t min_key(float d) {
  return d != d ? 0u : __float_as_uint(d) + 1u;
}

// P1: one block per cloud, PER points a thread. Shared memory: the cloud's
// points as float4 (the next center's coordinates), then the slots
// uint2 {key, index} [2][32].
template <int PER>
__global__ void __launch_bounds__(kGreedyThreads)
greedy_kernel(const float* __restrict__ points, int* __restrict__ order,
              int n, int start) {
  extern __shared__ float4 smem_greedy[];
  float4* pts = smem_greedy;
  uint2* slots = reinterpret_cast<uint2*>(pts + n);
  const int T = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = T >> 5;
  const long long cloud = blockIdx.x;
  const float* pc = points + cloud * 3 * n;
  int* oc = order + cloud * n;

  float px[PER], py[PER], pz[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int p = tid + T * j;
    px[j] = py[j] = pz[j] = 0.f;
    if (p < n) {
      px[j] = pc[3 * p];
      py[j] = pc[3 * p + 1];
      pz[j] = pc[3 * p + 2];
      pts[p] = make_float4(px[j], py[j], pz[j], 0.f);
    }
  }
  // bit j: this thread's point tid + T j is scheduled
  uint32_t removed = start % T == tid ? 1u << (start / T) : 0u;
  if (tid == 0) oc[0] = start;
  __syncthreads();
  float4 c = pts[start];
  int buf = 0;
  for (int i = 1; i < n; ++i) {
    uint32_t bk = kNone, bi = kNone;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int p = tid + T * j;
      if (p < n) {
        const uint32_t key =
            (removed >> j) & 1u
                ? kKeyInf
                : min_key(sq_dist(px[j], py[j], pz[j], c.x, c.y, c.z));
        if (key < bk) {                 // p grows with j: the first minimum
          bk = key;
          bi = static_cast<uint32_t>(p);
        }
      }
    }
    const uint32_t wk = __reduce_min_sync(kFull, bk);
    const uint32_t wi = __reduce_min_sync(kFull, bk == wk ? bi : kNone);
    if (lane == 0) slots[buf * 32 + warp] = make_uint2(wk, wi);
    __syncthreads();
    const uint2 s = lane < n_warps ? slots[buf * 32 + lane]
                                   : make_uint2(kNone, kNone);
    const uint32_t gk = __reduce_min_sync(kFull, s.x);
    const int cur =
        static_cast<int>(__reduce_min_sync(kFull, s.x == gk ? s.y : kNone));
    if (tid == 0) oc[i] = cur;
    if (cur % T == tid) removed |= 1u << (cur / T);
    c = pts[cur];
    buf ^= 1;
  }
}

// The layers P2 walks: per layer (index l for layer l + 1) its receptive
// fields into the layer below (int64, row stride nbr_rs, cloud stride
// nbr_bs, unit stride along K), its point count, K, and its outputs (int32
// (batch, n)).
struct Layers {
  const long long* nbr[kMaxLayers];
  int* order[kMaxLayers];
  int* inv[kMaxLayers];
  long long nbr_bs[kMaxLayers];
  long long nbr_rs[kMaxLayers];
  int n[kMaxLayers];
  int k[kMaxLayers];
};

// The stream one level walks: the last-layer order itself, or the rows of
// the upper layer's receptive fields in its partial order.
struct Stream {
  const int* last;
  const long long* nbr;
  const int* up;
  long long rs;
  int k, n_target;

  __device__ __forceinline__ int at(int s) const {
    const long long v =
        last != nullptr ? last[s]
                        : nbr[static_cast<long long>(up[s / k]) * rs + s % k];
    return static_cast<int>(min(max(v, 0LL),
                                static_cast<long long>(n_target - 1)));
  }
};

// Exclusive scan of v over the block; *total gets the sum. `sums` holds 32
// ints of shared memory; every thread of the block must call it.
__device__ int block_scan(int v, int* sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int n_warps = kCoordThreads / 32;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    sums[lane] = w;
  }
  __syncthreads();
  const int base = warp > 0 ? sums[warp - 1] : 0;
  *total = sums[n_warps - 1];
  __syncthreads();                       // sums is rewritten by the next scan
  return base + x - v;
}

// One level: the completed order of the n points of the target layer by
// their first position in the stream of length S, and its inverse.
// Returns the walk's partial length (points that occur).
__device__ int walk_level(const Stream& st, int S, int n, int* first,
                          int* sums, int* order, int* inv) {
  const int tid = threadIdx.x;
  for (int p = tid; p < n; p += kCoordThreads) first[p] = INT_MAX;
  __syncthreads();
  for (int s = tid; s < S; s += kCoordThreads) atomicMin(&first[st.at(s)], s);
  __syncthreads();
  // the first occurrences, in stream order: thread t scans [s0, s1)
  const int cs = (S + kCoordThreads - 1) / kCoordThreads;
  const int s0 = min(tid * cs, S), s1 = min(s0 + cs, S);
  int cnt = 0;
  for (int s = s0; s < s1; ++s) cnt += first[st.at(s)] == s;
  int walked;
  int at = block_scan(cnt, sums, &walked);
  for (int s = s0; s < s1; ++s) {
    const int p = st.at(s);
    if (first[p] == s) order[at++] = p;
  }
  // the orphans, ascending, after them
  const int cp = (n + kCoordThreads - 1) / kCoordThreads;
  const int p0 = min(tid * cp, n), p1 = min(p0 + cp, n);
  int orphans = 0;
  for (int p = p0; p < p1; ++p) orphans += first[p] == INT_MAX;
  int unused;
  at = walked + block_scan(orphans, sums, &unused);
  for (int p = p0; p < p1; ++p)
    if (first[p] == INT_MAX) order[at++] = p;
  __syncthreads();                       // the order, visible to the block
  for (int r = tid; r < n; r += kCoordThreads) inv[order[r]] = r;
  return walked;
}

// P2: one block per cloud walks every layer, the last first. Shared
// memory: 32 ints of scan sums, then one int a point of the widest layer.
__global__ void __launch_bounds__(kCoordThreads)
coordinate_kernel(const int* __restrict__ last, Layers ly, int layers) {
  extern __shared__ int smem_coord[];
  int* sums = smem_coord;
  int* first = smem_coord + 32;
  const long long b = blockIdx.x;
  const int top = layers - 1;
  const int n_top = ly.n[top];
  const Stream st = {last + b * n_top, nullptr, nullptr, 0, 1, n_top};
  int walked = walk_level(st, n_top, n_top, first, sums,
                          ly.order[top] + b * n_top, ly.inv[top] + b * n_top);
  for (int l = top; l >= 1; --l) {       // layer l + 1 walks into layer l
    const int n = ly.n[l - 1];
    const Stream down = {nullptr, ly.nbr[l] + b * ly.nbr_bs[l],
                         ly.order[l] + b * ly.n[l], ly.nbr_rs[l], ly.k[l], n};
    walked = walk_level(down, walked * ly.k[l], n, first, sums,
                        ly.order[l - 1] + b * n, ly.inv[l - 1] + b * n);
  }
}

}  // namespace

extern "C" {

// P1: order (batch, n) int32, the greedy chain of each cloud of points
// (batch, n, 3) float32 from index `start`; `threads` a block (a multiple
// of 32, at most 256), `per` points a thread (1, 2, 4 or 8; threads * per
// >= n). Returns the cudaError_t of the launch (0 on success).
int plan_greedy(const void* points, void* order, int batch, int n, int start,
                int threads, int per, void* stream) {
  if (batch < 1 || n < 1 || n > kGreedyThreads * 8 || start < 0 ||
      start >= n || threads < 32 || threads > kGreedyThreads ||
      threads % 32 != 0 || threads * per < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(n) * sizeof(float4) +
                      2 * 32 * sizeof(uint2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float*>(points);
  auto* o = static_cast<int*>(order);
  switch (per) {
    case 1: greedy_kernel<1><<<batch, threads, smem, st>>>(p, o, n, start);
      break;
    case 2: greedy_kernel<2><<<batch, threads, smem, st>>>(p, o, n, start);
      break;
    case 4: greedy_kernel<4><<<batch, threads, smem, st>>>(p, o, n, start);
      break;
    case 8: greedy_kernel<8><<<batch, threads, smem, st>>>(p, o, n, start);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// P2: for each of `layers` layers l (layer l + 1), order[l] and inv[l]
// (batch, n_l) int32, the completed coordinated order and its inverse,
// from `last` (batch, n_top) int32 and the receptive fields nbr[l] (int64;
// layer 1's is never read). dims holds 4 x layers int64: the point counts,
// K, and the neighbor tensors' cloud and row strides. Returns the
// cudaError_t of the launch.
int plan_coordinate(const void* last, const void* const* nbr,
                    void* const* order, void* const* inv,
                    const long long* dims, int batch, int layers,
                    void* stream) {
  if (batch < 1 || layers < 1 || layers > kMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  Layers ly = {};
  int widest = 0;
  for (int l = 0; l < layers; ++l) {
    ly.nbr[l] = static_cast<const long long*>(nbr[l]);
    ly.order[l] = static_cast<int*>(order[l]);
    ly.inv[l] = static_cast<int*>(inv[l]);
    if (dims[l] < 1 || dims[l] > INT_MAX || dims[layers + l] < 1 ||
        dims[l] * dims[layers + l] > INT_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    ly.n[l] = static_cast<int>(dims[l]);
    ly.k[l] = static_cast<int>(dims[layers + l]);
    ly.nbr_bs[l] = dims[2 * layers + l];
    ly.nbr_rs[l] = dims[3 * layers + l];
    widest = ly.n[l] > widest ? ly.n[l] : widest;
  }
  const size_t smem = (32 + static_cast<size_t>(widest)) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        coordinate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  coordinate_kernel<<<batch, kCoordThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(last), ly, layers);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
