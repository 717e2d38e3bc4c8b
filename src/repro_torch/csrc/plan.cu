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
// P1 design. The loop is n - 1 dependent argmins, so what bounds it is the
// chain of reductions, not the bytes (the points in, the order out) nor
// the 8 float operations a point and step. Row `cur` of the distance
// matrix is computed in the step it is needed, as ((x - x_c)^2 + (y -
// y_c)^2) + (z - z_c)^2 with every operation rounded on its own (__fsub_rn,
// __fmul_rn, __fadd_rn: no FMA), the same float32 values as the
// reference's matrix; the matrix is never built. The argmin runs on
// integer keys: a removed point's key is that of +inf, a NaN distance's key
// 0 (np.argmin and jnp.argmin return the first NaN), any other distance
// (>= +0.0) its bits + 1. A thread's candidate is the first least key of
// its points, taken as a tree; a warp's winner the least key, then the
// least index holding it (two REDUX). Ties go to the first index, as in
// the reference. Two shapes of the chain:
// - up to 256 points (the main path's 128, the forward's 1 x 128) one warp
//   runs a cloud, lane l holding the points l + 32 j in registers: a step
//   is the distances, the thread's tree, the two REDUX and one broadcast
//   shared load of the next center. No barrier, no slot array, no second
//   round of reductions (greedy_kernel_warp);
// - past that, up to 2048 points, one block of up to 256 threads (thread t
//   holds the points t + T j): warps post their winners to a
//   double-buffered slot array, and after one barrier every warp reduces
//   the slots itself (two more REDUX) (greedy_kernel).
// plan_greedy_chain, a measurement only, runs the one-warp chain with the
// distance arithmetic left out: the floor that design works against
// (chip_smoke.py's chain_us_per_step).
//
// P2 design. The recursion is not carried over: a serial walk whose every
// step is a branch would leave the card idle. The walk splits into one
// level per layer, from the last down. Layer L's partial order is the
// first-occurrence order of the last-layer order; layer k-1's is the
// first-occurrence order of the stream neighbors_k[o_k[s / K]][s % K],
// o_k layer k's partial order (a point runs at its first visit; a visited
// point, or one met again in its own row, is skipped and never walks its
// members again); the orphans follow in ascending order. One block per
// cloud runs every level, all of it in shared memory:
// - every receptive field the walk reads is loaded once, at the start, in
//   index order, as int32 (the loads do not depend on any order, so they
//   are all in flight together; the top layer's first 4 per thread are
//   held in registers over the top level and stored after it);
// - a level's first positions come by an atomicMin over the stream, whose
//   entries are two shared loads (the upper level's order, then the
//   field; the row and column stepped without a division): no pass reads
//   device memory;
// - each point that occurs then marks its first position in a stream-long
//   array, and __syncthreads_count counts them (the walk's length). At the
//   top level, where the last order names each point once (P1's order
//   does; the atomicMin finds a repeat, __syncthreads_or tells the block),
//   the last order is the level's order and this and the next step are
//   skipped;
// - the order is one compaction of the range [0, S + n): position s < S
//   is flagged where it is marked, position S + p where p never occurs.
//   Each warp owns a contiguous span, counts its flags by ballots and
//   popcounts, posts the count, and after one barrier places its points
//   (one cross-warp scan by a REDUX add). A position is one conflict-free
//   shared load. The orphans land after the walk by construction; each
//   point's inverse is placed with it, in shared memory too;
// - each level's order stays in shared memory for the next one (double
//   buffered, as are the first positions, which are reset for the next
//   level while this one runs), and goes out to device memory with its
//   inverse in coalesced stores while the next level starts: four
//   barriers a level (two at a top level without repeats), 512 threads.
// A walk whose arrays do not fit in shared memory runs the same code with
// a part of them in a device-memory workspace the caller hands in, one a
// cloud: shared memory keeps the longest prefix of the levels' arrays, the
// marks and the fields that fits, so past about 50K field entries the
// fields go first, then the marks, then past about 11K points a layer the
// levels' too. Slower; any size.
// Bound: the receptive fields and the outputs (bytes), a few microseconds
// of barriers and one round trip to device memory.
//
// Indices are clamped into range as a memory guard only: the model never
// passes others.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGreedyThreads = 256;
constexpr int kCoordThreads = 512;
constexpr int kCoordWarps = kCoordThreads / 32;
constexpr int kCoordPrefetch = 4;       // top-layer fields a thread holds
constexpr int kMaxLayers = 8;
constexpr int kMaxSmem = 232448;        // bytes a block may have
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

// A thread's candidate over its PER points (p = base + stride j): the
// least key, then the first point holding it, as a tree (a point is
// replaced only by a later one with a strictly smaller key). Removed
// points (bit j of `removed`) key as +inf; every key is computed and then
// selected, with no branch. CHAIN keys a point by its x bits against the
// center's, no distance arithmetic.
template <int PER, bool CHAIN>
__device__ __forceinline__ void candidate(const float* px, const float* py,
                                          const float* pz, float4 c,
                                          uint32_t removed, int base,
                                          int stride, uint32_t& bk,
                                          uint32_t& bi) {
  uint32_t k[PER], id[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const uint32_t key =
        CHAIN ? (__float_as_uint(px[j]) ^ __float_as_uint(c.x)) >> 1
              : min_key(sq_dist(px[j], py[j], pz[j], c.x, c.y, c.z));
    k[j] = (removed >> j) & 1u ? kKeyInf : key;
    id[j] = static_cast<uint32_t>(base + stride * j);
  }
#pragma unroll
  for (int w = 1; w < PER; w <<= 1) {
#pragma unroll
    for (int j = 0; j + w < PER; j += 2 * w) {
      const bool later = k[j + w] < k[j];
      k[j] = later ? k[j + w] : k[j];
      id[j] = later ? id[j + w] : id[j];
    }
  }
  bk = k[0];
  bi = id[0];
}

// The cloud's points into registers (p = base + stride j) and into
// shared memory as float4 (the next center's coordinates). Returns the
// bits j of the slots past n: they count as removed from the start. A
// removed point keys as +inf, as a point at +inf does, and every point of
// the cloud has a lower index, so a slot past n never wins.
template <int PER>
__device__ __forceinline__ uint32_t load_points(const float* pc, float4* pts,
                                                int base, int stride, int n,
                                                float* px, float* py,
                                                float* pz) {
  uint32_t past = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int p = base + stride * j;
    px[j] = py[j] = pz[j] = 0.f;
    if (p < n) {
      px[j] = pc[3 * p];
      py[j] = pc[3 * p + 1];
      pz[j] = pc[3 * p + 2];
      pts[p] = make_float4(px[j], py[j], pz[j], 0.f);
    } else {
      past |= 1u << j;
    }
  }
  return past;
}

// P1, one warp per cloud (n <= 32 PER): lane l holds the points l + 32 j.
// Shared memory: the cloud's points as float4.
template <int PER, bool CHAIN>
__global__ void __launch_bounds__(32)
greedy_kernel_warp(const float* __restrict__ points, int* __restrict__ order,
                   int n, int start) {
  extern __shared__ float4 smem_greedy[];
  float4* pts = smem_greedy;
  const int lane = threadIdx.x;
  const long long cloud = blockIdx.x;
  const float* pc = points + cloud * 3 * n;
  int* oc = order + cloud * n;

  float px[PER], py[PER], pz[PER];
  // bit j: this lane's point lane + 32 j is scheduled (or past n)
  uint32_t removed = load_points<PER>(pc, pts, lane, 32, n, px, py, pz);
  if ((start & 31) == lane) removed |= 1u << (start >> 5);
  if (lane == 0) oc[0] = start;
  __syncwarp();
  float4 c = pts[start];
  for (int i = 1; i < n; ++i) {
    uint32_t bk, bi;
    candidate<PER, CHAIN>(px, py, pz, c, removed, lane, 32, bk, bi);
    const uint32_t wk = __reduce_min_sync(kFull, bk);
    const int cur =
        static_cast<int>(__reduce_min_sync(kFull, bk == wk ? bi : kNone));
    if (lane == 0) oc[i] = cur;
    if ((cur & 31) == lane) removed |= 1u << (cur >> 5);
    c = pts[cur];
  }
}

// P1, one block per cloud, PER points a thread (thread t holds the points
// t + T j). Shared memory: the cloud's points as float4, then the slots
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
  // bit j: this thread's point tid + T j is scheduled (or past n)
  uint32_t removed = load_points<PER>(pc, pts, tid, T, n, px, py, pz);
  if (start % T == tid) removed |= 1u << (start / T);
  if (tid == 0) oc[0] = start;
  __syncthreads();
  float4 c = pts[start];
  int buf = 0;
  for (int i = 1; i < n; ++i) {
    uint32_t bk, bi;
    candidate<PER, false>(px, py, pz, c, removed, tid, T, bk, bi);
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

template <bool CHAIN>
int launch_greedy(const void* points, void* order, int batch, int n,
                  int start, int threads, int per, void* stream) {
  if (batch < 1 || n < 1 || n > kGreedyThreads * 8 || start < 0 ||
      start >= n || threads < 32 || threads > kGreedyThreads ||
      threads % 32 != 0 || threads * per < n || (CHAIN && threads != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float*>(points);
  auto* o = static_cast<int*>(order);
  const size_t pts = static_cast<size_t>(n) * sizeof(float4);
  if (threads == 32) {
    switch (per) {
      case 1: greedy_kernel_warp<1, CHAIN><<<batch, 32, pts, st>>>(p, o, n,
                                                                  start);
        break;
      case 2: greedy_kernel_warp<2, CHAIN><<<batch, 32, pts, st>>>(p, o, n,
                                                                  start);
        break;
      case 4: greedy_kernel_warp<4, CHAIN><<<batch, 32, pts, st>>>(p, o, n,
                                                                  start);
        break;
      case 8: greedy_kernel_warp<8, CHAIN><<<batch, 32, pts, st>>>(p, o, n,
                                                                  start);
        break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (!CHAIN) {
    const size_t smem = pts + 2 * 32 * sizeof(uint2);
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
  }
  return static_cast<int>(cudaGetLastError());
}

// The layers P2 walks: per layer (index l for layer l + 1) its receptive
// fields into the layer below (int64, cloud stride nbr_bs, row stride
// nbr_rs, unit stride along K), its point count and K; where its order
// and inverse start in the output (`at`; the inverses `inv` further on);
// and where its fields start in the walk's span (`field`, ints; layer
// 1's are never read).
struct Layers {
  const long long* nbr[kMaxLayers];
  long long nbr_bs[kMaxLayers];
  long long nbr_rs[kMaxLayers];
  long long at[kMaxLayers];
  long long inv;
  int n[kMaxLayers];
  int k[kMaxLayers];
  int field[kMaxLayers];
};

__device__ __forceinline__ int clamp_index(long long v, int n) {
  return static_cast<int>(min(max(v, 0LL), static_cast<long long>(n - 1)));
}

// One level's order, from its first positions `fst` and `mark` (mark[s]
// the point whose first position is s, else -1): the range [0, S + n)
// compacted in position order, s < S flagged where mark[s] holds a point,
// S + p where p never occurs. Warp w takes its own span (a multiple of 32
// positions), counts its flags by ballots, posts the count; after one
// barrier each warp places its points at the counts before it (a REDUX
// add) plus the flags before each: the order into ord, each point's place
// into inv (both shared). Every position is one conflict-free shared load.
__device__ void compact_level(const int* mark, int S, int n, const int* fst,
                              int* sums, int* ord, int* inv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int range = S + n;
  const int span =
      (range + 32 * kCoordWarps - 1) / (32 * kCoordWarps) * 32;
  const int c0 = min(warp * span, range), c1 = min(c0 + span, range);
  const int iters = (c1 - c0 + 31) >> 5;
  int count = 0;
#pragma unroll 4
  for (int it = 0; it < iters; ++it) {
    const int s = c0 + 32 * it + lane;
    const bool f = s < c1 && (s < S ? mark[s] >= 0 : fst[s - S] == INT_MAX);
    count += __popc(__ballot_sync(kFull, f));
  }
  if (lane == 0) sums[warp] = count;
  __syncthreads();
  int at = __reduce_add_sync(kFull, lane < warp ? sums[lane] : 0);
  const unsigned before = (1u << lane) - 1u;
#pragma unroll 4
  for (int it = 0; it < iters; ++it) {
    const int s = c0 + 32 * it + lane;
    int p = -1;
    if (s < c1) p = s < S ? mark[s] : (fst[s - S] == INT_MAX ? s - S : -1);
    const unsigned ballot = __ballot_sync(kFull, p >= 0);
    if (p >= 0) {
      const int r = at + __popc(ballot & before);
      ord[r] = p;
      inv[p] = r;
    }
    at += __popc(ballot);
  }
}

// The top layer's fields held in registers, into shared memory.
__device__ __forceinline__ void store_prefetch(const long long* pre,
                                               int n_pre, int* f,
                                               int below) {
#pragma unroll
  for (int m = 0; m < kCoordPrefetch; ++m) {
    const int e = threadIdx.x + m * kCoordThreads;
    if (e < n_pre) f[e] = clamp_index(pre[m], below);
  }
}

// A level's order and inverse out of shared memory, coalesced.
__device__ __forceinline__ void write_level(const int* ord, const int* inv,
                                            int n, int* og, int* ig) {
  for (int i = threadIdx.x; i < n; i += kCoordThreads) {
    og[i] = ord[i];
    ig[i] = inv[i];
  }
}

// P2: one block per cloud walks every layer, the last first. Shared
// memory (ints): the scan's counts [32], then the walk's three parts: the
// levels' arrays (the first positions [2][widest], the orders
// [2][widest], the inverse [widest]), the marks [longest stream], and the
// receptive fields of layers L..2 as int32. The first IN_SHARED parts lie
// there, the others in the cloud's workspace, work + span x cloud.
//
// A level walks the stream s = r K + j, r < walked, of the field at row
// up[r] (the upper level's order), column j; at the top level (K = 1) the
// last order itself. Each level: (A) the first positions by an atomicMin
// over the stream, the marks reset, the level above written out; (B) each
// point that occurs marks its first position, counted by
// __syncthreads_count (the walk's length); (C) compact_level. Four
// barriers a level; at the top level, when no point repeats, (B) and (C)
// give way to the last order itself.
template <int IN_SHARED>
__global__ void __launch_bounds__(kCoordThreads)
coordinate_kernel(const int* __restrict__ last, int* __restrict__ out,
                  Layers ly, int layers, int widest, int longest,
                  int* __restrict__ work, long long span) {
  extern __shared__ int smem_coord[];
  int* sums = smem_coord;
  int* own = IN_SHARED == 3 ? nullptr : work + span * blockIdx.x;
  int* first = IN_SHARED >= 1 ? sums + 32 : own;
  int* ord = first + 2 * widest;
  int* inv = ord + 2 * widest;
  int* mark = IN_SHARED == 1 ? own : inv + widest;
  int* fields = IN_SHARED == 2 ? own : mark + longest;
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const int top = layers - 1;
  const int n_top = ly.n[top];
  const int v_last = tid < n_top ? last[b * n_top + tid] : 0;

  // the top layer's first fields, held in registers over the top level
  long long pre[kCoordPrefetch];
  const int k_top = ly.k[top];
  const int n_pre =
      top >= 1 ? min(n_top * k_top, kCoordPrefetch * kCoordThreads) : 0;
  if (top >= 1) {
    const long long* nb = ly.nbr[top] + b * ly.nbr_bs[top];
#pragma unroll
    for (int m = 0; m < kCoordPrefetch; ++m) {
      const int e = tid + m * kCoordThreads;
      if (e < n_pre) {
        const int i = e / k_top;
        pre[m] = nb[i * ly.nbr_rs[top] + (e - i * k_top)];
      }
    }
  }
  // the other fields, into their part of the walk
  for (int l = top; l >= 1; --l) {
    const int k = ly.k[l], below = ly.n[l - 1];
    const long long* nb = ly.nbr[l] + b * ly.nbr_bs[l];
    int* f = fields + ly.field[l];
    const int count = ly.n[l] * k;
#pragma unroll 4
    for (int e = tid + (l == top ? n_pre : 0); e < count;
         e += kCoordThreads) {
      const int i = e / k;
      f[e] = clamp_index(nb[i * ly.nbr_rs[l] + (e - i * k)], below);
    }
  }
  // the top level's stream, the last order, where its upper order would be
  int* up = ord + ((top + 1) & 1) * widest;
  for (int s = tid; s < n_top; s += kCoordThreads) {
    up[s] = clamp_index(s == tid ? v_last : last[b * n_top + s], n_top);
    first[(top & 1) * widest + s] = INT_MAX;
  }
  __syncthreads();
  int walked = n_top;
  for (int t = top; t >= 0; --t) {
    const int n = ly.n[t];
    int* fst = first + (t & 1) * widest;
    int* mine = ord + (t & 1) * widest;
    // (A) s = tid + T m, as row r and column j, stepped without division
    const int above = min(t + 1, top);
    const int k = t == top ? 1 : ly.k[above];
    const int* f = t == top ? up : fields + ly.field[above];
    const int S = walked * k;
    const int dr = kCoordThreads / k, dj = kCoordThreads - dr * k;
    int r = tid / k, j = tid - r * k;
    bool repeat = false;                 // at the top: a point met twice
#pragma unroll 4
    for (int s = tid; s < S; s += kCoordThreads) {
      const int p = t == top ? f[s] : f[up[r] * k + j];
      if (t == top)
        repeat |= atomicMin(&fst[p], s) != INT_MAX;
      else
        atomicMin(&fst[p], s);         // no return: a reduction
      mark[s] = -1;
      r += dr;
      j += dj;
      if (j >= k) {
        j -= k;
        ++r;
      }
    }
    if (t > 0) {
      int* next = first + ((t - 1) & 1) * widest;
      for (int p = tid; p < ly.n[t - 1]; p += kCoordThreads) next[p] = INT_MAX;
    }
    if (t < top) {
      int* og = out + ly.at[t + 1] + b * ly.n[t + 1];
      write_level(up, inv, ly.n[t + 1], og, og + ly.inv);
    }
    if (__syncthreads_or(repeat) == 0 && t == top) {
      // the last order names each point once: it is the top level's
      // order, whole, and no mark or compaction is needed
      for (int s = tid; s < n_top; s += kCoordThreads) inv[up[s]] = s;
      if (top >= 1) store_prefetch(pre, n_pre, fields + ly.field[top],
                                   ly.n[top - 1]);
      __syncthreads();
      continue;
    }
    // (B) the marks; the points that occur are the next level's rows
    int occurs = 0;
    for (int base = 0; base < n; base += kCoordThreads) {
      const int p = base + tid;
      const int v = p < n ? fst[p] : INT_MAX;
      if (v != INT_MAX) mark[v] = p;
      occurs += __syncthreads_count(v != INT_MAX);
    }
    // (C)
    compact_level(mark, S, n, fst, sums, mine, inv);
    if (t == top && top >= 1)
      store_prefetch(pre, n_pre, fields + ly.field[top], ly.n[top - 1]);
    walked = occurs;
    up = mine;
    __syncthreads();
  }
  int* og = out + ly.at[0] + b * ly.n[0];
  write_level(up, inv, ly.n[0], og, og + ly.inv);
}

// One P2 launch's arguments, and the launch at `smem` ints of shared
// memory.
struct Launch {
  const int* last;
  int* out;
  const Layers* ly;
  int layers, widest, longest;
  int* work;
  int span, batch;
  cudaStream_t stream;
};

template <int IN_SHARED>
int launch_coordinate(const Launch& a, long long smem) {
  smem *= static_cast<long long>(sizeof(int));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        coordinate_kernel<IN_SHARED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  coordinate_kernel<IN_SHARED><<<a.batch, kCoordThreads,
                                 static_cast<size_t>(smem), a.stream>>>(
      a.last, a.out, *a.ly, a.layers, a.widest, a.longest, a.work, a.span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// P1: order (batch, n) int32, the greedy chain of each cloud of points
// (batch, n, 3) float32 from index `start`; `threads` a block: 32 runs one
// warp a cloud (n <= 256), a larger multiple of 32 up to 256 the block
// design; `per` points a thread (1, 2, 4 or 8; threads * per >= n).
// Returns the cudaError_t of the launch (0 on success).
int plan_greedy(const void* points, void* order, int batch, int n, int start,
                int threads, int per, void* stream) {
  return launch_greedy<false>(points, order, batch, n, start, threads, per,
                              stream);
}

// A measurement, not part of the library's interface: plan_greedy's
// one-warp launch (threads 32) with the distance arithmetic left out, so a
// step is the chain of reductions and the center's broadcast alone. Its
// orders mean nothing. chip_smoke.py binds it for chain_us_per_step.
int plan_greedy_chain(const void* points, void* order, int batch, int n,
                      int start, int threads, int per, void* stream) {
  return launch_greedy<true>(points, order, batch, n, start, threads, per,
                             stream);
}

// P2: for each of `layers` layers l (layer l + 1), the completed
// coordinated order and its inverse, (batch, n_l) int32 each, into `out`:
// every layer's order, layer 1 first, then every layer's inverse. From
// `last` (batch, n_top) int32 and the receptive fields. `args` holds 5 x
// layers int64: the neighbor tensors' addresses (int64; layer 1's is never
// read), the point counts, K, and the neighbor tensors' cloud and row
// strides. The walk's three parts are 5 widest, the longest stream and
// the fields of layers 2..L, int32; `span`, the ints a cloud of them that
// lie in `work` (batch spans), names which: 0 (work may be null), none;
// the fields'; the marks' and the fields'; or all three parts'. Any other
// span is refused. Returns the cudaError_t of the launch.
int plan_coordinate(const void* last, void* out, const long long* args,
                    void* work, int batch, int layers, int span,
                    void* stream) {
  if (batch < 1 || layers < 1 || layers > kMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  Layers ly = {};
  long long widest = 0, fields = 0, at = 0;
  for (int l = 0; l < layers; ++l) {
    const long long n = args[layers + l], k = args[2 * layers + l];
    if (n < 1 || n > INT_MAX || k < 1 || n * k > INT_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    ly.nbr[l] = reinterpret_cast<const long long*>(
        static_cast<uintptr_t>(args[l]));
    ly.n[l] = static_cast<int>(n);
    ly.k[l] = static_cast<int>(k);
    ly.nbr_bs[l] = args[3 * layers + l];
    ly.nbr_rs[l] = args[4 * layers + l];
    ly.at[l] = at;
    at += batch * n;
    if (l >= 1) {
      ly.field[l] = static_cast<int>(fields);
      fields += n * k;
    }
    widest = n > widest ? n : widest;
  }
  ly.inv = at;
  // the longest stream a level walks: the last order, or all the rows of
  // a layer's fields
  long long longest = ly.n[layers - 1];
  for (int l = 1; l < layers; ++l) {
    const long long walk = static_cast<long long>(ly.n[l]) * ly.k[l];
    longest = walk > longest ? walk : longest;
  }
  const long long levels = 5 * widest, all = levels + longest + fields;
  if (all > INT_MAX || (span != 0 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch a = {static_cast<const int*>(last), static_cast<int*>(out),
                    &ly, layers, static_cast<int>(widest),
                    static_cast<int>(longest), static_cast<int*>(work), span,
                    batch, static_cast<cudaStream_t>(stream)};
  if (span == 0) return launch_coordinate<3>(a, 32 + all);
  if (span == fields) return launch_coordinate<2>(a, 32 + levels + longest);
  if (span == longest + fields) return launch_coordinate<1>(a, 32 + levels);
  if (span == all) return launch_coordinate<0>(a, 32);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
