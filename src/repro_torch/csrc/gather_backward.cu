// P4 on Hopper: the backward of a row gather, summed in a fixed order.
//
// The port's own kernel; no pallas_call is replaced. The forward of
// kernels/gather_backward.py::gather_rows is torch.take_along_dim, used by
// PointNet++'s feature gathers, the LM's embedding and the MoE dispatch.
// Autograd's backward for it is a scatter-add, whose order on the card
// follows its atomics and changes from run to run. The JAX package's step
// is reproducible; this kernel computes the same gradient in one order:
//   out[r, c] = (((0.0f + g[p_0, c]) + g[p_1, c]) + ...) + g[p_last, c],
// p_0 < p_1 < ... the positions whose flat key (batch row l times n_rows,
// plus the gathered row index) is r: the CPU's sequential scatter-add, so
// the card and the CPU give the same bits. Float addition does not
// associate, so a segment's positions are never split between threads:
// the parallelism comes from rows and channels only.
//
// Two stages, each with what bounds it:
//
// 1. Segments: perm (positions ordered by key, stably) and starts (row r's
//    segment of perm is [starts[r], starts[r+1])), the keys being int32
//    (the wrapper refuses sizes at or above 2^31). Batch row l's keys lie
//    in [l * n_rows, (l + 1) * n_rows) and its positions are contiguous,
//    so the sort is L independent counting sorts. Its bytes are the
//    indices read once and perm and starts written once; what bounds it is
//    latency (a few dependent steps on few bytes), so it takes as few
//    launches as it can.
//    (a) n_rows <= kFusedMaxRows and positions <= kFusedMaxPositions
//        (PointNet++'s SA gathers, the MoE dispatch): a block takes one
//        batch row's slice of at most kFusedBlockRows rows, loads the
//        row's keys into shared memory, counts them per warp (integer
//        atomics: the counts do not depend on their order), scans the
//        counts (a block-wide exclusive scan gives starts), and places the
//        positions stably: each warp walks its own contiguous range in
//        32-position chunks, in order, the rank among equal keys being
//        __match_any_sync plus the popcount of the lower lanes plus the
//        warp's running count per bin. The slices of one batch row each
//        redo this cheap sort over the row's keys, so the card fills with
//        blocks; the sum (2) then runs in the same launch on perm and
//        starts in shared memory: one launch per gather, nothing written
//        but the output (gather_rows_backward_fused).
//    (b) any other size (the LM embedding, 151936 rows): a stable LSD
//        radix sort over ceil(log2(L * n_rows)) bits in passes of at most
//        kDigitBits bits. Each pass: per-tile digit counts
//        (segments_count_kernel), then a stable scatter
//        (segments_scatter_kernel) whose block scans the tiles' counts
//        itself (at most kMaxTiles tiles) and ranks as in (a). Then
//        segments_bounds_kernel fills starts from the sorted keys, each
//        sorted position writing its own start and every empty row between
//        its key and the one before it (a warp shares the long gaps).
//        2 passes at the embedding: 5 launches, no torch.sort, searchsorted
//        or arange.
//
// 2. The segment sum, bound by bytes: the gradient (positions x C) read
//    once, the output (rows x C) written once; one addition per gradient
//    element. A warp owns one row's tile of 128 channels (32 lanes x 4
//    floats: 16-byte loads and stores where C % 4 == 0 and the pointers
//    are aligned, else 4 scalar channels a lane, 32 apart). It keeps
//    kInFlight gradient-row loads in flight (kFusedInFlight in (a), whose
//    segments are short) and adds them in order, so a segment of n
//    positions costs about n / kInFlight memory round trips, not n
//    dependent pairs (the embedding's longest segment is 2105 positions).
//    In (b):
//    - the warp loads 32 perm entries at a time in one coalesced load and
//      hands them on by shuffle, the next 32 loading meanwhile;
//    - a block takes a group of kGroupRows rows and one channel tile and
//      reads the group's starts once, so an empty row (most of the
//      embedding's 151936) costs its 16-byte zero stores and nothing
//      else;
//    - its warps take contiguous runs of the group's rows of about equal
//      cost (positions plus a row's own round trip), so a long segment is
//      its warp's only row;
//    - its stores stream (evict first): the output is far larger than L2
//      and is not read again here, while the gradient rows may stay there.
//
// Indices, positions and offsets are clamped into range as a memory guard
// only: the wrapper never passes others.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileCh = 128;            // channels of one warp's tile
constexpr int kFusedMaxRows = 4096;     // path (a): rows of a batch row
constexpr int kFusedMaxPositions = 4096;  // path (a): its positions
constexpr int kFusedBlockRows = 256;    // path (a): rows of one block
constexpr int kFusedInFlight = 8;
constexpr int kDigitBits = 9;           // path (b): bits of one pass
constexpr int kTileMin = 1024;          // path (b): keys of one tile
constexpr int kMaxTiles = 64;
constexpr int kGroupRows = 256;         // path (b) sum: rows of one block
constexpr int kInFlight = 16;
constexpr int kRowCost = 16;            // path (b) sum: a row's cost

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// a[0, n) in shared memory <- its exclusive prefix sums; returns the total.
// Every thread of the block calls it with the same n.
__device__ int block_exclusive_scan(int* a, int n, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + threadIdx.x;
    const int v = i < n ? a[i] : 0;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      const int s = lane < kWarps ? warp_sums[lane] : 0;
      int t = s;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, t, d);
        if (lane >= d) t += y;
      }
      if (lane < kWarps) warp_sums[lane] = t - s;
      if (lane == kWarps - 1) warp_sums[kWarps] = t;
    }
    __syncthreads();
    if (i < n) a[i] = carry + warp_sums[warp] + x - v;
    carry += warp_sums[kWarps];
    __syncthreads();
  }
  return carry;
}

// One lane's 4 channels of a 128-channel tile starting at ch0: 4
// consecutive ones (kVec, one 16-byte access) or 4 at a stride of 32.
template <bool kVec>
__device__ __forceinline__ void load4(const float* __restrict__ row, int ch0,
                                      int c, int lane, float (&v)[4]) {
  if (kVec) {
    const int ch = ch0 + 4 * lane;
    if (ch < c) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(row + ch));
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.0f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ch = ch0 + lane + 32 * k;
      v[k] = ch < c ? __ldg(row + ch) : 0.0f;
    }
  }
}

// kStream: evict-first stores (__stcs), for an output that L2 cannot hold.
template <bool kVec, bool kStream>
__device__ __forceinline__ void store4(float* __restrict__ row, int ch0,
                                       int c, int lane, const float (&v)[4]) {
  if (kVec) {
    const int ch = ch0 + 4 * lane;
    if (ch < c) {
      float4* dst = reinterpret_cast<float4*>(row + ch);
      const float4 t = make_float4(v[0], v[1], v[2], v[3]);
      if (kStream)
        __stcs(dst, t);
      else
        *dst = t;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ch = ch0 + lane + 32 * k;
      if (ch < c) {
        if (kStream)
          __stcs(row + ch, v[k]);
        else
          row[ch] = v[k];
      }
    }
  }
}

// The sum of one row's channel tile over the positions pos[lo, hi) (in
// shared memory), in order, kU loads in flight.
template <bool kVec, int kU>
__device__ __forceinline__ void sum_tile_shared(
    const float* __restrict__ grad, const int* pos, int lo, int hi,
    float* __restrict__ orow, int c, int ch0, int lane) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = lo; j < hi; j += kU) {
    float v[kU][4];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (j + u < hi)
        load4<kVec>(grad + static_cast<size_t>(pos[j + u]) * c, ch0, c,
                    lane, v[u]);
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (j + u < hi) {
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(acc[k], v[u][k]);
      }
  }
  store4<kVec, false>(orow, ch0, c, lane, acc);
}

// The same over perm[lo, hi) in device memory: 32 entries a coalesced
// load, handed on by shuffle, the next 32 loading meanwhile. lo and hi
// are the same in the whole warp.
template <bool kVec, int kU>
__device__ __forceinline__ void sum_tile_perm(
    const float* __restrict__ grad, const long long* __restrict__ perm,
    int lo, int hi, int positions, float* __restrict__ orow, int c, int ch0,
    int lane) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  long long next = lo + lane < hi ? perm[lo + lane] : 0;
  for (int base = lo; base < hi; base += 32) {
    const int n = min(32, hi - base);
    const int pv = static_cast<int>(
        min(max(next, 0LL), static_cast<long long>(positions) - 1));
    // the next chunk's entries load while this chunk's rows do
    next = base + 32 + lane < hi ? perm[base + 32 + lane] : 0;
    for (int k0 = 0; k0 < n; k0 += kU) {
      float v[kU][4];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int p = __shfl_sync(kFull, pv, (k0 + u) & 31);
        if (k0 + u < n)
          load4<kVec>(grad + static_cast<size_t>(p) * c, ch0, c, lane, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (k0 + u < n) {
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(acc[k], v[u][k]);
        }
    }
  }
  store4<kVec, true>(orow, ch0, c, lane, acc);
}

// ---------------------------------------------------------------------------
// Path (a): one batch row's slice of rows, sorted in shared memory, then
// summed.

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_rows_backward_kernel_fused(const float* __restrict__ grad,
                                  const long long* __restrict__ idx,
                                  float* __restrict__ out, int positions,
                                  int n_rows, int c, int rpb, int splits) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[kWarps + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l = blockIdx.x / splits;
  const int r0 = (blockIdx.x - l * splits) * rpb;
  const int nr = min(rpb, n_rows - r0);
  int* key = smem;                    // [positions]: bin, or -1 outside
  int* sperm = key + positions;       // [positions]: sorted positions
  int* hist = sperm + positions;      // [kWarps][rpb]
  int* starts = hist + kWarps * rpb;  // [rpb + 1]
  const long long* row_idx = idx + static_cast<long long>(l) * positions;

  for (int i = threadIdx.x; i < kWarps * rpb; i += kThreads) hist[i] = 0;
#pragma unroll 4
  for (int p = threadIdx.x; p < positions; p += kThreads) {
    long long k = row_idx[p];
    k = min(max(k, 0LL), static_cast<long long>(n_rows) - 1);
    const int b = static_cast<int>(k) - r0;
    key[p] = (b >= 0 && b < nr) ? b : -1;
  }
  __syncthreads();

  // each warp's contiguous range of positions, whole 32-position chunks
  const int per = ((positions + 31) / 32 + kWarps - 1) / kWarps * 32;
  const int w_lo = min(positions, warp * per);
  const int w_hi = min(positions, w_lo + per);
  int* my = hist + warp * rpb;
  for (int p = w_lo + lane; p < w_hi; p += 32) {
    const int b = key[p];
    if (b >= 0) atomicAdd(&my[b], 1);
  }
  __syncthreads();
  // per bin: each warp's offset among the bin's positions, and its count
  for (int b = threadIdx.x; b < nr; b += kThreads) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int v = hist[w * rpb + b];
      hist[w * rpb + b] = run;
      run += v;
    }
    starts[b] = run;
  }
  __syncthreads();
  const int total = block_exclusive_scan(starts, nr, warp_sums);
  if (threadIdx.x == 0) starts[nr] = total;
  for (int b = threadIdx.x; b < nr; b += kThreads)
    for (int w = 0; w < kWarps; ++w) hist[w * rpb + b] += starts[b];
  __syncthreads();
  // stable placement: chunks in order within a warp, warps in order
  for (int base = w_lo; base < w_hi; base += 32) {
    const int p = base + lane;
    const int b = p < w_hi ? key[p] : -1;
    const unsigned peers = __match_any_sync(kFull, b);
    const int off = b >= 0 ? my[b] : 0;
    __syncwarp();
    if (b >= 0) {
      const int rank = __popc(peers & lanemask_lt());
      sperm[off + rank] = p;
      if (rank == __popc(peers) - 1) my[b] = off + rank + 1;
    }
    __syncwarp();
  }
  __syncthreads();

  const int n_ct = (c + kTileCh - 1) / kTileCh;
  const float* g = grad + static_cast<size_t>(l) * positions * c;
  float* o = out + (static_cast<size_t>(l) * n_rows + r0) * c;
  for (int it = warp; it < nr * n_ct; it += kWarps) {
    const int b = it / n_ct, ct = it - b * n_ct;
    sum_tile_shared<kVec, kFusedInFlight>(g, sperm, starts[b], starts[b + 1],
                                          o + static_cast<size_t>(b) * c, c,
                                          ct * kTileCh, lane);
  }
}

// ---------------------------------------------------------------------------
// Path (b): stable LSD radix sort of the flat keys, then the bounds.

// Key of flat position p: from the indices in the first pass, else from
// the previous pass's keys.
__device__ __forceinline__ int key_at(const long long* __restrict__ idx,
                                      const int* __restrict__ keys, int p,
                                      int positions, int n_rows) {
  if (keys != nullptr) return keys[p];
  long long k = idx[p];
  k = min(max(k, 0LL), static_cast<long long>(n_rows) - 1);
  return (p / positions) * n_rows + static_cast<int>(k);
}

__global__ void __launch_bounds__(kThreads)
segments_count_kernel(const long long* __restrict__ idx,
                      const int* __restrict__ keys, int* __restrict__ counts,
                      int n, int positions, int n_rows, int tile, int shift,
                      int digits) {
  __shared__ int hist[1 << kDigitBits];
  for (int i = threadIdx.x; i < digits; i += kThreads) hist[i] = 0;
  __syncthreads();
  const int lo = blockIdx.x * tile, hi = min(n, lo + tile);
#pragma unroll 4
  for (int p = lo + threadIdx.x; p < hi; p += kThreads)
    atomicAdd(&hist[(key_at(idx, keys, p, positions, n_rows) >> shift) &
                    (digits - 1)], 1);
  __syncthreads();
  for (int i = threadIdx.x; i < digits; i += kThreads)
    counts[blockIdx.x * digits + i] = hist[i];
}

// One tile's keys to their places in the pass's order: the tile's digit
// offsets from every tile's counts, then per-warp offsets, then the
// stable placement of (a). The last pass writes perm (int64), the others
// the values for the next.
__global__ void __launch_bounds__(kThreads)
segments_scatter_kernel(const long long* __restrict__ idx,
                        const int* __restrict__ keys_in,
                        const int* __restrict__ vals_in,
                        const int* __restrict__ counts,
                        int* __restrict__ keys_out, int* __restrict__ vals_out,
                        long long* __restrict__ perm, int n, int positions,
                        int n_rows, int tile, int tiles, int shift,
                        int digits) {
  __shared__ int hist[kWarps << kDigitBits];
  __shared__ int dbase[1 << kDigitBits];
  __shared__ int dpre[1 << kDigitBits];
  __shared__ int warp_sums[kWarps + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x;
  for (int q = threadIdx.x; q < digits; q += kThreads) {
    int tot = 0, pre = 0;
    for (int s = 0; s < tiles; ++s) {
      const int v = counts[s * digits + q];
      pre += s < t ? v : 0;
      tot += v;
    }
    dbase[q] = tot;
    dpre[q] = pre;
  }
  for (int i = threadIdx.x; i < kWarps * digits; i += kThreads) hist[i] = 0;
  __syncthreads();
  block_exclusive_scan(dbase, digits, warp_sums);

  const int lo = t * tile, hi = min(n, lo + tile);
  const int per = tile / kWarps;          // tile is a multiple of 256
  const int w_lo = min(hi, lo + warp * per);
  const int w_hi = min(hi, w_lo + per);
  const int mask = digits - 1;
  int* my = hist + warp * digits;
#pragma unroll 4
  for (int p = w_lo + lane; p < w_hi; p += 32)
    atomicAdd(&my[(key_at(idx, keys_in, p, positions, n_rows) >> shift) &
                  mask], 1);
  __syncthreads();
  for (int q = threadIdx.x; q < digits; q += kThreads) {
    int run = dbase[q] + dpre[q];
    for (int w = 0; w < kWarps; ++w) {
      const int v = hist[w * digits + q];
      hist[w * digits + q] = run;
      run += v;
    }
  }
  __syncthreads();
  // each chunk's keys and values load while the chunk before is placed
  bool next_valid = w_lo + lane < w_hi;
  int next_key = 0, next_val = 0;
  if (next_valid) {
    next_key = key_at(idx, keys_in, w_lo + lane, positions, n_rows);
    next_val = vals_in != nullptr ? vals_in[w_lo + lane] : w_lo + lane;
  }
  for (int base = w_lo; base < w_hi; base += 32) {
    const bool valid = next_valid;
    const int key = next_key, val = next_val;
    const int np = base + 32 + lane;
    next_valid = np < w_hi;
    if (next_valid) {
      next_key = key_at(idx, keys_in, np, positions, n_rows);
      next_val = vals_in != nullptr ? vals_in[np] : np;
    }
    const int q = valid ? (key >> shift) & mask : -1;
    const unsigned peers = __match_any_sync(kFull, q);
    const int off = valid ? my[q] : 0;
    __syncwarp();
    if (valid) {
      const int rank = __popc(peers & lanemask_lt());
      const int dest = off + rank;
      keys_out[dest] = key;
      if (perm != nullptr)
        perm[dest] = val;
      else
        vals_out[dest] = val;
      if (rank == __popc(peers) - 1) my[q] = dest + 1;
    }
    __syncwarp();
  }
}

// starts[r] = the first sorted position whose key is r or more: sorted
// position j (and j = n, past the end) writes it for the rows after the
// key before it, up to its own key (n: up to k, the last entry).
__global__ void __launch_bounds__(kThreads)
segments_bounds_kernel(const int* __restrict__ sorted,
                       long long* __restrict__ starts, int n, int k) {
  const int lane = threadIdx.x & 31;
  const long long j = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  int lo = 0, hi = -1;
  if (j <= n) {
    lo = (j == 0 ? -1 : sorted[j - 1]) + 1;
    hi = j == n ? k : sorted[j];
  }
  if (hi - lo < 32)
    for (int r = lo; r <= hi; ++r) starts[r] = j;
  unsigned longs = __ballot_sync(kFull, hi - lo >= 32);
  while (longs) {
    const int src = __ffs(longs) - 1;
    const int a = __shfl_sync(kFull, lo, src);
    const int b = __shfl_sync(kFull, hi, src);
    const long long jj = __shfl_sync(kFull, j, src);
    for (int r = a + lane; r <= b; r += 32) starts[r] = jj;
    longs &= longs - 1;
  }
}

// ---------------------------------------------------------------------------
// The segment sum over perm and starts in device memory.

// A block takes kGroupRows rows and one channel tile, and its warps take
// contiguous runs of those rows of about equal cost: a row costs its
// positions (at most 2^19, so that the total times kWarps fits an int: a
// balance, not a count) plus kRowCost (its own round trip), the costs are
// scanned, and warp w takes the rows whose scanned start falls in its
// eighth of the total. So a long segment (the embedding's 2105 positions at row 0)
// is its warp's only row, and the group's other rows go to the others.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_rows_backward_kernel(const float* __restrict__ grad,
                            const long long* __restrict__ perm,
                            const long long* __restrict__ starts,
                            float* __restrict__ out, int rows, int c,
                            int positions, int n_ct) {
  __shared__ int seg[kGroupRows + 1];
  __shared__ int cost[kGroupRows];
  __shared__ int first[kWarps + 1];
  __shared__ int warp_sums[kWarps + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = blockIdx.x / n_ct, ct = blockIdx.x - group * n_ct;
  const int r0 = group * kGroupRows;
  const int nr = min(kGroupRows, rows - r0);
  for (int i = threadIdx.x; i <= nr; i += kThreads)
    seg[i] = static_cast<int>(
        min(max(starts[r0 + i], 0LL), static_cast<long long>(positions)));
  if (threadIdx.x <= kWarps) first[threadIdx.x] = nr;
  __syncthreads();
  for (int b = threadIdx.x; b < nr; b += kThreads)
    cost[b] = min(max(seg[b + 1] - seg[b], 0), 1 << 19) + kRowCost;
  __syncthreads();
  const int total = block_exclusive_scan(cost, nr, warp_sums);
  for (int b = threadIdx.x; b < nr; b += kThreads) {
    const int own = cost[b] * kWarps / total;
    const int prev = b == 0 ? -1 : cost[b - 1] * kWarps / total;
    for (int w = prev + 1; w <= own; ++w) first[w] = b;
  }
  __syncthreads();
  for (int b = first[warp]; b < first[warp + 1]; ++b) {
    const int lo = seg[b], hi = max(seg[b + 1], lo);
    sum_tile_perm<kVec, kInFlight>(
        grad, perm, lo, hi, positions,
        out + static_cast<size_t>(r0 + b) * c, c, ct * kTileCh, lane);
  }
}

int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = n > 0 ? n : 1;
  }
  return cached[dev];
}

// Path (a)'s split: rows per block and blocks per batch row, about four
// blocks an SM in all, at most kFusedBlockRows rows a block.
void fused_split(int batch, int n_rows, int* rpb, int* splits) {
  const int target = 4 * sm_count();
  const int want = max(1, min(n_rows, (target + batch - 1) / batch));
  *rpb = min(kFusedBlockRows, (n_rows + want - 1) / want);
  *splits = (n_rows + *rpb - 1) / *rpb;
}

size_t fused_smem(int positions, int rpb) {
  return sizeof(int) * (2 * static_cast<size_t>(positions) +
                        (kWarps + 1) * static_cast<size_t>(rpb) + 1);
}

bool fused_fits(int batch, int positions, int n_rows) {
  return batch >= 1 && n_rows >= 1 && n_rows <= kFusedMaxRows &&
         positions >= 0 && positions <= kFusedMaxPositions;
}

struct RadixPlan {
  int passes, bits, digits, tile, tiles;
  long long words;  // int32 scratch: keys and values twice, the counts
};

RadixPlan radix_plan(int n, int k) {
  RadixPlan p{};
  int bits = 1;
  while (bits < 31 && (1LL << bits) < k) ++bits;
  p.passes = (bits + kDigitBits - 1) / kDigitBits;
  p.bits = (bits + p.passes - 1) / p.passes;
  p.digits = 1 << p.bits;
  const int spread = ((n + kMaxTiles - 1) / kMaxTiles + kThreads - 1) /
                     kThreads * kThreads;
  p.tile = max(kTileMin, spread);
  p.tiles = (n + p.tile - 1) / p.tile;
  p.words = 4LL * n + static_cast<long long>(p.tiles) * p.digits;
  return p;
}

bool too_large(long long a, long long b) { return a * b >= (1LL << 31); }

}  // namespace

extern "C" {

// The path (b) plan, for the wrapper: how many passes and int32 scratch
// words the radix sort of n keys below k takes.
int gather_rows_radix_passes(int n, int k) { return radix_plan(n, k).passes; }

long long gather_rows_radix_words(int n, int k) {
  return radix_plan(n, k).words;
}

// out (rows, c) float32, from grad (positions, c) float32, perm
// (positions,) int64 (the positions in key order, stably) and starts
// (rows + 1,) int64 (row r's segment of perm is [starts[r], starts[r+1])).
// All contiguous. Returns the cudaError_t of the launch (0 on success).
int gather_rows_backward(const void* grad, const void* perm,
                         const void* starts, void* out, int rows, int c,
                         int positions, void* stream) {
  if (rows < 1 || c < 1 || positions < 0 || too_large(rows, c) ||
      too_large(positions, c))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_ct = (c + kTileCh - 1) / kTileCh;
  const long long blocks =
      static_cast<long long>((rows + kGroupRows - 1) / kGroupRows) * n_ct;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = c % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(grad) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(grad);
  const auto* pm = static_cast<const long long*>(perm);
  const auto* st = static_cast<const long long*>(starts);
  auto* o = static_cast<float*>(out);
  if (vec)
    gather_rows_backward_kernel<true><<<static_cast<unsigned>(blocks),
                                        kThreads, 0, s>>>(
        g, pm, st, o, rows, c, positions, n_ct);
  else
    gather_rows_backward_kernel<false><<<static_cast<unsigned>(blocks),
                                         kThreads, 0, s>>>(
        g, pm, st, o, rows, c, positions, n_ct);
  return static_cast<int>(cudaGetLastError());
}

// Path (a), sort and sum in one launch: out (batch * n_rows, c) float32
// from grad (batch * positions, c) float32 and idx (batch, positions)
// int64, both contiguous.
int gather_rows_backward_fused(const void* grad, const void* idx, void* out,
                               int batch, int positions, int n_rows, int c,
                               void* stream) {
  if (!fused_fits(batch, positions, n_rows) || c < 1 ||
      too_large(static_cast<long long>(batch) * n_rows, c) ||
      too_large(static_cast<long long>(batch) * positions, c))
    return static_cast<int>(cudaErrorInvalidValue);
  int rpb = 0, splits = 0;
  fused_split(batch, n_rows, &rpb, &splits);
  const long long blocks = static_cast<long long>(batch) * splits;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = c % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(grad) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const size_t smem = fused_smem(positions, rpb);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(grad);
  const auto* ix = static_cast<const long long*>(idx);
  auto* o = static_cast<float*>(out);
  if (vec)
    gather_rows_backward_kernel_fused<true><<<static_cast<unsigned>(blocks),
                                              kThreads, smem, s>>>(
        g, ix, o, positions, n_rows, c, rpb, splits);
  else
    gather_rows_backward_kernel_fused<false><<<static_cast<unsigned>(blocks),
                                               kThreads, smem, s>>>(
        g, ix, o, positions, n_rows, c, rpb, splits);
  return static_cast<int>(cudaGetLastError());
}

// Path (b), any size: perm and starts as above, through
// gather_rows_radix_passes(n, k) passes (n = batch * positions keys below
// k = batch * n_rows) and the bounds; scratch holds at least
// gather_rows_radix_words(n, k) int32 words.
int gather_rows_segments(const void* idx, void* perm, void* starts,
                         void* scratch, int batch, int positions, int n_rows,
                         long long scratch_words, void* stream) {
  if (batch < 0 || positions < 0 || n_rows < 0 ||
      too_large(batch, positions) || too_large(batch, n_rows) ||
      (positions > 0 && batch > 0 && n_rows < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = batch * positions, k = batch * n_rows;
  const RadixPlan plan = radix_plan(n, k);
  if (scratch_words < plan.words)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const long long*>(idx);
  int* words = static_cast<int*>(scratch);
  int* keys[2] = {words, words + n};
  int* vals[2] = {words + 2LL * n, words + 3LL * n};
  int* counts = words + 4LL * n;
  for (int pass = 0; n > 0 && pass < plan.passes; ++pass) {
    const bool first = pass == 0, last = pass == plan.passes - 1;
    const int* kin = first ? nullptr : keys[(pass - 1) & 1];
    const int* vin = first ? nullptr : vals[(pass - 1) & 1];
    const int shift = pass * plan.bits;
    segments_count_kernel<<<plan.tiles, kThreads, 0, s>>>(
        ix, kin, counts, n, positions, n_rows, plan.tile, shift,
        plan.digits);
    segments_scatter_kernel<<<plan.tiles, kThreads, 0, s>>>(
        ix, kin, vin, counts, keys[pass & 1], last ? nullptr : vals[pass & 1],
        last ? static_cast<long long*>(perm) : nullptr, n, positions, n_rows,
        plan.tile, plan.tiles, shift, plan.digits);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int sorted = (plan.passes - 1) & 1;
  segments_bounds_kernel<<<(n + kThreads) / kThreads, kThreads, 0, s>>>(
      keys[sorted], static_cast<long long*>(starts), n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
