// Hand-written Hopper (sm_90a) kernels of the classify path.
//
// Replaces the jitted XLA device functions of the JAX package
// (jn_cuclark_tpu/ops/device_pipeline.py, radix_table.py, score.py) and the
// Pallas row-probe experiment (benchmarks/experiments.py:exp_probe_pallas):
//
//   K1 window_canonicals  device_pipeline.py:21 window_canonicals + :68 _revcomp
//   K2 probe              radix_table.py:393 probe (_probe_rows + _stash_lookup);
//                         with an all-EMPTY stash it computes exactly what
//                         exp_probe_pallas computes
//   K3 top2               score.py:41 top2_from_labels / :57 top2_from_sorted
//   K4 sort_top2          device_pipeline.py:155 score_from_labels(extended=
//                         "sorted"): K3 plus each read's sorted label row
//   K5 counts_top2        score.py:17 counts_from_hits + :85 read_results
//                         (device_pipeline.py:159 score_from_labels(True));
//                         its flat form counts_flat takes per-query labels
//                         and read ids (engine.py:2076 _query_single)
//   K7 probe_chunk        radix_table.py:411 probe_chunk (out-of-core cycling)
//   K8 probe_dense        radix_table.py:602 probe_dense (two-plane table)
//   K9 lookup             lookup.py:41 lookup_labels (the flat path's
//                         sorted-array search)
//
// u64 values arrive as int64 bit patterns and u32 values as int32 bit
// patterns; the kernels read them as unsigned.  Each launcher is a plain C
// function (bound with ctypes): it launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so a
// refused launch surfaces at once.
//
// Every kernel here is redesigned for the card (their notes below say what
// bounds them and what the design does about it); K3 and K4 keep the
// first, simple block form for rows wider than their warp forms take.
// The DB-build aggregate (K6) lives in aggregate.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

typedef unsigned long long u64;
typedef unsigned int u32;

#define EMPTY64 0xFFFFFFFFFFFFFFFFull
#define MIX1 0x9E3779B97F4A7C15ull  // 2^64 / golden ratio, odd -> bijective
#define MIX2 0xC2B2AE3D27D4EB4Full  // the dense table's plane-2 mix, odd
#define STASH_CAP 64

// ---------------------------------------------------------------- K1
// Replaces device_pipeline.py:21 window_canonicals and :68 _revcomp:
// words [R, nw] (2-bit codes, first char in the lowest bits, one zero guard
// word per row), vwords [R, nv] (validity bits) -> q [R, W]: the canonical
// value min(x, revcomp(x)) of the window starting at column p, or EMPTY
// where the window holds an invalid char or runs off the read.
//
// Bound by bytes at the config-2 shape (R = 32,768, S = 256, W = 224,
// k = 31: the [R, W] u64 write, 58.7 MB, is the DRAM traffic; 0.0186 ms
// at 3.35 TB/s).  The first kernel ran one thread per window and was bound
// by integer issue instead: each window paid a 64-bit division i / W, two
// 64-bit funnel shifts and the five-stage revcomp, 247 SASS instructions a
// window, all of it 32-bit integer work on sm_90 (0.0546 ms on an H100 SXM
// at 700 W, 1.1 TB/s).  This design takes those off the per-window path:
// 531 instructions a thread of E = 8 windows, 66 a window, and 0.0245 ms
// at that shape, 2.5 TB/s, 76% of the bound (chip_smoke.py phase 5:
// sass_counts, the profiler's trace):
//
//   - 2-D launch, no division by W: blockIdx.x walks groups of rb rows,
//     blockIdx.y tiles of tr runs along a row (kernels.window_run plans
//     both from W alone; one 32-bit division per thread splits
//     threadIdx.x into row and run).
//   - Rolling windows: a thread takes a run of E consecutive windows.  The
//     first is funnel-shifted and reverse-complemented as before; each
//     later one takes one new char c:
//         x'  = (x >> 2) | (c << (2k-2))
//         rc' = ((rc << 2) | (3 - c)) & mask
//     The second follows from revcomp: with y_j the 2-bit group j of
//     rc = revcomp(x), y_j = 3 - c_{p+k-1-j}, so the next window's
//     y'_0 = 3 - c_{p+k} (the new char, complemented) and y'_j =
//     3 - c_{p+k-j} = y_{j-1}: rc shifts up one group and the top group
//     falls off (mask = 2k ones; all 64 at k = 32, where the shift drops it
//     by itself).  The run's E-1 new chars come from one funnel shift,
//     its validity bits (k + E - 1 <= 64) from another; window e is valid
//     where bits [e, e+k) are all set, the test the twin makes.
//   - Staged stores: a thread writes its E values to shared memory (one
//     slot of padding every 8 keeps a half-warp's 8-B stores on distinct
//     banks), and the block's outputs -- one contiguous span of q, since a
//     block holds whole rows or one tile of one row -- leave as 16-B
//     stores (store_stage).
#define K1_THREADS 256
#define K1_SLOT(i) ((i) + ((i) >> 3))  // padded stage slot of span index i

// Jellyfish reverse complement of a little-endian 2-bit k-mer
// (kmersConversion.cc:39-47): swap the 2-bit groups, complement, then shift
// the k-mer back down.  k in [1, 32] keeps the shift in [0, 62].
__device__ __forceinline__ u64 revcomp(u64 x, int k) {
  x = ((x >> 2) & 0x3333333333333333ull) | ((x & 0x3333333333333333ull) << 2);
  x = ((x >> 4) & 0x0F0F0F0F0F0F0F0Full) | ((x & 0x0F0F0F0F0F0F0F0Full) << 4);
  x = ((x >> 8) & 0x00FF00FF00FF00FFull) | ((x & 0x00FF00FF00FF00FFull) << 8);
  x = ((x >> 16) & 0x0000FFFF0000FFFFull) |
      ((x & 0x0000FFFF0000FFFFull) << 16);
  x = (x >> 32) | (x << 32);
  return (~x) >> (64 - 2 * k);
}

// 64 bits of a row's bit string from bit 64 lo + off on: a funnel shift of
// words lo and hi (a shift by 64 is undefined, hence the guard).  hi is
// lo + 1, clamped by the caller where that may pass the row.
__device__ __forceinline__ u64 funnel(const u64* w, int lo, int hi, int off) {
  u64 x = w[lo] >> off;
  if (off) x |= w[hi] << (64 - off);
  return x;
}

// n staged values (span index i at stage[K1_SLOT(i)]) to global dst by the
// whole block: one scalar store up to dst's first 16-B boundary, 16-B
// stores, one scalar tail.
__device__ __forceinline__ void store_stage(u64* __restrict__ dst,
                                            const u64* stage, int n) {
  int head = (int)(((uintptr_t)dst >> 3) & 1);
  if (head > n) head = n;
  if (threadIdx.x < head) dst[0] = stage[K1_SLOT(0)];
  int np = (n - head) >> 1;
  ulonglong2* d2 = reinterpret_cast<ulonglong2*>(dst + head);
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    int o = head + 2 * i;
    d2[i] = make_ulonglong2(stage[K1_SLOT(o)], stage[K1_SLOT(o + 1)]);
  }
  if (threadIdx.x == 0 && head + 2 * np < n) dst[n - 1] = stage[K1_SLOT(n - 1)];
}

// E windows a thread (a run); tr runs of each of rb rows a block, tile
// blockIdx.y of each row's runs.  W <= S keeps every char a window reads
// below S + 32, inside the row's guard word.
template <int E>
__global__ void __launch_bounds__(K1_THREADS)
window_canonicals_kernel(const u64* __restrict__ words,
                         const u64* __restrict__ vwords, u64* __restrict__ q,
                         long long R, int nw, int nv, int W, int k, int tr,
                         int rb) {
  __shared__ u64 stage[K1_SLOT(K1_THREADS * E)];
  long long r0 = (long long)blockIdx.x * rb;
  int nr = (int)min((long long)rb, R - r0);
  int p0 = blockIdx.y * tr * E;   // the tile's first window
  int wt = min(tr * E, W - p0);   // the tile's windows in each row
  int lr = threadIdx.x / tr, jr = threadIdx.x - lr * tr;
  int p = p0 + jr * E;            // the run's first window
  if (lr < nr && jr * E < wt) {
    const u64* wr = words + (r0 + lr) * nw;
    const u64* vr = vwords + (r0 + lr) * nv;
    u64 mask = k < 32 ? (1ull << (2 * k)) - 1 : ~0ull;
    u64 x = funnel(wr, p >> 5, (p >> 5) + 1, (p & 31) * 2) & mask;
    u64 rc = revcomp(x, k);
    // the run's new chars p+k .. p+k+E-2, 2(E-1) <= 14 bits
    int t = p + k;
    u32 next = (u32)funnel(wr, t >> 5, min((t >> 5) + 1, nw - 1),
                           (t & 31) * 2);
    u64 vs = funnel(vr, p >> 6, (p >> 6) + 1, p & 63);
    u64 kmask = (1ull << k) - 1;  // k <= 32
    int top = 2 * k - 2;
    int lim = wt - jr * E;        // windows of this run inside the tile
    int s0 = lr * wt + jr * E;    // span index of the run's first window
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e) {
        u64 c = (next >> (2 * (e - 1))) & 3;
        x = (x >> 2) | (c << top);
        rc = ((rc << 2) | (c ^ 3)) & mask;
      }
      if (e < lim) {
        bool valid = ((vs >> e) & kmask) == kmask;
        u64 canon = x < rc ? x : rc;  // unsigned min
        stage[K1_SLOT(s0 + e)] = valid ? canon : EMPTY64;
      }
    }
  }
  __syncthreads();
  store_stage(q + r0 * W + p0, stage, nr * wt);
}

// ---------------------------------------------------------------- K7
// Replaces radix_table.py:411 probe_chunk (out-of-core cycling): label+1 per
// query against one chunk of rows [start_row, start_row + rows_per) of a
// 2^m1-row table.  lrow = bucket - start_row is taken in signed 64-bit: in
// u64 a bucket below the chunk would wrap to a huge value.  A query
// bucketed outside the chunk gets 0; the stash counts only in the chunk
// that carries it (use_stash), so each key is counted once over a pass of
// all chunks.  rows_per need not be a power of two (chunk_table pads the
// last chunk).
//
// Bound by bytes: the queries read once, each distinct row that in-chunk
// queries touch read once -- only its hi half (C x 4 B) is needed, plus
// one 32-B sector of lo words where a hi word matched -- and the labels
// written once.  About 1/cycles of the queries fall in the chunk, and the
// chunk is far larger than the 50 MB L2.  Three launches, one pass each:
//
//   (a1) chunk_count: a thread per query counts the in-chunk queries of
//        each of nbins bins (lrow >> shift; a bin's hi halves fit a share
//        of L2, kernels.chunk_bins) in a shared-memory histogram, one
//        global atomic per bin per block; the last block to finish turns
//        the counts into bin offsets.
//   (a2) chunk_scatter: a thread per query answers the stash (staged in
//        shared memory, only where use_stash) and writes out[qi] -- every
//        query is answered here -- and appends each in-chunk query index
//        to its bin's span of the list (a block reserves its share of each
//        bin with one atomic).  Out-of-chunk queries cost one thread.
//   (b)  chunk_probe: the list in order, so the grid walks the bins in
//        order and a bin's rows come from HBM about once and from L2 for
//        the other ~6 queries per row.  8 lanes per query, 16-B loads of
//        the row's hi half; a lo word is read only where its hi word
//        equals t_hi.  That is exact: a hit needs x_hi == 0, and an EMPTY
//        slot's hi half (0xFFFFFFFF) never equals t_hi, since lb < m1
//        keeps qlow << lb below 2^63.  out[qi] = max(out[qi], row label).
//
// K2 and K8 below partition all their queries, by finer bins and with no
// global atomics, so they have partition kernels of their own.
#define K7_THREADS 256
#define K7_QPT 8     // queries a thread places per block tile in (a2)
#define K7_LANES 8   // lanes per query in (b)
#define K7_MAX_BINS 4096  // kernels.chunk_bins keeps nbins at or below

__device__ __forceinline__ long long chunk_row(u64 x, int m1,
                                               long long start_row) {
  return (long long)((x * MIX1) >> (64 - m1)) - start_row;  // m1 >= 1
}

// ctr: [nbins] counts, [nbins] cursors (offsets after a1), done, total
__global__ void __launch_bounds__(K7_THREADS)
chunk_count_kernel(const u64* __restrict__ q, long long Q, int m1,
                   long long start_row, long long rows_per, int shift,
                   int nbins, int* __restrict__ ctr) {
  extern __shared__ int hist[];  // [nbins]
  __shared__ bool last;
  for (int j = threadIdx.x; j < nbins; j += K7_THREADS) hist[j] = 0;
  __syncthreads();
  for (long long i = blockIdx.x * (long long)K7_THREADS + threadIdx.x; i < Q;
       i += (long long)gridDim.x * K7_THREADS) {
    long long lrow = chunk_row(q[i], m1, start_row);
    if (lrow >= 0 && lrow < rows_per) atomicAdd(&hist[lrow >> shift], 1);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nbins; j += K7_THREADS)
    if (hist[j]) atomicAdd(&ctr[j], hist[j]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&ctr[2 * nbins], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (last && threadIdx.x == 0) {  // every block's counts are in
    int run = 0;
    for (int j = 0; j < nbins; ++j) {
      int c = __ldcg(&ctr[j]);
      ctr[nbins + j] = run;
      run += c;
    }
    ctr[2 * nbins + 1] = run;
  }
}

__global__ void __launch_bounds__(K7_THREADS)
chunk_scatter_kernel(const u64* __restrict__ q, long long Q, int m1,
                     long long start_row, long long rows_per, int shift,
                     int nbins, const u64* __restrict__ stash_keys,
                     const int* __restrict__ stash_labels, int use_stash,
                     int* __restrict__ out, int* __restrict__ ctr,
                     int* __restrict__ list) {
  extern __shared__ int hist[];  // [nbins] this tile's counts, [nbins] bases
  __shared__ u64 sk[STASH_CAP];
  __shared__ int sl[STASH_CAP];
  __shared__ int n_stash;
  if (use_stash && threadIdx.x == 0) {  // drop the padding: EMPTY keys
    int n = 0;                          // that carry label 0
    for (int j = 0; j < STASH_CAP; ++j) {
      u64 key = stash_keys[j];
      if (key != EMPTY64 || stash_labels[j] != 0) {
        sk[n] = key;
        sl[n++] = stash_labels[j];
      }
    }
    n_stash = n;
  }
  const long long tile = (long long)K7_THREADS * K7_QPT;
  for (long long base = blockIdx.x * tile; base < Q;
       base += (long long)gridDim.x * tile) {  // uniform across the block
    for (int j = threadIdx.x; j < nbins; j += K7_THREADS) hist[j] = 0;
    __syncthreads();  // also publishes the stash
    int bin[K7_QPT], rank[K7_QPT];
#pragma unroll
    for (int u = 0; u < K7_QPT; ++u) {
      long long i = base + u * K7_THREADS + threadIdx.x;
      bin[u] = -1;
      if (i < Q) {
        u64 x = q[i];
        int best = 0;
        if (use_stash)
          for (int j = 0; j < n_stash; ++j)
            if (sk[j] == x) best = max(best, sl[j]);
        out[i] = best;
        long long lrow = chunk_row(x, m1, start_row);
        if (lrow >= 0 && lrow < rows_per) {
          bin[u] = (int)(lrow >> shift);
          rank[u] = atomicAdd(&hist[bin[u]], 1);
        }
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < nbins; j += K7_THREADS)
      if (hist[j]) hist[nbins + j] = atomicAdd(&ctr[nbins + j], hist[j]);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < K7_QPT; ++u)
      if (bin[u] >= 0)
        list[hist[nbins + bin[u]] + rank[u]] =
            (int)(base + u * K7_THREADS + threadIdx.x);
    __syncthreads();  // before the next tile clears hist
  }
}

// This lane's largest hit label in the row for (t_lo, t_hi): the hi half
// first, a lo word only behind a matching hi word.  vec: C % 4 == 0 and
// the slots 16-B aligned, so each lane loads 4 hi words at once, and up to
// four such loads are in flight before the compares.
__device__ __forceinline__ int k7_scan_row(const u32* __restrict__ row, int C,
                                           u32 t_lo, u32 t_hi, u32 above,
                                           int sub, bool vec) {
  int best = 0;
  const u32* hi = row + C;
  if (vec) {
    const uint4* hi4 = reinterpret_cast<const uint4*>(hi);
    int nv = C >> 2;
    for (int s0 = sub; s0 < nv; s0 += 4 * K7_LANES) {
      uint4 h[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        int s = s0 + u * K7_LANES;
        h[u] = s < nv ? __ldg(hi4 + s) : make_uint4(~t_hi, ~t_hi, ~t_hi, ~t_hi);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        u32 w[4] = {h[u].x, h[u].y, h[u].z, h[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (w[e] == t_hi) {
            u32 xl = __ldg(row + 4 * (s0 + u * K7_LANES) + e) ^ t_lo;
            if ((xl & above) == 0) best = max(best, (int)xl);
          }
        }
      }
    }
  } else {
    for (int j = sub; j < C; j += K7_LANES) {
      if (__ldg(hi + j) == t_hi) {
        u32 xl = __ldg(row + j) ^ t_lo;
        if ((xl & above) == 0) best = max(best, (int)xl);
      }
    }
  }
  return best;
}

__global__ void __launch_bounds__(K7_THREADS)
chunk_probe_kernel(const u32* __restrict__ slots, const u64* __restrict__ q,
                   const int* __restrict__ list, const int* __restrict__ ctr,
                   int nbins, int* __restrict__ out, int C, int m1, int lb,
                   long long start_row, int use_stash, int vec) {
  const int total = __ldcg(&ctr[2 * nbins + 1]);
  const int sub = threadIdx.x & (K7_LANES - 1);
  const unsigned gmask = 0xFFu << (threadIdx.x & 31 & ~(K7_LANES - 1));
  const long long G = (long long)gridDim.x * (K7_THREADS / K7_LANES);
  const u64 qmask = (1ull << (64 - m1)) - 1;
  const u32 above = ~((1u << lb) - 1);
  long long j = blockIdx.x * (long long)(K7_THREADS / K7_LANES) +
                threadIdx.x / K7_LANES;
  // the group's query index and value, fetched one query ahead
  int qi = j < total ? __ldg(list + j) : 0;
  u64 x = j < total ? __ldg(q + qi) : 0;
  for (; j < total; j += G) {  // uniform across the 8 lanes of a group
    int cur = qi;
    u64 mixed = x * MIX1;
    if (j + G < total) {
      qi = __ldg(list + j + G);
      x = __ldg(q + qi);
    }
    long long lrow = (long long)(mixed >> (64 - m1)) - start_row;
    u64 t = (mixed & qmask) << lb;
    int best = k7_scan_row(slots + (u64)lrow * (u64)(2 * C), C, (u32)t,
                           (u32)(t >> 32), above, sub, vec != 0);
#pragma unroll
    for (int o = K7_LANES / 2; o; o >>= 1)
      best = max(best, __shfl_xor_sync(gmask, best, o));
    if (sub == 0 && best > 0)
      out[cur] = use_stash ? max(best, out[cur]) : best;
  }
}

// ---------------------------------------------------------------- K2, K8
// K2 replaces radix_table.py:393 probe (_probe_rows :332 + _stash_lookup
// :359), and with an all-EMPTY stash exactly what exp_probe_pallas
// computes; K8 replaces radix_table.py:602 probe_dense, max(plane 1 with
// MIX1 and m1, plane 2 with MIX2 and m2, the stash).  Label+1 per query,
// 0 on a miss.
//
// Bound by bytes: the queries read once, the hi half (C x 4 B) of each
// distinct row they touch once, one 32-B sector of lo words where a hi
// word matched, the labels written once.  A batch probes ~7 queries per
// row (7.3M queries over 2^20 rows), so a warp per query that reads its
// whole row moves ~14x the bound's bytes, and K7's L2-sized bins alone
// (each query reading its own hi half from L2) still ~7x.  So the queries
// are grouped by row and each row's hi half is read once for all of them.
// What bounds the design now is the walk (b): its compares, which the
// rows' DRAM reads only partly overlap (PERF.md).
//
// The partition, one level into nbins bins of bucket >> bshift, is four
// launches; past G_COARSE bins it runs twice, first into the coarse bins
// (bin >> G_COARSE_BITS), then from that coarse order into the bins, so
// that each level writes long runs a bin (one level into 4,096 bins wrote
// 4-12 B pieces all over a list larger than the L2, several times slower):
//
//   (a1) group_count: block b counts the queries of its contiguous slice
//        in each bin in shared memory and writes the counts to column b
//        of a [nbins, G] matrix.  No global atomics: at 4,096 bins, one
//        atomic per bin per block dominated the pass.
//   (a2) group_offsets: a warp per bin scans its row of the matrix into
//        each block's offset inside the bin, and the bin's total.
//   (a3) group_tiles: one block scans the totals into bin starts and the
//        first tile of each bin (a bin of n queries takes ceil(n/G_TILE)).
//   (a4) group_scatter: block b again, over the same slice, in tiles of
//        G_PART_TILE sorted by bin in shared memory, so each bin's run of
//        a tile leaves as consecutive stores: each query's index and mixed
//        key (so (b) reads them in order, not q by index), and from q the
//        stash answer into out[qi] (plane 1; the stash in shared memory).
//   (b)  group_probe: a block per tile of G_TILE queries of one bin (4,096
//        bins of 2^shift rows, kernels.group_bins: ~1,800 queries a bin at
//        7.3M) on a persistent grid, so a hot bin spreads over many blocks.
//        The block counting-sorts its tile by local row in shared memory
//        (a permutation).  Its warps walk the sorted tile in segments of
//        32 queries, the next segment's rows prefetched into L2; a
//        segment's runs of one row each load the row's hi half once into
//        registers (one 16-B load a lane at C = 128, three runs in flight),
//        and each query of the run is compared against it with one ballot,
//        which lane j keeps for query j.  After the segment each lane
//        finds its query's matching hi word from the ballot (re-reading
//        only those lanes' 16 B, from L1) and reads its lo word; the lo
//        word is used after the next segment's rows are in flight, so a hit
//        costs no latency of its own.  Several matching hi words (a rare
//        false match beside a hit) make the lane scan its row alone.  A
//        hit is atomicMax'ed into out[qi].  A row whose queries straddle
//        two segments or tiles is read twice (from L1 or L2): still exact,
//        since the answer is a max, and a hot row of thousands of queries
//        is split over as many warps.  Rows that are not 16-B vectors of
//        at most 128 words (C % 4 != 0 or C > 128) take a lane per query,
//        each scanning its row's hi half through L1.
//
// Hi first is exact: a hit needs x_hi == 0, and an EMPTY slot's hi half
// (0xFFFFFFFF) never equals t_hi, since lb < m keeps qlow << lb below 2^63.
//
// K8's plane 2 holds the few keys plane 1's buckets overflow: 2^m2 rows,
// nearly empty and hot (~115,000 queries a row at config 2, m2 = 6, 9 hi
// matches in 7.3M queries).  Where its slots fit G_LOCAL_BYTES of hi words
// (kernels.plane2_form "local"), plane2_local_kernel below compares each
// query with its row's occupied slots only, staged in shared memory.  Else
// (a1)-(b) run again with MIX2 and no stash, reusing the scratch after
// plane 1's probe (stream order).
#define G_THREADS 256
#define G_TILE 2048          // queries a block sorts at once
#define G_LOAD 4             // tile entries a thread loads at once
#define G_KEY_BITS 13        // counting-sort keys of a tile: 8,192, 32 KiB
#define G_LOCAL_BYTES (32 * 1024)
#define G_PART_THREADS 512   // (a1) and (a4)
#define G_PART_QPT 8         // queries a thread has in flight there
#define G_PART_TILE (G_PART_THREADS * G_PART_QPT)
#define G_COARSE_BITS 6      // a partition past 64 bins takes two levels
#define G_COARSE (1 << G_COARSE_BITS)
#define EMPTY32 0xFFFFFFFFu

__device__ __forceinline__ int group_bin(u64 mixed, int m, int shift) {
  return (int)(mixed >> (64 - m) >> shift);
}

// (a1): cnt [nbins, gridDim.x]; bin = bucket >> bshift, the query's mixed
// key x * MIX from q or, from the level before (PAIRS), as carried
template <u64 MIX, bool PAIRS>
__global__ void __launch_bounds__(G_PART_THREADS)
group_count_kernel(const u64* __restrict__ src, long long Q, long long slice,
                   int m, int bshift, int nbins, int* __restrict__ cnt) {
  extern __shared__ int hist[];  // [nbins]
  for (int j = threadIdx.x; j < nbins; j += G_PART_THREADS) hist[j] = 0;
  __syncthreads();
  long long i0 = blockIdx.x * slice, i1 = min(Q, i0 + slice);
  for (long long base = i0; base < i1; base += G_PART_THREADS * G_PART_QPT) {
    u64 mx[G_PART_QPT];
#pragma unroll
    for (int u = 0; u < G_PART_QPT; ++u) {
      long long i = base + u * G_PART_THREADS + threadIdx.x;
      mx[u] = i < i1 ? (PAIRS ? __ldg(src + i) : __ldg(src + i) * MIX) : 0;
    }
#pragma unroll
    for (int u = 0; u < G_PART_QPT; ++u)
      if (base + u * G_PART_THREADS + threadIdx.x < i1)
        atomicAdd(&hist[group_bin(mx[u], m, bshift)], 1);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nbins; j += G_PART_THREADS)
    cnt[(long long)j * gridDim.x + blockIdx.x] = hist[j];
}

// (a2): each row of cnt [nbins, G] scanned in place, its sum to tot[bin]
__global__ void __launch_bounds__(G_THREADS)
group_offsets_kernel(int* __restrict__ cnt, int G, int nbins,
                     int* __restrict__ tot) {
  int j = blockIdx.x * (G_THREADS / 32) + (threadIdx.x >> 5);
  int lane = threadIdx.x & 31;
  if (j >= nbins) return;  // uniform across the warp
  int* c = cnt + (long long)j * G;
  int run = 0;
  for (int b0 = 0; b0 < G; b0 += 32) {
    int v = b0 + lane < G ? c[b0 + lane] : 0;
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (b0 + lane < G) c[b0 + lane] = run + incl - v;
    run += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) tot[j] = run;
}

// (a3): ctr = [nbins] totals, [nbins] bin starts, [nbins + 1] tile starts
// (the last is the tile count)
__global__ void __launch_bounds__(1024)
group_tiles_kernel(int* __restrict__ ctr, int nbins) {
  __shared__ int part[2][32];
  const int* tot = ctr;
  int* start = ctr + nbins;
  int* ts = ctr + 2 * nbins;
  int per = (nbins + 1023) / 1024;
  int b0 = threadIdx.x * per, b1 = min(b0 + per, nbins);
  int own_q = 0, own_t = 0;
  for (int b = b0; b < b1; ++b) {
    own_q += tot[b];
    own_t += (tot[b] + G_TILE - 1) / G_TILE;
  }
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int iq = own_q, it = own_t;
  for (int o = 1; o < 32; o <<= 1) {
    int u = __shfl_up_sync(0xffffffffu, iq, o);
    int v = __shfl_up_sync(0xffffffffu, it, o);
    if (lane >= o) {
      iq += u;
      it += v;
    }
  }
  if (lane == 31) {
    part[0][warp] = iq;
    part[1][warp] = it;
  }
  __syncthreads();
  int rq = iq - own_q, rt = it - own_t;
  for (int w = 0; w < warp; ++w) {
    rq += part[0][w];
    rt += part[1][w];
  }
  for (int b = b0; b < b1; ++b) {
    start[b] = rq;
    ts[b] = rt;
    rq += tot[b];
    rt += (tot[b] + G_TILE - 1) / G_TILE;
  }
  if (threadIdx.x == 1023) ts[nbins] = rt;
}

// Exclusive scan of a[0, n) in shared memory by a whole block of THREADS
// threads (part: THREADS / 32 ints).
template <int THREADS>
__device__ __forceinline__ void block_exclusive_scan(int* a, int n,
                                                     int* part) {
  int per = (n + THREADS - 1) / THREADS;
  int j0 = threadIdx.x * per, j1 = min(j0 + per, n);
  int own = 0;
  for (int j = j0; j < j1; ++j) own += a[j];
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int incl = own;
  for (int o = 1; o < 32; o <<= 1) {
    int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  int run = incl - own;
  for (int w = 0; w < warp; ++w) run += part[w];
  for (int j = j0; j < j1; ++j) {
    int c = a[j];
    a[j] = run;
    run += c;
  }
  __syncthreads();
}

// (a4): each query's index and mixed key appended to its bin.  From q
// (!PAIRS) it also answers the stash into out[qi] (out null: plane 2,
// which has none); from the level before (PAIRS) the index is src_list's.
// A tile of G_PART_TILE queries is first sorted by bin in shared memory,
// so each bin's run of the tile leaves as consecutive stores, not stores
// scattered a query at a time across the bins.
template <u64 MIX, bool PAIRS>
__global__ void __launch_bounds__(G_PART_THREADS)
group_scatter_kernel(const u64* __restrict__ src,
                     const int* __restrict__ src_list, long long Q,
                     long long slice, int m, int bshift, int nbins,
                     const int* __restrict__ cnt, const int* __restrict__ ctr,
                     const u64* __restrict__ stash_keys,
                     const int* __restrict__ stash_labels,
                     int* __restrict__ out, int* __restrict__ list,
                     u64* __restrict__ keys) {
  extern __shared__ u64 p_smem[];
  u64* st_key = p_smem;                      // [G_PART_TILE] staged keys
  int* st_qi = (int*)(st_key + G_PART_TILE);  // [G_PART_TILE] staged indices
  int* cur = st_qi + G_PART_TILE;             // [nbins] the block's cursors
  int* off = cur + nbins;                     // [nbins + 1] tile offsets
  int* delta = off + nbins + 1;               // [nbins] cursor - offset
  __shared__ u64 sk[STASH_CAP];
  __shared__ int sl[STASH_CAP];
  __shared__ int n_stash;
  __shared__ int part[G_PART_THREADS / 32];
  const int* start = ctr + nbins;
  for (int j = threadIdx.x; j < nbins; j += G_PART_THREADS)
    cur[j] = start[j] + cnt[(long long)j * gridDim.x + blockIdx.x];
  if (!PAIRS && out && threadIdx.x == 0) {  // drop the padding: EMPTY keys
    int n = 0;                              // that carry label 0
    for (int j = 0; j < STASH_CAP; ++j) {
      u64 key = stash_keys[j];
      if (key != EMPTY64 || stash_labels[j] != 0) {
        sk[n] = key;
        sl[n++] = stash_labels[j];
      }
    }
    n_stash = n;
  }
  long long i0 = blockIdx.x * slice, i1 = min(Q, i0 + slice);
  for (long long base = i0; base < i1; base += G_PART_TILE) {
    const int n = (int)min((long long)G_PART_TILE, i1 - base);
    // the tile's bins: all, or from the level before (in coarse order) the
    // fine bins of its first to its last entry's coarse bin
    int b0 = 0, b1 = nbins;
    if (PAIRS) {
      b0 = group_bin(__ldg(src + base), m, bshift) >> G_COARSE_BITS
                                                   << G_COARSE_BITS;
      b1 = min(nbins, ((group_bin(__ldg(src + base + n - 1), m, bshift) >>
                        G_COARSE_BITS) + 1) << G_COARSE_BITS);
    }
    for (int j = b0 + threadIdx.x; j < b1; j += G_PART_THREADS) off[j] = 0;
    __syncthreads();  // also publishes the stash and the cursors
    u64 mixed[G_PART_QPT];  // the thread's loads in flight together
    int qi[G_PART_QPT], rank[G_PART_QPT];
#pragma unroll
    for (int u = 0; u < G_PART_QPT; ++u) {
      int e = u * G_PART_THREADS + threadIdx.x;
      if (e < n) {
        mixed[u] = __ldg(src + base + e);
        qi[u] = PAIRS ? __ldg(src_list + base + e) : (int)(base + e);
      }
    }
#pragma unroll
    for (int u = 0; u < G_PART_QPT; ++u) {
      if (u * G_PART_THREADS + threadIdx.x >= n) continue;
      if (!PAIRS) {
        u64 x = mixed[u];
        if (out) {
          int best = 0;
          for (int j = 0; j < n_stash; ++j)
            if (sk[j] == x) best = max(best, sl[j]);
          out[qi[u]] = best;
        }
        mixed[u] = x * MIX;
      }
      rank[u] = atomicAdd(&off[group_bin(mixed[u], m, bshift)], 1);
    }
    __syncthreads();
    // the tile's offsets; each bin's cursor moves past its run, and delta
    // maps a staged slot to its place in the list
    block_exclusive_scan<G_PART_THREADS>(off + b0, b1 - b0, part);
    for (int j = b0 + threadIdx.x; j < b1; j += G_PART_THREADS) {
      delta[j] = cur[j] - off[j];
      cur[j] += (j + 1 < b1 ? off[j + 1] : n) - off[j];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < G_PART_QPT; ++u) {
      if (u * G_PART_THREADS + threadIdx.x >= n) continue;
      int p = off[group_bin(mixed[u], m, bshift)] + rank[u];
      st_key[p] = mixed[u];
      st_qi[p] = qi[u];
    }
    __syncthreads();
    for (int p = threadIdx.x; p < n; p += G_PART_THREADS) {
      u64 key = st_key[p];
      int pos = delta[group_bin(key, m, bshift)] + p;
      list[pos] = st_qi[p];
      keys[pos] = key;
    }
    __syncthreads();  // before the next tile reuses off and the staging
  }
}

// The largest hit label of one query in its row (0 = none), the lane
// alone scanning the hi half (through L1) and a lo word behind each
// matching hi word.
__device__ __forceinline__ int scan_row_alone(const u32* __restrict__ row,
                                              int C, u32 t_lo, u32 t_hi,
                                              u32 above) {
  int best = 0;
  for (int c = 0; c < C; ++c)
    if (__ldg(row + C + c) == t_hi) {
      u32 xl = __ldg(row + c) ^ t_lo;
      if ((xl & above) == 0) best = max(best, (int)xl);
    }
  return best;
}

// The lane's 4 words of a row's hi half (vec, C <= 128), EMPTY past it.
__device__ __forceinline__ uint4 load_hi4(const u32* __restrict__ row, int C,
                                          int lane) {
  return lane < (C >> 2)
             ? __ldg(reinterpret_cast<const uint4*>(row + C) + lane)
             : make_uint4(EMPTY32, EMPTY32, EMPTY32, EMPTY32);
}

// Next run start of a segment from the mask of those not taken yet.
__device__ __forceinline__ int take_start(unsigned& rest, int end) {
  if (!rest) return end;
  int s = __ffs(rest) - 1;
  rest &= rest - 1;
  return s;
}

// (b).  Tile t of bin b is that bin's part of list/keys.  A tile sorts by
// local row >> kshift (kshift > 0 only
// past 2^G_KEY_BITS rows a bin: runs then interleave a few rows, each
// change of row reloads it, still exact).
__global__ void __launch_bounds__(G_THREADS)
group_probe_kernel(const u32* __restrict__ slots,
                   const int* __restrict__ list, const u64* __restrict__ keys,
                   const int* __restrict__ ctr, int nbins, int shift,
                   int kshift, int* __restrict__ out, int C, int m, int lb,
                   int vec) {
  extern __shared__ u64 g_smem[];
  u64* s_t = g_smem;                                 // [G_TILE] qlow << lb
  int* s_qi = (int*)(s_t + G_TILE);                  // [G_TILE] query index
  int* s_row = s_qi + G_TILE;                        // [G_TILE] local row
  unsigned short* s_rank = (unsigned short*)(s_row + G_TILE);  // [G_TILE]
  unsigned short* perm = s_rank + G_TILE;            // [G_TILE] sorted
  int* cnt = (int*)(perm + G_TILE);                  // [1 << (shift-kshift)]
  __shared__ int part[G_THREADS / 32];
  const int nkeys = 1 << (shift - kshift);
  const int* start = ctr + nbins;
  const int* ts = ctr + 2 * nbins;
  const int n_tiles = __ldg(ts + nbins);
  const u64 qmask = (1ull << (64 - m)) - 1;  // 1 <= m <= 62
  const u64 rmask = (1ull << shift) - 1;
  const u32 above = ~((1u << lb) - 1);
  const bool fast = vec && C <= 128;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const u64 stride = 2 * (u64)C;
  // a lo word read at the end of the last segment, used in the next
  int pend_qi = -1;
  u32 pend_lo = 0, pend_tlo = 0;

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int lo = 0, hi = nbins - 1;  // the bin with ts[bin] <= t < ts[bin + 1]
    while (lo < hi) {
      int mid = (lo + hi + 1) >> 1;
      if (__ldg(ts + mid) <= t) lo = mid;
      else hi = mid - 1;
    }
    const int k = t - __ldg(ts + lo);
    const long long base = (long long)__ldg(start + lo) + (long long)k * G_TILE;
    const int n = min(G_TILE, __ldg(ctr + lo) - k * G_TILE);
    const long long row0 = (long long)lo << shift;

    for (int j = threadIdx.x; j < nkeys; j += G_THREADS) cnt[j] = 0;
    __syncthreads();
    for (int e0 = threadIdx.x; e0 < n; e0 += G_THREADS * G_LOAD) {
      int qi[G_LOAD];  // G_LOAD of the thread's loads in flight at once
      u64 mx[G_LOAD];
#pragma unroll
      for (int u = 0; u < G_LOAD; ++u) {
        int e = e0 + u * G_THREADS;
        if (e < n) {
          qi[u] = __ldg(list + base + e);
          mx[u] = __ldg(keys + base + e);
        }
      }
#pragma unroll
      for (int u = 0; u < G_LOAD; ++u) {
        int e = e0 + u * G_THREADS;
        if (e < n) {
          int r = (int)((mx[u] >> (64 - m)) & rmask);
          s_qi[e] = qi[u];
          s_row[e] = r;
          s_t[e] = (mx[u] & qmask) << lb;
          s_rank[e] = (unsigned short)atomicAdd(&cnt[r >> kshift], 1);
        }
      }
    }
    __syncthreads();
    block_exclusive_scan<G_THREADS>(cnt, nkeys, part);
    for (int e = threadIdx.x; e < n; e += G_THREADS)
      perm[cnt[s_row[e] >> kshift] + s_rank[e]] = (unsigned short)e;
    __syncthreads();

    for (int s0 = warp * 32; s0 < n; s0 += G_THREADS) {  // warp-uniform
      const int end = min(n - s0, 32);
      const bool mine = lane < end;
      const int e = mine ? perm[s0 + lane] : 0;
      const int r = mine ? s_row[e] : -1;
      const u64 my_t = mine ? s_t[e] : 0;
      const u32 t_lo = (u32)my_t, t_hi = (u32)(my_t >> 32);
      const u32* my_row = slots + (u64)(row0 + max(r, 0)) * stride;
      if (!fast) {  // a lane per query
        int best = mine ? scan_row_alone(my_row, C, t_lo, t_hi, above) : 0;
        if (best > 0) atomicMax(out + s_qi[e], best);
        continue;
      }
      {  // the rows of the warp's next segment on their way to L2
        int s1 = s0 + G_THREADS + lane;
        int r1 = s1 < n ? s_row[perm[s1]] : -1;
        int p1 = __shfl_up_sync(0xffffffffu, r1, 1);
        if (r1 >= 0 && (lane == 0 || r1 != p1))
          asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(
                           slots + (u64)(row0 + r1) * stride + C),
                       "r"(C * 4)
                       : "memory");
      }
      const int prev = __shfl_up_sync(0xffffffffu, r, 1);
      unsigned rest =
          __ballot_sync(0xffffffffu, mine && (lane == 0 || r != prev));
      rest &= rest - 1;  // lane 0 starts the first run
      // runs [a, b), [b, c), [c, ...) with their rows' hi halves in flight
      int a = 0, b = take_start(rest, end), c = take_start(rest, end);
      auto row_of = [&](int s) {  // the row of the run starting at s
        return slots +
               (u64)(row0 + __shfl_sync(0xffffffffu, r, s & 31)) * stride;
      };
      uint4 ha = load_hi4(row_of(a), C, lane);
      uint4 hb = b < end ? load_hi4(row_of(b), C, lane) : ha;
      uint4 hc = c < end ? load_hi4(row_of(c), C, lane) : ha;
      if (pend_qi >= 0) {  // the last segment's lo word, now arrived
        u32 xl = pend_lo ^ pend_tlo;
        if ((xl & above) == 0 && xl) atomicMax(out + pend_qi, (int)xl);
        pend_qi = -1;
      }
      unsigned hits = 0;  // lane j: the lanes holding query j's t_hi
      for (;;) {
#pragma unroll 4
        for (int j = a; j < b; ++j) {
          u32 qhi = __shfl_sync(0xffffffffu, t_hi, j);
          unsigned any = __ballot_sync(
              0xffffffffu,
              ha.x == qhi || ha.y == qhi || ha.z == qhi || ha.w == qhi);
          if (lane == j) hits = any;
        }
        if (b >= end) break;
        a = b;
        b = c;
        c = take_start(rest, end);
        ha = hb;
        hb = hc;
        if (c < end) hc = load_hi4(row_of(c), C, lane);
      }
      if (hits) {  // each lane its own query: which words matched (from L1)
        int word = -1, n_match = 0;
        for (unsigned h = hits; h; h &= h - 1) {
          int l = __ffs(h) - 1;
          uint4 v = __ldg(reinterpret_cast<const uint4*>(my_row + C) + l);
          u32 w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (w[u] == t_hi) {
              word = 4 * l + u;
              ++n_match;
            }
        }
        if (n_match == 1) {  // its lo word, used in the next segment
          pend_qi = s_qi[e];
          pend_lo = __ldg(my_row + word);
          pend_tlo = t_lo;
        } else {  // a false hi match beside another: rare
          int best = scan_row_alone(my_row, C, t_lo, t_hi, above);
          if (best > 0) atomicMax(out + s_qi[e], best);
        }
      }
    }
    __syncthreads();  // before the next tile rewrites the shared arrays
  }
  if (pend_qi >= 0) {
    u32 xl = pend_lo ^ pend_tlo;
    if ((xl & above) == 0 && xl) atomicMax(out + pend_qi, (int)xl);
  }
}

// K8's plane 2 in the local form: every block stages the plane's occupied
// slots in shared memory, compacted row by row (an EMPTY slot's hi half
// never equals t_hi, so skipping it is exact), and a thread per query
// compares its t_hi against its row's occupied slots only: plane 2 holds
// the few keys plane 1 overflows, so its rows are nearly empty.  The max
// goes into out[qi] after plane 1's probe, in stream order.
__global__ void __launch_bounds__(G_THREADS)
plane2_local_kernel(const u32* __restrict__ slots2, const u64* __restrict__ q,
                    int* __restrict__ out, long long Q, int C, int m2,
                    int lb) {
  extern __shared__ u32 p2_smem[];
  const int rows = 1 << m2, pitch = C + 1;  // odd: rows on distinct banks
  u32* shi = p2_smem;                       // [rows, pitch] occupied hi words
  u32* slo = shi + rows * pitch;            // [rows, pitch] their lo words
  int* scnt = (int*)(slo + rows * pitch);   // [rows]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += G_THREADS / 32) {  // a warp a row
    const u32* row = slots2 + (u64)r * 2 * C;
    int n = 0;
#pragma unroll 4
    for (int c0 = 0; c0 < C; c0 += 32) {
      int c = c0 + lane;
      u32 h = c < C ? __ldg(row + C + c) : EMPTY32;
      unsigned occ = __ballot_sync(0xffffffffu, h != EMPTY32);
      if (h != EMPTY32) {
        int at = r * pitch + n + __popc(occ & ((1u << lane) - 1));
        shi[at] = h;
        slo[at] = __ldg(row + c);
      }
      n += __popc(occ);
    }
    if (lane == 0) scnt[r] = n;
  }
  __syncthreads();
  const u64 qmask = (1ull << (64 - m2)) - 1;  // 1 <= m2 <= 13
  const u32 above = ~((1u << lb) - 1);
  const long long stride = (long long)gridDim.x * G_THREADS;
  for (long long i0 = blockIdx.x * (long long)G_THREADS + threadIdx.x; i0 < Q;
       i0 += 4 * stride) {
    u64 x[4];  // four queries' loads in flight
#pragma unroll
    for (int u = 0; u < 4; ++u)
      x[u] = i0 + u * stride < Q ? __ldg(q + i0 + u * stride) : 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      long long i = i0 + u * stride;
      if (i >= Q) break;
      u64 mixed = x[u] * MIX2;
      int r = (int)(mixed >> (64 - m2));
      u64 t = (mixed & qmask) << lb;
      u32 t_lo = (u32)t, t_hi = (u32)(t >> 32);
      int best = 0;
      for (int j = r * pitch, e = j + scnt[r]; j < e; ++j)
        if (shi[j] == t_hi) {
          u32 xl = slo[j] ^ t_lo;
          if ((xl & above) == 0) best = max(best, (int)xl);
        }
      if (best > 0 && best > out[i]) out[i] = best;
    }
  }
}

// ---------------------------------------------------------------- K3, K4
// Per read: the count of each nonzero label, then the top two labels under
// (count desc, label asc) -- the reference's resultKernel order
// (CuClarkDB.cu:1361-1411).  The block form: one block per read.  A row
// may hold millions of windows, so nothing assumes it fits shared memory:
// the block first finds the row's positive label range [lo, hi], then
// histograms it in shared-memory chunks of K3_HIST labels (one pass over
// the row per chunk) and merges each chunk's top two into a running top
// two.  Bound by the row reads (once, plus once per chunk) and the
// shared-memory atomics, and its cost grows with the label range.  K3
// takes it only for rows wider than K3_TILE_W at more than K5_SMALL_T1 - 1
// targets (kernels.top2_form); its warp forms follow K5's section.
//
// K4's block form (SORTED; rows wider than K4_WARP_W, kernels.sort_form)
// also writes the row's labels sorted ascending, zeros first, as u16 -- a
// counting sort from the same histograms: W - total zeros, then each
// chunk's labels at offsets from a block scan of the chunk's histogram.
// Each output position finds its label by a binary search of the scanned
// histogram, so the writes are coalesced whatever the run lengths.  It
// adds one row write (2 B per window) to K3's traffic.  K4's rows up to
// K4_WARP_W take the warp form below.
#define K3_THREADS 128
#define K3_WARPS (K3_THREADS / 32)
#define K3_HIST 8192
#define K4_SPAN (K3_HIST / K3_THREADS)  // histogram entries scanned a thread

// (count desc, label asc) as one u64: larger key ranks higher; 0 = none
__device__ __forceinline__ u64 rank_key(int count, int label) {
  return ((u64)(u32)count << 32) | (u64)(0xFFFFFFFFu - (u32)label);
}

// Top two of two disjoint top-two lists (a1 >= a2, b1 >= b2).  Keys are
// u64 from rank_key, or u32 from rank_key16 (K4's warp form).
template <typename K>
__device__ __forceinline__ void merge2(K& a1, K& a2, K b1, K b2) {
  K n1 = max(a1, b1);
  K n2 = max(min(a1, b1), max(a2, b2));
  a1 = n1;
  a2 = n2;
}

// Block-wide top two of each thread's (a1, a2), valid in thread 0.
__device__ __forceinline__ void block_merge2(u64& a1, u64& a2, u64* s1,
                                             u64* s2) {
  for (int o = 16; o; o >>= 1) {
    u64 b1 = __shfl_xor_sync(0xffffffffu, a1, o);
    u64 b2 = __shfl_xor_sync(0xffffffffu, a2, o);
    merge2(a1, a2, b1, b2);
  }
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s1[warp] = a1;
    s2[warp] = a2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < K3_WARPS; ++w) merge2(a1, a2, s1[w], s2[w]);
  }
  __syncthreads();
}

// Top two of each lane's (a1, a2) across the warp, in every lane.
template <typename K>
__device__ __forceinline__ void warp_merge2(K& a1, K& a2) {
  for (int o = 16; o; o >>= 1) {
    K b1 = __shfl_xor_sync(0xffffffffu, a1, o);
    K b2 = __shfl_xor_sync(0xffffffffu, a2, o);
    merge2(a1, a2, b1, b2);
  }
}

template <typename K>
__device__ __forceinline__ void push_top2(K& a1, K& a2, K key) {
  if (key > a1) {
    a2 = a1;
    a1 = key;
  } else if (key > a2) {
    a2 = key;
  }
}

// Writes the top two (keys from rank_key) as the five result scalars.
__device__ __forceinline__ void store_top2(long long r, int cnt, u64 top1,
                                           u64 top2, int* total, int* ibest,
                                           int* best, int* isbest,
                                           int* sbest) {
  total[r] = cnt;
  best[r] = (int)(top1 >> 32);
  ibest[r] = top1 ? (int)(0xFFFFFFFFu - (u32)top1) : 0;
  sbest[r] = (int)(top2 >> 32);
  isbest[r] = top2 ? (int)(0xFFFFFFFFu - (u32)top2) : 0;
}

template <bool SORTED>
__global__ void __launch_bounds__(K3_THREADS)
top2_kernel(const int* __restrict__ lab, long long W, int* __restrict__ total,
            int* __restrict__ ibest, int* __restrict__ best,
            int* __restrict__ isbest, int* __restrict__ sbest,
            unsigned short* __restrict__ sorted) {
  __shared__ int hist[K3_HIST];
  __shared__ u64 s1[K3_WARPS], s2[K3_WARPS];
  __shared__ int s_cnt[K3_WARPS], s_lo[K3_WARPS], s_hi[K3_WARPS];
  __shared__ int row_lo, row_hi, row_cnt;
  const int* row = lab + (long long)blockIdx.x * W;
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  int cnt = 0, lo = 0x7FFFFFFF, hi = 0;
  for (long long j = threadIdx.x; j < W; j += K3_THREADS) {
    int v = row[j];
    if (v > 0) {
      ++cnt;
      lo = min(lo, v);
      hi = max(hi, v);
    }
  }
  for (int o = 16; o; o >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    s_cnt[warp] = cnt;
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < K3_WARPS; ++w) {
      cnt += s_cnt[w];
      lo = min(lo, s_lo[w]);
      hi = max(hi, s_hi[w]);
    }
    row_lo = lo;
    row_hi = hi;
    row_cnt = cnt;
  }
  __syncthreads();
  lo = row_lo;
  hi = row_hi;
  cnt = row_cnt;

  unsigned short* srow = nullptr;
  long long pos = 0;  // next sorted position (uniform across the block)
  if (SORTED) {
    srow = sorted + (long long)blockIdx.x * W;
    pos = W - cnt;
    for (long long j = threadIdx.x; j < pos; j += K3_THREADS) srow[j] = 0;
  }

  u64 top1 = 0, top2 = 0;  // running result, meaningful in thread 0
  for (long long base = lo; base <= hi; base += K3_HIST) {
    int span = (int)min((long long)K3_HIST, hi - base + 1);
    for (int j = threadIdx.x; j < span; j += K3_THREADS) hist[j] = 0;
    __syncthreads();
    for (long long j = threadIdx.x; j < W; j += K3_THREADS) {
      long long d = (long long)row[j] - base;
      if (d >= 0 && d < span) atomicAdd(&hist[d], 1);
    }
    __syncthreads();
    // labels ascend within each thread, so strict '>' keeps the lower
    // label on equal counts; keys of distinct labels never tie
    u64 a1 = 0, a2 = 0;
    for (int j = threadIdx.x; j < span; j += K3_THREADS) {
      int c = hist[j];
      if (c > 0) {
        u64 key = rank_key(c, (int)(base + j));
        if (key > a1) {
          a2 = a1;
          a1 = key;
        } else if (key > a2) {
          a2 = key;
        }
      }
    }
    block_merge2(a1, a2, s1, s2);  // ends with __syncthreads: hist reusable
    if (threadIdx.x == 0) merge2(top1, top2, a1, a2);
    if (SORTED) {
      // inclusive scan of hist[0, span) in place: thread t owns the
      // K4_SPAN entries from t * K4_SPAN; s_cnt holds the warp totals
      int j0 = threadIdx.x * K4_SPAN, j1 = min(j0 + K4_SPAN, span);
      int own = 0;
      for (int j = j0; j < j1; ++j) own += hist[j];
      int incl = own;
      for (int o = 1; o < 32; o <<= 1) {
        int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      if (lane == 31) s_cnt[warp] = incl;
      __syncthreads();
      int run = incl - own;
      for (int w = 0; w < warp; ++w) run += s_cnt[w];
      for (int j = j0; j < j1; ++j) {
        run += hist[j];
        hist[j] = run;
      }
      __syncthreads();
      int in_chunk = hist[span - 1];
      for (int p = threadIdx.x; p < in_chunk; p += K3_THREADS) {
        int a = 0, b = span - 1;  // first j with hist[j] > p
        while (a < b) {
          int m = (a + b) >> 1;
          if (hist[m] > p) b = m;
          else a = m + 1;
        }
        srow[pos + p] = (unsigned short)(base + a);
      }
      pos += in_chunk;
      __syncthreads();  // hist and s_cnt are rewritten by the next chunk
    }
  }
  if (threadIdx.x == 0)
    store_top2(blockIdx.x, cnt, top1, top2, total, ibest, best, isbest,
               sbest);
}

// ------------------------------------------------------- K4, warp form
// Replaces device_pipeline.py:155-158 (lax.sort of each read's labels, then
// score.py:57 top2_from_sorted) for rows of W <= K4_WARP_W windows, the
// classify batches' widths.  The bytes bound at the config-2 shape
// (R = 32,768, W = 224: the 29 MB label read and the 14.7 MB u16 write) is
// 0.0133 ms.  The block form above was bound by latency instead: a
// 128-thread block held under two labels a thread and ran five to seven
// __syncthreads phases per 8,192-label chunk of the row's range (0.107 ms
// on an H100 SXM at 700 W).  Here a warp holds one
// read and K4_WARPS reads share a block, with no block-wide phase but the
// final store.  What is left bounds it by instruction issue, mostly the
// sorting network's compare-exchanges and shuffles: 901 SASS instructions
// a read at W = 224 (R = 4), 0.039 ms, some 7.5e11 warp instructions a
// second, near three quarters of the card's four a clock per SM
// (chip_smoke.py phase 5).  The design keeps that count low:
//
//   - Keys: labels below 65,536 ride two to a 32-bit register (P = 2), so
//     one min.u16x2 / max.u16x2 or one shuffle serves two keys.  Register
//     s of lane l holds key l * R + s in its low half and M + l * R + s in
//     its high half (M = 32 R, N = 2M >= W).  Pads are 0xFFFF, no smaller
//     than any label, so the first W sorted places hold the row's own
//     multiset.  P = 1 (one u32 key a register, pads 2^32 - 1) is the form
//     for wider labels, such as K3's.
//   - Sort: a bitonic network over the register index space (lane * R +
//     s): strides below R compare registers of one lane, the others
//     exchange one register per lane with __shfl_xor_sync.  The halves see
//     the same compares up to level M, where the high half must run
//     descending: its keys are complemented (x ^ 0xFFFF) for that level.
//     The last level compares the halves inside each register, then runs
//     the strides below M ascending.  Nothing depends on the labels' range.
//   - Runs: a lane's registers hold two runs of consecutive sorted places
//     (one a half), so a run starts where a key differs from the one
//     before it (the previous lane's last key, or the low half's last for
//     lane 0's high half) and ends at the next start: the lane's own, or
//     the first start of a later segment (suffix minima over the warp).
//     Each positive run pushes its rank (count desc, label asc: the
//     reference's tie-break; a u32 for 16-bit labels) into the lane's top
//     two, and warp_merge2 merges them.
//   - Store (SORTED): the block's rows are one span of `sorted`, staged in
//     shared memory and stored as 16-B stores, head and tail masked
//     (store_span16).  K3 can take this form with SORTED = false.
#define K4_WARPS 8
#define K4_WARP_W 1024  // kernels.SORT_WARP_W

// n u16 from shared `src` to global `dst` by the whole block: scalar
// stores up to dst's first 16-B boundary, 16-B stores, a scalar tail.
__device__ __forceinline__ void store_span16(unsigned short* __restrict__ dst,
                                             const unsigned short* src, int n) {
  int head = (int)(((16 - ((uintptr_t)dst & 15)) & 15) >> 1);
  if (head > n) head = n;
  if ((int)threadIdx.x < head) dst[threadIdx.x] = src[threadIdx.x];
  int nv = (n - head) >> 3;
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const unsigned short* s = src + head + 8 * i;
    d4[i] = make_uint4(s[0] | (u32)s[1] << 16, s[2] | (u32)s[3] << 16,
                       s[4] | (u32)s[5] << 16, s[6] | (u32)s[7] << 16);
  }
  for (int i = head + 8 * nv + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src[i];
}

// rank_key's order for labels below 2^16 and counts below 2^16, as u32;
// widen_key16 turns it into rank_key's u64 (0 stays 0).
__device__ __forceinline__ u32 rank_key16(int count, u32 label) {
  return (u32)count << 16 | (0xFFFFu - label);
}

__device__ __forceinline__ u64 widen_key16(u32 k) {
  return k ? rank_key((int)(k >> 16), (int)(0xFFFFu - (k & 0xFFFFu))) : 0;
}

// min / max of P keys a register: two u16 halves (sm_90's min.u16x2) or one u32
template <int P>
__device__ __forceinline__ u32 kmin(u32 a, u32 b) {
  if (P == 1) return min(a, b);
  u32 d;
  asm("min.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

template <int P>
__device__ __forceinline__ u32 kmax(u32 a, u32 b) {
  if (P == 1) return max(a, b);
  u32 d;
  asm("max.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// One bitonic stage over the register index space i = lane * R + s:
// partner i ^ j, runs of k ascending where i & k == 0.  j and k are
// constants once the caller's loops unroll.
template <int R, int P>
__device__ __forceinline__ void bitonic_stage(u32 (&v)[R], int base, int j,
                                              int k) {
  if (j >= R) {
    // partner lane ^ j / R, the same register; i & j and i & k hang on the
    // lane alone
    bool keep_min = ((base & j) == 0) == ((base & k) == 0);
#pragma unroll
    for (int s = 0; s < R; ++s) {
      u32 o = __shfl_xor_sync(0xffffffffu, v[s], j / R);
      v[s] = keep_min ? kmin<P>(v[s], o) : kmax<P>(v[s], o);
    }
  } else {
#pragma unroll
    for (int s = 0; s < R; ++s) {
      if ((s & j) == 0) {
        bool up = ((base + s) & k) == 0;
        u32 lo = kmin<P>(v[s], v[s | j]), hi = kmax<P>(v[s], v[s | j]);
        v[s] = up ? lo : hi;
        v[s | j] = up ? hi : lo;
      }
    }
  }
}

// Sorts the warp's N = 32 R P keys ascending (layout above).  Every loop
// unrolls, so v stays in registers.
template <int R, int P>
__device__ __forceinline__ void bitonic_warp(u32 (&v)[R], int lane) {
  constexpr int LOGM = 5 + (R >= 2) + (R >= 4) + (R >= 8) + (R >= 16) +
                       (R >= 32);
  constexpr int M = 32 * R;
  const int base = lane * R;
#pragma unroll
  for (int lk = 1; lk <= LOGM; ++lk) {
    const int k = 1 << lk;
    if (P == 2 && k == M) {
#pragma unroll
      for (int s = 0; s < R; ++s) v[s] ^= 0xFFFF0000u;  // high half descends
    }
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) bitonic_stage<R, P>(v, base, 1 << lj, k);
    if (P == 2 && k == M) {
#pragma unroll
      for (int s = 0; s < R; ++s) v[s] ^= 0xFFFF0000u;
    }
  }
  if (P == 2) {  // level 2M: the halves in each register, then strides < M
#pragma unroll
    for (int s = 0; s < R; ++s) {
      u32 sw = __byte_perm(v[s], 0, 0x1032);
      v[s] = __byte_perm(kmin<2>(v[s], sw), kmax<2>(v[s], sw), 0x7610);
    }
#pragma unroll
    for (int lj = LOGM - 1; lj >= 0; --lj)
      bitonic_stage<R, P>(v, base, 1 << lj, 2 * M);
  }
}

template <int R, int P, bool SORTED>
__global__ void __launch_bounds__(K4_WARPS * 32)
sort_warp_kernel(const int* __restrict__ lab, long long R_rows, int W,
                 int* __restrict__ total, int* __restrict__ ibest,
                 int* __restrict__ best, int* __restrict__ isbest,
                 int* __restrict__ sbest, unsigned short* __restrict__ sorted) {
  constexpr int M = 32 * R;
  __shared__ unsigned short stage[SORTED ? K4_WARPS * M * P : 1];
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long r0 = (long long)blockIdx.x * K4_WARPS;
  int nr = (int)min((long long)K4_WARPS, R_rows - r0);
  // a warp past the last row repeats it and stores nothing: no branch
  // around the shuffles, which would make the compiler wrap each one in a
  // collective of its own
  bool live = warp < nr;
  {
    // lane l loads labels l, l + 32, ... (any placement: the sort orders
    // them) at fixed offsets from one pointer
    const int* row = lab + (r0 + min(warp, nr - 1)) * W + lane;
    u32 v[R];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      int j = s * 32 + lane;
      if (P == 2)
        v[s] = (j < W ? (u32)__ldg(row + 32 * s) & 0xFFFFu : 0xFFFFu) |
               (M + j < W ? (u32)__ldg(row + M + 32 * s) << 16 : 0xFFFF0000u);
      else
        v[s] = j < W ? (u32)__ldg(row + 32 * s) : 0xFFFFFFFFu;
    }
    bitonic_warp<R, P>(v, lane);
    const int base = lane * R;
    auto key = [&](int h, int s) -> u32 {
      return P == 1 ? v[s] : h ? v[s] >> 16 : v[s] & 0xFFFFu;
    };
    // the key before each segment's first place: the previous lane's last
    // of the same half; lane 0's high half follows lane 31's low half
    u32 prev[P];
#pragma unroll
    for (int h = 0; h < P; ++h)
      prev[h] = __shfl_up_sync(0xffffffffu, key(h, R - 1), 1);
    if (P == 2) {
      u32 t = __shfl_sync(0xffffffffu, key(0, R - 1), 31);
      if (lane == 0) prev[P - 1] = t;
    }
    bool start[P][R];
    int first[P];  // each segment's first run start (W: none)
#pragma unroll
    for (int h = 0; h < P; ++h) {
      first[h] = W;
#pragma unroll
      for (int s = R - 1; s >= 0; --s) {
        int i = h * M + base + s;
        start[h][s] = i < W && (i == 0 || key(h, s) != (s ? key(h, s - 1)
                                                          : prev[h]));
        if (start[h][s]) first[h] = i;
      }
    }
    // the next start after each segment: a later lane's in the same half,
    // else (low half) any start of the high half
    int next[P];
#pragma unroll
    for (int h = 0; h < P; ++h) {
      int x = first[h];
      for (int o = 1; o < 32; o <<= 1)
        x = min(x, __shfl_down_sync(0xffffffffu, x, o));
      next[h] = __shfl_down_sync(0xffffffffu, x, 1);
      if (lane == 31) next[h] = W;
      first[h] = x;  // now the suffix minimum
    }
    if (P == 2)
      next[0] = min(next[0], __shfl_sync(0xffffffffu, first[P - 1], 0));
    // ranks as u32 (rank_key16) where labels fit 16 bits: W <= 1,024
    // keeps counts below 2^16
    typedef typename std::conditional<P == 2, u32, u64>::type Key;
    int tot = 0;
    Key a1 = 0, a2 = 0;
#pragma unroll
    for (int h = 0; h < P; ++h) {
      int end = next[h];
#pragma unroll
      for (int s = R - 1; s >= 0; --s) {
        if (start[h][s]) {
          int i = h * M + base + s;
          if (key(h, s) > 0) {
            tot += end - i;
            if constexpr (P == 2)
              push_top2(a1, a2, rank_key16(end - i, key(h, s)));
            else
              push_top2(a1, a2, rank_key(end - i, (int)key(h, s)));
          }
          end = i;
        }
      }
    }
    for (int o = 16; o; o >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, o);
    warp_merge2(a1, a2);
    if (live && lane == 0) {
      if constexpr (P == 2)
        store_top2(r0 + warp, tot, widen_key16(a1), widen_key16(a2), total,
                   ibest, best, isbest, sbest);
      else
        store_top2(r0 + warp, tot, a1, a2, total, ibest, best, isbest, sbest);
    }
    if (SORTED && live) {
#pragma unroll
      for (int h = 0; h < P; ++h)
#pragma unroll
        for (int s = 0; s < R; ++s) {
          int i = h * M + base + s;
          if (i < W) stage[warp * W + i] = (unsigned short)key(h, s);
        }
    }
  }
  if (SORTED) {
    __syncthreads();
    store_span16(sorted + r0 * W, stage, nr * W);
  }
}

// ---------------------------------------------------------------- K5
// Dense per-read counts [R, T+1] (column 0 collects misses) and the top
// two over columns 1..T with read_results' order (count desc, lowest
// target index first; 0 = NA).  Labels outside [0, T] are dropped, as
// segment_sum drops them.
//
// Bound by bytes: the [R, T+1] count matrix written once, plus lab read
// once.  One kernel in three forms, chosen by shape alone
// (kernels.counts_form):
//
//   small  T+1 <= K5_SMALL_T1: K5_WARPS reads per block, a warp per read,
//          each read's histogram in shared memory, so no global atomic is
//          left.  A lane issues its K5_DEPTH loads before its shared
//          atomics.  The atomics are not warp-aggregated: on the H100 a
//          __match_any_sync per 32 windows cost more than the same-address
//          conflicts it saves, on random labels and on runs of one label
//          alike.  The block's rows lie back to back in shared memory as in
//          `counts`, so they leave as one span of 16-B stores (head and
//          tail masked: rows of 68 B are not 16-B aligned).  With a
//          `prior` [R, T+1] the histograms start from its rows instead of
//          zero: the last cycle of a cycled call passes the earlier
//          cycles' summed counts (chunks hold disjoint rows, so counts
//          add), and its top two are the read's final answer.
//   large  T+1 above that and W <= K5_TILE_W: a block per read.  The at
//          most W distinct labels go into an open-addressing table in
//          shared memory (label -> count, a power of two >= 2W slots,
//          atomicCAS insert; a hash rather than a sort, since the inserts
//          need no pass over the row besides the one that reads it), so the
//          total and the top two come from O(W) slots and the T columns
//          are never scanned.  The block streams 16-B zero stores over its
//          row, then scatters the at most W counts; the scattered lines are
//          mostly still in L2, so DRAM sees about one row write.
//   wide   rows wider than the tile (W > K5_TILE_W) at large T: the
//          multi-pass form below, a block per read adding into its row of
//          `counts` with global atomics and reading the row back.
#define K5_WARPS 8
#define K5_DEPTH 8        // loads a lane has in flight: W = 224 in one round
#define K5_SMALL_T1 4096  // K5_WARPS histograms of 16 KiB: 128 KiB
#define K5_TILE_W 4096    // table slots up to 8,192: 64 KiB
enum { K5_SMALL = 0, K5_LARGE = 1, K5_WIDE = 2 };

// n ints from shared `src` to global `dst` by the whole block: scalar
// stores up to dst's first 16-B boundary, 16-B stores, a scalar tail.
__device__ __forceinline__ void store_span(int* __restrict__ dst,
                                           const int* src, long long n) {
  long long head = ((16 - ((uintptr_t)dst & 15)) & 15) >> 2;
  if (head > n) head = n;
  if (threadIdx.x < head) dst[threadIdx.x] = src[threadIdx.x];
  long long nv = (n - head) >> 2;
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (long long i = threadIdx.x; i < nv; i += blockDim.x) {
    const int* s = src + head + 4 * i;
    d4[i] = make_uint4(s[0], s[1], s[2], s[3]);
  }
  for (long long i = head + 4 * nv + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src[i];
}

// n zeros over global `dst` by the whole block, 16-B stores in the middle.
__device__ __forceinline__ void zero_span(int* __restrict__ dst, long long n) {
  long long head = ((16 - ((uintptr_t)dst & 15)) & 15) >> 2;
  if (head > n) head = n;
  if (threadIdx.x < head) dst[threadIdx.x] = 0;
  long long nv = (n - head) >> 2;
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (long long i = threadIdx.x; i < nv; i += blockDim.x)
    d4[i] = make_uint4(0, 0, 0, 0);
  for (long long i = head + 4 * nv + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = 0;
}

// A lane's K5_DEPTH labels of one row of W windows from column base on
// (-1 past the row), all loads in flight before the caller's first atomic:
// label u is column base + 32 u + lane, so a warp's loads are coalesced.
__device__ __forceinline__ void load_labels(const int* __restrict__ row,
                                            long long W, long long base,
                                            int lane, int (&v)[K5_DEPTH]) {
#pragma unroll
  for (int u = 0; u < K5_DEPTH; ++u) {
    long long j = base + 32 * u + lane;
    v[u] = j < W ? __ldg(row + j) : -1;
  }
}

// A lane's labels in order as runs of equal values: add(label, run length)
// once per run, at its last label.  A read's hits mostly carry one label,
// so a lane of such a read adds once where it would add K5_DEPTH times;
// unrolled, the run test is a compare and a select per label.
template <typename Add>
__device__ __forceinline__ void for_runs(const int (&v)[K5_DEPTH], Add add) {
  int run = 1;
#pragma unroll
  for (int u = 0; u < K5_DEPTH; ++u) {
    if (u + 1 < K5_DEPTH && v[u + 1] == v[u]) {
      ++run;
    } else {
      add(v[u], run);
      run = 1;
    }
  }
}

// A warp's total over columns 1..T1-1 of its histogram h and the top two
// of those columns (keys from rank_key), in every lane.
__device__ __forceinline__ void warp_top2_columns(const int* h, int T1,
                                                  int lane, int& tot, u64& a1,
                                                  u64& a2) {
  tot = 0;
  a1 = a2 = 0;
  for (int c = 1 + lane; c < T1; c += 32) {
    int n = h[c];
    tot += n;
    if (n > 0) push_top2(a1, a2, rank_key(n, c));
  }
  for (int o = 16; o; o >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, o);
  warp_merge2(a1, a2);
}

__global__ void __launch_bounds__(K5_WARPS * 32)
counts_small_kernel(const int* __restrict__ lab,
                    const int* __restrict__ prior, long long R, long long W,
                    int T1, int* __restrict__ counts, int* __restrict__ total,
                    int* __restrict__ ibest, int* __restrict__ best,
                    int* __restrict__ isbest, int* __restrict__ sbest) {
  extern __shared__ int hist[];  // [nr][T1]: rows r0.. as in `counts`
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long r0 = (long long)blockIdx.x * K5_WARPS;
  int nr = (int)min((long long)K5_WARPS, R - r0);
  // the block's prior rows lie back to back, as its histograms do
  const int* seed = prior ? prior + r0 * T1 : nullptr;
  for (int j = threadIdx.x; j < nr * T1; j += blockDim.x)
    hist[j] = seed ? __ldg(seed + j) : 0;
  __syncthreads();
  if (warp < nr) {  // uniform across the warp
    int* h = hist + warp * T1;
    const int* row = lab + (r0 + warp) * W;
    for (long long base = 0; base < W; base += 32 * K5_DEPTH) {
      int v[K5_DEPTH];
      load_labels(row, W, base, lane, v);
#pragma unroll
      for (int u = 0; u < K5_DEPTH; ++u)
        if ((unsigned)v[u] < (unsigned)T1) atomicAdd(&h[v[u]], 1);
    }
    __syncwarp();
    int tot;
    u64 a1, a2;
    warp_top2_columns(h, T1, lane, tot, a1, a2);
    if (lane == 0)
      store_top2(r0 + warp, tot, a1, a2, total, ibest, best, isbest, sbest);
  }
  __syncthreads();
  store_span(counts + r0 * T1, hist, (long long)nr * T1);
}

__global__ void __launch_bounds__(K3_THREADS)
counts_large_kernel(const int* __restrict__ lab, long long W, int T1,
                    int log2cap, int* __restrict__ counts,
                    int* __restrict__ total, int* __restrict__ ibest,
                    int* __restrict__ best, int* __restrict__ isbest,
                    int* __restrict__ sbest) {
  extern __shared__ int tab[];  // keys[cap] (-1 = free), then cnt[cap]
  __shared__ u64 s1[K3_WARPS], s2[K3_WARPS];
  __shared__ int s_tot[K3_WARPS];
  const int cap = 1 << log2cap;
  int* keys = tab;
  int* cnt = tab + cap;
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* row = lab + (long long)blockIdx.x * W;
  int* crow = counts + (long long)blockIdx.x * T1;

  zero_span(crow, T1);  // the stores need not wait for the table
  for (int j = threadIdx.x; j < cap; j += K3_THREADS) {
    keys[j] = -1;
    cnt[j] = 0;
  }
  __syncthreads();
  for (long long base = warp * 32; base < W; base += K3_THREADS) {
    long long j = base + lane;  // base is uniform across the warp
    int v = j < W ? __ldg(row + j) : -1;
    bool ok = (unsigned)v < (unsigned)T1;
    unsigned peers = __match_any_sync(0xffffffffu, ok ? v : -1);
    if (ok && lane == __ffs(peers) - 1) {
      unsigned s = ((unsigned)v * 2654435761u) >> (32 - log2cap);
      for (;;) {  // at most W labels in >= 2W slots: a free slot exists
        int prev = atomicCAS(&keys[s], -1, v);
        if (prev == -1 || prev == v) {
          atomicAdd(&cnt[s], __popc(peers));
          break;
        }
        s = (s + 1) & (cap - 1);
      }
    }
  }
  __syncthreads();  // the table is complete; the zero stores are ordered
  int tot = 0;      // before the scatter below
  u64 a1 = 0, a2 = 0;
  for (int j = threadIdx.x; j < cap; j += K3_THREADS) {
    int v = keys[j];
    if (v < 0) continue;
    crow[v] = cnt[j];
    if (v > 0) {
      tot += cnt[j];
      push_top2(a1, a2, rank_key(cnt[j], v));
    }
  }
  for (int o = 16; o; o >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, o);
  if (lane == 0) s_tot[warp] = tot;
  block_merge2(a1, a2, s1, s2);  // its __syncthreads also publishes s_tot
  if (threadIdx.x == 0) {
    for (int w = 1; w < K3_WARPS; ++w) tot += s_tot[w];
    store_top2(blockIdx.x, tot, a1, a2, total, ibest, best, isbest, sbest);
  }
}

// The wide form: one block per read adds into its row of `counts` with
// global atomics, then reduces the row.
__global__ void __launch_bounds__(K3_THREADS)
counts_top2_kernel(const int* __restrict__ lab, long long W, int T1,
                   int* __restrict__ counts, int* __restrict__ total,
                   int* __restrict__ ibest, int* __restrict__ best,
                   int* __restrict__ isbest, int* __restrict__ sbest) {
  __shared__ u64 s1[K3_WARPS], s2[K3_WARPS];
  __shared__ int s_tot[K3_WARPS];
  const int* row = lab + (long long)blockIdx.x * W;
  int* crow = counts + (long long)blockIdx.x * T1;
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int j = threadIdx.x; j < T1; j += K3_THREADS) crow[j] = 0;
  __syncthreads();
  for (long long j = threadIdx.x; j < W; j += K3_THREADS) {
    int v = row[j];
    if ((unsigned)v < (unsigned)T1) atomicAdd(&crow[v], 1);
  }
  __syncthreads();  // also orders the block's global atomics before reads

  // columns ascend within each thread: strict '>' keeps the lower index
  int tot = 0;
  u64 a1 = 0, a2 = 0;
  for (int j = 1 + threadIdx.x; j < T1; j += K3_THREADS) {
    int c = crow[j];
    tot += c;
    if (c > 0) {
      u64 key = rank_key(c, j);
      if (key > a1) {
        a2 = a1;
        a1 = key;
      } else if (key > a2) {
        a2 = key;
      }
    }
  }
  for (int o = 16; o; o >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, o);
  if (lane == 0) s_tot[warp] = tot;
  block_merge2(a1, a2, s1, s2);  // its __syncthreads also publishes s_tot
  if (threadIdx.x == 0) {
    for (int w = 1; w < K3_WARPS; ++w) tot += s_tot[w];
    store_top2(blockIdx.x, tot, a1, a2, total, ibest, best, isbest, sbest);
  }
}

// ------------------------------------------------------- K3, warp forms
// Replaces score.py:41 top2_from_labels (sort, then :57 top2_from_sorted):
// per read the total of its positive labels and the top two labels under
// (count desc, label asc; 0 = NA).  Bound by bytes: the [R, W] label read
// once (29 MB at the config-2 shape, R = 32,768, W = 224: 0.0090 ms at
// 3.35 TB/s).  The block form above ran 0.0723 ms there on an H100 80GB
// HBM3 at 700 W, 12% of that: a 128-thread block held under two labels a
// thread, its 32 KiB static histogram kept seven blocks (28 warps) on an
// SM, it read the row twice
// (the range, then the histogram) and ran about a dozen __syncthreads a
// read, and its scan covered the label range [lo, hi], not the at most W
// labels present (thousands of entries a read at 5,001 targets, and the
// row read again per 8,192-label chunk at 65,535).  Here a warp holds one
// read: the row is read once, with K5_DEPTH loads a lane in flight before
// its shared atomics (W = 224 in one round), a lane adds a run of equal
// labels once (for_runs), nothing but the five scalars is stored, and no
// phase spans the block.  Two warp forms, chosen by shape alone
// (kernels.top2_form; the block form above takes the rest):
//
//   small  T+1 <= K5_SMALL_T1, T known: K5's small form without its count
//          store.  Each warp zeroes its own histogram of T+1 ints in
//          dynamic shared memory, adds labels 1..T, and scans columns
//          1 + lane, 1 + lane + 32, ...  A label outside [0, T] is skipped:
//          the caller promises none (score_from_labels gets labels in
//          [0, T]; a mesh's shard labels sum into that range, since a
//          window matches in at most one shard).
//   hash   any label in [1, 2^31), rows of W <= K3_TILE_W: the warp's
//          labels go into an open-addressing table in shared memory
//          (label -> count, a power of two >= 2W slots, 0 = free;
//          atomicCAS insert) as in counts_large_kernel, but a table per
//          warp, and a bit per occupied slot.  The scan covers the table's
//          occupied slots (the bits), never the label range, and clears
//          them.  The grid is persistent: a warp zeroes its table once and
//          takes read after read.  On the H100, zeroing and scanning all
//          2W slots a read, or scanning every slot without the bits, made
//          rows of one label (the common read) clearly slower; on rows of
//          many distinct labels the bits' atomicOr costs a little more
//          than either.  A block holds as many reads as keep its tables
//          within K3_HASH_SMEM (eight at W = 224: 4,160 B a table), so
//          several blocks share an SM.
//
// The order of the atomics does not matter: the counts are exact, and the
// top two of distinct rank keys is the same in any visiting order.
#define K3_TILE_W 4096            // hash form: windows a read, at most
#define K3_HASH_SMEM (36 * 1024)  // hash form: a block's tables, at most
enum { K3_SMALL = 0, K3_HASH = 1, K3_BLOCK = 2 };

__global__ void __launch_bounds__(K5_WARPS * 32)
top2_small_kernel(const int* __restrict__ lab, long long R, long long W,
                  int T1, int* __restrict__ total, int* __restrict__ ibest,
                  int* __restrict__ best, int* __restrict__ isbest,
                  int* __restrict__ sbest) {
  extern __shared__ int hist[];  // [K5_WARPS][T1]
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long r = (long long)blockIdx.x * K5_WARPS + warp;
  if (r >= R) return;  // uniform across the warp; no block-wide phase
  int* h = hist + warp * T1;
  for (int c = lane; c < T1; c += 32) h[c] = 0;
  __syncwarp();
  const int* row = lab + r * W;
  for (long long base = 0; base < W; base += 32 * K5_DEPTH) {
    int v[K5_DEPTH];
    load_labels(row, W, base, lane, v);
    for_runs(v, [&](int x, int n) {
      if ((unsigned)x - 1u < (unsigned)(T1 - 1)) atomicAdd(&h[x], n);
    });
  }
  __syncwarp();
  int tot;
  u64 a1, a2;
  warp_top2_columns(h, T1, lane, tot, a1, a2);
  if (lane == 0)
    store_top2(r, tot, a1, a2, total, ibest, best, isbest, sbest);
}

// n more of label x > 0 into a table of 2^(32 - shift) slots: keys (0 =
// free) and counts, and a bit per occupied slot in `used`.  At most W
// labels in >= 2W slots: a free slot exists.  A slot is read before the
// atomicCAS, so a label already in the table costs a plain load and its
// atomicAdd.  On the H100 that read saved time on rows of one label at
// 672 windows and cost a little on rows of 224 distinct labels.
__device__ __forceinline__ void hash_add(int* keys, int* cnt, unsigned* used,
                                         int shift, int x, int n) {
  unsigned mask = 0xFFFFFFFFu >> shift;
  unsigned s = ((unsigned)x * 2654435761u) >> shift;
  for (;;) {
    int k = ((volatile int*)keys)[s];
    if (k == 0) {
      k = atomicCAS(&keys[s], 0, x);
      if (k == 0) {
        atomicOr(&used[s >> 5], 1u << (s & 31));
        k = x;
      }
    }
    if (k == x) {
      atomicAdd(&cnt[s], n);
      return;
    }
    s = (s + 1) & mask;
  }
}

// Ints of one warp's table of 2^log2cap slots: keys, counts, used bits.
__host__ __device__ __forceinline__ int hash_table_ints(int log2cap) {
  return (2 << log2cap) + (((1 << log2cap) + 31) >> 5);
}

// A persistent grid: warp w of the grid takes rows w, w + the grid's warps,
// ...  Its table is zeroed once; after a row the scan clears the slots the
// row used (the used bits name them), so a row costs O(its distinct
// labels) of shared-memory work besides its loads, not O(2W) slots.
__global__ void __launch_bounds__(K5_WARPS * 32)
top2_hash_kernel(const int* __restrict__ lab, long long R, long long W,
                 int log2cap, int* __restrict__ total, int* __restrict__ ibest,
                 int* __restrict__ best, int* __restrict__ isbest,
                 int* __restrict__ sbest) {
  extern __shared__ int tab[];  // per warp: hash_table_ints(log2cap)
  const int cap = 1 << log2cap, words = (cap + 31) >> 5;
  const int warps = blockDim.x >> 5, n_ints = hash_table_ints(log2cap);
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* keys = tab + warp * n_ints;
  int* cnt = keys + cap;
  unsigned* used = (unsigned*)(cnt + cap);
  for (int j = lane; j < n_ints; j += 32) keys[j] = 0;
  __syncwarp();
  for (long long r = (long long)blockIdx.x * warps + warp; r < R;
       r += (long long)gridDim.x * warps) {  // uniform across the warp
    const int* row = lab + r * W;
    int tot = 0;
    for (long long base = 0; base < W; base += 32 * K5_DEPTH) {
      int v[K5_DEPTH];
      load_labels(row, W, base, lane, v);
      for_runs(v, [&](int x, int n) {
        if (x > 0) {
          tot += n;
          hash_add(keys, cnt, used, 32 - log2cap, x, n);
        }
      });
    }
    __syncwarp();
    u64 a1 = 0, a2 = 0;
    for (int i = lane; i < words; i += 32) {
      unsigned b = used[i];
      if (b) used[i] = 0;
      for (; b; b &= b - 1) {
        int j = (i << 5) + __ffs(b) - 1;
        push_top2(a1, a2, rank_key(cnt[j], keys[j]));
        keys[j] = 0;
        cnt[j] = 0;
      }
    }
    for (int o = 16; o; o >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, o);
    warp_merge2(a1, a2);
    if (lane == 0)
      store_top2(r, tot, a1, a2, total, ibest, best, isbest, sbest);
    __syncwarp();  // the table is clear before the next row's inserts
  }
}

// ---------------------------------------------------------------- K9
// Replaces ops/lookup.py:41 lookup_labels, the flat path's index search:
// keys [N] u64 ascending, labels1 [N] (label + 1), q [Q] u64 -> out [Q],
// the label + 1 of the first key equal to q, or 0 where none is or q is
// the pad value 2^64 - 1.
//
// Bound by bytes: what any search of a batch must read is q, out, the
// key sector of each distinct lower-bound position and a label sector a
// hit (chip_smoke.py phase 5 counts them from this run's queries).  A
// lower-bound binary search of the whole array (the first form) made
// ~log2(N) dependent loads a query, 26 at config 2's 48M keys: the top
// levels hit L2, the last ~10 were random HBM reads each waiting on the
// one before, so the kernel waited on latency.  This form puts a radix
// directory in front of the search (lookup.build_index, made once at
// load): the range [kmin, kmax] in 2^bits buckets of 2^shift values, and
// dir[j] the index of bucket j's first key, 2^bits <= 2^22 int32 offsets
// (16 MiB) that stay in the 50 MB L2 across batches.  A query loads
// dir[j] and dir[j + 1] (one L2 sector), then runs a lower-bound binary
// search of the bucket's keys alone (11.4 on average at config 2, 46 at
// most), whose ~4 steps fall in the bucket's one or two 128-B lines, and
// one label load on a hit, in place of 26 loads across the array.  What
// is left is random 32-B sectors from HBM, ~4 a query (the bucket's and
// the label's); ending the search in a scan of the bucket's last 8 or 16
// keys, loads in flight together, was no faster.  Skew costs only time:
// the search is a full binary search of any bucket.  Unsigned compares
// throughout; a query outside [kmin, kmax] misses without a load, and an
// index of pad keys alone has kmin > kmax.
#define K9_THREADS 256

__global__ void __launch_bounds__(K9_THREADS)
lookup_kernel(const u64* __restrict__ keys, const int* __restrict__ labels1,
              const int* __restrict__ dir, u64 kmin, u64 kmax, int shift,
              const u64* __restrict__ q, int* __restrict__ out, long long Q) {
  long long i = (long long)blockIdx.x * K9_THREADS + threadIdx.x;
  if (i >= Q) return;
  u64 x = q[i];
  int lab = 0;
  if (x != EMPTY64 && x >= kmin && x <= kmax) {
    long long j = shift < 64 ? (long long)((x - kmin) >> shift) : 0;
    long long lo = __ldg(dir + j), end = __ldg(dir + j + 1), hi = end;
    while (lo < hi) {  // the first key >= x lies in [lo, hi]
      long long mid = lo + ((hi - lo) >> 1);
      if (__ldg(keys + mid) < x)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo < end && __ldg(keys + lo) == x) lab = __ldg(labels1 + lo);
  }
  out[i] = lab;
}

// ------------------------------------------------------- K5, flat form
// Replaces score.py:17 counts_from_hits + :85 read_results where the flat
// path calls them (engine.py:2076 _query_single): per-query labels1 [Q]
// (label + 1 in [0, T]; 0 = miss) and read ids [Q] in [0, R) -> dense
// counts [R, T+1] (column 0 the misses) and the top two over columns 1..T
// in read_results' order.  Labels or read ids out of range are dropped.
//
// Bound by bytes: the two [Q] inputs read once and the [R, T+1] counts
// written once.  Three steps: the launcher zeroes `counts`; the scatter
// takes a query a thread; a warp a read scans its row's columns with K5's
// top-2 step (warp_top2_columns).  A read's ~144 queries lie together and
// most carry one label, so the first form's global atomic a query put a
// warp's 32 adds on 1-3 addresses, where they serialise in L2 (13%
// of its bound).  Here the lanes of a warp that share a (read, label)
// counter find each other with __match_any_sync, and the group's lowest
// lane adds the group's size once: one atomic a counter a warp.  Read ids
// need not be sorted: a group is whatever lanes share a counter (the JAX
// package's pad queries, read 0 at the batch's end, form their own).
__global__ void __launch_bounds__(K9_THREADS)
counts_flat_scatter_kernel(const int* __restrict__ labels1,
                           const int* __restrict__ read_id, long long Q,
                           long long R, int T1, int* __restrict__ counts) {
  long long i = (long long)blockIdx.x * K9_THREADS + threadIdx.x;
  long long at = -1;  // the lane's counter, -1 for none; every lane of the
  // warp reaches the match below, past Q too
  if (i < Q) {
    int v = labels1[i], r = read_id[i];
    if ((unsigned)v < (unsigned)T1 && r >= 0 && r < R)
      at = (long long)r * T1 + v;
  }
  unsigned group = __match_any_sync(0xffffffffu, (unsigned long long)at);
  if (at >= 0 && (int)(threadIdx.x & 31) == __ffs(group) - 1)
    atomicAdd(&counts[at], __popc(group));
}

__global__ void __launch_bounds__(K5_WARPS * 32)
counts_flat_top2_kernel(const int* __restrict__ counts, long long R, int T1,
                        int* __restrict__ total, int* __restrict__ ibest,
                        int* __restrict__ best, int* __restrict__ isbest,
                        int* __restrict__ sbest) {
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long r = (long long)blockIdx.x * K5_WARPS + warp;
  if (r >= R) return;  // uniform across the warp
  int tot;
  u64 a1, a2;
  warp_top2_columns(counts + r * T1, T1, lane, tot, a1, a2);
  if (lane == 0) store_top2(r, tot, a1, a2, total, ibest, best, isbest, sbest);
}

// ---------------------------------------------------------------- launchers
static long long lmin(long long a, long long b) { return a < b ? a : b; }
static long long lmax(long long a, long long b) { return a > b ? a : b; }

// A grid that fills the current device: its SMs times the blocks of
// `threads` threads one SM holds.
static int sm_grid(int threads, int* grid) {
  int dev = 0, sms = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (cudaError_t e =
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return (int)e;
  *grid = sms * (2048 / threads);
  return 0;
}

// Dynamic shared memory above the 48 KiB default needs the kernel's opt-in.
static int allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// A persistent grid: the blocks of `threads` threads and `smem` bytes of
// dynamic shared memory that the SMs hold at once (after the opt-in).
static int occupancy_grid(const void* kernel, int threads, size_t smem,
                          long long* grid) {
  if (int rc = allow_smem(kernel, smem)) return rc;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (cudaError_t e =
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return (int)e;
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, threads, smem))
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = (long long)sms * per_sm;
  return 0;
}

// K2/K8 (b) on a persistent grid: as many blocks as the SMs hold at the
// tile's shared memory, and no more than max_tiles.
static int launch_group_probe(const void* slots, const int* list,
                              const u64* keys, const int* ctr, int nbins,
                              int shift, int kshift, int* out, int C, int m,
                              int lb, long long max_tiles, cudaStream_t st) {
  size_t smem = (size_t)G_TILE * 20 + (sizeof(int) << (shift - kshift));
  long long grid = 0;
  if (int rc = occupancy_grid((const void*)group_probe_kernel,
                              G_THREADS, smem, &grid))
    return rc;
  int vec = (C % 4 == 0) && ((uintptr_t)slots % 16 == 0);
  group_probe_kernel<<<(unsigned)lmin(grid, max_tiles), G_THREADS, smem,
                       st>>>(
      (const u32*)slots, list, keys, ctr, nbins, shift, kshift, out, C, m, lb,
      vec);
  return (int)cudaGetLastError();
}

// One level of the partition: (a1), (a2), (a3), (a4) into nbins bins of
// bucket >> bshift, from q (src_list null) or from the level before.
template <u64 MIX>
static int group_level(const u64* src, const int* src_list, long long Q,
                       int m, int bshift, int nbins, int G,
                       const void* stash_keys, const void* stash_labels,
                       int* out_stash, int* list, u64* keys, int* cnt,
                       int* ctr, cudaStream_t st) {
  long long slice = (Q + G - 1) / G;
  size_t hist = (size_t)nbins * sizeof(int);
  if (src_list)
    group_count_kernel<MIX, true><<<G, G_PART_THREADS, hist, st>>>(
        src, Q, slice, m, bshift, nbins, cnt);
  else
    group_count_kernel<MIX, false><<<G, G_PART_THREADS, hist, st>>>(
        src, Q, slice, m, bshift, nbins, cnt);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  group_offsets_kernel<<<(nbins + G_THREADS / 32 - 1) / (G_THREADS / 32),
                         G_THREADS, 0, st>>>(cnt, G, nbins, ctr);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  group_tiles_kernel<<<1, 1024, 0, st>>>(ctr, nbins);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  size_t stage = (size_t)G_PART_TILE * 12 + (3 * nbins + 1) * sizeof(int);
  const void* sc = src_list ? (const void*)group_scatter_kernel<MIX, true>
                            : (const void*)group_scatter_kernel<MIX, false>;
  if (int rc = allow_smem(sc, stage)) return rc;
  if (src_list)
    group_scatter_kernel<MIX, true><<<G, G_PART_THREADS, stage, st>>>(
        src, src_list, Q, slice, m, bshift, nbins, cnt, ctr, nullptr,
        nullptr, nullptr, list, keys);
  else
    group_scatter_kernel<MIX, false><<<G, G_PART_THREADS, stage, st>>>(
        src, nullptr, Q, slice, m, bshift, nbins, cnt, ctr,
        (const u64*)stash_keys, (const int*)stash_labels, out_stash, list,
        keys);
  return (int)cudaGetLastError();
}

// K2/K8 for one plane of 2^m rows: the partition, in two levels past
// G_COARSE bins (first by bin >> G_COARSE_BITS, then, from that coarse
// order, by bin: each level then writes long runs a bin), then (b).  G
// blocks partition; scratch (nothing zeroed): list/keys [2, Q] (the two
// levels' outputs), cnt [nbins * G], ctr [3 * nbins + 1].  (shift, nbins,
// kshift) is the plan (kernels.group_bins); the stash is answered into
// out_stash (null: none).
template <u64 MIX>
static int group_plane(const void* slots, const void* stash_keys,
                       const void* stash_labels, const void* q,
                       int* out_stash, int* out, long long Q, int C, int m,
                       int lb, int shift, int nbins, int kshift, int G,
                       int* list, u64* keys, int* cnt, int* ctr,
                       cudaStream_t st) {
  long long rows = 1LL << m;
  if (nbins < 1 || nbins > K7_MAX_BINS || shift < 0 || shift > m ||
      kshift < 0 || kshift > shift || shift - kshift > G_KEY_BITS ||
      ((rows - 1) >> shift) >= nbins || G < 1)
    return (int)cudaErrorInvalidValue;
  const u64* src = (const u64*)q;
  const int* src_list = nullptr;
  int* l2 = list;
  u64* k2 = keys;
  if (nbins > G_COARSE) {
    int cb = shift + G_COARSE_BITS;
    if (int rc = group_level<MIX>(src, nullptr, Q, m, cb,
                                  (int)(((rows - 1) >> cb) + 1), G,
                                  stash_keys, stash_labels, out_stash, list,
                                  keys, cnt, ctr, st))
      return rc;
    src = keys;
    src_list = list;
    out_stash = nullptr;
    l2 = list + Q;
    k2 = keys + Q;
  }
  if (int rc = group_level<MIX>(src, src_list, Q, m, shift, nbins, G,
                                stash_keys, stash_labels, out_stash, l2, k2,
                                cnt, ctr, st))
    return rc;
  return launch_group_probe(slots, l2, k2, ctr, nbins, shift, kshift, out, C,
                            m, lb, (Q + G_TILE - 1) / G_TILE + nbins, st);
}

extern "C" {

const char* clark_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K1's plan (kernels.window_run): E windows a run, tr runs of each of rb
// rows a block, `tiles` blocks along a row; refused where it does not
// cover the [R, W] grid in one launch.
int launch_window_canonicals(const void* words, const void* vwords, void* q,
                             long long R, int nw, int nv, int W, int k, int E,
                             int tr, int rb, int tiles, void* stream) {
  if (R == 0 || W == 0) return 0;
  long long runs = (W + E - 1) / E;
  long long groups = (R + rb - 1) / rb;
  if ((E != 4 && E != 8) || tr < 1 || rb < 1 || (long long)tr * rb > K1_THREADS ||
      (rb > 1 && tr < runs) || (long long)tiles * tr < runs ||
      (long long)(tiles - 1) * tr >= runs || tiles > 65535 ||
      groups > 0x7FFFFFFFLL || k < 1 || k > 32 || W > (nw - 1) * 32)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)groups, (unsigned)tiles);
  cudaStream_t st = (cudaStream_t)stream;
  if (E == 8)
    window_canonicals_kernel<8><<<grid, K1_THREADS, 0, st>>>(
        (const u64*)words, (const u64*)vwords, (u64*)q, R, nw, nv, W, k, tr,
        rb);
  else
    window_canonicals_kernel<4><<<grid, K1_THREADS, 0, st>>>(
        (const u64*)words, (const u64*)vwords, (u64*)q, R, nw, nv, W, k, tr,
        rb);
  return (int)cudaGetLastError();
}

// K2's launches (group_plane): five, or nine past 64 bins.
int launch_probe(const void* slots, const void* stash_keys,
                 const void* stash_labels, const void* q, void* out,
                 long long Q, int C, int m1, int lb, int shift, int nbins,
                 int kshift, int G, void* list, void* keys, void* cnt,
                 void* ctr, void* stream) {
  if (Q == 0) return 0;
  if (Q > 0x7FFFFFFFLL || m1 < 1 || m1 > 62) return (int)cudaErrorInvalidValue;
  return group_plane<MIX1>(slots, stash_keys, stash_labels, q, (int*)out,
                           (int*)out, Q, C, m1, lb, shift, nbins, kshift, G,
                           (int*)list, (u64*)keys, (int*)cnt, (int*)ctr,
                           (cudaStream_t)stream);
}

// K7's three launches.  list [Q] int32 and ctr [2 * nbins + 2] int32
// (zeroed) are the wrapper's scratch; shift and nbins its bin plan.
int launch_probe_chunk(const void* slots, const void* stash_keys,
                       const void* stash_labels, const void* q, void* out,
                       long long Q, int C, int m1, int lb,
                       long long start_row, long long rows_per, int use_stash,
                       int shift, int nbins, void* list, void* ctr,
                       void* stream) {
  if (Q == 0) return 0;
  if (Q > 0x7FFFFFFFLL || nbins < 1 || nbins > K7_MAX_BINS || shift < 0 ||
      shift > 62 || ((rows_per - 1) >> shift) >= nbins)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int grid = 0;
  if (int rc = sm_grid(K7_THREADS, &grid)) return rc;
  // no more blocks than there is work for, in each of the three passes
  const long long tile = (long long)K7_THREADS * K7_QPT;
  const long long per_probe_block = K7_THREADS / K7_LANES;
  unsigned g_count = (unsigned)lmin(grid, (Q + K7_THREADS - 1) / K7_THREADS);
  unsigned g_scatter = (unsigned)lmin(grid, (Q + tile - 1) / tile);
  unsigned g_probe =
      (unsigned)lmin(grid, (Q + per_probe_block - 1) / per_probe_block);
  size_t hist = (size_t)nbins * sizeof(int);
  chunk_count_kernel<<<g_count, K7_THREADS, hist, st>>>(
      (const u64*)q, Q, m1, start_row, rows_per, shift, nbins, (int*)ctr);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  chunk_scatter_kernel<<<g_scatter, K7_THREADS, 2 * hist, st>>>(
      (const u64*)q, Q, m1, start_row, rows_per, shift, nbins,
      (const u64*)stash_keys, (const int*)stash_labels, use_stash, (int*)out,
      (int*)ctr, (int*)list);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  int vec = (C % 4 == 0) && ((uintptr_t)slots % 16 == 0);
  chunk_probe_kernel<<<g_probe, K7_THREADS, 0, st>>>(
      (const u32*)slots, (const u64*)q, (const int*)list, (const int*)ctr,
      nbins, (int*)out, C, m1, lb, start_row, use_stash, vec);
  return (int)cudaGetLastError();
}

// K8: plane 1 as K2, then plane 2 in its form (kernels.plane2_form):
// local2 (plane2_local_kernel, one launch over q) or grouped (as plane 1,
// the scratch reused).
int launch_probe_dense(const void* slots1, const void* slots2,
                       const void* stash_keys, const void* stash_labels,
                       const void* q, void* out, long long Q, int C, int m1,
                       int m2, int lb, int shift1, int nbins1, int kshift1,
                       int local2, int shift2, int nbins2, int kshift2, int G,
                       void* list, void* keys, void* cnt, void* ctr,
                       void* stream) {
  if (Q == 0) return 0;
  if (Q > 0x7FFFFFFFLL || m1 < 1 || m1 > 62 || m2 < 1 || m2 > 62 ||
      (local2 && (m2 > G_KEY_BITS || ((size_t)4 * C << m2) > G_LOCAL_BYTES)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (int rc = group_plane<MIX1>(slots1, stash_keys, stash_labels, q,
                                 (int*)out, (int*)out, Q, C, m1, lb, shift1,
                                 nbins1, kshift1, G, (int*)list, (u64*)keys,
                                 (int*)cnt, (int*)ctr, st))
    return rc;
  if (local2) {
    size_t smem = ((size_t)8 * (C + 1) + 4) << m2;
    long long grid = 0;
    if (int rc = occupancy_grid((const void*)plane2_local_kernel, G_THREADS,
                                smem, &grid))
      return rc;
    plane2_local_kernel<<<(unsigned)lmin(grid, (Q + G_THREADS - 1) /
                                                   G_THREADS),
                          G_THREADS, smem, st>>>(
        (const u32*)slots2, (const u64*)q, (int*)out, Q, C, m2, lb);
    return (int)cudaGetLastError();
  }
  return group_plane<MIX2>(slots2, stash_keys, stash_labels, q, nullptr,
                           (int*)out, Q, C, m2, lb, shift2, nbins2, kshift2,
                           G, (int*)list, (u64*)keys, (int*)cnt, (int*)ctr,
                           st);
}

// form: kernels.top2_form(T, W), 0 = small (T1 = T+1 histogram columns),
// 1 = hash, 2 = block; refused where the shape does not fit the form.
int launch_top2(const void* lab, long long R, long long W, int T1, int form,
                void* total, void* ibest, void* best, void* isbest,
                void* sbest, void* stream) {
  if (R == 0) return 0;
  if (R > 0x7FFFFFFFLL || W < 0) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  const int* l = (const int*)lab;
  int *t = (int*)total, *ib = (int*)ibest, *b = (int*)best,
      *isb = (int*)isbest, *sb = (int*)sbest;
  if (form == K3_SMALL) {
    if (T1 < 2 || T1 > K5_SMALL_T1) return (int)cudaErrorInvalidValue;
    size_t smem = (size_t)K5_WARPS * T1 * sizeof(int);
    if (int rc = allow_smem((const void*)top2_small_kernel, smem)) return rc;
    top2_small_kernel<<<(unsigned)((R + K5_WARPS - 1) / K5_WARPS),
                        K5_WARPS * 32, smem, st>>>(l, R, W, T1, t, ib, b,
                                                   isb, sb);
  } else if (form == K3_HASH) {
    if (W > K3_TILE_W) return (int)cudaErrorInvalidValue;
    int log2cap = 1;
    while ((1LL << log2cap) < 2 * W) ++log2cap;
    size_t table = sizeof(int) * hash_table_ints(log2cap);
    int warps = (int)lmin(K5_WARPS, lmax(K3_HASH_SMEM / table, 1));
    size_t smem = warps * table;
    long long grid = 0;
    if (int rc = occupancy_grid((const void*)top2_hash_kernel, warps * 32,
                                smem, &grid))
      return rc;
    top2_hash_kernel<<<(unsigned)lmin(grid, (R + warps - 1) / warps),
                       warps * 32, smem, st>>>(l, R, W, log2cap, t, ib, b,
                                               isb, sb);
  } else if (form == K3_BLOCK) {
    top2_kernel<false><<<(unsigned)R, K3_THREADS, 0, st>>>(l, W, t, ib, b,
                                                           isb, sb, nullptr);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// form: kernels.sort_form(W), 0 = warp (W <= K4_WARP_W), 1 = block.
int launch_sort_top2(const void* lab, long long R, long long W, int form,
                     void* sorted, void* total, void* ibest, void* best,
                     void* isbest, void* sbest, void* stream) {
  if (R == 0) return 0;
  if (R > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  const int* l = (const int*)lab;
  int *t = (int*)total, *ib = (int*)ibest, *b = (int*)best,
      *isb = (int*)isbest, *sb = (int*)sbest;
  unsigned short* s = (unsigned short*)sorted;
  if (form == 0) {
    if (W < 0 || W > K4_WARP_W) return (int)cudaErrorInvalidValue;
    unsigned grid = (unsigned)((R + K4_WARPS - 1) / K4_WARPS);
    int w = (int)W, th = K4_WARPS * 32;  // u16 pairs: N = 64 R keys a read
    if (w <= 64)
      sort_warp_kernel<1, 2, true><<<grid, th, 0, st>>>(l, R, w, t, ib, b, isb, sb, s);
    else if (w <= 128)
      sort_warp_kernel<2, 2, true><<<grid, th, 0, st>>>(l, R, w, t, ib, b, isb, sb, s);
    else if (w <= 256)
      sort_warp_kernel<4, 2, true><<<grid, th, 0, st>>>(l, R, w, t, ib, b, isb, sb, s);
    else if (w <= 512)
      sort_warp_kernel<8, 2, true><<<grid, th, 0, st>>>(l, R, w, t, ib, b, isb, sb, s);
    else
      sort_warp_kernel<16, 2, true><<<grid, th, 0, st>>>(l, R, w, t, ib, b, isb, sb, s);
  } else if (form == 1) {
    top2_kernel<true><<<(unsigned)R, K3_THREADS, 0, st>>>(l, W, t, ib, b, isb,
                                                          sb, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// form: kernels.counts_form(T1, W); refused where the shape does not fit.
// prior: null, or [R, T1] counts the small form starts from (the other
// forms refuse one).
int launch_counts_top2(const void* lab, const void* prior, long long R,
                       long long W, int T1, int form, void* counts,
                       void* total, void* ibest, void* best, void* isbest,
                       void* sbest, void* stream) {
  if (R == 0) return 0;
  if (R > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  if (prior && form != K5_SMALL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (form == K5_SMALL) {
    if (T1 > K5_SMALL_T1) return (int)cudaErrorInvalidValue;
    size_t smem = (size_t)K5_WARPS * T1 * sizeof(int);
    if (int rc = allow_smem((const void*)counts_small_kernel, smem)) return rc;
    counts_small_kernel<<<(unsigned)((R + K5_WARPS - 1) / K5_WARPS),
                          K5_WARPS * 32, smem, st>>>(
        (const int*)lab, (const int*)prior, R, W, T1, (int*)counts,
        (int*)total, (int*)ibest, (int*)best, (int*)isbest, (int*)sbest);
  } else if (form == K5_LARGE) {
    if (W > K5_TILE_W) return (int)cudaErrorInvalidValue;
    int log2cap = 1;
    while ((1LL << log2cap) < 2 * W) ++log2cap;
    size_t smem = (size_t)2 * sizeof(int) << log2cap;
    if (int rc = allow_smem((const void*)counts_large_kernel, smem)) return rc;
    counts_large_kernel<<<(unsigned)R, K3_THREADS, smem, st>>>(
        (const int*)lab, W, T1, log2cap, (int*)counts, (int*)total,
        (int*)ibest, (int*)best, (int*)isbest, (int*)sbest);
  } else if (form == K5_WIDE) {
    counts_top2_kernel<<<(unsigned)R, K3_THREADS, 0, st>>>(
        (const int*)lab, W, T1, (int*)counts, (int*)total, (int*)ibest,
        (int*)best, (int*)isbest, (int*)sbest);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K9 over Q queries through the directory dir [2^bits + 1].  kmin > kmax
// (an index of no key) gives all misses.
int launch_lookup(const void* keys, const void* labels1, const void* dir,
                  u64 kmin, u64 kmax, int shift, const void* q, void* out,
                  long long Q, void* stream) {
  if (Q == 0) return 0;
  long long blocks = (Q + K9_THREADS - 1) / K9_THREADS;
  if (shift < 0 || shift > 64 || blocks > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  lookup_kernel<<<(unsigned)blocks, K9_THREADS, 0, (cudaStream_t)stream>>>(
      (const u64*)keys, (const int*)labels1, (const int*)dir, kmin, kmax,
      shift, (const u64*)q, (int*)out, Q);
  return (int)cudaGetLastError();
}

// K5's flat form: zero counts, the scatter, then the top-2 a warp a read.
int launch_counts_flat(const void* labels1, const void* read_id, long long Q,
                       long long R, int T1, void* counts, void* total,
                       void* ibest, void* best, void* isbest, void* sbest,
                       void* stream) {
  if (R == 0) return 0;
  // whole blocks: every lane of a warp reaches the scatter's match
  long long blocks = (Q + K9_THREADS - 1) / K9_THREADS;
  if (T1 < 1 || R > 0x7FFFFFFFLL || Q < 0 || blocks > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (cudaError_t e =
          cudaMemsetAsync(counts, 0, (size_t)R * T1 * sizeof(int), st))
    return (int)e;
  if (Q > 0)
    counts_flat_scatter_kernel<<<(unsigned)blocks, K9_THREADS, 0, st>>>(
        (const int*)labels1, (const int*)read_id, Q, R, T1, (int*)counts);
  counts_flat_top2_kernel<<<(unsigned)((R + K5_WARPS - 1) / K5_WARPS),
                            K5_WARPS * 32, 0, st>>>(
      (const int*)counts, R, T1, (int*)total, (int*)ibest, (int*)best,
      (int*)isbest, (int*)sbest);
  return (int)cudaGetLastError();
}

}  // extern "C"
