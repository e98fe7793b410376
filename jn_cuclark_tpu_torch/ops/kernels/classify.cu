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
//                         (device_pipeline.py:159 score_from_labels(True))
//   K7 probe_chunk        radix_table.py:411 probe_chunk (out-of-core cycling)
//   K8 probe_dense        radix_table.py:602 probe_dense (two-plane table)
//
// u64 values arrive as int64 bit patterns and u32 values as int32 bit
// patterns; the kernels read them as unsigned.  Each launcher is a plain C
// function (bound with ctypes): it launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so a
// refused launch surfaces at once.
//
// K1-K4 and K8 are first, simple kernels: one thread per window, one warp
// per query, one block per read.  K5 and K7 are redesigned for the card
// (their notes below say what bounds them and what the design does about
// it).  The DB-build aggregate (K6) lives in aggregate.cu.

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;
typedef unsigned int u32;

#define EMPTY64 0xFFFFFFFFFFFFFFFFull
#define MIX1 0x9E3779B97F4A7C15ull  // 2^64 / golden ratio, odd -> bijective
#define MIX2 0xC2B2AE3D27D4EB4Full  // the dense table's plane-2 mix, odd
#define STASH_CAP 64

// ---------------------------------------------------------------- K1
// Bound by bytes: each window reads two code words and two validity words
// (L1/L2 hits for neighbouring threads of one row) and writes one u64, so
// the [R, W] output write is the DRAM traffic.  One thread per window.

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

// words [R, nw] (2-bit codes, first char in the lowest bits, one zero guard
// word per row), vwords [R, nv] (validity bits) -> q [R, W]: the canonical
// value of the window starting at column p, or EMPTY where the window holds
// an invalid char or runs off the read.
__global__ void window_canonicals_kernel(const u64* __restrict__ words,
                                         const u64* __restrict__ vwords,
                                         u64* __restrict__ q, long long R,
                                         int nw, int nv, int W, int k) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= R * (long long)W) return;
  long long r = i / W;
  int p = (int)(i - r * W);
  const u64* wr = words + r * nw;
  const u64* vr = vwords + r * nv;

  // funnel shift of two words; a shift by 64 is undefined, hence the guard
  int wi = p >> 5, off = (p & 31) * 2;
  u64 val = wr[wi] >> off;
  if (off) val |= wr[wi + 1] << (64 - off);
  if (k < 32) val &= (1ull << (2 * k)) - 1;

  int vi = p >> 6, voff = p & 63;
  u64 vb = vr[vi] >> voff;
  if (voff) vb |= vr[vi + 1] << (64 - voff);
  u64 kmask = (1ull << k) - 1;  // k <= 32
  bool valid = (vb & kmask) == kmask;

  u64 rc = revcomp(val, k);
  u64 canon = val < rc ? val : rc;  // unsigned min
  q[i] = valid ? canon : EMPTY64;
}

// ---------------------------------------------------------------- K2
// Bound by the row gather: each query reads one 2C-word row (1 KiB at
// C = 128) at a random bucket of a table far larger than L2.  One warp per
// query: lane j reads lo/hi words j, j+32, ... so each half-row is read as
// coalesced 128 B segments; the warp reduces the max label with shuffles.
// The 64-entry stash is staged in shared memory once per block.  K8 below
// shares these pieces.

// Stage the stash in shared memory (all threads of the block).
__device__ __forceinline__ void load_stash(const u64* __restrict__ stash_keys,
                                           const int* __restrict__ stash_labels,
                                           u64* sk, int* sl) {
  for (int j = threadIdx.x; j < STASH_CAP; j += blockDim.x) {
    sk[j] = stash_keys[j];
    sl[j] = stash_labels[j];
  }
  __syncthreads();
}

// This lane's largest hit label in one row for a query of quotient qlow
// (0 = none).  hit <=> slot == (qlow << lb) | label: x_hi == 0 and
// x_lo < 2^lb, tested as "no bit at or above lb set".
__device__ __forceinline__ int scan_row(const u32* __restrict__ row, int C,
                                        u64 qlow, int lb, int lane) {
  u64 t = qlow << lb;
  u32 t_lo = (u32)t, t_hi = (u32)(t >> 32);
  u32 above = ~((1u << lb) - 1);
  int best = 0;
  for (int j = lane; j < C; j += 32) {
    u32 xl = row[j] ^ t_lo;
    u32 xh = row[C + j] ^ t_hi;
    if (xh == 0 && (xl & above) == 0) best = max(best, (int)xl);
  }
  return best;
}

// This lane's share of the stash compare; EMPTY stash padding carries
// label 0, so it never raises the max.
__device__ __forceinline__ int scan_stash(const u64* sk, const int* sl, u64 x,
                                          int lane) {
  int best = 0;
  for (int j = lane; j < STASH_CAP; j += 32)
    if (sk[j] == x) best = max(best, sl[j]);
  return best;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void probe_kernel(const u32* __restrict__ slots,
                             const u64* __restrict__ stash_keys,
                             const int* __restrict__ stash_labels,
                             const u64* __restrict__ q, int* __restrict__ out,
                             long long Q, int C, int m1, int lb) {
  __shared__ u64 sk[STASH_CAP];
  __shared__ int sl[STASH_CAP];
  load_stash(stash_keys, stash_labels, sk, sl);
  int lane = threadIdx.x & 31;
  long long qi = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (qi >= Q) return;  // qi is uniform across the warp

  u64 x = q[qi];
  u64 mixed = x * MIX1;  // wraps mod 2^64
  u64 b = mixed >> (64 - m1);
  u64 qlow = mixed & ((1ull << (64 - m1)) - 1);
  int best = scan_row(slots + b * (u64)(2 * C), C, qlow, lb, lane);
  best = warp_max(max(best, scan_stash(sk, sl, x, lane)));
  if (lane == 0) out[qi] = best;
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
// K2 and K8 keep their warp-per-query scan_row above.
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

// ---------------------------------------------------------------- K8
// Replaces radix_table.py:602 probe_dense: the two-plane dense table.  One
// warp per query reads the plane-1 row at (q * MIX1) >> (64 - m1) and the
// plane-2 row at (q * MIX2) >> (64 - m2), each with its own quotient, and
// the shared-memory stash; a key lives in one plane or the stash, so the
// answer is max(lab1, lab2, stash).  Plane 2 holds the ~0.5% of keys that
// plane 1's buckets overflow, a small array that stays in L2, so the
// DRAM-bound cost is plane 1's row reads, as K2's.
__global__ void probe_dense_kernel(const u32* __restrict__ slots1,
                                   const u32* __restrict__ slots2,
                                   const u64* __restrict__ stash_keys,
                                   const int* __restrict__ stash_labels,
                                   const u64* __restrict__ q,
                                   int* __restrict__ out, long long Q, int C,
                                   int m1, int m2, int lb) {
  __shared__ u64 sk[STASH_CAP];
  __shared__ int sl[STASH_CAP];
  load_stash(stash_keys, stash_labels, sk, sl);
  int lane = threadIdx.x & 31;
  long long qi = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (qi >= Q) return;

  u64 x = q[qi];
  u64 x1 = x * MIX1, x2 = x * MIX2;
  u64 b1 = x1 >> (64 - m1), b2 = x2 >> (64 - m2);
  int best = scan_row(slots1 + b1 * (u64)(2 * C), C,
                      x1 & ((1ull << (64 - m1)) - 1), lb, lane);
  best = max(best, scan_row(slots2 + b2 * (u64)(2 * C), C,
                            x2 & ((1ull << (64 - m2)) - 1), lb, lane));
  best = warp_max(max(best, scan_stash(sk, sl, x, lane)));
  if (lane == 0) out[qi] = best;
}

// ---------------------------------------------------------------- K3, K4
// Per read: the count of each nonzero label, then the top two labels under
// (count desc, label asc) -- the reference's resultKernel order
// (CuClarkDB.cu:1361-1411).  One block per read.  A row may hold millions
// of windows, so nothing assumes it fits shared memory: the block first
// finds the row's positive label range [lo, hi], then histograms it in
// shared-memory chunks of K3_HIST labels (one pass over the row per chunk)
// and merges each chunk's top two into a running top two.  Bound by the
// row reads (once, plus once per chunk) and the shared-memory atomics.
//
// K4 (SORTED) also writes the row's labels sorted ascending, zeros first,
// as u16 -- a counting sort from the same histograms: W - total zeros,
// then each chunk's labels at offsets from a block scan of the chunk's
// histogram.  Each output position finds its label by a binary search of
// the scanned histogram, so the writes are coalesced whatever the run
// lengths.  It adds one row write (2 B per window) to K3's traffic.
#define K3_THREADS 128
#define K3_WARPS (K3_THREADS / 32)
#define K3_HIST 8192
#define K4_SPAN (K3_HIST / K3_THREADS)  // histogram entries scanned a thread

// (count desc, label asc) as one u64: larger key ranks higher; 0 = none
__device__ __forceinline__ u64 rank_key(int count, int label) {
  return ((u64)(u32)count << 32) | (u64)(0xFFFFFFFFu - (u32)label);
}

// Top two of two disjoint top-two lists (a1 >= a2, b1 >= b2).
__device__ __forceinline__ void merge2(u64& a1, u64& a2, u64 b1, u64 b2) {
  u64 n1 = max(a1, b1);
  u64 n2 = max(min(a1, b1), max(a2, b2));
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
//          tail masked: rows of 68 B are not 16-B aligned).
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

// Top two of each lane's (a1, a2) across the warp, in every lane.
__device__ __forceinline__ void warp_merge2(u64& a1, u64& a2) {
  for (int o = 16; o; o >>= 1) {
    u64 b1 = __shfl_xor_sync(0xffffffffu, a1, o);
    u64 b2 = __shfl_xor_sync(0xffffffffu, a2, o);
    merge2(a1, a2, b1, b2);
  }
}

__device__ __forceinline__ void push_top2(u64& a1, u64& a2, u64 key) {
  if (key > a1) {
    a2 = a1;
    a1 = key;
  } else if (key > a2) {
    a2 = key;
  }
}

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

__global__ void __launch_bounds__(K5_WARPS * 32)
counts_small_kernel(const int* __restrict__ lab, long long R, long long W,
                    int T1, int* __restrict__ counts, int* __restrict__ total,
                    int* __restrict__ ibest, int* __restrict__ best,
                    int* __restrict__ isbest, int* __restrict__ sbest) {
  extern __shared__ int hist[];  // [nr][T1]: rows r0.. as in `counts`
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long r0 = (long long)blockIdx.x * K5_WARPS;
  int nr = (int)min((long long)K5_WARPS, R - r0);
  for (int j = threadIdx.x; j < nr * T1; j += blockDim.x) hist[j] = 0;
  __syncthreads();
  if (warp < nr) {  // uniform across the warp
    int* h = hist + warp * T1;
    const int* row = lab + (r0 + warp) * W;
    for (long long base = 0; base < W; base += 32 * K5_DEPTH) {
      int v[K5_DEPTH];  // all loads in flight before the first atomic
#pragma unroll
      for (int u = 0; u < K5_DEPTH; ++u) {
        long long j = base + 32 * u + lane;
        v[u] = j < W ? __ldg(row + j) : -1;
      }
#pragma unroll
      for (int u = 0; u < K5_DEPTH; ++u)
        if ((unsigned)v[u] < (unsigned)T1) atomicAdd(&h[v[u]], 1);
    }
    __syncwarp();
    int tot = 0;
    u64 a1 = 0, a2 = 0;
    for (int c = 1 + lane; c < T1; c += 32) {
      int n = h[c];
      tot += n;
      if (n > 0) push_top2(a1, a2, rank_key(n, c));
    }
    for (int o = 16; o; o >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, o);
    warp_merge2(a1, a2);
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

// ---------------------------------------------------------------- launchers
static int grid_for(long long n, int threads, unsigned* grid) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  *grid = (unsigned)blocks;
  return 0;
}

static long long lmin(long long a, long long b) { return a < b ? a : b; }

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

extern "C" {

const char* clark_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int launch_window_canonicals(const void* words, const void* vwords, void* q,
                             long long R, int nw, int nv, int W, int k,
                             void* stream) {
  long long n = R * (long long)W;
  if (n == 0) return 0;
  unsigned grid;
  if (int rc = grid_for(n, 256, &grid)) return rc;
  window_canonicals_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const u64*)words, (const u64*)vwords, (u64*)q, R, nw, nv, W, k);
  return (int)cudaGetLastError();
}

int launch_probe(const void* slots, const void* stash_keys,
                 const void* stash_labels, const void* q, void* out,
                 long long Q, int C, int m1, int lb, void* stream) {
  if (Q == 0) return 0;
  unsigned grid;
  if (int rc = grid_for(Q * 32, 256, &grid)) return rc;
  probe_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const u32*)slots, (const u64*)stash_keys, (const int*)stash_labels,
      (const u64*)q, (int*)out, Q, C, m1, lb);
  return (int)cudaGetLastError();
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

int launch_probe_dense(const void* slots1, const void* slots2,
                       const void* stash_keys, const void* stash_labels,
                       const void* q, void* out, long long Q, int C, int m1,
                       int m2, int lb, void* stream) {
  if (Q == 0) return 0;
  unsigned grid;
  if (int rc = grid_for(Q * 32, 256, &grid)) return rc;
  probe_dense_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const u32*)slots1, (const u32*)slots2, (const u64*)stash_keys,
      (const int*)stash_labels, (const u64*)q, (int*)out, Q, C, m1, m2, lb);
  return (int)cudaGetLastError();
}

int launch_top2(const void* lab, long long R, long long W, void* total,
                void* ibest, void* best, void* isbest, void* sbest,
                void* stream) {
  if (R == 0) return 0;
  if (R > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  top2_kernel<false><<<(unsigned)R, K3_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)lab, W, (int*)total, (int*)ibest, (int*)best, (int*)isbest,
      (int*)sbest, nullptr);
  return (int)cudaGetLastError();
}

int launch_sort_top2(const void* lab, long long R, long long W, void* sorted,
                     void* total, void* ibest, void* best, void* isbest,
                     void* sbest, void* stream) {
  if (R == 0) return 0;
  if (R > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  top2_kernel<true><<<(unsigned)R, K3_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)lab, W, (int*)total, (int*)ibest, (int*)best, (int*)isbest,
      (int*)sbest, (unsigned short*)sorted);
  return (int)cudaGetLastError();
}

// form: kernels.counts_form(T1, W); refused where the shape does not fit.
int launch_counts_top2(const void* lab, long long R, long long W, int T1,
                       int form, void* counts, void* total, void* ibest,
                       void* best, void* isbest, void* sbest, void* stream) {
  if (R == 0) return 0;
  if (R > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  if (form == K5_SMALL) {
    if (T1 > K5_SMALL_T1) return (int)cudaErrorInvalidValue;
    size_t smem = (size_t)K5_WARPS * T1 * sizeof(int);
    if (int rc = allow_smem((const void*)counts_small_kernel, smem)) return rc;
    counts_small_kernel<<<(unsigned)((R + K5_WARPS - 1) / K5_WARPS),
                          K5_WARPS * 32, smem, st>>>(
        (const int*)lab, R, W, T1, (int*)counts, (int*)total, (int*)ibest,
        (int*)best, (int*)isbest, (int*)sbest);
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

}  // extern "C"
