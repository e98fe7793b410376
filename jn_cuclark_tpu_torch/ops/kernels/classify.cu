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
// These are first, simple kernels: one thread per window, one warp per
// query, one block per read.  Making them fast is later work.  The DB-build
// aggregate (K6) lives in aggregate.cu.

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
// The 64-entry stash is staged in shared memory once per block.  K7 and K8
// below share these pieces.

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
// Replaces radix_table.py:411 probe_chunk (out-of-core cycling): K2 against
// one chunk of rows [start_row, start_row + rows_per) of a 2^m1-row table.
// lrow = bucket - start_row is taken in signed 64-bit: in u64 a bucket
// below the chunk would wrap to a huge value.  A query bucketed outside
// the chunk reads no row and gets 0; the stash counts only in the chunk
// that carries it (use_stash), so each key is counted once over a pass of
// all chunks.  rows_per need not be a power of two (chunk_table pads the
// last chunk).  Bound like K2 by the rows it reads, here only for the
// queries whose bucket lies in the chunk (about 1/cycles of them).
__global__ void probe_chunk_kernel(const u32* __restrict__ slots,
                                   const u64* __restrict__ stash_keys,
                                   const int* __restrict__ stash_labels,
                                   const u64* __restrict__ q,
                                   int* __restrict__ out, long long Q, int C,
                                   int m1, int lb, long long start_row,
                                   long long rows_per, int use_stash) {
  __shared__ u64 sk[STASH_CAP];
  __shared__ int sl[STASH_CAP];
  if (use_stash) load_stash(stash_keys, stash_labels, sk, sl);
  int lane = threadIdx.x & 31;
  long long qi = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (qi >= Q) return;

  u64 x = q[qi];
  u64 mixed = x * MIX1;
  long long lrow = (long long)(mixed >> (64 - m1)) - start_row;  // m1 >= 1
  u64 qlow = mixed & ((1ull << (64 - m1)) - 1);
  int best = 0;
  if (lrow >= 0 && lrow < rows_per)  // uniform across the warp
    best = scan_row(slots + (u64)lrow * (u64)(2 * C), C, qlow, lb, lane);
  if (use_stash) best = max(best, scan_stash(sk, sl, x, lane));
  best = warp_max(best);
  if (lane == 0) out[qi] = best;
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
// target index first; 0 = NA).  One block per read: the block zeroes its
// row of the count matrix, adds each window with a global atomic, then
// reduces the row.  At T = 65,535 a row is 256 KiB, too large for shared
// memory, so it stays in device memory; bound by those row writes and
// reads (the count matrix is the output the host fetches anyway).
// Labels outside [0, T] are dropped, as segment_sum drops them.
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

int launch_probe_chunk(const void* slots, const void* stash_keys,
                       const void* stash_labels, const void* q, void* out,
                       long long Q, int C, int m1, int lb,
                       long long start_row, long long rows_per, int use_stash,
                       void* stream) {
  if (Q == 0) return 0;
  unsigned grid;
  if (int rc = grid_for(Q * 32, 256, &grid)) return rc;
  probe_chunk_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const u32*)slots, (const u64*)stash_keys, (const int*)stash_labels,
      (const u64*)q, (int*)out, Q, C, m1, lb, start_row, rows_per, use_stash);
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

int launch_counts_top2(const void* lab, long long R, long long W, int T1,
                       void* counts, void* total, void* ibest, void* best,
                       void* isbest, void* sbest, void* stream) {
  if (R == 0) return 0;
  if (R > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  counts_top2_kernel<<<(unsigned)R, K3_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)lab, W, T1, (int*)counts, (int*)total, (int*)ibest,
      (int*)best, (int*)isbest, (int*)sbest);
  return (int)cudaGetLastError();
}

}  // extern "C"
