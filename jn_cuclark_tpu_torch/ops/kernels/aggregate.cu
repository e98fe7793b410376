// Hand-written Hopper (sm_90a) kernel of the DB-build aggregate.
//
//   K6 aggregate   jn_cuclark_tpu/db/device_build.py:30 _aggregate_device
//                  (and the compaction of its aggregate_device, l.52)
//
// The build groups the occurrences of each canonical k-mer and applies the
// reference's update rule (HashTableStorage_hh.hh:422-461): per group, the
// label L0 of its first occurrence (smallest stream index), multiplicity
//     mult = min(1 + sum[(l != L0) + (pg[l] != pg[L0])], 255)
// (pg = a label's prefix group, the "centromere" pairing), the count
// (capped at 254 under the 8-bit lElement counter) and the first stream
// index; one row per distinct canonical, ascending as u64.
//
// None of a row's fields depends on the order inside a group once its
// smallest stream index is known, so keys need ordering between groups
// only: a bucket sort whose buckets fit one warp's registers, fused with
// the group pass.  The level plan (which digits, which buckets split) is
// host code, ops/bucket_plan.py; these are its launches:
//
//   range_kernel     min and max key (read back: the first level's digit)
//   hist_kernel      per bucket of the level's digit: count, min, max key;
//                    shared-memory histograms, one global atomic per block
//                    and non-empty bucket
//   scan_kernel      bucket starts, an exclusive scan of the counts
//   scatter_kernel   each occurrence to its bucket as a 16-B entry (key,
//                    seq << 32 | label): a block counts its chunk in shared
//                    memory, takes one cursor per bucket with one global
//                    atomic, then re-reads the chunk a tile at a time,
//                    orders the tile by bucket in shared memory and writes
//                    each bucket's run of it as consecutive stores; a
//                    warp's lanes with one digit share one shared atomic
//                    (__match_any_sync), so a hot bucket (the 2^64-1 pad)
//                    does not serialise the warp
//                    (hist, scan and scatter take every range of a level
//                    at once: a table of ranges, each with its own digit,
//                    and a table of blocks, none across two ranges)
//   bucket_kernel    one warp per bucket of at most CAP = 256 entries: a
//                    bitonic sort in registers of one u64 an entry, (key -
//                    the bucket's min) << 8 | its place, then the groups by
//                    a warp scan; a group's smallest (seq << 32 | label),
//                    size and change terms by shared atomics; the rows
//                    written at the bucket's start
//   single_*         a bucket over CAP entries of one key: a grid-wide min
//                    of (seq << 32 | label), the change terms' sum, the row
//   tile_*, compact  the rows gathered in key order: each place holds a
//                    flag (a staged row there, and its layout, or none);
//                    the flags' exclusive scan by tiles places each row
//
// A bucket fits a warp, so 21M occurrences need 2^18 buckets: the plan
// takes two levels of 9 bits, where one of 13 and one of 5 would leave the
// first scatter's tiles under one entry a bucket, stores that do not
// coalesce.  Buckets over
// CAP entries with several keys go through hist, scan and scatter again on
// their own key range (the next level), between the two entry buffers.  A
// leaf stages its rows at its own start: (canon, first << 32 | L0) in the
// buffer that held its entries, (count, mult) in the other, whose
// positions there are dead by then.
//
// Bound by bytes: per level the keys read by hist and the scatter's two
// passes, the entries written (16 B) and read back; the rows staged and
// copied out (about 64 B a group).  The sort runs in registers.
//
// Each launcher is a plain C function (bound with ctypes): it launches on
// the caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;
typedef unsigned int u32;

#define FULL 0xFFFFFFFFu
#define NO_DIGIT 0xFFFFFFFFu
#define CAP 256            // entries of a bucket: one warp, 8 a lane
#define MAX_BUCKETS 8192   // 2^13: a level's digit, at most
#define LOW32 0xFFFFFFFFull
#define IDX_BITS 8         // an entry's place in its bucket: CAP = 2^8
#define IDX_MASK ((1ull << IDX_BITS) - 1)
#define U 4                // entries a lane takes at once in hist, scatter
#define WARPS 4            // buckets (warps) a block of the bucket pass

struct __align__(16) Entry {
  u64 key;
  u64 val;  // seq << 32 | label; a staged row: first << 32 | L0
};

static int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

__device__ __forceinline__ u32 digit_of(u64 key, int shift, u32 mask) {
  return (u32)(key >> shift) & mask;
}

__device__ __forceinline__ u64 warp_min(u64 v) {
  for (int o = 16; o; o >>= 1) {
    u64 w = __shfl_down_sync(FULL, v, o);
    v = w < v ? w : v;
  }
  return v;
}

__device__ __forceinline__ u64 warp_max(u64 v) {
  for (int o = 16; o; o >>= 1) {
    u64 w = __shfl_down_sync(FULL, v, o);
    v = w > v ? w : v;
  }
  return v;
}

__device__ __forceinline__ u64 warp_sum(u64 v) {
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

// In-place inclusive scan of part[0..blockDim.x) (blockDim.x a power of
// two at most 1024).
__device__ void block_scan(u32* part) {
  int t = threadIdx.x;
  for (int o = 1; o < blockDim.x; o <<= 1) {
    u32 v = t >= o ? part[t - o] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
}

// out[0] = min key, out[1] = max key (pre-set to ~0 and 0).
__global__ void range_kernel(const u64* __restrict__ keys, long long n,
                             u64* __restrict__ out) {
  __shared__ u64 smin[32], smax[32];
  u64 lo = ~0ull, hi = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    u64 k = keys[i];
    lo = k < lo ? k : lo;
    hi = k > hi ? k : hi;
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    smin[w] = lo;
    smax[w] = hi;
  }
  __syncthreads();
  if (w == 0) {
    int nw = blockDim.x >> 5;
    lo = lane < nw ? smin[lane] : ~0ull;
    hi = lane < nw ? smax[lane] : 0;
    lo = warp_min(lo);
    hi = warp_max(hi);
    if (lane == 0) {
      atomicMin(&out[0], lo);
      atomicMax(&out[1], hi);
    }
  }
}

// The level's source: the inputs in stream order (FROM_INPUT: seq is the
// position) or a range of entries.
template <bool FROM_INPUT>
__device__ __forceinline__ u64 key_at(const u64* keys_in, const Entry* src,
                                      long long i) {
  return FROM_INPUT ? keys_in[i] : src[i].key;
}

// A level's table: one row (start, count, shift, nbits, bucket offset) per
// range; its blocks: one row (range, first position, end) per block.
struct Block {
  int shift;
  u32 mask;
  int nb;
  long long boff, b0, b1;
};

__device__ __forceinline__ Block block_of(const long long* table,
                                          const long long* blocks) {
  const long long* bl = blocks + 3 * (long long)blockIdx.x;
  const long long* r = table + 5 * bl[0];
  Block b;
  b.shift = (int)r[2];
  b.nb = 1 << (int)r[3];
  b.mask = (u32)b.nb - 1;
  b.boff = r[4];
  b.b0 = bl[1];
  b.b1 = bl[2];
  return b;
}

// plan [3][NB]: counts, min keys, max keys of every bucket of the level
// (pre-set to 0, ~0, 0).
template <bool FROM_INPUT>
__global__ void hist_kernel(const u64* __restrict__ keys_in,
                            const Entry* __restrict__ src,
                            const long long* __restrict__ table,
                            const long long* __restrict__ blocks,
                            long long NB, u64* __restrict__ plan) {
  extern __shared__ u64 hsm[];
  Block k = block_of(table, blocks);
  u64* smin = hsm;
  u64* smax = smin + k.nb;
  u32* scnt = (u32*)(smax + k.nb);
  for (int b = threadIdx.x; b < k.nb; b += blockDim.x) {
    smin[b] = ~0ull;
    smax[b] = 0;
    scnt[b] = 0;
  }
  __syncthreads();
  int lane = threadIdx.x & 31;
  // a warp takes U runs of 32 positions at once
  for (long long base = k.b0 + (threadIdx.x >> 5) * 32LL * U; base < k.b1;
       base += (long long)blockDim.x * U) {
    u64 key[U];
    u32 d[U];
#pragma unroll
    for (int u = 0; u < U; u++) {
      long long i = base + u * 32 + lane;
      key[u] = i < k.b1 ? key_at<FROM_INPUT>(keys_in, src, i) : 0;
      d[u] = i < k.b1 ? digit_of(key[u], k.shift, k.mask) : NO_DIGIT;
    }
#pragma unroll
    for (int u = 0; u < U; u++) {
      u32 peers = __match_any_sync(FULL, d[u]);
      if (d[u] != NO_DIGIT) {
        if (lane == __ffs(peers) - 1) atomicAdd(&scnt[d[u]], __popc(peers));
        if (key[u] < smin[d[u]]) atomicMin(&smin[d[u]], key[u]);
        if (key[u] > smax[d[u]]) atomicMax(&smax[d[u]], key[u]);
      }
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < k.nb; b += blockDim.x) {
    if (scnt[b]) {
      atomicAdd(&plan[k.boff + b], (u64)scnt[b]);
      atomicMin(&plan[NB + k.boff + b], smin[b]);
      atomicMax(&plan[2 * NB + k.boff + b], smax[b]);
    }
  }
}

// starts[b] = cursor[b] = the range's start + the counts of its buckets
// before b; one block per range.
__global__ void scan_kernel(const u64* __restrict__ counts,
                            const long long* __restrict__ table,
                            long long* __restrict__ starts,
                            u64* __restrict__ cursor) {
  __shared__ u32 part[1024];
  const long long* r = table + 5 * (long long)blockIdx.x;
  int nb = 1 << (int)r[3];
  long long boff = r[4];
  int t = threadIdx.x;
  int per = (nb + blockDim.x - 1) / blockDim.x;
  int b0 = t * per, b1 = b0 + per < nb ? b0 + per : nb;
  u64 sum = 0;
  for (int b = b0; b < b1; b++) sum += counts[boff + b];
  // a range holds fewer than 2^32 entries, so u32 partial sums suffice
  part[t] = (u32)sum;
  __syncthreads();
  block_scan(part);
  u64 run = (u64)r[0] + part[t] - (u32)sum;
  for (int b = b0; b < b1; b++) {
    starts[boff + b] = (long long)run;
    cursor[boff + b] = run;
    run += counts[boff + b];
  }
}

// The scatter stages STILE entries at a time in shared memory, ordered by
// bucket, so that a bucket's entries of the tile go out as one run of
// consecutive 16-B stores: at 512 buckets a tile's run is 8 entries, one
// 128-B line.  Shared memory: the staged entries, their digits, and three
// counters a bucket (the block's cursor, the tile's count and offset).
#define STILE 4096

__host__ __device__ constexpr size_t scatter_smem(int nb) {
  return (size_t)STILE * 16 + (size_t)STILE * 2 + (size_t)nb * 12;
}

template <bool FROM_INPUT>
__global__ void scatter_kernel(const u64* __restrict__ keys_in,
                               const int* __restrict__ label_in,
                               const Entry* __restrict__ src,
                               const long long* __restrict__ table,
                               const long long* __restrict__ blocks,
                               u64* __restrict__ cursor,
                               Entry* __restrict__ dst) {
  extern __shared__ Entry stage[];
  Block k = block_of(table, blocks);
  unsigned short* sdig = (unsigned short*)(stage + STILE);
  u32* scur = (u32*)(sdig + STILE);
  u32* tcnt = scur + k.nb;
  u32* toff = tcnt + k.nb;
  __shared__ u32 part[1024];
  int t = threadIdx.x, lane = t & 31;
  u32 lt = (1u << lane) - 1;
  for (int b = t; b < k.nb; b += blockDim.x) scur[b] = 0;
  __syncthreads();
  for (long long base = k.b0 + (t >> 5) * 32LL * U; base < k.b1;
       base += (long long)blockDim.x * U) {
    u32 d[U];
#pragma unroll
    for (int u = 0; u < U; u++) {
      long long i = base + u * 32 + lane;
      d[u] = i < k.b1 ? digit_of(key_at<FROM_INPUT>(keys_in, src, i), k.shift,
                                 k.mask)
                      : NO_DIGIT;
    }
#pragma unroll
    for (int u = 0; u < U; u++) {
      u32 peers = __match_any_sync(FULL, d[u]);
      if (d[u] != NO_DIGIT && lane == __ffs(peers) - 1)
        atomicAdd(&scur[d[u]], __popc(peers));
    }
  }
  __syncthreads();
  // the block's cursor of each bucket: positions fit u32 (n < 2^32)
  for (int b = t; b < k.nb; b += blockDim.x)
    if (scur[b]) scur[b] = (u32)atomicAdd(&cursor[k.boff + b], (u64)scur[b]);
  int per = (k.nb + blockDim.x - 1) / blockDim.x;
  for (long long t0 = k.b0; t0 < k.b1; t0 += STILE) {
    int tn = k.b1 - t0 < STILE ? (int)(k.b1 - t0) : STILE;
    for (int b = t; b < k.nb; b += blockDim.x) tcnt[b] = 0;
    __syncthreads();
    // the tile's entries (U a thread, striped), each with its rank among
    // the tile's entries of its bucket
    Entry e[U];
    u32 d[U], rank[U];
#pragma unroll
    for (int u = 0; u < U; u++) {
      int j = u * blockDim.x + t;
      long long i = t0 + j;
      bool on = j < tn;
      if (FROM_INPUT) {
        e[u].key = on ? keys_in[i] : 0;
        e[u].val = on ? ((u64)i << 32) | (u32)label_in[i] : 0;
      } else {
        e[u] = on ? src[i] : Entry{0, 0};
      }
      d[u] = on ? digit_of(e[u].key, k.shift, k.mask) : NO_DIGIT;
    }
#pragma unroll
    for (int u = 0; u < U; u++) {
      u32 peers = __match_any_sync(FULL, d[u]);
      int leader = __ffs(peers) - 1;
      u32 r = 0;
      if (d[u] != NO_DIGIT && lane == leader)
        r = atomicAdd(&tcnt[d[u]], __popc(peers));
      rank[u] = __shfl_sync(FULL, r, leader) + __popc(peers & lt);
    }
    __syncthreads();
    // the tile's offset of each bucket: an exclusive scan of tcnt
    int b0 = t * per, b1 = b0 + per < k.nb ? b0 + per : k.nb;
    u32 sum = 0;
    for (int b = b0; b < b1; b++) sum += tcnt[b];
    part[t] = sum;
    __syncthreads();
    block_scan(part);
    u32 run = part[t] - sum;
    for (int b = b0; b < b1; b++) {
      toff[b] = run;
      run += tcnt[b];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < U; u++) {
      if (d[u] != NO_DIGIT) {
        u32 at = toff[d[u]] + rank[u];
        stage[at] = e[u];
        sdig[at] = (unsigned short)d[u];
      }
    }
    __syncthreads();
    // out in stage order: a bucket's entries of the tile are consecutive
    for (int j = t; j < tn; j += blockDim.x) {
      u32 dd = sdig[j];
      dst[scur[dd] + (j - toff[dd])] = stage[j];
    }
    __syncthreads();
    for (int b = t; b < k.nb; b += blockDim.x) scur[b] += tcnt[b];
  }
}

// Compare-and-swap of a bitonic stage: afterwards a <= b where up, else
// a >= b.
__device__ __forceinline__ void cas(u64& a, u64& b, bool up) {
  u64 lo = a < b ? a : b, hi = a < b ? b : a;
  a = up ? lo : hi;
  b = up ? hi : lo;
}

// The stages (k, J) with J < E: both elements in one lane's registers.
template <int E, int J>
__device__ __forceinline__ void stage_in_lane(u64 (&x)[E], int i0, int k) {
#pragma unroll
  for (int q = 0; q < E; q++)
    if ((q & J) == 0) cas(x[q], x[q + J], ((i0 + q) & k) == 0);
}

// Bitonic sort of a warp's 32E keys, lane l holding positions [l*E,
// l*E + E) in x.  Stage (k, j) compares i with i + j for each i whose bit
// j is clear, ascending where bit k of i is clear: j < E in the lane's
// registers, larger j by warp shuffles.  Returns with x sorted, blocked as
// before.
template <int E>
__device__ __forceinline__ void warp_bitonic(u64 (&x)[E], int lane) {
  int i0 = lane * E;
#pragma unroll
  for (int k = 2; k <= 32 * E; k <<= 1) {
    int j = k >> 1;
    for (; j >= E; j >>= 1) {
      int lm = j / E;  // the partner's lane is lane ^ lm
      bool lower = (lane & lm) == 0;
#pragma unroll
      for (int q = 0; q < E; q++) {
        u64 y = __shfl_xor_sync(FULL, x[q], lm);
        bool keep_min = lower == (((i0 + q) & k) == 0);
        x[q] = keep_min ? (y < x[q] ? y : x[q]) : (y > x[q] ? y : x[q]);
      }
    }
    if (E > 4 && j == 4) {
      stage_in_lane<E, (E > 4 ? 4 : 0)>(x, i0, k);
      j >>= 1;
    }
    if (E > 2 && j == 2) {
      stage_in_lane<E, (E > 2 ? 2 : 0)>(x, i0, k);
      j >>= 1;
    }
    if (j == 1) stage_in_lane<E, 1>(x, i0, k);
  }
}

// One bucket of m entries (1..32E) from place st: sort, groups, rows.
template <int E>
__device__ __forceinline__ void bucket_rows(
    Entry* __restrict__ bufc, Entry* __restrict__ bufo, u64 bmin,
    long long st, u32 m, const int* __restrict__ pg, int lelement,
    unsigned char flag, unsigned char* __restrict__ rowflag, u64* vals,
    u64* gmin, u32* dsum, u32* gcnt, int lane) {
  int i0 = lane * E;
  u64 x[E];
#pragma unroll
  for (int q = 0; q < E; q++) {
    u32 i = i0 + q;
    if (i < m) {
      Entry e = bufc[st + i];
      x[q] = ((e.key - bmin) << IDX_BITS) | i;
      vals[i] = e.val;
    } else {
      x[q] = ~0ull;  // pads sort after every entry
    }
  }
  for (int i = lane; i < 32 * E; i += 32) {
    gmin[i] = ~0ull;
    dsum[i] = 0;
    gcnt[i] = 0;
  }
  warp_bitonic<E>(x, lane);
  __syncwarp();
  // group starts: the flags of the lane's run, then a warp scan
  u64 prev = __shfl_up_sync(FULL, x[E - 1] >> IDX_BITS, 1);
  u32 flags = 0, mine = 0;
#pragma unroll
  for (int q = 0; q < E; q++) {
    u32 i = i0 + q;
    u64 kq = x[q] >> IDX_BITS;
    bool s = i < m && (i == 0 || kq != prev);
    flags |= (u32)s << q;
    mine += s;
    prev = kq;
  }
  u32 inc = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    u32 y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  u32 g0 = inc - mine, ng = __shfl_sync(FULL, inc, 31);
  // each group's min val and size, one shared atomic per group and run
  int gi = (int)g0 - 1;
  u64 vmin = ~0ull;
  u32 run = 0;
#pragma unroll
  for (int q = 0; q < E; q++) {
    if (i0 + q < (int)m) {
      if (flags >> q & 1) {
        if (run) {
          atomicMin(&gmin[gi], vmin);
          atomicAdd(&gcnt[gi], run);
        }
        vmin = ~0ull;
        run = 0;
        gi++;
      }
      u64 v = vals[x[q] & IDX_MASK];
      vmin = v < vmin ? v : vmin;
      run++;
    }
  }
  if (run) {
    atomicMin(&gmin[gi], vmin);
    atomicAdd(&gcnt[gi], run);
  }
  __syncwarp();
  // the change terms against each group's L0
  gi = (int)g0 - 1;
  u32 acc = 0;
#pragma unroll
  for (int q = 0; q < E; q++) {
    if (i0 + q < (int)m) {
      if (flags >> q & 1) {
        if (acc) atomicAdd(&dsum[gi], acc);
        acc = 0;
        gi++;
      }
      int l = (int)(vals[x[q] & IDX_MASK] & LOW32);
      int l0 = (int)(gmin[gi] & LOW32);
      acc += (l != l0) + (pg[l] != pg[l0]);
    }
  }
  if (acc) atomicAdd(&dsum[gi], acc);
  __syncwarp();
  // the rows of the groups that start in this run
  u32 g = g0;
#pragma unroll
  for (int q = 0; q < E; q++) {
    if (flags >> q & 1) {
      u64 cnt = gcnt[g], mult = 1 + (u64)dsum[g];
      bufc[st + g] = Entry{bmin + (x[q] >> IDX_BITS), gmin[g]};
      bufo[st + g] = Entry{lelement && cnt > 254 ? 254 : cnt,
                           mult < 255 ? mult : 255};
      g++;
    }
  }
  // a row at each of the bucket's first ng places, none past them
  for (u32 i = lane; i < m; i += 32) rowflag[st + i] = i < ng ? flag : 0;
}

// One warp per bucket of the level; a launch takes the buckets whose sort
// length is 32E (E = 2, 4 or 8: 1-64, 65-128 or 129-256 entries), and
// the other warps return at once.  A key
// differs from its bucket's min in its low KEY_BITS = 56 bits at most (the
// plan's digit leaves no more below it), so the warp sorts one u64 per
// entry: (key - min) << IDX_BITS | the entry's place in the bucket.  A
// group's smallest (seq << 32 | label) -- its first seq and L0 -- its
// size and its change terms are shared-memory atomics of the lanes' runs.
template <int E>
__global__ void bucket_kernel(Entry* __restrict__ bufc,
                              Entry* __restrict__ bufo,
                              const u64* __restrict__ plan, long long NB,
                              const long long* __restrict__ starts,
                              const int* __restrict__ pg, int lelement,
                              unsigned char flag,
                              unsigned char* __restrict__ rowflag) {
  __shared__ u64 s_vals[WARPS][CAP], s_gmin[WARPS][CAP];
  __shared__ u32 s_dsum[WARPS][CAP], s_gcnt[WARPS][CAP];
  int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long b = (long long)blockIdx.x * WARPS + w;
  if (b >= NB) return;  // no block-wide barrier follows
  u32 m = (u32)plan[b];
  // this launch's buckets: those whose sort length is 32E
  if (m == 0 || m > 32 * E || (E > 2 && m <= 16 * E)) return;
  bucket_rows<E>(bufc, bufo, plan[NB + b], starts[b], m, pg, lelement, flag,
                 rowflag, s_vals[w], s_gmin[w], s_dsum[w], s_gcnt[w], lane);
}

// slot [2][nl]: the min (seq << 32 | label) of each single-key leaf, then
// its change terms' sum (pre-set to ~0 and 0).  Grid (x, leaf).  The min
// pass also clears the row flags of the leaf's places past its first.
__global__ void single_min_kernel(const Entry* __restrict__ buf,
                                  const long long* __restrict__ lstart,
                                  const long long* __restrict__ lcount,
                                  u64* __restrict__ slot,
                                  unsigned char* __restrict__ rowflag) {
  __shared__ u64 sw[32];
  int leaf = blockIdx.y;
  long long st = lstart[leaf], c = lcount[leaf];
  u64 v = ~0ull;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < c;
       i += (long long)gridDim.x * blockDim.x) {
    u64 x = buf[st + i].val;
    v = x < v ? x : v;
    if (i) rowflag[st + i] = 0;
  }
  v = warp_min(v);
  if ((threadIdx.x & 31) == 0) sw[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < (blockDim.x >> 5) ? sw[threadIdx.x] : ~0ull;
    v = warp_min(v);
    if (threadIdx.x == 0) atomicMin(&slot[leaf], v);
  }
}

__global__ void single_dsum_kernel(const Entry* __restrict__ buf,
                                   const long long* __restrict__ lstart,
                                   const long long* __restrict__ lcount,
                                   const int* __restrict__ pg, int nl,
                                   u64* __restrict__ slot) {
  __shared__ u64 sw[32];
  int leaf = blockIdx.y;
  long long st = lstart[leaf], c = lcount[leaf];
  int l0 = (int)(slot[leaf] & LOW32), p0 = pg[l0];
  u64 acc = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < c;
       i += (long long)gridDim.x * blockDim.x) {
    int l = (int)(buf[st + i].val & LOW32);
    acc += (l != l0) + (pg[l] != p0);
  }
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) sw[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    acc = threadIdx.x < (blockDim.x >> 5) ? sw[threadIdx.x] : 0;
    acc = warp_sum(acc);
    if (threadIdx.x == 0 && acc) atomicAdd(&slot[nl + leaf], acc);
  }
}

__global__ void single_rows_kernel(Entry* __restrict__ bufc,
                                   Entry* __restrict__ bufo,
                                   const long long* __restrict__ lstart,
                                   const long long* __restrict__ lcount,
                                   const u64* __restrict__ slot, int nl,
                                   int lelement, unsigned char flag,
                                   unsigned char* __restrict__ rowflag) {
  int leaf = blockIdx.x * blockDim.x + threadIdx.x;
  if (leaf >= nl) return;
  long long st = lstart[leaf];
  u64 c = (u64)lcount[leaf], mult = 1 + slot[nl + leaf];
  bufc[st].val = slot[leaf];
  bufo[st] = Entry{lelement && c > 254 ? 254 : c, mult < 255 ? mult : 255};
  rowflag[st] = flag;
}

// The compaction: every place p < n holds a flag, 0 or the layout of a
// staged row (1: (canon, first << 32 | L0) in buffer 0 and (count, mult)
// in buffer 1; 2: the other way round); the rows go out in place order,
// which is key order.  Tiles of TILE places (4 a thread): each tile's row
// count, their exclusive scan (one block), then each tile's rows.
#define TILE 4096

__device__ __forceinline__ u32 tile_flags(const unsigned char* rowflag,
                                          long long n, long long p0,
                                          unsigned char (&f)[4]) {
  u32 c = 0;
#pragma unroll
  for (int q = 0; q < 4; q++) {
    f[q] = p0 + q < n ? rowflag[p0 + q] : 0;
    c += f[q] != 0;
  }
  return c;
}

__global__ void tile_count_kernel(const unsigned char* __restrict__ rowflag,
                                  long long n, u32* __restrict__ tcount) {
  __shared__ u32 sw[32];
  unsigned char f[4];
  long long p0 = (long long)blockIdx.x * TILE + threadIdx.x * 4;
  u32 c = tile_flags(rowflag, n, p0, f);
  for (int o = 16; o; o >>= 1) c += __shfl_down_sync(FULL, c, o);
  if ((threadIdx.x & 31) == 0) sw[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x < 32) {
    c = sw[threadIdx.x];
    for (int o = 16; o; o >>= 1) c += __shfl_down_sync(FULL, c, o);
    if (threadIdx.x == 0) tcount[blockIdx.x] = c;
  }
}

// tbase[i] = rows of the tiles before tile i; *total = all rows.  One
// block of 1024 threads.
__global__ void tile_scan_kernel(const u32* __restrict__ tcount, long long nt,
                                 long long* __restrict__ tbase,
                                 long long* __restrict__ total) {
  __shared__ u32 part[1024];
  int t = threadIdx.x, T = blockDim.x;
  long long carry = 0;
  for (long long base = 0; base < nt; base += T) {
    long long i = base + t;
    u32 v = i < nt ? tcount[i] : 0;
    part[t] = v;
    __syncthreads();
    block_scan(part);  // at most 1024 x TILE rows: fits u32
    if (i < nt) tbase[i] = carry + part[t] - v;
    carry += part[T - 1];
    __syncthreads();
  }
  if (t == 0) *total = carry;
}

// A tile's places go in 4 rounds of 1024 consecutive places, one a thread,
// so the staged rows are read coalesced; a round's rows take their offsets
// from a ballot in each warp and a scan of the 32 warps' counts, and land
// at consecutive outputs.
__global__ void compact_kernel(const Entry* __restrict__ buf0,
                               const Entry* __restrict__ buf1,
                               const unsigned char* __restrict__ rowflag,
                               long long n,
                               const long long* __restrict__ tbase,
                               long long* __restrict__ out_canon,
                               int* __restrict__ out_l0,
                               int* __restrict__ out_mult,
                               long long* __restrict__ out_count,
                               long long* __restrict__ out_first) {
  __shared__ u32 wsum[32];
  int t = threadIdx.x, w = t >> 5, lane = t & 31;
  long long o = tbase[blockIdx.x];
  for (int r = 0; r < TILE / 1024; r++) {
    long long p = (long long)blockIdx.x * TILE + r * 1024 + t;
    unsigned char f = p < n ? rowflag[p] : 0;
    u32 mask = __ballot_sync(FULL, f != 0);
    if (lane == 0) wsum[w] = __popc(mask);
    __syncthreads();
    u32 before = 0, all = 0;
    for (int i = 0; i < 32; i++) {
      u32 c = wsum[i];
      before += i < w ? c : 0;
      all += c;
    }
    if (f) {
      long long q = o + before + __popc(mask & ((1u << lane) - 1));
      Entry x = (f == 1 ? buf0 : buf1)[p];
      Entry y = (f == 1 ? buf1 : buf0)[p];
      out_canon[q] = (long long)x.key;
      out_l0[q] = (int)(x.val & LOW32);
      out_first[q] = (long long)(x.val >> 32);
      out_count[q] = (long long)y.key;
      out_mult[q] = (int)y.val;
    }
    o += all;
    __syncthreads();
  }
}

template <int E>
static int bucket_launch(void* bufc, void* bufo, const void* plan,
                         long long NB, const void* starts, const void* pg,
                         int lelement, int flag, void* rowflag,
                         cudaStream_t stream) {
  long long grid = (NB + WARPS - 1) / WARPS;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  bucket_kernel<E><<<(unsigned)grid, 32 * WARPS, 0, stream>>>(
      (Entry*)bufc, (Entry*)bufo, (const u64*)plan, NB,
      (const long long*)starts, (const int*)pg, lelement,
      (unsigned char)flag, (unsigned char*)rowflag);
  return (int)cudaGetLastError();
}

extern "C" {

const char* clark_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int launch_agg_range(const void* keys, long long n, void* out,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(out, 0xFF, 8, s);
  cudaMemsetAsync((char*)out + 8, 0, 8, s);
  long long g = (n + 256 * 8 - 1) / (256 * 8);
  long long gmax = 4LL * sm_count();
  range_kernel<<<(unsigned)(g < gmax ? (g > 0 ? g : 1) : gmax), 256, 0, s>>>(
      (const u64*)keys, n, (u64*)out);
  return (int)cudaGetLastError();
}

// One launch partitions every range of a level: hist and scatter over the
// nblk blocks of `blocks`, the scan with one block per range; max_nb is the
// level's largest bucket count of a range.
int launch_agg_partition(const void* keys_in, const void* label_in,
                         const void* src, int from_input, const void* table,
                         long long n_ranges, const void* blocks,
                         long long nblk, long long NB, int max_nb, void* plan,
                         void* starts, void* cursor, void* dst,
                         void* stream) {
  if (max_nb < 1 || max_nb > MAX_BUCKETS || nblk < 1 || n_ranges < 1 ||
      nblk > 0x7FFFFFFFLL || n_ranges > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(plan, 0, 8 * (size_t)NB, st);
  cudaMemsetAsync((u64*)plan + NB, 0xFF, 8 * (size_t)NB, st);
  cudaMemsetAsync((u64*)plan + 2 * NB, 0, 8 * (size_t)NB, st);
  size_t hsmem = (size_t)max_nb * 20, ssmem = scatter_smem(max_nb);
  const long long* tab = (const long long*)table;
  if (from_input) {
    cudaFuncSetAttribute(hist_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)hsmem);
    hist_kernel<true><<<(unsigned)nblk, 1024, hsmem, st>>>(
        (const u64*)keys_in, (const Entry*)src, tab,
        (const long long*)blocks, NB, (u64*)plan);
  } else {
    cudaFuncSetAttribute(hist_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)hsmem);
    hist_kernel<false><<<(unsigned)nblk, 1024, hsmem, st>>>(
        (const u64*)keys_in, (const Entry*)src, tab,
        (const long long*)blocks, NB, (u64*)plan);
  }
  if (cudaError_t rc = cudaGetLastError()) return (int)rc;
  scan_kernel<<<(unsigned)n_ranges, 1024, 0, st>>>(
      (const u64*)plan, tab, (long long*)starts, (u64*)cursor);
  if (cudaError_t rc = cudaGetLastError()) return (int)rc;
  cudaFuncSetAttribute(scatter_kernel<true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)ssmem);
  cudaFuncSetAttribute(scatter_kernel<false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)ssmem);
  if (from_input)
    scatter_kernel<true><<<(unsigned)nblk, 1024, ssmem, st>>>(
        (const u64*)keys_in, (const int*)label_in, (const Entry*)src, tab,
        (const long long*)blocks, (u64*)cursor, (Entry*)dst);
  else
    scatter_kernel<false><<<(unsigned)nblk, 1024, ssmem, st>>>(
        (const u64*)keys_in, (const int*)label_in, (const Entry*)src, tab,
        (const long long*)blocks, (u64*)cursor, (Entry*)dst);
  return (int)cudaGetLastError();
}

// The level's buckets of at most S = 64, 128 or 256 entries: E = S / 32
// keys a lane; flag (1 + the level's buffer) marks their rows.
int launch_agg_bucket(void* bufc, void* bufo, const void* plan, long long NB,
                      const void* starts, int S, const void* pg, int lelement,
                      int flag, void* rowflag, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (NB <= 0) return (int)cudaErrorInvalidValue;
  if (S == 64)
    return bucket_launch<2>(bufc, bufo, plan, NB, starts, pg, lelement, flag,
                            rowflag, st);
  if (S == 128)
    return bucket_launch<4>(bufc, bufo, plan, NB, starts, pg, lelement, flag,
                            rowflag, st);
  if (S == 256)
    return bucket_launch<8>(bufc, bufo, plan, NB, starts, pg, lelement, flag,
                            rowflag, st);
  return (int)cudaErrorInvalidValue;
}

int launch_agg_single(void* bufc, void* bufo, const void* lstart,
                      const void* lcount, int nl, long long max_count,
                      void* slot, const void* pg, int lelement, int flag,
                      void* rowflag, void* stream) {
  if (nl <= 0 || nl > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(slot, 0xFF, 8 * (size_t)nl, st);
  cudaMemsetAsync((u64*)slot + nl, 0, 8 * (size_t)nl, st);
  long long gx = (max_count + 256 * 16 - 1) / (256 * 16);
  long long gmax = 2LL * sm_count();
  dim3 grid((unsigned)(gx < gmax ? (gx > 0 ? gx : 1) : gmax), (unsigned)nl);
  single_min_kernel<<<grid, 256, 0, st>>>(
      (const Entry*)bufc, (const long long*)lstart, (const long long*)lcount,
      (u64*)slot, (unsigned char*)rowflag);
  single_dsum_kernel<<<grid, 256, 0, st>>>(
      (const Entry*)bufc, (const long long*)lstart, (const long long*)lcount,
      (const int*)pg, nl, (u64*)slot);
  single_rows_kernel<<<(nl + 255) / 256, 256, 0, st>>>(
      (Entry*)bufc, (Entry*)bufo, (const long long*)lstart,
      (const long long*)lcount, (const u64*)slot, nl, lelement,
      (unsigned char)flag, (unsigned char*)rowflag);
  return (int)cudaGetLastError();
}

// The rows' count of each tile of n places and their scan (tcount [nt]
// u32, tbase [nt] and total int64, nt = ceil(n / TILE)).
int launch_agg_count_rows(const void* rowflag, long long n, void* tcount,
                          void* tbase, void* total, void* stream) {
  long long nt = (n + TILE - 1) / TILE;
  if (nt <= 0 || nt > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  tile_count_kernel<<<(unsigned)nt, TILE / 4, 0, st>>>(
      (const unsigned char*)rowflag, n, (u32*)tcount);
  tile_scan_kernel<<<1, 1024, 0, st>>>((const u32*)tcount, nt,
                                       (long long*)tbase, (long long*)total);
  return (int)cudaGetLastError();
}

int launch_agg_compact(const void* buf0, const void* buf1,
                       const void* rowflag, long long n, const void* tbase,
                       void* out_canon, void* out_l0, void* out_mult,
                       void* out_count, void* out_first, void* stream) {
  long long nt = (n + TILE - 1) / TILE;
  if (nt <= 0 || nt > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  compact_kernel<<<(unsigned)nt, TILE / 4, 0, (cudaStream_t)stream>>>(
      (const Entry*)buf0, (const Entry*)buf1, (const unsigned char*)rowflag,
      n, (const long long*)tbase, (long long*)out_canon, (int*)out_l0,
      (int*)out_mult, (long long*)out_count, (long long*)out_first);
  return (int)cudaGetLastError();
}

}  // extern "C"
