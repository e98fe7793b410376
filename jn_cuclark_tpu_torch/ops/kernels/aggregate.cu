// Hand-written Hopper (sm_90a) kernel of the DB-build aggregate.
//
//   K6 aggregate   jn_cuclark_tpu/db/device_build.py:30 _aggregate_device
//
// The build groups the occurrences of each canonical k-mer and applies the
// reference's update rule (HashTableStorage_hh.hh:422-461): per group, the
// first occurrence's label L0, multiplicity
//     mult = min(1 + sum[(l != L0) + (pg[l] != pg[L0])], 255)
// (pg = a label's prefix group, the "centromere" pairing), the count
// (capped at 254 under the 8-bit lElement counter) and the first stream
// index.  The device-wide stable sort of the keys stays torch.sort, as the
// JAX package leaves it to lax.sort; this file is the segmented pass over
// the sorted keys, in three data-parallel steps:
//
//   group_starts_kernel  flags[i] = 1 where a group starts
//   (torch glue)         offs = cumsum(flags) (element -> group + 1) and
//                        starts = nonzero(flags) (group -> first element)
//   group_mult_kernel    one thread per occurrence adds its label-change
//                        term to its group's sum (an atomic, issued only
//                        where the term is nonzero)
//   group_rows_kernel    one thread per group writes the group's row (the
//                        compaction): canonical, L0, mult, count, first seq
//
// No thread walks a group, so a long run (a genome repeat, or the padding
// of a partition: one group of 2^64-1 sentinels) costs what a short one
// does.  Keys arrive sorted as int64 bit patterns of canonical ^ 2^63, so
// that a signed sort orders them as unsigned canonicals; the row kernel
// flips bit 63 back.  Bound by bytes: the key reads and the gathers
// label[seq[j]] (about 40 B per occurrence in all).
//
// Each launcher is a plain C function (bound with ctypes): it launches on
// the caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

#define SIGN64 0x8000000000000000ull

__global__ void group_starts_kernel(const u64* __restrict__ keys,
                                    int* __restrict__ flags, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  flags[i] = (i == 0 || keys[i] != keys[i - 1]) ? 1 : 0;
}

// offs[j] - 1 is occurrence j's group; starts[g] the group's first
// occurrence; dsum (zeroed) receives each group's sum of change terms.
__global__ void group_mult_kernel(const long long* __restrict__ seq,
                                  const int* __restrict__ label,
                                  const int* __restrict__ pg,
                                  const long long* __restrict__ offs,
                                  const long long* __restrict__ starts,
                                  long long n, u64* __restrict__ dsum) {
  long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (j >= n) return;
  long long g = offs[j] - 1;
  long long s = starts[g];
  if (j == s) return;
  int l0 = label[seq[s]];
  int l = label[seq[j]];
  int d = (l != l0) + (pg[l] != pg[l0]);
  if (d) atomicAdd(&dsum[g], (u64)d);
}

// seq is the stable sort's permutation, so a group's first element has the
// group's smallest stream index.
__global__ void group_rows_kernel(
    const u64* __restrict__ keys, const long long* __restrict__ seq,
    const int* __restrict__ label, const long long* __restrict__ starts,
    const u64* __restrict__ dsum, long long ng, long long n, int lelement,
    u64* __restrict__ out_canon, int* __restrict__ out_l0,
    int* __restrict__ out_mult, long long* __restrict__ out_count,
    long long* __restrict__ out_first) {
  long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (g >= ng) return;
  long long s = starts[g];
  long long gsize = (g + 1 < ng ? starts[g + 1] : n) - s;
  u64 m = 1 + dsum[g];
  out_canon[g] = keys[s] ^ SIGN64;
  out_l0[g] = label[seq[s]];
  out_mult[g] = (int)(m < 255 ? m : 255);
  out_count[g] = lelement ? (gsize < 254 ? gsize : 254) : gsize;
  out_first[g] = seq[s];
}

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

int launch_group_starts(const void* keys, void* flags, long long n,
                        void* stream) {
  if (n == 0) return 0;
  unsigned grid;
  if (int rc = grid_for(n, 256, &grid)) return rc;
  group_starts_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const u64*)keys, (int*)flags, n);
  return (int)cudaGetLastError();
}

int launch_group_mult(const void* seq, const void* label, const void* pg,
                      const void* offs, const void* starts, long long n,
                      void* dsum, void* stream) {
  if (n == 0) return 0;
  unsigned grid;
  if (int rc = grid_for(n, 256, &grid)) return rc;
  group_mult_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const long long*)seq, (const int*)label, (const int*)pg,
      (const long long*)offs, (const long long*)starts, n, (u64*)dsum);
  return (int)cudaGetLastError();
}

int launch_group_rows(const void* keys, const void* seq, const void* label,
                      const void* starts, const void* dsum, long long ng,
                      long long n, int lelement, void* out_canon,
                      void* out_l0, void* out_mult, void* out_count,
                      void* out_first, void* stream) {
  if (ng == 0) return 0;
  unsigned grid;
  if (int rc = grid_for(ng, 256, &grid)) return rc;
  group_rows_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const u64*)keys, (const long long*)seq, (const int*)label,
      (const long long*)starts, (const u64*)dsum, ng, n, lelement,
      (u64*)out_canon, (int*)out_l0, (int*)out_mult, (long long*)out_count,
      (long long*)out_first);
  return (int)cudaGetLastError();
}

}  // extern "C"
