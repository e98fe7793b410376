// Record cuts of the port's streamed scan (engine._ScanStream,
// io/fasta.iter_record_cuts), built into the port's host runtime together
// with native/clark_native.cpp (utils/native.py).
#include <cstdint>
#include <cstring>

extern "C" {

// record_cut: the end of the record-aligned chunk of d[0, n) that starts
// at the record boundary pos, for a window of want bytes: n where the
// window reaches n; else FASTA, the last '>' after a '\n' with both in the
// window, found from the window's end; FASTQ, the byte after the last
// newline whose count from pos is a multiple of 4.  A window with no cut
// doubles until one has, each search reading only the bytes it adds.
// *looked gets the bytes read: about one record (FASTA), the window
// (FASTQ).
int64_t record_cut(const uint8_t* d, int64_t n, int64_t pos, int64_t want,
                   int32_t is_fq, int64_t* looked) {
  int64_t lo = pos + 1;      // FASTA: the lowest '>' position left to search
  int64_t nl = 0, at = pos;  // FASTQ: newlines counted in [pos, at)
  *looked = 0;
  for (;;) {
    int64_t end = want < n - pos ? pos + want : n;
    if (end == n) return n;
    if (is_fq) {
      int64_t cut = -1;
      *looked += end - at;
      while (at < end) {
        const void* p = memchr(d + at, '\n', (size_t)(end - at));
        if (!p) break;
        at = (const uint8_t*)p - d + 1;
        if (++nl % 4 == 0) cut = at;
      }
      at = end;
      if (cut >= 0) return cut;
    } else {
      for (int64_t i = end - 1; i >= lo; --i) {
        if (d[i] == '>' && d[i - 1] == '\n') {
          *looked += end - i + 1;
          return i;
        }
      }
      *looked += end - lo + 1;
      lo = end;
    }
    want *= 2;  // a record longer than the window: widen
  }
}

}  // extern "C"
