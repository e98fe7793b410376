"""K-mer spectrum analyser (legacy CLARK spectrum mode).

Port-for-completeness of src/analyser.cc: builds a k-mer count frequency
histogram from a spectrum file ("<kmer> <count>" lines) and detects the
coverage "bump" interval.  The reference compiles this into cuCLARK but never
calls it from the classification path (SURVEY §2.1); it is provided here so
spectrum-based workflows keep a home.
"""

from __future__ import annotations


class Analyser:
    def __init__(self, path: str):
        counts = []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    try:
                        counts.append(int(parts[1]))
                    except ValueError:
                        continue
        n_max = max(counts, default=0)
        self.frequency = [0] * (n_max + 1)
        self.kmer_ids: list[list[int]] = [[] for _ in range(n_max + 1)]
        for idx, c in enumerate(counts):
            self.frequency[c] += 1
            self.kmer_ids[c].append(idx)

    def bump_interval(self, div: int = 1) -> tuple[int, int, bool]:
        """(indexS, indexE, found) — analyser.cc:46-135 exactly: plateau
        suppression, running min then bump max, interval +- (max-min)/div."""
        freq = self.frequency
        unchanged = 0
        table: list[tuple[int, int]] = []
        index_s = 0
        minfound = False
        for i, v in enumerate(freq):
            if i > 0 and abs(v - freq[i - 1]) < 1:
                if unchanged < 5:
                    unchanged += 1
            else:
                unchanged = 0
            if unchanged < 1:
                table.append((i, v))
                if not minfound and v > 0:
                    index_s = i
                    minfound = True
        length = len(table)
        if length < 3:
            return index_s, table[-1][0] if table else 0, False
        index_e = table[-1][0]
        if length <= 4:
            return index_s, index_e, False
        min_val, max_val = 999999999, 0
        min_freq, max_freq = 1, 1
        min_done = max_done = False
        for cpt in range(1, length):
            if max_done:
                break
            x, y = table[cpt]
            if not min_done and min_val >= y:
                min_val = y
                min_freq = x
            step = 0.5 * min_freq if 0.5 * min_freq >= 2 else 2
            min_done = x - min_freq >= step
            if not max_done and min_done and max_val < y:
                max_val = y
                max_freq = x
            max_done = min_done and (x - max_freq >= (max_freq - min_freq))
        if max_done:
            return (
                max_freq - (max_freq - min_freq) // div,
                max_freq + (max_freq - min_freq) // div,
                True,
            )
        return index_s, index_e, False
