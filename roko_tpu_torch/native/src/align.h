// Banded unit-cost global alignment for assembly assessment.
//
// The assess tool (roko_tpu/eval/assess.py) decomposes a
// polished-vs-truth contig pair into short inter-anchor segments; this
// is the per-segment hot loop: a Needleman-Wunsch DP with unit
// mismatch/gap costs restricted to a diagonal band, with full
// traceback so the edit-op breakdown (match / substitution /
// insertion / deletion) is exact, not approximated from the distance.
//
// The reference's published accuracy table (total error / mismatch /
// deletion / insertion / Qscore, /root/reference/README.md:103-112) is
// produced by the external pomoxis assess_assembly; this module gives
// the framework a built-in equivalent so the north-star metric is
// self-measurable.
#ifndef ROKO_ALIGN_H_
#define ROKO_ALIGN_H_

#include <cstdint>

namespace roko {

struct AlignCounts {
  int64_t match = 0;
  int64_t sub = 0;    // diagonal step, a[i] != b[j]
  int64_t ins = 0;    // consumes b only (extra base in b)
  int64_t del_ = 0;   // consumes a only (base of a missing from b)
  bool hit_band_edge = false;  // optimal path touched the band limit
};

// Distinct failure modes so the binding can map the resource cap to a
// retryable MemoryError while genuine aligner bugs surface loudly
// instead of degrading into plausible-looking worst-case counts
// (ADVICE r3). kUnreachableEnd / kCorruptTraceback cannot happen for
// valid inputs (the end diagonal lies inside the band by construction
// and the band is contiguous) — they indicate an internal bug.
enum class AlignStatus {
  kOk = 0,
  kCellsCap = 1,         // (la+1) * band_width > max_cells
  kUnreachableEnd = 2,   // end cell not reached: internal bug
  kCorruptTraceback = 3  // kNone move before the origin: internal bug
};

// Global alignment of a[0:la) vs b[0:lb) with a band of diagonals
// j - i in [min(0, lb-la) - pad, max(0, lb-la) + pad].
// On kCellsCap the counts are untouched.
AlignStatus BandedAlign(const char* a, int64_t la, const char* b, int64_t lb,
                        int64_t pad, int64_t max_cells, AlignCounts* counts);

}  // namespace roko

#endif  // ROKO_ALIGN_H_
