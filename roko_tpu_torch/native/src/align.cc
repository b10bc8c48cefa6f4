#include "align.h"

#include <algorithm>
#include <limits>
#include <vector>

namespace roko {
namespace {

// Traceback moves. kDiag covers both match and substitution; the
// walk-back re-compares the bases to split them.
enum Move : uint8_t { kNone = 0, kDiag = 1, kUp = 2, kLeft = 3 };

constexpr int64_t kInf = std::numeric_limits<int64_t>::max() / 4;

}  // namespace

AlignStatus BandedAlign(const char* a, int64_t la, const char* b, int64_t lb,
                        int64_t pad, int64_t max_cells, AlignCounts* counts) {
  // Degenerate segments: one side empty is pure gap.
  if (la == 0 || lb == 0) {
    counts->ins += lb;
    counts->del_ += la;
    counts->hit_band_edge = false;
    return AlignStatus::kOk;
  }
  const int64_t dlo = std::min<int64_t>(0, lb - la) - pad;
  const int64_t dhi = std::max<int64_t>(0, lb - la) + pad;
  const int64_t width = dhi - dlo + 1;
  const int64_t cells = (la + 1) * width;
  if (cells > max_cells) return AlignStatus::kCellsCap;

  // dist[w] holds row i's costs for diagonal d = dlo + w (j = i + d).
  std::vector<int64_t> prev(width, kInf), cur(width, kInf);
  std::vector<uint8_t> moves(cells, kNone);

  // Row 0: j = d, only LEFT moves (insertions) inside the band.
  for (int64_t w = 0; w < width; ++w) {
    const int64_t j = dlo + w;
    if (j < 0 || j > lb) continue;
    prev[w] = j;
    moves[w] = j == 0 ? kNone : kLeft;
  }
  for (int64_t i = 1; i <= la; ++i) {
    uint8_t* row_moves = moves.data() + i * width;
    std::fill(cur.begin(), cur.end(), kInf);
    for (int64_t w = 0; w < width; ++w) {
      const int64_t j = i + dlo + w;
      if (j < 0 || j > lb) continue;
      // UP (delete a[i-1]): same j, previous i -> diagonal d+1.
      int64_t best = w + 1 < width && prev[w + 1] < kInf ? prev[w + 1] + 1 : kInf;
      uint8_t mv = kUp;
      // LEFT (insert b[j-1]): same i, previous j -> diagonal d-1.
      if (w - 1 >= 0 && cur[w - 1] < kInf && cur[w - 1] + 1 < best) {
        best = cur[w - 1] + 1;
        mv = kLeft;
      }
      // DIAG: previous i and j -> same diagonal index.
      if (j - 1 >= 0 && prev[w] < kInf) {
        const int64_t c = prev[w] + (a[i - 1] == b[j - 1] ? 0 : 1);
        if (c <= best) {  // prefer diagonal on ties: canonical paths
          best = c;
          mv = kDiag;
        }
      }
      if (j == 0) {  // column 0: only deletions can reach it
        best = i;
        mv = kUp;
      }
      cur[w] = best;
      row_moves[w] = best >= kInf ? kNone : mv;
    }
    std::swap(prev, cur);
  }

  const int64_t end_w = lb - la - dlo;
  if (end_w < 0 || end_w >= width || prev[end_w] >= kInf)
    return AlignStatus::kUnreachableEnd;

  // Walk back from (la, lb), counting ops and noting band-edge contact.
  AlignCounts c;
  int64_t i = la, w = end_w;
  while (i > 0 || i + dlo + w > 0) {
    const int64_t j = i + dlo + w;
    if ((w == 0 || w == width - 1) && (i > 0 && j > 0)) c.hit_band_edge = true;
    const uint8_t mv = moves[i * width + w];
    if (mv == kDiag) {
      if (a[i - 1] == b[j - 1]) {
        ++c.match;
      } else {
        ++c.sub;
      }
      --i;  // same w: j decreases with i
    } else if (mv == kUp) {
      ++c.del_;
      --i;
      ++w;
    } else if (mv == kLeft) {
      ++c.ins;
      --w;
    } else {
      return AlignStatus::kCorruptTraceback;  // kNone before the origin
    }
  }
  counts->match += c.match;
  counts->sub += c.sub;
  counts->ins += c.ins;
  counts->del_ += c.del_;
  counts->hit_band_edge = c.hit_band_edge;
  return AlignStatus::kOk;
}

}  // namespace roko
