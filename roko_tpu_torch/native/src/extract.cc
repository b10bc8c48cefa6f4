#include "extract.h"

#include <algorithm>
#include <deque>
#include <stdexcept>
#include <unordered_map>
#include <unordered_set>

namespace roko {

namespace {

constexpr uint8_t kGap = 4;
constexpr uint8_t kUnknown = 5;
constexpr uint8_t kStrandOffset = 6;
constexpr uint8_t kInvalid = 0xFF;

// BAM seq nibble -> encoded base, matching the oracle's nibble -> char ->
// CHAR_TO_CODE chain (roko_tpu_torch/io/bam.py _SEQ_CODES + constants.py
// CHAR_TO_CODE; ref nibble decode: include/models.h:120-138). Ambiguity
// codes other than N are errors there, so kInvalid here.
constexpr uint8_t kNibbleToCode[16] = {
    kInvalid, 0,        1,        kInvalid,  // -, A, C, M
    2,        kInvalid, kInvalid, kInvalid,  // G, R, S, V
    3,        kInvalid, kInvalid, kInvalid,  // T, W, Y, H
    kInvalid, kInvalid, kInvalid, kUnknown,  // K, D, B, N
};

struct ColState {
  int32_t qpos;
  bool is_del;
  bool is_refskip;
  int32_t indel;  // >0 insertion after this column; <0 deletion; 0 none
};

struct ReadInfo {
  int id;
  int32_t pos;
  int32_t ref_end;   // exclusive (htslib bam_endpos)
  bool reverse;
  const std::vector<uint8_t>* seq_nib;
  std::vector<ColState> states;
};

// Mirrors roko_tpu_torch/features/pileup.py::_column_states (htslib pileup
// semantics: indel flagged on the last column before an I/D op; D/N
// columns carry the qpos of the preceding aligned base).
std::vector<ColState> ColumnStates(const BamRecord& rec) {
  std::vector<ColState> states;
  int32_t qpos = 0;
  for (uint32_t c : rec.cigar) {
    uint32_t op = c & 0xF;
    int32_t length = static_cast<int32_t>(c >> 4);
    switch (op) {
      case 0:  // M
      case 7:  // =
      case 8:  // X
        for (int32_t i = 0; i < length; ++i)
          states.push_back({qpos + i, false, false, 0});
        qpos += length;
        break;
      case 1:  // I
        if (!states.empty()) states.back().indel = length;
        qpos += length;
        break;
      case 2:  // D
        if (!states.empty() && states.back().indel <= 0)
          states.back().indel = -length;
        for (int32_t i = 0; i < length; ++i)
          states.push_back({std::max(qpos - 1, 0), true, false, 0});
        break;
      case 3:  // N
        for (int32_t i = 0; i < length; ++i)
          states.push_back({std::max(qpos - 1, 0), true, true, 0});
        break;
      case 4:  // S
        qpos += length;
        break;
      default:  // H, P consume nothing
        break;
    }
  }
  return states;
}

// Draft FASTA char -> encoded base, matching constants.py CHAR_TO_CODE
// (same mapping as the reference's get_base: include/models.h:148-169).
uint8_t EncodeRefChar(char ch) {
  switch (ch) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    case 'N': case 'n': case '-': return kUnknown;
    case '*': return kGap;
    default:
      throw std::runtime_error("unexpected base in draft sequence");
  }
}

bool PassesFilter(const BamRecord& rec, const ExtractConfig& cfg) {
  if (rec.flag & cfg.filter_flag) return false;
  if (cfg.require_proper_pair && (rec.flag & 0x1) && !(rec.flag & 0x2))
    return false;
  if (rec.mapq < cfg.min_mapq) return false;
  return true;
}

}  // namespace

ExtractResult ExtractWindows(const std::string& bam_path,
                             const std::string& contig, int64_t start,
                             int64_t end, uint64_t seed,
                             const ExtractConfig& cfg,
                             const std::string& ref_seq, int64_t ref_off) {
  if (cfg.ref_rows < 0 || cfg.ref_rows > cfg.rows)
    throw std::runtime_error("ref_rows must be in [0, rows]");
  if (cfg.ref_rows > 0 &&
      (ref_off > start ||
       static_cast<int64_t>(ref_seq.size()) < end - ref_off))
    throw std::runtime_error(
        "ref_rows > 0 needs the draft sequence covering [start, end)");
  BamReader reader(bam_path);
  ExtractResult result;

  // storage owns the records; ReadInfo borrows seq_nib pointers, so it
  // must stay alive for the whole sweep
  std::vector<BamRecord> storage;
  std::vector<ReadInfo> reads;
  {
    std::vector<BamRecord> records = reader.Fetch(contig, start, end);
    storage.reserve(records.size());
    for (auto& rec : records) {
      if (!PassesFilter(rec, cfg)) continue;
      storage.push_back(std::move(rec));
    }
    int next_id = 0;
    reads.reserve(storage.size());
    for (auto& rec : storage) {
      ReadInfo info;
      info.id = next_id++;
      info.pos = rec.pos;
      info.ref_end = rec.ReferenceEnd();
      info.reverse = rec.IsReverse();
      info.seq_nib = &rec.seq_nib;
      info.states = ColumnStates(rec);
      reads.push_back(std::move(info));
    }
  }
  if (reads.empty()) return result;

  // generous output preallocation: growth reallocations re-copy the
  // whole accumulated matrix (tens of MB per 100 kb region). Insertion
  // columns can push the window count past span/stride, so reserve
  // with slack — reserve is a hint, not a cap.
  {
    const size_t est_windows =
        static_cast<size_t>((end - start) / cfg.stride + 2) * 5 / 4;
    result.positions.reserve(2ul * cfg.cols * est_windows);
    result.matrix.reserve(
        static_cast<size_t>(cfg.rows) * cfg.cols * est_windows);
  }

  const int slots = cfg.max_ins + 1;
  auto key_of = [slots](int64_t rpos, int ins) -> int64_t {
    return rpos * slots + ins;
  };

  SplitMix64 rng(seed);
  std::deque<int64_t> pos_queue;
  // (rpos, ins) -> per-read first-seen code list. The sweep visits each
  // (read, column) pair exactly once (one ColState per covered column),
  // so rids are unique per key by construction — a plain append matches
  // the oracle's dict setdefault without the O(coverage) membership
  // scan. The per-key code vectors are POOLED: a region touches
  // hundreds of thousands of keys, and allocating/destroying a short
  // vector per key was steady-state malloc churn in the r4 extraction
  // profile — recycled vectors keep their capacity instead.
  using Codes = std::vector<std::pair<int, uint8_t>>;  // (rid, code)
  std::vector<Codes> code_pool;
  std::vector<uint32_t> pool_free;
  auto pool_acquire = [&]() -> uint32_t {
    if (!pool_free.empty()) {
      uint32_t i = pool_free.back();
      pool_free.pop_back();
      return i;
    }
    code_pool.emplace_back();
    return static_cast<uint32_t>(code_pool.size() - 1);
  };
  std::unordered_map<int64_t, uint32_t> align_info;  // key -> pool index
  // rid -> (ref bounds, strand), recorded at first non-refskip entry.
  // rids are dense 0..n-1, so a flat array beats a hash map in the
  // per-column hot loop.
  struct Bounds {
    int32_t lo, hi;
    bool fwd;
  };
  std::vector<Bounds> bounds(reads.size());
  std::vector<bool> have_bounds(reads.size(), false);

  int64_t lo = reads.front().pos;
  for (const auto& r : reads) lo = std::min<int64_t>(lo, r.pos);
  int64_t hi = 0;
  for (const auto& r : reads)
    hi = std::max<int64_t>(hi, r.pos + static_cast<int64_t>(r.states.size()));

  std::vector<size_t> active;
  size_t nxt = 0;

  auto encode_base = [&](const ReadInfo& r, int32_t q) -> uint8_t {
    uint8_t code = kNibbleToCode[(*r.seq_nib)[q] & 0xF];
    if (code == kInvalid)
      throw std::runtime_error("unexpected base nibble in read sequence");
    return code;
  };

  // Reused per-window scratch: one dense row per read seen in the window,
  // built in a single pass over the columns (the per-sampled-read lazy
  // row construction the Python oracle uses is O(cols * coverage) per
  // sampled read; with 200 samples over ~coverage reads nearly every
  // read is materialised anyway, so batch-building is strictly cheaper).
  // All scratch persists ACROSS windows: the row vectors keep their
  // capacity (fresh per-window allocations were the top line of the r4
  // extraction profile), and rid->slot is a flat array over the dense
  // rid space reset via the touched list instead of a rebuilt hash map.
  constexpr uint8_t kUnset = 0xFE;
  constexpr int32_t kNoSlot = -1;
  std::vector<int32_t> rid_slot(reads.size(), kNoSlot);
  std::vector<int> slot_rid;
  std::vector<std::vector<uint8_t>> rows_buf;
  std::vector<bool> slot_valid;
  std::vector<int> valid;
  std::vector<uint8_t> ref_row;  // per-window draft row (ref_rows > 0)

  auto emit_windows = [&]() {
    while (static_cast<int>(pos_queue.size()) >= cfg.cols) {
      for (int rid : slot_rid) rid_slot[rid] = kNoSlot;
      slot_rid.clear();
      slot_valid.clear();
      size_t rows_used = 0;

      for (int c = 0; c < cfg.cols; ++c) {
        // .at(): every queued position must already own a pool slot
        // (enqueued together in the column sweep). operator[] would
        // default-insert index 0 on a broken invariant and silently
        // alias another column's codes; throwing is caught at the C-ABI
        // boundary and surfaced as a distinct error code instead.
        const Codes& codes = code_pool[align_info.at(pos_queue[c])];
        for (const auto& p : codes) {
          int32_t slot = rid_slot[p.first];
          if (slot == kNoSlot) {
            slot = static_cast<int32_t>(rows_used);
            rid_slot[p.first] = slot;
            slot_rid.push_back(p.first);
            if (rows_used == rows_buf.size())
              rows_buf.emplace_back(cfg.cols, kUnset);
            else
              rows_buf[rows_used].assign(cfg.cols, kUnset);
            ++rows_used;
            slot_valid.push_back(false);
          }
          rows_buf[slot][c] = p.second;
          if (p.second != kUnknown) slot_valid[slot] = true;
        }
      }

      // valid reads: any non-UNKNOWN code within the window, sorted by id
      valid.clear();
      for (size_t s = 0; s < slot_rid.size(); ++s)
        if (slot_valid[s]) valid.push_back(slot_rid[s]);
      std::sort(valid.begin(), valid.end());

      if (!valid.empty()) {
        const size_t n_valid = valid.size();
        // complete the rows: bounds rule for unset columns, strand offset
        for (size_t s = 0; s < rows_used; ++s) {
          const Bounds& b = bounds[slot_rid[s]];
          std::vector<uint8_t>& row = rows_buf[s];
          for (int c = 0; c < cfg.cols; ++c) {
            if (row[c] == kUnset) {
              int64_t p = pos_queue[c] / slots;
              // NB: b.hi is htslib's exclusive bam_endpos but the test is
              // `p > hi`, reproducing the reference's off-by-one where the
              // one-past-the-end position reads as in-bounds GAP
              // (ref: generate.cpp:135, kept by the Python oracle)
              row[c] = (p < b.lo || p > b.hi) ? kUnknown : kGap;
            }
            if (!b.fwd) row[c] = static_cast<uint8_t>(row[c] + kStrandOffset);
          }
        }

        size_t pos_base = result.positions.size();
        result.positions.resize(pos_base + 2ul * cfg.cols);
        for (int c = 0; c < cfg.cols; ++c) {
          int64_t key = pos_queue[c];
          result.positions[pos_base + 2 * c] = key / slots;
          result.positions[pos_base + 2 * c + 1] = key % slots;
        }

        // draft-base rows first (reference's REF_ROWS block,
        // generate.cpp:109-119): GAP at insertion slots, draft base
        // elsewhere, always forward-strand encoding
        if (cfg.ref_rows > 0) {
          ref_row.clear();
          for (int c = 0; c < cfg.cols; ++c) {
            int64_t key = pos_queue[c];
            ref_row.push_back(
                key % slots != 0
                    ? kGap
                    : EncodeRefChar(ref_seq[key / slots - ref_off]));
          }
          for (int r = 0; r < cfg.ref_rows; ++r)
            result.matrix.insert(result.matrix.end(), ref_row.begin(),
                                 ref_row.end());
        }

        // append row copies with insert (plain memcpy): resize would
        // zero-fill 18 kB per window only to overwrite it — the r4
        // profile put the sampling block at ~half of extraction time
        for (int r = cfg.ref_rows; r < cfg.rows; ++r) {
          int rid = valid[rng.NextBelow(n_valid)];
          const std::vector<uint8_t>& row = rows_buf[rid_slot[rid]];
          result.matrix.insert(result.matrix.end(), row.begin(), row.end());
        }
        result.n_windows += 1;
      }
      // slide by stride (empty valid set: skip but still slide)
      for (int s = 0; s < cfg.stride; ++s) {
        auto it = align_info.find(pos_queue.front());
        code_pool[it->second].clear();  // keep capacity for reuse
        pool_free.push_back(it->second);
        align_info.erase(it);
        pos_queue.pop_front();
      }
    }
  };

  for (int64_t rpos = lo; rpos < hi; ++rpos) {
    while (nxt < reads.size() && reads[nxt].pos <= rpos) active.push_back(nxt++);
    // compact: drop exhausted reads, preserving file order
    size_t w = 0;
    bool any_entry = false;
    for (size_t i = 0; i < active.size(); ++i) {
      const ReadInfo& r = reads[active[i]];
      int64_t col = rpos - r.pos;
      if (col >= static_cast<int64_t>(r.states.size())) continue;
      active[w++] = active[i];
      any_entry = true;
    }
    active.resize(w);
    if (!any_entry) {
      if (active.empty() && nxt >= reads.size()) break;
      continue;
    }
    if (rpos < start) continue;
    if (rpos >= end) break;

    // the base (ins=0) column key is shared by every read at this
    // rpos: resolve it at most once per rpos, not once per read
    // (lazily, so an all-refskip column still creates no key). Index,
    // not pointer — pool growth during insertion handling would
    // invalidate a pointer.
    constexpr uint32_t kNoIdx = ~0u;
    uint32_t base_idx = kNoIdx;
    for (size_t idx : active) {
      const ReadInfo& r = reads[idx];
      const ColState& st = r.states[static_cast<size_t>(rpos - r.pos)];
      if (st.is_refskip) continue;
      if (!have_bounds[r.id]) {
        bounds[r.id] = Bounds{r.pos, r.ref_end, !r.reverse};
        have_bounds[r.id] = true;
      }

      if (base_idx == kNoIdx) {
        int64_t base_key = key_of(rpos, 0);
        auto ai = align_info.find(base_key);
        if (ai == align_info.end()) {
          ai = align_info.emplace(base_key, pool_acquire()).first;
          pos_queue.push_back(base_key);
        }
        base_idx = ai->second;
      }
      if (st.is_del) {
        code_pool[base_idx].emplace_back(r.id, kGap);
      } else {
        code_pool[base_idx].emplace_back(r.id, encode_base(r, st.qpos));
        int32_t n_ins = std::min(st.indel, cfg.max_ins);
        for (int32_t i = 1; i <= n_ins; ++i) {
          int64_t ikey = key_of(rpos, i);
          auto ii = align_info.find(ikey);
          if (ii == align_info.end()) {
            ii = align_info.emplace(ikey, pool_acquire()).first;
            pos_queue.push_back(ikey);
          }
          code_pool[ii->second].emplace_back(r.id, encode_base(r, st.qpos + i));
        }
      }
    }
    emit_windows();
  }

  return result;
}

}  // namespace roko
