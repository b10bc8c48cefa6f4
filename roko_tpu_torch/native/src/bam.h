// BAM container parsing + full BAI (bin + linear) region fetch.
//
// Native replacement for the reference's htslib usage (readBAM /
// sam_itr_querys / bam_itr pattern, ref: models.cpp:37-101): parses the
// BAM binary layout (SAM spec §4.2) directly over roko::BgzfReader and
// serves coordinate-order region queries via the .bai distributed bins
// pruned by the linear index — the htslib query shape — mirroring
// roko_tpu_torch/io/bam.py::BamReader.fetch (linear-only indexes still work;
// no index falls back to a full scan).
#pragma once

#include <cstdint>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

#include "bgzf.h"

namespace roko {

struct BamRecord {
  std::string name;
  uint16_t flag = 0;
  int32_t tid = -1;
  int32_t pos = -1;  // 0-based leftmost
  uint8_t mapq = 0;
  std::vector<uint32_t> cigar;    // (len << 4) | op
  std::vector<uint8_t> seq_nib;   // 4-bit codes, one per base
  int32_t l_seq = 0;

  int32_t ReferenceEnd() const;  // one past last aligned ref pos (>= pos+1)
  bool IsUnmapped() const { return flag & 0x4; }
  bool IsReverse() const { return flag & 0x10; }
};

class BamReader {
 public:
  explicit BamReader(const std::string& path);

  const std::vector<std::pair<std::string, int64_t>>& References() const {
    return references_;
  }
  int TidByName(const std::string& name) const;  // -1 if unknown

  // All mapped records overlapping [start, end) on contig, file order.
  std::vector<BamRecord> Fetch(const std::string& contig, int64_t start,
                               int64_t end);

 private:
  struct RefIndex {
    std::unordered_map<uint32_t, std::vector<std::pair<uint64_t, uint64_t>>>
        bins;  // bin id -> [(chunk_beg, chunk_end)] virtual offsets
    std::vector<uint64_t> ioffsets;  // 16 kb linear index
  };

  bool ReadRecord(BamRecord* rec);  // false at EOF
  const std::vector<RefIndex>* LoadIndex();
  // Merged chunk list for [start, end) on tid; false when the index (or
  // its bin section) is unavailable and the caller must linear-scan.
  bool RegionChunks(int tid, int64_t start, int64_t end,
                    std::vector<std::pair<uint64_t, uint64_t>>* out);

  std::string path_;
  std::unique_ptr<BgzfReader> bgzf_;
  std::vector<std::pair<std::string, int64_t>> references_;
  std::unordered_map<std::string, int> tid_by_name_;
  uint64_t first_record_voffset_ = 0;
  std::vector<RefIndex> index_;
  bool index_loaded_ = false;
  bool index_present_ = false;
};

}  // namespace roko
