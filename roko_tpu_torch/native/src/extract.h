// Pileup sweep + 200x90 window tensorizer (the host hot path).
//
// Native implementation of the feature extractor with the exact
// semantics of the reference's generate.cpp:28-158 (window queue, GAP vs
// UNKNOWN bounds rule, with-replacement row sampling) as specified by
// the Python oracle in roko_tpu_torch/features/extract.py + pileup.py; golden
// tests assert bit-identical output between the two. Sampling uses the
// shared SplitMix64 stream (roko_tpu_torch/utils/rng.py) instead of the
// reference's wall-clock srand (ref: gen.cpp:11).
#pragma once

#include <cstdint>
#include <string>
#include <vector>

#include "bam.h"

namespace roko {

struct ExtractConfig {
  int rows = 200;
  int cols = 90;
  int stride = 30;
  int max_ins = 3;
  // first ref_rows rows carry the DRAFT base per column (GAP at
  // insertion slots, forward-strand encoding) — the reference's
  // REF_ROWS block (generate.cpp:109-119); needs ref_seq when > 0
  int ref_rows = 0;
  int min_mapq = 10;
  uint16_t filter_flag = 0xF04;  // UNMAP|SECONDARY|QCFAIL|DUP|SUPPLEMENTARY
  bool require_proper_pair = true;
};

struct ExtractResult {
  int64_t n_windows = 0;
  std::vector<int64_t> positions;  // [n_windows, cols, 2]
  std::vector<uint8_t> matrix;     // [n_windows, rows, cols]
};

// SplitMix64, identical to roko_tpu_torch/utils/rng.py::SplitMix64.
class SplitMix64 {
 public:
  explicit SplitMix64(uint64_t seed) : state_(seed) {}
  uint64_t NextU64() {
    state_ += 0x9E3779B97F4A7C15ull;
    uint64_t z = state_;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  }
  uint64_t NextBelow(uint64_t n) { return NextU64() % n; }

 private:
  uint64_t state_;
};

// ref_seq: draft contig bytes starting at absolute position ref_off and
// covering at least [start, end); only read when cfg.ref_rows > 0. The
// offset lets region callers pass just their slice (O(region) IPC).
ExtractResult ExtractWindows(const std::string& bam_path,
                             const std::string& contig, int64_t start,
                             int64_t end, uint64_t seed,
                             const ExtractConfig& cfg,
                             const std::string& ref_seq = std::string(),
                             int64_t ref_off = 0);

}  // namespace roko
