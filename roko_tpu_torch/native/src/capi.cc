// C ABI for the native extractor, consumed via ctypes
// (roko_tpu_torch/native/binding.py). One call per region; the caller copies
// the returned buffers into numpy arrays and frees them.
#include <cstdlib>
#include <cstring>
#include <string>

#include "align.h"
#include "extract.h"

namespace {
thread_local std::string g_last_error;
}

extern "C" {

// The binding refuses a library of another ABI version.
// v2: roko_extract_windows gained (ref_seq, ref_len, ref_rows).
int roko_native_abi_version() { return 2; }

struct RokoResult {
  int64_t n_windows;
  int64_t* positions;  // [n_windows, cols, 2], malloc'd
  uint8_t* matrix;     // [n_windows, rows, cols], malloc'd
};

const char* roko_last_error() { return g_last_error.c_str(); }

// Returns 0 on success, nonzero on error (message via roko_last_error).
// ref_seq/ref_len: draft contig bytes (starting at absolute position
// ref_off) for the ref_rows draft-base rows; pass nullptr/0/0 when
// ref_rows == 0.
int roko_extract_windows(const char* bam_path, const char* contig,
                         int64_t start, int64_t end, uint64_t seed, int rows,
                         int cols, int stride, int max_ins, int min_mapq,
                         int filter_flag, int require_proper_pair,
                         const char* ref_seq, int64_t ref_len,
                         int64_t ref_off, int ref_rows, RokoResult* out) {
  try {
    roko::ExtractConfig cfg;
    cfg.rows = rows;
    cfg.cols = cols;
    cfg.stride = stride;
    cfg.max_ins = max_ins;
    cfg.ref_rows = ref_rows;
    cfg.min_mapq = min_mapq;
    cfg.filter_flag = static_cast<uint16_t>(filter_flag);
    cfg.require_proper_pair = require_proper_pair != 0;

    roko::ExtractResult res = roko::ExtractWindows(
        bam_path, contig, start, end, seed, cfg,
        ref_seq ? std::string(ref_seq, static_cast<size_t>(ref_len))
                : std::string(),
        ref_off);

    out->n_windows = res.n_windows;
    out->positions = nullptr;
    out->matrix = nullptr;
    if (res.n_windows > 0) {
      out->positions = static_cast<int64_t*>(
          std::malloc(res.positions.size() * sizeof(int64_t)));
      out->matrix = static_cast<uint8_t*>(std::malloc(res.matrix.size()));
      if (!out->positions || !out->matrix) {
        std::free(out->positions);
        std::free(out->matrix);
        g_last_error = "out of memory";
        return 2;
      }
      std::memcpy(out->positions, res.positions.data(),
                  res.positions.size() * sizeof(int64_t));
      std::memcpy(out->matrix, res.matrix.data(), res.matrix.size());
    }
    return 0;
  } catch (const std::exception& e) {
    g_last_error = e.what();
    return 1;
  }
}

// Banded global alignment of a vs b (roko_tpu/eval/assess.py segment
// hot loop). out8 receives [match, sub, ins, del, hit_band_edge, 0, 0,
// 0]. Returns 0 on success; 3 ONLY when the band x length working set
// exceeds max_cells (retryable: caller shrinks the segment or widens
// in steps); 1 for internal aligner bugs, which the binding raises as
// RuntimeError rather than letting the caller degrade them into
// plausible worst-case counts (ADVICE r3).
int roko_align_counts(const char* a, int64_t la, const char* b, int64_t lb,
                      int64_t pad, int64_t max_cells, int64_t* out8) {
  try {
    roko::AlignCounts c;
    switch (roko::BandedAlign(a, la, b, lb, pad, max_cells, &c)) {
      case roko::AlignStatus::kOk:
        break;
      case roko::AlignStatus::kCellsCap:
        g_last_error = "alignment working set exceeds max_cells";
        return 3;
      case roko::AlignStatus::kUnreachableEnd:
        g_last_error = "internal aligner error: end cell unreachable";
        return 1;
      case roko::AlignStatus::kCorruptTraceback:
        g_last_error = "internal aligner error: corrupt traceback";
        return 1;
    }
    out8[0] = c.match;
    out8[1] = c.sub;
    out8[2] = c.ins;
    out8[3] = c.del_;
    out8[4] = c.hit_band_edge ? 1 : 0;
    out8[5] = out8[6] = out8[7] = 0;
    return 0;
  } catch (const std::exception& e) {
    g_last_error = e.what();
    return 1;
  }
}

void roko_free_result(RokoResult* res) {
  if (!res) return;
  std::free(res->positions);
  std::free(res->matrix);
  res->positions = nullptr;
  res->matrix = nullptr;
  res->n_windows = 0;
}

}  // extern "C"
