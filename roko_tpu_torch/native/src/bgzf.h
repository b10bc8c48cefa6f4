// BGZF (blocked gzip) reader over zlib raw inflate.
//
// Host-side native I/O layer: replaces the reference's vendored htslib
// BGZF machinery (SURVEY.md §2.13) with a from-scratch implementation of
// the BGZF spec (SAM spec §4.1): concatenated gzip members carrying a
// BC extra subfield with the compressed block size. Supports virtual
// offsets (coffset << 16 | uoffset) for BAI-indexed seeks.
#pragma once

#include <cstdint>
#include <cstdio>
#include <stdexcept>
#include <string>
#include <vector>

namespace roko {

class BgzfError : public std::runtime_error {
 public:
  explicit BgzfError(const std::string& msg) : std::runtime_error(msg) {}
};

class BgzfReader {
 public:
  explicit BgzfReader(const std::string& path);
  ~BgzfReader();
  BgzfReader(const BgzfReader&) = delete;
  BgzfReader& operator=(const BgzfReader&) = delete;

  // Read exactly n bytes unless EOF; returns bytes read.
  size_t Read(uint8_t* out, size_t n);
  // Virtual offset of the next byte to be read.
  uint64_t TellVirtual() const;
  void SeekVirtual(uint64_t voffset);
  bool AtEof();

 private:
  bool LoadBlockAt(uint64_t coffset);  // false at EOF

  std::FILE* file_;
  std::string path_;
  uint64_t block_coffset_ = 0;     // file offset of the current block
  uint64_t next_coffset_ = 0;      // file offset of the next block
  std::vector<uint8_t> block_;     // inflated payload of current block
  size_t block_pos_ = 0;           // cursor within block_
  bool eof_ = false;
};

}  // namespace roko
