#include "bgzf.h"

#include <zlib.h>

#include <cstring>

namespace roko {

namespace {
constexpr size_t kHeaderSize = 12;  // fixed gzip header through XLEN
}

BgzfReader::BgzfReader(const std::string& path) : path_(path) {
  file_ = std::fopen(path.c_str(), "rb");
  if (!file_) throw BgzfError(path + ": cannot open");
  try {
    if (!LoadBlockAt(0)) eof_ = true;
  } catch (...) {
    // destructor won't run for a partially constructed object
    std::fclose(file_);
    file_ = nullptr;
    throw;
  }
}

BgzfReader::~BgzfReader() {
  if (file_) std::fclose(file_);
}

bool BgzfReader::LoadBlockAt(uint64_t coffset) {
  if (std::fseek(file_, static_cast<long>(coffset), SEEK_SET) != 0)
    throw BgzfError(path_ + ": seek failed");

  uint8_t header[kHeaderSize];
  size_t got = std::fread(header, 1, kHeaderSize, file_);
  if (got == 0) return false;  // clean EOF
  if (got < kHeaderSize) throw BgzfError(path_ + ": truncated BGZF header");
  if (header[0] != 0x1f || header[1] != 0x8b)
    throw BgzfError(path_ + ": not a gzip stream");
  if (!(header[3] & 0x04))
    throw BgzfError(path_ + ": gzip member without FEXTRA (not BGZF)");

  uint16_t xlen = static_cast<uint16_t>(header[10] | (header[11] << 8));
  std::vector<uint8_t> extra(xlen);
  if (std::fread(extra.data(), 1, xlen, file_) != xlen)
    throw BgzfError(path_ + ": truncated FEXTRA");

  // find the BC subfield carrying BSIZE (total block size - 1)
  int bsize = -1;
  for (size_t i = 0; i + 4 <= extra.size();) {
    uint8_t si1 = extra[i], si2 = extra[i + 1];
    uint16_t slen = static_cast<uint16_t>(extra[i + 2] | (extra[i + 3] << 8));
    if (si1 == 'B' && si2 == 'C' && slen == 2 && i + 6 <= extra.size()) {
      bsize = extra[i + 4] | (extra[i + 5] << 8);
    }
    i += 4 + slen;
  }
  if (bsize < 0) throw BgzfError(path_ + ": BGZF BC subfield missing");
  if (static_cast<size_t>(bsize) + 1 < kHeaderSize + xlen + 8)
    throw BgzfError(path_ + ": corrupt BGZF block size");

  size_t cdata_len =
      static_cast<size_t>(bsize) + 1 - kHeaderSize - xlen - 8;  // minus CRC+ISIZE
  std::vector<uint8_t> cdata(cdata_len);
  if (std::fread(cdata.data(), 1, cdata_len, file_) != cdata_len)
    throw BgzfError(path_ + ": truncated CDATA");

  uint8_t tail[8];
  if (std::fread(tail, 1, 8, file_) != 8)
    throw BgzfError(path_ + ": truncated CRC/ISIZE");
  uint32_t isize = static_cast<uint32_t>(tail[4]) | (tail[5] << 8) |
                   (tail[6] << 16) | (static_cast<uint32_t>(tail[7]) << 24);

  block_.assign(isize, 0);
  if (isize > 0) {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK)
      throw BgzfError(path_ + ": inflateInit2 failed");
    zs.next_in = cdata.data();
    zs.avail_in = static_cast<uInt>(cdata.size());
    zs.next_out = block_.data();
    zs.avail_out = static_cast<uInt>(block_.size());
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (rc != Z_STREAM_END)
      throw BgzfError(path_ + ": corrupt BGZF block (inflate rc=" +
                      std::to_string(rc) + ")");
    uint32_t crc = crc32(0L, block_.data(), static_cast<uInt>(block_.size()));
    uint32_t want = static_cast<uint32_t>(tail[0]) | (tail[1] << 8) |
                    (tail[2] << 16) | (static_cast<uint32_t>(tail[3]) << 24);
    if (crc != want) throw BgzfError(path_ + ": BGZF CRC mismatch");
  }

  block_coffset_ = coffset;
  next_coffset_ = coffset + static_cast<uint64_t>(bsize) + 1;
  block_pos_ = 0;
  eof_ = false;
  return true;
}

size_t BgzfReader::Read(uint8_t* out, size_t n) {
  size_t done = 0;
  while (done < n) {
    if (block_pos_ >= block_.size()) {
      if (eof_ || !LoadBlockAt(next_coffset_)) {
        eof_ = true;
        break;
      }
      // empty EOF-marker blocks: keep advancing
      continue;
    }
    size_t take = std::min(n - done, block_.size() - block_pos_);
    std::memcpy(out + done, block_.data() + block_pos_, take);
    block_pos_ += take;
    done += take;
  }
  return done;
}

uint64_t BgzfReader::TellVirtual() const {
  // a fully consumed block addresses the *next* block's start: BGZF
  // blocks may hold exactly 65536 bytes, where (coffset, 65536) would
  // alias (coffset, 0) under the 16-bit uoffset mask
  if (block_pos_ >= block_.size() && !eof_)
    return next_coffset_ << 16;
  return (block_coffset_ << 16) | static_cast<uint64_t>(block_pos_ & 0xFFFF);
}

void BgzfReader::SeekVirtual(uint64_t voffset) {
  uint64_t coffset = voffset >> 16;
  size_t uoffset = static_cast<size_t>(voffset & 0xFFFF);
  if (coffset != block_coffset_ || eof_ || block_.empty()) {
    if (!LoadBlockAt(coffset)) throw BgzfError(path_ + ": seek past EOF");
  }
  if (uoffset > block_.size())
    throw BgzfError(path_ + ": virtual offset beyond block");
  block_pos_ = uoffset;
  eof_ = false;
}

bool BgzfReader::AtEof() {
  if (block_pos_ < block_.size()) return false;
  if (eof_) return true;
  if (!LoadBlockAt(next_coffset_)) {
    eof_ = true;
    return true;
  }
  return block_pos_ >= block_.size() && AtEof();
}

}  // namespace roko
