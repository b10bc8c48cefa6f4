#include "bam.h"

#include <algorithm>
#include <cstring>

namespace roko {

namespace {

constexpr char kBamMagic[4] = {'B', 'A', 'M', 1};
constexpr char kBaiMagic[4] = {'B', 'A', 'I', 1};
constexpr int kLinearShift = 14;

// ops that consume the reference: M, D, N, =, X
inline bool ConsumesRef(uint32_t op) {
  return op == 0 || op == 2 || op == 3 || op == 7 || op == 8;
}

uint32_t ReadU32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // BAM is little-endian; so are our targets
}

int32_t ReadI32(const uint8_t* p) {
  int32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

}  // namespace

int32_t BamRecord::ReferenceEnd() const {
  int64_t n = 0;
  for (uint32_t c : cigar) {
    if (ConsumesRef(c & 0xF)) n += c >> 4;
  }
  return n > 0 ? static_cast<int32_t>(pos + n) : pos + 1;
}

BamReader::BamReader(const std::string& path) : path_(path) {
  bgzf_.reset(new BgzfReader(path));
  uint8_t magic[4];
  if (bgzf_->Read(magic, 4) != 4 || std::memcmp(magic, kBamMagic, 4) != 0)
    throw BgzfError(path + ": not a BAM file");
  uint8_t buf[4];
  if (bgzf_->Read(buf, 4) != 4) throw BgzfError(path + ": truncated header");
  int32_t l_text = ReadI32(buf);
  std::vector<uint8_t> text(l_text);
  if (bgzf_->Read(text.data(), l_text) != static_cast<size_t>(l_text))
    throw BgzfError(path + ": truncated header text");
  if (bgzf_->Read(buf, 4) != 4) throw BgzfError(path + ": truncated n_ref");
  int32_t n_ref = ReadI32(buf);
  references_.reserve(n_ref);
  for (int32_t i = 0; i < n_ref; ++i) {
    if (bgzf_->Read(buf, 4) != 4) throw BgzfError(path + ": truncated ref");
    int32_t l_name = ReadI32(buf);
    std::vector<uint8_t> name(l_name);
    if (bgzf_->Read(name.data(), l_name) != static_cast<size_t>(l_name))
      throw BgzfError(path + ": truncated ref name");
    if (bgzf_->Read(buf, 4) != 4) throw BgzfError(path + ": truncated ref len");
    std::string sname(reinterpret_cast<char*>(name.data()), l_name - 1);
    tid_by_name_[sname] = static_cast<int>(references_.size());
    references_.emplace_back(std::move(sname), ReadI32(buf));
  }
  first_record_voffset_ = bgzf_->TellVirtual();
}

int BamReader::TidByName(const std::string& name) const {
  auto it = tid_by_name_.find(name);
  return it == tid_by_name_.end() ? -1 : it->second;
}

namespace {

// Scan the tag region for a CG:B,I array (the real CIGAR of reads whose
// op count overflows the 16-bit n_cigar field; the fixed field then
// holds the placeholder "<l_seq>S<ref_len>N", SAM spec §4.2.2).
bool FindCgTag(const uint8_t* tags, size_t len, std::vector<uint32_t>* out) {
  size_t off = 0;
  while (off + 3 <= len) {
    char t0 = static_cast<char>(tags[off]);
    char t1 = static_cast<char>(tags[off + 1]);
    char type = static_cast<char>(tags[off + 2]);
    off += 3;
    size_t size = 0;
    switch (type) {
      case 'A': case 'c': case 'C': size = 1; break;
      case 's': case 'S': size = 2; break;
      case 'i': case 'I': case 'f': size = 4; break;
      case 'Z': case 'H': {
        while (off < len && tags[off] != 0) ++off;
        ++off;
        continue;
      }
      case 'B': {
        if (off + 5 > len) return false;
        char elem = static_cast<char>(tags[off]);
        uint32_t count = ReadU32(tags + off + 1);
        size_t esize = (elem == 'c' || elem == 'C') ? 1
                       : (elem == 's' || elem == 'S') ? 2
                                                      : 4;
        if (t0 == 'C' && t1 == 'G' && elem == 'I') {
          if (off + 5 + 4ull * count > len) return false;
          out->resize(count);
          std::memcpy(out->data(), tags + off + 5, 4ull * count);
          return true;
        }
        off += 5 + esize * count;
        continue;
      }
      default:
        return false;  // unknown tag type: stop scanning
    }
    off += size;
  }
  return false;
}

}  // namespace

bool BamReader::ReadRecord(BamRecord* rec) {
  uint8_t buf[4];
  if (bgzf_->Read(buf, 4) < 4) return false;
  int32_t block_size = ReadI32(buf);
  if (block_size < 32) throw BgzfError(path_ + ": invalid record size");
  std::vector<uint8_t> body(block_size);
  if (bgzf_->Read(body.data(), block_size) != static_cast<size_t>(block_size))
    throw BgzfError(path_ + ": truncated record");

  const uint8_t* p = body.data();
  rec->tid = ReadI32(p + 0);
  rec->pos = ReadI32(p + 4);
  uint8_t l_read_name = p[8];
  rec->mapq = p[9];
  uint16_t n_cigar;
  std::memcpy(&n_cigar, p + 12, 2);
  std::memcpy(&rec->flag, p + 14, 2);
  rec->l_seq = ReadI32(p + 16);
  if (rec->l_seq < 0 || l_read_name < 1)
    throw BgzfError(path_ + ": malformed record");
  size_t need = 32ull + l_read_name + 4ull * n_cigar +
                (static_cast<size_t>(rec->l_seq) + 1) / 2 +
                static_cast<size_t>(rec->l_seq);
  if (need > static_cast<size_t>(block_size))
    throw BgzfError(path_ + ": record fields exceed block size");
  // next_tid (20), next_pos (24), tlen (28) unused by the extractor
  size_t off = 32;
  rec->name.assign(reinterpret_cast<const char*>(p + off), l_read_name - 1);
  off += l_read_name;
  rec->cigar.resize(n_cigar);
  for (uint16_t i = 0; i < n_cigar; ++i, off += 4)
    rec->cigar[i] = ReadU32(p + off);
  rec->seq_nib.resize(rec->l_seq);
  for (int32_t i = 0; i < rec->l_seq; ++i) {
    uint8_t byte = p[off + (i >> 1)];
    rec->seq_nib[i] = (i % 2 == 0) ? (byte >> 4) : (byte & 0xF);
  }
  off += (static_cast<size_t>(rec->l_seq) + 1) / 2;
  off += static_cast<size_t>(rec->l_seq);  // qual unused

  // ultralong-read CIGAR overflow: placeholder kS mN + CG:B,I tag
  if (rec->cigar.size() == 2 && (rec->cigar[0] & 0xF) == 4 /*S*/ &&
      (rec->cigar[1] & 0xF) == 3 /*N*/ &&
      static_cast<int32_t>(rec->cigar[0] >> 4) == rec->l_seq) {
    std::vector<uint32_t> real_cigar;
    if (FindCgTag(p + off, block_size - off, &real_cigar))
      rec->cigar = std::move(real_cigar);
  }
  return true;
}

const std::vector<BamReader::RefIndex>* BamReader::LoadIndex() {
  if (index_loaded_) return index_present_ ? &index_ : nullptr;
  index_loaded_ = true;
  std::string bai_path = path_ + ".bai";
  std::FILE* fh = std::fopen(bai_path.c_str(), "rb");
  if (!fh) return nullptr;
  std::fseek(fh, 0, SEEK_END);
  long size = std::ftell(fh);
  std::fseek(fh, 0, SEEK_SET);
  std::vector<uint8_t> data(size);
  if (std::fread(data.data(), 1, size, fh) != static_cast<size_t>(size)) {
    std::fclose(fh);
    throw BgzfError(bai_path + ": short read");
  }
  std::fclose(fh);
  if (size < 8 || std::memcmp(data.data(), kBaiMagic, 4) != 0)
    throw BgzfError(bai_path + ": not a BAI index");
  const size_t n = data.size();
  size_t off = 4;
  auto need = [&](size_t count) {
    if (off + count > n) throw BgzfError(bai_path + ": truncated BAI index");
  };
  need(4);
  int32_t n_ref = ReadI32(data.data() + off);
  off += 4;
  if (n_ref < 0) throw BgzfError(bai_path + ": corrupt BAI index");
  index_.resize(n_ref);
  for (int32_t r = 0; r < n_ref; ++r) {
    need(4);
    int32_t n_bin = ReadI32(data.data() + off);
    off += 4;
    if (n_bin < 0) throw BgzfError(bai_path + ": corrupt BAI index");
    for (int32_t b = 0; b < n_bin; ++b) {
      need(8);
      uint32_t bin_id;
      std::memcpy(&bin_id, data.data() + off, 4);
      int32_t n_chunk = ReadI32(data.data() + off + 4);
      if (n_chunk < 0) throw BgzfError(bai_path + ": corrupt BAI index");
      need(8 + 16ul * n_chunk);
      off += 8;
      auto& chunks = index_[r].bins[bin_id];
      chunks.reserve(n_chunk);
      for (int32_t c = 0; c < n_chunk; ++c) {
        uint64_t beg, cend;
        std::memcpy(&beg, data.data() + off, 8);
        std::memcpy(&cend, data.data() + off + 8, 8);
        off += 16;
        chunks.emplace_back(beg, cend);
      }
    }
    need(4);
    int32_t n_intv = ReadI32(data.data() + off);
    off += 4;
    if (n_intv < 0) throw BgzfError(bai_path + ": corrupt BAI index");
    need(8ul * n_intv);
    index_[r].ioffsets.resize(n_intv);
    std::memcpy(index_[r].ioffsets.data(), data.data() + off, 8ul * n_intv);
    off += 8ul * n_intv;
  }
  index_present_ = true;
  return &index_;
}

namespace {
// Candidate bins possibly holding records overlapping [beg, end)
// (SAM spec §5.3 recurrence).
void Reg2Bins(int64_t beg, int64_t end, std::vector<uint32_t>* bins) {
  --end;
  bins->push_back(0);
  static constexpr struct { uint32_t base; int shift; } kLevels[] = {
      {1, 26}, {9, 23}, {73, 20}, {585, 17}, {4681, 14}};
  for (const auto& lv : kLevels)
    for (int64_t k = lv.base + (beg >> lv.shift);
         k <= lv.base + (end >> lv.shift); ++k)
      bins->push_back(static_cast<uint32_t>(k));
}

uint64_t LinearMinVoffset(const std::vector<uint64_t>& ioffsets,
                          int64_t start) {
  if (ioffsets.empty()) return 0;
  int64_t i = std::min<int64_t>(start >> kLinearShift,
                                static_cast<int64_t>(ioffsets.size()) - 1);
  while (i >= 0 && ioffsets[i] == 0) --i;
  return i >= 0 ? ioffsets[i] : 0;
}
}  // namespace

bool BamReader::RegionChunks(int tid, int64_t start, int64_t end,
                             std::vector<std::pair<uint64_t, uint64_t>>* out) {
  const auto* index = LoadIndex();
  if (!index || tid >= static_cast<int>(index->size())) return false;
  const RefIndex& ref = (*index)[tid];
  if (ref.bins.empty()) return false;  // linear-only .bai
  uint64_t min_voff = LinearMinVoffset(ref.ioffsets, start);
  std::vector<uint32_t> bins;
  Reg2Bins(start, end, &bins);
  std::vector<std::pair<uint64_t, uint64_t>> chunks;
  for (uint32_t b : bins) {
    auto it = ref.bins.find(b);
    if (it == ref.bins.end()) continue;
    for (const auto& ch : it->second)
      if (ch.second > min_voff)
        chunks.emplace_back(std::max(ch.first, min_voff), ch.second);
  }
  std::sort(chunks.begin(), chunks.end());
  out->clear();
  for (const auto& ch : chunks) {
    if (!out->empty() && ch.first <= out->back().second)
      out->back().second = std::max(out->back().second, ch.second);
    else
      out->push_back(ch);
  }
  return true;
}

std::vector<BamRecord> BamReader::Fetch(const std::string& contig,
                                        int64_t start, int64_t end) {
  int tid = TidByName(contig);
  if (tid < 0) throw BgzfError(path_ + ": unknown contig " + contig);
  if (end < 0) end = references_[tid].second;

  std::vector<BamRecord> out;
  BamRecord rec;

  std::vector<std::pair<uint64_t, uint64_t>> chunks;
  if (RegionChunks(tid, start, end, &chunks)) {
    // binned query: read only the region's chunk list (htslib shape)
    for (const auto& ch : chunks) {
      bgzf_->SeekVirtual(ch.first);
      while (bgzf_->TellVirtual() < ch.second && ReadRecord(&rec)) {
        if (rec.tid != tid) {
          if (rec.tid > tid || rec.tid < 0) return out;  // sorted: past
          continue;
        }
        if (rec.pos >= end) return out;
        if (rec.IsUnmapped()) continue;
        if (rec.ReferenceEnd() > start) out.push_back(rec);
      }
    }
    return out;
  }

  uint64_t voffset = first_record_voffset_;
  const auto* index = LoadIndex();
  if (index && tid < static_cast<int>(index->size())) {
    uint64_t lin = LinearMinVoffset((*index)[tid].ioffsets, start);
    if (lin) voffset = lin;
  }
  bgzf_->SeekVirtual(voffset);

  while (ReadRecord(&rec)) {
    if (rec.tid != tid) {
      if (rec.tid > tid || rec.tid < 0) break;  // coordinate-sorted
      continue;
    }
    if (rec.pos >= end) break;
    if (rec.IsUnmapped()) continue;
    if (rec.ReferenceEnd() > start) out.push_back(rec);
  }
  return out;
}

}  // namespace roko
