// DiskQueue: durable, crash-recoverable append log over a file pair.
//
// The role of fdbserver/DiskQueue.actor.cpp (1,706 LoC): the TLog's
// persistence — push bytes, commit (fsync) before acking, pop consumed
// prefixes, and on restart recover exactly the committed records,
// stopping cleanly at a torn tail. The design here is a fresh two-file
// alternation (the reference also uses a paired-file ring):
//
//   * Records are framed [magic u32][seq u64][len u32][crc32 u32][bytes].
//     Sequence numbers are contiguous; recovery scans both files, orders
//     records by seq, and accepts the longest contiguous run with valid
//     checksums — a torn or corrupted frame ends recovery (data past it
//     was never acked, because commit() fsyncs before the TLog acks).
//   * Pops are themselves records (a control frame), so the pop floor is
//     recovered from the log stream like the reference's pop locations
//     ride the push stream.
//   * Writes go to the active file; when it exceeds the rotation size
//     and every record in the other file is popped, the other file is
//     truncated and becomes active — bounded disk usage, two fsyncs max
//     per commit.
//
// C ABI for ctypes (no pybind11 in the image).

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagicData = 0xD15C0001;
constexpr uint32_t kMagicPop = 0xD15C0002;

struct FrameHeader {
  uint32_t magic;
  uint64_t seq;
  uint32_t len;
  uint32_t crc;
} __attribute__((packed));

// CRC-32 (IEEE), small table implementation.
uint32_t crc32(const uint8_t* data, size_t n, uint32_t seed = 0) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  uint32_t c = ~seed;
  for (size_t i = 0; i < n; ++i) c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return ~c;
}

struct Record {
  uint64_t seq;
  bool isPop;
  uint64_t popTo;  // when isPop
  std::vector<uint8_t> data;
};

class DiskQueue {
 public:
  DiskQueue(const std::string& path0, const std::string& path1,
            uint64_t rotateBytes)
      : rotateBytes_(rotateBytes) {
    paths_[0] = path0;
    paths_[1] = path1;
    fds_[0] = ::open(path0.c_str(), O_RDWR | O_CREAT, 0644);
    fds_[1] = ::open(path1.c_str(), O_RDWR | O_CREAT, 0644);
    ok_ = fds_[0] >= 0 && fds_[1] >= 0;
    if (ok_) recover();
  }

  ~DiskQueue() {
    for (int f : fds_)
      if (f >= 0) ::close(f);
  }

  bool ok() const { return ok_; }
  uint64_t nextSeq() const { return nextSeq_; }
  uint64_t popFloor() const { return popFloor_; }

  // Buffered append; returns the record's seq. Not durable until commit().
  uint64_t push(const uint8_t* data, uint32_t len) {
    uint64_t seq = nextSeq_++;
    appendFrame(kMagicData, seq, data, len);
    return seq;
  }

  // Record that everything with seq < popTo may be discarded.
  void pop(uint64_t popTo) {
    if (popTo <= popFloor_) return;
    popFloor_ = popTo;
    uint8_t payload[8];
    std::memcpy(payload, &popTo, 8);
    appendFrame(kMagicPop, nextSeq_++, payload, 8);
  }

  // Flush buffered frames + fsync. Returns last durable seq (or UINT64_MAX
  // if nothing was ever pushed). Rotation happens here, before the write.
  uint64_t commit() {
    maybeRotate();
    if (!buffer_.empty()) {
      ssize_t n = ::pwrite(fds_[active_], buffer_.data(), buffer_.size(),
                           fileSize_[active_]);
      if (n != (ssize_t)buffer_.size()) {
        ok_ = false;
        return UINT64_MAX;
      }
      fileSize_[active_] += buffer_.size();
      buffer_.clear();
    }
    if (::fsync(fds_[active_]) != 0) ok_ = false;
    return nextSeq_ == 0 ? UINT64_MAX : nextSeq_ - 1;
  }

  // Recovered data records (seq ascending, already pop-filtered).
  const std::vector<Record>& recovered() const { return recovered_; }

 private:
  void appendFrame(uint32_t magic, uint64_t seq, const uint8_t* data,
                   uint32_t len) {
    FrameHeader h{magic, seq, len, crc32(data, len, magic ^ (uint32_t)seq)};
    const uint8_t* hp = reinterpret_cast<const uint8_t*>(&h);
    buffer_.insert(buffer_.end(), hp, hp + sizeof(h));
    buffer_.insert(buffer_.end(), data, data + len);
  }

  void maybeRotate() {
    if (fileSize_[active_] + buffer_.size() < rotateBytes_) return;
    int other = 1 - active_;
    // the other file may be reused only if all its records are popped
    if (maxSeqInFile_[other] != UINT64_MAX &&
        maxSeqInFile_[other] >= popFloor_)
      return;
    if (::ftruncate(fds_[other], 0) != 0) return;
    fileSize_[other] = 0;
    maxSeqInFile_[other] = UINT64_MAX;
    // re-anchor the pop floor at the head of the fresh file so recovery
    // of a queue whose old file held the only pop record stays correct
    active_ = other;
    uint8_t payload[8];
    uint64_t f = popFloor_;
    std::memcpy(payload, &f, 8);
    appendFrame(kMagicPop, nextSeq_++, payload, 8);
  }

  void scanFile(int idx, std::vector<Record>& out) {
    off_t size = ::lseek(fds_[idx], 0, SEEK_END);
    if (size <= 0) {
      fileSize_[idx] = size < 0 ? 0 : size;
      return;
    }
    std::vector<uint8_t> content(size);
    ssize_t n = ::pread(fds_[idx], content.data(), size, 0);
    if (n != size) return;
    size_t off = 0;
    size_t validEnd = 0;
    while (off + sizeof(FrameHeader) <= (size_t)size) {
      FrameHeader h;
      std::memcpy(&h, content.data() + off, sizeof(h));
      if (h.magic != kMagicData && h.magic != kMagicPop) break;
      if (off + sizeof(h) + h.len > (size_t)size) break;  // torn tail
      const uint8_t* payload = content.data() + off + sizeof(h);
      if (crc32(payload, h.len, h.magic ^ (uint32_t)h.seq) != h.crc) break;
      Record r;
      r.seq = h.seq;
      r.isPop = h.magic == kMagicPop;
      if (r.isPop && h.len == 8) std::memcpy(&r.popTo, payload, 8);
      if (!r.isPop) r.data.assign(payload, payload + h.len);
      out.push_back(std::move(r));
      if (!out.empty() && !out.back().isPop) {
        if (maxSeqInFile_[idx] == UINT64_MAX || h.seq > maxSeqInFile_[idx])
          maxSeqInFile_[idx] = h.seq;
      }
      if (maxAnySeqInFile_[idx] == UINT64_MAX ||
          h.seq > maxAnySeqInFile_[idx])
        maxAnySeqInFile_[idx] = h.seq;
      off += sizeof(h) + h.len;
      validEnd = off;
    }
    // Truncation policy is decided in recover() once both files are
    // scanned: only a PLAUSIBLE torn tail may be dropped. Blindly
    // truncating here would let a single mid-file bit flip in the older
    // file destroy every acked record after it — destructive recovery
    // on corruption. Resync probe: a frame that still validates past
    // the invalid region proves the damage is interior, not a tail.
    torn_[idx] = validEnd < (size_t)size;
    laterValid_[idx] =
        torn_[idx] && anyValidFrameAfter(content, validEnd + 1);
    validEnd_[idx] = validEnd;
    fileSize_[idx] = validEnd;
  }

  static bool anyValidFrameAfter(const std::vector<uint8_t>& content,
                                 size_t from) {
    size_t size = content.size();
    for (size_t p = from; p + sizeof(FrameHeader) <= size; ++p) {
      FrameHeader h;
      std::memcpy(&h, content.data() + p, sizeof(h));
      if (h.magic != kMagicData && h.magic != kMagicPop) continue;
      if (p + sizeof(h) + h.len > size) continue;
      if (crc32(content.data() + p + sizeof(h), h.len,
                h.magic ^ (uint32_t)h.seq) == h.crc)
        return true;
    }
    return false;
  }

  void recover() {
    std::vector<Record> all;
    maxSeqInFile_[0] = maxSeqInFile_[1] = UINT64_MAX;
    maxAnySeqInFile_[0] = maxAnySeqInFile_[1] = UINT64_MAX;
    scanFile(0, all);
    scanFile(1, all);
    // Which file holds the newest data? Only ITS trailing invalid bytes
    // are a plausible torn tail: tears (interrupted, never-acked,
    // possibly block-reordered commits) happen only in the file that was
    // active at the crash, which is the one with the newest sequence
    // numbers. Invalid bytes in the OLDER file are corruption of acked
    // data -> refuse to open rather than silently truncate it away —
    // with one exception: a file with NO valid frames, no revalidating
    // frame past the damage (resync probe), and a clean sibling is a
    // crash tearing the first write to a freshly rotated file.
    int newest = (maxAnySeqInFile_[1] != UINT64_MAX &&
                  (maxAnySeqInFile_[0] == UINT64_MAX ||
                   maxAnySeqInFile_[1] > maxAnySeqInFile_[0]))
                     ? 1
                     : 0;
    for (int idx = 0; idx < 2; ++idx) {
      if (!torn_[idx]) continue;
      bool noValidFrames = maxAnySeqInFile_[idx] == UINT64_MAX;
      bool freshRotationTear = noValidFrames && !torn_[1 - idx];
      // A frame that still validates PAST the damage means the invalid
      // region sits between recoverable records — interior corruption,
      // never a tail — regardless of which file it is. (A torn
      // multi-frame flush can in principle leave stray valid frames via
      // out-of-order block persistence, but none of those bytes were
      // acked either way; refusing loudly beats silently discarding
      // what may be acked data.)
      if (laterValid_[idx] || (idx != newest && !freshRotationTear)) {
        ok_ = false;  // corruption of acked data: fail loudly
        return;
      }
      if (::ftruncate(fds_[idx], validEnd_[idx]) != 0) ok_ = false;
    }
    std::sort(all.begin(), all.end(),
              [](const Record& a, const Record& b) { return a.seq < b.seq; });
    // longest contiguous run ending at the max seq... records committed
    // in order: accept ascending contiguous from the START; a gap means
    // the earlier part was popped+truncated, so accept the LAST
    // contiguous run.
    size_t runStart = 0;
    for (size_t i = 1; i < all.size(); ++i) {
      if (all[i].seq != all[i - 1].seq + 1) runStart = i;
    }
    uint64_t floor = 0;
    std::vector<Record> run(all.begin() + runStart, all.end());
    for (const Record& r : run) {
      if (r.isPop && r.popTo > floor) floor = r.popTo;
    }
    popFloor_ = floor;
    nextSeq_ = run.empty() ? 0 : run.back().seq + 1;
    for (Record& r : run) {
      if (!r.isPop && r.seq >= floor) recovered_.push_back(std::move(r));
    }
    // append after existing content in the file holding the newest data
    if (!all.empty()) {
      active_ = (maxSeqInFile_[1] != UINT64_MAX &&
                 (maxSeqInFile_[0] == UINT64_MAX ||
                  maxSeqInFile_[1] > maxSeqInFile_[0]))
                    ? 1
                    : 0;
    }
  }

  std::string paths_[2];
  int fds_[2] = {-1, -1};
  uint64_t rotateBytes_;
  bool ok_ = false;
  int active_ = 0;
  uint64_t nextSeq_ = 0;
  uint64_t popFloor_ = 0;
  uint64_t fileSize_[2] = {0, 0};
  uint64_t maxSeqInFile_[2] = {UINT64_MAX, UINT64_MAX};
  uint64_t maxAnySeqInFile_[2] = {UINT64_MAX, UINT64_MAX};
  bool torn_[2] = {false, false};
  bool laterValid_[2] = {false, false};
  size_t validEnd_[2] = {0, 0};
  std::vector<uint8_t> buffer_;
  std::vector<Record> recovered_;
};

}  // namespace

extern "C" {

void* dq_open(const char* path0, const char* path1, uint64_t rotate_bytes) {
  DiskQueue* q = new DiskQueue(path0, path1, rotate_bytes);
  if (!q->ok()) {
    delete q;
    return nullptr;
  }
  return q;
}

void dq_close(void* q) { delete static_cast<DiskQueue*>(q); }

uint64_t dq_push(void* q, const uint8_t* data, uint32_t len) {
  return static_cast<DiskQueue*>(q)->push(data, len);
}

void dq_pop(void* q, uint64_t pop_to) {
  static_cast<DiskQueue*>(q)->pop(pop_to);
}

uint64_t dq_commit(void* q) { return static_cast<DiskQueue*>(q)->commit(); }

int dq_ok(void* q) { return static_cast<DiskQueue*>(q)->ok() ? 1 : 0; }

uint64_t dq_next_seq(void* q) {
  return static_cast<DiskQueue*>(q)->nextSeq();
}

uint64_t dq_pop_floor(void* q) {
  return static_cast<DiskQueue*>(q)->popFloor();
}

int64_t dq_recovered_count(void* q) {
  return static_cast<DiskQueue*>(q)->recovered().size();
}

// Copy recovered record i into buf (if cap allows); returns its length
// and writes its seq.
int64_t dq_recovered_get(void* q, int64_t i, uint8_t* buf, int64_t cap,
                         uint64_t* seq) {
  const auto& rec = static_cast<DiskQueue*>(q)->recovered();
  if (i < 0 || (size_t)i >= rec.size()) return -1;
  const Record& r = rec[i];
  *seq = r.seq;
  if ((int64_t)r.data.size() <= cap && !r.data.empty())
    std::memcpy(buf, r.data.data(), r.data.size());
  return r.data.size();
}

}  // extern "C"
