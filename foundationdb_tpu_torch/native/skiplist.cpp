// Skip-list CPU baseline: an algorithmically faithful reimplementation of
// the reference resolver's conflict path (fdbserver/SkipList.cpp), built
// so the card's kernels are measured against the structure the reference
// actually ships rather than the ordered-map semantic model in
// conflict_set.cpp (a copy of the JAX package's
// foundationdb_tpu/native/skiplist.cpp).
//
// What is reproduced (behaviorally, not textually):
//   * version-annotated skip list over segment-start keys with per-level
//     max-version pyramids (SkipList.cpp:222-309) — value-at-key is the
//     version of the segment [key, next_key);
//   * point sort with the begin/end/read/write tie-break ordering
//     (sortPoints :170-220, extra_ordering :95-121) via an LSD radix sort
//     on an 8-byte key prefix with a comparator fallback for longer keys;
//   * read-vs-history range-max queries riding the pyramids
//     (CheckMax :695-759 contract: conflict iff max version over segments
//     intersecting [begin, end) exceeds the read snapshot);
//   * sequential intra-batch check over the dense rank space with a
//     bitset sweep (MiniConflictSet :857-899);
//   * combineWriteConflictRanges' coverage-parity union (:996-1011) and
//     merge of committed writes at the batch version (addConflictRanges
//     :430-441: ensure end node, drop interior, insert begin@version);
//   * windowed GC with the keep-one-dead-boundary rule
//     (removeBefore :576-608), amortized with a bounded per-batch budget.
//
// Keys are never copied at unpack time: ranges reference the caller's
// flat blob (StringRef-style), and bytes are copied only when a node is
// inserted (into size-class freelist storage, FastAllocator-style).
//
// C ABI for ctypes, mirroring conflict_set.cpp (same verdict contract).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

using Version = int64_t;
constexpr Version kNegInf = INT64_MIN / 2;

struct KeyRef {
  const uint8_t* p = nullptr;
  uint32_t len = 0;
};

// FDB key order: byte-lexicographic, shorter-before-longer at equal prefix.
inline int cmpKey(const uint8_t* a, uint32_t alen, const uint8_t* b,
                  uint32_t blen) {
  uint32_t n = alen < blen ? alen : blen;
  int c = n ? std::memcmp(a, b, n) : 0;
  if (c) return c;
  return (alen > blen) - (alen < blen);
}
inline int cmpKey(const KeyRef& a, const KeyRef& b) {
  return cmpKey(a.p, a.len, b.p, b.len);
}

// ---------------------------------------------------------------------------
// Size-class node allocator (the role of FastAllocator<64/128>).

class NodePool {
 public:
  ~NodePool() {
    for (void* b : blocks_) std::free(b);
  }
  void* alloc(size_t size) {
    int cls = sizeClass(size);
    if (cls < 0) return std::malloc(size);
    void*& head = free_[cls];
    if (!head) refill(cls);
    void* out = head;
    head = *reinterpret_cast<void**>(out);
    return out;
  }
  void release(void* p, size_t size) {
    int cls = sizeClass(size);
    if (cls < 0) {
      std::free(p);
      return;
    }
    *reinterpret_cast<void**>(p) = free_[cls];
    free_[cls] = p;
  }

 private:
  static int sizeClass(size_t size) {
    if (size <= 64) return 0;
    if (size <= 128) return 1;
    if (size <= 256) return 2;
    return -1;
  }
  void refill(int cls) {
    size_t sz = 64u << cls;
    size_t count = 1024;
    char* block = static_cast<char*>(std::malloc(sz * count));
    blocks_.push_back(block);
    for (size_t i = 0; i < count; ++i) {
      void* p = block + i * sz;
      *reinterpret_cast<void**>(p) = free_[cls];
      free_[cls] = p;
    }
  }
  void* free_[3] = {nullptr, nullptr, nullptr};
  std::vector<void*> blocks_;
};

// ---------------------------------------------------------------------------
// The skip list. Nodes hold segment-start keys; maxv[l] of node x is the
// max of maxv[0] over nodes in [x, next(x, l)) — the "pyramid".

constexpr int kMaxLevels = 26;

struct Node {
  // layout: Node header, then level+1 Node*, then level+1 Version, then key
  int16_t levels;  // = level + 1
  uint32_t keyLen;

  Node** nexts() { return reinterpret_cast<Node**>(this + 1); }
  Version* maxvs() { return reinterpret_cast<Version*>(nexts() + levels); }
  uint8_t* key() { return reinterpret_cast<uint8_t*>(maxvs() + levels); }

  Node* next(int l) { return nexts()[l]; }
  void setNext(int l, Node* n) { nexts()[l] = n; }
  Version maxv(int l) { return maxvs()[l]; }
  void setMaxv(int l, Version v) { maxvs()[l] = v; }

  static size_t byteSize(int levels, uint32_t keyLen) {
    return sizeof(Node) + levels * (sizeof(Node*) + sizeof(Version)) + keyLen;
  }
};

class SkipList {
 public:
  SkipList() {
    header_ = makeNode(KeyRef{}, kMaxLevels - 1);
    for (int l = 0; l < kMaxLevels; ++l) {
      header_->setNext(l, nullptr);
      header_->setMaxv(l, kNegInf);
    }
  }
  ~SkipList() {
    Node* x = header_;
    while (x) {
      Node* n = x->next(0);
      freeNode(x);
      x = n;
    }
  }

  size_t count() const { return count_; }

  // Max version over history segments intersecting [begin, end):
  // value of the segment containing `begin` plus every boundary in
  // (begin, end). Exact under the maintenance discipline described at
  // `write` and `gcStep` (pyramids never over-report inside the MVCC
  // window). This is the CheckMax verdict contract.
  Version maxOver(const KeyRef& begin, const KeyRef& end) {
    Node* path[kMaxLevels];
    descend(begin, /*strictly_less_or_equal=*/true, path);
    // path[0] = last node with key <= begin (header if none): its mv(0) is
    // the version of the segment containing `begin`.
    Node* x = path[0];
    Version acc = x->maxv(0);
    // Walk right, consuming the widest pyramid spans that stay < end.
    int l = x->levels - 1;
    while (true) {
      while (l > 0 && (!x->next(l) || !nodeKeyLess(x->next(l), end))) --l;
      Node* nx = x->next(l);
      if (!nx || !nodeKeyLess(nx, end)) break;
      // [x, nx) is already accounted (acc covers x; pyramid value of x at
      // level l covers [x, nx) — fold it in and jump).
      acc = std::max(acc, x->maxv(l));
      x = nx;
      acc = std::max(acc, x->maxv(0));
      l = x->levels - 1;
    }
    return acc;
  }

  // Overwrite [begin, end) with `version` — the addConflictRanges step
  // for one range (SkipList.cpp:430-441): ensure a node at `end`
  // carrying the prior segment version, drop interior nodes, install
  // `begin` at `version`. `version` must be the newest version in the
  // structure (true for the resolver: batches commit in version order),
  // which is what keeps the pyramids exact after the splice.
  void write(const KeyRef& begin, const KeyRef& end, Version version) {
    Node* path[kMaxLevels];
    // --- ensure end node exists (carries the old segment version).
    descend(end, /*strictly_less_or_equal=*/true, path);
    if (!keyEquals(path[0], end)) {
      insertAt(path, end, path[0]->maxv(0));
    }
    // --- remove interior nodes in (begin, end) and install begin.
    descend(begin, /*strictly_less_or_equal=*/false, path);
    // path[l] = last node with key < begin at each level.
    Node* stop = findAtLeast(path[0], end);  // first node with key >= end
    Node* doomed = path[0]->next(0) == stop ? nullptr : path[0]->next(0);
    // Unlink every node in [first >= begin, stop) at all levels.
    for (int l = 0; l < kMaxLevels; ++l) {
      Node* p = path[l];
      Node* n = p->next(l);
      while (n && n != stop && nodeBefore(n, stop)) n = n->next(l);
      if (p->next(l) != n) p->setNext(l, n);
    }
    while (doomed && doomed != stop) {
      Node* nx = doomed->next(0);
      count_--;
      freeNode(doomed);
      doomed = nx;
    }
    insertAt(path, begin, version);
    // Raise pyramids above the new node's height: the spliced region now
    // contains `version`, the global max, so raising is exact repair.
    for (int l = 0; l < kMaxLevels; ++l) {
      if (path[l]->maxv(l) < version) path[l]->setMaxv(l, version);
    }
  }

  // One bounded GC step (removeBefore :576-608): walk level 0 from the
  // resume point, erase nodes whose version is below `floor` unless the
  // previous node was live (a dead node after a live one is the boundary
  // that ends the live segment and must survive). Budget bounds work per
  // batch; the resume key persists across calls.
  void gcStep(Version floor, int budget) {
    Node* path[kMaxLevels];
    KeyRef resume{resumeKey_.data(), (uint32_t)resumeKey_.size()};
    descend(resume, /*strictly_less_or_equal=*/false, path);
    bool prevLive = true;
    while (budget-- > 0) {
      Node* x = path[0]->next(0);
      if (!x) {
        resumeKey_.clear();
        return;
      }
      bool live = x->maxv(0) >= floor;
      if (live || prevLive) {
        // keep: advance the path over x
        for (int l = 0; l < x->levels; ++l) path[l] = x;
      } else {
        // erase: absorb pyramid maxes into the predecessors (values are
        // below `floor`, hence below every live snapshot — conservative
        // but invisible, same as the reference).
        for (int l = 0; l < x->levels; ++l) {
          path[l]->setNext(l, x->next(l));
          if (l > 0 && path[l]->maxv(l) < x->maxv(l))
            path[l]->setMaxv(l, x->maxv(l));
        }
        count_--;
        freeNode(x);
      }
      prevLive = live;
    }
    Node* at = path[0];
    if (at == header_) {
      resumeKey_.clear();
    } else {
      resumeKey_.assign(at->key(), at->key() + at->keyLen);
    }
  }

 private:
  // path[l] := last node whose key is <= value (orEqual) or < value.
  void descend(const KeyRef& value, bool orEqual, Node** path) {
    Node* x = header_;
    for (int l = kMaxLevels - 1; l >= 0; --l) {
      while (true) {
        Node* n = x->next(l);
        if (!n) break;
        int c = cmpKey(n->key(), n->keyLen, value.p, value.len);
        if (c < 0 || (orEqual && c == 0)) {
          x = n;
        } else {
          break;
        }
      }
      path[l] = x;
    }
  }

  Node* findAtLeast(Node* from, const KeyRef& value) {
    Node* n = from->next(0);
    while (n && cmpKey(n->key(), n->keyLen, value.p, value.len) < 0)
      n = n->next(0);
    return n;
  }

  bool nodeKeyLess(Node* n, const KeyRef& k) {
    return cmpKey(n->key(), n->keyLen, k.p, k.len) < 0;
  }
  bool nodeBefore(Node* a, Node* b) {
    // b != nullptr check done by caller when needed
    return b == nullptr ||
           cmpKey(a->key(), a->keyLen, b->key(), b->keyLen) < 0;
  }
  bool keyEquals(Node* n, const KeyRef& k) {
    return n != header_ && n->keyLen == k.len &&
           (k.len == 0 || std::memcmp(n->key(), k.p, k.len) == 0);
  }

  int randomLevel() {
    // Geometric(1/2), capped — same distribution family as the reference.
    rng_ ^= rng_ << 13;
    rng_ ^= rng_ >> 7;
    rng_ ^= rng_ << 17;
    uint32_t bits = (uint32_t)rng_;
    int level = 0;
    while ((bits & 1) && level < kMaxLevels - 2) {
      bits >>= 1;
      ++level;
    }
    return level;
  }

  Node* makeNode(const KeyRef& k, int level) {
    int levels = level + 1;
    size_t sz = Node::byteSize(levels, k.len);
    Node* n = static_cast<Node*>(pool_.alloc(sz));
    n->levels = (int16_t)levels;
    n->keyLen = k.len;
    if (k.len) std::memcpy(n->key(), k.p, k.len);
    return n;
  }
  void freeNode(Node* n) {
    pool_.release(n, Node::byteSize(n->levels, n->keyLen));
  }

  // Insert a fresh node at the position recorded in `path`, then repair
  // pyramids: levels 1..level recompute from the level below (exactly the
  // calcVersionForLevel discipline); the caller raises higher levels.
  void insertAt(Node** path, const KeyRef& k, Version version) {
    int level = randomLevel();
    Node* x = makeNode(k, level);
    x->setMaxv(0, version);
    for (int l = 0; l <= level; ++l) {
      x->setNext(l, path[l]->next(l));
      path[l]->setNext(l, x);
    }
    for (int l = 1; l <= level; ++l) {
      recalc(path[l], l);
      recalc(x, l);
    }
    for (int l = level + 1; l < kMaxLevels; ++l) {
      if (path[l]->maxv(l) < version)
        path[l]->setMaxv(l, version);
      else
        break;  // reference invariant: higher levels already cover
    }
    // update path so subsequent raises see the new node where applicable
    for (int l = 0; l <= level; ++l) path[l] = x;
    count_++;
  }

  void recalc(Node* n, int l) {
    Node* stop = n->next(l);
    Version v = n->maxv(l - 1);
    for (Node* y = n->next(l - 1); y != stop; y = y->next(l - 1))
      v = std::max(v, y->maxv(l - 1));
    n->setMaxv(l, v);
  }

  Node* header_;
  NodePool pool_;
  uint64_t rng_ = 0x9E3779B97F4A7C15ull;
  size_t count_ = 0;
  std::vector<uint8_t> resumeKey_;
};

// ---------------------------------------------------------------------------
// Batch resolution: sortPoints + bitset intra-batch + history queries +
// committed-write union + merge + GC.

constexpr int kConflict = 0;
constexpr int kTooOld = 1;
constexpr int kCommitted = 3;

struct Point {
  uint64_t prefix;   // first 8 key bytes, big-endian (0-padded)
  uint32_t rangeIx;  // index into the flat range arrays (reads then writes)
  // minor ordering bits: (len<=8 ? len : 9) then extra_ordering
  uint16_t minor;
  uint8_t kind;  // 0=read-begin 1=read-end 2=write-begin 3=write-end
  uint8_t longKey;
};

inline uint64_t keyPrefix(const uint8_t* p, uint32_t len) {
  uint64_t v = 0;
  uint32_t n = len < 8 ? len : 8;
  for (uint32_t i = 0; i < n; ++i) v |= (uint64_t)p[i] << (56 - 8 * i);
  return v;
}

// extra_ordering (SkipList.cpp:95-121): at equal full keys, order
// end(read) < end(write) < begin(write) < begin(read).
inline int extraOrdering(bool isBegin, bool isWrite) {
  return (isBegin ? 2 : 0) + (isWrite ^ isBegin ? 1 : 0);
}

struct FlatRanges {
  const uint8_t* keys;
  const int64_t* off;
  const int32_t* txn;
  int32_t n;
  KeyRef begin(int32_t i) const {
    return {keys + off[2 * i], (uint32_t)(off[2 * i + 1] - off[2 * i])};
  }
  KeyRef end(int32_t i) const {
    return {keys + off[2 * i + 1], (uint32_t)(off[2 * i + 2] - off[2 * i + 1])};
  }
};

class SkipListConflictSet {
 public:
  explicit SkipListConflictSet(Version window) : window_(window) {}

  void resolve(Version version, int32_t nTxns, const int64_t* snapshots,
               const FlatRanges& reads, const FlatRanges& writes,
               int32_t* verdict) {
    const Version newOldest = version - window_;
    tooOld_.assign(nTxns, 0);
    conflicted_.assign(nTxns, 0);
    hasReads_.assign(nTxns, 0);
    for (int32_t i = 0; i < reads.n; ++i) hasReads_[reads.txn[i]] = 1;
    for (int32_t t = 0; t < nTxns; ++t)
      if (hasReads_[t] && snapshots[t] < newOldest) tooOld_[t] = 1;

    // ---- phase 1: reads vs. history (CheckMax contract) ----------------
    for (int32_t i = 0; i < reads.n; ++i) {
      int32_t t = reads.txn[i];
      if (tooOld_[t] || conflicted_[t]) continue;
      KeyRef b = reads.begin(i), e = reads.end(i);
      if (cmpKey(b, e) >= 0) continue;
      if (history_.maxOver(b, e) > snapshots[t]) conflicted_[t] = 1;
    }

    // ---- sortPoints + dense ranks --------------------------------------
    buildPoints(reads, writes);
    sortPoints(reads, writes);
    assignRanks(reads, writes);

    // ---- phase 2: sequential intra-batch sweep (MiniConflictSet) -------
    intraBatch(nTxns, reads, writes);

    for (int32_t t = 0; t < nTxns; ++t)
      verdict[t] =
          tooOld_[t] ? kTooOld : (conflicted_[t] ? kConflict : kCommitted);

    // ---- phases 3-4: union committed writes, merge at version, GC ------
    mergeCommitted(writes, version);
    if (newOldest > oldest_) oldest_ = newOldest;
    if (oldest_ > kNegInf) {
      // budget ~2x this batch's inserts keeps the list in steady state
      history_.gcStep(oldest_, 4 * writes.n + 1024);
    }
  }

  size_t historySize() const { return history_.count(); }

 private:
  void buildPoints(const FlatRanges& reads, const FlatRanges& writes) {
    points_.clear();
    points_.reserve(2 * (reads.n + writes.n));
    auto add = [&](const FlatRanges& fr, int32_t i, bool isBegin,
                   bool isWrite) {
      KeyRef k = isBegin ? fr.begin(i) : fr.end(i);
      Point p;
      p.prefix = keyPrefix(k.p, k.len);
      p.rangeIx = (uint32_t)i | (isWrite ? 0x80000000u : 0);
      p.longKey = k.len > 8;
      p.minor = (uint16_t)(((k.len <= 8 ? k.len : 9) << 2) |
                           extraOrdering(isBegin, isWrite));
      p.kind = (uint8_t)((isWrite ? 2 : 0) + (isBegin ? 0 : 1));
      points_.push_back(p);
    };
    for (int32_t i = 0; i < reads.n; ++i) {
      add(reads, i, true, false);
      add(reads, i, false, false);
    }
    for (int32_t i = 0; i < writes.n; ++i) {
      add(writes, i, true, true);
      add(writes, i, false, true);
    }
  }

  // LSD radix on (prefix, minor); comparator fallback inside runs with
  // long keys (prefix ties with len > 8 need full-key comparison). This is
  // the role of the reference's MSD radix sortPoints (:170-220).
  void sortPoints(const FlatRanges& reads, const FlatRanges& writes) {
    size_t n = points_.size();
    scratch_.resize(n);
    Point* src = points_.data();
    Point* dst = scratch_.data();
    // 1 pass over minor (11 bits used) + 8 passes over prefix bytes.
    radixPass(src, dst, n, [](const Point& p) { return p.minor & 0x7FFu; },
              2048);
    std::swap(src, dst);
    for (int shift = 0; shift < 64; shift += 16) {
      radixPass(src, dst, n,
                [shift](const Point& p) {
                  return (uint32_t)((p.prefix >> shift) & 0xFFFF);
                },
                65536);
      std::swap(src, dst);
    }
    if (src != points_.data())
      std::memcpy(points_.data(), src, n * sizeof(Point));
    // Fallback: runs sharing a prefix that contain any long key get a
    // full comparator sort (stable w.r.t. the exact ordering contract).
    auto keyOf = [&](const Point& p) -> KeyRef {
      FlatRanges const& fr = (p.rangeIx & 0x80000000u) ? writes : reads;
      uint32_t i = p.rangeIx & 0x7FFFFFFFu;
      return (p.kind & 1) ? fr.end(i) : fr.begin(i);
    };
    size_t i = 0;
    while (i < n) {
      size_t j = i + 1;
      bool anyLong = points_[i].longKey;
      while (j < n && points_[j].prefix == points_[i].prefix) {
        anyLong |= points_[j].longKey;
        ++j;
      }
      if (anyLong && j - i > 1) {
        std::sort(points_.begin() + i, points_.begin() + j,
                  [&](const Point& a, const Point& b) {
                    KeyRef ka = keyOf(a), kb = keyOf(b);
                    int c = cmpKey(ka, kb);
                    if (c) return c < 0;
                    return (a.minor & 3) < (b.minor & 3);
                  });
      }
      i = j;
    }
  }

  template <typename Fn>
  void radixPass(Point* src, Point* dst, size_t n, Fn digit, size_t buckets) {
    counts_.assign(buckets + 1, 0);
    for (size_t i = 0; i < n; ++i) counts_[digit(src[i]) + 1]++;
    for (size_t b = 1; b <= buckets; ++b) counts_[b] += counts_[b - 1];
    for (size_t i = 0; i < n; ++i) dst[counts_[digit(src[i])]++] = src[i];
  }

  // Dense ranks: equal full keys share a rank (minor bits excluded).
  void assignRanks(const FlatRanges& reads, const FlatRanges& writes) {
    size_t n = points_.size();
    rbRank_.resize(reads.n);
    reRank_.resize(reads.n);
    wbRank_.resize(writes.n);
    weRank_.resize(writes.n);
    auto keyOf = [&](const Point& p) -> KeyRef {
      FlatRanges const& fr = (p.rangeIx & 0x80000000u) ? writes : reads;
      uint32_t i = p.rangeIx & 0x7FFFFFFFu;
      return (p.kind & 1) ? fr.end(i) : fr.begin(i);
    };
    int32_t rank = -1;
    uint64_t prevPrefix = ~0ull;
    uint32_t prevLen = ~0u;
    KeyRef prevKey{};
    for (size_t i = 0; i < n; ++i) {
      const Point& p = points_[i];
      KeyRef k = keyOf(p);
      bool same = (rank >= 0) && p.prefix == prevPrefix && k.len == prevLen &&
                  (k.len <= 8 || std::memcmp(k.p, prevKey.p, k.len) == 0);
      if (!same) {
        ++rank;
        prevPrefix = p.prefix;
        prevLen = k.len;
        prevKey = k;
      }
      uint32_t ix = p.rangeIx & 0x7FFFFFFFu;
      switch (p.kind) {
        case 0: rbRank_[ix] = rank; break;
        case 1: reRank_[ix] = rank; break;
        case 2: wbRank_[ix] = rank; break;
        case 3: weRank_[ix] = rank; break;
      }
    }
    nRanks_ = rank + 1;
  }

  // Sequential sweep in txn order: a txn's reads conflict with writes of
  // earlier committed txns in the same batch; its own writes then join
  // the bitset. Word-parallel over the dense rank space. Range->txn
  // mapping goes through counting-sorted index lists, so any wire
  // ordering of the flat arrays is accepted (the map baseline's unpack
  // accepts any order too).
  void intraBatch(int32_t nTxns, const FlatRanges& reads,
                  const FlatRanges& writes) {
    size_t words = (size_t)(nRanks_ + 63) / 64;
    bits_.assign(words, 0);
    groupByTxn(nTxns, reads, readOff_, readIdx_);
    groupByTxn(nTxns, writes, writeOff_, writeIdx_);
    for (int32_t t = 0; t < nTxns; ++t) {
      bool dead = tooOld_[t] || conflicted_[t];
      if (!dead) {
        for (int32_t j = readOff_[t]; j < readOff_[t + 1]; ++j) {
          int32_t ri = readIdx_[j];
          if (anyBit(rbRank_[ri], reRank_[ri])) {
            conflicted_[t] = 1;
            break;
          }
        }
      }
      if (!tooOld_[t] && !conflicted_[t]) {
        for (int32_t j = writeOff_[t]; j < writeOff_[t + 1]; ++j) {
          int32_t wi = writeIdx_[j];
          setBits(wbRank_[wi], weRank_[wi]);
        }
      }
    }
  }

  void groupByTxn(int32_t nTxns, const FlatRanges& fr,
                  std::vector<int32_t>& off, std::vector<int32_t>& idx) {
    off.assign(nTxns + 1, 0);
    idx.resize(fr.n);
    for (int32_t i = 0; i < fr.n; ++i) off[fr.txn[i] + 1]++;
    for (int32_t t = 0; t < nTxns; ++t) off[t + 1] += off[t];
    cursor_.assign(off.begin(), off.end() - 1);
    for (int32_t i = 0; i < fr.n; ++i) idx[cursor_[fr.txn[i]]++] = i;
  }

  bool anyBit(int32_t lo, int32_t hi) {
    if (lo >= hi) return false;
    size_t wl = (size_t)lo >> 6, wh = (size_t)(hi - 1) >> 6;
    uint64_t first = ~0ull << (lo & 63);
    uint64_t last = ~0ull >> (63 - ((hi - 1) & 63));
    if (wl == wh) return (bits_[wl] & first & last) != 0;
    if (bits_[wl] & first) return true;
    for (size_t w = wl + 1; w < wh; ++w)
      if (bits_[w]) return true;
    return (bits_[wh] & last) != 0;
  }
  void setBits(int32_t lo, int32_t hi) {
    if (lo >= hi) return;
    size_t wl = (size_t)lo >> 6, wh = (size_t)(hi - 1) >> 6;
    uint64_t first = ~0ull << (lo & 63);
    uint64_t last = ~0ull >> (63 - ((hi - 1) & 63));
    if (wl == wh) {
      bits_[wl] |= first & last;
      return;
    }
    bits_[wl] |= first;
    for (size_t w = wl + 1; w < wh; ++w) bits_[w] = ~0ull;
    bits_[wh] |= last;
  }

  // Union the committed txns' write ranges by coverage parity over the
  // sorted points (combineWriteConflictRanges :996-1011), writing each
  // union run into the skip list at `version`.
  void mergeCommitted(const FlatRanges& writes, Version version) {
    int depth = 0;
    KeyRef runBegin{};
    bool inRun = false;
    for (const Point& p : points_) {
      if (!(p.rangeIx & 0x80000000u)) continue;  // write points only
      uint32_t i = p.rangeIx & 0x7FFFFFFFu;
      int32_t t = writes.txn[i];
      if (tooOld_[t] || conflicted_[t]) continue;
      // empty/inverted ranges must not perturb the parity depth
      if (cmpKey(writes.begin(i), writes.end(i)) >= 0) continue;
      bool isBegin = (p.kind & 1) == 0;
      KeyRef k = isBegin ? writes.begin(i) : writes.end(i);
      if (isBegin) {
        if (depth == 0) {
          runBegin = k;
          inRun = true;
        }
        ++depth;
      } else {
        --depth;
        if (depth == 0 && inRun) {
          if (cmpKey(runBegin, k) < 0) history_.write(runBegin, k, version);
          inRun = false;
        }
      }
    }
  }

  SkipList history_;
  Version window_;
  Version oldest_ = kNegInf;
  std::vector<char> tooOld_, conflicted_, hasReads_;
  std::vector<Point> points_, scratch_;
  std::vector<uint32_t> counts_;
  std::vector<int32_t> rbRank_, reRank_, wbRank_, weRank_;
  std::vector<int32_t> readOff_, readIdx_, writeOff_, writeIdx_, cursor_;
  std::vector<uint64_t> bits_;
  int32_t nRanks_ = 0;
};

}  // namespace

extern "C" {

void* slcs_create(int64_t window) { return new SkipListConflictSet(window); }

void slcs_destroy(void* cs) { delete static_cast<SkipListConflictSet*>(cs); }

void slcs_resolve(void* cs, int64_t version, int32_t n_txns,
                  const int64_t* snapshots, const uint8_t* rkeys,
                  const int64_t* roff, const int32_t* rtxn, int32_t n_reads,
                  const uint8_t* wkeys, const int64_t* woff,
                  const int32_t* wtxn, int32_t n_writes, int32_t* verdict) {
  FlatRanges reads{rkeys, roff, rtxn, n_reads};
  FlatRanges writes{wkeys, woff, wtxn, n_writes};
  static_cast<SkipListConflictSet*>(cs)->resolve(version, n_txns, snapshots,
                                                 reads, writes, verdict);
}

int64_t slcs_history_size(void* cs) {
  return static_cast<SkipListConflictSet*>(cs)->historySize();
}

}  // extern "C"
