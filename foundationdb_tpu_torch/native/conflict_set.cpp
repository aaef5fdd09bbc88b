// CPU reference conflict set: a baseline the card's kernels are measured
// against, and an independent parity oracle (a copy of the JAX
// package's foundationdb_tpu/native/conflict_set.cpp).
//
// Semantics mirror the reference's ConflictBatch pipeline
// (fdbserver/SkipList.cpp:909-956 detectConflicts: history check,
// sequential intra-batch check, combine committed writes, merge at the
// batch version, MVCC-window GC) and its tooOld rule
// (:819-828: snapshot < newOldestVersion AND the txn has reads). The
// implementation is NOT a port of the reference's skip list: committed
// write history lives in an ordered std::map as a piecewise-constant
// key->version function (segment starts keyed by boundary, background
// version below the first boundary), which gives the same
// max-version-over-range contract (CheckMax, :695-759) with idiomatic
// C++ instead of a hand-rolled lock-free structure.
//
// Exposed as a C ABI for ctypes (no pybind11 in the image).

#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

using Key = std::string;
using Version = int64_t;

constexpr Version kNegInf = INT64_MIN / 2;

// Piecewise-constant map key -> last-commit version.
class VersionMap {
 public:
  // Value in force at `k`.
  Version at(const Key& k) const {
    auto it = segs_.upper_bound(k);
    if (it == segs_.begin()) return background_;
    return std::prev(it)->second;
  }

  // Max version over segments intersecting [begin, end).
  Version maxOver(const Key& begin, const Key& end) const {
    Version best = at(begin);
    for (auto it = segs_.upper_bound(begin); it != segs_.end() && it->first < end;
         ++it) {
      best = std::max(best, it->second);
    }
    return best;
  }

  // Overwrite [begin, end) with `version` (SkipList::addConflictRanges
  // contract: interior boundaries die, end inherits the prior value).
  void write(const Key& begin, const Key& end, Version version) {
    if (begin >= end) return;
    Version tail = at(end);
    auto lo = segs_.lower_bound(begin);
    auto hi = segs_.lower_bound(end);
    bool endHasBoundary = hi != segs_.end() && hi->first == end;
    segs_.erase(lo, hi);
    segs_[begin] = version;
    if (!endHasBoundary) segs_[end] = tail;
  }

  // Drop segments whose version can no longer conflict
  // (SkipList::removeBefore :576-608).
  void gc(Version oldest) {
    if (background_ < oldest) background_ = kNegInf;
    bool prevDead = true;
    for (auto it = segs_.begin(); it != segs_.end();) {
      bool dead = it->second < oldest;
      if (dead) {
        if (prevDead) {
          it = segs_.erase(it);
          continue;
        }
        it->second = kNegInf;
      }
      prevDead = dead;
      ++it;
    }
  }

  size_t size() const { return segs_.size(); }

 private:
  std::map<Key, Version> segs_;
  Version background_ = kNegInf;
};

struct Range {
  Key begin, end;
};

struct Txn {
  std::vector<Range> reads, writes;
  Version snapshot = 0;
};

constexpr int kConflict = 0;   // ConflictBatch::TransactionConflict
constexpr int kTooOld = 1;     // ConflictBatch::TransactionTooOld
constexpr int kCommitted = 3;  // ConflictBatch::TransactionCommitted

class ConflictSet {
 public:
  explicit ConflictSet(Version window) : window_(window) {}

  void resolve(const std::vector<Txn>& txns, Version version, int32_t* verdict) {
    const Version newOldest = version - window_;
    const size_t n = txns.size();
    std::vector<char> tooOld(n, 0), conflicted(n, 0);

    for (size_t t = 0; t < n; ++t) {
      if (!txns[t].reads.empty() && txns[t].snapshot < newOldest) tooOld[t] = 1;
    }

    // Phase 1: reads vs. persistent history.
    for (size_t t = 0; t < n; ++t) {
      if (tooOld[t]) continue;
      for (const Range& r : txns[t].reads) {
        if (r.begin >= r.end) continue;  // empty/inverted: touches nothing
        if (history_.maxOver(r.begin, r.end) > txns[t].snapshot) {
          conflicted[t] = 1;
          break;
        }
      }
    }

    // Phase 2: sequential intra-batch — earlier committed writes conflict
    // later reads (MiniConflictSet semantics, SkipList.cpp:874-899).
    VersionMap batchWrites;  // values: 1 = written this batch
    std::vector<const Txn*> committedTxns;
    for (size_t t = 0; t < n; ++t) {
      if (conflicted[t]) continue;  // history-conflicted: contributes nothing
      bool conflict = tooOld[t];
      if (!conflict) {
        for (const Range& r : txns[t].reads) {
          if (r.begin >= r.end) continue;  // empty/inverted: touches nothing
          if (batchWrites.maxOver(r.begin, r.end) > 0) {
            conflict = true;
            break;
          }
        }
      }
      if (conflict) {
        conflicted[t] = 1;
      } else {
        for (const Range& r : txns[t].writes) {
          if (r.begin < r.end) batchWrites.write(r.begin, r.end, 1);
        }
      }
    }

    // Verdicts (Resolver.actor.cpp:349-356 classification order).
    for (size_t t = 0; t < n; ++t) {
      verdict[t] = tooOld[t] ? kTooOld : (conflicted[t] ? kConflict : kCommitted);
    }

    // Phase 3+4: merge committed writes at `version`, then GC. Writing
    // through the same VersionMap reproduces combineWriteConflictRanges +
    // mergeWriteConflictRanges (:996-1011, :430-441).
    for (size_t t = 0; t < n; ++t) {
      if (verdict[t] != kCommitted) continue;
      for (const Range& r : txns[t].writes) {
        if (r.begin < r.end) history_.write(r.begin, r.end, version);
      }
    }
    if (newOldest > oldest_) {
      oldest_ = newOldest;
      history_.gc(oldest_);
    }
  }

  size_t historySize() const { return history_.size(); }

 private:
  VersionMap history_;
  Version window_;
  Version oldest_ = kNegInf;
};

// Unpack the flat wire arrays into Txns. Layout (all little-endian host):
//   keys:       concatenated key bytes
//   offsets:    [2*n_ranges+1] offsets into `keys` (begin_i, end_i pairs)
//   range_txn:  [n_ranges] owning txn index
// for reads and writes separately.
std::vector<Txn> unpack(int32_t n_txns, const int64_t* snapshots,
                        const uint8_t* rkeys, const int64_t* roff,
                        const int32_t* rtxn, int32_t n_reads,
                        const uint8_t* wkeys, const int64_t* woff,
                        const int32_t* wtxn, int32_t n_writes) {
  std::vector<Txn> txns(n_txns);
  for (int32_t t = 0; t < n_txns; ++t) txns[t].snapshot = snapshots[t];
  auto slice = [](const uint8_t* base, int64_t a, int64_t b) {
    return Key(reinterpret_cast<const char*>(base) + a, b - a);
  };
  for (int32_t i = 0; i < n_reads; ++i) {
    txns[rtxn[i]].reads.push_back({slice(rkeys, roff[2 * i], roff[2 * i + 1]),
                                   slice(rkeys, roff[2 * i + 1], roff[2 * i + 2])});
  }
  for (int32_t i = 0; i < n_writes; ++i) {
    txns[wtxn[i]].writes.push_back({slice(wkeys, woff[2 * i], woff[2 * i + 1]),
                                    slice(wkeys, woff[2 * i + 1], woff[2 * i + 2])});
  }
  return txns;
}

}  // namespace

extern "C" {

void* cs_create(int64_t window) { return new ConflictSet(window); }

void cs_destroy(void* cs) { delete static_cast<ConflictSet*>(cs); }

// Resolve one batch; writes per-txn verdicts (0/1/3) into `verdict`.
void cs_resolve(void* cs, int64_t version, int32_t n_txns,
                const int64_t* snapshots, const uint8_t* rkeys,
                const int64_t* roff, const int32_t* rtxn, int32_t n_reads,
                const uint8_t* wkeys, const int64_t* woff, const int32_t* wtxn,
                int32_t n_writes, int32_t* verdict) {
  auto txns = unpack(n_txns, snapshots, rkeys, roff, rtxn, n_reads, wkeys, woff,
                     wtxn, n_writes);
  static_cast<ConflictSet*>(cs)->resolve(txns, version, verdict);
}

int64_t cs_history_size(void* cs) {
  return static_cast<ConflictSet*>(cs)->historySize();
}

}  // extern "C"
