// Versioned LSM storage engine: the persistent engine behind StorageRole.
//
// Role parity: the reference's storage servers sit on a real on-disk
// engine — sqlite (fdbserver/KeyValueStoreSQLite.actor.cpp), Redwood
// (fdbserver/VersionedBTree.actor.cpp), or RocksDB — with three load-
// bearing properties this file reproduces with an LSM rather than a
// B-tree (a deliberate redesign, not a port):
//
//   1. data > RAM: records live in sorted runs on disk; point reads
//      pread one sparse-index block; only sparse indexes + range
//      tombstones + the memtable stay resident.
//   2. restart cost ∝ tail: a MANIFEST names the runs and the durable
//      version; recovery re-opens runs (O(index)) and the caller replays
//      only its write-ahead log above durable_version (StorageRole's
//      DiskQueue mutation log — same discipline as
//      KeyValueStoreMemory's log+snapshot and Redwood's pager).
//   3. MVCC window: records keep (version, value-or-clear) pairs; reads
//      are at-version; compaction drops versions below the GC floor,
//      keeping the floor winner (storageserver.actor.cpp's
//      VersionedMap::forgetVersionsBefore semantics).
//
// Durability discipline: runs are fsync'd before the MANIFEST names
// them; the MANIFEST is replaced atomically (tmp + rename + dir fsync);
// orphan runs from a crash between the two are swept on open. kill -9
// at any point loses only the un-flushed memtable — which the caller's
// WAL replays.
//
// Concurrency: one writer at a time (the role serializes applies); this
// file does no locking.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dirent.h>
#include <fcntl.h>
#include <map>
#include <memory>
#include <optional>
#include <queue>
#include <set>
#include <string>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

typedef long long i64;
typedef uint64_t u64;
typedef uint32_t u32;

constexpr i64 kVerNegInf = INT64_MIN;
const char kMagic[8] = {'V', 'L', 'S', 'M', '0', '0', '1', '\n'};
constexpr int kIndexEvery = 16;     // sparse index granularity (records)
constexpr int kCompactTrigger = 8;  // full-merge when runs exceed this

struct Tomb {
  std::string begin, end;
  i64 ver;
};

// ---- low-level file helpers ------------------------------------------------

bool write_all(int fd, const void* buf, size_t n) {
  const char* p = (const char*)buf;
  while (n) {
    ssize_t w = ::write(fd, p, n);
    if (w <= 0) return false;
    p += w;
    n -= (size_t)w;
  }
  return true;
}

bool fsync_dir(const std::string& dir) {
  int fd = ::open(dir.c_str(), O_RDONLY | O_DIRECTORY);
  if (fd < 0) return false;
  bool ok = ::fsync(fd) == 0;
  ::close(fd);
  return ok;
}

void put_u32(std::string& s, u32 v) { s.append((const char*)&v, 4); }
void put_i64(std::string& s, i64 v) { s.append((const char*)&v, 8); }

// ---- on-disk run -----------------------------------------------------------
//
// Layout:  [magic 8]
//          data section    : records, sorted by (key asc, ver asc)
//            record = klen u32 | key | ver i64 | flag u8 (1=set) | vlen u32 | value
//          tombstone section: blen u32 | begin | elen u32 | end | ver i64
//          index section   : klen u32 | key | off u64   (every kIndexEvery-th
//                            record + one PAST-END entry with the data end)
//          footer          : data_off tomb_off index_off n_rec n_tomb n_idx
//                            minv maxv  (8 x i64)  | magic 8

struct Footer {
  i64 data_off, tomb_off, index_off, n_rec, n_tomb, n_idx, minv, maxv;
};

struct Run {
  std::string path;
  int fd = -1;
  Footer f{};
  // resident: sparse index + all range tombstones
  std::vector<std::string> idx_keys;
  std::vector<u64> idx_offs;
  std::vector<Tomb> tombs;

  ~Run() {
    if (fd >= 0) ::close(fd);
  }
};

bool read_exact(int fd, void* buf, size_t n, i64 off) {
  char* p = (char*)buf;
  while (n) {
    ssize_t r = ::pread(fd, p, n, off);
    if (r <= 0) return false;
    p += r;
    off += r;
    n -= (size_t)r;
  }
  return true;
}

std::unique_ptr<Run> open_run(const std::string& path, std::string* err) {
  auto run = std::make_unique<Run>();
  run->path = path;
  run->fd = ::open(path.c_str(), O_RDONLY);
  if (run->fd < 0) {
    *err = "open failed: " + path;
    return nullptr;
  }
  struct stat st;
  if (fstat(run->fd, &st) != 0 || st.st_size < (i64)(8 + 64 + 8)) {
    *err = "run too short: " + path;
    return nullptr;
  }
  char tail[8];
  if (!read_exact(run->fd, tail, 8, st.st_size - 8) ||
      memcmp(tail, kMagic, 8) != 0) {
    *err = "bad trailing magic: " + path;
    return nullptr;
  }
  if (!read_exact(run->fd, &run->f, 64, st.st_size - 8 - 64)) {
    *err = "footer read failed: " + path;
    return nullptr;
  }
  const Footer& f = run->f;
  // load tombstones
  std::string buf;
  buf.resize(f.index_off - f.tomb_off);
  if (!buf.empty() && !read_exact(run->fd, &buf[0], buf.size(), f.tomb_off)) {
    *err = "tombstone read failed: " + path;
    return nullptr;
  }
  size_t p = 0;
  for (i64 i = 0; i < f.n_tomb; i++) {
    u32 bl, el;
    memcpy(&bl, &buf[p], 4);
    p += 4;
    std::string b = buf.substr(p, bl);
    p += bl;
    memcpy(&el, &buf[p], 4);
    p += 4;
    std::string e = buf.substr(p, el);
    p += el;
    i64 v;
    memcpy(&v, &buf[p], 8);
    p += 8;
    run->tombs.push_back({std::move(b), std::move(e), v});
  }
  // load sparse index
  buf.resize(st.st_size - 8 - 64 - f.index_off);
  if (!buf.empty() &&
      !read_exact(run->fd, &buf[0], buf.size(), f.index_off)) {
    *err = "index read failed: " + path;
    return nullptr;
  }
  p = 0;
  for (i64 i = 0; i < f.n_idx; i++) {
    u32 kl;
    memcpy(&kl, &buf[p], 4);
    p += 4;
    run->idx_keys.push_back(buf.substr(p, kl));
    p += kl;
    u64 off;
    memcpy(&off, &buf[p], 8);
    p += 8;
    run->idx_offs.push_back(off);
  }
  return run;
}

// A parsed record view during block scans / merges.
struct Rec {
  std::string key;
  i64 ver;
  bool is_set;
  std::string val;
};

// Sequential reader over a run's data section (for compaction / scans).
struct RunCursor {
  Run* run;
  i64 off, end;
  std::string buf;
  size_t pos = 0;
  i64 remaining;

  explicit RunCursor(Run* r)
      : run(r), off(r->f.data_off), end(r->f.tomb_off), remaining(r->f.n_rec) {}

  // Start at the sparse-index block whose range may contain `key`.
  void seek_block(const std::string& key) {
    auto& ks = run->idx_keys;
    // Start ONE block before the first index key >= `key`: when an
    // index entry EQUALS the key, older versions of that same key may
    // sit at the tail of the previous block (records sort by key then
    // version, and a key's versions can straddle an index boundary).
    // The final past-end sentinel entry is excluded from the search.
    size_t lo = std::lower_bound(ks.begin(), ks.end() - 1, key) - ks.begin();
    size_t blk = lo == 0 ? 0 : lo - 1;
    off = (i64)run->idx_offs[blk];
    remaining = INT64_MAX;  // bounded by `end`
    buf.clear();
    pos = 0;
  }

  // `off` is the absolute file offset of buf[0]; `off + pos` is the
  // cursor's absolute position.
  bool fill(size_t need) {
    if (pos + need <= buf.size()) return true;
    buf.erase(0, pos);
    off += (i64)pos;
    pos = 0;
    size_t have = buf.size();
    size_t want = std::max<size_t>(need, 1 << 16);
    i64 can = std::min<i64>((i64)want - (i64)have, end - (off + (i64)have));
    if (can > 0) {
      buf.resize(have + (size_t)can);
      if (!read_exact(run->fd, &buf[have], (size_t)can, off + (i64)have))
        return false;
    }
    return pos + need <= buf.size();
  }

  // Returns false at end of data section.
  bool next(Rec* out) {
    if (remaining <= 0) return false;
    if (off + (i64)pos >= end) return false;
    if (!fill(4)) return false;
    u32 kl;
    memcpy(&kl, &buf[pos], 4);
    if (!fill(4 + kl + 8 + 1 + 4)) return false;
    size_t p = pos + 4;
    out->key.assign(&buf[p], kl);
    p += kl;
    memcpy(&out->ver, &buf[p], 8);
    p += 8;
    out->is_set = buf[p] != 0;
    p += 1;
    u32 vl;
    memcpy(&vl, &buf[p], 4);
    p += 4;
    if (!fill((p - pos) + vl)) return false;
    p = pos + 4 + kl + 8 + 1 + 4;  // recompute: fill may have shifted buf
    out->val.assign(&buf[p], vl);
    pos = p + vl;
    remaining--;
    return true;
  }
};

// ---- run writer ------------------------------------------------------------

struct RunWriter {
  std::string dir, path, tmp;
  int fd = -1;
  std::string buf;
  i64 written = 0;
  i64 n_rec = 0;
  i64 minv = INT64_MAX, maxv = INT64_MIN;
  std::vector<std::string> idx_keys;
  std::vector<u64> idx_offs;
  std::string err;

  bool open(const std::string& d, const std::string& name) {
    dir = d;
    path = d + "/" + name;
    tmp = path + ".tmp";
    fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (fd < 0) {
      err = "create failed: " + tmp;
      return false;
    }
    buf.assign(kMagic, 8);
    written = 0;
    return true;
  }

  bool flush_buf() {
    if (!write_all(fd, buf.data(), buf.size())) {
      err = "write failed: " + path;
      return false;
    }
    written += (i64)buf.size();
    buf.clear();
    return true;
  }

  i64 pos() const { return written + (i64)buf.size(); }

  bool add(const Rec& r) {
    if (n_rec % kIndexEvery == 0) {
      idx_keys.push_back(r.key);
      idx_offs.push_back((u64)pos());
    }
    put_u32(buf, (u32)r.key.size());
    buf += r.key;
    put_i64(buf, r.ver);
    buf.push_back(r.is_set ? 1 : 0);
    put_u32(buf, (u32)(r.is_set ? r.val.size() : 0));
    if (r.is_set) buf += r.val;
    n_rec++;
    minv = std::min(minv, r.ver);
    maxv = std::max(maxv, r.ver);
    if (buf.size() > (1u << 20) && !flush_buf()) return false;
    return true;
  }

  // tombs must be begin-sorted; finish writes sections + footer + fsync.
  bool finish(const std::vector<Tomb>& tombs) {
    Footer f{};
    f.data_off = 8;
    f.tomb_off = pos();
    for (const auto& t : tombs) {
      put_u32(buf, (u32)t.begin.size());
      buf += t.begin;
      put_u32(buf, (u32)t.end.size());
      buf += t.end;
      put_i64(buf, t.ver);
      minv = std::min(minv, t.ver);
      maxv = std::max(maxv, t.ver);
      if (buf.size() > (1u << 20) && !flush_buf()) return false;
    }
    f.index_off = pos();
    // past-end index entry: empty key sentinel carrying the data end
    idx_keys.push_back(std::string());
    idx_offs.push_back((u64)f.tomb_off);
    f.n_idx = (i64)idx_keys.size();
    for (size_t i = 0; i < idx_keys.size(); i++) {
      put_u32(buf, (u32)idx_keys[i].size());
      buf += idx_keys[i];
      u64 off = idx_offs[i];
      buf.append((const char*)&off, 8);
      if (buf.size() > (1u << 20) && !flush_buf()) return false;
    }
    f.n_rec = n_rec;
    f.n_tomb = (i64)tombs.size();
    f.minv = n_rec + (i64)tombs.size() ? minv : 0;
    f.maxv = n_rec + (i64)tombs.size() ? maxv : 0;
    buf.append((const char*)&f, 64);
    buf.append(kMagic, 8);
    if (!flush_buf()) return false;
    if (::fsync(fd) != 0) {
      err = "fsync failed: " + path;
      return false;
    }
    ::close(fd);
    fd = -1;
    if (::rename(tmp.c_str(), path.c_str()) != 0) {
      err = "rename failed: " + path;
      return false;
    }
    return fsync_dir(dir);
  }
};

// ---- memtable --------------------------------------------------------------

struct MemTable {
  // key -> [(ver, value-or-nullopt)] ascending by apply order (versions
  // arrive monotonically per the role's contract)
  std::map<std::string, std::vector<std::pair<i64, std::optional<std::string>>>>
      points;
  std::vector<Tomb> clears;
  i64 bytes = 0;
  i64 minv = INT64_MAX, maxv = INT64_MIN;

  void note(i64 ver) {
    minv = std::min(minv, ver);
    maxv = std::max(maxv, ver);
  }

  void set(const std::string& k, i64 ver, const std::string& v) {
    points[k].emplace_back(ver, v);
    bytes += (i64)k.size() + (i64)v.size() + 24;
    note(ver);
  }

  void clear_range(const std::string& b, const std::string& e, i64 ver) {
    // eager per-key tombstones for memtable-resident keys keep
    // within-version mutation ORDER exact (a set after a clear at the
    // same version must survive; apply order is the tie-break)
    for (auto it = points.lower_bound(b); it != points.end() && it->first < e;
         ++it) {
      it->second.emplace_back(ver, std::nullopt);
      bytes += 24;
    }
    clears.push_back({b, e, ver});
    bytes += (i64)b.size() + (i64)e.size() + 24;
    note(ver);
  }

  bool empty() const { return points.empty() && clears.empty(); }

  void reset() {
    points.clear();
    clears.clear();
    bytes = 0;
    minv = INT64_MAX;
    maxv = INT64_MIN;
  }
};

// ---- the store -------------------------------------------------------------

struct Store {
  std::string dir;
  i64 window;
  i64 floor = 0;           // GC floor: versions <= floor may collapse
  i64 durable = 0;         // all versions <= durable are in runs
  i64 applied = 0;         // newest applied version (memtable included)
  i64 next_file = 1;
  MemTable mem;
  std::vector<std::unique_ptr<Run>> runs;  // oldest first
  std::string err;

  std::string manifest_path() const { return dir + "/MANIFEST"; }

  bool write_manifest() {
    std::string s = "vlsm 1\n";
    s += "durable " + std::to_string(durable) + "\n";
    s += "floor " + std::to_string(floor) + "\n";
    s += "next " + std::to_string(next_file) + "\n";
    for (auto& r : runs) {
      const char* base = strrchr(r->path.c_str(), '/');
      s += "run ";
      s += base ? base + 1 : r->path.c_str();
      s += "\n";
    }
    std::string tmp = manifest_path() + ".tmp";
    int fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (fd < 0) {
      err = "manifest create failed";
      return false;
    }
    bool ok = write_all(fd, s.data(), s.size()) && ::fsync(fd) == 0;
    ::close(fd);
    if (!ok) {
      err = "manifest write failed";
      return false;
    }
    if (::rename(tmp.c_str(), manifest_path().c_str()) != 0) {
      err = "manifest rename failed";
      return false;
    }
    return fsync_dir(dir);
  }

  bool load_manifest() {
    FILE* f = fopen(manifest_path().c_str(), "r");
    std::set<std::string> named;
    if (f) {
      char line[4096];
      while (fgets(line, sizeof line, f)) {
        std::string l(line);
        while (!l.empty() && (l.back() == '\n' || l.back() == '\r'))
          l.pop_back();
        if (l.rfind("durable ", 0) == 0)
          durable = atoll(l.c_str() + 8);
        else if (l.rfind("floor ", 0) == 0)
          floor = atoll(l.c_str() + 6);
        else if (l.rfind("next ", 0) == 0)
          next_file = atoll(l.c_str() + 5);
        else if (l.rfind("run ", 0) == 0) {
          std::string name = l.substr(4);
          auto run = open_run(dir + "/" + name, &err);
          if (!run) {
            fclose(f);
            return false;
          }
          named.insert(name);
          runs.push_back(std::move(run));
        }
      }
      fclose(f);
    }
    applied = durable;
    // sweep orphans: runs written but never named by a manifest (crash
    // between file fsync and manifest rename)
    DIR* d = opendir(dir.c_str());
    if (d) {
      std::vector<std::string> dead;
      while (struct dirent* e = readdir(d)) {
        std::string n(e->d_name);
        bool sst = n.size() > 4 && n.compare(n.size() - 4, 4, ".sst") == 0;
        bool tmp = n.size() > 4 && n.find(".tmp") != std::string::npos;
        if ((sst && !named.count(n)) || tmp) dead.push_back(n);
      }
      closedir(d);
      for (auto& n : dead) ::unlink((dir + "/" + n).c_str());
    }
    return true;
  }

  // -- reads -----------------------------------------------------------

  // best = record with max version <= v governing `key`.
  //
  // Equal-version ties encode WITHIN-version mutation order: clear_range
  // eagerly appends per-key point tombstones for memtable-resident keys,
  // so the point-record stream carries the apply order — a later-
  // considered POINT record at an equal version wins (`point_rec`),
  // while a RANGE tombstone never wins a tie (whenever its order vs a
  // same-version set matters, the eager point tombstone — or the set
  // appended after it — is the authoritative record).
  void consider(i64 ver, bool is_set, const std::string* val, i64* best_ver,
                bool* best_set, std::string* best_val, i64 v,
                bool point_rec = true) const {
    if (ver > v) return;
    if (point_rec ? (ver < *best_ver) : (ver <= *best_ver)) return;
    *best_ver = ver;
    *best_set = is_set;
    if (is_set) *best_val = *val;
  }

  bool get(const std::string& key, i64 v, std::string* out) {
    i64 best_ver = kVerNegInf;
    bool best_set = false;
    std::string best_val;
    auto it = mem.points.find(key);
    if (it != mem.points.end())
      for (auto& [ver, val] : it->second)
        consider(ver, val.has_value(), val ? &*val : nullptr, &best_ver,
                 &best_set, &best_val, v);
    for (auto& t : mem.clears)
      if (t.begin <= key && key < t.end)
        consider(t.ver, false, nullptr, &best_ver, &best_set, &best_val, v,
                 /*point_rec=*/false);
    for (auto& r : runs) {
      for (auto& t : r->tombs)
        if (t.begin <= key && key < t.end)
          consider(t.ver, false, nullptr, &best_ver, &best_set, &best_val, v,
                   /*point_rec=*/false);
      if (r->f.n_rec == 0) continue;
      RunCursor c(r.get());
      c.seek_block(key);
      Rec rec;
      while (c.next(&rec)) {
        if (rec.key > key) break;
        if (rec.key == key)
          consider(rec.ver, rec.is_set, &rec.val, &best_ver, &best_set,
                   &best_val, v);
      }
    }
    if (best_ver == kVerNegInf || !best_set) return false;
    *out = std::move(best_val);
    return true;
  }

  // -- flush -----------------------------------------------------------

  bool flush() {
    if (mem.empty()) {
      // no data, but `durable` may still advance (empty version
      // batches) — it must be PERSISTED before the caller pops WAL
      // records up to it, or a crash reopens below an acked version
      if (applied > durable) {
        durable = applied;
        return write_manifest();
      }
      return true;
    }
    RunWriter w;
    char name[64];
    snprintf(name, sizeof name, "%06lld.sst", (long long)next_file);
    if (!w.open(dir, name)) {
      err = w.err;
      return false;
    }
    for (auto& [k, hist] : mem.points) {
      // versions ascend in apply order; emit ascending
      for (auto& [ver, val] : hist) {
        Rec r{k, ver, val.has_value(), val ? *val : std::string()};
        if (!w.add(r)) {
          err = w.err;
          return false;
        }
      }
    }
    std::vector<Tomb> tombs = mem.clears;
    std::sort(tombs.begin(), tombs.end(),
              [](const Tomb& a, const Tomb& b) { return a.begin < b.begin; });
    if (!w.finish(tombs)) {
      err = w.err;
      return false;
    }
    auto run = open_run(w.path, &err);
    if (!run) return false;
    runs.push_back(std::move(run));
    next_file++;
    durable = std::max(durable, applied);
    if (!write_manifest()) return false;
    mem.reset();
    if ((int)runs.size() > kCompactTrigger) return compact();
    return true;
  }

  // -- compaction ------------------------------------------------------
  //
  // Full tiered merge: stream every run through a (key, ver) heap into
  // one new run, collapsing versions <= floor to the floor winner and
  // dropping tombstones <= floor (their effect is materialized). Memory
  // is O(one key's versions + tombstones), never O(data).

  struct HeapItem {
    Rec rec;
    size_t src;
    bool operator<(const HeapItem& o) const {
      // min-heap via greater-than
      if (rec.key != o.rec.key) return rec.key > o.rec.key;
      if (rec.ver != o.rec.ver) return rec.ver > o.rec.ver;
      return src > o.src;
    }
  };

  bool compact() {
    if (runs.empty()) return true;
    // gather tombstones: all of them feed winner logic; only > floor
    // survive into the merged run
    std::vector<Tomb> all_tombs;
    for (auto& r : runs)
      for (auto& t : r->tombs) all_tombs.push_back(t);
    std::sort(all_tombs.begin(), all_tombs.end(),
              [](const Tomb& a, const Tomb& b) { return a.begin < b.begin; });
    std::vector<Tomb> keep_tombs;
    for (auto& t : all_tombs)
      if (t.ver > floor) keep_tombs.push_back(t);

    std::vector<std::unique_ptr<RunCursor>> cursors;
    std::priority_queue<HeapItem> heap;
    for (size_t i = 0; i < runs.size(); i++) {
      cursors.push_back(std::make_unique<RunCursor>(runs[i].get()));
      Rec r;
      if (cursors[i]->next(&r)) heap.push({std::move(r), i});
    }

    RunWriter w;
    char name[64];
    snprintf(name, sizeof name, "%06lld.sst", (long long)next_file);
    if (!w.open(dir, name)) {
      err = w.err;
      return false;
    }

    // sweep state over begin-sorted all_tombs
    size_t tpos = 0;
    std::vector<const Tomb*> active;  // tombs with begin <= key, end > key

    std::string cur_key;
    std::vector<Rec> cur;  // all records for cur_key, ver ascending-ish

    auto emit_key = [&]() -> bool {
      if (cur.empty()) return true;
      // advance tombstone sweep to cur_key
      while (tpos < all_tombs.size() && all_tombs[tpos].begin <= cur_key) {
        active.push_back(&all_tombs[tpos]);
        tpos++;
      }
      i64 win_ver = kVerNegInf;
      bool win_set = false;
      const Rec* win_rec = nullptr;
      for (auto* t : active)
        if (t->end > cur_key && t->ver <= floor && t->ver > win_ver) {
          win_ver = t->ver;
          win_set = false;
          win_rec = nullptr;
        }
      // stable: equal-version records keep their apply order, so the
      // LAST one at the winning version is authoritative (the same
      // tie-break consider() applies on reads)
      std::stable_sort(cur.begin(), cur.end(),
                       [](const Rec& a, const Rec& b) { return a.ver < b.ver; });
      for (auto& r : cur)
        if (r.ver <= floor && r.ver >= win_ver) {
          win_ver = r.ver;
          win_set = r.is_set;
          win_rec = &r;
        }
      // floor winner (if it is a live set) then everything above floor
      if (win_rec && win_set) {
        Rec fr = *win_rec;
        fr.ver = win_ver;
        if (!w.add(fr)) {
          err = w.err;
          return false;
        }
      }
      for (auto& r : cur)
        if (r.ver > floor)
          if (!w.add(r)) {
            err = w.err;
            return false;
          }
      cur.clear();
      return true;
    };

    while (!heap.empty()) {
      HeapItem it = heap.top();
      heap.pop();
      Rec nxt;
      if (cursors[it.src]->next(&nxt)) heap.push({std::move(nxt), it.src});
      if (it.rec.key != cur_key) {
        if (!emit_key()) return false;
        cur_key = it.rec.key;
      }
      cur.push_back(std::move(it.rec));
    }
    if (!emit_key()) return false;

    std::sort(keep_tombs.begin(), keep_tombs.end(),
              [](const Tomb& a, const Tomb& b) { return a.begin < b.begin; });
    if (!w.finish(keep_tombs)) {
      err = w.err;
      return false;
    }
    auto merged = open_run(w.path, &err);
    if (!merged) return false;
    std::vector<std::string> old_paths;
    for (auto& r : runs) old_paths.push_back(r->path);
    runs.clear();
    runs.push_back(std::move(merged));
    next_file++;
    if (!write_manifest()) return false;
    for (auto& p : old_paths) ::unlink(p.c_str());
    return true;
  }

  // -- range scan ------------------------------------------------------
  //
  // Merged at-version scan: k-way heap across runs + memtable points,
  // with tombstone shadowing. Used by snapshot/fetchKeys/backup.
  // An EMPTY `end` means unbounded (scan to the last key).

  i64 range(const std::string& begin, const std::string& end, i64 v,
            i64 max_items, std::string* out) {
    struct Src {
      std::unique_ptr<RunCursor> cur;
      Rec rec;
      bool alive;
    };
    std::vector<Src> srcs;
    for (auto& r : runs) {
      if (r->f.n_rec == 0) continue;
      Src s;
      s.cur = std::make_unique<RunCursor>(r.get());
      s.cur->seek_block(begin);
      s.alive = false;
      Rec rec;
      while (s.cur->next(&rec)) {
        if (rec.key >= begin) {
          s.rec = std::move(rec);
          s.alive = true;
          break;
        }
      }
      if (s.alive) srcs.push_back(std::move(s));
    }
    auto mit = mem.points.lower_bound(begin);

    // all tombstones (memtable + runs), considered per key
    std::vector<const Tomb*> tombs;
    for (auto& t : mem.clears) tombs.push_back(&t);
    for (auto& r : runs)
      for (auto& t : r->tombs) tombs.push_back(&t);

    i64 count = 0;
    while (count < max_items) {
      // next key = min over sources
      const std::string* k = nullptr;
      for (auto& s : srcs)
        if (s.alive && (!k || s.rec.key < *k)) k = &s.rec.key;
      if (mit != mem.points.end() && (end.empty() || mit->first < end) &&
          (!k || mit->first < *k))
        k = &mit->first;
      if (!k || (!end.empty() && *k >= end)) break;
      std::string key = *k;

      i64 best_ver = kVerNegInf;
      bool best_set = false;
      std::string best_val;
      for (auto& s : srcs) {
        while (s.alive && s.rec.key == key) {
          consider(s.rec.ver, s.rec.is_set, &s.rec.val, &best_ver, &best_set,
                   &best_val, v);
          Rec rec;
          s.alive = s.cur->next(&rec);
          if (s.alive) s.rec = std::move(rec);
        }
      }
      if (mit != mem.points.end() && mit->first == key) {
        for (auto& [ver, val] : mit->second)
          consider(ver, val.has_value(), val ? &*val : nullptr, &best_ver,
                   &best_set, &best_val, v);
        ++mit;
      }
      for (auto* t : tombs)
        if (t->begin <= key && key < t->end)
          consider(t->ver, false, nullptr, &best_ver, &best_set, &best_val, v,
                   /*point_rec=*/false);

      if (best_ver != kVerNegInf && best_set) {
        put_u32(*out, (u32)key.size());
        *out += key;
        put_u32(*out, (u32)best_val.size());
        *out += best_val;
        count++;
      }
    }
    return count;
  }
};

}  // namespace

// ---- C ABI -----------------------------------------------------------------

extern "C" {

void* vlsm_open(const char* dir, long long window) {
  auto* s = new Store();
  s->dir = dir;
  s->window = window;
  ::mkdir(dir, 0755);
  if (!s->load_manifest()) {
    // leave the store constructed so last_error is readable; callers
    // must check vlsm_ok before use
    s->runs.clear();
    s->applied = -1;
    return s;
  }
  return s;
}

int vlsm_ok(void* h) { return ((Store*)h)->applied >= 0; }

void vlsm_close(void* h) { delete (Store*)h; }

long long vlsm_durable_version(void* h) { return ((Store*)h)->durable; }

long long vlsm_applied_version(void* h) { return ((Store*)h)->applied; }

long long vlsm_mem_bytes(void* h) { return ((Store*)h)->mem.bytes; }

int vlsm_num_runs(void* h) { return (int)((Store*)h)->runs.size(); }

int vlsm_last_error(void* h, char* buf, int cap) {
  auto& e = ((Store*)h)->err;
  int n = (int)std::min<size_t>(e.size(), cap > 0 ? cap - 1 : 0);
  memcpy(buf, e.data(), n);
  if (cap > 0) buf[n] = 0;
  return n;
}

// blob: n i32, then per mutation:
//   op u8 (0 set, 1 clear_range) | klen i32 | key |
//   (set: vlen i32 | value) (clear: elen i32 | end)
int vlsm_apply(void* h, long long version, const unsigned char* blob,
               long long len) {
  Store* s = (Store*)h;
  if (len < 4) return -1;
  int32_t n;
  memcpy(&n, blob, 4);
  i64 p = 4;
  for (int i = 0; i < n; i++) {
    if (p + 5 > len) return -1;
    uint8_t op = blob[p];
    p += 1;
    int32_t kl;
    memcpy(&kl, blob + p, 4);
    p += 4;
    if (p + kl + 4 > len) return -1;
    std::string key((const char*)blob + p, kl);
    p += kl;
    int32_t sl;
    memcpy(&sl, blob + p, 4);
    p += 4;
    if (p + sl > len) return -1;
    std::string second((const char*)blob + p, sl);
    p += sl;
    if (op == 0)
      s->mem.set(key, version, second);
    else
      s->mem.clear_range(key, second, version);
  }
  s->applied = std::max(s->applied, (i64)version);
  return 0;
}

long long vlsm_get(void* h, const unsigned char* key, int klen,
                   long long version, unsigned char* out, long long cap) {
  Store* s = (Store*)h;
  std::string val;
  if (!s->get(std::string((const char*)key, klen), version, &val)) return -1;
  if ((i64)val.size() > cap) return -2 - (i64)val.size();
  memcpy(out, val.data(), val.size());
  return (i64)val.size();
}

long long vlsm_flush(void* h) {
  Store* s = (Store*)h;
  if (!s->flush()) return -1;
  return s->durable;
}

int vlsm_compact(void* h) { return ((Store*)h)->compact() ? 0 : -1; }

void vlsm_set_floor(void* h, long long floor) {
  Store* s = (Store*)h;
  s->floor = std::max(s->floor, (i64)floor);
}

long long vlsm_floor(void* h) { return ((Store*)h)->floor; }

// range scan at `version`; out receives [klen|key|vlen|value]*; returns
// item count, and *bytes gets the packed length. cap is the out buffer
// capacity; if the packed data would exceed it, returns -1 with *bytes
// holding a sufficient size (caller retries with a bigger buffer).
long long vlsm_range(void* h, const unsigned char* begin, int blen,
                     const unsigned char* end, int elen, long long version,
                     long long max_items, unsigned char* out, long long cap,
                     long long* bytes) {
  Store* s = (Store*)h;
  std::string packed;
  i64 n = s->range(std::string((const char*)begin, blen),
                   std::string((const char*)end, elen), version, max_items,
                   &packed);
  *bytes = (i64)packed.size();
  if ((i64)packed.size() > cap) return -1;
  memcpy(out, packed.data(), packed.size());
  return n;
}

}  // extern "C"
