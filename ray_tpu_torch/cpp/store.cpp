// Shared-memory immutable object store daemon ("plasma equivalent").
//
// The port's copy of ray_tpu/cpp/store.cpp (segments named
// /rtt_store_<pid>_<pid namespace>_*, so the two packages' stores never touch
// each other's segments, nor stores of other pid namespaces); a
// rebuild of the reference's plasma store
// (reference: src/ray/object_manager/plasma/store.h:55 — shared-memory
// immutable object store embedded in the raylet; dlmalloc arena over mmap,
// ObjectLifecycleManager + LRU EvictionPolicy, create/get queues, client
// over unix socket). Design differences, deliberate for the host path:
//
//  * One POSIX shm segment **per object** (shm_open) instead of one dlmalloc
//    arena: clients mmap exactly the object they touch, the kernel reclaims
//    a segment the moment its refcount drops to zero and it is unlinked, and
//    host buffers handed to a device copy are page-aligned by construction.
//  * Thread-per-connection unix-socket server (host object churn is a
//    control-plane rate, not a data-plane rate — data moves via mmap).
//  * LRU eviction of sealed, unreferenced objects when a create would exceed
//    the byte budget (reference: plasma/eviction_policy.h:199).
//
// Wire protocol (little-endian u32 framing), one request per message:
//   req:  [u32 len][u8 op][28B object_id][payload]
//   resp: [u32 len][u8 status][payload]
// ops: 1=CREATE(u64 size) -> shm name; 2=SEAL; 3=GET(u64 timeout_ms) ->
//      shm name+size; 4=RELEASE; 5=DELETE; 6=CONTAINS; 7=LIST; 8=STATS;
//      9=SHUTDOWN; 10=SUBSCRIBE (connection becomes a push-only event
//      stream: [u32 len][u8 event][28B id], event 1=SEALED 2=EVICTED —
//      the plasma→raylet notification socket analog, feeding the object
//      directory); 11=ABORT (drop an unsealed create, e.g. failed pull);
//      12=PIN / 13=UNPIN (long-lived reference by the raylet for primary
//      copies — pinned objects are never LRU-evicted, only spilled);
//      14=WAIT (payload: u64 timeout_ms, u32 k, u32 n, n*28B ids → reply
//      u32 m + m*28B ids that are present, blocking until >=k or timeout —
//      the native replacement for client-side contains() busy-polling).
// status: 0=OK 1=NOT_FOUND 2=EXISTS 3=FULL 4=TIMEOUT 5=ERR 6=EVICTED
//
// Spilling (reference: raylet/local_object_manager.cc spill/restore +
// external_storage.py — here implemented natively inside the daemon):
// under memory pressure, unreferenced sealed objects are LRU-EVICTED
// (recoverable via lineage); referenced/pinned sealed objects are SPILLED
// to <spill_dir> and transparently restored into fresh shm on the next
// Get. argv: <socket> <capacity> [spill_dir] — no spill_dir disables
// spilling (pressure then fails creates with FULL, as before).
//
// Build: g++ -O2 -std=c++17 -pthread -o ray_tpu_torch_store store.cpp -lrt

#include <fcntl.h>
#include <signal.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/un.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <list>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "util.hpp"  // structured events / throttling / counters (N18)

namespace {
rt_util::CounterMap g_counters;           // lifetime op counters
rt_util::Throttler g_pressure_log(1000);  // >=1s between pressure events
}  // namespace

namespace {

constexpr uint8_t OP_CREATE = 1, OP_SEAL = 2, OP_GET = 3, OP_RELEASE = 4,
                  OP_DELETE = 5, OP_CONTAINS = 6, OP_LIST = 7, OP_STATS = 8,
                  OP_SHUTDOWN = 9, OP_SUBSCRIBE = 10, OP_ABORT = 11,
                  OP_PIN = 12, OP_UNPIN = 13, OP_WAIT = 14;
constexpr uint8_t ST_OK = 0, ST_NOT_FOUND = 1, ST_EXISTS = 2, ST_FULL = 3,
                  ST_TIMEOUT = 4, ST_ERR = 5, ST_EVICTED = 6;
constexpr uint8_t EV_SEALED = 1, EV_EVICTED = 2;
constexpr size_t ID_SIZE = 28;

bool WriteExact(int fd, const void *buf, size_t n);
bool ReadExact(int fd, void *buf, size_t n);

// "/rtt_store_<pid>_<pid namespace inode>_": the stale-segment sweep
// (object_store.py) judges a segment only by a pid of its own namespace, so
// a store in another pid namespace that shares /dev/shm keeps its segments.
const std::string &SegmentPrefix() {
  static const std::string prefix = [] {
    char link[64] = {0};
    ssize_t n = readlink("/proc/self/ns/pid", link, sizeof(link) - 1);
    std::string ns = "0";
    if (n > 0) {
      std::string s(link, (size_t)n);  // "pid:[4026531836]"
      size_t a = s.find('['), b = s.find(']');
      if (a != std::string::npos && b != std::string::npos && b > a + 1)
        ns = s.substr(a + 1, b - a - 1);
    }
    return "/rtt_store_" + std::to_string(getpid()) + "_" + ns + "_";
  }();
  return prefix;
}

struct ObjectEntry {
  std::string shm_name;
  uint64_t size = 0;
  bool sealed = false;
  int64_t refcount = 0;  // client references; creator holds one until seal
  uint64_t lru_tick = 0;
  bool spilled = false;      // bytes live in spill_path, not in shm
  std::string spill_path;
};

class Store {
 public:
  Store(uint64_t capacity, std::string spill_dir, uint64_t min_spill)
      : capacity_(capacity), spill_dir_(std::move(spill_dir)),
        min_spill_(min_spill) {}

  uint8_t Create(const std::string &id, uint64_t size, std::string *shm_name) {
    std::unique_lock<std::mutex> lk(mu_);
    if (closing_) return ST_ERR;  // shutting down: no new segments may appear
    if (objects_.count(id)) return ST_EXISTS;
    tombstones_.erase(id);  // reconstruction recreates an evicted object
    if (!EnsureCapacityLocked(size)) return ST_FULL;
    std::string name = SegmentPrefix() + Hex(id.substr(0, 8)) + "_" +
                       std::to_string(seq_++);
    int fd = shm_open(name.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
    if (fd < 0) return ST_ERR;
    if (ftruncate(fd, (off_t)size) != 0) {
      close(fd);
      shm_unlink(name.c_str());
      return ST_FULL;
    }
    close(fd);
    ObjectEntry e;
    e.shm_name = name;
    e.size = size;
    e.refcount = 1;  // creator's reference until Seal
    objects_[id] = e;
    used_ += size;
    *shm_name = name;
    return ST_OK;
  }

  // Abort an unsealed create (creator died before seal): remove without
  // tombstoning so a retry's create() succeeds cleanly.
  void Abort(const std::string &id) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = objects_.find(id);
    if (it == objects_.end() || it->second.sealed) return;
    shm_unlink(it->second.shm_name.c_str());
    used_ -= it->second.size;
    objects_.erase(it);
  }

  // pin=true converts the creator's reference into a long-lived pin
  // ATOMICALLY with the seal — primary copies must never be evictable in
  // the window before the raylet's async pin would land.
  uint8_t Seal(const std::string &id, bool pin) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = objects_.find(id);
    if (it == objects_.end()) return ST_NOT_FOUND;
    it->second.sealed = true;
    if (!pin) it->second.refcount--;  // drop creator ref; LRU-evictable at 0
    it->second.lru_tick = tick_++;
    PushEventLocked(EV_SEALED, id);
    sealed_cv_.notify_all();
    return ST_OK;
  }

  uint8_t Get(const std::string &id, uint64_t timeout_ms, std::string *shm_name,
              uint64_t *size) {
    std::unique_lock<std::mutex> lk(mu_);
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms);
    for (;;) {
      auto it = objects_.find(id);
      if (it != objects_.end() && it->second.sealed) {
        if (it->second.spilled && !RestoreLocked(id, it->second)) return ST_ERR;
        it->second.refcount++;
        it->second.lru_tick = tick_++;
        *shm_name = it->second.shm_name;
        *size = it->second.size;
        return ST_OK;
      }
      // Evicted objects report distinctly so owners can trigger lineage
      // reconstruction (reference: ObjectRecoveryManager,
      // core_worker/object_recovery_manager.h:41).
      if (it == objects_.end() && tombstones_.count(id)) return ST_EVICTED;
      if (timeout_ms == 0) return ST_NOT_FOUND;
      if (sealed_cv_.wait_until(lk, deadline) == std::cv_status::timeout)
        return ST_TIMEOUT;
    }
  }

  uint8_t Release(const std::string &id) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = objects_.find(id);
    if (it == objects_.end()) return ST_NOT_FOUND;
    if (it->second.refcount > 0) it->second.refcount--;
    return ST_OK;
  }

  // Long-lived reference for primary copies (raylet-held); pinned objects
  // are never LRU-evicted — under pressure they spill instead.
  uint8_t Pin(const std::string &id) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = objects_.find(id);
    if (it == objects_.end() || !it->second.sealed) return ST_NOT_FOUND;
    it->second.refcount++;
    return ST_OK;
  }

  uint8_t Unpin(const std::string &id) { return Release(id); }

  // Block until >= k of `ids` are present (sealed, in memory or spilled)
  // or the deadline passes; returns the present subset. The seal cv wakes
  // every waiter, so one daemon serves many concurrent wait() calls
  // without any client-side polling.
  std::vector<std::string> WaitAny(const std::vector<std::string> &ids,
                                   size_t k, uint64_t timeout_ms) {
    std::unique_lock<std::mutex> lk(mu_);
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms);
    bool timed_out = false;
    for (;;) {
      std::vector<std::string> present;
      for (const auto &id : ids) {
        auto it = objects_.find(id);
        if (it != objects_.end() && it->second.sealed) present.push_back(id);
      }
      if (present.size() >= k || timeout_ms == 0 || timed_out) return present;
      timed_out =
          sealed_cv_.wait_until(lk, deadline) == std::cv_status::timeout;
    }
  }

  uint8_t Delete(const std::string &id) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = objects_.find(id);
    if (it == objects_.end()) {
      // Delete is idempotent AND final even for ids never created here:
      // tombstoning unknown ids lets sweepers retire object ids whose
      // producer died before sealing (KV-handoff leak sweep), and the
      // wakeup below bounces any getter blocked on that id immediately
      // (ST_EVICTED) instead of letting it sleep out its full timeout.
      tombstones_.insert(id);
      sealed_cv_.notify_all();
      return ST_NOT_FOUND;
    }
    // Unlink now; clients holding an mmap keep their pages until they unmap.
    if (it->second.spilled) {
      unlink(it->second.spill_path.c_str());
    } else {
      shm_unlink(it->second.shm_name.c_str());
      used_ -= it->second.size;
    }
    objects_.erase(it);
    tombstones_.insert(id);
    PushEventLocked(EV_EVICTED, id);
    // Wake blocked getters so a get racing this delete surfaces
    // ST_EVICTED promptly rather than hanging until its deadline.
    sealed_cv_.notify_all();
    return ST_OK;
  }

  uint8_t Contains(const std::string &id) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = objects_.find(id);
    if (it != objects_.end() && it->second.sealed) return ST_OK;
    if (it == objects_.end() && tombstones_.count(id)) return ST_EVICTED;
    return ST_NOT_FOUND;
  }

  std::vector<std::string> List() {
    std::unique_lock<std::mutex> lk(mu_);
    std::vector<std::string> out;
    for (auto &kv : objects_)
      if (kv.second.sealed) out.push_back(kv.first);
    return out;
  }

  void Stats(uint64_t *used, uint64_t *capacity, uint64_t *count) {
    std::unique_lock<std::mutex> lk(mu_);
    *used = used_;
    *capacity = capacity_;
    *count = objects_.size();
  }

  // Final cleanup: gate new creates first, then unlink every segment. A
  // create in flight when we take mu_ has already inserted its entry, so
  // it gets unlinked here; creates arriving after see closing_ and fail.
  void UnlinkAll() {
    std::unique_lock<std::mutex> lk(mu_);
    closing_ = true;
    for (auto &kv : objects_) {
      if (kv.second.spilled)
        unlink(kv.second.spill_path.c_str());
      else
        shm_unlink(kv.second.shm_name.c_str());
    }
    objects_.clear();
    used_ = 0;
  }

  // -- event notification stream (plasma notification socket analog) --

  // Registers the fd and sends the subscribe ACK under subs_mu_, so the
  // ACK is ordered before any event the notifier writes to this fd and no
  // seal after the client observes the ACK can be missed.
  void Subscribe(int fd) {
    std::unique_lock<std::mutex> lk(subs_mu_);
    uint32_t len = 1;
    std::string msg;
    msg.append((char *)&len, 4);
    msg.push_back((char)0 /* ST_OK */);
    WriteExact(fd, msg.data(), msg.size());
    sub_fds_.push_back(fd);
  }

  void StartNotifier() {
    notifier_ = std::thread([this] { NotifierLoop(); });
  }

  void StopNotifier() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stopping_ = true;
      events_cv_.notify_all();
    }
    if (notifier_.joinable()) notifier_.join();
    std::unique_lock<std::mutex> lk(subs_mu_);
    for (int fd : sub_fds_) close(fd);
    sub_fds_.clear();
  }

 private:
  // Caller holds mu_. Events drain on a dedicated thread so a slow
  // subscriber never blocks store operations.
  void PushEventLocked(uint8_t ev, const std::string &id) {
    std::string frame;
    uint32_t len = 1 + (uint32_t)ID_SIZE;
    frame.append((char *)&len, 4);
    frame.push_back((char)ev);
    frame.append(id);
    events_.push_back(std::move(frame));
    events_cv_.notify_one();
  }

  void NotifierLoop() {
    for (;;) {
      std::deque<std::string> batch;
      {
        std::unique_lock<std::mutex> lk(mu_);
        events_cv_.wait(lk, [&] { return !events_.empty() || stopping_; });
        if (stopping_ && events_.empty()) return;
        batch.swap(events_);
      }
      std::unique_lock<std::mutex> slk(subs_mu_);
      for (auto it = sub_fds_.begin(); it != sub_fds_.end();) {
        bool ok = true;
        for (auto &f : batch) {
          if (!WriteExact(*it, f.data(), f.size())) {
            ok = false;
            break;
          }
        }
        if (!ok) {
          close(*it);
          it = sub_fds_.erase(it);
        } else {
          ++it;
        }
      }
    }
  }

  // Make room for `needed` bytes. Caller holds mu_. Policy (reference:
  // eviction_policy.h LRU + local_object_manager.cc spill): first LRU-EVICT
  // sealed, unreferenced, in-memory objects (recoverable via lineage or
  // other copies); then SPILL referenced/pinned sealed objects to disk
  // (restored on Get, never lost). IO runs under mu_ — a deliberate v1
  // simplification; object churn is control-plane rate here.
  bool EnsureCapacityLocked(uint64_t needed) {
    while (used_ + needed > capacity_) {
      std::string victim;
      uint64_t best_tick = UINT64_MAX;
      for (auto &kv : objects_) {
        if (kv.second.sealed && !kv.second.spilled && kv.second.refcount == 0 &&
            kv.second.size > 0 && kv.second.lru_tick < best_tick) {
          best_tick = kv.second.lru_tick;
          victim = kv.first;
        }
      }
      if (!victim.empty()) {
        auto it = objects_.find(victim);
        shm_unlink(it->second.shm_name.c_str());
        used_ -= it->second.size;
        objects_.erase(it);
        tombstones_.insert(victim);
        PushEventLocked(EV_EVICTED, victim);
        // getters blocked on the victim learn ST_EVICTED now, not at
        // their deadline (same contract as Delete)
        sealed_cv_.notify_all();
        g_counters.Inc("objects_evicted");
        if (g_pressure_log.AbleToRun()) {
          rt_util::Event("INFO", "store_lru_eviction",
                         "\"used_bytes\":" + std::to_string(used_));
        }
        continue;
      }
      if (spill_dir_.empty()) return false;
      // no evictable object: spill referenced in-memory objects, LRU
      // first, as a BATCH of at least min_spill_ bytes per pass so disk
      // IO is amortized (reference: local_object_manager.cc spills in
      // >= min_spilling_size batches)
      std::vector<std::pair<uint64_t, std::string>> order;
      for (auto &kv : objects_) {
        if (kv.second.sealed && !kv.second.spilled && kv.second.size > 0)
          order.emplace_back(kv.second.lru_tick, kv.first);
      }
      if (order.empty()) return false;
      std::sort(order.begin(), order.end());
      uint64_t want = needed > min_spill_ ? needed : min_spill_;
      uint64_t freed = 0;
      bool any = false;
      for (auto &tick_id : order) {
        if (freed >= want) break;
        ObjectEntry &e = objects_[tick_id.second];
        uint64_t sz = e.size;
        if (SpillLocked(tick_id.second, e)) {
          freed += sz;
          any = true;
        }
      }
      if (!any) return false;
    }
    return true;
  }

  bool SpillLocked(const std::string &id, ObjectEntry &e) {
    std::string path = spill_dir_ + "/" + Hex(id);
    int sfd = shm_open(e.shm_name.c_str(), O_RDONLY, 0600);
    if (sfd < 0) return false;
    void *src = nullptr;
    if (e.size > 0) {
      src = mmap(nullptr, e.size, PROT_READ, MAP_SHARED, sfd, 0);
      close(sfd);
      if (src == MAP_FAILED) return false;
    } else {
      close(sfd);
    }
    int out = open(path.c_str(), O_CREAT | O_TRUNC | O_WRONLY, 0600);
    if (out < 0) {
      if (src) munmap(src, e.size);
      return false;
    }
    bool ok = e.size == 0 || WriteExact(out, src, e.size);
    close(out);
    if (src) munmap(src, e.size);
    if (!ok) {
      unlink(path.c_str());
      return false;
    }
    shm_unlink(e.shm_name.c_str());
    e.spilled = true;
    e.spill_path = path;
    used_ -= e.size;
    g_counters.Inc("objects_spilled");
    g_counters.Inc("bytes_spilled", e.size);
    if (g_pressure_log.AbleToRun()) {
      rt_util::Event("INFO", "store_spill",
                     "\"bytes\":" + std::to_string(e.size) +
                     ",\"used_bytes\":" + std::to_string(used_));
    }
    return true;
  }

  bool RestoreLocked(const std::string &id, ObjectEntry &e) {
    if (closing_) return false;  // no new segments after UnlinkAll
    if (!EnsureCapacityLocked(e.size)) return false;
    std::string name = SegmentPrefix() + Hex(id.substr(0, 8)) + "_" +
                       std::to_string(seq_++);
    int fd = shm_open(name.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
    if (fd < 0) return false;
    if (ftruncate(fd, (off_t)e.size) != 0) {
      close(fd);
      shm_unlink(name.c_str());
      return false;
    }
    bool ok = true;
    if (e.size > 0) {
      void *dst = mmap(nullptr, e.size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
      close(fd);
      if (dst == MAP_FAILED) {
        shm_unlink(name.c_str());
        return false;
      }
      int in = open(e.spill_path.c_str(), O_RDONLY);
      ok = in >= 0 && ReadExact(in, dst, e.size);
      if (in >= 0) close(in);
      munmap(dst, e.size);
    } else {
      close(fd);
    }
    if (!ok) {
      shm_unlink(name.c_str());
      return false;
    }
    unlink(e.spill_path.c_str());
    e.shm_name = name;
    e.spilled = false;
    e.spill_path.clear();
    used_ += e.size;
    g_counters.Inc("objects_restored");
    return true;
  }

  static std::string Hex(const std::string &raw) {
    static const char *d = "0123456789abcdef";
    std::string out;
    for (unsigned char c : raw) {
      out.push_back(d[c >> 4]);
      out.push_back(d[c & 15]);
    }
    return out;
  }

  std::mutex mu_;
  std::condition_variable sealed_cv_;
  std::unordered_map<std::string, ObjectEntry> objects_;
  std::unordered_set<std::string> tombstones_;
  uint64_t capacity_;
  std::string spill_dir_;
  uint64_t min_spill_ = 0;  // batch floor per spill pass (config
                            // min_spilling_size)
  uint64_t used_ = 0;
  uint64_t tick_ = 0;
  uint64_t seq_ = 0;
  bool closing_ = false;
  // notification stream state
  std::mutex subs_mu_;
  std::vector<int> sub_fds_;
  std::deque<std::string> events_;
  std::condition_variable events_cv_;
  bool stopping_ = false;
  std::thread notifier_;
};

bool ReadExact(int fd, void *buf, size_t n) {
  char *p = (char *)buf;
  while (n > 0) {
    ssize_t r = read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

bool WriteExact(int fd, const void *buf, size_t n) {
  const char *p = (const char *)buf;
  while (n > 0) {
    ssize_t r = write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

void SendResp(int fd, uint8_t status, const std::string &payload = "") {
  uint32_t len = 1 + (uint32_t)payload.size();
  std::string msg;
  msg.reserve(4 + len);
  msg.append((char *)&len, 4);
  msg.push_back((char)status);
  msg.append(payload);
  WriteExact(fd, msg.data(), msg.size());
}

std::atomic<bool> g_shutdown{false};
std::atomic<int> g_srv_fd{-1};

void ServeClient(Store *store, int fd) {
  // Objects this connection created but has not yet sealed; aborted on
  // disconnect so a crashed creator never leaves a permanently-unsealed
  // object that wedges getters (reference: plasma AbortObject on client
  // disconnect, plasma/store.cc DisconnectClient).
  std::unordered_set<std::string> unsealed;
  for (;;) {
    uint32_t len;
    if (!ReadExact(fd, &len, 4)) break;
    std::string req(len, '\0');
    if (!ReadExact(fd, &req[0], len)) break;
    if (len < 1 + ID_SIZE) {
      SendResp(fd, ST_ERR);
      continue;
    }
    uint8_t op = (uint8_t)req[0];
    std::string id = req.substr(1, ID_SIZE);
    const char *payload = req.data() + 1 + ID_SIZE;
    size_t payload_len = len - 1 - ID_SIZE;

    switch (op) {
      case OP_CREATE: {
        if (payload_len < 8) {
          SendResp(fd, ST_ERR);
          break;
        }
        uint64_t size;
        memcpy(&size, payload, 8);
        std::string name;
        uint8_t st = store->Create(id, size, &name);
        if (st == ST_OK) unsealed.insert(id);
        SendResp(fd, st, st == ST_OK ? name : "");
        break;
      }
      case OP_SEAL: {
        bool pin = payload_len >= 1 && payload[0] != 0;
        uint8_t st = store->Seal(id, pin);
        if (st == ST_OK) unsealed.erase(id);
        SendResp(fd, st);
        break;
      }
      case OP_GET: {
        uint64_t timeout_ms = 0;
        if (payload_len >= 8) memcpy(&timeout_ms, payload, 8);
        std::string name;
        uint64_t size = 0;
        uint8_t st = store->Get(id, timeout_ms, &name, &size);
        if (st == ST_OK) {
          std::string out((char *)&size, 8);
          out += name;
          SendResp(fd, st, out);
        } else {
          SendResp(fd, st);
        }
        break;
      }
      case OP_RELEASE:
        SendResp(fd, store->Release(id));
        break;
      case OP_DELETE:
        SendResp(fd, store->Delete(id));
        break;
      case OP_CONTAINS:
        SendResp(fd, store->Contains(id));
        break;
      case OP_LIST: {
        auto ids = store->List();
        std::string out;
        uint32_t n = (uint32_t)ids.size();
        out.append((char *)&n, 4);
        for (auto &s : ids) out += s;
        SendResp(fd, ST_OK, out);
        break;
      }
      case OP_STATS: {
        uint64_t used, cap, count;
        store->Stats(&used, &cap, &count);
        std::string out;
        out.append((char *)&used, 8);
        out.append((char *)&cap, 8);
        out.append((char *)&count, 8);
        SendResp(fd, ST_OK, out);
        break;
      }
      case OP_ABORT:
        store->Abort(id);
        unsealed.erase(id);
        SendResp(fd, ST_OK);
        break;
      case OP_WAIT: {
        if (payload_len < 16) {
          SendResp(fd, ST_ERR);
          break;
        }
        uint64_t timeout_ms;
        uint32_t k, n;
        memcpy(&timeout_ms, payload, 8);
        memcpy(&k, payload + 8, 4);
        memcpy(&n, payload + 12, 4);
        if (payload_len < 16 + (size_t)n * ID_SIZE) {
          SendResp(fd, ST_ERR);
          break;
        }
        std::vector<std::string> ids;
        ids.reserve(n);
        for (uint32_t i = 0; i < n; i++)
          ids.emplace_back(payload + 16 + i * ID_SIZE, ID_SIZE);
        auto present = store->WaitAny(ids, k, timeout_ms);
        std::string out;
        uint32_t m = (uint32_t)present.size();
        out.append((char *)&m, 4);
        for (auto &s : present) out += s;
        SendResp(fd, ST_OK, out);
        break;
      }
      case OP_PIN:
        SendResp(fd, store->Pin(id));
        break;
      case OP_UNPIN:
        SendResp(fd, store->Unpin(id));
        break;
      case OP_SUBSCRIBE:
        // Connection becomes a push-only event stream owned by the
        // notifier thread; stop reading requests and do NOT close the fd.
        // Subscribe() acks internally, ordered against notifier writes.
        store->Subscribe(fd);
        return;
      case OP_SHUTDOWN:
        SendResp(fd, ST_OK);
        g_shutdown = true;
        // Unblock the accept() loop so the daemon can exit.
        if (g_srv_fd >= 0) shutdown(g_srv_fd.load(), SHUT_RDWR);
        close(fd);
        return;
      default:
        SendResp(fd, ST_ERR);
    }
  }
  for (const auto &id : unsealed) store->Abort(id);
  close(fd);
}

}  // namespace

Store *g_store = nullptr;
const char *g_sock_path = nullptr;

void HandleTerm(int) {
  // Async-signal-safe only: flag shutdown and wake the accept loop; the
  // main thread does the real cleanup (UnlinkAll takes a mutex, which must
  // never happen inside a signal handler).
  g_shutdown = true;
  if (g_srv_fd >= 0) shutdown(g_srv_fd.load(), SHUT_RDWR);
}

int main(int argc, char **argv) {
  if (argc < 3) {
    fprintf(stderr,
            "usage: %s <socket_path> <capacity_bytes> [spill_dir] "
            "[min_spill_bytes]\n",
            argv[0]);
    return 1;
  }
  const char *sock_path = argv[1];
  uint64_t capacity = strtoull(argv[2], nullptr, 10);
  std::string spill_dir = argc > 3 ? argv[3] : "";
  uint64_t min_spill = argc > 4 ? strtoull(argv[4], nullptr, 10) : 0;
  if (!spill_dir.empty() && mkdir(spill_dir.c_str(), 0700) != 0 &&
      errno != EEXIST) {
    rt_util::Event("WARNING", "store_spill_dir_unusable",
                   "\"dir\":\"" + rt_util::JsonEscape(spill_dir) + "\"");
    spill_dir.clear();
  }
  if (!spill_dir.empty()) {
    // per-daemon subdir: several stores may share one configured spill
    // root (e.g. every node of a local cluster) and the same object id can
    // exist in more than one store — files must never clobber across stores
    spill_dir += "/pid" + std::to_string(getpid());
    if (mkdir(spill_dir.c_str(), 0700) != 0 && errno != EEXIST) {
      rt_util::Event("WARNING", "store_spill_dir_unusable",
                     "\"dir\":\"" + rt_util::JsonEscape(spill_dir) + "\"");
      spill_dir.clear();
    }
  }
  rt_util::Event("INFO", "store_started",
                 "\"capacity_bytes\":" + std::to_string(capacity) +
                 ",\"spill\":" + (spill_dir.empty() ? "false" : "true"));
  Store store(capacity, spill_dir, min_spill);
  g_store = &store;
  g_sock_path = sock_path;
  signal(SIGTERM, HandleTerm);
  signal(SIGINT, HandleTerm);

  unlink(sock_path);
  int srv = socket(AF_UNIX, SOCK_STREAM, 0);
  if (srv < 0) {
    perror("socket");
    return 1;
  }
  sockaddr_un addr{};
  addr.sun_family = AF_UNIX;
  strncpy(addr.sun_path, sock_path, sizeof(addr.sun_path) - 1);
  if (bind(srv, (sockaddr *)&addr, sizeof(addr)) != 0) {
    perror("bind");
    return 1;
  }
  if (listen(srv, 128) != 0) {
    perror("listen");
    return 1;
  }
  g_srv_fd = srv;
  store.StartNotifier();
  // Readiness handshake: parent waits for this line.
  printf("READY\n");
  fflush(stdout);

  while (!g_shutdown) {
    int fd = accept(srv, nullptr, nullptr);
    if (fd < 0) break;
    // detach immediately: connections may be ephemeral (one per wait()
    // window) — an unbounded join-list would leak a handle per connection
    std::thread(ServeClient, &store, fd).detach();
  }
  store.StopNotifier();
  store.UnlinkAll();
  unlink(sock_path);
  rt_util::Event("INFO", "store_shutdown", g_counters.ToJsonFields());
  return 0;
}
