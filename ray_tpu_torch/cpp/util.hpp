// C++ util substrate shared by the native components (the N18 analog of
// the reference's src/ray/util/ — structured event log event.h/.cc,
// exponential_backoff.h, throttler.h, counter_map.h; same roles, sized
// to what the in-tree daemons actually use).
//
// Header-only on purpose: the native components build as single
// translation units through native_build.py's content-hash cache, and a
// separate .so would complicate that for zero benefit at this size.
#pragma once

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <ctime>
#include <mutex>
#include <string>
#include <unordered_map>

namespace rt_util {

// ---------------------------------------------------------------------
// Structured NDJSON event log (reference: util/event.h RayEvent — one
// JSON object per line with severity, timestamp, label and kv fields).
// Destination: $RT_EVENT_LOG file when set, else stderr. Thread-safe.
// ---------------------------------------------------------------------
class StructuredLog {
 public:
  static StructuredLog &Instance() {
    static StructuredLog inst;
    return inst;
  }

  // Emit {"ts":..., "severity":..., "label":..., <fields>}. `fields`
  // is a pre-rendered JSON fragment like "\"id\":\"ab\",\"bytes\":5"
  // (callers own their escaping; labels/severities are code constants).
  void Emit(const char *severity, const char *label,
            const std::string &fields) {
    std::lock_guard<std::mutex> lk(mu_);
    if (!out_) return;
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    fprintf(out_, "{\"ts\":%lld.%03ld,\"severity\":\"%s\",\"label\":\"%s\"%s%s}\n",
            (long long)ts.tv_sec, ts.tv_nsec / 1000000, severity, label,
            fields.empty() ? "" : ",", fields.c_str());
    fflush(out_);
  }

 private:
  StructuredLog() {
    const char *path = getenv("RT_EVENT_LOG");
    out_ = path && *path ? fopen(path, "a") : stderr;
    if (!out_) out_ = stderr;
  }
  std::mutex mu_;
  FILE *out_;
};

inline void Event(const char *severity, const char *label,
                  const std::string &fields = "") {
  StructuredLog::Instance().Emit(severity, label, fields);
}

// JSON string escaping for UNTRUSTED values (paths, ids) interpolated
// into event fields — callers of Event() own their escaping.
inline std::string JsonEscape(const std::string &in) {
  std::string out;
  out.reserve(in.size() + 8);
  for (unsigned char c : in) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof(buf), "\\u%04x", c);
          out += buf;
        } else {
          out += (char)c;
        }
    }
  }
  return out;
}

// ---------------------------------------------------------------------
// Deterministic exponential backoff (reference: util/exponential_backoff.h
// — same multiplier/cap contract, no jitter: callers that want jitter
// add it, and deterministic delays keep tests exact).
// ---------------------------------------------------------------------
class ExponentialBackoff {
 public:
  ExponentialBackoff(uint64_t initial_ms, double multiplier, uint64_t max_ms)
      : initial_ms_(initial_ms), multiplier_(multiplier), max_ms_(max_ms),
        current_ms_(initial_ms) {}

  uint64_t Next() {
    uint64_t v = current_ms_;
    double n = (double)current_ms_ * multiplier_;
    current_ms_ = n > (double)max_ms_ ? max_ms_ : (uint64_t)n;
    return v;
  }

  void Reset() { current_ms_ = initial_ms_; }
  uint64_t Current() const { return current_ms_; }

 private:
  uint64_t initial_ms_;
  double multiplier_;
  uint64_t max_ms_;
  uint64_t current_ms_;
};

// ---------------------------------------------------------------------
// Event-rate throttler (reference: util/throttler.h): AbleToRun() is
// true at most once per period. Used so pressure paths (spill/evict
// storms) log a bounded number of lines, not one per object.
// ---------------------------------------------------------------------
class Throttler {
 public:
  explicit Throttler(uint64_t period_ms) : period_ms_(period_ms) {}

  bool AbleToRun() {
    uint64_t now = NowMs();
    std::lock_guard<std::mutex> lk(mu_);
    if (now - last_run_ms_ >= period_ms_) {
      last_run_ms_ = now;
      return true;
    }
    return false;
  }

  static uint64_t NowMs() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (uint64_t)ts.tv_sec * 1000 + (uint64_t)(ts.tv_nsec / 1000000);
  }

 private:
  uint64_t period_ms_;
  uint64_t last_run_ms_ = 0;
  std::mutex mu_;
};

// ---------------------------------------------------------------------
// Counter map (reference: util/counter_map.h): named monotonic counters
// a daemon can dump as one structured event (e.g. at shutdown).
// ---------------------------------------------------------------------
class CounterMap {
 public:
  void Inc(const std::string &key, uint64_t by = 1) {
    std::lock_guard<std::mutex> lk(mu_);
    counts_[key] += by;
  }

  std::string ToJsonFields() const {
    std::lock_guard<std::mutex> lk(mu_);
    std::string out;
    for (auto &kv : counts_) {
      if (!out.empty()) out += ",";
      out += "\"" + kv.first + "\":" + std::to_string(kv.second);
    }
    return out;
  }

 private:
  mutable std::mutex mu_;
  std::unordered_map<std::string, uint64_t> counts_;
};

}  // namespace rt_util
