// RegionTimer — nested HPC region timers (C++ core).
//
// Native replacement for GPTL (`gptl4py`, used by hydragnn/utils/tracer.py:
// 39-59 with per-rank `gp.pr_file` / `pr_summary_file` dumps): nested
// start/stop regions accumulate into a call-tree keyed by the full region
// path ("train/forward"), with count/total/min/max per node, plus an
// in-memory event ring that exports chrome://tracing JSON (the modern
// equivalent of GPTL's text timing files — loadable in perfetto).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace {

double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

struct Stat {
  uint64_t count = 0;
  double total = 0, mn = 1e300, mx = 0;
};

struct Event {
  std::string path;
  double t0, t1;
};

struct Timer {
  std::mutex mu;
  std::vector<std::pair<std::string, double>> stack;  // (name, t_start)
  std::map<std::string, Stat> stats;                  // keyed by full path
  std::vector<Event> events;
  size_t max_events = 1 << 20;
  double epoch = now_s();
};

}  // namespace

extern "C" {

void* rt_create() { return new Timer(); }
void rt_destroy(void* h) { delete static_cast<Timer*>(h); }

void rt_start(void* h, const char* name) {
  Timer* t = static_cast<Timer*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  t->stack.emplace_back(name, now_s());
}

void rt_stop(void* h, const char* name) {
  Timer* t = static_cast<Timer*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  // unwind to the matching frame (tolerates missed stops, like GPTL)
  for (size_t i = t->stack.size(); i > 0; --i) {
    if (t->stack[i - 1].first == name) {
      double t1 = now_s();
      double t0 = t->stack[i - 1].second;
      std::string path;
      for (size_t j = 0; j < i; ++j) {
        path += t->stack[j].first;
        if (j + 1 < i) path += '/';
      }
      Stat& s = t->stats[path];
      double dt = t1 - t0;
      s.count++;
      s.total += dt;
      if (dt < s.mn) s.mn = dt;
      if (dt > s.mx) s.mx = dt;
      if (t->events.size() < t->max_events)
        t->events.push_back({path, t0, t1});
      t->stack.resize(i - 1);
      return;
    }
  }
}

void rt_reset(void* h) {
  Timer* t = static_cast<Timer*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  t->stack.clear();
  t->stats.clear();
  t->events.clear();
  t->epoch = now_s();
}

// GPTL-style per-rank text summary: call-tree indented by path depth.
int rt_print(void* h, const char* filename) {
  Timer* t = static_cast<Timer*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  FILE* f = fopen(filename, "w");
  if (!f) return -1;
  fprintf(f, "%-44s %10s %14s %12s %12s %12s\n", "region", "calls",
          "total_s", "avg_ms", "min_ms", "max_ms");
  for (auto& kv : t->stats) {
    const std::string& path = kv.first;
    int depth = 0;
    for (char c : path)
      if (c == '/') depth++;
    std::string label(2 * depth, ' ');
    size_t slash = path.rfind('/');
    label += (slash == std::string::npos) ? path : path.substr(slash + 1);
    const Stat& s = kv.second;
    fprintf(f, "%-44s %10llu %14.4f %12.3f %12.3f %12.3f\n", label.c_str(),
            (unsigned long long)s.count, s.total,
            1e3 * s.total / (double)(s.count ? s.count : 1), 1e3 * s.mn,
            1e3 * s.mx);
  }
  fclose(f);
  return 0;
}

// Region names are arbitrary caller strings: escape them for JSON.
std::string json_escape(const std::string& in) {
  std::string out;
  out.reserve(in.size());
  for (unsigned char c : in) {
    if (c == '"' || c == '\\') {
      out += '\\';
      out += (char)c;
    } else if (c < 0x20) {
      char buf[8];
      snprintf(buf, sizeof(buf), "\\u%04x", c);
      out += buf;
    } else {
      out += (char)c;
    }
  }
  return out;
}

// chrome://tracing / perfetto JSON ("X" complete events).
int rt_chrome(void* h, const char* filename, int pid) {
  Timer* t = static_cast<Timer*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  FILE* f = fopen(filename, "w");
  if (!f) return -1;
  fprintf(f, "[\n");
  bool first = true;
  for (auto& e : t->events) {
    if (!first) fprintf(f, ",\n");
    first = false;
    fprintf(f,
            "{\"name\":\"%s\",\"ph\":\"X\",\"pid\":%d,\"tid\":0,"
            "\"ts\":%.3f,\"dur\":%.3f}",
            json_escape(e.path).c_str(), pid, 1e6 * (e.t0 - t->epoch),
            1e6 * (e.t1 - e.t0));
  }
  fprintf(f, "\n]\n");
  fclose(f);
  return 0;
}

// Accessors for tests / summaries.
// Newline-separated "path<TAB>total_seconds" dump of every region — the
// host-side consumer is the telemetry layer's region-totals forwarding
// (utils/tracer.py totals()). Returns bytes written, or -(bytes needed)
// when the buffer is too small so the caller can retry sized right.
int rt_totals(void* h, char* buf, int cap) {
  Timer* t = static_cast<Timer*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  std::string out;
  char line[512];
  for (auto& kv : t->stats) {
    snprintf(line, sizeof line, "%s\t%.9f\n", kv.first.c_str(),
             kv.second.total);
    out += line;
  }
  if ((int)out.size() + 1 > cap) return -(int)(out.size() + 1);
  memcpy(buf, out.c_str(), out.size() + 1);
  return (int)out.size();
}

uint64_t rt_count(void* h, const char* path) {
  Timer* t = static_cast<Timer*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  auto it = t->stats.find(path);
  return it == t->stats.end() ? 0 : it->second.count;
}

double rt_total(void* h, const char* path) {
  Timer* t = static_cast<Timer*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  auto it = t->stats.find(path);
  return it == t->stats.end() ? 0.0 : it->second.total;
}

}  // extern "C"
