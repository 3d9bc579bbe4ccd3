// DistStore — distributed in-memory sample store (C++ core).
//
// TPU-native replacement for DDStore (`pyddstore`, used at
// hydragnn/utils/distdataset.py:22-183 and adiosdataset.py:507-545): the
// global sample index space is partitioned contiguously across processes;
// each process holds its partition in RAM and serves it to peers. The
// reference exposes add()/get(name, buf, offset)/epoch_begin()/epoch_end()
// over MPI one-sided windows; here the transport is plain TCP between
// TPU-VM hosts (DCN) — epoch_begin starts the serving thread, epoch_end
// drains and stops it, get() on a non-local sample fetches from the owner.
//
// Wire protocol (little-endian):
//   request:  u32 var_id | u64 global_sample_index
//   response: i64 rows | u64 nbytes | payload
//
// On-host sharing needs no RPC at all (GraphPack mmap shards cover it);
// DistStore exists for datasets larger than one host's RAM spread across
// hosts — SURVEY.md §2.4.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Var {
  std::string name;
  size_t row_bytes = 0;
  std::vector<int64_t> count;    // per LOCAL sample
  std::vector<int64_t> offset;   // prefix sum (rows)
  std::vector<uint8_t> data;     // owned copy of the local partition
};

struct Store {
  int rank = 0;
  int world = 1;
  std::vector<std::string> host;   // per-rank "ip"
  std::vector<int> port;           // per-rank port
  std::vector<int64_t> part_start; // first global sample of each rank
  std::vector<int64_t> part_count; // samples held by each rank
  std::vector<Var> vars;

  int listen_fd = -1;
  std::thread server;
  std::atomic<bool> running{false};
  // cached client connections; peer_fd[r] is only touched under peer_mu[r]
  std::vector<int> peer_fd;
  std::vector<std::unique_ptr<std::mutex>> peer_mu;
};

bool read_full(int fd, void* buf, size_t n) {
  uint8_t* p = (uint8_t*)buf;
  while (n) {
    ssize_t r = recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const uint8_t* p = (const uint8_t*)buf;
  while (n) {
    ssize_t r = send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

int owner_of(Store* s, int64_t idx) {
  for (int r = 0; r < s->world; ++r)
    if (idx >= s->part_start[r] && idx < s->part_start[r] + s->part_count[r])
      return r;
  return -1;
}

// local lookup: returns pointer into the var blob
const uint8_t* local_sample(Store* s, uint32_t vi, int64_t local_idx,
                            int64_t* rows, uint64_t* nbytes) {
  Var& v = s->vars[vi];
  *rows = v.count[local_idx];
  *nbytes = (uint64_t)(*rows) * v.row_bytes;
  return v.data.data() + (uint64_t)v.offset[local_idx] * v.row_bytes;
}

void serve_conn(Store* s, int fd) {
  for (;;) {
    // poll so shutdown (running=false) isn't blocked by an idle connection
    struct pollfd pf{fd, POLLIN, 0};
    int rc = poll(&pf, 1, 100 /*ms*/);
    if (!s->running.load()) break;
    if (rc <= 0) continue;
    uint32_t vi;
    uint64_t gidx;
    if (!read_full(fd, &vi, 4) || !read_full(fd, &gidx, 8)) break;
    if (vi >= s->vars.size()) break;
    int64_t local = (int64_t)gidx - s->part_start[s->rank];
    if (local < 0 || local >= s->part_count[s->rank]) break;
    int64_t rows;
    uint64_t nbytes;
    const uint8_t* p = local_sample(s, vi, local, &rows, &nbytes);
    if (!write_full(fd, &rows, 8) || !write_full(fd, &nbytes, 8) ||
        !write_full(fd, p, nbytes))
      break;
  }
  close(fd);
}

void server_loop(Store* s) {
  std::vector<std::thread> workers;
  while (s->running.load()) {
    struct pollfd pf{s->listen_fd, POLLIN, 0};
    int rc = poll(&pf, 1, 100 /*ms*/);
    if (rc <= 0) continue;
    int fd = accept(s->listen_fd, nullptr, nullptr);
    if (fd < 0) continue;
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    workers.emplace_back(serve_conn, s, fd);
  }
  for (auto& w : workers)
    if (w.joinable()) w.join();
}

// caller must hold peer_mu[rank]
int connect_peer(Store* s, int rank) {
  if (s->peer_fd[rank] >= 0) return s->peer_fd[rank];
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)s->port[rank]);
  inet_pton(AF_INET, s->host[rank].c_str(), &addr.sin_addr);
  // the peer's epoch_begin may lag ours: retry briefly. A TCP socket is
  // unusable after a failed connect(), so each attempt gets a fresh one.
  for (int attempt = 0; attempt < 100; ++attempt) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    if (connect(fd, (sockaddr*)&addr, sizeof(addr)) == 0) {
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      s->peer_fd[rank] = fd;
      return fd;
    }
    close(fd);
    usleep(50 * 1000);
  }
  return -1;
}

// Drop a cached peer connection after a protocol failure so the next get()
// reconnects instead of reading a desynchronized stream. Caller must hold
// peer_mu[rank].
void invalidate_peer(Store* s, int rank, int fd) {
  if (s->peer_fd[rank] == fd) s->peer_fd[rank] = -1;
  close(fd);
}

// Read and discard n bytes (keeps the stream in sync when the caller's
// buffer was too small). Returns false on socket error.
bool drain(int fd, uint64_t n) {
  uint8_t scratch[4096];
  while (n) {
    size_t chunk = n < sizeof(scratch) ? (size_t)n : sizeof(scratch);
    if (!read_full(fd, scratch, chunk)) return false;
    n -= chunk;
  }
  return true;
}

}  // namespace

extern "C" {

// hosts: "ip:port,ip:port,..." — one entry per rank.
void* dds_create(int rank, int world, const char* hosts) {
  Store* s = new Store();
  s->rank = rank;
  s->world = world;
  std::string h(hosts);
  size_t pos = 0;
  while (pos < h.size()) {
    size_t comma = h.find(',', pos);
    if (comma == std::string::npos) comma = h.size();
    std::string entry = h.substr(pos, comma - pos);
    size_t colon = entry.rfind(':');
    s->host.push_back(entry.substr(0, colon));
    s->port.push_back(atoi(entry.c_str() + colon + 1));
    pos = comma + 1;
  }
  if ((int)s->host.size() != world) {
    delete s;
    return nullptr;
  }
  s->peer_fd.assign(world, -1);
  for (int i = 0; i < world; ++i)
    s->peer_mu.emplace_back(new std::mutex());
  return s;
}

// samples_per_rank: how many samples each rank holds (contiguous partition).
int dds_set_partition(void* sp, const int64_t* samples_per_rank) {
  Store* s = static_cast<Store*>(sp);
  s->part_start.resize(s->world);
  s->part_count.assign(samples_per_rank, samples_per_rank + s->world);
  int64_t off = 0;
  for (int r = 0; r < s->world; ++r) {
    s->part_start[r] = off;
    off += s->part_count[r];
  }
  return 0;
}

// Adds the LOCAL partition of one variable; data/counts are copied in.
int dds_add_var(void* sp, const char* name, uint64_t row_bytes,
                const int64_t* counts, const void* data,
                uint64_t data_bytes) {
  Store* s = static_cast<Store*>(sp);
  Var v;
  v.name = name;
  v.row_bytes = row_bytes;
  int64_t n = s->part_count[s->rank];
  v.count.assign(counts, counts + n);
  v.offset.resize(n);
  int64_t off = 0;
  for (int64_t i = 0; i < n; ++i) {
    v.offset[i] = off;
    off += v.count[i];
  }
  if ((uint64_t)off * row_bytes != data_bytes) return -1;
  v.data.assign((const uint8_t*)data, (const uint8_t*)data + data_bytes);
  s->vars.push_back(std::move(v));
  return (int)s->vars.size() - 1;
}

int dds_epoch_begin(void* sp) {
  Store* s = static_cast<Store*>(sp);
  if (s->running.load()) return 0;
  s->listen_fd = socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) return -1;
  int one = 1;
  setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = INADDR_ANY;
  addr.sin_port = htons((uint16_t)s->port[s->rank]);
  if (bind(s->listen_fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    close(s->listen_fd);
    s->listen_fd = -1;
    return -2;
  }
  if (listen(s->listen_fd, 64) != 0) {
    close(s->listen_fd);
    s->listen_fd = -1;
    return -3;
  }
  s->running.store(true);
  s->server = std::thread(server_loop, s);
  return 0;
}

int dds_epoch_end(void* sp) {
  Store* s = static_cast<Store*>(sp);
  if (!s->running.load()) return 0;
  s->running.store(false);
  if (s->server.joinable()) s->server.join();
  close(s->listen_fd);
  s->listen_fd = -1;
  for (int r = 0; r < s->world; ++r) {
    std::lock_guard<std::mutex> lk(*s->peer_mu[r]);
    if (s->peer_fd[r] >= 0) close(s->peer_fd[r]);
    s->peer_fd[r] = -1;
  }
  return 0;
}

// Fetch sample `gidx` of var `vi` into out (capacity out_cap bytes).
// Returns rows (>=0) or negative error; *nbytes gets the payload size.
int64_t dds_get(void* sp, uint32_t vi, uint64_t gidx, void* out,
                uint64_t out_cap, uint64_t* nbytes) {
  Store* s = static_cast<Store*>(sp);
  int owner = owner_of(s, (int64_t)gidx);
  if (owner < 0 || vi >= s->vars.size()) return -1;
  if (owner == s->rank) {
    int64_t rows;
    const uint8_t* p = local_sample(
        s, vi, (int64_t)gidx - s->part_start[s->rank], &rows, nbytes);
    if (*nbytes > out_cap) return -2;
    memcpy(out, p, *nbytes);
    return rows;
  }
  // the lock spans connect -> request -> response -> (maybe) invalidate, so
  // the fd cannot be closed/reused by a concurrent get to the same owner
  std::lock_guard<std::mutex> lk(*s->peer_mu[owner]);
  int fd = connect_peer(s, owner);
  if (fd < 0) return -3;
  int64_t rows;
  if (!write_full(fd, &vi, 4) || !write_full(fd, &gidx, 8) ||
      !read_full(fd, &rows, 8) || !read_full(fd, nbytes, 8)) {
    invalidate_peer(s, owner, fd);
    return -4;
  }
  if (*nbytes > out_cap) {
    // consume the payload so the cached connection stays usable
    if (!drain(fd, *nbytes)) invalidate_peer(s, owner, fd);
    return -2;
  }
  if (!read_full(fd, out, *nbytes)) {
    invalidate_peer(s, owner, fd);
    return -4;
  }
  return rows;
}

int64_t dds_total_samples(void* sp) {
  Store* s = static_cast<Store*>(sp);
  int64_t t = 0;
  for (auto c : s->part_count) t += c;
  return t;
}

// Max payload bytes of var vi over the LOCAL partition (callers allocate
// out buffers with a host-side allgather max of this).
uint64_t dds_local_max_bytes(void* sp, uint32_t vi) {
  Store* s = static_cast<Store*>(sp);
  if (vi >= s->vars.size()) return 0;
  Var& v = s->vars[vi];
  int64_t mx = 0;
  for (auto c : v.count) mx = std::max(mx, c);
  return (uint64_t)mx * v.row_bytes;
}

void dds_destroy(void* sp) {
  Store* s = static_cast<Store*>(sp);
  dds_epoch_end(sp);
  delete s;
}

}  // extern "C"
