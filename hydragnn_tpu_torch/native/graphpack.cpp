// GraphPack — memory-mapped packed-tensor shard format (C++ core).
//
// TPU-native replacement for the reference's ADIOS2 ".bp" data plane
// (hydragnn/utils/adiosdataset.py:77-789): every variable is stored as one
// contiguous blob concatenated along its variable dimension, with per-sample
// count/offset index arrays — the same variable_count/variable_offset design
// the reference builds with MPI-collective DefineVariable/Put calls
// (adiosdataset.py:207-270), but as a flat mmap-able file per writer process.
//
// Why mmap instead of a reader stack: file-backed MAP_SHARED pages are
// shared in the host page cache, so every trainer process on a TPU-VM host
// reads the SAME physical memory — the reference's node-local SharedMemory
// mode (adiosdataset.py:458-506) falls out for free, with zero copies and no
// local-rank-0 election protocol.
//
// File layout (little-endian):
//   magic "GPK1" | u32 version | u64 num_samples | u32 num_vars
//   num_vars x var descriptor:
//     u32 name_len | name bytes
//     u32 dtype (0=f32 1=f64 2=i32 3=i64 4=u8)
//     u32 ndim | i64 dims[ndim]     (dims[0] == -1 -> variable first dim)
//     u64 index_offset              (0 if fixed-shape)
//     u64 data_offset | u64 data_bytes
//   per variable-dim var: i64 count[num_samples] | i64 offset[num_samples]
//   raw blobs (64-byte aligned)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kVersion = 1;
constexpr char kMagic[4] = {'G', 'P', 'K', '1'};
constexpr uint64_t kAlign = 64;

size_t dtype_size(uint32_t dt) {
  switch (dt) {
    case 0: return 4;   // f32
    case 1: return 8;   // f64
    case 2: return 4;   // i32
    case 3: return 8;   // i64
    case 4: return 1;   // u8
    default: return 0;
  }
}

struct VarDesc {
  std::string name;
  uint32_t dtype = 0;
  std::vector<int64_t> dims;       // dims[0] == -1 => variable first dim
  std::vector<int64_t> count;      // per-sample extent of the variable dim
  std::vector<int64_t> offset;     // prefix sum of count
  uint64_t index_offset = 0;
  uint64_t data_offset = 0;
  uint64_t data_bytes = 0;
  const void* data = nullptr;      // writer only

  bool variable() const { return !dims.empty() && dims[0] < 0; }
  size_t row_bytes() const {
    size_t b = dtype_size(dtype);
    for (size_t i = 1; i < dims.size(); ++i) b *= (size_t)dims[i];
    return b;
  }
};

struct Writer {
  std::string path;
  uint64_t num_samples = 0;
  std::vector<VarDesc> vars;
};

struct Reader {
  int fd = -1;
  uint8_t* base = nullptr;
  size_t length = 0;
  bool owned_copy = false;         // preload mode: base is malloc'd
  uint64_t num_samples = 0;
  std::vector<VarDesc> vars;
};

uint64_t align_up(uint64_t v) { return (v + kAlign - 1) / kAlign * kAlign; }

template <typename T>
void put(std::string& buf, T v) {
  buf.append(reinterpret_cast<const char*>(&v), sizeof(T));
}

template <typename T>
T take(const uint8_t*& p) {
  T v;
  memcpy(&v, p, sizeof(T));
  p += sizeof(T);
  return v;
}

}  // namespace

extern "C" {

void gpk_close(void* rp);

// ---------------- writer ----------------

void* gpk_writer_create(const char* path, uint64_t num_samples) {
  Writer* w = new Writer();
  w->path = path;
  w->num_samples = num_samples;
  return w;
}

// counts: per-sample extent along dims[0] when dims[0] < 0, else NULL.
// data: the fully concatenated blob (caller keeps it alive until finish).
int gpk_writer_add_var(void* wp, const char* name, uint32_t dtype,
                       uint32_t ndim, const int64_t* dims,
                       const int64_t* counts, const void* data,
                       uint64_t data_bytes) {
  Writer* w = static_cast<Writer*>(wp);
  if (dtype_size(dtype) == 0 || ndim == 0) return -1;
  VarDesc v;
  v.name = name;
  v.dtype = dtype;
  v.dims.assign(dims, dims + ndim);
  if (v.variable()) {
    if (!counts) return -2;
    v.count.assign(counts, counts + w->num_samples);
    v.offset.resize(w->num_samples);
    int64_t off = 0;
    for (uint64_t i = 0; i < w->num_samples; ++i) {
      v.offset[i] = off;
      off += v.count[i];
    }
    if ((uint64_t)off * v.row_bytes() != data_bytes) return -3;
  } else {
    uint64_t expect = v.row_bytes() * (uint64_t)v.dims[0] * w->num_samples;
    // fixed-shape vars store [num_samples, dims...]
    if (expect != data_bytes) return -3;
  }
  v.data = data;
  v.data_bytes = data_bytes;
  w->vars.push_back(std::move(v));
  return 0;
}

int gpk_writer_finish(void* wp) {
  Writer* w = static_cast<Writer*>(wp);
  // serialize header to compute offsets
  std::string header;
  header.append(kMagic, 4);
  put<uint32_t>(header, kVersion);
  put<uint64_t>(header, w->num_samples);
  put<uint32_t>(header, (uint32_t)w->vars.size());
  size_t desc_start = header.size();
  for (auto& v : w->vars) {
    put<uint32_t>(header, (uint32_t)v.name.size());
    header.append(v.name);
    put<uint32_t>(header, v.dtype);
    put<uint32_t>(header, (uint32_t)v.dims.size());
    for (int64_t d : v.dims) put<int64_t>(header, d);
    put<uint64_t>(header, 0);  // index_offset placeholder
    put<uint64_t>(header, 0);  // data_offset placeholder
    put<uint64_t>(header, v.data_bytes);
  }
  // index arrays follow the header
  uint64_t cursor = header.size();
  for (auto& v : w->vars) {
    if (v.variable()) {
      v.index_offset = cursor;
      cursor += 2 * sizeof(int64_t) * w->num_samples;
    }
  }
  // blobs, aligned
  for (auto& v : w->vars) {
    cursor = align_up(cursor);
    v.data_offset = cursor;
    cursor += v.data_bytes;
  }
  // patch placeholders
  size_t p = desc_start;
  for (auto& v : w->vars) {
    p += 4 + v.name.size() + 4 + 4 + 8 * v.dims.size();
    memcpy(&header[p], &v.index_offset, 8);
    memcpy(&header[p + 8], &v.data_offset, 8);
    p += 24;
  }

  FILE* f = fopen(w->path.c_str(), "wb");
  if (!f) {
    delete w;
    return -1;
  }
  int rc = 0;
  if (fwrite(header.data(), 1, header.size(), f) != header.size()) rc = -2;
  uint64_t written = header.size();
  for (auto& v : w->vars) {
    if (!v.variable()) continue;
    if (fwrite(v.count.data(), sizeof(int64_t), v.count.size(), f) !=
        v.count.size())
      rc = -2;
    if (fwrite(v.offset.data(), sizeof(int64_t), v.offset.size(), f) !=
        v.offset.size())
      rc = -2;
    written += 2 * sizeof(int64_t) * w->num_samples;
  }
  for (auto& v : w->vars) {
    uint64_t pad = align_up(written) - written;
    static const char zeros[kAlign] = {0};
    if (pad && fwrite(zeros, 1, pad, f) != pad) rc = -2;
    written += pad;
    if (fwrite(v.data, 1, v.data_bytes, f) != v.data_bytes) rc = -2;
    written += v.data_bytes;
  }
  // stdio buffering can defer a write failure (e.g. ENOSPC) to the final
  // flush — a corrupt shard must not report success and get published.
  if (fclose(f) != 0) rc = -2;
  delete w;
  return rc;
}

void gpk_writer_abort(void* wp) { delete static_cast<Writer*>(wp); }

// ---------------- reader ----------------

// preload: 0 = pure mmap (page-cache shared across host processes),
//          1 = copy whole file into private RAM (for slow/remote filesystems)
void* gpk_open(const char* path, int preload) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  size_t len = (size_t)st.st_size;
  void* base = mmap(nullptr, len, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) { close(fd); return nullptr; }

  Reader* r = new Reader();
  r->length = len;
  if (preload) {
    uint8_t* copy = (uint8_t*)malloc(len);
    if (!copy) { munmap(base, len); close(fd); delete r; return nullptr; }
    memcpy(copy, base, len);
    munmap(base, len);
    close(fd);
    r->base = copy;
    r->owned_copy = true;
    r->fd = -1;
  } else {
    madvise(base, len, MADV_WILLNEED);
    r->base = (uint8_t*)base;
    r->fd = fd;
  }

  const uint8_t* p = r->base;
  if (len < 20 || memcmp(p, kMagic, 4) != 0) { gpk_close(r); return nullptr; }
  p += 4;
  uint32_t version = take<uint32_t>(p);
  if (version != kVersion) { gpk_close(r); return nullptr; }
  r->num_samples = take<uint64_t>(p);
  uint32_t nvars = take<uint32_t>(p);
  r->vars.resize(nvars);
  for (auto& v : r->vars) {
    uint32_t nl = take<uint32_t>(p);
    v.name.assign((const char*)p, nl);
    p += nl;
    v.dtype = take<uint32_t>(p);
    uint32_t nd = take<uint32_t>(p);
    v.dims.resize(nd);
    for (auto& d : v.dims) d = take<int64_t>(p);
    v.index_offset = take<uint64_t>(p);
    v.data_offset = take<uint64_t>(p);
    v.data_bytes = take<uint64_t>(p);
  }
  return r;
}

void gpk_close(void* rp) {
  Reader* r = static_cast<Reader*>(rp);
  if (!r) return;
  if (r->owned_copy) {
    free(r->base);
  } else if (r->base) {
    munmap(r->base, r->length);
  }
  if (r->fd >= 0) close(r->fd);
  delete r;
}

uint64_t gpk_num_samples(void* rp) {
  return static_cast<Reader*>(rp)->num_samples;
}
uint32_t gpk_num_vars(void* rp) {
  return (uint32_t)static_cast<Reader*>(rp)->vars.size();
}
const char* gpk_var_name(void* rp, uint32_t i) {
  return static_cast<Reader*>(rp)->vars[i].name.c_str();
}
uint32_t gpk_var_dtype(void* rp, uint32_t i) {
  return static_cast<Reader*>(rp)->vars[i].dtype;
}
uint32_t gpk_var_ndim(void* rp, uint32_t i) {
  return (uint32_t)static_cast<Reader*>(rp)->vars[i].dims.size();
}
void gpk_var_dims(void* rp, uint32_t i, int64_t* out) {
  const auto& d = static_cast<Reader*>(rp)->vars[i].dims;
  memcpy(out, d.data(), d.size() * sizeof(int64_t));
}

// Zero-copy pointer to one sample's slice of variable `vi`; writes the
// sample's first-dim extent to *rows and byte length to *nbytes.
const void* gpk_sample_ptr(void* rp, uint32_t vi, uint64_t sample,
                           int64_t* rows, uint64_t* nbytes) {
  Reader* r = static_cast<Reader*>(rp);
  if (vi >= r->vars.size() || sample >= r->num_samples) return nullptr;
  const VarDesc& v = r->vars[vi];
  size_t rb = v.row_bytes();
  if (v.variable()) {
    const int64_t* count =
        (const int64_t*)(r->base + v.index_offset);
    const int64_t* offset = count + r->num_samples;
    *rows = count[sample];
    *nbytes = (uint64_t)count[sample] * rb;
    return r->base + v.data_offset + (uint64_t)offset[sample] * rb;
  }
  *rows = v.dims[0];
  *nbytes = (uint64_t)v.dims[0] * rb;
  return r->base + v.data_offset + sample * (*nbytes);
}

// Bulk pointer to a variable's whole blob (for preloading into numpy).
const void* gpk_var_ptr(void* rp, uint32_t vi, uint64_t* nbytes) {
  Reader* r = static_cast<Reader*>(rp);
  if (vi >= r->vars.size()) return nullptr;
  *nbytes = r->vars[vi].data_bytes;
  return r->base + r->vars[vi].data_offset;
}

const int64_t* gpk_var_index(void* rp, uint32_t vi) {
  Reader* r = static_cast<Reader*>(rp);
  if (vi >= r->vars.size() || !r->vars[vi].variable()) return nullptr;
  return (const int64_t*)(r->base + r->vars[vi].index_offset);
}

}  // extern "C"
