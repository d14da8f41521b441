// recordstore — memory-mapped single-file KV store (read path).
//
// Native replacement for the reference's LMDB engine role
// (ref: utils/lmdb.py:14-171): the training data layer streams
// JPEG-encoded frames by key. Layout (little-endian):
//
//   [0]  magic   u64  'GRVSTOR1'
//   [8]  count   u64
//   [16] index_offset u64
//   [24] ... record payloads ...
//   index: count x { hash u64, key_off u64, key_len u32, pad u32,
//                    val_off u64, val_len u64 }  (sorted by hash, then key)
//
// The port's copy of the JAX package's reader (same layout, same hash).
// The Python writer lives in guava_renderer_tpu_torch/data/store.py; this
// C++ reader mmaps the file once and serves zero-copy lookups via ctypes.
// Collisions are resolved by comparing the stored key bytes.

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct IndexEntry {
  uint64_t hash;
  uint64_t key_off;
  uint32_t key_len;
  uint32_t pad;
  uint64_t val_off;
  uint64_t val_len;
};

struct Store {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  const IndexEntry* index = nullptr;
  uint64_t count = 0;
};

constexpr uint64_t kMagic = 0x31524F5453565247ULL;  // "GRVSTOR1"

uint64_t fnv1a(const uint8_t* data, size_t len) {
  uint64_t h = 1469598103934665603ULL;
  for (size_t i = 0; i < len; ++i) {
    h ^= data[i];
    h *= 1099511628211ULL;
  }
  return h;
}

}  // namespace

extern "C" {

void* rs_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 24) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* s = new Store();
  s->fd = fd;
  s->base = static_cast<const uint8_t*>(mem);
  s->size = st.st_size;
  uint64_t magic, count, index_offset;
  std::memcpy(&magic, s->base, 8);
  std::memcpy(&count, s->base + 8, 8);
  std::memcpy(&index_offset, s->base + 16, 8);
  if (magic != kMagic || index_offset + count * sizeof(IndexEntry) > s->size) {
    munmap(mem, st.st_size);
    ::close(fd);
    delete s;
    return nullptr;
  }
  s->count = count;
  s->index = reinterpret_cast<const IndexEntry*>(s->base + index_offset);
  return s;
}

uint64_t rs_count(void* handle) {
  return handle ? static_cast<Store*>(handle)->count : 0;
}

// Returns pointer to the value (zero-copy into the mmap) and sets *len;
// nullptr when the key is absent.
const uint8_t* rs_get(void* handle, const char* key, uint64_t key_len,
                      uint64_t* len) {
  if (!handle) return nullptr;
  auto* s = static_cast<Store*>(handle);
  const uint64_t h = fnv1a(reinterpret_cast<const uint8_t*>(key), key_len);
  // binary search on hash
  uint64_t lo = 0, hi = s->count;
  while (lo < hi) {
    uint64_t mid = (lo + hi) / 2;
    if (s->index[mid].hash < h)
      lo = mid + 1;
    else
      hi = mid;
  }
  for (; lo < s->count && s->index[lo].hash == h; ++lo) {
    const IndexEntry& e = s->index[lo];
    if (e.key_len == key_len &&
        std::memcmp(s->base + e.key_off, key, key_len) == 0) {
      *len = e.val_len;
      return s->base + e.val_off;
    }
  }
  return nullptr;
}

// Key enumeration: writes the i-th key into buf (up to buf_len), returns
// the key length (0 when out of range).
uint64_t rs_key_at(void* handle, uint64_t i, char* buf, uint64_t buf_len) {
  if (!handle) return 0;
  auto* s = static_cast<Store*>(handle);
  if (i >= s->count) return 0;
  const IndexEntry& e = s->index[i];
  uint64_t n = e.key_len < buf_len ? e.key_len : buf_len;
  std::memcpy(buf, s->base + e.key_off, n);
  return e.key_len;
}

void rs_close(void* handle) {
  if (!handle) return;
  auto* s = static_cast<Store*>(handle);
  munmap(const_cast<uint8_t*>(s->base), s->size);
  ::close(s->fd);
  delete s;
}

}  // extern "C"
