// Shared-memory object store — the analog of the reference's
// plasma store (src/ray/object_manager/plasma/store.h,
// object_lifecycle_manager.h, eviction_policy.h, plasma_allocator.h).
//
// Design differences from plasma, chosen for a host that runs a few
// worker processes:
//   * No store server process and no unix-socket protocol (plasma.fbs,
//     fling.cc fd-passing). All control state — the object index, the
//     allocator, refcounts, the LRU clock — lives *inside* the shared
//     memory segment, guarded by a process-shared robust mutex. Any
//     attached process creates/seals/gets objects directly; a create+seal
//     round trip is two mutex acquisitions instead of two socket round
//     trips. This matters because a GPU host runs O(1) workers per card,
//     not O(100), so a lock-per-op design is uncontended in practice.
//   * Allocation uses a boundary-tag first-fit free list with coalescing
//     (plasma uses a dlmalloc arena, plasma/dlmalloc.cc).
//   * Eviction: LRU over sealed refcount-0 objects via a monotonic clock
//     tick per Get/Seal (plasma: eviction_policy.h LRUCache).
//
// Object lifecycle mirrors plasma: Create (allocates, writable by creator)
// -> Seal (immutable, visible to others) -> Get/Release (pin/unpin) ->
// Delete or Evict.  Abort frees an unsealed object.
//
// Built by ray_tpu_torch/_build.py build_native("object_store"):
// g++ -O2 -fPIC -std=c++17 -Wall -shared object_store.cc -lpthread -lrt

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x5254535452554354ull;  // "RTSTRUCT"
constexpr uint32_t kIdSize = 16;
constexpr uint64_t kAlign = 64;
// Allocator block header: size of this block's payload, size of previous
// block's payload (for coalescing), free flag.
struct BlockHeader {
  uint64_t size;       // payload bytes
  uint64_t prev_size;  // payload bytes of the block immediately before us
  uint32_t free_flag;  // 1 = free
  uint32_t pad;
};
static_assert(sizeof(BlockHeader) == 24, "block header layout");

constexpr uint64_t kBlockOverhead = ((sizeof(BlockHeader) + kAlign - 1) / kAlign) * kAlign;

enum ObjectState : uint32_t {
  kFree = 0,
  kCreating = 1,
  kSealed = 2,
  kTombstone = 3,  // deleted hash slot; probe chains continue through it
};

struct Entry {
  uint8_t id[kIdSize];
  uint32_t state;
  uint32_t refcount;
  uint64_t offset;     // payload offset from segment base
  uint64_t data_size;  // bytes of object data
  uint64_t lru_tick;
};

struct Header {
  uint64_t magic;
  uint64_t total_size;
  uint64_t table_offset;
  uint64_t table_capacity;  // power of two
  uint64_t heap_offset;
  uint64_t heap_size;
  uint64_t free_head;  // offset of first free block header, 0 = none
  uint64_t lru_clock;
  // stats
  uint64_t used_bytes;
  uint64_t num_objects;
  uint64_t num_evictions;
  uint64_t evicted_bytes;
  pthread_mutex_t mutex;
};

struct Handle {
  uint8_t* base;
  uint64_t size;
  Header* header;
  char name[256];
};

inline Entry* table(Handle* h) {
  return reinterpret_cast<Entry*>(h->base + h->header->table_offset);
}

inline BlockHeader* block_at(Handle* h, uint64_t payload_off) {
  return reinterpret_cast<BlockHeader*>(h->base + payload_off - kBlockOverhead);
}

inline uint64_t payload_off(Handle* h, BlockHeader* b) {
  return static_cast<uint64_t>(reinterpret_cast<uint8_t*>(b) - h->base) + kBlockOverhead;
}

// Free-list links are stored in the first 16 bytes of a free block's payload.
struct FreeLinks {
  uint64_t next;  // payload offset of next free block, 0 = end
  uint64_t prev;
};

inline FreeLinks* links(Handle* h, uint64_t off) {
  return reinterpret_cast<FreeLinks*>(h->base + off);
}

uint64_t hash_id(const uint8_t* id) {
  // FNV-1a over the 16-byte id.
  uint64_t hv = 1469598103934665603ull;
  for (uint32_t i = 0; i < kIdSize; i++) {
    hv ^= id[i];
    hv *= 1099511628211ull;
  }
  return hv;
}

void lock(Handle* h) {
  int rc = pthread_mutex_lock(&h->header->mutex);
  if (rc == EOWNERDEAD) {
    // A process died holding the lock; state is still consistent enough for
    // our ops (we never leave multi-step invariants broken across a lock).
    pthread_mutex_consistent(&h->header->mutex);
  }
}

void unlock(Handle* h) { pthread_mutex_unlock(&h->header->mutex); }

// ---- allocator ------------------------------------------------------------

void freelist_remove(Handle* h, uint64_t off) {
  FreeLinks* l = links(h, off);
  if (l->prev) {
    links(h, l->prev)->next = l->next;
  } else {
    h->header->free_head = l->next;
  }
  if (l->next) links(h, l->next)->prev = l->prev;
}

void freelist_push(Handle* h, uint64_t off) {
  FreeLinks* l = links(h, off);
  l->next = h->header->free_head;
  l->prev = 0;
  if (l->next) links(h, l->next)->prev = off;
  h->header->free_head = off;
}

inline uint64_t heap_end(Handle* h) {
  return h->header->heap_offset + h->header->heap_size;
}

// Blocks tile the heap contiguously. For a block with payload `off` and
// payload size `size`, the following block's payload offset is
// off + size + kBlockOverhead; it exists iff that is < heap_end.
inline uint64_t next_payload_off(uint64_t off, uint64_t size) {
  return off + size + kBlockOverhead;
}

// Returns payload offset or 0 on failure.
uint64_t alloc_block(Handle* h, uint64_t want) {
  want = (want + kAlign - 1) / kAlign * kAlign;
  if (want < sizeof(FreeLinks)) want = kAlign;
  uint64_t off = h->header->free_head;
  while (off) {
    BlockHeader* b = block_at(h, off);
    if (b->size >= want) {
      freelist_remove(h, off);
      uint64_t remainder = b->size - want;
      if (remainder >= kBlockOverhead + kAlign) {
        // Split: carve the tail into a new free block.
        b->size = want;
        uint64_t next_off = next_payload_off(off, want);
        BlockHeader* nb = block_at(h, next_off);
        nb->size = remainder - kBlockOverhead;
        nb->prev_size = want;
        nb->free_flag = 1;
        freelist_push(h, next_off);
        // fix prev_size of the block after the new free block
        uint64_t after = next_payload_off(next_off, nb->size);
        if (after < heap_end(h)) {
          block_at(h, after)->prev_size = nb->size;
        }
      }
      b->free_flag = 0;
      return off;
    }
    off = links(h, off)->next;
  }
  return 0;
}

void free_block(Handle* h, uint64_t off) {
  BlockHeader* b = block_at(h, off);
  b->free_flag = 1;
  // Coalesce with next block.
  uint64_t next_off = next_payload_off(off, b->size);
  if (next_off < heap_end(h)) {
    BlockHeader* nb = block_at(h, next_off);
    if (nb->free_flag) {
      freelist_remove(h, next_off);
      b->size += nb->size + kBlockOverhead;
    }
  }
  // Coalesce with previous block.
  if (b->prev_size) {
    uint64_t prev_payload = off - kBlockOverhead - b->prev_size;
    BlockHeader* pb = block_at(h, prev_payload);
    if (pb->free_flag) {
      freelist_remove(h, prev_payload);
      pb->size += b->size + kBlockOverhead;
      b = pb;
      off = prev_payload;
    }
  }
  // Fix the next block's prev_size after coalescing.
  uint64_t after = next_payload_off(off, b->size);
  if (after < heap_end(h)) {
    block_at(h, after)->prev_size = b->size;
  }
  freelist_push(h, off);
}

// ---- object index ---------------------------------------------------------

Entry* find_entry(Handle* h, const uint8_t* id) {
  Entry* t = table(h);
  uint64_t cap = h->header->table_capacity;
  uint64_t idx = hash_id(id) & (cap - 1);
  for (uint64_t probe = 0; probe < cap; probe++) {
    Entry* e = &t[(idx + probe) & (cap - 1)];
    if (e->state == kFree) return nullptr;
    if (e->state != kTombstone && memcmp(e->id, id, kIdSize) == 0) return e;
  }
  return nullptr;
}

Entry* insert_entry(Handle* h, const uint8_t* id) {
  Entry* t = table(h);
  uint64_t cap = h->header->table_capacity;
  uint64_t idx = hash_id(id) & (cap - 1);
  Entry* first_tomb = nullptr;
  for (uint64_t probe = 0; probe < cap; probe++) {
    Entry* e = &t[(idx + probe) & (cap - 1)];
    if (e->state == kTombstone) {
      if (!first_tomb) first_tomb = e;
      continue;
    }
    if (e->state == kFree) return first_tomb ? first_tomb : e;
    if (memcmp(e->id, id, kIdSize) == 0) return nullptr;  // exists
  }
  return first_tomb;  // table full unless a tombstone is reusable
}

void erase_entry(Handle* h, Entry* e) {
  memset(e->id, 0, kIdSize);
  e->state = kTombstone;
  e->refcount = 0;
  e->offset = 0;
  e->data_size = 0;
}

// Evict LRU sealed refcount-0 objects until at least `need` payload bytes
// could plausibly be freed. Returns bytes freed.
uint64_t evict_lru(Handle* h, uint64_t need) {
  uint64_t freed = 0;
  Entry* t = table(h);
  uint64_t cap = h->header->table_capacity;
  while (freed < need) {
    Entry* victim = nullptr;
    for (uint64_t i = 0; i < cap; i++) {
      Entry* e = &t[i];
      if (e->state == kSealed && e->refcount == 0) {
        if (!victim || e->lru_tick < victim->lru_tick) victim = e;
      }
    }
    if (!victim) break;
    uint64_t sz = victim->data_size;
    free_block(h, victim->offset);
    h->header->used_bytes -= sz;
    h->header->num_objects--;
    h->header->num_evictions++;
    h->header->evicted_bytes += sz;
    erase_entry(h, victim);
    freed += sz + kBlockOverhead;
  }
  return freed;
}

}  // namespace

extern "C" {

// Error codes
#define RT_OK 0
#define RT_ERR_EXISTS -1
#define RT_ERR_FULL -2
#define RT_ERR_NOT_FOUND -3
#define RT_ERR_NOT_SEALED -4
#define RT_ERR_IN_USE -5
#define RT_ERR_STATE -6
#define RT_ERR_SYS -7

void* rt_store_open(const char* name, uint64_t size, int create) {
  int flags = create ? (O_CREAT | O_EXCL | O_RDWR) : O_RDWR;
  int fd = shm_open(name, flags, 0600);
  if (fd < 0) return nullptr;
  if (create) {
    if (ftruncate(fd, static_cast<off_t>(size)) != 0) {
      close(fd);
      shm_unlink(name);
      return nullptr;
    }
  } else {
    struct stat st;
    if (fstat(fd, &st) != 0) {
      close(fd);
      return nullptr;
    }
    size = static_cast<uint64_t>(st.st_size);
  }
  void* base = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;

  Handle* h = new Handle();
  h->base = static_cast<uint8_t*>(base);
  h->size = size;
  h->header = reinterpret_cast<Header*>(base);
  snprintf(h->name, sizeof(h->name), "%s", name);

  if (create) {
    Header* hd = h->header;
    memset(hd, 0, sizeof(Header));
    hd->magic = kMagic;
    hd->total_size = size;
    // Size the index at ~1 entry per 16 KiB of heap, clamped to [1024, 2^20].
    uint64_t cap = 1024;
    while (cap < size / 16384 && cap < (1ull << 20)) cap <<= 1;
    hd->table_capacity = cap;
    hd->table_offset = (sizeof(Header) + kAlign - 1) / kAlign * kAlign;
    uint64_t table_bytes = cap * sizeof(Entry);
    hd->heap_offset =
        (hd->table_offset + table_bytes + kAlign - 1) / kAlign * kAlign + kBlockOverhead;
    hd->heap_size = size - hd->heap_offset;
    memset(h->base + hd->table_offset, 0, table_bytes);
    // One giant free block spanning the heap.
    BlockHeader* b = block_at(h, hd->heap_offset);
    b->size = hd->heap_size - kBlockOverhead;
    // Leave room so payload + overhead fits: heap_size includes our header.
    b->size = (hd->heap_size >= 2 * kBlockOverhead) ? hd->heap_size - kBlockOverhead : 0;
    b->prev_size = 0;
    b->free_flag = 1;
    hd->free_head = hd->heap_offset;
    FreeLinks* l = links(h, hd->heap_offset);
    l->next = 0;
    l->prev = 0;

    pthread_mutexattr_t attr;
    pthread_mutexattr_init(&attr);
    pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&hd->mutex, &attr);
    pthread_mutexattr_destroy(&attr);
  } else if (h->header->magic != kMagic) {
    munmap(base, size);
    delete h;
    return nullptr;
  }
  return h;
}

void rt_store_close(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  munmap(h->base, h->size);
  delete h;
}

int rt_store_unlink(const char* name) { return shm_unlink(name); }

uint8_t* rt_store_base(void* handle) { return static_cast<Handle*>(handle)->base; }

int64_t rt_store_create_object(void* handle, const uint8_t* id, uint64_t size) {
  Handle* h = static_cast<Handle*>(handle);
  lock(h);
  if (find_entry(h, id)) {
    unlock(h);
    return RT_ERR_EXISTS;
  }
  Entry* e = insert_entry(h, id);
  if (!e) {
    unlock(h);
    return RT_ERR_FULL;
  }
  uint64_t off = alloc_block(h, size ? size : 1);
  if (!off) {
    evict_lru(h, size + kBlockOverhead);
    off = alloc_block(h, size ? size : 1);
  }
  if (!off) {
    unlock(h);
    return RT_ERR_FULL;
  }
  memcpy(e->id, id, kIdSize);
  e->state = kCreating;
  e->refcount = 1;  // creator holds a ref until seal+release
  e->offset = off;
  e->data_size = size;
  e->lru_tick = ++h->header->lru_clock;
  h->header->used_bytes += size;
  h->header->num_objects++;
  unlock(h);
  return static_cast<int64_t>(off);
}

int rt_store_seal(void* handle, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(handle);
  lock(h);
  Entry* e = find_entry(h, id);
  if (!e) {
    unlock(h);
    return RT_ERR_NOT_FOUND;
  }
  if (e->state != kCreating) {
    unlock(h);
    return RT_ERR_STATE;
  }
  e->state = kSealed;
  e->lru_tick = ++h->header->lru_clock;
  unlock(h);
  return RT_OK;
}

// Get: pins the object (refcount++). Returns payload offset, fills size.
int64_t rt_store_get(void* handle, const uint8_t* id, uint64_t* size_out) {
  Handle* h = static_cast<Handle*>(handle);
  lock(h);
  Entry* e = find_entry(h, id);
  if (!e) {
    unlock(h);
    return RT_ERR_NOT_FOUND;
  }
  if (e->state != kSealed) {
    unlock(h);
    return RT_ERR_NOT_SEALED;
  }
  e->refcount++;
  e->lru_tick = ++h->header->lru_clock;
  if (size_out) *size_out = e->data_size;
  int64_t off = static_cast<int64_t>(e->offset);
  unlock(h);
  return off;
}

int rt_store_release(void* handle, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(handle);
  lock(h);
  Entry* e = find_entry(h, id);
  if (!e) {
    unlock(h);
    return RT_ERR_NOT_FOUND;
  }
  if (e->refcount > 0) e->refcount--;
  unlock(h);
  return RT_OK;
}

int rt_store_contains(void* handle, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(handle);
  lock(h);
  Entry* e = find_entry(h, id);
  int r = (e && e->state == kSealed) ? 1 : 0;
  unlock(h);
  return r;
}

int rt_store_delete(void* handle, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(handle);
  lock(h);
  Entry* e = find_entry(h, id);
  if (!e) {
    unlock(h);
    return RT_ERR_NOT_FOUND;
  }
  if (e->refcount > 0) {
    unlock(h);
    return RT_ERR_IN_USE;
  }
  free_block(h, e->offset);
  h->header->used_bytes -= e->data_size;
  h->header->num_objects--;
  erase_entry(h, e);
  unlock(h);
  return RT_OK;
}

int rt_store_abort(void* handle, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(handle);
  lock(h);
  Entry* e = find_entry(h, id);
  if (!e || e->state != kCreating) {
    unlock(h);
    return RT_ERR_STATE;
  }
  free_block(h, e->offset);
  h->header->used_bytes -= e->data_size;
  h->header->num_objects--;
  erase_entry(h, e);
  unlock(h);
  return RT_OK;
}

uint64_t rt_store_evict(void* handle, uint64_t nbytes) {
  Handle* h = static_cast<Handle*>(handle);
  lock(h);
  uint64_t freed = evict_lru(h, nbytes);
  unlock(h);
  return freed;
}

// stats: [0]=used_bytes [1]=num_objects [2]=num_evictions [3]=heap_size
void rt_store_stats(void* handle, uint64_t* out) {
  Handle* h = static_cast<Handle*>(handle);
  lock(h);
  out[0] = h->header->used_bytes;
  out[1] = h->header->num_objects;
  out[2] = h->header->num_evictions;
  out[3] = h->header->heap_size;
  unlock(h);
}

}  // extern "C"
