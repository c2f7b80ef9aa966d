// Process-shared blocking byte queue: the DataLoader's worker transport
// (a copy of the JAX package's ``paddle_tpu/csrc/shm_queue.cpp``).
//
// Reference capability: the C++ LoDTensorBlockingQueue + buffered reader
// (paddle/fluid/operators/reader/, python/paddle/io/dataloader/
// dataloader_iter.py:114) that moves batches from worker processes to
// the trainer without Python-object serialization overhead.
//
// Design: one mmap'd shared-memory segment holding a ring buffer of
// bytes plus a pthread mutex/condvar pair with PROCESS_SHARED
// attributes. Writers (forked DataLoader workers) push length-prefixed
// records; the reader pops them in arrival order. Arrays are written as
// raw bytes with a dtype tag by the Python wrapper
// (paddle_tpu_torch/io/shm_queue.py), so a batch crosses the process
// boundary as one memcpy each way instead of a pickle round-trip.
//
// Host code only: built with g++ at first use by
// paddle_tpu_torch/ops/_build.py (plain C ABI, loaded with ctypes).

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <pthread.h>

extern "C" {

struct QueueHeader {
  pthread_mutex_t mutex;
  pthread_cond_t not_empty;
  pthread_cond_t not_full;
  uint64_t capacity;   // ring capacity in bytes
  uint64_t head;       // read offset
  uint64_t tail;       // write offset
  uint64_t size;       // bytes currently stored
  uint32_t closed;
  uint32_t _pad;
  // ring data follows
};

// Initialize a queue inside `mem` (an mmap'd shared segment of
// `total_bytes`). Returns usable ring capacity, or 0 on failure.
uint64_t shm_queue_init(void* mem, uint64_t total_bytes) {
  if (total_bytes <= sizeof(QueueHeader)) return 0;
  QueueHeader* h = static_cast<QueueHeader*>(mem);
  std::memset(h, 0, sizeof(QueueHeader));
  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  // robust: a worker killed while holding the lock must not deadlock
  // the trainer — the next locker gets EOWNERDEAD and recovers
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  if (pthread_mutex_init(&h->mutex, &ma) != 0) return 0;
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  if (pthread_cond_init(&h->not_empty, &ca) != 0) return 0;
  if (pthread_cond_init(&h->not_full, &ca) != 0) return 0;
  h->capacity = total_bytes - sizeof(QueueHeader);
  h->head = h->tail = h->size = 0;
  h->closed = 0;
  return h->capacity;
}

// The mutex came back from a holder that died (EOWNERDEAD): make it
// consistent and close the queue. The dead holder may have been a writer
// part way through a record, so the ring's bytes are suspect: drop them,
// and readers see the queue closed and drained (EOF), never a torn record.
static void recover(QueueHeader* h) {
  pthread_mutex_consistent(&h->mutex);
  h->closed = 1;
  h->size = 0;
  h->head = h->tail;
  pthread_cond_broadcast(&h->not_empty);
  pthread_cond_broadcast(&h->not_full);
}

static int lock(QueueHeader* h) {
  int rc = pthread_mutex_lock(&h->mutex);
  if (rc == EOWNERDEAD) {
    recover(h);
    return 0;
  }
  return rc;
}

// A wait re-acquires the mutex, and may be the call that finds its
// holder dead.
static void wait_on(pthread_cond_t* cv, QueueHeader* h) {
  if (pthread_cond_wait(cv, &h->mutex) == EOWNERDEAD) recover(h);
}

static uint8_t* ring_data(QueueHeader* h) {
  return reinterpret_cast<uint8_t*>(h) + sizeof(QueueHeader);
}

static void ring_write(QueueHeader* h, const uint8_t* src, uint64_t n) {
  uint8_t* data = ring_data(h);
  uint64_t first = h->capacity - h->tail;
  if (first > n) first = n;
  std::memcpy(data + h->tail, src, first);
  std::memcpy(data, src + first, n - first);
  h->tail = (h->tail + n) % h->capacity;
  h->size += n;
}

static void ring_read(QueueHeader* h, uint8_t* dst, uint64_t n) {
  uint8_t* data = ring_data(h);
  uint64_t first = h->capacity - h->head;
  if (first > n) first = n;
  std::memcpy(dst, data + h->head, first);
  std::memcpy(dst + first, data, n - first);
  h->head = (h->head + n) % h->capacity;
  h->size -= n;
}

// Push one length-prefixed record. Blocks while the ring is full.
// Returns 0 on success, -1 if closed, -2 if the record can never fit.
int shm_queue_push(void* mem, const uint8_t* buf, uint64_t n) {
  QueueHeader* h = static_cast<QueueHeader*>(mem);
  uint64_t need = n + 8;
  if (need > h->capacity) return -2;
  lock(h);
  while (h->capacity - h->size < need && !h->closed) {
    wait_on(&h->not_full, h);
  }
  if (h->closed) {
    pthread_mutex_unlock(&h->mutex);
    return -1;
  }
  uint64_t len = n;
  ring_write(h, reinterpret_cast<uint8_t*>(&len), 8);
  ring_write(h, buf, n);
  pthread_cond_signal(&h->not_empty);
  pthread_mutex_unlock(&h->mutex);
  return 0;
}

// Size of the next record, blocking until one is available.
// Returns -1 when the queue is closed AND drained.
int64_t shm_queue_next_size(void* mem) {
  QueueHeader* h = static_cast<QueueHeader*>(mem);
  lock(h);
  while (h->size == 0 && !h->closed) {
    wait_on(&h->not_empty, h);
  }
  if (h->size == 0 && h->closed) {
    pthread_mutex_unlock(&h->mutex);
    return -1;
  }
  // peek the length prefix without consuming it
  uint8_t lenb[8];
  uint64_t save_head = h->head, save_size = h->size;
  ring_read(h, lenb, 8);
  h->head = save_head;
  h->size = save_size;
  uint64_t len;
  std::memcpy(&len, lenb, 8);
  pthread_mutex_unlock(&h->mutex);
  return static_cast<int64_t>(len);
}

// Pop the next record into out (must be next_size() bytes).
// Returns record length, or -1 if closed+drained.
int64_t shm_queue_pop(void* mem, uint8_t* out, uint64_t out_cap) {
  QueueHeader* h = static_cast<QueueHeader*>(mem);
  lock(h);
  while (h->size == 0 && !h->closed) {
    wait_on(&h->not_empty, h);
  }
  if (h->size == 0 && h->closed) {
    pthread_mutex_unlock(&h->mutex);
    return -1;
  }
  uint8_t lenb[8];
  ring_read(h, lenb, 8);
  uint64_t len;
  std::memcpy(&len, lenb, 8);
  if (len > out_cap) {  // caller error; drop the record to stay sane
    uint8_t scratch[4096];
    uint64_t left = len;
    while (left) {
      uint64_t chunk = left < sizeof(scratch) ? left : sizeof(scratch);
      ring_read(h, scratch, chunk);
      left -= chunk;
    }
    pthread_cond_signal(&h->not_full);
    pthread_mutex_unlock(&h->mutex);
    return -2;
  }
  ring_read(h, out, len);
  pthread_cond_signal(&h->not_full);
  pthread_mutex_unlock(&h->mutex);
  return static_cast<int64_t>(len);
}

// Wake all waiters and mark closed (writers fail, readers drain).
void shm_queue_close(void* mem) {
  QueueHeader* h = static_cast<QueueHeader*>(mem);
  lock(h);
  h->closed = 1;
  pthread_cond_broadcast(&h->not_empty);
  pthread_cond_broadcast(&h->not_full);
  pthread_mutex_unlock(&h->mutex);
}

// Like shm_queue_next_size but waits at most timeout_ms.
// Returns record size, -1 closed+drained, -3 timeout.
int64_t shm_queue_next_size_timed(void* mem, int64_t timeout_ms) {
  QueueHeader* h = static_cast<QueueHeader*>(mem);
  lock(h);
  if (h->size == 0 && !h->closed) {
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    ts.tv_sec += timeout_ms / 1000;
    ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
    if (ts.tv_nsec >= 1000000000L) { ts.tv_sec++; ts.tv_nsec -= 1000000000L; }
    while (h->size == 0 && !h->closed) {
      int rc = pthread_cond_timedwait(&h->not_empty, &h->mutex, &ts);
      if (rc == EOWNERDEAD) {
        recover(h);
      } else if (rc == ETIMEDOUT) {
        pthread_mutex_unlock(&h->mutex);
        return -3;
      }
    }
  }
  if (h->size == 0 && h->closed) {
    pthread_mutex_unlock(&h->mutex);
    return -1;
  }
  uint8_t lenb[8];
  uint64_t save_head = h->head, save_size = h->size;
  ring_read(h, lenb, 8);
  h->head = save_head;
  h->size = save_size;
  uint64_t len;
  std::memcpy(&len, lenb, 8);
  pthread_mutex_unlock(&h->mutex);
  return static_cast<int64_t>(len);
}

uint64_t shm_queue_header_size() { return sizeof(QueueHeader); }

}  // extern "C"
