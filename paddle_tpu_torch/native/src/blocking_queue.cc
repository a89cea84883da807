// Copy of paddle_tpu/native/src/blocking_queue.cc (the port keeps its own).
// Bounded blocking byte-buffer queue — the native reader-queue role of the
// reference (paddle/fluid/framework/blocking_queue.h and the
// LoDTensorBlockingQueue bound at pybind.cc:591): producer threads push
// serialized batches, the trainer pops them with backpressure.  Plain C ABI
// for ctypes.

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <vector>

namespace {

struct Buffer {
  std::vector<uint8_t> data;
};

struct Queue {
  explicit Queue(size_t capacity) : capacity(capacity), closed(false) {}
  size_t capacity;
  bool closed;
  std::deque<Buffer> items;
  std::mutex mu;
  std::condition_variable not_full;
  std::condition_variable not_empty;
};

}  // namespace

extern "C" {

void* ptq_create(size_t capacity) { return new Queue(capacity); }

void ptq_destroy(void* h) { delete static_cast<Queue*>(h); }

// 1 = pushed, 0 = queue closed.
int ptq_push(void* h, const uint8_t* data, size_t len) {
  Queue* q = static_cast<Queue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  q->not_full.wait(lk,
                   [q] { return q->closed || q->items.size() < q->capacity; });
  if (q->closed) return 0;
  Buffer b;
  b.data.assign(data, data + len);
  q->items.push_back(std::move(b));
  q->not_empty.notify_one();
  return 1;
}

// Returns the popped length, 0 when the queue is closed AND drained.
// The payload is copied into out (caller sizes it via ptq_peek_len).
int64_t ptq_pop(void* h, uint8_t* out, size_t max_len) {
  Queue* q = static_cast<Queue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  q->not_empty.wait(lk, [q] { return q->closed || !q->items.empty(); });
  if (q->items.empty()) return 0;
  Buffer b = std::move(q->items.front());
  q->items.pop_front();
  q->not_full.notify_one();
  size_t n = b.data.size() < max_len ? b.data.size() : max_len;
  std::memcpy(out, b.data.data(), n);
  return static_cast<int64_t>(n);
}

// Length of the front item without popping (blocks like pop); 0 = closed
// and drained.
int64_t ptq_peek_len(void* h) {
  Queue* q = static_cast<Queue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  q->not_empty.wait(lk, [q] { return q->closed || !q->items.empty(); });
  if (q->items.empty()) return 0;
  return static_cast<int64_t>(q->items.front().data.size());
}

size_t ptq_size(void* h) {
  Queue* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->items.size();
}

void ptq_close(void* h) {
  Queue* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  q->closed = true;
  q->not_empty.notify_all();
  q->not_full.notify_all();
}

int ptq_is_closed(void* h) {
  Queue* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->closed ? 1 : 0;
}

}  // extern "C"
