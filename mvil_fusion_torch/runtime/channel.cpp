// Bounded in-process channels for the pipeline runtime.
//
// The port's own copy of mvil_fusion_tpu/runtime/channel.cpp.
//
// The reference's inter-stage transport is ROS1 TCP pub/sub with bounded
// queues and deliberate load-shedding drops (reference:
// estimator_node.cpp:552-559 queue depths, localMapping.cpp:328-332 stale
// frame drops; SURVEY.md §2.6).  Here the same semantics live in-process:
// a mutex+condvar ring buffer of fixed-size slots with two policies —
// BLOCK (backpressure) and DROP_OLDEST (load shedding).  Blocking calls
// release the Python GIL (ctypes foreign calls), so Python stage threads
// overlap host preprocessing with device compute.
//
// Built at first use by mvil_fusion_torch/runtime/__init__.py:
// g++ -O2 -std=c++17 -shared -fPIC -o build/runtime/libmvil_runtime-<hash>.so
//     channel.cpp -lpthread

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <vector>

namespace {

struct Channel {
  explicit Channel(uint32_t capacity, uint32_t slot_size, int policy)
      : capacity(capacity), slot_size(slot_size), policy(policy) {}

  const uint32_t capacity;
  const uint32_t slot_size;
  const int policy;  // 0 = BLOCK, 1 = DROP_OLDEST

  std::mutex mu;
  std::condition_variable cv_push;
  std::condition_variable cv_pop;
  std::deque<std::vector<uint8_t>> items;
  uint64_t dropped = 0;
  uint64_t pushed = 0;
  bool closed = false;
};

}  // namespace

extern "C" {

void* ch_create(uint32_t capacity, uint32_t slot_size, int policy) {
  return new Channel(capacity, slot_size, policy);
}

void ch_destroy(void* h) { delete static_cast<Channel*>(h); }

void ch_close(void* h) {
  auto* c = static_cast<Channel*>(h);
  {
    std::lock_guard<std::mutex> lk(c->mu);
    c->closed = true;
  }
  c->cv_push.notify_all();
  c->cv_pop.notify_all();
}

// returns: 0 ok, -1 closed, -2 payload too large
int ch_push(void* h, const uint8_t* data, uint32_t len) {
  auto* c = static_cast<Channel*>(h);
  if (len > c->slot_size) return -2;
  std::unique_lock<std::mutex> lk(c->mu);
  if (c->policy == 0) {
    c->cv_push.wait(lk, [&] { return c->items.size() < c->capacity
                                     || c->closed; });
    if (c->closed) return -1;
  } else {
    while (c->items.size() >= c->capacity) {
      c->items.pop_front();
      ++c->dropped;
    }
    if (c->closed) return -1;
  }
  c->items.emplace_back(data, data + len);
  ++c->pushed;
  lk.unlock();
  c->cv_pop.notify_one();
  return 0;
}

// returns: >=0 payload length, -1 closed+empty, -3 timeout
int ch_pop(void* h, uint8_t* out, uint32_t out_cap, int64_t timeout_us) {
  auto* c = static_cast<Channel*>(h);
  std::unique_lock<std::mutex> lk(c->mu);
  auto ready = [&] { return !c->items.empty() || c->closed; };
  if (timeout_us < 0) {
    c->cv_pop.wait(lk, ready);
  } else if (!c->cv_pop.wait_for(lk, std::chrono::microseconds(timeout_us),
                                 ready)) {
    return -3;
  }
  if (c->items.empty()) return -1;  // closed and drained
  auto item = std::move(c->items.front());
  c->items.pop_front();
  lk.unlock();
  c->cv_push.notify_one();
  uint32_t n = item.size() < out_cap ? item.size() : out_cap;
  std::memcpy(out, item.data(), n);
  return static_cast<int>(n);
}

uint32_t ch_size(void* h) {
  auto* c = static_cast<Channel*>(h);
  std::lock_guard<std::mutex> lk(c->mu);
  return static_cast<uint32_t>(c->items.size());
}

uint64_t ch_dropped(void* h) {
  auto* c = static_cast<Channel*>(h);
  std::lock_guard<std::mutex> lk(c->mu);
  return c->dropped;
}

uint64_t ch_pushed(void* h) {
  auto* c = static_cast<Channel*>(h);
  std::lock_guard<std::mutex> lk(c->mu);
  return c->pushed;
}

}  // extern "C"
