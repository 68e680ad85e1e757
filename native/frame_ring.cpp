// Native frame-ingest runtime: SPSC frame ring + stereo timestamp pairer.
//
// Replacement for the reference's C++ host ingest plumbing:
//  * message_filters Exact/ApproximateTime synchronizers
//    (reference: include/gpuimageproc/StereoProcessor.h:45-62,
//     src/StereoProcessor.cpp:33-77)  -> Pairer
//  * pinned HostMem staging + drop-on-overflow queues
//    (reference: src/GPUStereoProcessor.cpp:89-109 uploadMat,
//     queue_size rosparam src/StereoProcessor.cpp:33-34)   -> Ring
//
// The ring hands out zero-copy slot views (peek/release) so Python can
// jax.device_put straight from the staging memory without an extra memcpy;
// producer threads never touch the GIL.  Single-producer/single-consumer
// indices are lock-free; blocking waits use a mutex+condvar only at the
// empty/full edges.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC frame_ring.cpp -o libframe_ring.so

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cmath>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

struct Ring {
  size_t capacity = 0;
  size_t image_bytes = 0;
  bool drop_on_full = true;
  std::vector<uint8_t> left, right;
  std::vector<double> stamp;
  std::vector<uint64_t> seq;
  // head: next write slot index (monotonic), tail: next read slot index
  std::atomic<uint64_t> head{0}, tail{0};
  std::atomic<uint64_t> n_pushed{0}, n_popped{0}, n_dropped{0};
  std::mutex m;
  std::condition_variable cv_nonempty, cv_nonfull;
};

struct PendingFrame {
  std::vector<uint8_t> img;
  double stamp;
};

struct Pairer {
  double slop = 0.01;
  bool exact = true;
  size_t image_bytes = 0;
  size_t queue_size = 5;  // the reference's queue_size rosparam default
  std::deque<PendingFrame> left, right;
  uint64_t n_paired = 0, n_dropped = 0;
  std::mutex m;
};

bool wait_pred(std::unique_lock<std::mutex>& lk, std::condition_variable& cv,
               double timeout_s, const std::function<bool()>& pred) {
  if (timeout_s < 0) {
    cv.wait(lk, pred);
    return true;
  }
  return cv.wait_for(lk, std::chrono::duration<double>(timeout_s), pred);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Ring
// ---------------------------------------------------------------------------

Ring* ring_create(size_t capacity, size_t image_bytes, int drop_on_full) {
  auto* r = new Ring();
  r->capacity = capacity;
  r->image_bytes = image_bytes;
  r->drop_on_full = drop_on_full != 0;
  r->left.resize(capacity * image_bytes);
  r->right.resize(capacity * image_bytes);
  r->stamp.resize(capacity);
  r->seq.resize(capacity);
  return r;
}

void ring_destroy(Ring* r) { delete r; }

size_t ring_size(Ring* r) {
  return static_cast<size_t>(r->head.load() - r->tail.load());
}

uint64_t ring_pushed(Ring* r) { return r->n_pushed.load(); }
uint64_t ring_popped(Ring* r) { return r->n_popped.load(); }
uint64_t ring_dropped(Ring* r) { return r->n_dropped.load(); }

// Returns 1 on success, 0 on drop/timeout.
int ring_push(Ring* r, const uint8_t* l, const uint8_t* rgt, double stamp,
              uint64_t seq, double timeout_s) {
  uint64_t h = r->head.load(std::memory_order_relaxed);
  if (h - r->tail.load(std::memory_order_acquire) >= r->capacity) {
    if (r->drop_on_full) {
      r->n_dropped.fetch_add(1);
      return 0;  // drop-on-overflow, the ROS queue behaviour
    }
    std::unique_lock<std::mutex> lk(r->m);
    bool ok = wait_pred(lk, r->cv_nonfull, timeout_s, [&] {
      return r->head.load() - r->tail.load() < r->capacity;
    });
    if (!ok) return 0;
    h = r->head.load(std::memory_order_relaxed);
  }
  size_t slot = static_cast<size_t>(h % r->capacity);
  std::memcpy(&r->left[slot * r->image_bytes], l, r->image_bytes);
  std::memcpy(&r->right[slot * r->image_bytes], rgt, r->image_bytes);
  r->stamp[slot] = stamp;
  r->seq[slot] = seq;
  r->head.store(h + 1, std::memory_order_release);
  r->n_pushed.fetch_add(1);
  {
    std::lock_guard<std::mutex> lk(r->m);
    r->cv_nonempty.notify_one();
  }
  return 1;
}

// Zero-copy consume: expose pointers into the slot.  Caller MUST call
// ring_release exactly once after the data has been consumed (device_put'd).
int ring_peek(Ring* r, uint8_t** l, uint8_t** rgt, double* stamp,
              uint64_t* seq, double timeout_s) {
  uint64_t t = r->tail.load(std::memory_order_relaxed);
  if (r->head.load(std::memory_order_acquire) == t) {
    std::unique_lock<std::mutex> lk(r->m);
    bool ok = wait_pred(lk, r->cv_nonempty, timeout_s,
                        [&] { return r->head.load() != r->tail.load(); });
    if (!ok) return 0;
  }
  size_t slot = static_cast<size_t>(t % r->capacity);
  *l = &r->left[slot * r->image_bytes];
  *rgt = &r->right[slot * r->image_bytes];
  *stamp = r->stamp[slot];
  *seq = r->seq[slot];
  return 1;
}

void ring_release(Ring* r) {
  r->tail.fetch_add(1, std::memory_order_release);
  r->n_popped.fetch_add(1);
  std::lock_guard<std::mutex> lk(r->m);
  r->cv_nonfull.notify_one();
}

// Copy-out consume (simpler, one memcpy).
int ring_pop(Ring* r, uint8_t* l, uint8_t* rgt, double* stamp, uint64_t* seq,
             double timeout_s) {
  uint8_t *pl, *pr;
  if (!ring_peek(r, &pl, &pr, stamp, seq, timeout_s)) return 0;
  std::memcpy(l, pl, r->image_bytes);
  std::memcpy(rgt, pr, r->image_bytes);
  ring_release(r);
  return 1;
}

// ---------------------------------------------------------------------------
// Pairer — timestamp synchronization (ExactTime / ApproximateTime policies)
// ---------------------------------------------------------------------------

Pairer* pairer_create(double slop, int exact, size_t image_bytes,
                      size_t queue_size) {
  auto* p = new Pairer();
  p->slop = slop;
  p->exact = exact != 0;
  p->image_bytes = image_bytes;
  p->queue_size = queue_size;
  return p;
}

void pairer_destroy(Pairer* p) { delete p; }

uint64_t pairer_paired(Pairer* p) { return p->n_paired; }
uint64_t pairer_dropped(Pairer* p) { return p->n_dropped; }

// side: 0 = left, 1 = right.
void pairer_add(Pairer* p, int side, const uint8_t* img, double stamp) {
  std::lock_guard<std::mutex> lk(p->m);
  auto& q = side == 0 ? p->left : p->right;
  q.push_back(PendingFrame{
      std::vector<uint8_t>(img, img + p->image_bytes), stamp});
  if (q.size() > p->queue_size) {  // drop oldest, ROS queue semantics
    q.pop_front();
    p->n_dropped++;
  }
}

// Try to produce a synchronized pair.  Returns 1 and fills the buffers when
// a pair under the active policy is available.
int pairer_get(Pairer* p, uint8_t* l, uint8_t* rgt, double* stamp) {
  std::lock_guard<std::mutex> lk(p->m);
  while (!p->left.empty() && !p->right.empty()) {
    double tl = p->left.front().stamp;
    double tr = p->right.front().stamp;
    bool match = p->exact ? (tl == tr) : (std::abs(tl - tr) <= p->slop);
    if (match) {
      // approx policy: make sure the *next* right isn't closer
      if (!p->exact && p->right.size() > 1) {
        double trn = p->right[1].stamp;
        if (std::abs(trn - tl) < std::abs(tr - tl)) {
          p->right.pop_front();
          continue;
        }
      }
      std::memcpy(l, p->left.front().img.data(), p->image_bytes);
      std::memcpy(rgt, p->right.front().img.data(), p->image_bytes);
      *stamp = tl;
      p->left.pop_front();
      p->right.pop_front();
      p->n_paired++;
      return 1;
    }
    // discard the older unmatched frame
    if (tl < tr) {
      p->left.pop_front();
    } else {
      p->right.pop_front();
    }
    p->n_dropped++;
  }
  return 0;
}

}  // extern "C"
