// ofrt — native host runtime (a copy of the JAX package's csrc/ofrt.cpp for
// onset_fingerprinting_torch, which builds it at first use).
//
// The reference's native layer is a C circular array + shared-memory IPC
// between an audio callback process and analysis workers (reference:
// onset_fingerprinting/c/circular_array.h:9-141,
// realtime/recording.py:65-158).  The re-design keeps compute on the device;
// the host side still needs a real-time-safe transport between the audio
// thread and the Python engine thread.  This library provides:
//
//  - ofrt_ring: a lock-free single-producer/single-consumer ring buffer of
//    float32 frames with monotonic counters (write side wait-free; read side
//    polls).  Mirrors the reference's SharedInt+CircularArray protocol
//    (single writer, monotonic counter, reader catches up) without IPC.
//
//  - ofrt_executor: a paced block executor that pulls fixed-size blocks from
//    a ring on a dedicated thread at audio rate (or as fast as possible),
//    invokes a registered callback (Python ctypes callback or C function),
//    and records per-block latency statistics (count/p50/p99/max) — the
//    1.33 ms budget observability the reference lacked (SURVEY.md §5.1).
//
// Built at first use by onset_fingerprinting_torch/runtime_native.py (g++,
// into build/ofrt/ beside the package); bound there with ctypes.

#include <atomic>
#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// SPSC ring buffer of float32 frames
// ---------------------------------------------------------------------------

struct ofrt_ring {
  std::vector<float> data;     // capacity_frames * channels
  int64_t capacity_frames;
  int64_t channels;
  std::atomic<int64_t> write_counter;  // total frames ever written
  std::atomic<int64_t> read_counter;   // total frames ever consumed
};

ofrt_ring* ofrt_ring_create(int64_t capacity_frames, int64_t channels) {
  auto* r = new ofrt_ring();
  r->data.assign(static_cast<size_t>(capacity_frames * channels), 0.0f);
  r->capacity_frames = capacity_frames;
  r->channels = channels;
  r->write_counter.store(0, std::memory_order_relaxed);
  r->read_counter.store(0, std::memory_order_relaxed);
  return r;
}

void ofrt_ring_destroy(ofrt_ring* r) { delete r; }

int64_t ofrt_ring_write_counter(const ofrt_ring* r) {
  return r->write_counter.load(std::memory_order_acquire);
}

int64_t ofrt_ring_read_counter(const ofrt_ring* r) {
  return r->read_counter.load(std::memory_order_acquire);
}

int64_t ofrt_ring_readable(const ofrt_ring* r) {
  return r->write_counter.load(std::memory_order_acquire) -
         r->read_counter.load(std::memory_order_acquire);
}

// Producer side (audio thread): wait-free; overwrites oldest data if the
// consumer lags more than capacity (the reference ring has the same
// overwrite semantics).  Returns frames written.
int64_t ofrt_ring_write(ofrt_ring* r, const float* frames, int64_t n) {
  const int64_t cap = r->capacity_frames;
  const int64_t ch = r->channels;
  int64_t wc = r->write_counter.load(std::memory_order_relaxed);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t slot = (wc + i) % cap;
    std::memcpy(&r->data[slot * ch], frames + i * ch, ch * sizeof(float));
  }
  r->write_counter.store(wc + n, std::memory_order_release);
  return n;
}

// Consumer side: copy up to n frames if available; returns frames read.
int64_t ofrt_ring_read(ofrt_ring* r, float* out, int64_t n) {
  const int64_t cap = r->capacity_frames;
  const int64_t ch = r->channels;
  int64_t rc = r->read_counter.load(std::memory_order_relaxed);
  const int64_t wc = r->write_counter.load(std::memory_order_acquire);
  const int64_t avail = wc - rc;
  if (avail < n) return 0;
  // Detect overwrite (producer lapped us): skip forward to the oldest
  // fully-valid frame, like the reference's counter-catchup.
  if (avail > cap) {
    rc = wc - cap;
  }
  for (int64_t i = 0; i < n; ++i) {
    const int64_t slot = (rc + i) % cap;
    std::memcpy(out + i * ch, &r->data[slot * ch], ch * sizeof(float));
  }
  r->read_counter.store(rc + n, std::memory_order_release);
  return n;
}

// Read the most recent n frames (linearized), without consuming — the
// negative-relative query of the reference CircularArray.
int64_t ofrt_ring_peek_last(const ofrt_ring* r, float* out, int64_t n) {
  const int64_t cap = r->capacity_frames;
  const int64_t ch = r->channels;
  const int64_t wc = r->write_counter.load(std::memory_order_acquire);
  if (n > cap) return 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t idx = wc - n + i;
    const int64_t slot = ((idx % cap) + cap) % cap;
    std::memcpy(out + i * ch, &r->data[slot * ch], ch * sizeof(float));
  }
  return n;
}

// ---------------------------------------------------------------------------
// Paced block executor
// ---------------------------------------------------------------------------

typedef void (*ofrt_block_cb)(const float* block, int64_t frames,
                              int64_t channels, int64_t block_index,
                              void* user);

struct ofrt_executor {
  ofrt_ring* ring;
  int64_t block_size;
  double sample_rate;      // <= 0: free-run (as fast as blocks arrive)
  ofrt_block_cb callback;
  void* user;
  std::thread worker;
  std::atomic<bool> running;
  std::atomic<int64_t> blocks_processed;
  std::atomic<int64_t> deadline_misses;
  std::vector<double> latencies_us;  // guarded by running flag (single writer)
  std::vector<float> scratch;
};

static void executor_loop(ofrt_executor* e) {
  using clock = std::chrono::steady_clock;
  const int64_t bs = e->block_size;
  const int64_t ch = e->ring->channels;
  const double budget_us =
      e->sample_rate > 0 ? 1e6 * bs / e->sample_rate : 0.0;
  int64_t idx = 0;
  while (e->running.load(std::memory_order_acquire)) {
    if (ofrt_ring_readable(e->ring) < bs) {
      std::this_thread::yield();
      continue;
    }
    auto t0 = clock::now();
    ofrt_ring_read(e->ring, e->scratch.data(), bs);
    e->callback(e->scratch.data(), bs, ch, idx, e->user);
    auto t1 = clock::now();
    const double us =
        std::chrono::duration<double, std::micro>(t1 - t0).count();
    if (e->latencies_us.size() < (1u << 20)) e->latencies_us.push_back(us);
    if (budget_us > 0 && us > budget_us)
      e->deadline_misses.fetch_add(1, std::memory_order_relaxed);
    e->blocks_processed.fetch_add(1, std::memory_order_relaxed);
    ++idx;
  }
}

ofrt_executor* ofrt_executor_create(ofrt_ring* ring, int64_t block_size,
                                    double sample_rate, ofrt_block_cb cb,
                                    void* user) {
  auto* e = new ofrt_executor();
  e->ring = ring;
  e->block_size = block_size;
  e->sample_rate = sample_rate;
  e->callback = cb;
  e->user = user;
  e->running.store(false);
  e->blocks_processed.store(0);
  e->deadline_misses.store(0);
  e->scratch.assign(static_cast<size_t>(block_size * ring->channels), 0.0f);
  return e;
}

void ofrt_executor_start(ofrt_executor* e) {
  if (e->running.exchange(true)) return;
  e->worker = std::thread(executor_loop, e);
}

void ofrt_executor_stop(ofrt_executor* e) {
  if (!e->running.exchange(false)) return;
  if (e->worker.joinable()) e->worker.join();
}

void ofrt_executor_destroy(ofrt_executor* e) {
  ofrt_executor_stop(e);
  delete e;
}

int64_t ofrt_executor_blocks(const ofrt_executor* e) {
  return e->blocks_processed.load(std::memory_order_relaxed);
}

int64_t ofrt_executor_misses(const ofrt_executor* e) {
  return e->deadline_misses.load(std::memory_order_relaxed);
}

// Latency stats over processed blocks so far: fills [count, p50, p99, max]
// (µs).  Call after stop() for a consistent snapshot.
void ofrt_executor_latency_stats(ofrt_executor* e, double* out4) {
  std::vector<double> v = e->latencies_us;
  if (v.empty()) {
    out4[0] = out4[1] = out4[2] = out4[3] = 0.0;
    return;
  }
  std::sort(v.begin(), v.end());
  out4[0] = static_cast<double>(v.size());
  out4[1] = v[v.size() / 2];
  out4[2] = v[std::min(v.size() - 1, (v.size() * 99) / 100)];
  out4[3] = v.back();
}

}  // extern "C"
