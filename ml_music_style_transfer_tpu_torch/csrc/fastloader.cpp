// fastloader: the native multi-threaded training-batch assembler.
//
// The port's own copy of the JAX package's native/fastloader/fastloader.cpp,
// built by ops/kernels/_build.py's host route (g++, no nvcc) and bound with
// ctypes by data/fastloader.py. Host C++, not a kernel.
//
// The reference's data loading is its acknowledged bottleneck (per-item
// h5py reads + per-item tensor uploads, model/train.py:53-57,93-96). Batch
// assembly (the index gather of rolls/onoff and the style-paired
// spectrogram gather into contiguous slot buffers) runs on worker threads
// that fill a slot ring while the card computes; Python only takes
// zero-copy numpy views of finished slots and releases them.
//
// Semantics match data/dataset.py ChunkDataset.assemble():
//   target[j] = specs[style[j]][idx[j]], cond[j] = specs[style[j]][cond_idx[j]]
//   midi[j] = pianoroll[idx[j]], onoff[j] = onoff[idx[j]]
// Index and style selection stay in Python (the reference's RNG semantics);
// the memcpy fan-out is native.
//
// One change from the JAX package's copy: fl_next hands out batches in the
// order they were submitted. There, with two worker threads, a later batch
// that finished first was handed out first, so an epoch's order could
// change from run to run.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct BatchSpec {
  std::vector<int64_t> idx;
  std::vector<int64_t> cond_idx;
  std::vector<int32_t> style;
  int64_t seq = 0;  // submission number
  int slot = -1;
};

struct Slot {
  std::vector<float> midi, onoff, cond, target;
  std::atomic<bool> ready{false};
};

struct FastLoader {
  // borrowed data pointers (owned by numpy on the Python side)
  const float* pianoroll = nullptr;  // (n_data, T, n_pitch)
  const float* onoff = nullptr;      // (n_data, T, n_pitch)
  std::vector<const float*> specs;   // per style: (n_data, T, n_bins)
  int64_t n_data = 0;
  int64_t roll_item = 0;  // T * n_pitch floats
  int64_t spec_item = 0;  // T * n_bins floats
  int batch = 0;

  std::vector<Slot> slots;
  std::deque<BatchSpec> pending;      // produced by fl_submit
  std::map<int64_t, int> done;        // submission number -> its filled slot
  std::deque<int> free_slots;
  int64_t n_submitted = 0, n_delivered = 0;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker_loop() {
    for (;;) {
      BatchSpec spec;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stop || (!pending.empty() && !free_slots.empty()); });
        if (stop) return;
        spec = std::move(pending.front());
        pending.pop_front();
        spec.slot = free_slots.front();
        free_slots.pop_front();
      }
      Slot& s = slots[spec.slot];
      const int b = static_cast<int>(spec.idx.size());
      for (int j = 0; j < b; ++j) {
        const int64_t i = spec.idx[j];
        const int64_t ci = spec.cond_idx[j];
        const float* sp = specs[spec.style[j]];
        std::memcpy(s.midi.data() + j * roll_item, pianoroll + i * roll_item,
                    roll_item * sizeof(float));
        std::memcpy(s.onoff.data() + j * roll_item, onoff + i * roll_item,
                    roll_item * sizeof(float));
        std::memcpy(s.target.data() + j * spec_item, sp + i * spec_item,
                    spec_item * sizeof(float));
        std::memcpy(s.cond.data() + j * spec_item, sp + ci * spec_item,
                    spec_item * sizeof(float));
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        done[spec.seq] = spec.slot;
      }
      cv_done.notify_all();
    }
  }
};

}  // namespace

extern "C" {

FastLoader* fl_create(const float* pianoroll, const float* onoff,
                      const float** specs, int n_styles, int64_t n_data,
                      int64_t roll_item, int64_t spec_item, int batch,
                      int n_slots, int n_threads) {
  auto* fl = new FastLoader();
  fl->pianoroll = pianoroll;
  fl->onoff = onoff;
  fl->specs.assign(specs, specs + n_styles);
  fl->n_data = n_data;
  fl->roll_item = roll_item;
  fl->spec_item = spec_item;
  fl->batch = batch;
  fl->slots = std::vector<Slot>(n_slots);
  for (int i = 0; i < n_slots; ++i) {
    fl->slots[i].midi.resize(batch * roll_item);
    fl->slots[i].onoff.resize(batch * roll_item);
    fl->slots[i].cond.resize(batch * spec_item);
    fl->slots[i].target.resize(batch * spec_item);
    fl->free_slots.push_back(i);
  }
  for (int t = 0; t < n_threads; ++t)
    fl->workers.emplace_back([fl] { fl->worker_loop(); });
  return fl;
}

// Enqueue a batch (arrays of length `batch`). Returns 0 on success.
int fl_submit(FastLoader* fl, const int64_t* idx, const int64_t* cond_idx,
              const int32_t* style, int batch) {
  if (batch != fl->batch) return -1;
  BatchSpec spec;
  spec.idx.assign(idx, idx + batch);
  spec.cond_idx.assign(cond_idx, cond_idx + batch);
  spec.style.assign(style, style + batch);
  for (int j = 0; j < batch; ++j) {
    if (spec.idx[j] < 0 || spec.idx[j] >= fl->n_data) return -2;
    if (spec.cond_idx[j] < 0 || spec.cond_idx[j] >= fl->n_data) return -2;
    if (spec.style[j] < 0 || spec.style[j] >= (int)fl->specs.size()) return -3;
  }
  {
    std::lock_guard<std::mutex> lk(fl->mu);
    spec.seq = fl->n_submitted++;
    fl->pending.push_back(std::move(spec));
  }
  fl->cv_work.notify_one();
  return 0;
}

// Block until the next batch in submission order is assembled; returns the
// slot id and its buffer pointers (valid until fl_release(slot)). Workers
// take pending batches first in, first out, so the next batch to hand out
// always holds a slot or is ahead of every batch that does.
int fl_next(FastLoader* fl, float** midi, float** onoff, float** cond,
            float** target) {
  std::unique_lock<std::mutex> lk(fl->mu);
  fl->cv_done.wait(lk, [&] { return fl->done.count(fl->n_delivered) > 0; });
  auto it = fl->done.find(fl->n_delivered++);
  int slot = it->second;
  fl->done.erase(it);
  Slot& s = fl->slots[slot];
  *midi = s.midi.data();
  *onoff = s.onoff.data();
  *cond = s.cond.data();
  *target = s.target.data();
  return slot;
}

void fl_release(FastLoader* fl, int slot) {
  {
    std::lock_guard<std::mutex> lk(fl->mu);
    fl->free_slots.push_back(slot);
  }
  fl->cv_work.notify_one();
}

void fl_destroy(FastLoader* fl) {
  {
    // set under the mutex: a worker evaluating the wait predicate must not
    // miss the wakeup (notify before it re-blocks would deadlock join)
    std::lock_guard<std::mutex> lk(fl->mu);
    fl->stop = true;
  }
  fl->cv_work.notify_all();
  for (auto& t : fl->workers) t.join();
  delete fl;
}

}  // extern "C"
