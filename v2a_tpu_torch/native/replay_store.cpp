// Native episode store + hindsight batch sampler.
//
// The port's copy of the JAX package's episode store, built by
// `v2a_tpu_torch/ops/_build.py::load_host` with g++ at first use.
//
// Host-side hot path of online training: every train step assembles a batch
// of (start image, goal image, action window) triples from stored episodes
// (reference semantics: uniform episode with replacement, uniform start in
// [0, len - horizon - 1], goal = start + horizon —
// `diffuser/datasets/env_img_replay_buffer.py:68-116,278-302`). The Python
// reference stacks per-step torch tensors; here episodes live in one
// preallocated slab (uint8 images, float32 actions) and batch assembly is
// parallel memcpy, so the sampler keeps up with the accelerator while the
// GIL-holding thread does other work.
//
// C ABI for ctypes binding (`v2a_tpu_torch/data/native_store.py`). No Python.h
// dependency; thread-safety contract: add_episode and sample_batch must not
// run concurrently with each other (the Python wrapper holds a lock).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// splitmix64: deterministic counter-based RNG so a (seed, draw-index) pair
// fully determines the sample, matching the repo's explicit-RNG discipline.
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97f4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

static inline uint64_t bounded(uint64_t r, uint64_t n) {
  // unbiased-enough for sampling purposes: 128-bit multiply-shift
  return (uint64_t)(((__uint128_t)r * (__uint128_t)n) >> 64);
}

struct Episode {
  int64_t n_imgs = 0;  // T+1
  // offsets into the slabs, in elements
  int64_t img_off = 0;
  int64_t act_off = 0;
};

struct Store {
  int64_t max_episodes;
  int64_t max_len;  // max images per episode
  int64_t h, w, c;
  int64_t act_dim;

  std::vector<uint8_t> img_slab;   // max_episodes * max_len * h*w*c
  std::vector<float> act_slab;     // max_episodes * (max_len-1) * act_dim
  std::vector<Episode> episodes;   // ring of size max_episodes
  int64_t n_live = 0;
  int64_t next_slot = 0;           // FIFO ring cursor
  int64_t total_added = 0;         // incl. evicted

  int64_t img_px() const { return h * w * c; }
};

}  // namespace

extern "C" {

Store* v2a_store_create(int64_t max_episodes, int64_t max_len, int64_t h,
                        int64_t w, int64_t c, int64_t act_dim) {
  if (max_episodes <= 0 || max_len <= 1 || h <= 0 || w <= 0 || c <= 0 ||
      act_dim <= 0)
    return nullptr;
  Store* s = new (std::nothrow) Store();
  if (!s) return nullptr;
  s->max_episodes = max_episodes;
  s->max_len = max_len;
  s->h = h;
  s->w = w;
  s->c = c;
  s->act_dim = act_dim;
  try {
    s->img_slab.resize((size_t)max_episodes * max_len * h * w * c);
    s->act_slab.resize((size_t)max_episodes * (max_len - 1) * act_dim);
    s->episodes.resize(max_episodes);
  } catch (...) {
    delete s;
    return nullptr;
  }
  for (int64_t i = 0; i < max_episodes; ++i) {
    s->episodes[i].img_off = i * s->max_len * s->img_px();
    s->episodes[i].act_off = i * (s->max_len - 1) * s->act_dim;
  }
  return s;
}

void v2a_store_destroy(Store* s) { delete s; }

int64_t v2a_store_len(const Store* s) { return s ? s->n_live : 0; }
int64_t v2a_store_total_added(const Store* s) {
  return s ? s->total_added : 0;
}

// Returns the slot index the episode landed in, or -1 on error.
// imgs: (n_imgs, h, w, c) uint8 contiguous; acts: (n_imgs-1, act_dim) f32.
// Episodes longer than max_len keep their most recent frames (the
// reference's deque truncation, `env_img_replay_buffer.py:240-248`).
int64_t v2a_store_add_episode(Store* s, const uint8_t* imgs,
                              const float* acts, int64_t n_imgs) {
  if (!s || !imgs || !acts || n_imgs < 2) return -1;
  int64_t keep = std::min(n_imgs, s->max_len);
  int64_t skip = n_imgs - keep;  // drop oldest frames
  int64_t slot = s->next_slot;
  Episode& ep = s->episodes[slot];
  ep.n_imgs = keep;
  std::memcpy(s->img_slab.data() + ep.img_off,
              imgs + skip * s->img_px(),
              (size_t)keep * s->img_px());
  std::memcpy(s->act_slab.data() + ep.act_off,
              acts + skip * s->act_dim,
              (size_t)(keep - 1) * s->act_dim * sizeof(float));
  s->next_slot = (s->next_slot + 1) % s->max_episodes;
  s->n_live = std::min(s->n_live + 1, s->max_episodes);
  s->total_added += 1;
  return slot;
}

// Assemble a hindsight batch. Outputs must be preallocated:
//   out_obs, out_goal: (batch, h, w, c) uint8
//   out_acts:          (batch, horizon, act_dim) float32
//   out_ep_slots:      (batch,) int64 — which stored episode each row used
// Returns 0 on success, nonzero on error (-2: empty store, -3: an episode
// shorter than horizon+1 exists and was drawn).
int32_t v2a_store_sample_batch(const Store* s, int64_t batch, int64_t horizon,
                               uint64_t seed, uint8_t* out_obs,
                               uint8_t* out_goal, float* out_acts,
                               int64_t* out_ep_slots, int32_t n_threads) {
  if (!s || batch <= 0 || horizon <= 0) return -1;
  if (s->n_live == 0) return -2;

  // FIFO ring: live slots are the n_live most recent
  const int64_t n = s->n_live;
  const int64_t px = s->img_px();
  std::atomic<int32_t> status{0};

  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      uint64_t r1 = splitmix64(seed ^ (uint64_t)(2 * i));
      uint64_t r2 = splitmix64(seed ^ (uint64_t)(2 * i + 1));
      int64_t live_idx = (int64_t)bounded(r1, (uint64_t)n);
      // map live index -> slot (oldest-first ordering like the deque)
      int64_t slot =
          (s->n_live == s->max_episodes)
              ? (s->next_slot + live_idx) % s->max_episodes
              : live_idx;
      const Episode& ep = s->episodes[slot];
      if (ep.n_imgs <= horizon) {
        status.store(-3);
        return;
      }
      int64_t start = (int64_t)bounded(r2, (uint64_t)(ep.n_imgs - horizon));
      int64_t goal = start + horizon;
      std::memcpy(out_obs + i * px,
                  s->img_slab.data() + ep.img_off + start * px, (size_t)px);
      std::memcpy(out_goal + i * px,
                  s->img_slab.data() + ep.img_off + goal * px, (size_t)px);
      std::memcpy(out_acts + i * horizon * s->act_dim,
                  s->act_slab.data() + ep.act_off + start * s->act_dim,
                  (size_t)horizon * s->act_dim * sizeof(float));
      out_ep_slots[i] = slot;
    }
  };

  int64_t nt = std::max(1, (int32_t)std::min<int64_t>(
                               n_threads > 0 ? n_threads : 4, batch));
  if (nt == 1) {
    work(0, batch);
  } else {
    std::vector<std::thread> threads;
    int64_t per = (batch + nt - 1) / nt;
    for (int64_t t = 0; t < nt; ++t) {
      int64_t lo = t * per, hi = std::min(batch, lo + per);
      if (lo >= hi) break;
      threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
  }
  return status.load();
}

// Fetch one episode's length (images) by live index, -1 if out of range.
int64_t v2a_store_episode_len(const Store* s, int64_t live_idx) {
  if (!s || live_idx < 0 || live_idx >= s->n_live) return -1;
  int64_t slot = (s->n_live == s->max_episodes)
                     ? (s->next_slot + live_idx) % s->max_episodes
                     : live_idx;
  return s->episodes[slot].n_imgs;
}

// Copy one episode's payload out (for checkpointing). Buffers must hold
// n_imgs*h*w*c bytes and (n_imgs-1)*act_dim floats (query episode_len
// first). Returns 0 on success.
int32_t v2a_store_get_episode(const Store* s, int64_t live_idx,
                              uint8_t* out_imgs, float* out_acts) {
  if (!s || live_idx < 0 || live_idx >= s->n_live || !out_imgs || !out_acts)
    return -1;
  int64_t slot = (s->n_live == s->max_episodes)
                     ? (s->next_slot + live_idx) % s->max_episodes
                     : live_idx;
  const Episode& ep = s->episodes[slot];
  std::memcpy(out_imgs, s->img_slab.data() + ep.img_off,
              (size_t)ep.n_imgs * s->img_px());
  std::memcpy(out_acts, s->act_slab.data() + ep.act_off,
              (size_t)(ep.n_imgs - 1) * s->act_dim * sizeof(float));
  return 0;
}

}  // extern "C"
