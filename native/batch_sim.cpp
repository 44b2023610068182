// Batched gridworld simulator — native (C++) implementation of the sim
// contract, standing in for a Madrona-style external batch simulator
// (the reference's native engine lives out-of-repo and enters the trainer
// only as opaque step callables; reference: rollouts.py:905-947).
//
// Design: *stateless* step function — all state arrays are passed in and
// written out, so the JAX side can wrap it in a pure host callback and keep
// the training loop functionally pure (and checkpoint sim state as plain
// arrays). The layout matches envs/toy_env.py's target-chasing gridworld so
// the native and pure-JAX envs are interchangeable and cross-checkable.
//
// Parallelized over worlds with a simple thread pool (std::thread), since a
// production host-side simulator must feed an accelerator faster than
// Python could.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// xorshift128+ per-agent PRNG; deterministic across runs given the seed.
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    // splitmix64 init
    uint64_t z = seed + 0x9e3779b97f4a7c15ull;
    auto next = [&z]() {
      z += 0x9e3779b97f4a7c15ull;
      uint64_t x = z;
      x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
      x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
      return x ^ (x >> 31);
    };
    s0 = next();
    s1 = next();
  }
  uint64_t next() {
    uint64_t x = s0;
    uint64_t const y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  int32_t randint(int32_t lo, int32_t hi) {  // [lo, hi)
    return lo + static_cast<int32_t>(next() % static_cast<uint64_t>(hi - lo));
  }
};

const int32_t kMoves[5][2] = {{0, 0}, {0, 1}, {0, -1}, {1, 0}, {-1, 0}};

void step_range(int64_t begin, int64_t end, int32_t grid_size,
                int32_t episode_len, uint64_t seed,
                const int32_t* pos_in, const int32_t* tgt_in,
                const int32_t* t_in, const int32_t* rng_ctr_in,
                const int32_t* actions, const int32_t* resets,
                int32_t* pos_out, int32_t* tgt_out, int32_t* t_out,
                int32_t* rng_ctr_out, float* obs_delta, float* obs_time,
                float* rewards, uint8_t* dones) {
  for (int64_t i = begin; i < end; ++i) {
    int32_t px = pos_in[2 * i], py = pos_in[2 * i + 1];
    int32_t tx = tgt_in[2 * i], ty = tgt_in[2 * i + 1];
    int32_t t = t_in[i];

    int32_t old_dist = std::abs(tx - px) + std::abs(ty - py);
    int32_t a = actions[i];
    int32_t nx = std::clamp(px + kMoves[a][0], 0, grid_size - 1);
    int32_t ny = std::clamp(py + kMoves[a][1], 0, grid_size - 1);
    int32_t new_dist = std::abs(tx - nx) + std::abs(ty - ny);

    float reward = static_cast<float>(old_dist - new_dist);
    if (new_dist == 0) reward += 1.0f;

    t += 1;
    bool done = (t >= episode_len) || (resets[i] != 0);

    int64_t ctr = rng_ctr_in[i];
    if (done) {
      Rng rng(seed ^ (static_cast<uint64_t>(i) << 20) ^
              static_cast<uint64_t>(ctr));
      nx = rng.randint(0, grid_size);
      ny = rng.randint(0, grid_size);
      tx = rng.randint(0, grid_size);
      ty = rng.randint(0, grid_size);
      t = 0;
      ctr += 1;
    }

    pos_out[2 * i] = nx;
    pos_out[2 * i + 1] = ny;
    tgt_out[2 * i] = tx;
    tgt_out[2 * i + 1] = ty;
    t_out[i] = t;
    rng_ctr_out[i] = ctr;

    obs_delta[2 * i] = static_cast<float>(tx - nx) / grid_size;
    obs_delta[2 * i + 1] = static_cast<float>(ty - ny) / grid_size;
    obs_time[i] = static_cast<float>(t) / episode_len;
    rewards[i] = reward;
    dones[i] = done ? 1 : 0;
  }
}

void parallel_for(int64_t n, int num_threads,
                  const std::function<void(int64_t, int64_t)>& fn) {
  if (num_threads <= 1 || n < 4096) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    int64_t begin = t * chunk;
    int64_t end = std::min(n, begin + chunk);
    if (begin >= end) break;
    threads.emplace_back(fn, begin, end);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Initialize state arrays for `n` agents.
void batch_sim_init(int64_t n, int32_t grid_size, uint64_t seed,
                    int32_t* pos, int32_t* tgt, int32_t* t,
                    int32_t* rng_ctr, float* obs_delta, float* obs_time) {
  for (int64_t i = 0; i < n; ++i) {
    Rng rng(seed ^ (static_cast<uint64_t>(i) << 20) ^ 0xabcdef);
    pos[2 * i] = rng.randint(0, grid_size);
    pos[2 * i + 1] = rng.randint(0, grid_size);
    tgt[2 * i] = rng.randint(0, grid_size);
    tgt[2 * i + 1] = rng.randint(0, grid_size);
    t[i] = 0;
    rng_ctr[i] = 0;
    obs_delta[2 * i] =
        static_cast<float>(tgt[2 * i] - pos[2 * i]) / grid_size;
    obs_delta[2 * i + 1] =
        static_cast<float>(tgt[2 * i + 1] - pos[2 * i + 1]) / grid_size;
    obs_time[i] = 0.0f;
  }
}

// One batched step over all `n` agents (stateless: state in -> state out).
void batch_sim_step(int64_t n, int32_t grid_size, int32_t episode_len,
                    uint64_t seed, int32_t num_threads,
                    const int32_t* pos_in, const int32_t* tgt_in,
                    const int32_t* t_in, const int32_t* rng_ctr_in,
                    const int32_t* actions, const int32_t* resets,
                    int32_t* pos_out, int32_t* tgt_out, int32_t* t_out,
                    int32_t* rng_ctr_out, float* obs_delta, float* obs_time,
                    float* rewards, uint8_t* dones) {
  parallel_for(n, num_threads, [&](int64_t begin, int64_t end) {
    step_range(begin, end, grid_size, episode_len, seed, pos_in, tgt_in,
               t_in, rng_ctr_in, actions, resets, pos_out, tgt_out, t_out,
               rng_ctr_out, obs_delta, obs_time, rewards, dones);
  });
}

}  // extern "C"
