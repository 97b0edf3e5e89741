// Native host-side data-pipeline loops (a copy of
// pytorchrec_tpu/native/fastrec.cpp for the port), built with g++ and loaded
// through ctypes (native/__init__.py).
//
// The numpy history in pytorchrec_tpu_torch/data/process/history.py
// (_history_matrix) is the plain version; tests hold the two equal.
//
//   fastrec_neg_sample   - per-row rejection sampling of negative item ids
//                          against a sorted (uid*K + iid) positive-key set
//                          (xoshiro256** stream; the readers' "fast"
//                          sampling mode).
//   fastrec_history      - per-row preceding-event history matrix, fixed
//                          length k, first column = true length, optionally
//                          inclusive (next-state variant, s' includes the
//                          current event).

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// --- splitmix64/xoshiro256** PRNG (public-domain algorithm) ----------------
struct Xoshiro {
  uint64_t s[4];
};

static uint64_t splitmix64(uint64_t &x) {
  uint64_t z = (x += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

static void seed_xoshiro(Xoshiro &rng, uint64_t seed) {
  for (int i = 0; i < 4; i++) rng.s[i] = splitmix64(seed);
}

static inline uint64_t rotl(uint64_t x, int k) {
  return (x << k) | (x >> (64 - k));
}

static inline uint64_t next_u64(Xoshiro &rng) {
  uint64_t *s = rng.s;
  const uint64_t result = rotl(s[1] * 5, 7) * 9;
  const uint64_t t = s[1] << 17;
  s[2] ^= s[0];
  s[3] ^= s[1];
  s[1] ^= s[2];
  s[0] ^= s[3];
  s[2] ^= t;
  s[3] = rotl(s[3], 45);
  return result;
}

// uniform integer in [lo, hi) by rejection (unbiased)
static inline int64_t next_range(Xoshiro &rng, int64_t lo, int64_t hi) {
  uint64_t span = (uint64_t)(hi - lo);
  uint64_t limit = UINT64_MAX - (UINT64_MAX % span);
  uint64_t v;
  do {
    v = next_u64(rng);
  } while (v >= limit);
  return lo + (int64_t)(v % span);
}

// binary search membership in a sorted int64 array
static inline bool contains(const int64_t *keys, int64_t n, int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = lo + ((hi - lo) >> 1);
    if (keys[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < n && keys[lo] == key;
}

// Per-row negative sampling: out[i] = random iid in [lo, hi) such that
// (uids[i]*K + out[i]) is not in pos_keys. K = hi (the vocab bound).
void fastrec_neg_sample(const int32_t *uids, int64_t n_rows, int64_t lo,
                        int64_t hi, const int64_t *pos_keys,
                        int64_t n_pos_keys, uint64_t seed, int32_t *out) {
  Xoshiro rng;
  seed_xoshiro(rng, seed);
  for (int64_t i = 0; i < n_rows; i++) {
    int64_t base = (int64_t)uids[i] * hi;
    int64_t candidate;
    do {
      candidate = next_range(rng, lo, hi);
    } while (contains(pos_keys, n_pos_keys, base + candidate));
    out[i] = (int32_t)candidate;
  }
}

// Preceding-event history per interaction row.
//   uids/iids/events: length n_rows, rows pre-sorted by (uid, time) -- the
//     canonical interaction order. events[i] nonzero = the row belongs to the
//     tracked stream (e.g. positives).
//   k: history length; inclusive: snapshot AFTER appending the current row
//     (the RL next-state variant, interaction_next_state_list.py:46-52).
//   out: [n_rows, k+1] int32, col 0 = min(events so far, k), cols 1..k = the
//     last k tracked ids, right-padded with 0 (matches
//     data/process/history.py::_history_matrix exactly).
void fastrec_history(const int32_t *uids, const int32_t *iids,
                     const uint8_t *events, int64_t n_rows, int64_t k,
                     int32_t inclusive, int32_t *out) {
  std::vector<int32_t> window;  // rolling last-k ids for the current user
  window.reserve((size_t)k);
  int64_t total = 0;  // uncapped count for the current user
  int32_t current_uid = INT32_MIN;
  for (int64_t i = 0; i < n_rows; i++) {
    if (uids[i] != current_uid) {
      current_uid = uids[i];
      window.clear();
      total = 0;
    }
    int32_t *row = out + i * (k + 1);
    if (inclusive && events[i]) {
      if ((int64_t)window.size() == k) window.erase(window.begin());
      window.push_back(iids[i]);
      total++;
    }
    row[0] = (int32_t)(total < k ? total : k);
    int64_t m = (int64_t)window.size();
    for (int64_t j = 0; j < k; j++) row[1 + j] = j < m ? window[j] : 0;
    if (!inclusive && events[i]) {
      if ((int64_t)window.size() == k) window.erase(window.begin());
      window.push_back(iids[i]);
      total++;
    }
  }
}

}  // extern "C"
