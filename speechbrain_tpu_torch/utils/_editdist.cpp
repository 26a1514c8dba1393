// Native edit-distance core for WER accumulation (the port's copy of
// speechbrain_tpu/utils/_editdist.cpp).
//
// The reference computes WER with a per-utterance Python DP
// (edit_distance.py:146 op_table + backtrack); on large eval sets that
// is the post-decode bottleneck. This C++ core runs the same DP with
// the same tie-breaking (substitution preferred over insertion over
// deletion) and carries (ins, del, sub) counts forward per cell, which
// reproduces the backtracked path exactly. Calls release the GIL via
// ctypes and shard the batch across hardware threads.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread (editdist_native.py
// does it at first use, into speechbrain_tpu_torch/_build/).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Cell {
  int32_t cost;
  int32_t ins;
  int32_t del;
  int32_t sub;
};

void edit_ops_one(const int32_t* a, int64_t na, const int32_t* b, int64_t nb,
                  int32_t* out3) {
  std::vector<Cell> prev(nb + 1), cur(nb + 1);
  for (int64_t j = 0; j <= nb; ++j) {
    prev[j] = {static_cast<int32_t>(j), static_cast<int32_t>(j), 0, 0};
  }
  for (int64_t i = 1; i <= na; ++i) {
    cur[0] = {static_cast<int32_t>(i), 0, static_cast<int32_t>(i), 0};
    const int32_t ai = a[i - 1];
    for (int64_t j = 1; j <= nb; ++j) {
      if (ai == b[j - 1]) {
        cur[j] = prev[j - 1];
      } else {
        const int32_t ins_c = cur[j - 1].cost + 1;
        const int32_t del_c = prev[j].cost + 1;
        const int32_t sub_c = prev[j - 1].cost + 1;
        // tie-break: sub, then ins, then del (matches the Python DP)
        if (sub_c <= ins_c && sub_c <= del_c) {
          cur[j] = prev[j - 1];
          cur[j].cost = sub_c;
          cur[j].sub += 1;
        } else if (ins_c <= del_c) {
          cur[j] = cur[j - 1];
          cur[j].cost = ins_c;
          cur[j].ins += 1;
        } else {
          cur[j] = prev[j];
          cur[j].cost = del_c;
          cur[j].del += 1;
        }
      }
    }
    std::swap(prev, cur);
  }
  out3[0] = prev[nb].ins;
  out3[1] = prev[nb].del;
  out3[2] = prev[nb].sub;
}

}  // namespace

extern "C" {

// a_flat/b_flat: concatenated int32 token sequences; a_off/b_off:
// (n_pairs + 1) int64 offsets; out: n_pairs * 3 int32 (ins, del, sub).
void sb_edit_ops_batch(const int32_t* a_flat, const int64_t* a_off,
                       const int32_t* b_flat, const int64_t* b_off,
                       int64_t n_pairs, int32_t* out) {
  int n_threads =
      static_cast<int>(std::min<int64_t>(
          n_pairs, std::max(1u, std::thread::hardware_concurrency())));
  if (n_threads <= 1 || n_pairs < 8) {
    for (int64_t p = 0; p < n_pairs; ++p) {
      edit_ops_one(a_flat + a_off[p], a_off[p + 1] - a_off[p],
                   b_flat + b_off[p], b_off[p + 1] - b_off[p], out + 3 * p);
    }
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    pool.emplace_back([=]() {
      for (int64_t p = t; p < n_pairs; p += n_threads) {
        edit_ops_one(a_flat + a_off[p], a_off[p + 1] - a_off[p],
                     b_flat + b_off[p], b_off[p + 1] - b_off[p],
                     out + 3 * p);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
