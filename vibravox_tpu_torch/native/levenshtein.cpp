// Levenshtein edit operations and distance (C++), the port's copy of
// vibravox_tpu/native/levenshtein.cpp.
//
// The PER metric and the phonemizer confusion analysis run Levenshtein
// alignment over every (prediction, target) pair of a test epoch
// (reference: python-Levenshtein via vibravox/utils.py:256-331).
// vibravox_tpu_torch/metrics/text.py binds these functions with ctypes; a
// failed build raises there, and its Python DP is the tests' twin.
//
// Ops match the python implementation exactly: codes 0=replace, 1=insert,
// 2=delete with (pred_idx, target_idx) positions, emitted in order.

#include <cstdint>
#include <vector>

extern "C" {

// Returns the number of ops written (<= max_ops), or -1 on overflow.
// a/b are unicode codepoint arrays; out receives triples (op, i, j).
int levenshtein_editops(const uint32_t* a, int la, const uint32_t* b, int lb,
                        int32_t* out, int max_ops) {
  std::vector<int32_t> dist((la + 1) * (lb + 1));
  const int w = lb + 1;
  for (int i = 0; i <= la; ++i) dist[i * w] = i;
  for (int j = 0; j <= lb; ++j) dist[j] = j;
  for (int i = 1; i <= la; ++i) {
    const uint32_t ai = a[i - 1];
    for (int j = 1; j <= lb; ++j) {
      const int cost = (ai == b[j - 1]) ? 0 : 1;
      int best = dist[(i - 1) * w + j] + 1;            // delete
      const int ins = dist[i * w + (j - 1)] + 1;       // insert
      if (ins < best) best = ins;
      const int rep = dist[(i - 1) * w + (j - 1)] + cost;  // replace/match
      if (rep < best) best = rep;
      dist[i * w + j] = best;
    }
  }
  // backtrace (same tie-breaking order as the python reference impl)
  int i = la, j = lb, n = 0;
  std::vector<int32_t> rev;
  rev.reserve(dist[la * w + lb] * 3);
  while (i > 0 || j > 0) {
    if (i > 0 && j > 0 && dist[i * w + j] == dist[(i - 1) * w + (j - 1)] &&
        a[i - 1] == b[j - 1]) {
      --i; --j;
    } else if (i > 0 && j > 0 && dist[i * w + j] == dist[(i - 1) * w + (j - 1)] + 1) {
      rev.push_back(j - 1); rev.push_back(i - 1); rev.push_back(0);  // replace
      --i; --j; ++n;
    } else if (i > 0 && dist[i * w + j] == dist[(i - 1) * w + j] + 1) {
      rev.push_back(j); rev.push_back(i - 1); rev.push_back(2);      // delete
      --i; ++n;
    } else {
      rev.push_back(j - 1); rev.push_back(i); rev.push_back(1);      // insert
      --j; ++n;
    }
  }
  if (n > max_ops) return -1;
  for (int k = 0; k < n; ++k) {
    out[3 * k + 0] = rev[3 * (n - 1 - k) + 2];
    out[3 * k + 1] = rev[3 * (n - 1 - k) + 1];
    out[3 * k + 2] = rev[3 * (n - 1 - k) + 0];
  }
  return n;
}

// Corpus-level edit distance (no backtrace): total edits over many pairs.
int levenshtein_distance(const uint32_t* a, int la, const uint32_t* b, int lb) {
  std::vector<int32_t> prev(lb + 1), cur(lb + 1);
  for (int j = 0; j <= lb; ++j) prev[j] = j;
  for (int i = 1; i <= la; ++i) {
    cur[0] = i;
    const uint32_t ai = a[i - 1];
    for (int j = 1; j <= lb; ++j) {
      const int cost = (ai == b[j - 1]) ? 0 : 1;
      int best = prev[j] + 1;
      if (cur[j - 1] + 1 < best) best = cur[j - 1] + 1;
      if (prev[j - 1] + cost < best) best = prev[j - 1] + cost;
      cur[j] = best;
    }
    std::swap(prev, cur);
  }
  return prev[lb];
}

}  // extern "C"
