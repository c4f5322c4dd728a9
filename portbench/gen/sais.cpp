// Frozen copy of the SA-IS suffix sorter and the occurrence-checkpoint
// builder of native/bwbble_native.cpp, kept with the benchmark so that the
// index of a benchmark world never changes with the program's native code.
//
// bwbble_tpu native runtime: SA-IS suffix-array construction and FM-index
// occurrence-checkpoint construction.
//
// Fresh implementation of the SA-IS induced-sorting algorithm
// (G. Nong, S. Zhang, W. H. Chan, "Two Efficient Algorithms for Linear Time
// Suffix Array Construction", 2009).  Plays the role of the reference's
// in-RAM suffix sorter (mg-aligner/is.c) for index construction; the query
// path runs on TPU and never calls into this library.
//
// Exposed via a C ABI for ctypes (see bwbble_tpu/native.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>
#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#endif

namespace {

// Core SA-IS over an integer string whose last character is the unique
// smallest symbol (a sentinel).  SA receives the full suffix array.
template <typename I>
void sais_core(const I* s, I* SA, I n, I K) {
  if (n == 1) {
    SA[0] = 0;
    return;
  }
  const I EMPTY = static_cast<I>(-1);

  // Suffix types: 1 = S-type (suffix smaller than its right neighbor).
  std::vector<uint8_t> st(n);
  st[n - 1] = 1;
  for (I i = n - 2; i >= 0; --i)
    st[i] = (s[i] < s[i + 1] || (s[i] == s[i + 1] && st[i + 1])) ? 1 : 0;
  auto is_lms = [&](I i) { return i > 0 && st[i] && !st[i - 1]; };

  std::vector<I> bkt(K);
  auto fill_buckets = [&](bool ends) {
    std::fill(bkt.begin(), bkt.end(), I(0));
    for (I i = 0; i < n; ++i) bkt[s[i]]++;
    I sum = 0;
    for (I k = 0; k < K; ++k) {
      sum += bkt[k];
      bkt[k] = ends ? sum : sum - bkt[k];
    }
  };

  auto induce = [&]() {
    // induce L-type from bucket heads (left to right)
    fill_buckets(false);
    for (I i = 0; i < n; ++i) {
      I j = SA[i];
      if (j != EMPTY && j > 0 && !st[j - 1]) SA[bkt[s[j - 1]]++] = j - 1;
    }
    // induce S-type from bucket ends (right to left)
    fill_buckets(true);
    for (I i = n - 1; i >= 0; --i) {
      I j = SA[i];
      if (j != EMPTY && j > 0 && st[j - 1]) SA[--bkt[s[j - 1]]] = j - 1;
    }
  };

  // Stage 1: sort LMS substrings by one induced pass.
  std::fill(SA, SA + n, EMPTY);
  fill_buckets(true);
  for (I i = 1; i < n; ++i)
    if (is_lms(i)) SA[--bkt[s[i]]] = i;
  induce();

  // Compact the (now sorted) LMS positions to the front.
  I n1 = 0;
  for (I i = 0; i < n; ++i)
    if (is_lms(SA[i])) SA[n1++] = SA[i];

  // Stage 2: name LMS substrings to build the reduced problem.
  std::fill(SA + n1, SA + n, EMPTY);
  I name = 0, prev = EMPTY;
  for (I i = 0; i < n1; ++i) {
    I pos = SA[i];
    bool differs = (prev == EMPTY);
    if (!differs) {
      for (I d = 0;; ++d) {
        if (s[pos + d] != s[prev + d] || st[pos + d] != st[prev + d]) {
          differs = true;
          break;
        }
        if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) break;
      }
    }
    if (differs) {
      ++name;
      prev = pos;
    }
    SA[n1 + pos / 2] = name - 1;
  }
  for (I i = n - 1, j = n - 1; i >= n1; --i)
    if (SA[i] != EMPTY) SA[j--] = SA[i];

  // Stage 3: solve the reduced problem (recurse only if names repeat).
  I* SA1 = SA;
  I* s1 = SA + n - n1;
  if (name < n1) {
    sais_core<I>(s1, SA1, n1, name);
  } else {
    for (I i = 0; i < n1; ++i) SA1[s1[i]] = i;
  }

  // Stage 4: place LMS suffixes in their final order and induce the rest.
  for (I i = 1, j = 0; i < n; ++i)
    if (is_lms(i)) s1[j++] = i;           // LMS positions in text order
  for (I i = 0; i < n1; ++i) SA1[i] = s1[SA1[i]];
  std::fill(SA + n1, SA + n, EMPTY);
  fill_buckets(true);
  for (I i = n1 - 1; i >= 0; --i) {
    I j = SA[i];
    SA[i] = EMPTY;
    SA[--bkt[s[j]]] = j;
  }
  induce();
}

template <typename I>
int sais_u8_impl(const uint8_t* T, int64_t* SA_out, int64_t n) {
  // Append an explicit sentinel (shift symbols by +1 so 0 is unique minimum).
  std::vector<I> s(n + 1);
  for (int64_t i = 0; i < n; ++i) s[i] = static_cast<I>(T[i]) + 1;
  s[n] = 0;
  std::vector<I> SA(n + 1);
  sais_core<I>(s.data(), SA.data(), static_cast<I>(n + 1), I(257));
  // SA[0] is the sentinel suffix; drop it.
  for (int64_t i = 0; i < n; ++i) SA_out[i] = static_cast<int64_t>(SA[i + 1]);
  return 0;
}

}  // namespace

extern "C" {
// Suffix array of T[0..n-1] (bytes).  SA receives n entries.
int bwbble_sais_u8(const uint8_t* T, int64_t* SA, int64_t n) {
  if (n <= 0) return 0;
  if (n + 1 < (int64_t{1} << 31))
    return sais_u8_impl<int32_t>(T, SA, n);
  return sais_u8_impl<int64_t>(T, SA, n);
}

// Occurrence checkpoints for a 16-symbol BWT: out[k*16 + c] = number of
// occurrences of c in bwt[0 .. k*interval] (inclusive), skipping the sa0
// sentinel row (semantics of mg-aligner/bwt.c:280-291).
void bwbble_build_occ(const uint8_t* bwt, int64_t n, int64_t sa0,
                      int64_t interval, int64_t* out) {
  int64_t counts[16] = {0};
  int64_t k = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (i != sa0) counts[bwt[i]]++;
    if (i % interval == 0) {
      std::memcpy(out + k * 16, counts, sizeof(counts));
      ++k;
    }
  }
}

}  // extern "C"
