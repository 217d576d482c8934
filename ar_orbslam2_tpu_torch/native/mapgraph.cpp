// Native map-graph runtime for the TPU SLAM framework.
//
// The reference implements its map bookkeeping in C++ (MapPoint::
// ComputeDistinctiveDescriptors src/MapPoint.cc:~200, MapPoint::
// UpdateNormalAndDepth src/MapPoint.cc:~330, KeyFrame::UpdateConnections
// src/KeyFrame.cc:~330). In this framework the numeric hot paths live on
// the TPU, but this per-keyframe host bookkeeping is scalar pointer-
// chasing that numpy handles poorly (Python loop per landmark) — so it is
// native here too. The library operates zero-copy on the MapStore's numpy
// buffers through a C ABI (loaded with ctypes); semantics are kept
// bit-identical to the numpy fallbacks in mapstore/map.py, which double
// as the test oracle.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libmapgraph.so mapgraph.cpp
// (built + loaded by native/mapgraph.py; numpy fallbacks in mapstore/map.py
// are the test oracle — see tests/test_native_mapgraph.py)
#include <cstdint>
#include <cstring>
#include <climits>
#include <cmath>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

constexpr int kDescBytes = 32;

inline int hamming32(const uint8_t* a, const uint8_t* b) {
  uint64_t wa[4], wb[4];
  std::memcpy(wa, a, 32);
  std::memcpy(wb, b, 32);
  int d = 0;
  for (int i = 0; i < 4; ++i) d += __builtin_popcountll(wa[i] ^ wb[i]);
  return d;
}

// Parallel-for over [0, n) with a small thread pool; serial for tiny n.
template <typename F>
void parallel_for(int64_t n, F&& f) {
  const int64_t kGrain = 64;
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = static_cast<int>(std::min<int64_t>(
      hw ? hw : 1, (n + kGrain - 1) / kGrain));
  if (nthreads <= 1) {
    for (int64_t i = 0; i < n; ++i) f(i);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([lo, hi, &f] {
      for (int64_t i = lo; i < hi; ++i) f(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Representative descriptor per landmark: the observation descriptor with
// the minimum median Hamming distance to all other observations.
// Median matches np.median (mean of the two middles for even counts);
// comparisons use doubled medians to stay in integers.
void mg_distinctive_descriptors(
    const uint8_t* kf_desc,      // [K, P, 32]
    const int64_t* mp_obs_kf,    // [M, O]
    const int64_t* mp_obs_feat,  // [M, O]
    const int32_t* mp_nobs,      // [M]
    uint8_t* mp_desc,            // [M, 32] out
    const int64_t* mp_ids, int64_t n_ids,
    int64_t P, int64_t O) {
  parallel_for(n_ids, [&](int64_t ii) {
    const int64_t mp = mp_ids[ii];
    const int n = mp_nobs[mp];
    if (n <= 0) return;
    // buffers sized by O (the per-landmark observation capacity) so the
    // kernel stays bit-identical to the numpy oracle for any max_obs
    const int m = static_cast<int>(std::min<int64_t>(n, O));
    std::vector<const uint8_t*> descs(m);
    for (int i = 0; i < m; ++i) {
      int64_t kf = mp_obs_kf[mp * O + i];
      int64_t ft = mp_obs_feat[mp * O + i];
      descs[i] = kf_desc + (kf * P + ft) * kDescBytes;
    }
    std::vector<int> dist(m * m);
    for (int i = 0; i < m; ++i) {
      dist[i * m + i] = 0;
      for (int j = i + 1; j < m; ++j)
        dist[i * m + j] = dist[j * m + i] = hamming32(descs[i], descs[j]);
    }
    int best = 0;
    long best_med2 = LONG_MAX;
    std::vector<int> row(m);
    for (int i = 0; i < m; ++i) {
      std::memcpy(row.data(), dist.data() + i * m, m * sizeof(int));
      std::sort(row.begin(), row.end());
      long med2 = (m % 2) ? 2L * row[m / 2]
                          : (long)row[m / 2 - 1] + row[m / 2];
      if (med2 < best_med2) { best_med2 = med2; best = i; }
    }
    std::memcpy(mp_desc + mp * kDescBytes, descs[best], kDescBytes);
  });
}

// Mean viewing direction + scale-invariance distance band per landmark.
void mg_update_normal_and_depth(
    const int64_t* mp_obs_kf, const int64_t* mp_obs_feat,
    const int32_t* mp_nobs,
    const float* mp_pos,         // [M, 3]
    const float* kf_R,           // [K, 3, 3] (row-major, world->cam)
    const float* kf_t,           // [K, 3]
    const int32_t* kf_octave,    // [K, P]
    float* mp_normal, float* mp_dmin, float* mp_dmax,   // out
    const int64_t* mp_ids, int64_t n_ids,
    int64_t P, int64_t O,
    float scale_factor, int n_levels) {
  parallel_for(n_ids, [&](int64_t ii) {
    const int64_t mp = mp_ids[ii];
    const int n = mp_nobs[mp];
    if (n <= 0) return;
    const float* pos = mp_pos + mp * 3;
    double nx = 0, ny = 0, nz = 0;
    double ref_dist = 0;
    for (int i = 0; i < n; ++i) {
      int64_t kf = mp_obs_kf[mp * O + i];
      const float* R = kf_R + kf * 9;
      const float* t = kf_t + kf * 3;
      // camera center = -R^T t
      float cx = -(R[0] * t[0] + R[3] * t[1] + R[6] * t[2]);
      float cy = -(R[1] * t[0] + R[4] * t[1] + R[7] * t[2]);
      float cz = -(R[2] * t[0] + R[5] * t[1] + R[8] * t[2]);
      double dx = pos[0] - cx, dy = pos[1] - cy, dz = pos[2] - cz;
      double norm = std::sqrt(dx * dx + dy * dy + dz * dz);
      double inv = 1.0 / std::max(norm, 1e-9);
      nx += dx * inv; ny += dy * inv; nz += dz * inv;
      if (i == 0) ref_dist = norm;
    }
    nx /= n; ny /= n; nz /= n;
    double nn = std::max(std::sqrt(nx * nx + ny * ny + nz * nz), 1e-9);
    mp_normal[mp * 3 + 0] = static_cast<float>(nx / nn);
    mp_normal[mp * 3 + 1] = static_cast<float>(ny / nn);
    mp_normal[mp * 3 + 2] = static_cast<float>(nz / nn);
    int64_t kf0 = mp_obs_kf[mp * O];
    int64_t ft0 = mp_obs_feat[mp * O];
    int lvl = kf_octave[kf0 * P + ft0];
    float dmax = static_cast<float>(ref_dist * std::pow(scale_factor, lvl));
    mp_dmax[mp] = dmax;
    mp_dmin[mp] = dmax / std::pow(scale_factor, float(n_levels - 1));
  });
}

// Covisibility row refresh for one keyframe: count shared landmarks with
// every other keyframe via the observation table, gate at `th` (keeping
// all maxima if nothing passes), write the symmetric row/col, and set the
// spanning-tree parent on first connection.
void mg_update_connections(
    const int64_t* kf_mp,        // [K, P]
    const int64_t* mp_obs_kf,    // [M, O]
    const int32_t* mp_nobs,      // [M]
    int32_t* covis,              // [K, K] in/out
    int64_t* kf_parent,          // [K]    in/out
    int64_t kf, int64_t K, int64_t P, int64_t O, int th) {
  std::vector<int32_t> counts(K, 0);
  const int64_t* row_mp = kf_mp + kf * P;
  for (int64_t f = 0; f < P; ++f) {
    int64_t mp = row_mp[f];
    if (mp < 0) continue;
    const int n = mp_nobs[mp];
    const int64_t* obs = mp_obs_kf + mp * O;
    for (int i = 0; i < n; ++i) {
      int64_t other = obs[i];
      if (other >= 0 && other < K) counts[other]++;
    }
  }
  counts[kf] = 0;
  int32_t cmax = 0;
  for (int64_t k = 0; k < K; ++k) cmax = std::max(cmax, counts[k]);
  bool any_pass = false;
  for (int64_t k = 0; k < K; ++k) any_pass |= counts[k] >= th;
  int64_t best = -1;
  for (int64_t k = 0; k < K; ++k) {
    int32_t w;
    if (any_pass) w = counts[k] >= th ? counts[k] : 0;
    else w = (cmax > 0 && counts[k] == cmax) ? counts[k] : 0;
    covis[kf * K + k] = w;
    covis[k * K + kf] = w;
    if (w > 0 && (best < 0 || w > covis[kf * K + best])) best = k;
  }
  if (kf_parent[kf] < 0 && kf != 0 && best >= 0) {
    // parent = most covisible (first argmax, matching np.argmax)
    int32_t wbest = 0; int64_t arg = -1;
    for (int64_t k = 0; k < K; ++k)
      if (covis[kf * K + k] > wbest) { wbest = covis[kf * K + k]; arg = k; }
    if (arg >= 0) kf_parent[kf] = arg;
  }
}

// Batched all-pairs packed-descriptor Hamming (host-side oracle/helper):
// out[i*m + j] = popcount(a[i] ^ b[j]).
void mg_hamming_matrix(const uint8_t* a, int64_t n,
                       const uint8_t* b, int64_t m,
                       int32_t* out) {
  parallel_for(n, [&](int64_t i) {
    const uint8_t* ai = a + i * kDescBytes;
    for (int64_t j = 0; j < m; ++j)
      out[i * m + j] = hamming32(ai, b + j * kDescBytes);
  });
}

int mg_version() { return 1; }

}  // extern "C"
