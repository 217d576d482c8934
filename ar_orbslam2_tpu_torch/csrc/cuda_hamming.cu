// Windowed, gated Hamming search: top-2 per query, reverse-best per keypoint,
// threshold / Lowe-ratio / mutual-best filter — one launch for the whole
// function, for a batch of independent searches.
//
// Replaces the TPU kernel ar_orbslam2_tpu/ops/pallas_hamming.py::_kernel
// (launched by _pallas_top2) together with the filter its public entry
// fused_windowed_top2 applies around it. Semantics, with INF = 257:
//
//   d(i,j) = popcount(q_i XOR k_j)  on the 256-bit descriptors, or INF
//            unless |u_i-u_j| <= r_i and |v_i-v_j| <= r_i (f32), olo_i <=
//            oct_j <= ohi_i, and both sides are valid;
//   per query row i:   d0 = min_j d(i,j), idx0 = first j attaining it,
//                      d1 = min over every column except idx0;
//   per keypoint col j: the column minimum and the first row attaining it,
//                      kept packed as (d << 16) | row (INT_MAX where every
//                      row is INF, which decodes to (INF, row 0));
//   filtered output:   idx_i = idx0 if d0 <= th and d0 <= nn_ratio * d1
//                      (f32), and, with `mutual`, if row i is the first row
//                      attaining column idx0's minimum; else -1. d0 as above.
//   raw output:        idx0, d0, d1 per row and (d, row) per column, for the
//                      bit-exact comparison with the plain version.
//
// What bounds it on an H100: at the main path's largest call (4096 queries
// x 1024 keypoints) the inputs are ~210 KB and the outputs 32 KB, so device
// memory is irrelevant; the work is 4M window tests and, on the main path's
// data, a popcount for a fraction of a percent of them. It is bound by the
// launch, by staging the keypoints on chip and by the latency of the window
// tests' sweep. The design:
//
//   * one launch is the whole function. Blocks publish their column minima
//     with atomicMin into a persistent workspace (shared memory first, one
//     global atomic per column and block); every block then arrives at a
//     device-wide counter behind __threadfence, and the LAST block to arrive
//     runs the mutual-best pass over all rows, then resets the column keys
//     and the counter, so the next call needs no fill kernel before it. A
//     second tiny kernel would cost another launch (and another graph node)
//     for ~1 us of work; without `mutual` no block touches the workspace;
//   * a scalar radius and "no octave gate" are arguments (null pointers), so
//     callers build no constant tensors;
//   * keypoints are staged ONCE per block: descriptors (32 B each) and uv go
//     to shared memory with 16-byte cp.async copies, descriptors swizzled
//     (the two 16-byte halves of keypoint j swap when bit 2 of j is set) so
//     that a quarter-warp's 16-byte reads of consecutive keypoints hit
//     distinct banks; octave and validity are merged into one word (an
//     invalid keypoint gets an octave no window admits);
//   * the window test runs on uv and octave alone; the descriptor is read
//     and the 8 XOR+popc run only where it passes;
//   * a warp owns RPW query rows (descriptors and running top-2 in
//     registers) and its lanes sweep the keypoints in increasing order, so
//     "first index wins" holds per lane and the butterfly merge orders ties
//     by index; the lowest row wins a column tie through the packed key;
//   * 16 warps and 16*RPW rows per block, RPW in {1, 2, 4} chosen by the
//     launcher so that a 4096-row search is one wave of 128 blocks on the
//     132 SMs (the keypoints are staged 128 times instead of 256) while
//     smaller searches still spread over 64-128 SMs. The kernel is a chain
//     of latencies (launch, query loads, staging, a 32-step sweep, fence,
//     arrival, two dependent loads in the mutual pass), not of throughput:
//     16 warps hide more of it than 8 and make the mutual pass of 4096 rows
//     one step of 512 threads x 8 rows; 32 warps gain 1 us at 4096 rows and
//     lose 1 us at 1024 and 10 us on a batch of 5 (eval/tune_hamming.py);
//   * grid.y is the batch: B searches that share shapes. Query descriptors,
//     query geometry and keypoints are each either stacked per batch or
//     shared by all.
//
// Any N (< 65536 per search, so the row fits the key's low 16 bits) and any
// M >= 1; ragged edges are masked and pointers that are not 16-byte aligned
// are staged with plain loads. Launch on the caller's stream; no sync, no
// allocation (the wrapper allocates outputs and owns the workspace).
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#define INF_D 257
// Tunables (eval/tune_hamming.py builds and times other values with -D).
#ifndef WARPS
#define WARPS 16                // warps per block
#endif
#ifndef SCAN_UNROLL
#define SCAN_UNROLL 4           // keypoints per lane in flight in the sweep
#endif
#define THREADS (WARPS * 32)
constexpr int kScanUnroll = SCAN_UNROLL;  // #pragma takes no macro
#define KT 1024                 // keypoints staged per tile
#define TAIL_ROWS 8             // rows per thread in flight in the mutual pass
#define SMEM_PER_KP 48          // 32 B descriptor, 8 B uv, octave, column key

struct Params {
  const uint32_t* q_desc;
  const float* q_uv;
  const float* q_radius;        // null: `radius` for every row
  const int* q_olo;             // null (with q_ohi): no octave gate
  const int* q_ohi;
  const uint8_t* q_valid;
  const uint32_t* k_desc;
  const float* k_uv;
  const int* k_oct;
  const uint8_t* k_valid;
  int n, m, tile;
  int qd_stride, qg_stride, k_stride;   // rows per batch item, 0 = shared
  float radius, th, nn_ratio;
  int mutual, raw;
  int* idx_out;                 // (B, n): filtered idx, or idx0 when raw
  int* d0_out;                  // (B, n)
  int* d1_out;                  // (B, n), raw only
  int* kp_best_d;               // (B, m), raw only
  int* kp_best_q;               // (B, m), raw only
  int* col_key;                 // workspace (B, m), INT_MAX between calls
  unsigned int* counter;        // workspace (B,), 0 between calls
};

struct Top2 {
  int d0, i0, d1;
};

__device__ __forceinline__ void top2_push(Top2& s, int d, int j) {
  if (d < s.d0) {
    s.d1 = s.d0;
    s.d0 = d;
    s.i0 = j;
  } else if (d < s.d1) {
    s.d1 = d;
  }
}

__device__ __forceinline__ Top2 top2_merge(Top2 a, Top2 b) {
  bool a_first = (a.d0 < b.d0) || (a.d0 == b.d0 && a.i0 < b.i0);
  Top2 w = a_first ? a : b;
  int loser_d0 = a_first ? b.d0 : a.d0;
  w.d1 = min(w.d1, loser_d0);
  return w;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  unsigned int dst = (unsigned int)__cvta_generic_to_shared(smem_dst);
  size_t gsrc = __cvta_generic_to_global(src);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gsrc) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// index of 16-byte half c (0/1) of keypoint j's descriptor in shared memory
__device__ __forceinline__ int desc_chunk(int j, int c) {
  return 2 * j + (c ^ ((j >> 2) & 1));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (((uintptr_t)p) & 15) == 0;
}

template <int RPW>
__global__ void __launch_bounds__(THREADS)
hamming_search_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* s_desc = reinterpret_cast<uint4*>(smem);
  float2* s_uv = reinterpret_cast<float2*>(smem + 32 * p.tile);
  int* s_oct = reinterpret_cast<int*>(smem + 40 * p.tile);
  int* s_col = reinterpret_cast<int*>(smem + 44 * p.tile);
  __shared__ int s_last;

  const int n = p.n, m = p.m, tile = p.tile;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row_base = blockIdx.x * (WARPS * RPW) + warp * RPW;
  const bool need_cols = p.mutual || p.raw;

  const uint32_t* q_desc = p.q_desc + (size_t)b * p.qd_stride * 8;
  const size_t qg = (size_t)b * p.qg_stride;
  const size_t kb = (size_t)b * p.k_stride;
  const uint32_t* k_desc = p.k_desc + kb * 8;
  const float* k_uv = p.k_uv + kb * 2;
  const int* k_oct = p.k_oct + kb;
  const uint8_t* k_valid = p.k_valid + kb;
  int* col_key = p.col_key + (size_t)b * m;
  int* idx_out = p.idx_out + (size_t)b * n;
  int* d0_out = p.d0_out + (size_t)b * n;

  uint32_t q[RPW][8];
  float qu[RPW], qv[RPW], qr[RPW];
  int lo[RPW], hi[RPW];
  Top2 st[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    // every load of the row starts at once (a row past the end reads the
    // last row): none waits for the validity flag
    const int row = min(row_base + r, n - 1);
    const bool live = row_base + r < n && p.q_valid[qg + row] != 0;
    const uint4* qd = reinterpret_cast<const uint4*>(q_desc + (size_t)row * 8);
    if (aligned16(q_desc)) {
      const uint4 a = __ldg(qd), c = __ldg(qd + 1);
      q[r][0] = a.x; q[r][1] = a.y; q[r][2] = a.z; q[r][3] = a.w;
      q[r][4] = c.x; q[r][5] = c.y; q[r][6] = c.z; q[r][7] = c.w;
    } else {
#pragma unroll
      for (int w = 0; w < 8; ++w) q[r][w] = q_desc[(size_t)row * 8 + w];
    }
    qu[r] = p.q_uv[2 * (qg + row)];
    qv[r] = p.q_uv[2 * (qg + row) + 1];
    const float rad = p.q_radius ? p.q_radius[qg + row] : p.radius;
    // INT_MIN is the staged octave of an invalid keypoint: keep lo above it
    lo[r] = p.q_olo ? max(p.q_olo[qg + row], INT_MIN + 1) : INT_MIN + 1;
    hi[r] = p.q_ohi ? p.q_ohi[qg + row] : INT_MAX;
    // a dead row gets a radius no distance passes
    qr[r] = live ? rad : -1.f;
    st[r].d0 = INF_D;
    st[r].i0 = INT_MAX;
    st[r].d1 = INF_D;
  }

  for (int t0 = 0; t0 < m; t0 += tile) {
    const int tn = min(tile, m - t0);
    if (t0 > 0) __syncthreads();  // the previous tile is consumed and flushed
    {  // descriptors: 2 * tn chunks of 16 bytes, swizzled
      const uint32_t* g = k_desc + (size_t)t0 * 8;
      if (aligned16(g)) {
        for (int i = threadIdx.x; i < 2 * tn; i += THREADS)
          cp_async16(&s_desc[desc_chunk(i >> 1, i & 1)], g + 4 * i);
      } else {
        uint32_t* sw = reinterpret_cast<uint32_t*>(s_desc);
        for (int i = threadIdx.x; i < 8 * tn; i += THREADS) {
          const int j = i >> 3, w = i & 7;
          sw[4 * desc_chunk(j, w >> 2) + (w & 3)] = g[i];
        }
      }
    }
    {  // uv: tn pairs, two per 16-byte chunk
      const float* g = k_uv + (size_t)t0 * 2;
      const int vec = aligned16(g) ? (tn >> 1) : 0;
      for (int i = threadIdx.x; i < vec; i += THREADS)
        cp_async16(&s_uv[2 * i], g + 4 * i);
      for (int i = 2 * vec + threadIdx.x; i < tn; i += THREADS)
        s_uv[i] = make_float2(g[2 * i], g[2 * i + 1]);
    }
    for (int j = threadIdx.x; j < tn; j += THREADS) {
      s_oct[j] = k_valid[t0 + j] ? k_oct[t0 + j] : INT_MIN;
      s_col[j] = INT_MAX;
    }
    cp_async_wait_all();
    __syncthreads();

#pragma unroll kScanUnroll
    for (int j = lane; j < tn; j += 32) {
      const float2 kuv = s_uv[j];
      const int ko = s_oct[j];
      int best_key = INT_MAX;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        if (fabsf(qu[r] - kuv.x) <= qr[r] && fabsf(qv[r] - kuv.y) <= qr[r]
            && ko >= lo[r] && ko <= hi[r]) {
          const uint4 a = s_desc[desc_chunk(j, 0)];
          const uint4 c = s_desc[desc_chunk(j, 1)];
          const int d = __popc(q[r][0] ^ a.x) + __popc(q[r][1] ^ a.y)
                      + __popc(q[r][2] ^ a.z) + __popc(q[r][3] ^ a.w)
                      + __popc(q[r][4] ^ c.x) + __popc(q[r][5] ^ c.y)
                      + __popc(q[r][6] ^ c.z) + __popc(q[r][7] ^ c.w);
          top2_push(st[r], d, t0 + j);
          best_key = min(best_key, (d << 16) | (row_base + r));
        }
      }
      if (need_cols && best_key != INT_MAX) atomicMin(&s_col[j], best_key);
    }
    if (need_cols) {
      __syncthreads();
      for (int j = threadIdx.x; j < tn; j += THREADS) {
        const int v = s_col[j];
        if (v != INT_MAX) atomicMin(&col_key[t0 + j], v);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    Top2 s = st[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Top2 o;
      o.d0 = __shfl_xor_sync(0xffffffffu, s.d0, off);
      o.i0 = __shfl_xor_sync(0xffffffffu, s.i0, off);
      o.d1 = __shfl_xor_sync(0xffffffffu, s.d1, off);
      s = top2_merge(s, o);
    }
    const int row = row_base + r;
    if (lane == 0 && row < n) {
      if (s.d0 >= INF_D) s.i0 = 0;  // every column INF: the first one
      d0_out[row] = s.d0;
      if (p.raw) {
        idx_out[row] = s.i0;
        p.d1_out[(size_t)b * n + row] = s.d1;
      } else {
        const float f0 = (float)s.d0;
        const bool ok = f0 <= p.th && f0 <= p.nn_ratio * (float)s.d1;
        idx_out[row] = ok ? s.i0 : -1;
      }
    }
  }
  if (!need_cols) return;

  // arrive; the last block of this batch item finishes the function
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int prev = atomicAdd(&p.counter[b], 1u);
    s_last = (prev == gridDim.x - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  if (p.raw) {
    int* best_d = p.kp_best_d + (size_t)b * m;
    int* best_q = p.kp_best_q + (size_t)b * m;
    for (int j = threadIdx.x; j < m; j += THREADS) {
      const int key = __ldcg(&col_key[j]);
      const bool unset = key == INT_MAX;
      best_d[j] = unset ? INF_D : (key >> 16);
      best_q[j] = unset ? 0 : (key & 0xFFFF);
      col_key[j] = INT_MAX;
    }
  } else {
    // mutual-best: keep row i only if it is the first row attaining its
    // column's minimum. TAIL_ROWS rows per thread in flight.
    for (int i0 = threadIdx.x; i0 < n; i0 += TAIL_ROWS * THREADS) {
      int c[TAIL_ROWS], key[TAIL_ROWS];
#pragma unroll
      for (int u = 0; u < TAIL_ROWS; ++u) {
        const int i = i0 + u * THREADS;
        c[u] = i < n ? __ldcg(&idx_out[i]) : -1;
      }
#pragma unroll
      for (int u = 0; u < TAIL_ROWS; ++u)
        key[u] = c[u] >= 0 ? __ldcg(&col_key[c[u]]) : INT_MAX;
#pragma unroll
      for (int u = 0; u < TAIL_ROWS; ++u) {
        const int i = i0 + u * THREADS;
        if (c[u] >= 0) {
          const int back = key[u] == INT_MAX ? -2 : (key[u] & 0xFFFF);
          if (back != i) idx_out[i] = -1;
        }
      }
    }
    __syncthreads();  // every key is read before the reset
    for (int j = threadIdx.x; j < m; j += THREADS) col_key[j] = INT_MAX;
  }
  if (threadIdx.x == 0) p.counter[b] = 0u;
}

template <int RPW>
static cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {  // a full tile plus the flag exceeds the 48 KB default
    cudaError_t err = cudaFuncSetAttribute(
        hamming_search_kernel<RPW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, KT * SMEM_PER_KP);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int rows = WARPS * RPW;
  dim3 grid((p.n + rows - 1) / rows, batch);
  hamming_search_kernel<RPW>
      <<<grid, THREADS, p.tile * SMEM_PER_KP, stream>>>(p);
  return cudaGetLastError();
}

// One windowed search (or `batch` of them) on `stream`. Null q_radius: the
// scalar `radius`; null q_olo/q_ohi: no octave gate. `*_batched` say which
// of query descriptors, query geometry (uv, radius, octaves, valid) and
// keypoints are stacked per batch item. raw != 0: unfiltered outputs (idx0,
// d0, d1, kp_best_d, kp_best_q); else idx/d0 after threshold, ratio and, with
// `mutual`, the mutual-best test. col_key/counter: the workspace, needed
// when mutual or raw. Returns the CUDA error code (0 on success).
extern "C" int hamming_search_launch(
    const void* q_desc, const void* q_uv, const void* q_radius,
    const void* q_olo, const void* q_ohi, const void* q_valid,
    const void* k_desc, const void* k_uv, const void* k_oct,
    const void* k_valid, int n, int m, int batch, int qd_batched,
    int qg_batched, int k_batched, float radius, float th, float nn_ratio,
    int mutual, int raw, void* idx_out, void* d0_out, void* d1_out,
    void* kp_best_d, void* kp_best_q, void* col_key, void* counter,
    void* stream) {
  if (n <= 0 || m <= 0 || batch <= 0) return (int)cudaGetLastError();
  Params p;
  p.q_desc = (const uint32_t*)q_desc;
  p.q_uv = (const float*)q_uv;
  p.q_radius = (const float*)q_radius;
  p.q_olo = (const int*)q_olo;
  p.q_ohi = (const int*)q_ohi;
  p.q_valid = (const uint8_t*)q_valid;
  p.k_desc = (const uint32_t*)k_desc;
  p.k_uv = (const float*)k_uv;
  p.k_oct = (const int*)k_oct;
  p.k_valid = (const uint8_t*)k_valid;
  p.n = n;
  p.m = m;
  p.tile = min(KT, (m + 3) & ~3);
  p.qd_stride = qd_batched ? n : 0;
  p.qg_stride = qg_batched ? n : 0;
  p.k_stride = k_batched ? m : 0;
  p.radius = radius;
  p.th = th;
  p.nn_ratio = nn_ratio;
  p.mutual = mutual;
  p.raw = raw;
  p.idx_out = (int*)idx_out;
  p.d0_out = (int*)d0_out;
  p.d1_out = (int*)d1_out;
  p.kp_best_d = (int*)kp_best_d;
  p.kp_best_q = (int*)kp_best_q;
  p.col_key = (int*)col_key;
  p.counter = (unsigned int*)counter;
  const long long rows = (long long)n * batch;
  cudaStream_t s = (cudaStream_t)stream;
  // about 128 blocks where the rows allow it: one wave on the 132 SMs
  cudaError_t err = rows >= 128 * WARPS * 4 ? launch<4>(p, batch, s)
                  : rows >= 128 * WARPS * 2 ? launch<2>(p, batch, s)
                                            : launch<1>(p, batch, s);
  return (int)err;
}

// Host helper for the graph runner (system/graph.py): the number of nodes
// of a captured CUDA graph, given its cudaGraph_t handle. Returns the CUDA
// error code (0 on success).
extern "C" int cuda_graph_node_count(void* graph, unsigned long long* count) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &n);
  *count = (unsigned long long)n;
  return (int)err;
}
