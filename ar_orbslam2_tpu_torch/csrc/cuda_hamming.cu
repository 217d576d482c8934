// Windowed, gated Hamming top-2 search with reverse-best bookkeeping.
//
// Replaces the TPU kernel ar_orbslam2_tpu/ops/pallas_hamming.py::_kernel
// (launched by _pallas_top2, public entry fused_windowed_top2). Semantics,
// with INF = 257:
//
//   d(i,j) = popcount(q_i XOR k_j)  on the 256-bit descriptors, or INF
//            unless |u_i-u_j| <= r_i and |v_i-v_j| <= r_i (f32), olo_i <=
//            oct_j <= ohi_i, and both sides are valid;
//   per query row i:   d0 = min_j d(i,j), idx0 = first j attaining it,
//                      d1 = min over every column except idx0;
//   per keypoint col j: the column minimum and the first row attaining it,
//                      returned packed as (d << 16) | row in col_key (INT_MAX
//                      where every row is INF: the wrapper decodes that to
//                      (INF, row 0), which is what a column of INFs gives).
//
// What bounds it on an H100: at the main path's largest call (4096 queries
// x 1024 keypoints) the inputs are ~160 KB, so device-memory bandwidth is
// irrelevant; the work is 4M gated pairs, each an f32 window test and, when
// the gate passes, 8 XOR+popc on packed u32 words. It is instruction- and
// launch-bound. The design keeps everything on chip:
//
//   * descriptors are packed 8 x u32 (32 B) instead of the TPU's 256 int8
//     signs, so a distance is 8 __popc, not a 256-wide dot;
//   * a block stages a tile of KT keypoints (descriptors word-major, uv,
//     octave, valid) in shared memory; lanes of a warp read consecutive
//     keypoints, so the loads are conflict-free;
//   * one warp owns ROWS_PER_WARP query rows and keeps their descriptors and
//     a running (d0, idx0, d1) per lane in registers; each lane visits its
//     columns in increasing order, so "first index wins" holds per lane and
//     the final butterfly merge orders ties by index;
//   * the TPU kernel carried the column minimum across its sequential grid;
//     here blocks run in any order, so each block reduces its rows per column
//     in shared memory (atomicMin on (d << 16) | row: the lowest row wins a
//     tie), then one global atomicMin per column and block. Only gated-in
//     pairs (d < INF) reach the atomics.
//
// Any N (< 65536, so the row fits the key's low 16 bits) and any M >= 1; the
// ragged edges are masked here. Launch on the caller's stream; no sync, no
// allocation (the wrapper allocates every output).
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#define INF_D 257
#define SENTINEL (INF_D + 1)
#define WARPS 8
#define ROWS_PER_WARP 2
#define ROWS_PER_BLOCK (WARPS * ROWS_PER_WARP)
#define KT 512

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

__global__ void __launch_bounds__(WARPS * 32)
hamming_top2_kernel(const uint32_t* __restrict__ q_desc,
                    const float* __restrict__ q_uv,
                    const float* __restrict__ q_radius,
                    const int* __restrict__ q_olo,
                    const int* __restrict__ q_ohi,
                    const uint8_t* __restrict__ q_valid,
                    const uint32_t* __restrict__ k_desc,
                    const float* __restrict__ k_uv,
                    const int* __restrict__ k_oct,
                    const uint8_t* __restrict__ k_valid,
                    int n, int m,
                    int* __restrict__ idx0_out,
                    int* __restrict__ d0_out,
                    int* __restrict__ d1_out,
                    int* __restrict__ col_key) {
  __shared__ uint32_t s_desc[8][KT];
  __shared__ float s_u[KT];
  __shared__ float s_v[KT];
  __shared__ int s_oct[KT];
  __shared__ uint8_t s_valid[KT];
  __shared__ int s_col[KT];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row_base = blockIdx.x * ROWS_PER_BLOCK + warp * ROWS_PER_WARP;

  uint32_t q[ROWS_PER_WARP][8];
  float qu[ROWS_PER_WARP], qv[ROWS_PER_WARP], qr[ROWS_PER_WARP];
  int lo[ROWS_PER_WARP], hi[ROWS_PER_WARP];
  bool live[ROWS_PER_WARP];
  Top2 st[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int row = row_base + r;
    live[r] = row < n && q_valid[row] != 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) q[r][w] = live[r] ? q_desc[row * 8 + w] : 0u;
    qu[r] = live[r] ? q_uv[2 * row] : 0.f;
    qv[r] = live[r] ? q_uv[2 * row + 1] : 0.f;
    qr[r] = live[r] ? q_radius[row] : 0.f;
    lo[r] = live[r] ? q_olo[row] : 0;
    hi[r] = live[r] ? q_ohi[row] : 0;
    st[r].d0 = SENTINEL;
    st[r].i0 = INT_MAX;
    st[r].d1 = SENTINEL;
  }

  for (int t0 = 0; t0 < m; t0 += KT) {
    const int tn = min(KT, m - t0);
    __syncthreads();  // the previous tile is fully consumed
    for (int j = threadIdx.x; j < KT; j += blockDim.x) {
      if (j < tn) {
        const int g = t0 + j;
#pragma unroll
        for (int w = 0; w < 8; ++w) s_desc[w][j] = k_desc[g * 8 + w];
        s_u[j] = k_uv[2 * g];
        s_v[j] = k_uv[2 * g + 1];
        s_oct[j] = k_oct[g];
        s_valid[j] = k_valid[g];
      }
      s_col[j] = INT_MAX;
    }
    __syncthreads();

    for (int j = lane; j < tn; j += 32) {
      uint32_t kd[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) kd[w] = s_desc[w][j];
      const float ku = s_u[j], kv = s_v[j];
      const int ko = s_oct[j];
      const bool kval = s_valid[j] != 0;
      int best_key = INT_MAX;
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        if (!live[r]) continue;
        int d = INF_D;
        if (kval && fabsf(qu[r] - ku) <= qr[r] && fabsf(qv[r] - kv) <= qr[r]
            && ko >= lo[r] && ko <= hi[r]) {
          int c = 0;
#pragma unroll
          for (int w = 0; w < 8; ++w) c += __popc(q[r][w] ^ kd[w]);
          d = c;
          best_key = min(best_key, (d << 16) | (row_base + r));
        }
        top2_push(st[r], d, t0 + j);
      }
      if (best_key != INT_MAX) atomicMin(&s_col[j], best_key);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < tn; j += blockDim.x) {
      const int v = s_col[j];
      if (v != INT_MAX) atomicMin(&col_key[t0 + j], v);
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
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
      if (s.d0 > INF_D) {  // invalid row: every column is INF
        s.d0 = INF_D;
        s.i0 = 0;
      }
      idx0_out[row] = s.i0;
      d0_out[row] = s.d0;
      d1_out[row] = min(s.d1, INF_D);
    }
  }
}

extern "C" int hamming_top2_launch(const void* q_desc, const void* q_uv,
                                   const void* q_radius, const void* q_olo,
                                   const void* q_ohi, const void* q_valid,
                                   const void* k_desc, const void* k_uv,
                                   const void* k_oct, const void* k_valid,
                                   int n, int m, void* idx0_out,
                                   void* d0_out, void* d1_out, void* col_key,
                                   void* stream) {
  if (n > 0 && m > 0) {
    dim3 grid((n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
    hamming_top2_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)q_desc, (const float*)q_uv, (const float*)q_radius,
        (const int*)q_olo, (const int*)q_ohi, (const uint8_t*)q_valid,
        (const uint32_t*)k_desc, (const float*)k_uv, (const int*)k_oct,
        (const uint8_t*)k_valid, n, m, (int*)idx0_out, (int*)d0_out,
        (int*)d1_out, (int*)col_key);
  }
  return (int)cudaGetLastError();
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
