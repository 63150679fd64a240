// Per-id sums of cotangent rows sorted by id: the backward of the packed
// row gather (ops/gather.py).
//
// Replaces the JAX package's Pallas kernel `_segsum_kernel` in
// cpp_cuda_raytracer_dev_tpu/ops/gather.py (launched by
// `_segment_sum_pallas`). Contract: block (R, F) f32 row-major, rows sorted
// by idx (R,) i32 ascending, every id in [0, T); out (T, F) f32, zeroed by
// the caller, gets out[id] = sum of the rows with that id. Ids with no rows
// stay 0.
//
// The TPU kernel summed with one-hot matrix products over a bf16 hi/lo
// split of the cotangents; here every sum is plain fp32 on the CUDA cores.
//
// Design (deterministic, balanced, no float atomics): the rows are cut
// into runs of kRun = 512 rows, one CTA per run. A CTA stages its run in
// shared memory and does a segmented scan over it, feature by feature:
// each thread sums its 4 rows, a warp scan with shuffles and a scan over
// the 4 warp totals carry the open segment across threads, and the thread
// that holds a segment's last row has its sum.
//   - A segment with both ends inside the run has exactly one writer and
//     is stored straight to out[id].
//   - The run's first and last segments may continue into the neighbours.
//     They go, with their ids, to a partials table of 2 rows per run (a run
//     that is one segment writes it as (id, sum) and (id, 0)). The table is
//     sorted by id again, so the same kernel runs on it as the next level.
//   - A level of one run has no neighbours and writes every segment.
// 518,400 rows take three levels (1,013 runs, then 4, then 1). The order
// of every addition is fixed by the row order, so the result is bitwise
// the same from run to run. One long segment (every miss pixel gathers
// triangle 0) costs no more than any other rows: it is cut across runs.
//
// Bound: bytes. It reads R (F + 1) 4 B and writes T F 4 B: 518,400 x 52 B
// + 800,130 x 48 B, about 65 MB, about 20 us at 3.35 TB/s. The adds are
// R F, a few microseconds of FP32 issue.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerThread = 4;
constexpr int kRun = kThreads * kRowsPerThread;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
segment_sum_level(const float* __restrict__ vals,   // (n_rows, f)
                  const int* __restrict__ ids,      // (n_rows,) ascending
                  int n_rows, int f, int final_level,
                  float* __restrict__ out,          // (T, f)
                  int* __restrict__ part_id,        // (2 * runs,)
                  float* __restrict__ part_val) {   // (2 * runs, f)
  extern __shared__ float sv[];                     // kRun * f values
  __shared__ int sid[kRun];
  __shared__ float w_val[kWarps];
  __shared__ int w_flag[kWarps];

  const int run = blockIdx.x;
  const size_t r0 = (size_t)run * kRun;
  const int n = min(kRun, (int)(n_rows - r0));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < n; i += kThreads) sid[i] = ids[r0 + i];
  const float* src = vals + r0 * f;
  for (int i = tid; i < n * f; i += kThreads) sv[i] = src[i];
  __syncthreads();

  // this thread's rows [j0, j1); row j > 0 heads a segment when its id
  // differs from row j - 1's
  const int j0 = tid * kRowsPerThread;
  const int j1 = min(j0 + kRowsPerThread, n);
  int any_head = 0;
  for (int j = max(j0, 1); j < j1; ++j) any_head |= sid[j] != sid[j - 1];

  for (int c = 0; c < f; ++c) {
    // the thread's (flag, value): any head in its rows, and the sum from
    // its last head (or its first row) to its last row
    float v = 0.f;
    for (int j = j0; j < j1; ++j) {
      const float x = sv[j * f + c];
      v = (j > 0 && sid[j] != sid[j - 1]) ? x : v + x;
    }
    // inclusive scan in thread order under
    // (fa, va) + (fb, vb) = (fa | fb, fb ? vb : va + vb)
    int fl = any_head;
    for (int o = 1; o < 32; o <<= 1) {
      const float vu = __shfl_up_sync(0xffffffffu, v, o);
      const int fu = __shfl_up_sync(0xffffffffu, fl, o);
      if (lane >= o) {
        if (!fl) v = vu + v;
        fl |= fu;
      }
    }
    if (lane == 31) {
      w_val[warp] = v;
      w_flag[warp] = fl;
    }
    __syncthreads();
    // exclusive prefix: the earlier warps' totals, then the earlier lanes'
    float cv = 0.f;
    int cf = 0;
    for (int w = 0; w < warp; ++w) {
      cv = w_flag[w] ? w_val[w] : cv + w_val[w];
      cf |= w_flag[w];
    }
    const float pv = __shfl_up_sync(0xffffffffu, v, 1);
    const int pf = __shfl_up_sync(0xffffffffu, fl, 1);
    if (lane > 0) {
      cv = pf ? pv : cv + pv;
      cf |= pf;
    }

    // walk the rows again; close each segment at its last row
    float s = cv;
    bool first_seg = !cf;                 // the segment holds row 0
    for (int j = j0; j < j1; ++j) {
      const float x = sv[j * f + c];
      if (j > 0 && sid[j] != sid[j - 1]) {
        s = x;
        first_seg = false;
      } else {
        s = s + x;
      }
      const bool last_seg = j == n - 1;
      if (!last_seg && sid[j + 1] == sid[j]) continue;
      const int id = sid[j];
      if (final_level || !(first_seg || last_seg)) {
        out[(size_t)id * f + c] = s;
      } else if (first_seg) {
        part_val[(size_t)(2 * run) * f + c] = s;
        if (c == 0) part_id[2 * run] = id;
        if (last_seg) {                   // the run is one segment
          part_val[(size_t)(2 * run + 1) * f + c] = 0.f;
          if (c == 0) part_id[2 * run + 1] = id;
        }
      } else {
        part_val[(size_t)(2 * run + 1) * f + c] = s;
        if (c == 0) part_id[2 * run + 1] = id;
      }
    }
    __syncthreads();                      // w_val / w_flag reused
  }
}

long long scratch_rows(long long n) {
  long long total = 0;
  while (n > kRun) {
    n = 2 * ((n + kRun - 1) / kRun);
    total += n;
  }
  return total;
}

}  // namespace

// Rows of the partials table that `segment_sum_launch` needs for R rows.
extern "C" long long segment_sum_scratch_rows(long long r_rows) {
  return scratch_rows(r_rows);
}

extern "C" int segment_sum_launch(const void* block, const void* idx,
                                  int r_rows, int f, void* out,
                                  void* part_id, void* part_val,
                                  void* stream) {
  const size_t smem = (size_t)kRun * f * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        segment_sum_level, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float* vals = static_cast<const float*>(block);
  const int* ids = static_cast<const int*>(idx);
  int* pid = static_cast<int*>(part_id);
  float* pval = static_cast<float*>(part_val);
  int n = r_rows;
  while (true) {
    const int runs = (n + kRun - 1) / kRun;
    const int final_level = runs == 1;
    segment_sum_level<<<runs, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        vals, ids, n, f, final_level, static_cast<float*>(out), pid, pval);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || final_level) return (int)e;
    vals = pval;
    ids = pid;
    n = 2 * runs;
    pid += n;
    pval += (size_t)n * f;
  }
}
