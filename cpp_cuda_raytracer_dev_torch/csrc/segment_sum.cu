// Per-id sums of cotangent rows, read through their sort order: the
// backward of the packed row gather (ops/gather.py).
//
// Replaces the JAX package's Pallas kernel `_segsum_kernel` in
// cpp_cuda_raytracer_dev_tpu/ops/gather.py (launched by
// `_segment_sum_pallas`). Contract: block (R, F) f32 row-major, F <= 16;
// order (R,) i64 or null; idx (R,) i32 ascending, every id in [0, T).
// Row i of the sorted sequence is block[order[i]] (block[i] when order is
// null) and has id idx[i]. out (T, F) f32, zeroed by the caller, gets
// out[id] = the sum of the rows with that id; ids with no rows stay 0.
// The stable sort that gives idx and order stays outside, as the JAX
// package's argsort does.
//
// The TPU kernel summed with one-hot matrix products over a bf16 hi/lo
// split of the cotangents; here every sum is plain fp32 on the CUDA cores.
//
// Design (deterministic, balanced, no float atomics, one pass over the
// rows): the sorted sequence is cut into runs of kRun = 512 rows, one CTA
// of 128 threads per run, 4 consecutive rows a thread. A thread gathers
// its rows through `order`, each a 48-byte row as three 16-byte loads, and
// keeps every feature of them in registers. One segmented scan carries all
// F features at once: each thread sums its rows from its last segment head,
// a warp scan with shuffles and a scan over the 4 warp totals (the one
// barrier) carry the open segment across threads, and the thread that holds
// a segment's last row has its sum.
//   - A segment with both ends inside the run has exactly one writer and
//     is stored straight to out[id].
//   - The run's first and last segments may continue into the neighbours.
//     They go, with their ids, to a partials table of 2 rows per run (a run
//     that is one segment writes it as (id, sum) and (id, 0)). The table is
//     sorted by id again, so the same kernel runs on it, without an order,
//     as the next level.
//   - A level of one run has no neighbours and writes every segment.
// 518,400 rows take three levels (1,013 runs, then 4, then 1). The order
// of every addition is fixed by the row order, so the result is bitwise
// the same from run to run. One long segment (every miss pixel gathers
// triangle 0) costs no more than any other rows: it is cut across runs.
//
// Bound: bytes. It reads R (4 F + 4 + 8) B (rows, ids, order) and writes
// T 4 F B: 518,400 x 60 B + 800,130 x 48 B, about 69.5 MB, about 21 us at
// 3.35 TB/s. The adds are R F, a few microseconds of FP32 issue.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerThread = 4;
constexpr int kRun = kThreads * kRowsPerThread;
constexpr int kWarps = kThreads / 32;

// kQ = ceil(F / 4): the registers hold 4 kQ features a row.
template <int kQ>
__global__ void __launch_bounds__(kThreads)
segment_sum_level(const float* __restrict__ vals,       // (rows, f)
                  const long long* __restrict__ order,  // (n_rows,) or null
                  const int* __restrict__ ids,          // (n_rows,) ascending
                  int n_rows, int f, int vec, int final_level,
                  float* __restrict__ out,              // (T, f)
                  int* __restrict__ part_id,            // (2 * runs,)
                  float* __restrict__ part_val) {       // (2 * runs, f)
  constexpr int kW = 4 * kQ;
  __shared__ float w_val[kWarps][kW];
  __shared__ int w_flag[kWarps];

  const int run = blockIdx.x;
  const long long r0 = (long long)run * kRun;
  const int n = (int)min((long long)kRun, n_rows - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = tid * kRowsPerThread;

  // this thread's rows j0 .. j0 + 3 of the run (those below n): ids, head
  // flags (row j > 0 heads a segment when its id differs from row j - 1's)
  // and features
  int id[kRowsPerThread];
  bool head[kRowsPerThread];
  float x[kRowsPerThread][kW];
  int prev = j0 > 0 && j0 <= n ? ids[r0 + j0 - 1] : 0;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int j = j0 + k;
    id[k] = j < n ? ids[r0 + j] : 0;
    head[k] = j > 0 && j < n && id[k] != prev;
    prev = id[k];
    if (j >= n) {
#pragma unroll
      for (int c = 0; c < kW; ++c) x[k][c] = 0.f;
      continue;
    }
    const long long row = order ? order[r0 + j] : r0 + j;
    const float* src = vals + row * f;
    if (vec) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 v = q * 4 < f ? __ldg(reinterpret_cast<const float4*>(src) + q)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
        x[k][4 * q] = v.x;
        x[k][4 * q + 1] = v.y;
        x[k][4 * q + 2] = v.z;
        x[k][4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < kW; ++c) x[k][c] = c < f ? __ldg(src + c) : 0.f;
    }
  }
  const int next = j0 + kRowsPerThread < n ? ids[r0 + j0 + kRowsPerThread] : 0;

  // the thread's (flag, value): any head in its rows, and per feature the
  // sum from its last head (or its first row) to its last row
  float v[kW];
  int fl = 0;
#pragma unroll
  for (int c = 0; c < kW; ++c) v[c] = 0.f;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    if (j0 + k >= n) break;
    fl |= head[k];
#pragma unroll
    for (int c = 0; c < kW; ++c) v[c] = head[k] ? x[k][c] : v[c] + x[k][c];
  }
  // inclusive scan in thread order under
  // (fa, va) + (fb, vb) = (fa | fb, fb ? vb : va + vb), every feature at once
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int fu = __shfl_up_sync(0xffffffffu, fl, o);
    float vu[kW];
#pragma unroll
    for (int c = 0; c < kW; ++c) vu[c] = __shfl_up_sync(0xffffffffu, v[c], o);
    if (lane >= o) {
      if (!fl) {
#pragma unroll
        for (int c = 0; c < kW; ++c) v[c] = vu[c] + v[c];
      }
      fl |= fu;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < kW; ++c) w_val[warp][c] = v[c];
    w_flag[warp] = fl;
  }
  __syncthreads();
  // exclusive prefix: the earlier warps' totals, then the earlier lanes'
  float s[kW];
  int cf = 0;
#pragma unroll
  for (int c = 0; c < kW; ++c) s[c] = 0.f;
  for (int w = 0; w < warp; ++w) {
#pragma unroll
    for (int c = 0; c < kW; ++c) s[c] = w_flag[w] ? w_val[w][c] : s[c] + w_val[w][c];
    cf |= w_flag[w];
  }
  const int pf = __shfl_up_sync(0xffffffffu, fl, 1);
#pragma unroll
  for (int c = 0; c < kW; ++c) {
    const float pv = __shfl_up_sync(0xffffffffu, v[c], 1);
    if (lane > 0) s[c] = pf ? pv : s[c] + pv;
  }
  if (lane > 0) cf |= pf;

  // walk the rows again; close each segment at its last row
  bool first_seg = !cf;                      // the segment holds row 0
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int j = j0 + k;
    if (j >= n) break;
    if (head[k]) first_seg = false;
#pragma unroll
    for (int c = 0; c < kW; ++c) s[c] = head[k] ? x[k][c] : s[c] + x[k][c];
    const bool last_seg = j == n - 1;
    const int id_next = k + 1 < kRowsPerThread ? id[(k + 1) % kRowsPerThread] : next;
    if (!last_seg && id_next == id[k]) continue;
    float* dst;
    if (final_level || !(first_seg || last_seg)) {
      dst = out + (size_t)id[k] * f;
    } else if (first_seg) {
      dst = part_val + (size_t)(2 * run) * f;
      part_id[2 * run] = id[k];
      if (last_seg) {                        // the run is one segment
        for (int c = 0; c < f; ++c) part_val[(size_t)(2 * run + 1) * f + c] = 0.f;
        part_id[2 * run + 1] = id[k];
      }
    } else {
      dst = part_val + (size_t)(2 * run + 1) * f;
      part_id[2 * run + 1] = id[k];
    }
    if (vec) {
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        if (q * 4 < f)
          reinterpret_cast<float4*>(dst)[q] =
              make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
    } else {
#pragma unroll
      for (int c = 0; c < kW; ++c)
        if (c < f) dst[c] = s[c];
    }
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

template <int kQ>
cudaError_t run_levels(const float* vals, const long long* order,
                       const int* ids, int n, int f, float* out, int* pid,
                       float* pval, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  while (true) {
    const int runs = (n + kRun - 1) / kRun;
    const int final_level = runs == 1;
    const int vec = f % 4 == 0 && aligned(vals) && aligned(out) && aligned(pval);
    segment_sum_level<kQ><<<runs, kThreads, 0, stream>>>(
        vals, order, ids, n, f, vec, final_level, out, pid, pval);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || final_level) return e;
    vals = pval;                             // the partials, in id order
    order = nullptr;
    ids = pid;
    n = 2 * runs;
    pid += n;
    pval += (size_t)n * f;
  }
}

}  // namespace

// Rows of the partials table that `segment_sum_launch` needs for R rows.
extern "C" long long segment_sum_scratch_rows(long long r_rows) {
  return scratch_rows(r_rows);
}

extern "C" int segment_sum_launch(const void* block, const void* order,
                                  const void* idx, int r_rows, int f,
                                  void* out, void* part_id, void* part_val,
                                  void* stream) {
  const float* vals = static_cast<const float*>(block);
  const long long* ord = static_cast<const long long*>(order);
  const int* ids = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  int* pid = static_cast<int*>(part_id);
  float* pval = static_cast<float*>(part_val);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((f + 3) / 4) {
    case 1: return (int)run_levels<1>(vals, ord, ids, r_rows, f, o, pid, pval, s);
    case 2: return (int)run_levels<2>(vals, ord, ids, r_rows, f, o, pid, pval, s);
    case 3: return (int)run_levels<3>(vals, ord, ids, r_rows, f, o, pid, pval, s);
    case 4: return (int)run_levels<4>(vals, ord, ids, r_rows, f, o, pid, pval, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
