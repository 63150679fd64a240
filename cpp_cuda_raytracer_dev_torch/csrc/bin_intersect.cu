// Nearest hit per primary ray over a tile's depth-sorted entry blocks.
//
// Replaces the JAX package's Pallas kernel `_kernel` in
// cpp_cuda_raytracer_dev_tpu/ops/pallas/bin_kernel3.py (launched by
// `pallas_bin_intersect3`). What it computes, per tile t and ray r of the
// tile, over the blocks b = starts[t] / chunk .. (starts[t+1] - 1) / chunk
// (one block for an empty tile), in order, and within block b over the
// tile's own entries [max(s0, b chunk), min(s1, (b + 1) chunk)) only
// (s0 = starts[t], s1 = starts[t+1]):
//
//   gate:   skip block b when  min depth(own entries of b)
//                                >= max_r min(best_r, bound_r)
//   MT:     det = A.d, u' = B.d, v' = C.d
//           accept when min(u' det, v' det, (det - u' - v') det,
//                           TD det - eps det^2) >= 0 and det^2 >= (k1 eps)^2
//           t = TD / det
//   select: within a block the lowest triangle id at the minimum t;
//           across blocks the best changes only on a strictly smaller t.
//
// The JAX kernel scans whole blocks, the neighbouring tiles' entries that
// share the tile's first and last block included (2.4x the pairs on the
// headline frame). Binning is conservative, so those entries cannot hit
// the tile's rays; the two walks can differ only where two triangles give
// exactly the same t (ROADMAP F9).
//
// Telemetry switch (kernel K3 of the JAX package, `_kernel` in
// ops/pallas/bin_kernel2.py, launched by `pallas_bin_intersect2`;
// `aligned_walk_kernel`): the walk of the JAX kernels, over whole blocks.
// With esub > 1 each block is scanned as esub slices of chunk / esub
// entries, each with its own gate (which sees the previous slices' hits);
// the select rules above then hold per slice. When `steps` is not null the
// kernel also writes steps[t] = [slices scanned, blocks walked] per tile.
//
// Design of both walks (K1 `own_walk_kernel`, K3 `aligned_walk_kernel`):
//   - One CTA per tile, `groups` groups of p / R threads (4 groups of 128
//     at 16x32 tiles, two CTAs an SM at <= 64 registers); each thread holds
//     R rays (R = 4 at 16x32 tiles) with their running best in registers,
//     and every group holds all of the tile's rays. The groups split each
//     block's (K3: slice's) entries, entry k to group k mod groups; the
//     per-ray (t, id) minima of the groups meet in shared memory, where the
//     lexicographic minimum gives the within-block rule exactly in any
//     order, and every group then applies the across-block rule.
//   - Entries are staged as interleaved 12-word records (A | B | C | TD |
//     depth | id), so one thread reads an entry with three 16-byte shared
//     loads that serve all of its R rays.
//   - Double buffering: the next block's entries (K1: own entries) are
//     copied with cp.async while the current one is scanned.
//   - Longest tiles first: CTA i takes the i-th tile in descending order of
//     own entries in buckets of 64 (K1) or of blocks in range (K3), so the
//     long tiles do not form the tail; `longest_first_kernel`, one CTA
//     launched before the walk, writes the order.
//   - With a draw distance <= 3e38 (every caller's), a rejected entry can
//     never win (its t, 3e38, is never below the running best), so only
//     accepted entries take part in the select; an infinite draw distance
//     takes the instance in which every entry takes part.
//   - K3's gates: the slice's minimum depth is one warp reduction of
//     per-32-entry minima, which each block's depth row gives from device
//     memory while its copy is in flight, so the barrier that publishes the
//     block's records publishes them too; the running maximum of
//     min(best, bound) is one warp reduction of the warps' maxima, written
//     after each slice's merge and published by the next barrier the walk
//     has (the next slice's, or the next block's records barrier). A block
//     costs one barrier, and each scanned slice one more (two when another
//     slice of the block follows).
//
// Bound: FP32 issue. A ray-entry pair costs 29 FP32 operations: 24
// multiplies, adds and subtracts (three 3-term dots, 15; det^2, 1; the
// four acceptance terms, 8) and the five acceptance tests; the select (two
// comparisons) and the division run on accepted pairs only, 3 operations
// more each. K3's bound counts its own pairs, over whole slices, at the
// same rates. Built with -fmad=false, each is its own instruction, so the
// issue rate (128 lanes an SM a clock) is the limit; the FMA peak counts
// two operations a lane. Each block is read from device memory once per
// tile: bytes are far from the limit.
//
// Numerics: build with -fmad=false and without fast math, so every product
// and sum rounds as the plain PyTorch version's separate operations do and
// t = TD / det is IEEE division; the two agree bit for bit. eps,
// (k1 eps)^2 and the draw distance arrive as float32 arguments.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kRows = 11;          // A(3) | B(3) | C(3) | TD | depth
constexpr int kRec = 12;           // a staged entry: the 11 rows and the id
constexpr float kMissT = 3.0e38f;  // t of a rejected entry
constexpr float kTinyDet = 1e-30f;
constexpr int kThreads = 512;      // the largest CTA of K1
constexpr int kWideThreads = 1024; // of K3

__device__ __forceinline__ float warp_min(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The ray-entry test: whether the entry is accepted, and its det (an
// accepted entry's t is TD / det).
__device__ __forceinline__ bool mt_accept(float dx, float dy, float dz,
                                          float a0, float a1, float a2,
                                          float b0, float b1, float b2,
                                          float c0, float c1, float c2,
                                          float td, float eps, float eps2_det,
                                          float* det_out) {
  const float det = dx * a0 + dy * a1 + dz * a2;
  const float up = dx * b0 + dy * b1 + dz * b2;
  const float vp = dx * c0 + dy * c1 + dz * c2;
  const float dd2 = det * det;
  *det_out = det;
  return (up * det >= 0.f) && (vp * det >= 0.f)
      && ((det - up - vp) * det >= 0.f)
      && (td * det - eps * dd2 >= 0.f) && (dd2 >= eps2_det);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of the entries [lo, hi) into records 0 .. hi - lo - 1.
__device__ __forceinline__ void stage(float* slab, const float* geom,
                                      const int* entry_tri, int epad, int lo,
                                      int hi) {
  for (int k = threadIdx.x; k < hi - lo; k += blockDim.x) {
    float* rec = slab + k * kRec;
    const size_t e = (size_t)lo + k;
#pragma unroll
    for (int row = 0; row < kRows; ++row)
      cp_async4(rec + row, geom + (size_t)row * epad + e);
    cp_async4(rec + kRows, entry_tri + e);
  }
  cp_async_commit();
}

// order[i] = the tile that CTA i takes: the tiles in descending order of
// own entries counted in buckets of 64 (K1), or of blocks in range (K3), by
// a counting sort in one CTA, O(n_tiles). The order within a bucket follows
// the atomics; each tile's result does not depend on it.
template <bool kByBlocks>
__global__ void __launch_bounds__(1024)
longest_first_kernel(const int* __restrict__ starts, int n_tiles, int chunk,
                     int* __restrict__ order) {
  constexpr int kBuckets = 32;
  __shared__ int at[kBuckets];
  const auto bucket = [&](int t) {
    const int s0 = starts[t], s1 = starts[t + 1];
    const int n = kByBlocks ? (s1 > s0 ? (s1 - 1) / chunk - s0 / chunk + 1 : 1)
                            : (s1 - s0) >> 6;
    return min(n, kBuckets - 1);
  };
  if (threadIdx.x < kBuckets) at[threadIdx.x] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) atomicAdd(&at[bucket(t)], 1);
  __syncthreads();
  if (threadIdx.x == 0) {                    // each bucket's first slot
    for (int b = kBuckets - 1, n = 0; b >= 0; --b) {
      const int c = at[b];
      at[b] = n;
      n += c;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x)
    order[atomicAdd(&at[bucket(t)], 1)] = t;
}

// One entry group's share of the records [k0, k1) of a slab: the records
// k0 + grp, k0 + grp + groups, ... against the thread's R rays. Returns the
// group's (t, id) per ray, (inf, INT_MAX) where no entry took part.
template <int R, bool kAllEntries>
__device__ __forceinline__ void scan_records(const float* __restrict__ slab,
                                             int k0, int k1, int grp,
                                             int groups, const float* dx,
                                             const float* dy, const float* dz,
                                             float eps, float eps2_det,
                                             float* bt, int* bi) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    bt[j] = __int_as_float(0x7f800000);
    bi[j] = INT_MAX;
  }
  for (int k = k0 + grp; k < k1; k += groups) {
    const float4* rec = reinterpret_cast<const float4*>(slab + k * kRec);
    const float4 e0 = rec[0], e1 = rec[1], e2 = rec[2];
    const int id = __float_as_int(e2.w);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float det;
      const bool ok = mt_accept(dx[j], dy[j], dz[j], e0.x, e0.y, e0.z,
                                e0.w, e1.x, e1.y, e1.z, e1.w, e2.x, e2.y,
                                eps, eps2_det, &det);
      if (!kAllEntries && !ok) continue;
      const float tt = ok ? e2.y / (det == 0.f ? kTinyDet : det) : kMissT;
      if (tt < bt[j] || (tt == bt[j] && id < bi[j])) {
        bt[j] = tt;
        bi[j] = id;
      }
    }
  }
}

// The groups' (t, id) per ray meet in shared memory (one barrier); every
// group takes the lexicographic minimum over them, the within-block (or
// within-slice) rule in any order, and applies the across-block rule: the
// best changes only on a strictly smaller t, and then take_id(j, id).
template <int R, typename TakeId>
__device__ __forceinline__ void merge_groups(float* __restrict__ red_t,
                                             int* __restrict__ red_i, int p,
                                             int groups, int grp, int lane_r,
                                             int per_group, const float* bt,
                                             const int* bi, float* best,
                                             TakeId take_id) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int ray = grp * p + lane_r + j * per_group;
    red_t[ray] = bt[j];
    red_i[ray] = bi[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int ray = lane_r + j * per_group;
    float t = red_t[ray];
    int id = red_i[ray];
    for (int q = 1; q < groups; ++q) {
      const float tq = red_t[q * p + ray];
      const int iq = red_i[q * p + ray];
      if (tq < t || (tq == t && iq < id)) {
        t = tq;
        id = iq;
      }
    }
    if (t < best[j]) {
      best[j] = t;
      take_id(j, id);
    }
  }
}

// Per-32-entry minima of a block's depth row, read from device memory:
// seg[i] = min depth[32 i, 32 i + 32) for i < ceil(chunk / 32). Each warp
// takes whole runs of 32.
__device__ __forceinline__ void depth_minima(float* __restrict__ seg,
                                             const float* __restrict__ depth,
                                             int chunk) {
  const int n = (chunk + 31) & ~31;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float d = warp_min(k < chunk ? depth[k] : __int_as_float(0x7f800000));
    if ((threadIdx.x & 31) == 0) seg[k >> 5] = d;
  }
}

// This warp's max_r min(best_r, bound_r) over its threads' rays, into
// w_max[warp]; bound_of(j) is the bound of the thread's ray j.
template <int R, typename BoundOf>
__device__ __forceinline__ void publish_wmax(float* w_max, const float* best,
                                             BoundOf bound_of) {
  float v = fminf(best[0], bound_of(0));
#pragma unroll
  for (int j = 1; j < R; ++j) v = fmaxf(v, fminf(best[j], bound_of(j)));
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) w_max[threadIdx.x >> 5] = v;
}

// Kernel K3: the aligned walk over whole blocks in n_slices gated slices,
// with the CTA of K1 (see the header). Writes steps[t] = [slices scanned,
// blocks walked] when steps is not null. Without overlap each block is
// copied just before its scan.
template <int R, bool kAllEntries>
__global__ void __launch_bounds__(kWideThreads, 1)
aligned_walk_kernel(const float4* __restrict__ rays,    // (nT, P) [d, bound]
                    const float* __restrict__ geom,     // (11, epad)
                    const int* __restrict__ entry_tri,  // (epad,)
                    const int* __restrict__ starts,     // (nT + 1,)
                    const int* __restrict__ order,      // (nT,) or null
                    float* __restrict__ out_t,          // (nT, P)
                    int* __restrict__ out_tri,          // (nT, P)
                    int* __restrict__ steps,            // (nT, 2) or null
                    int p, int epad, int chunk, int n_slices, int groups,
                    int overlap, float eps, float eps2_det,
                    float draw_distance) {
  // two slabs of chunk records, the groups' (t, id) per ray, the
  // per-32-entry depth minima of two blocks, and each ray's bound and best
  // id (in shared memory, not registers, so that R = 4 does not spill)
  extern __shared__ float4 smem4[];
  const int nseg = (chunk + 31) >> 5;
  float* slabs = reinterpret_cast<float*>(smem4);
  float* red_t = slabs + 2 * chunk * kRec;
  int* red_i = reinterpret_cast<int*>(red_t + groups * p);
  float* seg_min = reinterpret_cast<float*>(red_i + groups * p);
  float* ray_bound = seg_min + 2 * nseg;
  int* ray_id = reinterpret_cast<int*>(ray_bound + p);
  __shared__ float w_max[kWideThreads / 32];

  const int tile = order ? order[blockIdx.x] : blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int per_group = p / R;
  const int grp = tid / per_group, lane_r = tid - grp * per_group;

  float dx[R], dy[R], dz[R], best[R];
  {
    float bound[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int ray = lane_r + j * per_group;
      const float4 d = rays[(size_t)tile * p + ray];
      dx[j] = d.x;
      dy[j] = d.y;
      dz[j] = d.z;
      bound[j] = d.w;
      best[j] = draw_distance;
      if (grp == 0) {
        ray_bound[ray] = d.w;
        ray_id[ray] = -1;
      }
    }
    // the first gate's maximum
    publish_wmax<R>(w_max, best, [&](int j) { return bound[j]; });
  }
  // after the first barrier
  const auto bound_of = [&](int j) { return ray_bound[lane_r + j * per_group]; };
  const auto take_id = [&](int j, int id) {
    if (grp == 0) ray_id[lane_r + j * per_group] = id;
  };

  const int s0 = starts[tile], s1 = starts[tile + 1];
  const int first = s0 / chunk;
  const int last = s1 > s0 ? (s1 - 1) / chunk : first;
  const int el = chunk / n_slices;
  const int slice_segs = (el + 31) >> 5;     // el is a multiple of 32 when sliced
  const float* depth = geom + (size_t)10 * epad;
  if (overlap) stage(slabs, geom, entry_tri, epad, first * chunk, (first + 1) * chunk);
  depth_minima(seg_min, depth + (size_t)first * chunk, chunk);
  int n_scanned = 0;
  for (int b = first; b <= last; ++b) {
    const int buf = (b - first) & 1;
    const float* slab = slabs + buf * chunk * kRec;
    // every read of the other slab ended before a barrier of the previous
    // block, so its refill starts now and runs under this block's scan
    if (!overlap) {
      stage(slabs + buf * chunk * kRec, geom, entry_tri, epad, b * chunk,
            (b + 1) * chunk);
      cp_async_wait<0>();
    } else if (b < last) {
      stage(slabs + (buf ^ 1) * chunk * kRec, geom, entry_tri, epad,
            (b + 1) * chunk, (b + 2) * chunk);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // block b's records and depth minima, and the first gate's maximum,
    // visible
    __syncthreads();
    const float* seg = seg_min + buf * nseg;
    for (int s = 0; s < n_slices; ++s) {
      // gate: the slice's minimum depth against max_r min(best_r, bound_r)
      // after the previous slice, each one warp reduction of the partials
      float cmin = __int_as_float(0x7f800000);
      for (int i = lane; i < slice_segs; i += 32) cmin = fminf(cmin, seg[s * slice_segs + i]);
      cmin = warp_min(cmin);
      const float wb = warp_max(lane < nwarps ? w_max[lane] : -__int_as_float(0x7f800000));
      if (!(cmin < wb)) continue;            // uniform over the CTA
      ++n_scanned;
      float bt[R];
      int bi[R];
      scan_records<R, kAllEntries>(slab, s * el, (s + 1) * el, grp, groups,
                                   dx, dy, dz, eps, eps2_det, bt, bi);
      merge_groups<R>(red_t, red_i, p, groups, grp, lane_r, per_group, bt,
                      bi, best, take_id);
      // the next gate's maximum; the next slice's gate reads it after this
      // barrier, the next block's after its records barrier
      publish_wmax<R>(w_max, best, bound_of);
      if (s + 1 < n_slices) __syncthreads();
    }
    if (b < last)
      depth_minima(seg_min + (buf ^ 1) * nseg, depth + (size_t)(b + 1) * chunk, chunk);
  }
  if (steps && tid == 0) {
    steps[2 * tile] = n_scanned;
    steps[2 * tile + 1] = last - first + 1;
  }
  if (grp == 0) {                            // ray_id holds this thread's writes
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int ray = lane_r + j * per_group;
      out_t[(size_t)tile * p + ray] = best[j];
      out_tri[(size_t)tile * p + ray] = ray_id[ray];
    }
  }
}

template <int R, bool kAllEntries>
__global__ void __launch_bounds__(kThreads, 2)
own_walk_kernel(const float4* __restrict__ rays,    // (nT, P) [d, bound]
                const float* __restrict__ geom,     // (11, epad)
                const int* __restrict__ entry_tri,  // (epad,)
                const int* __restrict__ starts,     // (nT + 1,)
                const int* __restrict__ order,      // (nT,) or null
                float* __restrict__ out_t,          // (nT, P)
                int* __restrict__ out_tri,          // (nT, P)
                int p, int epad, int chunk, int groups,
                float eps, float eps2_det, float draw_distance) {
  // two slabs of chunk records, then the groups' (t, id) per ray
  extern __shared__ float4 smem4[];
  float* slabs = reinterpret_cast<float*>(smem4);
  float* red_t = slabs + 2 * chunk * kRec;
  int* red_i = reinterpret_cast<int*>(red_t + groups * p);
  __shared__ float w_min[kThreads / 32], w_max[kThreads / 32];

  const int tile = order ? order[blockIdx.x] : blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int per_group = p / R;
  const int grp = tid / per_group, lane_r = tid - grp * per_group;

  float dx[R], dy[R], dz[R], bound[R], best[R];
  int best_tri[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float4 ray = rays[(size_t)tile * p + lane_r + j * per_group];
    dx[j] = ray.x;
    dy[j] = ray.y;
    dz[j] = ray.z;
    bound[j] = ray.w;
    best[j] = draw_distance;
    best_tri[j] = -1;
  }

  const int s0 = starts[tile], s1 = starts[tile + 1];
  const int first = s0 / chunk;
  const int last = s1 > s0 ? (s1 - 1) / chunk : first;
  stage(slabs, geom, entry_tri, epad, s0, min(s1, (first + 1) * chunk));
  for (int b = first; b <= last; ++b) {
    const float* slab = slabs + ((b - first) & 1) * chunk * kRec;
    const int lo = max(s0, b * chunk), hi = min(s1, (b + 1) * chunk);
    // every read of the other slab ended before the previous block's last
    // barrier, so its refill starts now and runs under this block's scan
    if (b < last) {
      stage(slabs + ((b + 1 - first) & 1) * chunk * kRec, geom, entry_tri,
            epad, hi, min(s1, (b + 2) * chunk));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                         // block b's records visible

    // gate: own entries' minimum depth against max_r min(best_r, bound_r)
    const int n = hi - lo;
    float dmin = __int_as_float(0x7f800000);
    for (int k = tid; k < n; k += blockDim.x) dmin = fminf(dmin, slab[k * kRec + 10]);
    float wmax = fminf(best[0], bound[0]);
#pragma unroll
    for (int j = 1; j < R; ++j) wmax = fmaxf(wmax, fminf(best[j], bound[j]));
    dmin = warp_min(dmin);
    wmax = warp_max(wmax);
    if (lane == 0) {
      w_min[warp] = dmin;
      w_max[warp] = wmax;
    }
    __syncthreads();
    float cmin = w_min[0], wb = w_max[0];
    for (int w = 1; w < nwarps; ++w) {
      cmin = fminf(cmin, w_min[w]);
      wb = fmaxf(wb, w_max[w]);
    }
    if (!(cmin < wb)) continue;              // uniform over the CTA

    float bt[R];
    int bi[R];
    scan_records<R, kAllEntries>(slab, 0, n, grp, groups, dx, dy, dz, eps,
                                 eps2_det, bt, bi);
    merge_groups<R>(red_t, red_i, p, groups, grp, lane_r, per_group, bt, bi,
                    best, [&](int j, int id) { best_tri[j] = id; });
  }
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const size_t at = (size_t)tile * p + lane_r + j * per_group;
      out_t[at] = best[j];
      out_tri[at] = best_tri[j];
    }
  }
}

// Sets the kernel's shared memory (above 48 KB only after the opt-in;
// setting it always is one cheap host call) and launches it.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int n_tiles, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<n_tiles, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The instance of a walk for R rays a thread, with the select over every
// entry (an infinite draw distance) or over the accepted ones only.
auto own_instance(int r, bool all) {
  return r == 4 ? (all ? own_walk_kernel<4, true> : own_walk_kernel<4, false>)
       : r == 2 ? (all ? own_walk_kernel<2, true> : own_walk_kernel<2, false>)
                : (all ? own_walk_kernel<1, true> : own_walk_kernel<1, false>);
}

auto aligned_instance(int r, bool all) {
  return r == 4 ? (all ? aligned_walk_kernel<4, true> : aligned_walk_kernel<4, false>)
       : r == 2 ? (all ? aligned_walk_kernel<2, true> : aligned_walk_kernel<2, false>)
                : (all ? aligned_walk_kernel<1, true> : aligned_walk_kernel<1, false>);
}

bool bad_shape(int p, int r, int groups, int max_threads) {
  return (r != 1 && r != 2 && r != 4) || p % (32 * r) || groups < 1
      || (p / r) * groups > max_threads;
}

// Launches the longest-first order kernel when `order` is not null.
template <bool kByBlocks>
cudaError_t order_tiles(const void* starts, int n_tiles, int chunk,
                        void* order, cudaStream_t s) {
  if (!order) return cudaSuccess;
  longest_first_kernel<kByBlocks><<<1, 1024, 0, s>>>(
      static_cast<const int*>(starts), n_tiles, chunk, static_cast<int*>(order));
  return cudaGetLastError();
}

}  // namespace

// Kernel K3: the aligned walk with the telemetry switch (esub > 1 or a
// steps output), one CTA of `groups` groups of p / rays_per_thread threads
// a tile. With `order` (n_tiles ints of scratch) the tiles are taken in
// descending order of blocks in range; without `overlap` each block is
// copied just before its scan.
extern "C" int bin_intersect_launch(const void* rays, const void* geom,
                                    const void* entry_tri, const void* starts,
                                    void* order, void* out_t, void* out_tri,
                                    void* steps, int n_tiles, int p, int epad,
                                    int chunk, int esub, int rays_per_thread,
                                    int groups, int overlap, float eps,
                                    float eps2_det, float draw_distance,
                                    void* stream) {
  if (esub <= 1 && !steps) return (int)cudaErrorInvalidValue;  // that is K1
  if (bad_shape(p, rays_per_thread, groups, kWideThreads) || esub < 1 || chunk % esub
      || (esub > 1 && (chunk / esub) % 32))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * chunk * kRec * sizeof(float)
                    + (size_t)(groups + 1) * p * (sizeof(float) + sizeof(int))
                    + (size_t)2 * ((chunk + 31) / 32) * sizeof(float);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = order_tiles<true>(starts, n_tiles, chunk, order, s);
  if (e != cudaSuccess) return (int)e;
  e = launch(aligned_instance(rays_per_thread, !(draw_distance <= kMissT)),
             n_tiles, (p / rays_per_thread) * groups, smem, s,
             static_cast<const float4*>(rays), static_cast<const float*>(geom),
             static_cast<const int*>(entry_tri), static_cast<const int*>(starts),
             static_cast<const int*>(order), static_cast<float*>(out_t),
             static_cast<int*>(out_tri), static_cast<int*>(steps), p, epad,
             chunk, esub, groups, overlap, eps, eps2_det, draw_distance);
  return (int)e;
}

// Kernel K1: the own-range walk, one CTA of `groups` groups of
// p / rays_per_thread threads a tile. With `order` (n_tiles ints of
// scratch) the tiles are taken longest first, ordered by one small kernel
// launched before the walk; without it in index order.
extern "C" int bin_intersect_own_launch(
    const void* rays, const void* geom, const void* entry_tri,
    const void* starts, void* order, void* out_t, void* out_tri,
    int n_tiles, int p, int epad, int chunk, int rays_per_thread, int groups,
    float eps, float eps2_det, float draw_distance, void* stream) {
  if (bad_shape(p, rays_per_thread, groups, kThreads)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * chunk * kRec * sizeof(float)
                    + (size_t)groups * p * (sizeof(float) + sizeof(int));
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = order_tiles<false>(starts, n_tiles, chunk, order, s);
  if (e != cudaSuccess) return (int)e;
  e = launch(own_instance(rays_per_thread, !(draw_distance <= kMissT)),
             n_tiles, (p / rays_per_thread) * groups, smem, s,
             static_cast<const float4*>(rays), static_cast<const float*>(geom),
             static_cast<const int*>(entry_tri), static_cast<const int*>(starts),
             static_cast<const int*>(order), static_cast<float*>(out_t),
             static_cast<int*>(out_tri), p, epad, chunk, groups, eps, eps2_det,
             draw_distance);
  return (int)e;
}
