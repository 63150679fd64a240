// Nearest hit per primary ray over a tile's whole chunks of the depth-sorted
// bin entry table, with the depth-certificate early exit: kernel K6.
//
// Replaces the JAX package's Pallas kernel `_kernel` in
// cpp_cuda_raytracer_dev_tpu/ops/pallas/bin_kernel.py (launched by
// `pallas_bin_intersect`). What it computes, per tile t and ray r of the
// tile, over the chunks b0 + k, b0 = starts[t] / chunk, k < nch with
// nch = (starts[t+1] - 1) / chunk - b0 + 1 (0 for an empty tile). The first
// and the last chunk may hold a neighbouring tile's entries: real geometry,
// which a ray may hit.
//
//   bound:  per ray, the far slab of the root box (origin10[3:9]) + 1e-3,
//           0 where the ray misses it, capped at the draw distance
//           (directions below 1e-30 in magnitude clamped to +-1e-30).
//   walk:   wb = max_r bound_r, cert = -3e38. Before chunk k the walk
//           stops unless cert < wb (debug_mode 0). After chunk k,
//           wb = min(wb, max_r min(best_r, bound_r)), cert = cmin_k - qstep,
//           cmin_k the minimum of the chunk's depth row (origin10[9] =
//           qstep, the depth-quantisation bucket of the sort).
//   gates:  chunk k is scanned when cmin_k < wb; with n_sub > 1 each run
//           of P / n_sub consecutive rays q is scanned only when also
//           cmin_k < max_{r in q} min(best_r, bound_r). debug_mode 1 drops
//           the exit, 2 also both gates.
//   MT:     per entry the epsilon-folded fixed-origin constants from
//           p1 | e1 | e2 and the origin: A = k1 (e2 x e1), B = e2 x tv -
//           eps (e2 x e1), C = tv x e1 - eps (e2 x e1), TD = k1 e2.(tv x e1),
//           tv = o - p1, k1 = 1 - eps. det = A.d, u' = B.d, v' = C.d;
//           accept when u' det, v' det, (det - u' - v') det and
//           TD det - eps det^2 are all >= 0 and det^2 >= (k1 eps)^2;
//           t = TD / det.
//   select: within a chunk the lowest slot at the minimum accepted t;
//           across chunks the best changes only on a strictly smaller t.
//   out:    t (draw distance on a miss), enc = k * chunk + slot relative
//           to b0 (-1 on a miss), steps = [chunks walked, nch].
//
// Differences from the Pallas kernel (ROADMAP F8): t is the exact IEEE
// quotient and ties are exact ties, where the TPU kernel takes an
// approximate reciprocal with one Newton step and clears t's low
// log2(chunk) mantissa bits to select the winner by one integer minimum.
// The TPU kernel's ring of DMA buffers is a TPU mechanism and is not kept.
//
// Design: one CTA per tile, `groups` groups of P / R threads (4 groups of
// 128 at 16x32 tiles, two CTAs an SM at <= 64 registers); each thread
// holds R rays (R = 4 at 16x32 tiles, rays lane + j P / R) with their
// running best in registers, and every group holds all of the tile's rays.
//   - Slots: the groups split each chunk's slots, slot s to group
//     s mod groups, each in ascending order; the groups' per-ray
//     (t, slot) minima meet in shared memory, where the lexicographic
//     minimum is the within-chunk rule (the lowest slot at the minimum t)
//     in any order, and every group then applies the across-chunk rule.
//   - Records: a chunk's raw rows (5 KB at chunk 128) are copied with
//     16-byte cp.async while the previous chunk is scanned; after that
//     chunk's merge barrier every thread of the CTA computes a share of the
//     entry constants (four threads an entry: A; B; C; TD and the depth
//     minimum) into 12-word records (A | B | C | TD | pad), which one
//     thread reads as three 16-byte shared loads serving its R rays.
//   - Barriers: two a walked chunk. The first publishes the groups' minima
//     and the next chunk's raw rows; the second the next chunk's records
//     and depth minimum and the run maxima of min(best, bound) after this
//     chunk (one per 32 rays), from which wb, the exit test, the chunk gate
//     and the sub-tile gate of the next chunk are read, each by one warp
//     reduction. The next chunk's constants are computed before its exit
//     test is known, which costs at most one chunk's constants a tile.
//   - Sub-tiles: a run of P / n_sub consecutive rays is gated by its own
//     maximum, taken by shuffles inside a warp's run of 32 rays (P / n_sub
//     divides 32) or over the run maxima (whole runs); a thread scans when
//     one of its rays' sub-tiles is open and takes a chunk's hit only for
//     those rays.
//   - Longest tiles first: CTA i takes the i-th tile in descending order
//     of chunks in range, from one small CTA launched first.
//
// Bound: FP32 issue. A (ray, entry) pair costs 24 multiplies, adds and
// subtracts (three 3-term dots, 15; det^2, 1; the four acceptance terms,
// 8) and 5 comparisons, 29 operations; the division and the select run only
// on accepted pairs. An entry's constants cost 51 operations once per
// walked chunk, shared by the tile's P rays (the split over four threads
// repeats the shared cross products: about 84). A chunk is read from device
// memory once per tile that walks it.
//
// Numerics: build with -fmad=false and without fast math, so every product
// and sum rounds as the plain PyTorch version's separate operations do and
// every division is IEEE; the two agree bit for bit. eps, 1 - eps,
// ((1-eps) eps)^2 and the draw distance arrive as float32 arguments.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 1024;         // the largest CTA
constexpr int kRows = 10;              // raw rows: p1(3) | e1(3) | e2(3) | depth
constexpr int kRec = 12;               // a record: A(3) | B(3) | C(3) | TD | pad
constexpr int kParts = 4;              // threads an entry's constants take
constexpr float kMissT = 3.0e38f;      // t of a rejected entry
constexpr float kTinyDir = 1e-30f;

__device__ __forceinline__ float clamp_dir(float x) {
  return fabsf(x) < kTinyDir ? (x < 0.f ? -kTinyDir : kTinyDir) : x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_min(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copy of one chunk's raw rows (kRows x chunk floats, contiguous
// in device memory) into `raw`, 16 bytes a copy.
__device__ __forceinline__ void stage_raw(float* raw, const float* g, int chunk) {
  for (int i = threadIdx.x; i < kRows * chunk / 4; i += blockDim.x)
    cp_async16(raw + 4 * i, g + 4 * i);
  cp_async_commit();
}

// One chunk's records from its raw rows: the ten epsilon-folded constants
// of each entry (see the header), split over kParts threads an entry, so
// that every thread of the CTA takes part; and this warp's minimum of the
// depth row into cmin_part[warp]. Each constant is computed by the same
// operations in the same order whichever thread computes it.
__device__ __forceinline__ void build_records(float* __restrict__ rec,
                                              const float* __restrict__ raw,
                                              float* __restrict__ cmin_part,
                                              const float* __restrict__ origin,
                                              int chunk, float eps, float k1) {
  const float ox = origin[0], oy = origin[1], oz = origin[2];
  float dmin = __int_as_float(0x7f800000);
  for (int w = threadIdx.x; w < kParts * chunk; w += blockDim.x) {
    const int e = w % chunk, part = w / chunk;
    const float p1x = raw[e], p1y = raw[chunk + e], p1z = raw[2 * chunk + e];
    const float e1x = raw[3 * chunk + e], e1y = raw[4 * chunk + e], e1z = raw[5 * chunk + e];
    const float e2x = raw[6 * chunk + e], e2y = raw[7 * chunk + e], e2z = raw[8 * chunk + e];
    const float tvx = ox - p1x, tvy = oy - p1y, tvz = oz - p1z;
    float* r = rec + e * kRec;
    if (part == 3) {                            // TD, and the depth minimum
      const float mvx = tvy * e1z - tvz * e1y;
      const float mvy = tvz * e1x - tvx * e1z;
      const float mvz = tvx * e1y - tvy * e1x;
      const float td = e2x * mvx + e2y * mvy + e2z * mvz;
      r[9] = td * k1;
      dmin = fminf(dmin, raw[9 * chunk + e]);
      continue;
    }
    const float mdx = e2y * e1z - e2z * e1y;
    const float mdy = e2z * e1x - e2x * e1z;
    const float mdz = e2x * e1y - e2y * e1x;
    if (part == 0) {                            // A
      r[0] = mdx * k1;
      r[1] = mdy * k1;
      r[2] = mdz * k1;
    } else if (part == 1) {                     // B
      const float mux = e2y * tvz - e2z * tvy;
      const float muy = e2z * tvx - e2x * tvz;
      const float muz = e2x * tvy - e2y * tvx;
      r[3] = mux - eps * mdx;
      r[4] = muy - eps * mdy;
      r[5] = muz - eps * mdz;
    } else {                                    // C
      const float mvx = tvy * e1z - tvz * e1y;
      const float mvy = tvz * e1x - tvx * e1z;
      const float mvz = tvx * e1y - tvy * e1x;
      r[6] = mvx - eps * mdx;
      r[7] = mvy - eps * mdy;
      r[8] = mvz - eps * mdz;
    }
  }
  dmin = warp_min(dmin);
  if ((threadIdx.x & 31) == 0) cmin_part[threadIdx.x >> 5] = dmin;
}

// run_max[i] = max over rays 32 i .. 32 i + 31 of min(best_r, bound_r),
// written by the first entry group (every group holds the same bests);
// bound_of(j) is the bound of the thread's ray j.
template <int R, typename BoundOf>
__device__ __forceinline__ void publish_runs(float* run_max, const float* best,
                                             BoundOf bound_of, int grp,
                                             int lane_r, int per_group) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float v = warp_max(fminf(best[j], bound_of(j)));
    if (grp == 0 && (threadIdx.x & 31) == 0) run_max[(lane_r + j * per_group) >> 5] = v;
  }
}

// order[i] = the tile that CTA i takes: the tiles in descending order of
// chunks in range (a counting sort in one CTA, O(n_tiles)). The order within
// a bucket follows the atomics; each tile's result does not depend on it.
__global__ void __launch_bounds__(1024)
longest_first_kernel(const int* __restrict__ starts, int n_tiles, int chunk,
                     int* __restrict__ order) {
  constexpr int kBuckets = 32;
  __shared__ int at[kBuckets];
  const auto bucket = [&](int t) {
    const int s0 = starts[t], s1 = starts[t + 1];
    return min(s1 > s0 ? (s1 - 1) / chunk - s0 / chunk + 1 : 0, kBuckets - 1);
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

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
bin_tile_intersect_kernel(const float* __restrict__ d,        // (nT, 3, P)
                          const int* __restrict__ starts,     // (nT + 1,)
                          const float* __restrict__ origin10, // (10,)
                          const float* __restrict__ geom,     // (B, 10, chunk)
                          const int* __restrict__ order,      // (nT,) or null
                          float* __restrict__ out_t,          // (nT, P)
                          int* __restrict__ out_enc,          // (nT, P)
                          int* __restrict__ steps,            // (nT, 2)
                          int p, int chunk, int n_sub, int debug_mode,
                          int groups, int overlap, float eps, float k1,
                          float eps2_det, float draw) {
  // the next chunk's raw rows, this chunk's records, the groups' (t, slot)
  // per ray, the run maxima, and each ray's bound and best enc (in shared
  // memory, not registers, so that R = 4 does not spill)
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);
  float* rec = raw + kRows * chunk;
  float* red_t = rec + kRec * chunk;
  int* red_s = reinterpret_cast<int*>(red_t + groups * p);
  float* run_max = reinterpret_cast<float*>(red_s + groups * p);
  float* ray_bound = run_max + (p >> 5);
  int* ray_enc = reinterpret_cast<int*>(ray_bound + p);
  __shared__ float cmin_part[kThreads / 32];

  const int tile = order ? order[blockIdx.x] : blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int per_group = p / R;
  const int grp = tid / per_group, lane_r = tid - grp * per_group;
  const float qstep = origin10[9];
  const float inf = __int_as_float(0x7f800000);

  float dx[R], dy[R], dz[R], best[R];
  {
    const float ox = origin10[0], oy = origin10[1], oz = origin10[2];
    float bound[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int ray = lane_r + j * per_group;
      const size_t base = (size_t)tile * 3 * p + ray;
      dx[j] = d[base];
      dy[j] = d[base + p];
      dz[j] = d[base + 2 * (size_t)p];
      const float ix = 1.f / clamp_dir(dx[j]), iy = 1.f / clamp_dir(dy[j]);
      const float iz = 1.f / clamp_dir(dz[j]);
      const float ax = (origin10[3] - ox) * ix, bx = (origin10[6] - ox) * ix;
      const float ay = (origin10[4] - oy) * iy, by = (origin10[7] - oy) * iy;
      const float az = (origin10[5] - oz) * iz, bz = (origin10[8] - oz) * iz;
      const float r_near = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
      const float r_far = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
      const bool root_hit = r_far >= fmaxf(r_near, 0.f) - 1e-4f;
      bound[j] = fminf(root_hit ? r_far + 1e-3f : 0.f, draw);
      best[j] = draw;
      if (grp == 0) {
        ray_bound[ray] = bound[j];
        ray_enc[ray] = -1;
      }
    }
    // the run maxima before the walk: min(draw, bound) = bound
    publish_runs<R>(run_max, best, [&](int j) { return bound[j]; }, grp,
                    lane_r, per_group);
  }
  // after the first barrier
  const auto bound_of = [&](int j) { return ray_bound[lane_r + j * per_group]; };

  const int s0 = starts[tile], s1 = starts[tile + 1];
  const int b0 = s0 / chunk;
  const int nch = s1 > s0 ? (s1 - 1) / chunk - b0 + 1 : 0;
  const int sub_len = p / n_sub;
  const bool sub_gate = n_sub > 1 && debug_mode < 2;
  const float* g0 = geom + (size_t)b0 * kRows * chunk;

  if (nch > 0) stage_raw(raw, g0, chunk);
  cp_async_wait_all();
  __syncthreads();                           // chunk 0's raw rows, the run maxima
  if (nch > 0) build_records(rec, raw, cmin_part, origin10, chunk, eps, k1);
  __syncthreads();                           // chunk 0's records and depth minimum
  // wb = max_r bound_r, then after each chunk min(wb, max_r min(best_r,
  // bound_r)): one warp reduction of the run maxima
  float wb = warp_max(lane < (p >> 5) ? run_max[lane] : -inf);
  float cert = -3.0e38f;
  int k = 0;
  for (; k < nch; ++k) {
    if (debug_mode < 1 && !(cert < wb)) break;   // uniform over the CTA
    const float cmin = warp_min(lane < nwarps ? cmin_part[lane] : inf);
    // chunk k + 1's raw rows, copied under chunk k's scan: the last reads
    // of `raw` (chunk k's records) ended before the previous barrier
    if (overlap && k + 1 < nch) stage_raw(raw, g0 + (size_t)(k + 1) * kRows * chunk, chunk);
    const bool open = cmin < wb || debug_mode >= 2;  // uniform over the CTA
    unsigned go = (1u << R) - 1;              // bit j: ray j's sub-tile is open
    float bt[R];
    int bs[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      bt[j] = kMissT;
      bs[j] = INT_MAX;
    }
    if (open) {
      if (sub_gate) {
        // max over the ray's sub-tile of min(best, bound): sub-tiles of at
        // most 32 rays lie inside a warp's run of 32 rays (sub_len divides
        // 32), longer ones are whole runs
#pragma unroll
        for (int j = 0; j < R; ++j) {
          float v;
          if (sub_len < 32) {
            v = fminf(best[j], bound_of(j));
            for (int o = sub_len >> 1; o > 0; o >>= 1)
              v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
          } else {
            const int q0 = (lane_r + j * per_group) / sub_len * (sub_len >> 5);
            v = run_max[q0];
            for (int w = 1; w < (sub_len >> 5); ++w) v = fmaxf(v, run_max[q0 + w]);
          }
          if (!(cmin < v)) go &= ~(1u << j);
        }
      }
      if (go) {
        // this group's slots grp, grp + groups, ... in ascending order: the
        // lowest slot at the group's minimum accepted t
        for (int s = grp; s < chunk; s += groups) {
          const float4* e = reinterpret_cast<const float4*>(rec + s * kRec);
          const float4 e0 = e[0], e1 = e[1], e2 = e[2];
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const float det = dx[j] * e0.x + dy[j] * e0.y + dz[j] * e0.z;
            const float up = dx[j] * e0.w + dy[j] * e1.x + dz[j] * e1.y;
            const float vp = dx[j] * e1.z + dy[j] * e1.w + dz[j] * e2.x;
            const float td = e2.y;
            const float dd2 = det * det;
            const bool ok = (up * det >= 0.f) && (vp * det >= 0.f)
                         && ((det - up - vp) * det >= 0.f)
                         && (td * det - eps * dd2 >= 0.f) && (dd2 >= eps2_det);
            if (ok) {
              const float tt = td / det;
              if (tt < bt[j]) {
                bt[j] = tt;
                bs[j] = s;
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int ray = grp * p + lane_r + j * per_group;
        red_t[ray] = bt[j];
        red_s[ray] = bs[j];
      }
    }
    if (!overlap && k + 1 < nch) stage_raw(raw, g0 + (size_t)(k + 1) * kRows * chunk, chunk);
    cp_async_wait_all();
    __syncthreads();                         // the groups' minima, chunk k + 1's raw rows
    if (open) {
      // the lexicographic (t, slot) minimum over the groups, the
      // within-chunk rule in any order; then the across-chunk rule
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int ray = lane_r + j * per_group;
        float t = red_t[ray];
        int slot = red_s[ray];
        for (int q = 1; q < groups; ++q) {
          const float tq = red_t[q * p + ray];
          const int sq = red_s[q * p + ray];
          if (tq < t || (tq == t && sq < slot)) {
            t = tq;
            slot = sq;
          }
        }
        if ((go >> j & 1) && t < kMissT && t < best[j]) {
          best[j] = t;
          if (grp == 0) ray_enc[ray] = k * chunk + slot;
        }
      }
    }
    publish_runs<R>(run_max, best, bound_of, grp, lane_r, per_group);
    if (k + 1 < nch) build_records(rec, raw, cmin_part, origin10, chunk, eps, k1);
    // chunk k + 1's records and depth minimum, and the run maxima after
    // chunk k, which the exit test and the gates of chunk k + 1 read
    __syncthreads();
    wb = fminf(wb, warp_max(lane < (p >> 5) ? run_max[lane] : -inf));
    cert = cmin - qstep;
  }
  if (tid == 0) {
    steps[2 * tile] = k;
    steps[2 * tile + 1] = nch;
  }
  if (grp == 0) {                            // ray_enc holds this thread's writes
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int ray = lane_r + j * per_group;
      out_t[(size_t)tile * p + ray] = best[j];
      out_enc[(size_t)tile * p + ray] = ray_enc[ray];
    }
  }
}

}  // namespace

// Kernel K6: one CTA of `groups` groups of p / rays_per_thread threads a
// tile. With `order` (n_tiles ints of scratch) the tiles are taken in
// descending order of chunks in range, ordered by one small kernel launched
// first; without `overlap` each chunk's raw rows are copied after its scan.
extern "C" int bin_tile_intersect_launch(const void* d, const void* starts,
                                         const void* origin10, const void* geom,
                                         void* order, void* out_t, void* out_enc,
                                         void* steps, int n_tiles, int p, int chunk,
                                         int n_sub, int debug_mode,
                                         int rays_per_thread, int groups, int overlap,
                                         float eps, float k1, float eps2_det,
                                         float draw, void* stream) {
  const int r = rays_per_thread;
  if ((r != 1 && r != 2 && r != 4) || p % (32 * r) || p > 1024 || groups < 1
      || (p / r) * groups > kThreads || chunk < 4 || chunk % 4 || n_sub < 1
      || p % n_sub)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(kRows + kRec) * chunk * sizeof(float)
                    + (size_t)(groups + 1) * p * (sizeof(float) + sizeof(int))
                    + (size_t)(p / 32) * sizeof(float);
  auto kernel = r == 4 ? bin_tile_intersect_kernel<4>
              : r == 2 ? bin_tile_intersect_kernel<2>
                       : bin_tile_intersect_kernel<1>;
  auto s = static_cast<cudaStream_t>(stream);
  // above 48 KB only after the opt-in; setting it always is one cheap call
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (order) {
    longest_first_kernel<<<1, 1024, 0, s>>>(static_cast<const int*>(starts), n_tiles,
                                            chunk, static_cast<int*>(order));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_tiles, (p / r) * groups, smem, s>>>(
      static_cast<const float*>(d), static_cast<const int*>(starts),
      static_cast<const float*>(origin10), static_cast<const float*>(geom),
      static_cast<const int*>(order), static_cast<float*>(out_t),
      static_cast<int*>(out_enc), static_cast<int*>(steps), p, chunk, n_sub,
      debug_mode, groups, overlap, eps, k1, eps2_det, draw);
  return (int)cudaGetLastError();
}
