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
// Design: one CTA per tile, one thread per ray (P <= 1024). Per walked
// chunk the first `chunk` threads read their entry's ten rows, compute the
// entry's ten constants into shared memory and its depth into a block-wide
// minimum; after that barrier every ray whose gate is open loops over the
// chunk's entries with its running best in registers, reading the
// constants as shared-memory broadcasts. wb is one block-wide maximum a
// chunk.
//
// Bound: FP32 issue. A (ray, entry) pair costs 24 multiplies, adds and
// subtracts (three 3-term dots, 15; det^2, 1; the four acceptance terms,
// 8) and 5 comparisons, 29 operations; the division and the select run only
// on accepted pairs. An entry's constants cost 51 operations once per
// walked chunk, shared by the tile's P rays. A chunk (5 KB at 128 entries)
// is read from device memory once per tile that walks it.
//
// Numerics: build with -fmad=false and without fast math, so every product
// and sum rounds as the plain PyTorch version's separate operations do and
// every division is IEEE; the two agree bit for bit. eps, 1 - eps,
// ((1-eps) eps)^2 and the draw distance arrive as float32 arguments.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 10;              // p1(3) | e1(3) | e2(3) | depth
constexpr int kConsts = 10;            // A(3) | B(3) | C(3) | TD
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

// Block-wide reduction; every thread gets the same value (each reads the
// warp results in the same order). One barrier; `red` may be written again
// only after the caller's next barrier.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  x = kMax ? warp_max(x) : warp_min(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    m = kMax ? fmaxf(m, red[w]) : fminf(m, red[w]);
  return m;
}

__global__ void __launch_bounds__(1024)
bin_tile_intersect_kernel(const float* __restrict__ d,        // (nT, 3, P)
                          const int* __restrict__ starts,     // (nT + 1,)
                          const float* __restrict__ origin10, // (10,)
                          const float* __restrict__ geom,     // (B, 10, chunk)
                          float* __restrict__ out_t,          // (nT, P)
                          int* __restrict__ out_enc,          // (nT, P)
                          int* __restrict__ steps,            // (nT, 2)
                          int p, int chunk, int n_sub, int debug_mode,
                          float eps, float k1, float eps2_det, float draw) {
  extern __shared__ float cst[];             // kConsts * chunk floats
  __shared__ float red_min[32], red_max[32], red_sub[32];

  const int tile = blockIdx.x, r = threadIdx.x;
  const int lane = r & 31, warp = r >> 5;
  const float ox = origin10[0], oy = origin10[1], oz = origin10[2];
  const float qstep = origin10[9];
  const size_t base = (size_t)tile * 3 * p + r;
  const float dx = d[base], dy = d[base + p], dz = d[base + 2 * (size_t)p];

  float bound;
  {
    const float ix = 1.f / clamp_dir(dx), iy = 1.f / clamp_dir(dy), iz = 1.f / clamp_dir(dz);
    const float ax = (origin10[3] - ox) * ix, bx = (origin10[6] - ox) * ix;
    const float ay = (origin10[4] - oy) * iy, by = (origin10[7] - oy) * iy;
    const float az = (origin10[5] - oz) * iz, bz = (origin10[8] - oz) * iz;
    const float r_near = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
    const float r_far = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
    const bool root_hit = r_far >= fmaxf(r_near, 0.f) - 1e-4f;
    bound = fminf(root_hit ? r_far + 1e-3f : 0.f, draw);
  }
  float best = draw;
  int best_enc = -1;

  const int s0 = starts[tile], s1 = starts[tile + 1];
  const int b0 = s0 / chunk;
  const int nch = s1 > s0 ? (s1 - 1) / chunk - b0 + 1 : 0;
  const int sub_len = p / n_sub;

  float wb = block_reduce<true>(bound, red_max);
  float cert = -3.0e38f;
  int k = 0;
  for (; k < nch; ++k) {
    if (debug_mode < 1 && !(cert < wb)) break;   // uniform over the CTA
    __syncthreads();                             // previous chunk fully read
    const float* g = geom + (size_t)(b0 + k) * kRows * chunk;
    float dmin = __int_as_float(0x7f800000);
    for (int e = r; e < chunk; e += p) {
      const float p1x = g[e], p1y = g[chunk + e], p1z = g[2 * chunk + e];
      const float e1x = g[3 * chunk + e], e1y = g[4 * chunk + e], e1z = g[5 * chunk + e];
      const float e2x = g[6 * chunk + e], e2y = g[7 * chunk + e], e2z = g[8 * chunk + e];
      dmin = fminf(dmin, g[9 * chunk + e]);
      const float tvx = ox - p1x, tvy = oy - p1y, tvz = oz - p1z;
      const float mdx = e2y * e1z - e2z * e1y;
      const float mdy = e2z * e1x - e2x * e1z;
      const float mdz = e2x * e1y - e2y * e1x;
      const float mux = e2y * tvz - e2z * tvy;
      const float muy = e2z * tvx - e2x * tvz;
      const float muz = e2x * tvy - e2y * tvx;
      const float mvx = tvy * e1z - tvz * e1y;
      const float mvy = tvz * e1x - tvx * e1z;
      const float mvz = tvx * e1y - tvy * e1x;
      const float td = e2x * mvx + e2y * mvy + e2z * mvz;
      cst[e] = mdx * k1;
      cst[chunk + e] = mdy * k1;
      cst[2 * chunk + e] = mdz * k1;
      cst[3 * chunk + e] = mux - eps * mdx;
      cst[4 * chunk + e] = muy - eps * mdy;
      cst[5 * chunk + e] = muz - eps * mdz;
      cst[6 * chunk + e] = mvx - eps * mdx;
      cst[7 * chunk + e] = mvy - eps * mdy;
      cst[8 * chunk + e] = mvz - eps * mdz;
      cst[9 * chunk + e] = td * k1;
    }
    // the barrier inside also publishes the staged constants
    const float cmin = block_reduce<false>(dmin, red_min);

    if (cmin < wb || debug_mode >= 2) {          // uniform over the CTA
      bool go = true;
      if (n_sub > 1 && debug_mode < 2) {         // uniform branch
        // max over the ray's sub-tile of min(best, bound): sub-tiles of at
        // most 32 rays lie inside a warp (sub_len divides 32), longer ones
        // are whole warps
        float v = fminf(best, bound);
        const int span = sub_len < 32 ? sub_len : 32;
        for (int o = span >> 1; o > 0; o >>= 1)
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
        if (sub_len > 32) {
          if (lane == 0) red_sub[warp] = v;
          __syncthreads();
          const int w0 = (r / sub_len) * (sub_len >> 5);
          v = red_sub[w0];
          for (int w = 1; w < (sub_len >> 5); ++w) v = fmaxf(v, red_sub[w0 + w]);
        }
        go = cmin < v;
      }
      if (go) {
        float bt = kMissT;
        int bi = -1;
        for (int s = 0; s < chunk; ++s) {
          const float det = dx * cst[s] + dy * cst[chunk + s] + dz * cst[2 * chunk + s];
          const float up = dx * cst[3 * chunk + s] + dy * cst[4 * chunk + s]
                         + dz * cst[5 * chunk + s];
          const float vp = dx * cst[6 * chunk + s] + dy * cst[7 * chunk + s]
                         + dz * cst[8 * chunk + s];
          const float td = cst[9 * chunk + s];
          const float dd2 = det * det;
          const bool ok = (up * det >= 0.f) && (vp * det >= 0.f)
                       && ((det - up - vp) * det >= 0.f)
                       && (td * det - eps * dd2 >= 0.f) && (dd2 >= eps2_det);
          if (ok) {
            const float tt = td / det;
            if (tt < bt) {                       // ascending slots: lowest on a tie
              bt = tt;
              bi = s;
            }
          }
        }
        if (bi >= 0 && bt < best) {
          best = bt;
          best_enc = k * chunk + bi;
        }
      }
    }
    wb = fminf(wb, block_reduce<true>(fminf(best, bound), red_max));
    cert = cmin - qstep;
  }
  if (r == 0) {
    steps[2 * tile] = k;
    steps[2 * tile + 1] = nch;
  }
  out_t[(size_t)tile * p + r] = best;
  out_enc[(size_t)tile * p + r] = best_enc;
}

}  // namespace

extern "C" int bin_tile_intersect_launch(const void* d, const void* starts,
                                         const void* origin10, const void* geom,
                                         void* out_t, void* out_enc, void* steps,
                                         int n_tiles, int p, int chunk, int n_sub,
                                         int debug_mode, float eps, float k1,
                                         float eps2_det, float draw, void* stream) {
  const size_t smem = (size_t)kConsts * chunk * sizeof(float);
  bin_tile_intersect_kernel<<<n_tiles, p, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<const int*>(starts),
      static_cast<const float*>(origin10), static_cast<const float*>(geom),
      static_cast<float*>(out_t), static_cast<int*>(out_enc), static_cast<int*>(steps),
      p, chunk, n_sub, debug_mode, eps, k1, eps2_det, draw);
  return (int)cudaGetLastError();
}
