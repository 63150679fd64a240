// Nearest hit per primary ray over a tile's candidate clusters: kernels K4
// and K5 of the cluster paths.
//
// K4 replaces the JAX package's Pallas kernel `_kernel` in
// cpp_cuda_raytracer_dev_tpu/ops/pallas/intersect_kernel_v2.py (launched by
// `pallas_tile_intersect_v2`, method "pallas2"); K5 replaces `_kernel` in
// ops/pallas/intersect_kernel.py (launched by `pallas_tile_intersect`,
// method "pallas"). Both walk the candidate clusters cand[t, 0..count[t])
// of tile t nearest first and, per candidate, slab-test its AABB per ray
// and run Moller-Trumbore over the cluster's L triangle slots:
//
//   slab:  box_ok = t_far >= max(t_near, 0) - 1e-4  and  t_near < best'
//          with best' = min(best, bound) (K4) or best (K5); directions
//          below 1e-30 in magnitude are clamped to +-1e-30 first.
//   K4:    per-ray bound = far root-box slab + 1e-3 (0 when the ray misses
//          the root box), capped at the draw distance. Per slot the eps
//          folding det' = (1-eps) det, u' = u - eps det, v' = v - eps det,
//          td' = (1-eps) td; accept when u' det', v' det', (det'-u'-v') det'
//          and td' det' - eps det'^2 are all >= 0 and det'^2 >= ((1-eps)eps)^2;
//          t = td' / det'. Within a cluster the lowest slot at the minimum
//          t wins. The walk stops before candidate k when suffixmin_dist[k]
//          (boxes column 6) >= wb, wb being the running minimum over steps
//          of the tile-wide maximum of min(best, bound).
//   K5:    every k < count[t]; s = sign(det) (+1 at 0), accept when
//          |det| >= eps, s u >= eps |det|, s v >= eps |det|,
//          s (u + v) <= |det| + eps |det|, t >= eps and the slot holds a
//          triangle, with t = td * (1 / det) (the JAX kernel's exact
//          reciprocal, then the product). Within a cluster the lowest
//          triangle id at the minimum t wins.
//   Both:  a ray takes a hit from candidate k only where its own box_ok
//          holds, and only on a strictly smaller t than its best. The
//          triangle id is written directly (through slot_mat), not JAX's
//          k * Lpad + slot encoding.
//
// Telemetry: steps[t] = [candidates visited, sub-tile MT executions]. The
// second counts, per visited candidate, the sub-tiles (runs of P / n_sub
// consecutive rays) in which some ray has box_ok (JAX's debug_mode 1); it
// is 0 unless count_subs is set. Both switches are template parameters.
//
// Design: one CTA per tile, min(P, 1024) threads, P / threads <= 4 rays a
// thread with their running best in registers. Per candidate the first L
// threads compute the slot's ten fixed-origin constants (m_det, m_u, m_v,
// td, folded for K4) straight from the (9, Lpad) geometry block into
// shared memory, with the slot's triangle id; after a barrier every ray
// whose box test passed loops over the L slots, reading the constants as
// shared-memory broadcasts. One __syncthreads_or gives the tile-wide
// "any box_ok" that lets a whole candidate be skipped; K4's exit test needs
// one block-wide max a step.
//
// Bound: FP32 issue. A (ray, slot) pair costs, in the slot loop, K4: 24
// multiplies, adds and subtracts (three 3-term dots, 15; det'^2, 1; the
// four acceptance terms, 8) and 5 comparisons, 29 operations; K5: 15 for
// the dots, 1 sign comparison, 4 multiplies (|det|, s u, s v, eps |det|)
// and 2 adds, 4 comparisons, 26 operations. The division and the select run
// only on accepted pairs. A candidate's geometry (4.6 KB at Lpad 128) is
// read from device memory once per tile.
//
// Numerics: build with -fmad=false and without fast math, so every product
// and sum rounds as the plain PyTorch version's separate operations do and
// every division is IEEE; the two agree bit for bit. eps, 1 - eps,
// ((1-eps) eps)^2 and the draw distance arrive as float32 arguments.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRaysPerThread = 4;   // P <= 4096
constexpr int kMaxSubWords = 128;      // n_sub <= 4096 sub-tiles
constexpr int kConsts = 10;            // m_det(3) | m_u(3) | m_v(3) | td
constexpr float kMissT = 3.0e38f;      // K4's t of a rejected slot
constexpr float kTinyDir = 1e-30f;

__device__ __forceinline__ float clamp_dir(float x) {
  return fabsf(x) < kTinyDir ? (x < 0.f ? -kTinyDir : kTinyDir) : x;
}

// Tile-wide maximum; every thread gets the same value (each reads the warp
// maxima in the same order). One barrier; `red` is reused only after the
// next barrier of the caller's loop.
__device__ __forceinline__ float block_max(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
  return m;
}

template <bool kV2, bool kCountSubs>
__global__ void __launch_bounds__(1024)
tile_intersect_kernel(const float* __restrict__ d,        // (nT, 3, P)
                      const int* __restrict__ cand,       // (nT, K)
                      const int* __restrict__ count,      // (nT,)
                      const float* __restrict__ boxes,    // (nT, K, 8)
                      const float* __restrict__ root,     // (9,) origin | root box
                      const float* __restrict__ geom9,    // (C, 9, Lpad)
                      const int* __restrict__ slot_mat,   // (C, L)
                      float* __restrict__ out_t,          // (nT, P)
                      int* __restrict__ out_tri,          // (nT, P)
                      int* __restrict__ steps,            // (nT, 2)
                      int p, int kmax, int n_slots, int lpad, int n_sub,
                      float eps, float k1, float eps2_det, float draw) {
  extern __shared__ float smem[];           // kConsts * L floats, L ids
  float* cst = smem;
  int* sid = reinterpret_cast<int*>(smem + kConsts * n_slots);
  __shared__ float red[32];
  __shared__ unsigned sub_bits[2][kMaxSubWords];

  const int tile = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const int nr = p / nthr;
  const int sub_len = p / n_sub;
  const float ox = root[0], oy = root[1], oz = root[2];
  if (kCountSubs) {
    for (int w = tid; w < 2 * kMaxSubWords; w += nthr) (&sub_bits[0][0])[w] = 0u;
  }

  float dx[kMaxRaysPerThread], dy[kMaxRaysPerThread], dz[kMaxRaysPerThread];
  float ix[kMaxRaysPerThread], iy[kMaxRaysPerThread], iz[kMaxRaysPerThread];
  float bound[kMaxRaysPerThread], best[kMaxRaysPerThread];
  int best_tri[kMaxRaysPerThread];
  float wmax = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxRaysPerThread; ++j) {
    if (j < nr) {
      const int r = tid + j * nthr;
      const size_t base = (size_t)tile * 3 * p + r;
      dx[j] = d[base];
      dy[j] = d[base + p];
      dz[j] = d[base + 2 * (size_t)p];
      ix[j] = 1.f / clamp_dir(dx[j]);
      iy[j] = 1.f / clamp_dir(dy[j]);
      iz[j] = 1.f / clamp_dir(dz[j]);
      best[j] = draw;
      best_tri[j] = -1;
      bound[j] = draw;
      if (kV2) {
        const float ax = (root[3] - ox) * ix[j], bx = (root[6] - ox) * ix[j];
        const float ay = (root[4] - oy) * iy[j], by = (root[7] - oy) * iy[j];
        const float az = (root[5] - oz) * iz[j], bz = (root[8] - oz) * iz[j];
        const float r_near = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
        const float r_far = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
        const bool root_hit = r_far >= fmaxf(r_near, 0.f) - 1e-4f;
        bound[j] = fminf(root_hit ? r_far + 1e-3f : 0.f, draw);
        wmax = fmaxf(wmax, bound[j]);
      }
    }
  }
  __syncthreads();                          // sub_bits zeroed
  float wb = kV2 ? block_max(wmax, red) : 0.f;

  const int cnt = count[tile];
  const float* tb = boxes + (size_t)tile * kmax * 8;
  int k = 0, n_mt = 0;
  for (; k < cnt; ++k) {
    if (kV2 && !(tb[k * 8 + 6] < wb)) break;  // uniform over the CTA
    const int c = cand[(size_t)tile * kmax + k];
    const float b0 = tb[k * 8 + 0] - ox, b3 = tb[k * 8 + 3] - ox;
    const float b1 = tb[k * 8 + 1] - oy, b4 = tb[k * 8 + 4] - oy;
    const float b2 = tb[k * 8 + 2] - oz, b5 = tb[k * 8 + 5] - oz;
    bool box_ok[kMaxRaysPerThread];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kMaxRaysPerThread; ++j) {
      box_ok[j] = false;
      if (j < nr) {
        const float ax = b0 * ix[j], bx = b3 * ix[j];
        const float ay = b1 * iy[j], by = b4 * iy[j];
        const float az = b2 * iz[j], bz = b5 * iz[j];
        const float t_near = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
        const float t_far = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
        const float lim = kV2 ? fminf(best[j], bound[j]) : best[j];
        box_ok[j] = (t_far >= fmaxf(t_near, 0.f) - 1e-4f) && (t_near < lim);
        mine |= box_ok[j];
        if (kCountSubs && box_ok[j]) {
          const int q = (tid + j * nthr) / sub_len;
          atomicOr(&sub_bits[k & 1][q >> 5], 1u << (q & 31));
        }
      }
    }
    // barrier: the previous candidate's constants are no longer read, and
    // this candidate's sub-tile bits are all set
    const int any = __syncthreads_or(mine);
    if (kCountSubs && tid == 0) {
      // sub_bits[k & 1] is next written at step k + 2, after the next
      // barrier, which thread 0 reaches only after clearing it here
      for (int w = 0; w < (n_sub + 31) / 32; ++w) {
        n_mt += __popc(sub_bits[k & 1][w]);
        sub_bits[k & 1][w] = 0u;
      }
    }
    if (any) {
      const float* g = geom9 + (size_t)c * 9 * lpad;
      for (int s = tid; s < n_slots; s += nthr) {
        const float p1x = g[s], p1y = g[lpad + s], p1z = g[2 * lpad + s];
        const float e1x = g[3 * lpad + s], e1y = g[4 * lpad + s], e1z = g[5 * lpad + s];
        const float e2x = g[6 * lpad + s], e2y = g[7 * lpad + s], e2z = g[8 * lpad + s];
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
        float m[kConsts];
        if (kV2) {
          m[0] = mdx * k1; m[1] = mdy * k1; m[2] = mdz * k1;
          m[3] = mux - eps * mdx; m[4] = muy - eps * mdy; m[5] = muz - eps * mdz;
          m[6] = mvx - eps * mdx; m[7] = mvy - eps * mdy; m[8] = mvz - eps * mdz;
          m[9] = td * k1;
        } else {
          m[0] = mdx; m[1] = mdy; m[2] = mdz;
          m[3] = mux; m[4] = muy; m[5] = muz;
          m[6] = mvx; m[7] = mvy; m[8] = mvz;
          m[9] = td;
        }
#pragma unroll
        for (int i = 0; i < kConsts; ++i) cst[i * n_slots + s] = m[i];
        sid[s] = slot_mat[(size_t)c * n_slots + s];
      }
      __syncthreads();                      // constants staged
#pragma unroll
      for (int j = 0; j < kMaxRaysPerThread; ++j) {
        if (j >= nr || !box_ok[j]) continue;
        float bt = kV2 ? kMissT : draw;
        int bi = 0x7fffffff;
        for (int s = 0; s < n_slots; ++s) {
          const float det = dx[j] * cst[s] + dy[j] * cst[n_slots + s]
                          + dz[j] * cst[2 * n_slots + s];
          const float up = dx[j] * cst[3 * n_slots + s] + dy[j] * cst[4 * n_slots + s]
                         + dz[j] * cst[5 * n_slots + s];
          const float vp = dx[j] * cst[6 * n_slots + s] + dy[j] * cst[7 * n_slots + s]
                         + dz[j] * cst[8 * n_slots + s];
          const float td = cst[9 * n_slots + s];
          if (kV2) {
            const float dd2 = det * det;
            const bool ok = (up * det >= 0.f) && (vp * det >= 0.f)
                         && ((det - up - vp) * det >= 0.f)
                         && (td * det - eps * dd2 >= 0.f) && (dd2 >= eps2_det);
            if (ok) {
              const float tt = td / det;
              if (tt < bt) {                // ascending slots: lowest slot on a tie
                bt = tt;
                bi = s;
              }
            }
          } else {
            const float sg = det >= 0.f ? 1.f : -1.f;
            const float ad = det * sg, uds = up * sg, vds = vp * sg;
            const float eps_ad = eps * ad;
            const int id = sid[s];
            if ((ad >= eps) && (uds >= eps_ad) && (vds >= eps_ad)
                && (uds + vds <= ad + eps_ad) && id >= 0) {
              const float tt = td * (1.f / det);
              if (tt >= eps && (tt < bt || (tt == bt && id < bi))) {
                bt = tt;
                bi = id;
              }
            }
          }
        }
        // bi is still INT_MAX when no slot was accepted (then bt is K4's
        // kMissT, which a draw distance above it would otherwise take)
        if (bi != 0x7fffffff && bt < best[j]) {
          best[j] = bt;
          best_tri[j] = kV2 ? sid[bi] : bi;
        }
      }
    }
    if (kV2) {
      float m = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxRaysPerThread; ++j)
        if (j < nr) m = fmaxf(m, fminf(best[j], bound[j]));
      wb = fminf(wb, block_max(m, red));
    }
  }
  if (tid == 0) {
    steps[2 * tile] = k;
    steps[2 * tile + 1] = n_mt;
  }
#pragma unroll
  for (int j = 0; j < kMaxRaysPerThread; ++j) {
    if (j < nr) {
      out_t[(size_t)tile * p + tid + j * nthr] = best[j];
      out_tri[(size_t)tile * p + tid + j * nthr] = best_tri[j];
    }
  }
}

}  // namespace

extern "C" int tile_intersect_launch(const void* d, const void* cand, const void* count,
                                     const void* boxes, const void* root,
                                     const void* geom9, const void* slot_mat,
                                     void* out_t, void* out_tri, void* steps,
                                     int n_tiles, int p, int kmax, int n_slots, int lpad,
                                     int n_sub, int gen, int count_subs, float eps,
                                     float k1, float eps2_det, float draw, void* stream) {
  const int threads = p < 1024 ? p : 1024;
  const size_t smem = (size_t)n_slots * (kConsts * sizeof(float) + sizeof(int));
  auto kernel = gen == 4 ? (count_subs ? tile_intersect_kernel<true, true>
                                       : tile_intersect_kernel<true, false>)
                         : (count_subs ? tile_intersect_kernel<false, true>
                                       : tile_intersect_kernel<false, false>);
  kernel<<<n_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<const int*>(cand),
      static_cast<const int*>(count), static_cast<const float*>(boxes),
      static_cast<const float*>(root), static_cast<const float*>(geom9),
      static_cast<const int*>(slot_mat), static_cast<float*>(out_t),
      static_cast<int*>(out_tri), static_cast<int*>(steps), p, kmax, n_slots, lpad,
      n_sub, eps, k1, eps2_det, draw);
  return (int)cudaGetLastError();
}
