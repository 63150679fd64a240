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
// Design: one CTA of T = min(P, 512) threads per tile (two CTAs an SM at
// <= 64 registers). Per visited candidate k:
//   - Fill: the slot loop stops at the cluster's fill, one past its last
//     slot that holds a triangle id or nonzero constants. A slot whose ten
//     constants are all zero is never accepted (det = 0, td = 0, and
//     eps > 0), so the cut is exact for any layout; ClusterAccel pads only
//     at the end of a cluster, so it drops exactly the padding.
//   - Prefetch: each staging thread copies its own slots' raw geometry (9
//     rows and the id) of candidate k + dist with cp.async into a ring of
//     dist + 1 stages, and computes candidate k's constants from its own
//     copies, so no barrier waits for device memory. The constants are
//     staged as 12-word records (m_det | m_u | m_v | td | id), double
//     buffered by the parity of k.
//   - Compaction: the rays whose box test passed are gathered into a dense
//     list in shared memory (a ballot and one shared atomic a warp); the
//     per-ray state (direction, best t, best id) lives in shared memory,
//     so any thread can take any ray.
//   - Slot loop: the list's n rays are split among G <= 16 slot groups of
//     ceil(n / R) threads (not rounded to a warp, so no lane idles: a warp
//     across two groups reads two records a load); a thread keeps R rays
//     (4 from 128 rays on, 2 from 64, else 1) in registers and reads a
//     slot's record as three 16-byte shared loads that serve all R. Each
//     group's per-ray (t, slot) (K4) or (t, id) (K5) minimum goes to
//     shared memory, and each ray's owner takes the lexicographic minimum
//     over the groups, which is the within-cluster tie rule in any order,
//     then applies the across-candidate rule (strictly smaller t).
//   - Barriers: two a candidate (list and records ready; group minima
//     ready), one when no ray passed. K4's exit maximum is reduced at the
//     first of them, from the best after candidate k - 1, which is the
//     value the exit test at k needs; block-wide maxima are read back by
//     one warp reduction, not a loop over the warps.
//   - Longest tiles first (from 512 tiles on): CTA i takes the tile of
//     i-th largest count, from one small CTA launched before the walk.
// The slot loop is most of the time, issue-bound at about 30 instructions
// a pair; staging, the box test and the merge are the rest.
//
// Bound: FP32 issue. A (ray, slot) pair costs, in the slot loop, K4: 24
// multiplies, adds and subtracts (three 3-term dots, 15; det'^2, 1; the
// four acceptance terms, 8) and 5 comparisons, 29 operations; K5: 15 for
// the dots, 1 sign comparison, 4 multiplies (|det|, s u, s v, eps |det|)
// and 2 adds, 4 comparisons, 26 operations. The division and the select run
// only on accepted pairs. The bound counts the pairs of rays past a box
// test and filled slots; a candidate's geometry (4.6 KB at Lpad 128) is read
// once per tile, mostly from L2.
//
// Numerics: build with -fmad=false and without fast math, so every product
// and sum rounds as the plain PyTorch version's separate operations do and
// every division is IEEE; the two agree bit for bit. eps, 1 - eps,
// ((1-eps) eps)^2 and the draw distance arrive as float32 arguments; the
// wrapper requires eps > 0.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 512;          // the largest CTA
constexpr int kMaxHome = 4;            // rays a thread box-tests: P <= 2048
constexpr int kMaxSubWords = 64;       // n_sub <= 2048 sub-tiles
constexpr int kRows = 10;              // raw slot rows: p1 | e1 | e2 | id
constexpr int kRec = 12;               // m_det | m_u | m_v | td | id | pad
constexpr float kMissT = 3.0e38f;      // K4's t of a rejected slot
constexpr float kTinyDir = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

// levers, for measuring each one against its absence
constexpr int kLeverAllSlots = 1;      // loop over all L slots
constexpr int kLeverNoCompact = 2;     // whole warps of rays, as in one ray a thread
constexpr int kLeverOneRay = 4;        // one ray a thread in the slot loop
constexpr int kLeverFourRays = 8;      // four rays a thread in the slot loop

__device__ __forceinline__ float clamp_dir(float x) {
  return fabsf(x) < kTinyDir ? (x < 0.f ? -kTinyDir : kTinyDir) : x;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most n of this thread's cp.async groups are pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// order[i] = the tile that CTA i takes: the tiles in descending order of
// candidate count, in 32 buckets (a counting sort in one CTA, O(n_tiles)).
// The order within a bucket follows the atomics; each tile's result does
// not depend on it.
__global__ void __launch_bounds__(1024)
longest_first_kernel(const int* __restrict__ count, int n_tiles, int kmax,
                     int* __restrict__ order) {
  constexpr int kBuckets = 32;
  __shared__ int at[kBuckets];
  const auto bucket = [&](int t) {
    return min(max(count[t], 0) * kBuckets / (kmax + 1), kBuckets - 1);
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

// One slot group's share of candidate k: list rays [gi R, gi R + R) against
// slots grp, grp + G, ... < fill. Writes the group's (t, tie) per list
// position, tie = slot (K4) or id (K5), INT_MAX where nothing beat the
// ray's best (K4: or 3e38).
template <bool kV2, int R>
__device__ __forceinline__ void slot_loop(const float* __restrict__ rec,
                                          const float4* __restrict__ ray_d,
                                          const int* __restrict__ list, int n,
                                          int fill, int groups, int grp, int gi,
                                          float eps, float eps2_det,
                                          float* __restrict__ red_t,
                                          int* __restrict__ red_i) {
  float dx[R], dy[R], dz[R], bt[R];
  int bi[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int pos = gi * R + j;
    dx[j] = dy[j] = dz[j] = 0.f;
    bt[j] = 0.f;                             // an empty lane accepts nothing
    bi[j] = INT_MAX;
    if (pos < n) {
      const int r = list[pos];
      const float4 v = ray_d[r < 0 ? ~r : r];
      dx[j] = v.x;
      dy[j] = v.y;
      dz[j] = v.z;
      // only a t below the ray's best can change it (K4: and below 3e38)
      bt[j] = kV2 ? fminf(v.w, kMissT) : v.w;
    }
  }
  for (int s = grp; s < fill; s += groups) {
    const float4* q = reinterpret_cast<const float4*>(rec + s * kRec);
    const float4 e0 = q[0], e1 = q[1], e2 = q[2];
    const int tie = kV2 ? s : __float_as_int(e2.z);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float det = dx[j] * e0.x + dy[j] * e0.y + dz[j] * e0.z;
      const float up = dx[j] * e0.w + dy[j] * e1.x + dz[j] * e1.y;
      const float vp = dx[j] * e1.z + dy[j] * e1.w + dz[j] * e2.x;
      const float td = e2.y;
      if (kV2) {
        const float dd2 = det * det;
        const bool ok = (up * det >= 0.f) && (vp * det >= 0.f)
                     && ((det - up - vp) * det >= 0.f)
                     && (td * det - eps * dd2 >= 0.f) && (dd2 >= eps2_det);
        if (ok) {
          const float tt = td / det;
          if (tt < bt[j]) {                  // ascending slots: lowest slot on a tie
            bt[j] = tt;
            bi[j] = tie;
          }
        }
      } else {
        const float sg = det >= 0.f ? 1.f : -1.f;
        const float ad = det * sg, uds = up * sg, vds = vp * sg;
        const float eps_ad = eps * ad;
        if ((ad >= eps) && (uds >= eps_ad) && (vds >= eps_ad)
            && (uds + vds <= ad + eps_ad) && tie >= 0) {
          const float tt = td * (1.f / det);
          if (tt >= eps && (tt < bt[j] || (tt == bt[j] && tie < bi[j]))) {
            bt[j] = tt;
            bi[j] = tie;
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int pos = gi * R + j;
    if (pos < n) {
      red_t[grp * n + pos] = bt[j];
      red_i[grp * n + pos] = bi[j];
    }
  }
}

template <bool kV2, bool kCountSubs>
__global__ void __launch_bounds__(kThreads, 2)
tile_intersect_kernel(const float* __restrict__ d,        // (nT, 3, P)
                      const int* __restrict__ cand,       // (nT, K)
                      const int* __restrict__ count,      // (nT,)
                      const float* __restrict__ boxes,    // (nT, K, 8)
                      const float* __restrict__ root,     // (9,) origin | root box
                      const float* __restrict__ geom9,    // (C, 9, Lpad)
                      const int* __restrict__ slot_mat,   // (C, L)
                      const int* __restrict__ order,      // (nT,) or null
                      float* __restrict__ out_t,          // (nT, P)
                      int* __restrict__ out_tri,          // (nT, P)
                      int* __restrict__ steps,            // (nT, 2)
                      int p, int kmax, int n_slots, int lpad, int n_sub,
                      int levers, int dist, float eps, float k1,
                      float eps2_det, float draw) {
  // per ray: [d | best t], [1/d | bound]; two record buffers; the groups'
  // minima; the raw ring; the list; per ray: best id
  extern __shared__ float4 smem4[];
  float4* ray_d = smem4;
  float4* ray_i = ray_d + p;
  float* recs = reinterpret_cast<float*>(ray_i + p);
  float* red_t = recs + 2 * kRec * n_slots;
  int* red_i = reinterpret_cast<int*>(red_t + 4 * blockDim.x);
  float* ring = reinterpret_cast<float*>(red_i + 4 * blockDim.x);
  int* list = reinterpret_cast<int*>(ring + (dist + 1) * kRows * n_slots);
  int* ray_tri = list + p;
  __shared__ float w_max[2][kThreads / 32];
  __shared__ int w_fill[2][kThreads / 32];
  __shared__ int n_list[2];
  __shared__ unsigned sub_bits[kMaxSubWords];

  const int tile = order ? order[blockIdx.x] : blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int nh = p / nthr;                   // rays a thread box-tests
  const int sub_len = p / n_sub;
  const int stages = dist + 1;
  const float ox = root[0], oy = root[1], oz = root[2];
  const bool compact = !(levers & kLeverNoCompact);

  if (tid < 2) n_list[tid] = 0;
  if (kCountSubs)
    for (int w = tid; w < kMaxSubWords; w += nthr) sub_bits[w] = 0u;
#pragma unroll
  for (int j = 0; j < kMaxHome; ++j) {
    if (j < nh) {
      const int r = tid + j * nthr;
      const size_t base = (size_t)tile * 3 * p + r;
      const float dx = d[base], dy = d[base + p], dz = d[base + 2 * (size_t)p];
      const float ix = 1.f / clamp_dir(dx), iy = 1.f / clamp_dir(dy);
      const float iz = 1.f / clamp_dir(dz);
      float bound = draw;
      if (kV2) {
        const float ax = (root[3] - ox) * ix, bx = (root[6] - ox) * ix;
        const float ay = (root[4] - oy) * iy, by = (root[7] - oy) * iy;
        const float az = (root[5] - oz) * iz, bz = (root[8] - oz) * iz;
        const float r_near = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
        const float r_far = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
        const bool root_hit = r_far >= fmaxf(r_near, 0.f) - 1e-4f;
        bound = fminf(root_hit ? r_far + 1e-3f : 0.f, draw);
      }
      ray_d[r] = make_float4(dx, dy, dz, draw);
      ray_i[r] = make_float4(ix, iy, iz, bound);
      ray_tri[r] = -1;
    }
  }

  const int cnt = count[tile];
  const float* tb = boxes + (size_t)tile * kmax * 8;
  const int* tc = cand + (size_t)tile * kmax;
  // the copy of candidate kk's raw slots into ring stage kk % stages; each
  // thread copies the slots it stages itself
  const auto issue = [&](int kk) {
    if (kk < cnt) {
      const int c = tc[kk];
      float* st = ring + (kk % stages) * kRows * n_slots;
      const float* g = geom9 + (size_t)c * 9 * lpad;
      const int* ids = slot_mat + (size_t)c * n_slots;
      for (int s = tid; s < n_slots; s += nthr) {
#pragma unroll
        for (int row = 0; row < 9; ++row) cp_async4(st + row * n_slots + s, g + row * lpad + s);
        cp_async4(st + 9 * n_slots + s, ids + s);
      }
    }
    cp_async_commit();
  };
  for (int kk = 0; kk < dist; ++kk) issue(kk);
  __syncthreads();                           // counters and sub_bits zeroed

  float wb = __int_as_float(0x7f800000);
  int k = 0, n_mt = 0;
  for (; k < cnt; ++k) {
    const int par = k & 1;
    float* rec = recs + par * kRec * n_slots;
    // stage candidate k's records from this thread's own ring copies
    issue(k + dist);
    cp_async_wait(dist);
    int my_fill = 0;
    {
      const float* st = ring + (k % stages) * kRows * n_slots;
      for (int s = tid; s < n_slots; s += nthr) {
        const float p1x = st[s], p1y = st[n_slots + s], p1z = st[2 * n_slots + s];
        const float e1x = st[3 * n_slots + s], e1y = st[4 * n_slots + s];
        const float e1z = st[5 * n_slots + s];
        const float e2x = st[6 * n_slots + s], e2y = st[7 * n_slots + s];
        const float e2z = st[8 * n_slots + s];
        const int id = __float_as_int(st[9 * n_slots + s]);
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
        float m[kRec];
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
        bool live = id >= 0;
#pragma unroll
        for (int i = 0; i < 10; ++i) live |= m[i] != 0.f;
        m[10] = __int_as_float(id);
        m[11] = 0.f;
        float4* out = reinterpret_cast<float4*>(rec + s * kRec);
        out[0] = make_float4(m[0], m[1], m[2], m[3]);
        out[1] = make_float4(m[4], m[5], m[6], m[7]);
        out[2] = make_float4(m[8], m[9], m[10], m[11]);
        if (live) my_fill = s + 1;
      }
    }
    my_fill = __reduce_max_sync(kFull, my_fill);
    if (lane == 0) w_fill[par][warp] = my_fill;

    // box test of this thread's rays; the passing ones join the list
    const float b0 = tb[k * 8 + 0] - ox, b3 = tb[k * 8 + 3] - ox;
    const float b1 = tb[k * 8 + 1] - oy, b4 = tb[k * 8 + 4] - oy;
    const float b2 = tb[k * 8 + 2] - oz, b5 = tb[k * 8 + 5] - oz;
    int pos[kMaxHome];
    unsigned mine = 0u;
    float wmax = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxHome; ++j) {
      pos[j] = -1;
      if (j < nh) {
        const int r = tid + j * nthr;
        const float4 rd = ray_d[r], ri = ray_i[r];
        const float ax = b0 * ri.x, bx = b3 * ri.x;
        const float ay = b1 * ri.y, by = b4 * ri.y;
        const float az = b2 * ri.z, bz = b5 * ri.z;
        const float t_near = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
        const float t_far = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
        const float lim = kV2 ? fminf(rd.w, ri.w) : rd.w;
        const bool ok = (t_far >= fmaxf(t_near, 0.f) - 1e-4f) && (t_near < lim);
        if (kV2) wmax = fmaxf(wmax, lim);
        const unsigned bal = __ballot_sync(kFull, ok);
        if (bal) {                           // uniform over the warp
          const int take = compact ? __popc(bal) : 32;
          int base = 0;
          if (lane == 0) base = atomicAdd(&n_list[par], take);
          base = __shfl_sync(kFull, base, 0);
          const int at = compact ? base + __popc(bal & ((1u << lane) - 1u)) : base + lane;
          if (ok || !compact) list[at] = ok ? r : ~r;
          if (ok) pos[j] = at;
        }
        mine |= (unsigned)ok << j;
      }
    }
    if (kV2) {
      // the maximum of non-negative floats: their bit patterns order alike
      const unsigned mx = __reduce_max_sync(kFull, __float_as_uint(wmax));
      if (lane == 0) w_max[par][warp] = __uint_as_float(mx);
    }
    __syncthreads();                         // list, records and maxima ready

    if (kV2) {
      // the tile-wide maximum of min(best, bound) after candidate k - 1
      // (each warp reduces the warps' maxima, non-negative floats, as bits)
      const unsigned mx = __reduce_max_sync(
          kFull, lane < nwarps ? __float_as_uint(w_max[par][lane]) : 0u);
      wb = fminf(wb, __uint_as_float(mx));
      if (!(tb[k * 8 + 6] < wb)) break;      // uniform over the CTA
    }
    const int n = n_list[par];
    if (n == 0) continue;                    // uniform; nothing was marked
    if (kCountSubs) {
#pragma unroll
      for (int j = 0; j < kMaxHome; ++j) {
        if ((mine >> j) & 1u) {
          const int q = (tid + j * nthr) / sub_len;
          atomicOr(&sub_bits[q >> 5], 1u << (q & 31));
        }
      }
    }
    int fill = n_slots;
    if (!(levers & kLeverAllSlots)) {
      fill = __reduce_max_sync(kFull, lane < nwarps ? w_fill[par][lane] : 0);
    }
    // R rays a thread, per_group threads a slot group (not rounded to a
    // warp: a warp across two groups reads two records a load), at most 16
    // groups; every thread but the last of a group holds R list rays
    int r_eff = n >= 128 ? 4 : (n >= 64 ? 2 : 1);
    if (levers & kLeverOneRay) r_eff = 1;
    if (levers & kLeverFourRays) r_eff = 4;
    r_eff = max(r_eff, (n + nthr - 1) / nthr);
    if (r_eff == 3) r_eff = 4;
    const int per_group = (n + r_eff - 1) / r_eff;
    const int groups = min(16, nthr / per_group);
    const int grp = tid / per_group, gi = tid - grp * per_group;
    if (grp < groups) {
      if (r_eff == 4)
        slot_loop<kV2, 4>(rec, ray_d, list, n, fill, groups, grp, gi, eps, eps2_det, red_t, red_i);
      else if (r_eff == 2)
        slot_loop<kV2, 2>(rec, ray_d, list, n, fill, groups, grp, gi, eps, eps2_det, red_t, red_i);
      else
        slot_loop<kV2, 1>(rec, ray_d, list, n, fill, groups, grp, gi, eps, eps2_det, red_t, red_i);
    }
    __syncthreads();                         // the groups' minima ready
    if (tid == 0) {
      // n_list[par] is next added to at step k + 2, after the next barrier
      n_list[par] = 0;
      if (kCountSubs) {
        // sub_bits are next set after the next barrier, which thread 0
        // reaches only after clearing them here
        for (int w = 0; w < (n_sub + 31) / 32; ++w) {
          n_mt += __popc(sub_bits[w]);
          sub_bits[w] = 0u;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxHome; ++j) {
      if (pos[j] < 0) continue;
      const int r = tid + j * nthr;
      float t = red_t[pos[j]];
      int tie = red_i[pos[j]];
      for (int q = 1; q < groups; ++q) {
        const float tq = red_t[q * n + pos[j]];
        const int iq = red_i[q * n + pos[j]];
        if (tq < t || (tq == t && iq < tie)) {
          t = tq;
          tie = iq;
        }
      }
      // tie is INT_MAX when no slot beat the ray's best
      if (tie != INT_MAX && t < ray_d[r].w) {
        ray_d[r].w = t;
        ray_tri[r] = kV2 ? __float_as_int(rec[tie * kRec + 10]) : tie;
      }
    }
  }
  cp_async_wait(0);
  if (tid == 0) {
    steps[2 * tile] = k;
    steps[2 * tile + 1] = n_mt;
  }
#pragma unroll
  for (int j = 0; j < kMaxHome; ++j) {
    if (j < nh) {
      const int r = tid + j * nthr;
      out_t[(size_t)tile * p + r] = ray_d[r].w;
      out_tri[(size_t)tile * p + r] = ray_tri[r];
    }
  }
}

// Dynamic shared memory of one CTA (see the kernel's layout).
size_t smem_bytes(int p, int threads, int n_slots, int dist) {
  return (size_t)p * (2 * sizeof(float4) + 2 * sizeof(int))
       + (size_t)2 * kRec * n_slots * sizeof(float)
       + (size_t)4 * threads * (sizeof(float) + sizeof(int))
       + (size_t)(dist + 1) * kRows * n_slots * sizeof(float);
}

}  // namespace

// Kernels K4 (gen 4) and K5 (gen 5). `order` (n_tiles ints of scratch) or
// null: with it the tiles are taken in descending order of count, ordered
// by one small kernel launched first. `dist` is the prefetch distance in
// candidates (0-3; lowered while the ring does not fit); `levers` switch
// the fill cut, the compaction and the choice of rays a thread off for
// measurement.
extern "C" int tile_intersect_launch(const void* d, const void* cand, const void* count,
                                     const void* boxes, const void* root,
                                     const void* geom9, const void* slot_mat, void* order,
                                     void* out_t, void* out_tri, void* steps,
                                     int n_tiles, int p, int kmax, int n_slots, int lpad,
                                     int n_sub, int gen, int count_subs, int levers,
                                     int dist, float eps, float k1, float eps2_det,
                                     float draw, void* stream) {
  const int threads = p < kThreads ? p : kThreads;
  if (p % 32 || p % threads || p / threads > kMaxHome || n_sub < 1
      || n_sub > 32 * kMaxSubWords || p % n_sub || n_slots < 1 || dist < 0
      || dist > 3 || !(eps > 0.f))
    return (int)cudaErrorInvalidValue;
  constexpr size_t kSmemMax = 232448 - 4096;  // the opt-in limit less the static arrays
  while (dist > 0 && smem_bytes(p, threads, n_slots, dist) > kSmemMax) --dist;
  const size_t smem = smem_bytes(p, threads, n_slots, dist);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto kernel = gen == 4 ? (count_subs ? tile_intersect_kernel<true, true>
                                       : tile_intersect_kernel<true, false>)
                         : (count_subs ? tile_intersect_kernel<false, true>
                                       : tile_intersect_kernel<false, false>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (order) {
    longest_first_kernel<<<1, 1024, 0, s>>>(static_cast<const int*>(count), n_tiles,
                                            kmax, static_cast<int*>(order));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_tiles, threads, smem, s>>>(
      static_cast<const float*>(d), static_cast<const int*>(cand),
      static_cast<const int*>(count), static_cast<const float*>(boxes),
      static_cast<const float*>(root), static_cast<const float*>(geom9),
      static_cast<const int*>(slot_mat), static_cast<const int*>(order),
      static_cast<float*>(out_t), static_cast<int*>(out_tri), static_cast<int*>(steps),
      p, kmax, n_slots, lpad, n_sub, levers, dist, eps, k1, eps2_det, draw);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K14: the cluster paths' cull, one pass of it in one launch: each tile's
// frustum test of the cluster boxes, its stable nearest-k candidate list,
// and, as an epilogue, the candidates' boxes for K4 / K5.
//
// It replaces no Pallas kernel: the JAX package culls in plain jnp
// (cpp_cuda_raytracer_dev_tpu/accel/traverse.py `cull_tiles_hier`,
// `cull_tiles`, `_candidate_boxes`), and so does K14's plain twin in
// accel/traverse.py (`cull_tiles_reference`, `cull_tiles_hier_reference`,
// `_candidate_boxes`), about 290 operations of a "pallas2" frame and
// (n, 4, C) temporaries a pass. The contract, per tile t:
//
//   frustum: the corner rays c00, c01, c10, c11 (P-axis positions
//          0, i01, i10, i11 of tiles[t]) and the centre m = center[t] (the
//          tiles' mean over P, computed by the caller); the normals
//          n_j = cross(a_j, b_j) over the pairs (c00, c01), (c01, c11),
//          (c11, c10), (c10, c00), each times s = sign(dot(n_j, m)) (1
//          where that is 0). A box (lo, hi) is visible when for every j
//          (n_jx h_x + n_jy h_y) + n_jz h_z >= 0, h_a = (n_ja > 0 ? hi_a :
//          lo_a) - o_a. Its key is dot((lo + hi) / 2 - o, m), every dot as
//          (x0 y0 + x1 y1) + x2 y2.
//   flat (group 0): the positions are the C clusters.
//   two levels (group > 0): first the ng = ceil(C / group) group boxes
//          (the members' union; `cluster_group_box_kernel` before the
//          cull), of which the kg nearest are kept (gsel); then the
//          positions j < kg group, cluster cl = gsel[j / group] group +
//          j % group, visible only where its group was visible and cl < C
//          (the padded tail takes cluster C - 1 as its id, as the twin's
//          clamp does).
//   list:  the positions sorted by (key, position) with invisible ones
//          keyed +inf, the first k: torch.sort(key, stable=True)
//          .indices[:k], the visible nearest first, then the invisible in
//          ascending order. cand = their cluster ids; count = min(nvis,
//          k); overflow = max(nvis - k, 0), plus for two levels
//          max(ngvis - kg, 0) group.
//   boxes (where boxes is not null): row j = bmin | bmax | the suffix
//          minimum over j' >= j of dist(cand[j']) (3e38 for j' >= count)
//          | 0, with dist(c) = sqrt((g_x g_x + g_y g_y) + g_z g_z), g =
//          max(max(bmin - o, o - bmax), 0).
//
// Design: one CTA of 256 threads a tile. Per level, each thread tests one
// position of each run of 256 (coalesced reads of the bounds, which stay
// in L1 / L2: 196 KB at 8,192 clusters); a warp's ballot is one word of a
// visibility mask, and one block scan of the words' counts gives each word
// the visible positions before it. Each thread then places its own
// positions at once: a visible one as a 64-bit (ordered key bits,
// position) pair at its index-order place in the pair buffer, an invisible
// one that the list reaches straight into the list's tail. A bitonic sort
// of the visible pairs alone, padded to a power of two, orders them (two
// pairs never compare equal: -0 and +0 are one key, as the twin's
// comparison has them), so the sort's cost follows the visible count, not
// C.
//
// The workspace (pairs, mask, the counts before each mask word, the kept
// groups) is sized for the largest level, every position visible. Where
// it fits (up to 16,384 positions a level) it is shared memory and the
// grid is a CTA a tile; where it does not, it is the CTA's slice of a
// global scratch buffer the launcher's caller allocates
// (`cluster_cull_scratch` bytes a CTA), and a grid of `blocks` CTAs walks
// the tiles, so any cluster count is culled, in the same steps.
//
// Bound: the box tests, 30 operations each (six differences; per plane
// three products, two sums and the test; the planes' choice of corner is
// the tile's, and the keys of visible boxes, 14 more, are left out), 3.1M
// a "pallas2" frame at the published scene: about 3 us of the card's FP32
// issue; the bounds read (24 bytes a cluster) and the lists and boxes
// written (36 bytes a candidate, 2.4 MB for the first pass's 1,020 tiles
// at 64, 1.2 MB for 256 escalated tiles at 128) take under a microsecond
// of HBM. A pass is set by its barriers and its placement, not by the
// card's peaks.
//
// Numerics: built with -fmad=false, every product and sum rounds as the
// twin's separate operations; division by 2 and sqrt are exact / IEEE.

namespace {

constexpr int kCullThreads = 256;
constexpr int kCullWarps = kCullThreads / 32;
constexpr int kCullSharedPos = 16384;  // the largest level held in shared memory
constexpr int kCullMostPos = 1 << 30;  // the largest level at all
constexpr float kCullFar = 3.0e38f;    // the boxes' distance past count

struct Frustum {
  float n[4][3];                       // inward plane normals
  float m[3];                          // the tile's mean direction
  float o[3];                          // the rays' origin
};

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

__device__ Frustum tile_frustum(const float* __restrict__ tiles,
                                const float* __restrict__ center,
                                const float* __restrict__ origin, int tile,
                                int p, int i01, int i10, int i11) {
  Frustum f;
  const float* base = tiles + (size_t)tile * p * 3;
  float c[4][3];                       // c00, c01, c11, c10
  const int at[4] = {0, i01, i11, i10};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int a = 0; a < 3; ++a) c[j][a] = base[(size_t)at[j] * 3 + a];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    f.m[a] = center[(size_t)tile * 3 + a];
    f.o[a] = origin[a];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float* x = c[j];
    const float* y = c[(j + 1) & 3];
    float n[3] = {x[1] * y[2] - x[2] * y[1], x[2] * y[0] - x[0] * y[2],
                  x[0] * y[1] - x[1] * y[0]};
    const float d = dot3(n, f.m);
    const float s = d > 0.f ? 1.f : (d < 0.f ? -1.f : 1.f);
#pragma unroll
    for (int a = 0; a < 3; ++a) f.n[j][a] = n[a] * s;
  }
  return f;
}

__device__ __forceinline__ bool box_visible(const Frustum& f,
                                            const float* __restrict__ lo,
                                            const float* __restrict__ hi) {
  float l[3], h[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    l[a] = lo[a] - f.o[a];
    h[a] = hi[a] - f.o[a];
  }
  bool vis = true;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float t0 = f.n[j][0] * (f.n[j][0] > 0.f ? h[0] : l[0]);
    const float t1 = f.n[j][1] * (f.n[j][1] > 0.f ? h[1] : l[1]);
    const float t2 = f.n[j][2] * (f.n[j][2] > 0.f ? h[2] : l[2]);
    vis &= (t0 + t1) + t2 >= 0.f;
  }
  return vis;
}

__device__ __forceinline__ float box_key(const Frustum& f,
                                         const float* __restrict__ lo,
                                         const float* __restrict__ hi) {
  float c[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) c[a] = (lo[a] + hi[a]) / 2.f - f.o[a];
  return dot3(c, f.m);
}

// (key, position) as one 64-bit word whose unsigned order is the pair's
// lexicographic order; -0 is taken as +0.
__device__ __forceinline__ unsigned long long pair_word(float key, int pos) {
  unsigned b = key == 0.f ? 0u : __float_as_uint(key);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)b << 32) | (unsigned)pos;
}

// Exclusive prefix sum of v over the CTA; *total gets the sum.
__device__ int block_exclusive_sum(int v, int* warp_sum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kCullWarps; ++w) {
    const int s = warp_sum[w];
    before += w < warp ? s : 0;
    all += s;
  }
  __syncthreads();                           // warp_sum is free again
  *total = all;
  return before + x - v;
}

// Ascending bitonic sort of buf[0, n), n a power of two; ends on a barrier.
__device__ void bitonic_sort(unsigned long long* buf, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += kCullThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = buf[lo], b = buf[hi];
        if ((a > b) == ((lo & size) == 0)) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// One level of the cull: the positions [0, n) sorted by (key, position)
// with the invisible keyed +inf, the first k passed to out(j, id(pos)).
// Returns the visible count. mask and before hold ceil(n / 256) * 8 words
// each and buf the next power of two >= n pairs; ends on a barrier.
template <class Vis, class Key, class Id, class Out>
__device__ int select_nearest(int n, int k, Vis vis, Key key, Id id, Out out,
                              unsigned long long* buf, unsigned* mask,
                              int* before, int* warp_sum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int base = 0; base < n; base += kCullThreads) {
    const int pos = base + tid;
    const unsigned bits = __ballot_sync(kFull, pos < n && vis(pos));
    if (lane == 0) mask[(base >> 5) + warp] = bits;
  }
  __syncthreads();
  // the visible positions before each mask word: a thread a run of words
  const int words = (n + 31) >> 5;
  const int per = (words + kCullThreads - 1) / kCullThreads;
  const int w0 = min(tid * per, words), w1 = min(w0 + per, words);
  int mine = 0;
  for (int w = w0; w < w1; ++w) mine += __popc(mask[w]);
  int nvis;
  int at = block_exclusive_sum(mine, warp_sum, &nvis);
  for (int w = w0; w < w1; ++w) {
    before[w] = at;
    at += __popc(mask[w]);
  }
  __syncthreads();
  // each visible position's pair at its place in index order; the
  // invisible ones that the list reaches straight to their place in it
  for (int pos = tid; pos < n; pos += kCullThreads) {
    const unsigned bits = mask[pos >> 5];
    const int vis_before = before[pos >> 5] + __popc(bits & ((1u << lane) - 1u));
    if ((bits >> lane) & 1u)
      buf[vis_before] = pair_word(key(pos), pos);
    else if (nvis + pos - vis_before < k)
      out(nvis + pos - vis_before, id(pos));
  }
  // the visible pairs, padded to a power of two, sorted
  int m2 = 1;
  while (m2 < nvis) m2 <<= 1;
  for (int i = nvis + tid; i < m2; i += kCullThreads) buf[i] = ~0ull;
  __syncthreads();
  bitonic_sort(buf, m2);
  for (int j = tid; j < min(k, nvis); j += kCullThreads)
    out(j, id((int)(buf[j] & 0xffffffffu)));
  __syncthreads();
  return nvis;
}

// The union of each group's member boxes, a warp a group.
__global__ void __launch_bounds__(256)
cluster_group_box_kernel(const float* __restrict__ bmin,
                         const float* __restrict__ bmax, int c, int group,
                         int ng, float* __restrict__ gbox) {
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= ng) return;                       // whole warps
  const int first = g * group, last = min(first + group, c);
  const float inf = __int_as_float(0x7f800000);
  float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
  for (int i = first + lane; i < last; i += 32) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], bmin[(size_t)i * 3 + a]);
      hi[a] = fmaxf(hi[a], bmax[(size_t)i * 3 + a]);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(kFull, lo[a], d));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFull, hi[a], d));
    }
  }
  if (lane < 3) {
    gbox[(size_t)g * 6 + lane] = lo[lane];
    gbox[(size_t)g * 6 + 3 + lane] = hi[lane];
  }
}

// The candidates' boxes of one tile (the contract's "boxes").
__device__ void candidate_boxes_of(const int* __restrict__ cand, int kk,
                                   int cnt, const float* __restrict__ bmin,
                                   const float* __restrict__ bmax,
                                   const float* __restrict__ origin,
                                   float* __restrict__ out, int* warp_min) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (kk + kCullThreads - 1) / kCullThreads;
  const int j0 = min(tid * per, kk), j1 = min(j0 + per, kk);
  const float ox = origin[0], oy = origin[1], oz = origin[2];
  const auto dist = [&](int j) {
    if (j >= cnt) return kCullFar;
    const int c = cand[j];
    const float* lo = bmin + (size_t)c * 3;
    const float* hi = bmax + (size_t)c * 3;
    const float gx = fmaxf(fmaxf(lo[0] - ox, ox - hi[0]), 0.f);
    const float gy = fmaxf(fmaxf(lo[1] - oy, oy - hi[1]), 0.f);
    const float gz = fmaxf(fmaxf(lo[2] - oz, oz - hi[2]), 0.f);
    return sqrtf((gx * gx + gy * gy) + gz * gz);
  };
  float mine = kCullFar;
  for (int j = j0; j < j1; ++j) mine = fminf(mine, dist(j));
  // the minimum over the threads after this one (exact in any order)
  float after = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_down_sync(kFull, after, d);
    if (lane + d < 32) after = fminf(after, y);
  }
  if (lane == 0) warp_min[warp] = __float_as_int(after);
  __syncthreads();
  float run = __shfl_down_sync(kFull, after, 1);
  if (lane == 31) run = kCullFar;
  for (int w = warp + 1; w < kCullWarps; ++w)
    run = fminf(run, __int_as_float(warp_min[w]));
  for (int j = j1 - 1; j >= j0; --j) {
    run = fminf(run, dist(j));
    const int c = cand[j];
    const float* lo = bmin + (size_t)c * 3;
    const float* hi = bmax + (size_t)c * 3;
    float4* row = reinterpret_cast<float4*>(out + (size_t)j * 8);
    row[0] = make_float4(lo[0], lo[1], lo[2], hi[0]);
    row[1] = make_float4(hi[1], hi[2], run, 0.f);
  }
  __syncthreads();
}

// The workspace of the largest level: cap pairs, the mask and the counts
// before its words (cap / 32 words each), the kg kept groups.
// cap is the next power of two >= the level's positions (at least 256);
// bytes is a multiple of 8.
struct CullWork {
  long long most = 0;                  // positions of the largest level
  int cap = 256;
  size_t bytes = 0;
  CullWork(int c, int group, int kg) {
    const long long ng = group > 0 ? ((long long)c + group - 1) / group : 0;
    const long long members = (long long)kg * group;
    most = group > 0 ? (ng > members ? ng : members) : c;
    while (cap < most && cap < kCullMostPos) cap <<= 1;
    bytes = (size_t)cap * 8 + (size_t)cap / 32 * 8
          + ((size_t)(group > 0 ? kg : 0) * 4 + 7) / 8 * 8;
  }
  bool shared() const { return cap <= kCullSharedPos; }
};

// kScratch: the workspace is the CTA's slice of scratch, else shared
// memory (a separate instance, so that its accesses are known shared).
template <bool kScratch>
__global__ void __launch_bounds__(kCullThreads)
cluster_cull_kernel(const float* __restrict__ tiles,    // (nT, P, 3)
                    const float* __restrict__ center,   // (nT, 3)
                    const float* __restrict__ origin,   // (3,)
                    const float* __restrict__ bmin,     // (C, 3)
                    const float* __restrict__ bmax,     // (C, 3)
                    const float* __restrict__ gbox,     // (ng, 6), two levels
                    int* __restrict__ cand,             // (nT, K)
                    int* __restrict__ count,            // (nT,)
                    int* __restrict__ overflow,         // (nT,)
                    float* __restrict__ boxes,          // (nT, K, 8) or null
                    unsigned long long* scratch,        // a workspace a CTA
                    size_t work_words, int n_tiles, int p, int c, int k,
                    int group, int ng, int kg, int i01, int i10, int i11,
                    int cap) {
  extern __shared__ unsigned long long cull_smem[];
  __shared__ int warp_sum[kCullWarps];
  unsigned long long* buf =                                 // cap pairs
      kScratch ? scratch + (size_t)blockIdx.x * work_words : cull_smem;
  unsigned* mask = reinterpret_cast<unsigned*>(buf + cap);  // cap / 32
  int* before = reinterpret_cast<int*>(mask + cap / 32);    // cap / 32
  int* gsel = before + cap / 32;                            // kg
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const Frustum f = tile_frustum(tiles, center, origin, tile, p, i01, i10,
                                   i11);
    int* tc = cand + (size_t)tile * k;
    const auto to_cand = [&](int j, int id) { tc[j] = id; };
    int nvis, extra = 0;
    if (group == 0) {
      nvis = select_nearest(
          c, k,
          [&](int q) { return box_visible(f, bmin + 3 * q, bmax + 3 * q); },
          [&](int q) { return box_key(f, bmin + 3 * q, bmax + 3 * q); },
          [](int q) { return q; }, to_cand, buf, mask, before, warp_sum);
    } else {
      const int ngvis = select_nearest(
          ng, kg,
          [&](int g) { return box_visible(f, gbox + 6 * g, gbox + 6 * g + 3); },
          [&](int g) { return box_key(f, gbox + 6 * g, gbox + 6 * g + 3); },
          [](int g) { return g; }, [&](int j, int g) { gsel[j] = g; }, buf,
          mask, before, warp_sum);
      const auto raw = [&](int j) { return gsel[j / group] * group + j % group; };
      nvis = select_nearest(
          kg * group, k,
          [&](int j) {
            const int q = raw(j);
            return j / group < ngvis && q < c
                && box_visible(f, bmin + 3 * q, bmax + 3 * q);
          },
          [&](int j) {
            const int q = min(raw(j), c - 1);
            return box_key(f, bmin + 3 * q, bmax + 3 * q);
          },
          [&](int j) { return min(raw(j), c - 1); }, to_cand, buf, mask,
          before, warp_sum);
      extra = max(ngvis - kg, 0) * group;
    }
    const int cnt = min(nvis, k);
    if (threadIdx.x == 0) {
      count[tile] = cnt;
      overflow[tile] = max(nvis - k, 0) + extra;
    }
    if (boxes)
      candidate_boxes_of(tc, k, cnt, bmin, bmax, origin,
                         boxes + (size_t)tile * k * 8, warp_sum);
  }
}

}  // namespace

// The global scratch bytes a CTA of K14 needs at these sizes: 0 where its
// workspace fits in shared memory (a level of at most 16,384 positions).
extern "C" size_t cluster_cull_scratch(int c, int group, int kg) {
  const CullWork w(c, group, kg);
  return w.shared() ? 0 : w.bytes;
}

// Kernel K14 (one launch a pass; for two levels `cluster_group_box_kernel`
// first, into gbox, ng * 6 floats of scratch). group 0: the flat cull of
// the c clusters; group > 0: two levels through groups of `group`, the kg
// nearest. boxes may be null. scratch: null, or blocks x
// cluster_cull_scratch(c, group, kg) bytes where that is not 0.
extern "C" int cluster_cull_launch(const void* tiles, const void* center,
                                   const void* origin, const void* bmin,
                                   const void* bmax, void* gbox, void* cand,
                                   void* count, void* overflow, void* boxes,
                                   void* scratch, int blocks, int n_tiles,
                                   int p, int c, int k, int group, int kg,
                                   int i01, int i10, int i11, void* stream) {
  const int ng = group > 0 ? (int)(((long long)c + group - 1) / group) : 0;
  if (n_tiles < 0 || c < 1 || k < 1 || group < 0
      || (group == 0 && k > c)
      || (group > 0 && (kg < 1 || kg > ng || k > (long long)kg * group)))
    return (int)cudaErrorInvalidValue;
  const CullWork w(c, group, kg);
  if (w.most > kCullMostPos || (!w.shared() && (!scratch || blocks < 1)))
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  const size_t smem = w.shared() ? w.bytes : 0;
  const int grid = w.shared() ? n_tiles : min(blocks, n_tiles);
  const auto kernel = w.shared() ? cluster_cull_kernel<false>
                                 : cluster_cull_kernel<true>;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (group > 0) {
    cluster_group_box_kernel<<<(ng + 7) / 8, 256, 0, s>>>(
        static_cast<const float*>(bmin), static_cast<const float*>(bmax), c, group,
        ng, static_cast<float*>(gbox));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kCullThreads, smem, s>>>(
      static_cast<const float*>(tiles), static_cast<const float*>(center),
      static_cast<const float*>(origin), static_cast<const float*>(bmin),
      static_cast<const float*>(bmax), static_cast<const float*>(gbox),
      static_cast<int*>(cand), static_cast<int*>(count), static_cast<int*>(overflow),
      static_cast<float*>(boxes), static_cast<unsigned long long*>(scratch),
      w.bytes / 8, n_tiles, p, c, k, group, ng, kg, i01, i10, i11, w.cap);
  return (int)cudaGetLastError();
}
