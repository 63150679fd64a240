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
