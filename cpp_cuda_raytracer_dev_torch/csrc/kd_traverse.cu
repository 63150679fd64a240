// Per-ray KD-tree stack traversal: kernel K7 of the "kd" method.
//
// Counterpart of the JAX package's on-device loop in `kd_intersect`
// (cpp_cuda_raytracer_dev_tpu/accel/traverse.py:750, its
// `jax.lax.while_loop` at :876), not of a Pallas kernel: JAX runs every ray
// in lockstep, one (pop, test, push) step a loop iteration, until every
// stack is empty. Here each thread walks one ray to its own end, as the
// reference's traversal does (Trixel.cu:41-172). It computes what the
// plain PyTorch version computes (ops/cuda/kd_traverse.py
// `kd_traverse_reference`, near-first), bit for bit in t and ids:
//
//   pop:   node = stack[sp], sp -= 1; the root is stack[0] at sp = 0; the
//          ray is done when sp < 0.
//   exit:  (near-first) slab-test the popped node's box grown by pad =
//          c_pad * (max |o| + max |root box|) on every side; skip the node
//          when that entry t exceeds bound = best_t * c_rel + c_abs, and a
//          popped leaf also when t_far = (that exit t) * c_rel + c_abs is
//          below 0 or the entry t exceeds t_far * c_rel + c_abs (the margin,
//          and the grazing hits for which it is exact: kd_traverse.py
//          `NEAR_REL`). A NaN slab t keeps the node.
//   leaf:  Moller-Trumbore over its slots [start, start + count); reject
//          when |det| < eps, u < eps, v < eps, u + v > 1 + eps or t < eps.
//          The lowest slot at the leaf's minimum t wins, and it replaces
//          the ray's best only on a strictly smaller t.
//   node:  slab test t0 = (bmin - o) / d, t1 = (bmax - o) / d (times the
//          IEEE reciprocal of d), t_entry = max over axes of min(t0, t1),
//          t_exit = min of max(t0, t1), all NaN-propagating as torch's
//          minimum / amax are (a zero direction component on a box plane
//          gives 0 * inf = NaN, and then the box is missed); hit when
//          t_exit >= t_entry - eps and t_entry > -eps (Trixel.cu:146). On a
//          hit the children are pushed by the s1/s2 rule (Trixel.cu:
//          155-163), the far one first (when its side is reached) and the
//          near one last, so that it is popped first. A push writes at
//          clamp(sp, 0, depth - 1).
//   miss:  t = draw_distance, id -1.
// With lever (a) off there is no exit: a popped leaf runs MT without a box
// test, which is the plain version with near_first=False (JAX's loop).
//
// The arithmetic is the plain version's operation for operation: every
// product and sum rounded on its own (built with -fmad=false), the dot
// products summed as (x + y) + z, the reciprocals IEEE divisions, the
// epsilons and the margin's constants in the rays' type except s1 + eps
// and s2 +- eps, which the plain version takes in float32 (its split planes
// are float32). A template over the rays' type T serves float32 and float64
// (the node tables stay float32 and are widened exactly).
//
// Tables (made once per KDTables, accel/traverse.py): node_box (N, 8) f32
// = (bmin xyz, s1, bmax xyz, s2), two 16-byte loads a node; node_link (N, 4)
// i32 = (-1, leaf_start, leaf_count, 0) at a leaf, (axis, left, right, 0)
// at an internal node; slot_geom (T, 12) = (p1, 0, e1, 0, e2, 0) in T and
// perm (T,) i32, both in leaf order.
//
// Bound: operations. Per slab test about 36 (6 subtractions and 6
// products, 10 minima and maxima, 3 for the hit test, 11 for the children's
// order, or the exit's tests at a leaf) and per (ray, slot) pair about 54
// (two cross products 18, three dot products 15 and det's 5, tvec 3, the
// reciprocal and its select 2, three products by it 3, the acceptance
// tests 7, the running minimum 1), at one instruction an operation; the
// bytes (rays in, t and ids out, the tables once) are a few tens of
// megabytes. The counts depend on the data: chip_smoke.py counts them from
// the plain run. At headline frame 0 (960x540, leaf 128) a ray tests 1,872
// slots and 66 nodes without the exit and 477 slots and 32 nodes with it;
// the issue bound falls from 1.60 to 0.42 ms, and K7 runs in about 1.56 ms
// (float32; 2.3 ms in float64) on an H100 SXM, where it took 12.6 ms with a
// thread a ray in index order, no exit and nine scalar loads a slot. What
// is left is the MT loop run with lanes idle (a warp's rays hold leaves of
// unequal length, or none, in a round, and finish their walks at different
// times) and the dependent loads of the node walk.
//
// Design levers (`levers`, a bitmask; each bit switches one on, so that
// chip_smoke.py can time each against its absence; ops/cuda/kd_traverse.py
// `DESIGN` launches all three):
//   (a) kNearFirst: the exit above, at internal and leaf pops. It cuts the
//       pairs, the work that bounds K7, fourfold at the headline (off: 2.9x
//       slower).
//   (b) kPacked: a slot's geometry in 16-byte loads (three in float32, six
//       in float64) in place of nine scalar loads from the same table.
//   (d) kWarpBlocks: with the image width, a warp takes an 8x4 pixel block
//       (a CTA 16x8), not 32 pixels of one row, so its rays walk more of
//       the same nodes; outputs are still written in pixel order (off:
//       18-24% slower).
// Three more measured slower than their absence on an H100 and were taken
// out (PERF.md): (c) sign rejects before MT's division (their branches
// split the warp inside the slot loop), (d)'s staging of a leaf that every
// lane of a warp pops in shared memory (lanes reading one slot are already
// served by one cache request) and (e) the stack in shared memory (the L1
// cache holds the local-memory stack as well).
// The traversal is while-while: each lane walks internal nodes until it
// holds a leaf to intersect (or its stack is empty), then the warp
// intersects its lanes' leaves together, so that MT runs with the lanes
// converged. No atomics, no host read: the launch captures into a CUDA
// graph.

#include <cuda_runtime.h>

namespace {

// with the image width (lever (d)) a CTA takes a kTileW x kTileH pixel tile,
// a warp an 8x4 block of it
constexpr int kTileW = 16, kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kMaxStack = 64;
constexpr unsigned kFull = 0xffffffffu;

enum : int {
  kNearFirst = 1,
  kPacked = 2,
  kWarpBlocks = 4,
  kAllLevers = 7,
};

// torch.minimum / torch.maximum: NaN when either operand is NaN
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}

// a slot's (p1, e1, e2) from slot_geom: 16-byte loads, or nine scalar ones
template <typename T>
struct Slot {
  T p1x, p1y, p1z, e1x, e1y, e1z, e2x, e2y, e2z;
};

template <typename T>
__device__ __forceinline__ Slot<T> scalar_slot(const T* geom, int s) {
  const T* g = geom + 12 * s;
  return {g[0], g[1], g[2], g[4], g[5], g[6], g[8], g[9], g[10]};
}

template <bool kPackedT>
__device__ __forceinline__ Slot<float> load_slot(const float* geom, int s) {
  if constexpr (kPackedT) {
    const float4* g = reinterpret_cast<const float4*>(geom) + 3 * s;
    const float4 a = g[0], b = g[1], c = g[2];
    return {a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z};
  } else {
    return scalar_slot(geom, s);
  }
}

template <bool kPackedT>
__device__ __forceinline__ Slot<double> load_slot(const double* geom, int s) {
  if constexpr (kPackedT) {
    const double2* g = reinterpret_cast<const double2*>(geom) + 6 * s;
    const double2 a = g[0], b = g[1], c = g[2], e = g[3], f = g[4],
                  h = g[5];
    return {a.x, a.y, b.x, c.x, c.y, e.x, f.x, f.y, h.x};
  } else {
    return scalar_slot(geom, s);
  }
}

template <typename T>
struct Consts {
  T ox, oy, oz, eps, one_eps, seps, c_rel, c_abs, c_pad, pad;
  float seps_f;
};

// MT over one leaf's slots; (lmin, lslot) the lowest slot at the leaf's
// minimum t
template <typename T, bool kPackedT>
__device__ __forceinline__ void intersect_leaf(
    const Consts<T>& c, T dx, T dy, T dz, int start, int count,
    const T* __restrict__ geom, T& lmin, int& lslot) {
  for (int s = start; s < start + count; ++s) {
    const Slot<T> g = load_slot<kPackedT>(geom, s);
    const T px = dy * g.e2z - dz * g.e2y;            // pvec = d x e2
    const T py = dz * g.e2x - dx * g.e2z;
    const T pz = dx * g.e2y - dy * g.e2x;
    const T det = (g.e1x * px + g.e1y * py) + g.e1z * pz;
    const T adet = det < T(0) ? -det : det;
    const T tx = c.ox - g.p1x, ty = c.oy - g.p1y, tz = c.oz - g.p1z;
    const T unum = (tx * px + ty * py) + tz * pz;
    const T qx = ty * g.e1z - tz * g.e1y;            // qvec = tvec x e1
    const T qy = tz * g.e1x - tx * g.e1z;
    const T qz = tx * g.e1y - ty * g.e1x;
    const T vnum = (dx * qx + dy * qy) + dz * qz;
    const T tnum = (g.e2x * qx + g.e2y * qy) + g.e2z * qz;
    const T inv = T(1) / (det == T(0) ? T(1) : det);
    const T u = inv * unum, v = inv * vnum, t = inv * tnum;
    const bool ok = adet >= c.eps && u >= c.eps && v >= c.eps
                    && u + v <= c.one_eps && t >= c.eps;
    if (ok && t < lmin) {
      lmin = t;
      lslot = s;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kd_traverse_kernel(const T* __restrict__ origin,        // (3,)
                   const T* __restrict__ dirs,          // (R, 3)
                   int n_rays, int width,
                   const float4* __restrict__ node_box,  // (N, 2) float4
                   const int4* __restrict__ node_link,   // (N,)
                   const T* __restrict__ geom,           // (T, 12)
                   const int* __restrict__ perm,         // (T,)
                   int depth, int levers, T draw, Consts<T> c,
                   T* __restrict__ out_t, int* __restrict__ out_tri) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  c.ox = origin[0];
  c.oy = origin[1];
  c.oz = origin[2];
  {  // the exit's pad: c_pad * (max |o| + max |root box|)
    const float4 lo = node_box[0], hi = node_box[1];
    const float m = fmaxf(fmaxf(fmaxf(fabsf(lo.x), fabsf(lo.y)),
                                fmaxf(fabsf(lo.z), fabsf(hi.x))),
                          fmaxf(fabsf(hi.y), fabsf(hi.z)));
    const T ax = c.ox < T(0) ? -c.ox : c.ox, ay = c.oy < T(0) ? -c.oy : c.oy,
            az = c.oz < T(0) ? -c.oz : c.oz;
    const T mo = ax > ay ? (ax > az ? ax : az) : (ay > az ? ay : az);
    c.pad = (mo + T(m)) * c.c_pad;
  }

  // this thread's ray: an 8x4 block a warp (a CTA 16x8) of an image
  // `width` wide, or the next 128 rays in order
  int r;
  if (width > 0 && (levers & kWarpBlocks)) {
    constexpr int warps_x = kTileW / 8;
    const int tiles_x = (width + kTileW - 1) / kTileW;
    const int x = (blockIdx.x % tiles_x) * kTileW + (warp % warps_x) * 8
                  + (lane & 7);
    const int y = (blockIdx.x / tiles_x) * kTileH + (warp / warps_x) * 4
                  + (lane >> 3);
    r = x < width ? y * width + x : n_rays;
  } else {
    r = blockIdx.x * kThreads + threadIdx.x;
  }
  bool done = r >= n_rays;
  const int rr = done ? 0 : r;
  const T dx = dirs[3 * rr], dy = dirs[3 * rr + 1], dz = dirs[3 * rr + 2];
  const T ix = T(1) / dx, iy = T(1) / dy, iz = T(1) / dz;
  const bool near_first = levers & kNearFirst;
  const bool packed = levers & kPacked;

  int stack[kMaxStack];
  int sp = 0;
  stack[0] = 0;
  T best_t = draw;
  T bound = best_t * c.c_rel + c.c_abs;
  int best = -1;
  while (true) {
    // walk internal nodes until a leaf to intersect, or an empty stack
    int4 leaf = make_int4(-1, 0, 0, 0);
    while (!done) {
      if (sp < 0) {
        done = true;
        break;
      }
      const int node = stack[min(sp, depth - 1)];
      --sp;
      const int4 link = node_link[node];
      if (link.x < 0 && !near_first) {
        leaf = link;
        break;
      }
      const float4 lo = node_box[2 * node], hi = node_box[2 * node + 1];
      if (near_first) {
        // the box grown by the pad: beyond the best, or (a leaf) missed or
        // behind the ray, each by more than the margin; NaN keeps
        const T q0x = ((T(lo.x) - c.pad) - c.ox) * ix;
        const T q1x = ((T(hi.x) + c.pad) - c.ox) * ix;
        const T q0y = ((T(lo.y) - c.pad) - c.oy) * iy;
        const T q1y = ((T(hi.y) + c.pad) - c.oy) * iy;
        const T q0z = ((T(lo.z) - c.pad) - c.oz) * iz;
        const T q1z = ((T(hi.z) + c.pad) - c.oz) * iz;
        const T q_entry = nan_max(nan_max(nan_min(q0x, q1x),
                                          nan_min(q0y, q1y)),
                                  nan_min(q0z, q1z));
        if (q_entry > bound) continue;
        if (link.x < 0) {
          const T t_far = nan_min(nan_min(nan_max(q0x, q1x),
                                          nan_max(q0y, q1y)),
                                  nan_max(q0z, q1z)) * c.c_rel + c.c_abs;
          if (t_far < T(0) || q_entry > t_far * c.c_rel + c.c_abs) continue;
          leaf = link;
          break;
        }
      }
      const T t0x = (T(lo.x) - c.ox) * ix, t1x = (T(hi.x) - c.ox) * ix;
      const T t0y = (T(lo.y) - c.oy) * iy, t1y = (T(hi.y) - c.oy) * iy;
      const T t0z = (T(lo.z) - c.oz) * iz, t1z = (T(hi.z) - c.oz) * iz;
      const T t_entry = nan_max(nan_max(nan_min(t0x, t1x),
                                        nan_min(t0y, t1y)),
                                nan_min(t0z, t1z));
      const T t_exit = nan_min(nan_min(nan_max(t0x, t1x),
                                       nan_max(t0y, t1y)),
                               nan_max(t0z, t1z));
      // Trixel.cu:146: mint1 >= maxt0 - eps && maxt0 > -eps
      if (!(t_exit >= t_entry - c.seps && t_entry > -c.seps)) continue;
      const T d_ax = link.x == 0 ? dx : (link.x == 1 ? dy : dz);
      const T o_ax = link.x == 0 ? c.ox : (link.x == 1 ? c.oy : c.oz);
      const T c_entry = o_ax + t_entry * d_ax;
      const T c_exit = o_ax + t_exit * d_ax;
      const float s1e = lo.w + c.seps_f;
      const bool go_left_first = c_entry < T(hi.w + c.seps_f);  // :155
      const bool also_right = c_exit > T(hi.w - c.seps_f);       // :156
      const bool also_left = c_exit < T(s1e) || c_entry < T(s1e);  // :163
      if (go_left_first ? also_right : also_left) {
        ++sp;
        stack[min(max(sp, 0), depth - 1)] = go_left_first ? link.z : link.y;
      }
      ++sp;
      stack[min(max(sp, 0), depth - 1)] = go_left_first ? link.y : link.z;
    }
    if (__all_sync(kFull, done)) break;

    // the warp's leaves together
    T lmin = T(1) / T(0);
    int lslot = 0;
    if (!done) {
      if (packed)
        intersect_leaf<T, true>(c, dx, dy, dz, leaf.y, leaf.z, geom, lmin,
                                lslot);
      else
        intersect_leaf<T, false>(c, dx, dy, dz, leaf.y, leaf.z, geom, lmin,
                                 lslot);
      if (lmin < best_t) {
        best_t = lmin;
        best = perm[lslot];
        bound = best_t * c.c_rel + c.c_abs;
      }
    }
  }
  if (r < n_rays) {
    out_t[r] = best_t;
    out_tri[r] = best;
  }
}

template <typename T>
cudaError_t launch(const void* origin, const void* dirs, int n_rays,
                   int width, const void* node_box, const void* node_link,
                   const void* geom, const void* perm, int depth, int levers,
                   double draw, double eps, double slab_eps, double c_rel,
                   double c_abs, double c_pad, void* out_t, void* out_tri,
                   cudaStream_t stream) {
  int blocks;
  if (width > 0 && (levers & kWarpBlocks)) {
    const int rows = (n_rays + width - 1) / width;
    blocks = ((width + kTileW - 1) / kTileW) * ((rows + kTileH - 1) / kTileH);
  } else {
    blocks = (n_rays + kThreads - 1) / kThreads;
  }
  Consts<T> c;   // the origin is read by the kernel (no host read)
  c.eps = T(eps);
  c.one_eps = T(1.0 + eps);
  c.seps = T(slab_eps);
  c.seps_f = float(slab_eps);
  c.c_rel = T(c_rel);
  c.c_abs = T(c_abs);
  c.c_pad = T(c_pad);
  c.ox = c.oy = c.oz = c.pad = T(0);
  kd_traverse_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(origin), static_cast<const T*>(dirs), n_rays,
      width, static_cast<const float4*>(node_box),
      static_cast<const int4*>(node_link), static_cast<const T*>(geom),
      static_cast<const int*>(perm), depth, levers, T(draw), c,
      static_cast<T*>(out_t), static_cast<int*>(out_tri));
  return cudaGetLastError();
}

}  // namespace

// The deepest stack the kernel holds (max_depth + 2 of the tree).
extern "C" int kd_traverse_max_stack() { return kMaxStack; }

// Every lever's bit.
extern "C" int kd_traverse_all_levers() { return kAllLevers; }

extern "C" int kd_traverse_launch(const void* origin, const void* dirs,
                                  int n_rays, int width,
                                  const void* node_box,
                                  const void* node_link, const void* geom,
                                  const void* perm, int depth, int is_f64,
                                  int levers, double draw, double eps,
                                  double slab_eps, double c_rel,
                                  double c_abs, double c_pad, void* out_t,
                                  void* out_tri, void* stream) {
  if (n_rays < 1 || width < 0 || depth < 1 || depth > kMaxStack
      || (levers & ~kAllLevers))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(is_f64
      ? launch<double>(origin, dirs, n_rays, width, node_box, node_link,
                       geom, perm, depth, levers, draw, eps, slab_eps, c_rel,
                       c_abs, c_pad, out_t, out_tri, s)
      : launch<float>(origin, dirs, n_rays, width, node_box, node_link, geom,
                      perm, depth, levers, draw, eps, slab_eps, c_rel, c_abs,
                      c_pad, out_t, out_tri, s));
}
