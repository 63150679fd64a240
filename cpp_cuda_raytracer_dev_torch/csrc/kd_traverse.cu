// Per-ray KD-tree stack traversal: kernel K7 of the "kd" method.
//
// Counterpart of the JAX package's on-device loop in `kd_intersect`
// (cpp_cuda_raytracer_dev_tpu/accel/traverse.py:750, its
// `jax.lax.while_loop` at :876), not of a Pallas kernel: JAX runs every ray
// in lockstep, one (pop, test, push) step a loop iteration, until every
// stack is empty. Here each thread walks one ray to its own end, as the
// reference's traversal does (Trixel.cu:41-172). It computes what the
// plain PyTorch version computes (ops/cuda/kd_traverse.py
// `kd_traverse_reference`), bit for bit in t and ids:
//
//   pop:   node = stack[sp], sp -= 1; the root is stack[0] at sp = 0; the
//          ray is done when sp < 0.
//   leaf:  Moller-Trumbore over its slots [start, start + count) (the leaf's
//          box is not tested, as in the plain version); reject when
//          |det| < eps, u < eps, v < eps, u + v > 1 + eps or t < eps. The
//          lowest slot at the leaf's minimum t wins, and it replaces the
//          ray's best only on a strictly smaller t.
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
//
// The arithmetic is the plain version's operation for operation: every
// product and sum rounded on its own (built with -fmad=false), the dot
// products summed as (x + y) + z, the reciprocals IEEE divisions, the
// epsilons in the rays' type except s1 + eps and s2 +- eps, which the plain
// version takes in float32 (its split planes are float32). A template over
// the rays' type T serves float32 and float64 (the node tables stay
// float32 and are widened exactly).
//
// Tables (made once per KDTables, accel/traverse.py): node_box (N, 8) f32
// = (bmin xyz, s1, bmax xyz, s2), two 16-byte loads a node; node_link (N, 4)
// i32 = (-1, leaf_start, leaf_count, 0) at a leaf, (axis, left, right, 0)
// at an internal node; p1, e1, e2 (T, 3) and perm (T,) i32 in leaf order.
//
// Bound: operations. Per (ray, internal node) slab test about 36 (6
// subtractions and 6 products, 10 minima and maxima, 3 for the hit test, 11
// for the children's order) and per (ray, slot) pair about 54 (two cross
// products 18, three dot products 15 and det's 5, tvec 3, the reciprocal and
// its select 2, three products by it 3, the acceptance tests 7, the
// running minimum 1), at one instruction an operation; the bytes (rays in,
// t and ids out, the tables once) are a few tens of megabytes. The
// counts depend on the data: chip_smoke.py counts them from the plain run.
//
// Design (the simple kernel first): one thread a ray, 128 threads a CTA,
// rays in pixel order so that a warp's rays walk much the same nodes and
// read the same leaf slots (broadcast loads). The stack lives in the
// thread's local memory (kMaxStack entries; the wrapper refuses a deeper
// tree). No shared memory, no atomics, no host read: the launch captures
// into a CUDA graph.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStack = 64;

// torch.minimum / torch.maximum: NaN when either operand is NaN
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kd_traverse_kernel(const T* __restrict__ origin,        // (3,)
                   const T* __restrict__ dirs,          // (R, 3)
                   int n_rays,
                   const float4* __restrict__ node_box,  // (N, 2) float4
                   const int4* __restrict__ node_link,   // (N,)
                   const T* __restrict__ p1,             // (T, 3)
                   const T* __restrict__ e1,
                   const T* __restrict__ e2,
                   const int* __restrict__ perm,         // (T,)
                   int depth, T draw, T eps, T one_eps, T seps, float seps_f,
                   T* __restrict__ out_t, int* __restrict__ out_tri) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  const T ox = origin[0], oy = origin[1], oz = origin[2];
  const T dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const T ix = T(1) / dx, iy = T(1) / dy, iz = T(1) / dz;

  int stack[kMaxStack];
  int sp = 0;
  stack[0] = 0;
  T best_t = draw;
  int best = -1;
  while (sp >= 0) {
    const int node = stack[min(sp, depth - 1)];
    --sp;
    const int4 link = node_link[node];
    if (link.x < 0) {
      // a leaf: MT over its slots, the lowest slot at the minimum t
      T lmin = T(1) / T(0);
      int lslot = 0;
      for (int s = link.y; s < link.y + link.z; ++s) {
        const T p1x = p1[3 * s], p1y = p1[3 * s + 1], p1z = p1[3 * s + 2];
        const T e1x = e1[3 * s], e1y = e1[3 * s + 1], e1z = e1[3 * s + 2];
        const T e2x = e2[3 * s], e2y = e2[3 * s + 1], e2z = e2[3 * s + 2];
        const T px = dy * e2z - dz * e2y;           // pvec = d x e2
        const T py = dz * e2x - dx * e2z;
        const T pz = dx * e2y - dy * e2x;
        const T det = (e1x * px + e1y * py) + e1z * pz;
        const T tx = ox - p1x, ty = oy - p1y, tz = oz - p1z;
        const T qx = ty * e1z - tz * e1y;           // qvec = tvec x e1
        const T qy = tz * e1x - tx * e1z;
        const T qz = tx * e1y - ty * e1x;
        const T inv = T(1) / (det == T(0) ? T(1) : det);
        const T u = inv * ((tx * px + ty * py) + tz * pz);
        const T v = inv * ((dx * qx + dy * qy) + dz * qz);
        const T t = inv * ((e2x * qx + e2y * qy) + e2z * qz);
        const T adet = det < T(0) ? -det : det;
        const bool ok = adet >= eps && u >= eps && v >= eps
                        && u + v <= one_eps && t >= eps;
        if (ok && t < lmin) {
          lmin = t;
          lslot = s;
        }
      }
      if (lmin < best_t) {
        best_t = lmin;
        best = perm[lslot];
      }
      continue;
    }
    const float4 lo = node_box[2 * node], hi = node_box[2 * node + 1];
    const T t0x = (T(lo.x) - ox) * ix, t1x = (T(hi.x) - ox) * ix;
    const T t0y = (T(lo.y) - oy) * iy, t1y = (T(hi.y) - oy) * iy;
    const T t0z = (T(lo.z) - oz) * iz, t1z = (T(hi.z) - oz) * iz;
    const T t_entry = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                              nan_min(t0z, t1z));
    const T t_exit = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                             nan_max(t0z, t1z));
    // Trixel.cu:146: mint1 >= maxt0 - eps && maxt0 > -eps
    if (!(t_exit >= t_entry - seps && t_entry > -seps)) continue;
    const T d_ax = link.x == 0 ? dx : (link.x == 1 ? dy : dz);
    const T o_ax = link.x == 0 ? ox : (link.x == 1 ? oy : oz);
    const T c_entry = o_ax + t_entry * d_ax;
    const T c_exit = o_ax + t_exit * d_ax;
    const float s1e = lo.w + seps_f;
    const bool go_left_first = c_entry < T(hi.w + seps_f);   // Trixel.cu:155
    const bool also_right = c_exit > T(hi.w - seps_f);       // Trixel.cu:156
    const bool also_left = c_exit < T(s1e) || c_entry < T(s1e);  // :163
    if (go_left_first ? also_right : also_left) {
      ++sp;
      stack[min(max(sp, 0), depth - 1)] = go_left_first ? link.z : link.y;
    }
    ++sp;
    stack[min(max(sp, 0), depth - 1)] = go_left_first ? link.y : link.z;
  }
  out_t[r] = best_t;
  out_tri[r] = best;
}

template <typename T>
cudaError_t launch(const void* origin, const void* dirs, int n_rays,
                   const void* node_box, const void* node_link,
                   const void* p1, const void* e1, const void* e2,
                   const void* perm, int depth, double draw, double eps,
                   double slab_eps, void* out_t, void* out_tri,
                   cudaStream_t stream) {
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  kd_traverse_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(origin), static_cast<const T*>(dirs), n_rays,
      static_cast<const float4*>(node_box),
      static_cast<const int4*>(node_link), static_cast<const T*>(p1),
      static_cast<const T*>(e1), static_cast<const T*>(e2),
      static_cast<const int*>(perm), depth, T(draw), T(eps), T(1.0 + eps),
      T(slab_eps), float(slab_eps), static_cast<T*>(out_t),
      static_cast<int*>(out_tri));
  return cudaGetLastError();
}

}  // namespace

// The deepest stack the kernel holds (max_depth + 2 of the tree).
extern "C" int kd_traverse_max_stack() { return kMaxStack; }

extern "C" int kd_traverse_launch(const void* origin, const void* dirs,
                                  int n_rays, const void* node_box,
                                  const void* node_link, const void* p1,
                                  const void* e1, const void* e2,
                                  const void* perm, int depth, int is_f64,
                                  double draw, double eps, double slab_eps,
                                  void* out_t, void* out_tri, void* stream) {
  if (n_rays < 1 || depth < 1 || depth > kMaxStack)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return (int)launch<double>(origin, dirs, n_rays, node_box, node_link, p1,
                               e1, e2, perm, depth, draw, eps, slab_eps,
                               out_t, out_tri, s);
  return (int)launch<float>(origin, dirs, n_rays, node_box, node_link, p1, e1,
                            e2, perm, depth, draw, eps, slab_eps, out_t,
                            out_tri, s);
}
