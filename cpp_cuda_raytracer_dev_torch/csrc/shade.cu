// Serving shading and composition: kernel K10; the serving frame's set-up:
// kernel K11 (below K10); the training shading's backward: kernel K12
// (below K11); the training set-up's backward: kernel K13 (below K12).
//
// Counterpart of the JAX package's XLA-fused plain code of a forward
// frame's shading and composition, not of a Pallas kernel: `shade_hits`
// (cpp_cuda_raytracer_dev_tpu/models/renderer.py:116-223) and
// `phong_radiance_c`, `tonemap_maxnorm`, `compose_framebuffer`
// (ops/shade.py:46,76,86). Run eagerly in PyTorch that was about 100
// small kernels a frame and object, and a (T, 12) concatenation of the
// triangle leaves every frame to gather from. One thread a ray computes
// what the plain PyTorch version computes (models/renderer.py
// `shade_compose_reference`, without autograd), bit for bit:
//
//   the hit triangle's leaves, read directly (no per-frame pack);
//   the object-frame direction R^T d, and Moller-Trumbore t from the
//     object-frame origin with the plain version's acceptance; t is MT's
//     where it accepts, the traversal's hit t otherwise (epsilon edges);
//   the world hit point o + t d; the unit normal normalize(e1 x e2)
//     rotated to world;
//   Phong (light direction, |L.N| diffuse, |sum((L - 2 (L.N) N) * d)| **
//     exponent specular);
//   max-norm tonemap, x 255, half-to-even rounding, clamp, the background
//     on a miss, uint8; radiance, normal and point (zeros on a miss).
//
// A ray takes the object its hit names (hit_obj); a launch serves up to
// kMaxObjects objects [obj0, obj0 + n_obj), whose pointers (leaves,
// colour, the pose's quaternion and translation) travel in the launch's
// parameters, so any number of objects take ceil(n / kMaxObjects)
// launches; the first also writes the misses. A thread builds its
// object's rotation R from the quaternion (ops/quaternion.py to_matrix)
// and the object-frame origin R^T (o - t) (Pose.inv_apply) itself. The
// pose, the origin, the Phong parameters and the light are device
// pointers, read anew by every replay of a captured frame.
//
// Operation for operation as the plain version: every product and sum
// rounded on its own (the _rn intrinsics), dots summed as (x + y) + z,
// IEEE division and reciprocal, rsqrt as torch.rsqrt (rsqrtf in float32),
// pow as torch.pow with a tensor exponent (powf), nearbyint as
// torch.round, NaN-propagating maximum (amax) and clamps. The one matrix
// product of the plain version, Pose.inv_apply's (3,) @ (3, 3), is a
// cuBLAS gemv; its order on an H100 (CUDA 12.8) was read from the card:
// float32 (a0 b0 + a1 b1, fused) + a2 b2, float64 two fused steps (inv_dot
// below; the bitwise checks of K10 hold it). A template over the rays'
// type T serves float32 and float64 (the kd and brute paths' float64
// frames).
//
// Bound: bytes. Per ray it reads the direction, t, the triangle and object
// ids and the hit triangle's nine leaves and colour, and writes the image
// (3 B) and radiance, normal and point (9 T); about 240 operations a hit
// (50 of them the pose) are far below the issue rate.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxObjects = 8;
constexpr int kObjPtrs = 12;   // p1x .. e2z, colour (T, 3), quat (4,), t (3,)

template <typename T>
struct Objects {
  const T* p[kMaxObjects][kObjPtrs];
};

template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {   // torch.amax's combine
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}

template <typename T>
__device__ __forceinline__ T clamp2(T v, T lo, T hi) {   // torch.clamp
  return v != v ? v : fmin(fmax(v, lo), hi);
}

template <typename T>
__device__ __forceinline__ T clamp_lo(T v, T lo) {   // torch.clamp_min
  return v != v ? v : fmax(v, lo);
}

// Every product, sum and quotient of the plain version rounded on its own:
// the _rn intrinsics are never contracted into a multiply-add. The file is
// built with -fmad=true all the same (ops/cuda/_build.py), as PyTorch's own
// kernels are, because the math library's float64 pow contracts under it:
// built with -fmad=false, pow(x, 5.0) differs from torch.pow on 25 of 2^20
// inputs in (1e-3, 3) on an H100 (float32 powf and rsqrt on none).
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div(double a, double b) {
  return __ddiv_rn(a, b);
}

// Pose.inv_apply's (3,) @ (3, 3) product as cuBLAS's gemv forms it: v0 r0
// + v1 r1 + v2 r2, fused as that kernel fuses it
__device__ __forceinline__ float inv_dot(float v0, float r0, float v1,
                                         float r1, float v2, float r2) {
  return __fadd_rn(__fmaf_rn(v1, r1, __fmul_rn(v0, r0)), __fmul_rn(v2, r2));
}
__device__ __forceinline__ double inv_dot(double v0, double r0, double v1,
                                          double r1, double v2, double r2) {
  return __fma_rn(v2, r2, __fma_rn(v1, r1, __dmul_rn(v0, r0)));
}

// (a0 b0 + a1 b1) + a2 b2, and a0 b0 - a1 b1 (a cross product's component)
template <typename T>
__device__ __forceinline__ T dot3(T a0, T b0, T a1, T b1, T a2, T b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}
template <typename T>
__device__ __forceinline__ T cross1(T a0, T b0, T a1, T b1) {
  return sub(mul(a0, b0), mul(a1, b1));
}

// the rotation of unit quaternion q = (x, y, z, w), row-major, as
// ops/quaternion.py to_matrix computes it (1 - 2 y y - 2 z z is
// (1 - (2 y) y) - (2 z) z)
template <typename T>
__device__ __forceinline__ void quat_matrix(const T* q, T* m) {
  const T x = q[0], y = q[1], z = q[2], w = q[3];
  const T x2 = mul(T(2), x), y2 = mul(T(2), y), z2 = mul(T(2), z);
  m[0] = sub(sub(T(1), mul(y2, y)), mul(z2, z));
  m[1] = sub(mul(x2, y), mul(z2, w));
  m[2] = add(mul(x2, z), mul(y2, w));
  m[3] = add(mul(x2, y), mul(z2, w));
  m[4] = sub(sub(T(1), mul(x2, x)), mul(z2, z));
  m[5] = sub(mul(y2, z), mul(x2, w));
  m[6] = sub(mul(x2, z), mul(y2, w));
  m[7] = add(mul(y2, z), mul(x2, w));
  m[8] = sub(sub(T(1), mul(x2, x)), mul(y2, y));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
shade_compose_kernel(int n_rays, int obj0, int n_obj, int n_total,
                     int first, Objects<T> objs, const T* rmd,
                     const T* origin, const T* hit_t, const int* hit_tri,
                     const int* hit_obj, const T* light_pos,
                     const T* light_color, const T* diffuse,
                     const T* specular, const T* exponent, T eps, T one_eps,
                     T bg0, T bg1, T bg2, uint8_t* image, T* radiance,
                     T* normal, T* point) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  const int tri = hit_tri[r];
  const int obj = hit_obj[r];
  const bool hit = tri >= 0;
  const int slot = obj - obj0;
  const long long r3 = 3ll * r;
  if (!(hit && slot >= 0 && slot < n_obj)) {
    if (!first || (hit && obj >= 0 && obj < n_total)) return;
    // a miss (or a hit of no object: zero radiance tonemapped to 0)
    const T zero = T(0);
    image[r3] = hit ? 0 : static_cast<uint8_t>(bg0);
    image[r3 + 1] = hit ? 0 : static_cast<uint8_t>(bg1);
    image[r3 + 2] = hit ? 0 : static_cast<uint8_t>(bg2);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      radiance[r3 + k] = zero;
      normal[r3 + k] = zero;
      point[r3 + k] = zero;
    }
    return;
  }
  const T* const* p = objs.p[slot];
  const T p1x = p[0][tri], p1y = p[1][tri], p1z = p[2][tri];
  const T e1x = p[3][tri], e1y = p[4][tri], e1z = p[5][tri];
  const T e2x = p[6][tri], e2y = p[7][tri], e2z = p[8][tri];
  const T* col = p[9] + 3ll * tri;
  const T dx = rmd[r3], dy = rmd[r3 + 1], dz = rmd[r3 + 2];

  // the pose: R, and the object-frame origin R^T (o - t)
  T m[9];
  quat_matrix(p[10], m);
  const T vx = sub(origin[0], p[11][0]), vy = sub(origin[1], p[11][1]),
          vz = sub(origin[2], p[11][2]);
  const T oo[3] = {inv_dot(vx, m[0], vy, m[3], vz, m[6]),
                   inv_dot(vx, m[1], vy, m[4], vz, m[7]),
                   inv_dot(vx, m[2], vy, m[5], vz, m[8])};

  // object-frame direction R^T d
  const T ddx = dot3(m[0], dx, m[3], dy, m[6], dz);
  const T ddy = dot3(m[1], dx, m[4], dy, m[7], dz);
  const T ddz = dot3(m[2], dx, m[5], dy, m[8], dz);

  // Moller-Trumbore t (ops/intersect.py mt_test)
  const T tvx = sub(oo[0], p1x), tvy = sub(oo[1], p1y),
          tvz = sub(oo[2], p1z);
  const T pvx = cross1(ddy, e2z, ddz, e2y);
  const T pvy = cross1(ddz, e2x, ddx, e2z);
  const T pvz = cross1(ddx, e2y, ddy, e2x);
  const T det = dot3(e1x, pvx, e1y, pvy, e1z, pvz);
  const T qvx = cross1(tvy, e1z, tvz, e1y);
  const T qvy = cross1(tvz, e1x, tvx, e1z);
  const T qvz = cross1(tvx, e1y, tvy, e1x);
  const T inv = div(T(1), det == T(0) ? T(1) : det);
  const T u = mul(dot3(tvx, pvx, tvy, pvy, tvz, pvz), inv);
  const T v = mul(dot3(ddx, qvx, ddy, qvy, ddz, qvz), inv);
  const T t_mt = mul(dot3(e2x, qvx, e2y, qvy, e2z, qvz), inv);
  const bool valid = fabs(det) >= eps && u >= eps && v >= eps
                     && add(u, v) <= one_eps && t_mt >= eps;
  const T t = valid ? t_mt : hit_t[r];

  const T px = add(origin[0], mul(t, dx));
  const T py = add(origin[1], mul(t, dy));
  const T pz = add(origin[2], mul(t, dz));
  // object-frame unit normal normalize(e1 x e2), rotated to world
  const T cnx = cross1(e1y, e2z, e1z, e2y);
  const T cny = cross1(e1z, e2x, e1x, e2z);
  const T cnz = cross1(e1x, e2y, e1y, e2x);
  const T inv_n = rsqrt(clamp_lo(dot3(cnx, cnx, cny, cny, cnz, cnz),
                                 T(1e-30)));
  const T nx_ = mul(cnx, inv_n), ny_ = mul(cny, inv_n),
          nz_ = mul(cnz, inv_n);
  const T nwx = dot3(m[0], nx_, m[1], ny_, m[2], nz_);
  const T nwy = dot3(m[3], nx_, m[4], ny_, m[5], nz_);
  const T nwz = dot3(m[6], nx_, m[7], ny_, m[8], nz_);

  // Phong (ops/shade.py phong_radiance_c)
  T lx = sub(light_pos[0], px), ly = sub(light_pos[1], py),
    lz = sub(light_pos[2], pz);
  const T inv_len = rsqrt(dot3(lx, lx, ly, ly, lz, lz));
  lx = mul(lx, inv_len);
  ly = mul(ly, inv_len);
  lz = mul(lz, inv_len);
  const T dot_r_n = dot3(lx, nwx, ly, nwy, lz, nwz);
  const T two = mul(T(2), dot_r_n);
  const T rsum = dot3(sub(lx, mul(two, nwx)), dx, sub(ly, mul(two, nwy)), dy,
                      sub(lz, mul(two, nwz)), dz);
  const T dif = mul(*diffuse, fabs(dot_r_n));
  const T spec = mul(*specular, pow(fabs(rsum), *exponent));
  T rad[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    rad[k] = add(mul(mul(col[k], dif), light_color[k]),
                 mul(light_color[k], spec));

  // max-norm tonemap, rounded half to even (ops/shade.py)
  const T peak = nmax(nmax(rad[0], rad[1]), rad[2]);
  const T den = peak > T(0) ? peak : T(1);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T s = clamp2(nearbyint(mul(div(rad[k], den), T(255))), T(0),
                       T(255));
    image[r3 + k] = static_cast<uint8_t>(s);
    radiance[r3 + k] = rad[k];
  }
  normal[r3] = nwx;
  normal[r3 + 1] = nwy;
  normal[r3 + 2] = nwz;
  point[r3] = px;
  point[r3 + 1] = py;
  point[r3 + 2] = pz;
}

template <typename T>
cudaError_t launch(int n_rays, int obj0, int n_obj, int n_total, int first,
                   const void* const* obj_ptrs, const void* const* ops,
                   double eps, const double* bg, void* const* outs,
                   cudaStream_t stream) {
  Objects<T> objs;
  for (int i = 0; i < kMaxObjects; ++i)
    for (int k = 0; k < kObjPtrs; ++k)
      objs.p[i][k] = i < n_obj
          ? static_cast<const T*>(obj_ptrs[i * kObjPtrs + k]) : nullptr;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  shade_compose_kernel<T><<<blocks, kThreads, 0, stream>>>(
      n_rays, obj0, n_obj, n_total, first, objs,
      static_cast<const T*>(ops[0]), static_cast<const T*>(ops[1]),
      static_cast<const T*>(ops[2]), static_cast<const int*>(ops[3]),
      static_cast<const int*>(ops[4]), static_cast<const T*>(ops[5]),
      static_cast<const T*>(ops[6]), static_cast<const T*>(ops[7]),
      static_cast<const T*>(ops[8]), static_cast<const T*>(ops[9]), T(eps),
      T(1.0 + eps), T(bg[0]), T(bg[1]), T(bg[2]),
      static_cast<uint8_t*>(outs[0]), static_cast<T*>(outs[1]),
      static_cast<T*>(outs[2]), static_cast<T*>(outs[3]));
  return cudaGetLastError();
}


// ---- K11: the serving frame's set-up ----
//
// Counterpart of the JAX package's XLA-fused plain code of a frame's
// set-up, not of a Pallas kernel: `Camera.ray_directions` and `projection`
// (cpp_cuda_raytracer_dev_tpu/models/camera.py:107,124) and the per-object
// pose transforms of `trace_rays` and `Projection.transformed`
// (models/renderer.py:66-112). In PyTorch the plain version is 380 kernels
// a one-object bin frame on an H100, nearly all of a few scalars each (the
// camera basis twice, the pose matrix rebuilt in five transforms), and some
// 28 passes over the rays. One launch computes what the plain version
// (models/camera.py `frame_setup_reference`) computes, bit for bit:
//
//   the camera basis n, u, v, the pixel pitch, the ray mods, and the
//     projection's sx, sy and pixel-centre offsets (Camera.projection);
//   each object's rotation R (ops/quaternion.py to_matrix), its origin
//     R^T (pos - t) (Pose.inv_apply) and the projection's origin, n, u, v
//     in its frame (Projection.transformed);
//   the unit ray of every pixel of a band of rows [row0, row0 + band_h)
//     (Camera.ray_directions at the frame's pixel coordinates), and for
//     the methods that read them the object-frame rays R^T d
//     (Pose.inv_apply_vec).
//
// Thread 0 of every block derives the camera's constants, then one thread
// an object the object's, in shared memory: about 200 operations, no
// synchronisation across blocks; block 0 writes them to the constants
// buffer (kFrameConsts, then kObjConsts an object) whose views are the
// frame's Projection fields and object origins. Each thread then writes
// kSetupRays rays. A launch serves up to kMaxObjects objects [obj0, obj0 +
// n_obj) (quaternion and translation pointers in the launch's parameters,
// read anew by every replay of a captured frame); the first (first != 0)
// also writes the rays and the camera's constants.
//
// Operation order is the plain version's as PyTorch runs it on the card,
// read from an H100 (torch 2.11, CUDA 12.8): each elementwise product and
// sum rounded on its own; torch.sum of a (3,) tensor as (x0 + x2) + x1 (its
// reduction gives a block two threads, the first of which sums elements 0
// and 2); a 0-dim tensor over a Python int as the tensor times the
// reciprocal of the int, rounded on the host (PyTorch's division by a CPU
// scalar); the (3,) @ (3, 3) products as K10's inv_dot (cuBLAS gemv); the
// rays' (R, 3) @ (3, 3) product as cuBLAS's GEMM forms it, three fused
// steps from the first term (float32 at 64 rays or more: below that cuBLAS
// takes another kernel; float64 at any count).
//
// Bound: bytes. It writes 3 T a ray, and 3 T more an object for the
// methods that read object-frame rays (6.2 MB a 960x540 float32 frame, 1.9
// us at 3.35 TB/s); about 25 operations a ray and 15 an object's ray.

constexpr int kSetupThreads = 256;
constexpr int kSetupRays = 4;
constexpr int kFrameConsts = 16;   // origin, n, u, v, sx, sy, adjust_x, _y
constexpr int kObjConsts = 12;     // origin, n, u, v in the object's frame
constexpr int kCamPtrs = 6;        // pos, look_at, up, film_w, film_h, focal

template <typename T>
struct Poses {
  const T* quat[kMaxObjects];
  const T* trans[kMaxObjects];
  T* rays[kMaxObjects];            // R^T d (R, 3), or null
};

// torch.sum of a (3,) tensor on the card
template <typename T>
__device__ __forceinline__ T sum3(T x0, T x1, T x2) {
  return add(add(x0, x2), x1);
}

// vecmath.normalize: a * rsqrt(dot(a, a))
template <typename T>
__device__ __forceinline__ void unit3(const T* a, T* out) {
  const T inv = rsqrt(sum3(mul(a[0], a[0]), mul(a[1], a[1]),
                           mul(a[2], a[2])));
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = mul(a[k], inv);
}

// vecmath.cross
template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* out) {
  out[0] = cross1(a[1], b[2], a[2], b[1]);
  out[1] = cross1(a[2], b[0], a[0], b[2]);
  out[2] = cross1(a[0], b[1], a[1], b[0]);
}

// v @ m for a (3,) v and a row-major 3x3 m (Pose.inv_apply's product)
template <typename T>
__device__ __forceinline__ void inv_apply3(const T* v, const T* m, T* out) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    out[j] = inv_dot(v[0], m[j], v[1], m[3 + j], v[2], m[6 + j]);
}

// shared constants: the frame's (kFrameConsts), the ray mods n_mod,
// u_mod, v_mod (9), then an object's R (9) and kObjConsts
constexpr int kShFrame = kFrameConsts + 9;
constexpr int kShObj = 9 + kObjConsts;

template <typename T>
__device__ void camera_constants(const T* const* cam, int res_w, int res_h,
                                 T adj_x, T adj_y, T* c) {
  const T* pos = cam[0];
  const T* look = cam[1];
  const T* up = cam[2];
  const T film_w = *cam[3], film_h = *cam[4], focal = *cam[5];
  T a[3], n[3], upn[3], cu[3], e[3], v[3], u[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) a[k] = sub(look[k], pos[k]);
  unit3(a, n);
  unit3(up, upn);
  cross3(upn, n, cu);
  cross3(n, cu, e);
  unit3(e, v);
  cross3(v, n, u);
  // film / res: PyTorch multiplies by the host's reciprocal of the int
  const T pix_w = mul(film_w, div(T(1), T(res_w)));
  const T pix_h = mul(film_h, div(T(1), T(res_h)));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c[k] = pos[k];
    c[3 + k] = n[k];
    c[6 + k] = u[k];
    c[9 + k] = v[k];
    const T um = mul(u[k], pix_w), vm = mul(v[k], pix_h);
    c[kFrameConsts + k] = sub(sub(mul(n[k], focal), mul(vm, adj_y)),
                              mul(um, adj_x));
    c[kFrameConsts + 3 + k] = um;
    c[kFrameConsts + 6 + k] = vm;
  }
  c[12] = div(focal, pix_w);
  c[13] = div(focal, pix_h);
  c[14] = adj_x;
  c[15] = adj_y;
}

template <typename T>
__device__ void object_constants(const T* quat, const T* trans, const T* c,
                                 T* o) {
  quat_matrix(quat, o);
  T w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) w[k] = sub(c[k], trans[k]);
  inv_apply3(w, o, o + 9);
  inv_apply3(c + 3, o, o + 12);
  inv_apply3(c + 6, o, o + 15);
  inv_apply3(c + 9, o, o + 18);
}

// the rays' (R, 3) @ R product, as cuBLAS's GEMM sums it
template <typename T>
__device__ __forceinline__ T gemm_dot(T d0, T r0, T d1, T r1, T d2, T r2);
template <>
__device__ __forceinline__ float gemm_dot(float d0, float r0, float d1,
                                          float r1, float d2, float r2) {
  return __fmaf_rn(d2, r2, __fmaf_rn(d1, r1, __fmul_rn(d0, r0)));
}
template <>
__device__ __forceinline__ double gemm_dot(double d0, double r0, double d1,
                                           double r1, double d2, double r2) {
  return __fma_rn(d2, r2, __fma_rn(d1, r1, __dmul_rn(d0, r0)));
}

struct CamPtrs {
  const void* p[kCamPtrs];
};

template <typename T>
__global__ void __launch_bounds__(kSetupThreads)
frame_setup_kernel(int n_rays, int res_w, int res_h, int row0, int obj0,
                   int n_obj, int first, CamPtrs cam_ptrs, Poses<T> poses,
                   T adj_x, T adj_y, T* consts, T* rmd) {
  __shared__ T sc[kShFrame];
  __shared__ T so[kMaxObjects][kShObj];
  const T* cam[kCamPtrs];
#pragma unroll
  for (int k = 0; k < kCamPtrs; ++k)
    cam[k] = static_cast<const T*>(cam_ptrs.p[k]);
  if (threadIdx.x == 0)
    camera_constants(cam, res_w, res_h, adj_x, adj_y, sc);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < n_obj)
    object_constants(poses.quat[threadIdx.x], poses.trans[threadIdx.x], sc,
                     so[threadIdx.x]);
  __syncthreads();
  if (blockIdx.x == 0) {
    if (first && threadIdx.x < kFrameConsts)
      consts[threadIdx.x] = sc[threadIdx.x];
    for (int k = threadIdx.x; k < n_obj * kObjConsts; k += kSetupThreads)
      consts[kFrameConsts + (obj0 + k / kObjConsts) * kObjConsts
             + k % kObjConsts] = so[k / kObjConsts][9 + k % kObjConsts];
  }
  const T* nm = sc + kFrameConsts;
  const long long base = static_cast<long long>(row0) * res_w;
#pragma unroll
  for (int j = 0; j < kSetupRays; ++j) {
    const int r = (blockIdx.x * kSetupRays + j) * kSetupThreads + threadIdx.x;
    if (r >= n_rays) return;
    // Camera.ray_directions at pixel (ix, iy) of the frame
    const long long i = base + r;
    const T ix = static_cast<T>(i % res_w), iy = static_cast<T>(i / res_w);
    T d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      d[k] = add(add(nm[k], mul(nm[3 + k], ix)), mul(nm[6 + k], iy));
    const T inv = rsqrt(add(add(mul(d[0], d[0]), mul(d[1], d[1])),
                            mul(d[2], d[2])));
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = mul(d[k], inv);
    const long long r3 = 3ll * r;
    if (first) {
      rmd[r3] = d[0];
      rmd[r3 + 1] = d[1];
      rmd[r3 + 2] = d[2];
    }
    for (int s = 0; s < n_obj; ++s) {
      T* out = poses.rays[s];
      if (out == nullptr) continue;
      const T* m = so[s];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        out[r3 + k] = gemm_dot(d[0], m[k], d[1], m[3 + k], d[2], m[6 + k]);
    }
  }
}

template <typename T>
cudaError_t launch_setup(int n_rays, int res_w, int res_h, int row0,
                         int obj0, int n_obj, int first,
                         const void* const* cam, const void* const* quats,
                         const void* const* trans, void* const* rays,
                         double adj_x, double adj_y, void* consts, void* rmd,
                         cudaStream_t stream) {
  CamPtrs c;
  for (int k = 0; k < kCamPtrs; ++k) c.p[k] = cam[k];
  Poses<T> p;
  for (int i = 0; i < kMaxObjects; ++i) {
    p.quat[i] = i < n_obj ? static_cast<const T*>(quats[i]) : nullptr;
    p.trans[i] = i < n_obj ? static_cast<const T*>(trans[i]) : nullptr;
    p.rays[i] = i < n_obj ? static_cast<T*>(rays[i]) : nullptr;
  }
  const int per_block = kSetupThreads * kSetupRays;
  const int blocks = n_rays > 0 ? (n_rays + per_block - 1) / per_block : 1;
  frame_setup_kernel<T><<<blocks, kSetupThreads, 0, stream>>>(
      n_rays, res_w, res_h, row0, obj0, n_obj, first, c, p, T(adj_x),
      T(adj_y), static_cast<T*>(consts), static_cast<T*>(rmd));
  return cudaGetLastError();
}


// ---- K12: the training shading's backward ----
//
// Counterpart of the JAX package's XLA-fused autograd of the plain code of a
// training frame's shading (`shade_hits`,
// cpp_cuda_raytracer_dev_tpu/models/renderer.py:116-223, and
// `phong_radiance_c`, ops/shade.py:46), which JAX differentiates and fuses
// by itself; not of a Pallas kernel. Run eagerly in PyTorch that was some
// 800 autograd nodes a step (the forward's 310 and their backward), among
// them a (T, 12) concatenation of the triangle leaves and a gather of it,
// every step. K10 is the forward (models/shade_grad.py); one thread a ray
// of K12 recomputes what K10 computes (the object-frame direction, MT's t,
// u, v and det, the hit point, the normal, Phong) and writes, bit for bit
// as its plain twin (models/shade_grad.py `shade_grad_reference`):
//
//   the cotangent of the ray's direction rmd (R, 3);
//   one column a ray of the partials of every scalar leaf (kGradCols: the
//     world origin, light_pos, light_color, diffuse, specular, exponent;
//     then kObjGradCols an object: R, row-major, and the object-frame
//     origin), column-major (column c at partials + c R), which torch.sum
//     adds up over the rays: no float atomics, so a step repeats bitwise;
//   where a triangle table needs a gradient, the (R, 12) cotangent rows of
//     the hit triangle's leaves p1, e1, e2 and colour (ops/gather.py's
//     packed order), which the segment sum K2 adds up by triangle;
//   where asked, the cotangent of the traversal's t (rays whose recomputed
//     MT rejects the hit keep that t);
//   each object's R and o - t (kGradConsts), block 0's first threads.
//
// It takes the cotangents of radiance, normal and point that autograd
// gives; an absent one is a template flag (kCts), not a zero tensor. Rays
// of no object of the launch write nothing, except in the first launch,
// which writes every output of every ray that it does not own as zero (a
// later launch's rays are then written again by it). Misses and the
// other objects' columns are zero.
//
// Autograd's conventions: where's masks (the acceptance, the hit's object),
// abs's sgn(0) = 0, clamp_min's gradient 0 below the clamp, rsqrt's
// -x^3 / 2, reciprocal(where(det == 0, 1, det)) (0 where det is 0), pow's
// base gradient 0 where the exponent is 0 and its exponent gradient 0
// where the base is 0 (pow_backward_self, pow_backward_exponent). Order:
// K10's for the recompute; every product and sum of the backward rounded
// on its own, dots summed (x + y) + z, as the twin writes them.
//
// Bound: bytes. Per ray it reads what K10 reads and the cotangents (3 T
// each), and writes the partials (24 T for one object), the direction's
// cotangent (3 T) and, for the tables, 12 T; about 400 operations a hit
// are far below the issue rate.

constexpr int kGradCols = 12;     // origin, light_pos, light_color, kd, ks, ex
constexpr int kObjGradCols = 12;  // R (9), the object-frame origin (3)
constexpr int kGradConsts = 12;   // R (9), o - t (3)

template <typename T>
__device__ __forceinline__ T sgn(T x) {   // torch.sign, abs's gradient
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

template <typename T>
__device__ __forceinline__ T dot3v(const T* a, const T* b) {
  return dot3(a[0], b[0], a[1], b[1], a[2], b[2]);
}

template <typename T, int kCts>
__global__ void __launch_bounds__(kThreads)
shade_grad_kernel(int n_rays, int obj0, int n_obj, int n_total, int first,
                  Objects<T> objs, const T* rmd, const T* origin,
                  const T* hit_t, const int* hit_tri, const int* hit_obj,
                  const T* light_pos, const T* light_color,
                  const T* diffuse, const T* specular, const T* exponent,
                  T eps, T one_eps, const T* ct_rad, const T* ct_nrm,
                  const T* ct_pnt, T* partials, T* consts, T* g_rmd,
                  T* g_rows, T* g_ht) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < n_obj) {
    const T* const* p = objs.p[threadIdx.x];
    T* c = consts + static_cast<long long>(obj0 + threadIdx.x) * kGradConsts;
    quat_matrix(p[10], c);
#pragma unroll
    for (int k = 0; k < 3; ++k) c[9 + k] = sub(origin[k], p[11][k]);
  }
  if (r >= n_rays) return;
  const long long R = n_rays;
  const int tri = hit_tri[r];
  const int obj = hit_obj[r];
  const int slot = obj - obj0;
  const bool own = tri >= 0 && slot >= 0 && slot < n_obj;
  const T zero = T(0);
  if (first && partials != nullptr) {
    for (int o = 0; o < n_total; ++o) {
      if (own && o == obj) continue;
      T* col = partials + (kGradCols + static_cast<long long>(o)
                           * kObjGradCols) * R + r;
#pragma unroll
      for (int k = 0; k < kObjGradCols; ++k) col[k * R] = zero;
    }
  }
  if (!own) {
    if (!first) return;
    if (partials != nullptr) {
#pragma unroll
      for (int k = 0; k < kGradCols; ++k) partials[k * R + r] = zero;
    }
    if (g_rmd != nullptr) {
#pragma unroll
      for (int k = 0; k < 3; ++k) g_rmd[3ll * r + k] = zero;
    }
    if (g_rows != nullptr) {
#pragma unroll
      for (int k = 0; k < 12; ++k) g_rows[12ll * r + k] = zero;
    }
    if (g_ht != nullptr) g_ht[r] = zero;
    return;
  }

  // ---- the forward, as K10 computes it ----
  const T* const* p = objs.p[slot];
  const T p1[3] = {p[0][tri], p[1][tri], p[2][tri]};
  const T e1[3] = {p[3][tri], p[4][tri], p[5][tri]};
  const T e2[3] = {p[6][tri], p[7][tri], p[8][tri]};
  const T* colp = p[9] + 3ll * tri;
  const T col[3] = {colp[0], colp[1], colp[2]};
  const long long r3 = 3ll * r;
  const T d[3] = {rmd[r3], rmd[r3 + 1], rmd[r3 + 2]};
  T m[9];
  quat_matrix(p[10], m);
  const T vx = sub(origin[0], p[11][0]), vy = sub(origin[1], p[11][1]),
          vz = sub(origin[2], p[11][2]);
  const T oo[3] = {inv_dot(vx, m[0], vy, m[3], vz, m[6]),
                   inv_dot(vx, m[1], vy, m[4], vz, m[7]),
                   inv_dot(vx, m[2], vy, m[5], vz, m[8])};
  T dd[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    dd[j] = dot3(m[j], d[0], m[3 + j], d[1], m[6 + j], d[2]);
  const T tv[3] = {sub(oo[0], p1[0]), sub(oo[1], p1[1]), sub(oo[2], p1[2])};
  T pv[3], qv[3];
  cross3(dd, e2, pv);
  cross3(tv, e1, qv);
  const T det = dot3v(e1, pv);
  const T inv = div(T(1), det == T(0) ? T(1) : det);
  const T u = mul(dot3v(tv, pv), inv);
  const T v = mul(dot3v(dd, qv), inv);
  const T e_t = dot3v(e2, qv);
  const T t_mt = mul(e_t, inv);
  const bool valid = fabs(det) >= eps && u >= eps && v >= eps
                     && add(u, v) <= one_eps && t_mt >= eps;
  const T t = valid ? t_mt : hit_t[r];
  T pt[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) pt[k] = add(origin[k], mul(t, d[k]));
  T cn[3];
  cross3(e1, e2, cn);
  const T cs = dot3v(cn, cn);
  const T inv_n = rsqrt(clamp_lo(cs, T(1e-30)));
  const T nn[3] = {mul(cn[0], inv_n), mul(cn[1], inv_n), mul(cn[2], inv_n)};
  T nw[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    nw[i] = dot3(m[3 * i], nn[0], m[3 * i + 1], nn[1], m[3 * i + 2], nn[2]);

  // ---- the backward ----
  T g_nw[3] = {zero, zero, zero}, g_p[3] = {zero, zero, zero},
    g_d[3] = {zero, zero, zero};
  T g_lp[3] = {zero, zero, zero}, g_lc[3] = {zero, zero, zero},
    g_col[3] = {zero, zero, zero};
  T g_kd = zero, g_ks = zero, g_ex = zero;
  if (kCts & 1) {   // radiance: Phong (ops/shade.py phong_radiance_c)
    const T kd = *diffuse, ks = *specular, ex = *exponent;
    T l[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) l[k] = sub(light_pos[k], pt[k]);
    const T inv_len = rsqrt(dot3v(l, l));
    const T lh[3] = {mul(l[0], inv_len), mul(l[1], inv_len),
                     mul(l[2], inv_len)};
    const T dot = dot3v(lh, nw);
    const T two = mul(T(2), dot);
    T rr[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) rr[k] = sub(lh[k], mul(two, nw[k]));
    const T rsum = dot3v(rr, d);
    const T dif = mul(kd, fabs(dot));
    const T a = fabs(rsum);
    const T pw = pow(a, ex);
    const T spec = mul(ks, pw);
    const T gr[3] = {ct_rad[r3], ct_rad[r3 + 1], ct_rad[r3 + 2]};
    T ga[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ga[k] = mul(gr[k], light_color[k]);
      g_col[k] = mul(ga[k], dif);
      g_lc[k] = add(mul(gr[k], mul(col[k], dif)), mul(gr[k], spec));
    }
    const T g_dif = dot3v(ga, col);
    const T g_spec = add(add(ga[0], ga[1]), ga[2]);
    g_ks = mul(g_spec, pw);
    const T g_pw = mul(g_spec, ks);
    const T g_a = ex == T(0) ? zero
                  : mul(g_pw, mul(ex, pow(a, sub(ex, T(1)))));
    g_ex = mul(g_pw, a == T(0) && ex >= T(0) ? zero : mul(pw, log(a)));
    const T g_rsum = mul(g_a, sgn(rsum));
    g_kd = mul(g_dif, fabs(dot));
    T g_dot = mul(mul(g_dif, kd), sgn(dot));
    T g_r[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_r[k] = mul(g_rsum, d[k]);
      g_d[k] = mul(g_rsum, rr[k]);
    }
    const T g_two = -dot3v(g_r, nw);
#pragma unroll
    for (int k = 0; k < 3; ++k) g_nw[k] = -mul(g_r[k], two);
    g_dot = add(g_dot, mul(T(2), g_two));
    T g_lh[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_lh[k] = add(g_r[k], mul(g_dot, nw[k]));
      g_nw[k] = add(g_nw[k], mul(g_dot, lh[k]));
    }
    const T g_ls = mul(mul(T(-0.5), dot3v(g_lh, l)),
                       mul(mul(inv_len, inv_len), inv_len));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_lp[k] = add(mul(g_lh[k], inv_len), mul(mul(T(2), g_ls), l[k]));
      g_p[k] = -g_lp[k];
    }
  }
  if (kCts & 2) {   // normal
#pragma unroll
    for (int k = 0; k < 3; ++k) g_nw[k] = add(g_nw[k], ct_nrm[r3 + k]);
  }
  if (kCts & 4) {   // point
#pragma unroll
    for (int k = 0; k < 3; ++k) g_p[k] = add(g_p[k], ct_pnt[r3 + k]);
  }
  // the hit point o + t d
  const T g_t = dot3v(g_p, d);
#pragma unroll
  for (int k = 0; k < 3; ++k) g_d[k] = add(g_d[k], mul(g_p[k], t));
  // the world normal R n and the unit normal n = cn rsqrt(|cn|^2)
  T g_m[9], g_n[3], g_cn[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) g_m[3 * i + j] = mul(g_nw[i], nn[j]);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g_n[j] = dot3(g_nw[0], m[j], g_nw[1], m[3 + j], g_nw[2], m[6 + j]);
    g_cn[j] = mul(g_n[j], inv_n);
  }
  const T g_cs = cs >= T(1e-30)
      ? mul(mul(T(-0.5), dot3v(g_n, cn)), mul(mul(inv_n, inv_n), inv_n))
      : zero;
#pragma unroll
  for (int k = 0; k < 3; ++k) g_cn[k] = add(g_cn[k], mul(mul(T(2), g_cs),
                                                         cn[k]));
  T g_e1[3], g_e2[3], x[3];
  cross3(e2, g_cn, g_e1);
  cross3(g_cn, e1, g_e2);
  // MT's t = e_t / det where the recompute accepts the hit
  const T g_tm = valid ? g_t : zero;
  const T g_e = mul(g_tm, inv);
  const T g_det = det == T(0) ? zero
                  : -mul(mul(g_tm, e_t), mul(inv, inv));
  T g_qv[3], g_pv[3], g_tv[3], g_dd[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_e2[k] = add(g_e2[k], mul(g_e, qv[k]));
    g_qv[k] = mul(g_e, e2[k]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_e1[k] = add(g_e1[k], mul(g_det, pv[k]));
    g_pv[k] = mul(g_det, e1[k]);
  }
  cross3(e1, g_qv, g_tv);
  cross3(g_qv, tv, x);
#pragma unroll
  for (int k = 0; k < 3; ++k) g_e1[k] = add(g_e1[k], x[k]);
  cross3(e2, g_pv, g_dd);
  cross3(g_pv, dd, x);
#pragma unroll
  for (int k = 0; k < 3; ++k) g_e2[k] = add(g_e2[k], x[k]);
  // the object-frame direction R^T d
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      g_m[3 * i + j] = add(g_m[3 * i + j], mul(g_dd[j], d[i]));
#pragma unroll
  for (int i = 0; i < 3; ++i)
    g_d[i] = add(g_d[i], dot3(m[3 * i], g_dd[0], m[3 * i + 1], g_dd[1],
                              m[3 * i + 2], g_dd[2]));

  if (partials != nullptr) {
    const T shared[kGradCols] = {g_p[0], g_p[1], g_p[2], g_lp[0], g_lp[1],
                                 g_lp[2], g_lc[0], g_lc[1], g_lc[2], g_kd,
                                 g_ks, g_ex};
#pragma unroll
    for (int k = 0; k < kGradCols; ++k) partials[k * R + r] = shared[k];
    T* col_o = partials + (kGradCols + static_cast<long long>(obj)
                           * kObjGradCols) * R + r;
#pragma unroll
    for (int k = 0; k < 9; ++k) col_o[k * R] = g_m[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) col_o[(9 + k) * R] = g_tv[k];
  }
  if (g_rmd != nullptr) {
#pragma unroll
    for (int k = 0; k < 3; ++k) g_rmd[r3 + k] = g_d[k];
  }
  if (g_rows != nullptr) {
    T* row = g_rows + 12ll * r;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      row[k] = -g_tv[k];
      row[3 + k] = g_e1[k];
      row[6 + k] = g_e2[k];
      row[9 + k] = g_col[k];
    }
  }
  if (g_ht != nullptr) g_ht[r] = valid ? zero : g_t;
}

template <typename T, int kCts>
cudaError_t launch_grad_cts(int n_rays, int obj0, int n_obj, int n_total,
                            int first, const Objects<T>& objs,
                            const void* const* ops, double eps,
                            const void* const* cts, void* const* outs,
                            cudaStream_t stream) {
  const int blocks = n_rays > 0 ? (n_rays + kThreads - 1) / kThreads : 1;
  shade_grad_kernel<T, kCts><<<blocks, kThreads, 0, stream>>>(
      n_rays, obj0, n_obj, n_total, first, objs,
      static_cast<const T*>(ops[0]), static_cast<const T*>(ops[1]),
      static_cast<const T*>(ops[2]), static_cast<const int*>(ops[3]),
      static_cast<const int*>(ops[4]), static_cast<const T*>(ops[5]),
      static_cast<const T*>(ops[6]), static_cast<const T*>(ops[7]),
      static_cast<const T*>(ops[8]), static_cast<const T*>(ops[9]), T(eps),
      T(1.0 + eps), static_cast<const T*>(cts[0]),
      static_cast<const T*>(cts[1]), static_cast<const T*>(cts[2]),
      static_cast<T*>(outs[0]), static_cast<T*>(outs[1]),
      static_cast<T*>(outs[2]), static_cast<T*>(outs[3]),
      static_cast<T*>(outs[4]));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_grad(int n_rays, int obj0, int n_obj, int n_total,
                        int first, int cts_mask, const void* const* obj_ptrs,
                        const void* const* ops, double eps,
                        const void* const* cts, void* const* outs,
                        cudaStream_t stream) {
  Objects<T> objs;
  for (int i = 0; i < kMaxObjects; ++i)
    for (int k = 0; k < kObjPtrs; ++k)
      objs.p[i][k] = i < n_obj
          ? static_cast<const T*>(obj_ptrs[i * kObjPtrs + k]) : nullptr;
#define K12_CASE(c)                                                        \
  case c:                                                                  \
    return launch_grad_cts<T, c>(n_rays, obj0, n_obj, n_total, first,      \
                                 objs, ops, eps, cts, outs, stream);
  switch (cts_mask) {
    K12_CASE(1)
    K12_CASE(2)
    K12_CASE(3)
    K12_CASE(4)
    K12_CASE(5)
    K12_CASE(6)
    K12_CASE(7)
    default:
      return cudaErrorInvalidValue;
  }
#undef K12_CASE
}


// ---- K13: the training set-up's backward ----
//
// Counterpart of the JAX package's autograd of the plain code of a frame's
// set-up (`Camera.ray_directions`, cpp_cuda_raytracer_dev_tpu/models/
// camera.py:124, under `jax.grad`), not of a Pallas kernel. Run in PyTorch
// that was about 560 autograd nodes a step (K11's plain twin under
// autograd, forward and backward). K11 is the forward (models/camera.py
// `set_up_frame`); K13 takes the cotangent of the rays rmd, which K12
// writes, back to the camera's six leaves, bit for bit as its plain twin
// (models/setup_grad.py `frame_setup_grad_reference`), in two launches:
//
//   frame_setup_grad_kernel, a few rays a thread as K11: it recomputes the
//     ray's unnormalised direction d = n_mod + u_mod ix + v_mod iy and its
//     rsqrt in K11's order at the frame's pixel (ix, iy) (row0 for a
//     band), forms the normalise's VJP g_d = g inv + 2 (-1/2 (g . d) inv^3)
//     d (rsqrt's -x^3 / 2), and writes nine columns a ray, g_d, ix g_d and
//     iy g_d, column-major (column c at partials + c R), which one torch.sum
//     adds up over the rays: no float atomics, so a step repeats bitwise;
//   frame_setup_grad_chain_kernel, one thread: the nine sums (the
//     gradients of n_mod, u_mod and v_mod) back through the ray mods, the
//     pixel pitch film / res (the host's reciprocal of the int, as K11),
//     the basis (normalize, the two crosses, normalize(up)) and
//     look_at - pos to the leaves the need mask asks for.
//
// Order: K11's for the recompute; every product and sum of the backward
// rounded on its own (the _rn intrinsics, so the file's -fmad=true changes
// none of them), dots summed (x + y) + z, as the twin writes them.
//
// Bound: bytes. It reads the (R, 3) cotangent (6.2 MB a 960x540 float32
// frame) and writes nine columns (18.7 MB), 7.4 us at 3.35 TB/s; about 45
// operations a ray. The chain is about 200 operations on one thread.

template <typename T>
__global__ void __launch_bounds__(kSetupThreads)
frame_setup_grad_kernel(int n_rays, int res_w, int res_h, int row0,
                        CamPtrs cam_ptrs, T adj_x, T adj_y, const T* g_rmd,
                        T* partials) {
  __shared__ T sc[kShFrame];
  if (threadIdx.x == 0) {
    const T* cam[kCamPtrs];
#pragma unroll
    for (int k = 0; k < kCamPtrs; ++k)
      cam[k] = static_cast<const T*>(cam_ptrs.p[k]);
    camera_constants(cam, res_w, res_h, adj_x, adj_y, sc);
  }
  __syncthreads();
  const T* nm = sc + kFrameConsts;
  const long long R = n_rays;
  const long long base = static_cast<long long>(row0) * res_w;
#pragma unroll
  for (int j = 0; j < kSetupRays; ++j) {
    const int r = (blockIdx.x * kSetupRays + j) * kSetupThreads + threadIdx.x;
    if (r >= n_rays) return;
    const long long i = base + r;
    const T ix = static_cast<T>(i % res_w), iy = static_cast<T>(i / res_w);
    T d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      d[k] = add(add(nm[k], mul(nm[3 + k], ix)), mul(nm[6 + k], iy));
    const T inv = rsqrt(add(add(mul(d[0], d[0]), mul(d[1], d[1])),
                            mul(d[2], d[2])));
    const long long r3 = 3ll * r;
    const T g[3] = {g_rmd[r3], g_rmd[r3 + 1], g_rmd[r3 + 2]};
    const T g_s = mul(mul(T(-0.5), dot3v(g, d)), mul(mul(inv, inv), inv));
    const T two = mul(T(2), g_s);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T g_d = add(mul(g[k], inv), mul(two, d[k]));
      partials[k * R + r] = g_d;
      partials[(3 + k) * R + r] = mul(ix, g_d);
      partials[(6 + k) * R + r] = mul(iy, g_d);
    }
  }
}

// the VJP of vecmath.normalize, a rsqrt(|a|^2) with inv = rsqrt(|a|^2):
// g inv + 2 (-1/2 (g . a) inv^3) a
template <typename T>
__device__ __forceinline__ void unit3_grad(const T* a, T inv, const T* g,
                                           T* out) {
  const T g_s = mul(mul(T(-0.5), dot3v(g, a)), mul(mul(inv, inv), inv));
  const T two = mul(T(2), g_s);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = add(mul(g[k], inv), mul(two, a[k]));
}

// acc += a x b
template <typename T>
__device__ __forceinline__ void add_cross3(const T* a, const T* b, T* acc) {
  T x[3];
  cross3(a, b, x);
#pragma unroll
  for (int k = 0; k < 3; ++k) acc[k] = add(acc[k], x[k]);
}

template <typename T>
__device__ __forceinline__ T rsqrt_sq3(const T* a) {   // unit3's rsqrt
  return rsqrt(sum3(mul(a[0], a[0]), mul(a[1], a[1]), mul(a[2], a[2])));
}

template <typename T>
__global__ void frame_setup_grad_chain_kernel(int res_w, int res_h,
                                              CamPtrs cam_ptrs, T adj_x,
                                              T adj_y, const T* sums,
                                              int need, T* out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const T* pos = static_cast<const T*>(cam_ptrs.p[0]);
  const T* look = static_cast<const T*>(cam_ptrs.p[1]);
  const T* up = static_cast<const T*>(cam_ptrs.p[2]);
  const T film_w = *static_cast<const T*>(cam_ptrs.p[3]);
  const T film_h = *static_cast<const T*>(cam_ptrs.p[4]);
  const T focal = *static_cast<const T*>(cam_ptrs.p[5]);
  // the forward, as camera_constants computes it
  T a[3], n[3], upn[3], cu[3], e[3], v[3], u[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) a[k] = sub(look[k], pos[k]);
  const T inv_a = rsqrt_sq3(a), inv_up = rsqrt_sq3(up);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    n[k] = mul(a[k], inv_a);
    upn[k] = mul(up[k], inv_up);
  }
  cross3(upn, n, cu);
  cross3(n, cu, e);
  const T inv_e = rsqrt_sq3(e);
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = mul(e[k], inv_e);
  cross3(v, n, u);
  const T rw = div(T(1), T(res_w)), rh = div(T(1), T(res_h));
  const T pix_w = mul(film_w, rw), pix_h = mul(film_h, rh);

  // the backward: n_mod = (n focal - v_mod adj_y) - u_mod adj_x, u_mod =
  // u pix_w, v_mod = v pix_h; sums: the gradients of n_mod, and of u_mod
  // and v_mod through ix and iy
  const T* s0 = sums;
  T g_um[3], g_vm[3], g_n[3], g_u[3], g_v[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_um[k] = sub(sums[3 + k], mul(s0[k], adj_x));
    g_vm[k] = sub(sums[6 + k], mul(s0[k], adj_y));
    g_n[k] = mul(s0[k], focal);
    g_u[k] = mul(g_um[k], pix_w);
    g_v[k] = mul(g_vm[k], pix_h);
  }
  const T g_focal = dot3v(s0, n);
  const T g_film_w = mul(dot3v(g_um, u), rw);
  const T g_film_h = mul(dot3v(g_vm, v), rh);
  // u = v x n
  add_cross3(n, g_u, g_v);
  add_cross3(g_u, v, g_n);
  // v = normalize(e), e = n x cu, cu = upn x n
  T g_e[3], g_cu[3], g_upn[3], g_up[3], g_a[3];
  unit3_grad(e, inv_e, g_v, g_e);
  add_cross3(cu, g_e, g_n);
  cross3(g_e, n, g_cu);
  cross3(n, g_cu, g_upn);
  add_cross3(g_cu, upn, g_n);
  unit3_grad(up, inv_up, g_upn, g_up);
  // n = normalize(look_at - pos)
  unit3_grad(a, inv_a, g_n, g_a);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (need & 1) out[k] = -g_a[k];
    if (need & 2) out[3 + k] = g_a[k];
    if (need & 4) out[6 + k] = g_up[k];
  }
  if (need & 8) out[9] = g_film_w;
  if (need & 16) out[10] = g_film_h;
  if (need & 32) out[11] = g_focal;
}

template <typename T>
cudaError_t launch_setup_grad(int n_rays, int res_w, int res_h, int row0,
                              const void* const* cam, double adj_x,
                              double adj_y, const void* g_rmd,
                              void* partials, cudaStream_t stream) {
  CamPtrs c;
  for (int k = 0; k < kCamPtrs; ++k) c.p[k] = cam[k];
  const int per_block = kSetupThreads * kSetupRays;
  const int blocks = (n_rays + per_block - 1) / per_block;
  frame_setup_grad_kernel<T><<<blocks, kSetupThreads, 0, stream>>>(
      n_rays, res_w, res_h, row0, c, T(adj_x), T(adj_y),
      static_cast<const T*>(g_rmd), static_cast<T*>(partials));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_setup_chain(int res_w, int res_h, const void* const* cam,
                               double adj_x, double adj_y, const void* sums,
                               int need, void* out, cudaStream_t stream) {
  CamPtrs c;
  for (int k = 0; k < kCamPtrs; ++k) c.p[k] = cam[k];
  frame_setup_grad_chain_kernel<T><<<1, 1, 0, stream>>>(
      res_w, res_h, c, T(adj_x), T(adj_y), static_cast<const T*>(sums), need,
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" int shade_max_objects() { return kMaxObjects; }

// obj_ptrs: n_obj x 12 pointers (p1x .. e2z, colour, quaternion,
// translation); ops: rmd, world origin, hit_t, hit_tri, hit_obj,
// light_pos, light_color, diffuse, specular, exponent; bg: 3 doubles;
// outs: image, radiance, normal, point.
extern "C" int shade_compose_launch(int n_rays, int obj0, int n_obj,
                                    int n_total, int first, int is_f64,
                                    const void* const* obj_ptrs,
                                    const void* const* ops, double eps,
                                    const double* bg, void* const* outs,
                                    void* stream) {
  if (n_rays < 1 || n_obj < 1 || n_obj > kMaxObjects || obj0 < 0
      || obj0 + n_obj > n_total)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(is_f64
      ? launch<double>(n_rays, obj0, n_obj, n_total, first, obj_ptrs, ops,
                       eps, bg, outs, s)
      : launch<float>(n_rays, obj0, n_obj, n_total, first, obj_ptrs, ops,
                      eps, bg, outs, s));
}

// n_rays = band_h * res_w rays of frame rows [row0, row0 + band_h); cam:
// pos, look_at, up, film_w, film_h, focal; quats, trans, rays: n_obj
// pointers each (rays null where the method reads no object-frame rays);
// adj_x, adj_y: the pixel-centre offsets; consts: kFrameConsts + kObjConsts
// an object of the whole scene; rmd (n_rays, 3).
extern "C" int frame_setup_launch(int n_rays, int res_w, int res_h, int row0,
                                  int obj0, int n_obj, int first, int is_f64,
                                  const void* const* cam,
                                  const void* const* quats,
                                  const void* const* trans,
                                  void* const* rays, double adj_x,
                                  double adj_y, void* consts, void* rmd,
                                  void* stream) {
  if (n_rays < 0 || res_w < 1 || res_h < 1 || row0 < 0 || n_obj < 0
      || n_obj > kMaxObjects || obj0 < 0 || (!first && n_obj < 1))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(is_f64
      ? launch_setup<double>(n_rays, res_w, res_h, row0, obj0, n_obj, first,
                             cam, quats, trans, rays, adj_x, adj_y, consts,
                             rmd, s)
      : launch_setup<float>(n_rays, res_w, res_h, row0, obj0, n_obj, first,
                            cam, quats, trans, rays, adj_x, adj_y, consts,
                            rmd, s));
}

// K12. obj_ptrs, ops and eps: K10's; cts_mask: bit 0 radiance, 1 normal, 2
// point, whose cotangents (R, 3) are cts[0..2] (null where absent); outs:
// partials (kGradCols + kObjGradCols n_total, R), consts (n_total,
// kGradConsts), the cotangent of rmd (R, 3), of the tables' rows (R, 12)
// and of hit_t (R,), each but consts null where not asked for.
extern "C" int shade_grad_launch(int n_rays, int obj0, int n_obj, int n_total,
                                 int first, int is_f64, int cts_mask,
                                 const void* const* obj_ptrs,
                                 const void* const* ops, double eps,
                                 const void* const* cts, void* const* outs,
                                 void* stream) {
  if (n_rays < 0 || n_obj < 1 || n_obj > kMaxObjects || obj0 < 0
      || obj0 + n_obj > n_total || cts_mask < 1 || cts_mask > 7
      || outs[1] == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 3; ++k)
    if (((cts_mask >> k) & 1) != (cts[k] != nullptr))
      return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(is_f64
      ? launch_grad<double>(n_rays, obj0, n_obj, n_total, first, cts_mask,
                            obj_ptrs, ops, eps, cts, outs, s)
      : launch_grad<float>(n_rays, obj0, n_obj, n_total, first, cts_mask,
                           obj_ptrs, ops, eps, cts, outs, s));
}

// K13. n_rays = band_h * res_w rays of frame rows [row0, row0 + band_h)
// (n_rays >= 1); cam, adj_x, adj_y: K11's; g_rmd: the rays' cotangent
// (n_rays, 3); partials: (9, n_rays), column-major: g_d, ix g_d, iy g_d.
extern "C" int frame_setup_grad_launch(int n_rays, int res_w, int res_h,
                                       int row0, int is_f64,
                                       const void* const* cam, double adj_x,
                                       double adj_y, const void* g_rmd,
                                       void* partials, void* stream) {
  if (n_rays < 1 || res_w < 1 || res_h < 1 || row0 < 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(is_f64
      ? launch_setup_grad<double>(n_rays, res_w, res_h, row0, cam, adj_x,
                                  adj_y, g_rmd, partials, s)
      : launch_setup_grad<float>(n_rays, res_w, res_h, row0, cam, adj_x,
                                 adj_y, g_rmd, partials, s));
}

// K13's chain: sums (9,), the partials summed over the rays;
// need: bit k for leaf k of pos, look_at, up, film_w, film_h, focal; out
// (12,), those leaves' gradients in that order, each written only where
// asked.
extern "C" int frame_setup_chain_launch(int res_w, int res_h, int is_f64,
                                        const void* const* cam, double adj_x,
                                        double adj_y, const void* sums,
                                        int need, void* out, void* stream) {
  if (res_w < 1 || res_h < 1 || need < 1 || need > 63)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(is_f64
      ? launch_setup_chain<double>(res_w, res_h, cam, adj_x, adj_y, sums,
                                   need, out, s)
      : launch_setup_chain<float>(res_w, res_h, cam, adj_x, adj_y, sums, need,
                                  out, s));
}
