// The bin path's prepass: kernels K8 (the per-triangle pass and the ray
// table) and K9 (the entry passes around the key sort).
//
// Counterpart of the JAX package's XLA-fused plain code around the bin
// kernel, not of a Pallas kernel: `bin_triangles`
// (cpp_cuda_raytracer_dev_tpu/accel/binning.py:67) and, in
// `intersect_binned` (accel/traverse.py:532), the root box and
// `_ray_table`. Under `jax.jit` XLA fuses those into a few passes; run
// eagerly in PyTorch they were some 250 small kernels a frame. Each launch
// here computes what its plain PyTorch version computes
// (ops/cuda/bin_prepass.py), bit for bit:
//
//   tri_pass_kernel (K8), one thread a triangle: the projection of the
//     three vertices, the camera-plane and backface tests, the guarded
//     pixel box clamped and cast to pixel and tile ranges, the tile count
//     (int64, for torch.cumsum), the depth certificate, the 11 MT-constant
//     rows, and two order-free reductions over all triangles: the root box
//     (min / max of the three vertices) and the depth range d_lo / d_hi,
//     with the count of camera-plane crossers. Each block reduces its
//     threads' values and the last block to finish reduces the blocks'
//     (a counter and a fence): minima and maxima are exact in any order,
//     so the result is amin's / amax's.
//   ray_table_kernel (K8's second launch), one thread a ray: the tile-order
//     direction and the far slab t of the root box.
//   entry_keys_kernel (K9a), one thread a triangle (grid-stride): each
//     triangle writes its own entry slots [cum - n, cum), the (tile, depth
//     bucket) key and its id, and the dead slots of a capacity bucket past
//     the live count get the dead key. A triangle owns its slots, rather
//     than an entry searching cum: every triangle's row is read once and
//     its depth bucket computed once, where the search costs each entry
//     about 20 dependent loads; only the few camera-plane crossers (every
//     tile) loop long.
//   entry_table_kernel (K9b), one thread an entry slot of the padded table,
//     after torch.sort(key, stable=True): the triangle through the sort
//     order, its MT rows written column by column into geom (11, E_pad),
//     the id (-1 when dead), the dead chunk, and the tile starts: entry j
//     writes starts[t] = j for the tiles t after the previous entry's tile
//     up to its own (slot `size` closes the range up to n_tiles), which is
//     lower_bound(keys, t << dbits) as the plain searchsorted.
//
// Operation for operation as the plain version: every product and sum
// rounded on its own (built with -fmad=false), sums in its order
// ((x * b0 + y * b1) + z * b2), IEEE division, rsqrtf (torch.rsqrt), and
// NaN-propagating minimum, maximum and clamp as torch.minimum, amin and
// clamp_min are (fminf alone drops a NaN). Integer work in int64 where the
// plain code has it (cum, the tile of an entry, the key before its cast to
// int32).
//
// Bound: bytes. K8 reads the nine (T,) leaves and writes (T,) int64,
// (T, 3) int32 and (T, 11) float32: 100 B a triangle; the ray table writes
// 16 B a ray; K9a reads 32 B a triangle and writes 8 B an entry; K9b
// reads 16 B an entry and the MT rows, and writes 48 B an entry. The
// operations, about 150 a triangle and 60 a ray, are far below the
// issue rate. The loads of a warp fall on neighbouring addresses; K8's MT
// rows (44 B a thread) are staged in shared memory and leave the block in
// whole lines.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 3.0e38f;   // accel/binning.py BIG
constexpr float kInf = __builtin_huge_valf();

// torch.minimum / maximum: a NaN operand wins
__device__ __forceinline__ float nmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// torch.clamp_min / clamp_max / clamp with scalars: NaN stays NaN
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_hi(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp2(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// The nine (T,) leaves p1x .. e2z.
struct Leaves {
  const float* f[9];
};

// The Projection's device scalars (models/camera.py): origin (3,), n, u,
// v (3,), sx, sy, adjust_x, adjust_y (0-dim). A replay reads them anew.
struct Proj {
  const float *origin, *n, *u, *v, *sx, *sy, *ax, *ay;
};

// The eight reduced values: box min xyz, box max xyz, d_lo, d_hi (the
// minima at 0-2 and 6).
constexpr int kStats = 8;

__device__ __forceinline__ float combine(float a, float b, int k) {
  return (k < 3 || k == 6) ? nmin(a, b) : nmax(a, b);
}

// Reduce kStats floats and one count over the block; thread 0 gets them.
__device__ void block_reduce(float (&v)[kStats], long long& c) {
  __shared__ float sv[kThreads / 32][kStats];
  __shared__ long long sc[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kStats; ++k)
      v[k] = combine(v[k], __shfl_down_sync(0xffffffffu, v[k], off), k);
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kStats; ++k) sv[warp][k] = v[k];
    sc[warp] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
#pragma unroll
      for (int k = 0; k < kStats; ++k) v[k] = combine(v[k], sv[w][k], k);
      c += sc[w];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float dotb(float x, float y, float z,
                                      const float* b) {
  return (x * b[0] + y * b[1]) + z * b[2];
}

__global__ void __launch_bounds__(kThreads)
tri_pass_kernel(int t_n, Leaves lv, Proj pr, const float* o, int res_h,
                int res_w, int th, int tw, int cull, float k1, float eps_f,
                long long* ntiles, int* tinfo, float* ftab,
                float* part, long long* part_c, unsigned* counter,
                float* stats, long long* cross_tris) {
  // the block's MT rows, staged so that they leave in whole lines (a
  // thread's own row is 44 B, so its stores would hit a sector each)
  __shared__ float rows[kThreads * 11];
  float acc[kStats] = {kInf, kInf, kInf, -kInf, -kInf, -kInf, kInf, -kInf};
  long long n_cross = 0;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < t_n) {
    const float p1x = lv.f[0][i], p1y = lv.f[1][i], p1z = lv.f[2][i];
    const float e1x = lv.f[3][i], e1y = lv.f[4][i], e1z = lv.f[5][i];
    const float e2x = lv.f[6][i], e2y = lv.f[7][i], e2z = lv.f[8][i];
    const float q0x = p1x - pr.origin[0], q0y = p1y - pr.origin[1],
                q0z = p1z - pr.origin[2];
    const float a0 = dotb(q0x, q0y, q0z, pr.n);
    const float b0 = dotb(q0x, q0y, q0z, pr.u);
    const float c0 = dotb(q0x, q0y, q0z, pr.v);
    const float a1 = a0 + dotb(e1x, e1y, e1z, pr.n);
    const float b1 = b0 + dotb(e1x, e1y, e1z, pr.u);
    const float c1 = c0 + dotb(e1x, e1y, e1z, pr.v);
    const float a2 = a0 + dotb(e2x, e2y, e2z, pr.n);
    const float b2 = b0 + dotb(e2x, e2y, e2z, pr.u);
    const float c2 = c0 + dotb(e2x, e2y, e2z, pr.v);
    const bool f0 = a0 > 0.0f, f1 = a1 > 0.0f, f2 = a2 > 0.0f;
    const bool all_front = f0 && f1 && f2;
    bool any_front = f0 || f1 || f2;
    bool cross = any_front && !all_front;
    if (cull) {
      const float nx = e1y * e2z - e1z * e2y;
      const float ny = e1z * e2x - e1x * e2z;
      const float nz = e1x * e2y - e1y * e2x;
      const bool away = ((nx * (p1x - o[0]) + ny * (p1y - o[1]))
                         + nz * (p1z - o[2])) > 0.0f;
      cross = cross && !away;
      any_front = any_front && !away;
    }
    const float sx = *pr.sx, sy = *pr.sy, adx = *pr.ax, ady = *pr.ay;
    const float px0 = adx + sx * (b0 / clamp_lo(a0, 1e-20f));
    const float px1 = adx + sx * (b1 / clamp_lo(a1, 1e-20f));
    const float px2 = adx + sx * (b2 / clamp_lo(a2, 1e-20f));
    const float py0 = ady + sy * (c0 / clamp_lo(a0, 1e-20f));
    const float py1 = ady + sy * (c1 / clamp_lo(a1, 1e-20f));
    const float py2 = ady + sy * (c2 / clamp_lo(a2, 1e-20f));
    float x0 = nmin(nmin(px0, px1), px2) - 0.5f;
    float x1 = nmax(nmax(px0, px1), px2) + 0.5f;
    float y0 = nmin(nmin(py0, py1), py2) - 0.5f;
    float y1 = nmax(nmax(py0, py1), py2) + 0.5f;
    const float wmax = float(res_w - 1), hmax = float(res_h - 1);
    if (cross) {
      x0 = 0.0f;
      y0 = 0.0f;
      x1 = wmax;
      y1 = hmax;
    }
    const long long ix0 = static_cast<long long>(clamp2(ceilf(x0), 0.0f,
                                                        wmax));
    const long long ix1 = static_cast<long long>(floorf(clamp2(x1, 0.0f,
                                                               wmax)));
    const long long iy0 = static_cast<long long>(clamp2(ceilf(y0), 0.0f,
                                                        hmax));
    const long long iy1 = static_cast<long long>(floorf(clamp2(y1, 0.0f,
                                                               hmax)));
    const bool onscreen = any_front && x1 >= 0.0f && x0 <= wmax
                          && y1 >= 0.0f && y0 <= hmax && ix1 >= ix0
                          && iy1 >= iy0;
    const long long tx0 = ix0 / tw, ty0 = iy0 / th;
    const long long ntx = onscreen ? ix1 / tw - tx0 + 1 : 0;
    const long long nty = onscreen ? iy1 / th - ty0 + 1 : 0;
    ntiles[i] = ntx * nty;
    tinfo[3ll * i] = int(ntx);
    tinfo[3ll * i + 1] = int(tx0);
    tinfo[3ll * i + 2] = int(ty0);

    float depth = nmin(nmin(f0 ? a0 : kBig, f1 ? a1 : kBig), f2 ? a2 : kBig);
    depth = clamp_lo(depth, 0.0f);
    if (cross) depth = 0.0f;

    // MT constants of the shared origin (accel/binning.py, step 5)
    const float tvx = o[0] - p1x, tvy = o[1] - p1y, tvz = o[2] - p1z;
    const float mdx = e2y * e1z - e2z * e1y;
    const float mdy = e2z * e1x - e2x * e1z;
    const float mdz = e2x * e1y - e2y * e1x;
    const float mux = e2y * tvz - e2z * tvy;
    const float muy = e2z * tvx - e2x * tvz;
    const float muz = e2x * tvy - e2y * tvx;
    const float mvx = tvy * e1z - tvz * e1y;
    const float mvy = tvz * e1x - tvx * e1z;
    const float mvz = tvx * e1y - tvy * e1x;
    const float td = (e2x * mvx + e2y * mvy) + e2z * mvz;
    float* row = rows + 11 * threadIdx.x;
    row[0] = k1 * mdx;
    row[1] = k1 * mdy;
    row[2] = k1 * mdz;
    row[3] = mux - eps_f * mdx;
    row[4] = muy - eps_f * mdy;
    row[5] = muz - eps_f * mdz;
    row[6] = mvx - eps_f * mdx;
    row[7] = mvy - eps_f * mdy;
    row[8] = mvz - eps_f * mdz;
    row[9] = k1 * td;
    row[10] = depth;

    const float vx[3] = {p1x, p1x + e1x, p1x + e2x};
    const float vy[3] = {p1y, p1y + e1y, p1y + e2y};
    const float vz[3] = {p1z, p1z + e1z, p1z + e2z};
    acc[0] = nmin(nmin(vx[0], vx[1]), vx[2]);
    acc[1] = nmin(nmin(vy[0], vy[1]), vy[2]);
    acc[2] = nmin(nmin(vz[0], vz[1]), vz[2]);
    acc[3] = nmax(nmax(vx[0], vx[1]), vx[2]);
    acc[4] = nmax(nmax(vy[0], vy[1]), vy[2]);
    acc[5] = nmax(nmax(vz[0], vz[1]), vz[2]);
    acc[6] = onscreen ? depth : kBig;
    acc[7] = (onscreen && isfinite(depth)) ? depth : 0.0f;
    n_cross = cross ? 1 : 0;
  }
  __syncthreads();
  const long long first = 11ll * blockIdx.x * kThreads;
  const int n_rows = min(kThreads, t_n - blockIdx.x * kThreads);
  for (int k = threadIdx.x; k < 11 * n_rows; k += kThreads)
    ftab[first + k] = rows[k];

  block_reduce(acc, n_cross);
  __shared__ bool last;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kStats; ++k) part[blockIdx.x * kStats + k] = acc[k];
    part_c[blockIdx.x] = n_cross;
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every block's values are visible (fence, counter)
  float v[kStats] = {kInf, kInf, kInf, -kInf, -kInf, -kInf, kInf, -kInf};
  long long c = 0;
  const volatile float* vp = part;
  const volatile long long* vc = part_c;
  for (int b = threadIdx.x; b < gridDim.x; b += kThreads) {
#pragma unroll
    for (int k = 0; k < kStats; ++k) v[k] = combine(v[k], vp[b * kStats + k],
                                                    k);
    c += vc[b];
  }
  block_reduce(v, c);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kStats; ++k) stats[k] = v[k];
    *cross_tris = c;
    *counter = 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
ray_table_kernel(int n, int p, int n_tx, int th, int tw, int row0, Proj pr,
                 const float* o, const float* stats, float draw,
                 float4* rays) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  const int t = idx / p;
  const int pi = idx - t * p;
  const float ix = float((t % n_tx) * tw + pi % tw);
  const float iy = float((t / n_tx) * th + pi / tw + row0);
  const float sx = *pr.sx, sy = *pr.sy, adx = *pr.ax, ady = *pr.ay;
  float dc[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float um = pr.u[ax] / sx;
    const float vm = pr.v[ax] / sy;
    const float base = (pr.n[ax] - um * adx) - vm * ady;
    dc[ax] = (base + um * ix) + vm * iy;
  }
  const float inv_len = rsqrtf((dc[0] * dc[0] + dc[1] * dc[1])
                               + dc[2] * dc[2]);
  float d[3];
  float r_near = -kInf, r_far = kInf;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    d[ax] = dc[ax] * inv_len;
    const float dsf = fabsf(d[ax]) < 1e-30f ? (d[ax] < 0.0f ? -1e-30f
                                                             : 1e-30f)
                                            : d[ax];
    const float inv = 1.0f / dsf;
    const float ta = (stats[ax] - o[ax]) * inv;
    const float tb = (stats[3 + ax] - o[ax]) * inv;
    r_near = nmax(r_near, nmin(ta, tb));
    r_far = nmin(r_far, nmax(ta, tb));
  }
  const bool root_hit = r_far >= clamp_lo(r_near, 0.0f) - 1e-4f;
  const float bnd = clamp_hi(root_hit ? r_far + 1e-3f : 0.0f, draw);
  rays[idx] = make_float4(d[0], d[1], d[2], bnd);
}

__global__ void __launch_bounds__(kThreads)
entry_keys_kernel(int t_n, const long long* cum, const long long* ntiles,
                  const int* tinfo, const float* ftab, const float* stats,
                  int n_tx, int n_tiles, int dbits, long long size, int* key,
                  int* tri, float* qstep) {
  const long long dmax = (1ll << dbits) - 1;
  const float d_lo = stats[6], d_hi = stats[7];
  const float d_rng = clamp_lo(d_hi - d_lo, 1e-20f);
  const float dmax_f = float(dmax);
  const float scale = dmax_f / d_rng;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (first == 0) *qstep = d_rng / dmax_f;
  for (long long i = first; i < t_n; i += stride) {
    const long long nt = ntiles[i];
    const long long start = cum[i] - nt;
    if (nt == 0 || start >= size) continue;
    const float depth = ftab[11 * i + 10];
    long long dq = static_cast<long long>(
        clamp_hi(clamp_lo((depth - d_lo) * scale, 0.0f), dmax_f));
    dq = dq < dmax ? dq : dmax;
    const int* ti = tinfo + 3 * i;
    const long long ntx = ti[0] > 1 ? ti[0] : 1;
    const long long end = cum[i] < size ? cum[i] : size;
    for (long long j = start; j < end; ++j) {
      const long long si = j - start;
      const long long tile = ((long long)ti[2] + si / ntx) * n_tx + ti[1]
                             + si % ntx;
      key[j] = static_cast<int>((tile << dbits) | dq);
      tri[j] = static_cast<int>(i);
    }
  }
  // dead slots of a capacity bucket: triangle T, the key above every tile
  const long long n_e = t_n ? cum[t_n - 1] : 0;
  const int dead = static_cast<int>(((long long)n_tiles << dbits) | dmax);
  for (long long j = n_e + first; j < size; j += stride) {
    key[j] = dead;
    tri[j] = t_n;
  }
}

__global__ void __launch_bounds__(kThreads)
entry_table_kernel(long long size, long long e_pad, int t_n, int n_tiles,
                   int dbits, const int* key, const long long* order,
                   const int* tri, const float* ftab, float* geom,
                   int* entry_tri, int* starts) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= e_pad) return;
  int tr = t_n;
  if (j < size) {
    tr = tri[order[j]];
    const int tile = key[j] >> dbits;
    const int prev = j ? key[j - 1] >> dbits : -1;
    for (int t = prev + 1; t <= tile && t <= n_tiles; ++t)
      starts[t] = static_cast<int>(j);
  } else if (j == size) {
    const int prev = size ? key[size - 1] >> dbits : -1;
    for (int t = prev + 1; t <= n_tiles; ++t)
      starts[t] = static_cast<int>(size);
  }
  const bool live = tr < t_n;
  const float* row = ftab + 11ll * (live ? tr : 0);
#pragma unroll
  for (int r = 0; r < 11; ++r)
    geom[r * e_pad + j] = live ? row[r] : (r == 10 ? kBig : 0.0f);
  entry_tri[j] = live ? tr : -1;
}

int blocks(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int bin_prepass_threads() { return kThreads; }

// K8. leaves: 9 pointers; proj: 8 pointers (Proj's order); part: (blocks,
// 8) f32, part_c (blocks,) i64, counter one u32 that is 0 (the last block
// leaves it 0); stats (8,) f32, cross_tris () i64.
extern "C" int bin_tri_pass_launch(int t_n, const void* const* leaves,
                                   const void* const* proj, const void* o,
                                   int res_h, int res_w, int th, int tw,
                                   int cull, double k1, double eps_f,
                                   void* ntiles, void* tinfo, void* ftab,
                                   void* part, void* part_c, void* counter,
                                   void* stats, void* cross_tris,
                                   void* stream) {
  if (t_n < 0 || res_h < 1 || res_w < 1 || th < 1 || tw < 1)
    return (int)cudaErrorInvalidValue;
  Leaves lv;
  for (int k = 0; k < 9; ++k) lv.f[k] = static_cast<const float*>(leaves[k]);
  const float* const* pp = reinterpret_cast<const float* const*>(proj);
  const Proj pr{pp[0], pp[1], pp[2], pp[3], pp[4], pp[5], pp[6], pp[7]};
  const int nb = t_n ? blocks(t_n) : 1;
  tri_pass_kernel<<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t_n, lv, pr, static_cast<const float*>(o), res_h, res_w, th, tw, cull,
      float(k1), float(eps_f), static_cast<long long*>(ntiles),
      static_cast<int*>(tinfo), static_cast<float*>(ftab),
      static_cast<float*>(part), static_cast<long long*>(part_c),
      static_cast<unsigned*>(counter), static_cast<float*>(stats),
      static_cast<long long*>(cross_tris));
  return (int)cudaGetLastError();
}

extern "C" int ray_table_launch(int n_tiles, int p, int n_tx, int th, int tw,
                                int row0, const void* const* proj,
                                const void* o, const void* stats,
                                double draw, void* rays, void* stream) {
  if (n_tiles < 1 || p < 1 || n_tx < 1
      || (long long)n_tiles * p >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const float* const* pp = reinterpret_cast<const float* const*>(proj);
  const Proj pr{pp[0], pp[1], pp[2], pp[3], pp[4], pp[5], pp[6], pp[7]};
  const int n = n_tiles * p;
  ray_table_kernel<<<blocks(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      n, p, n_tx, th, tw, row0, pr, static_cast<const float*>(o),
      static_cast<const float*>(stats), float(draw),
      static_cast<float4*>(rays));
  return (int)cudaGetLastError();
}

extern "C" int entry_keys_launch(int t_n, const void* cum,
                                 const void* ntiles, const void* tinfo,
                                 const void* ftab, const void* stats,
                                 int n_tx, int n_tiles, int dbits,
                                 long long size, void* key, void* tri,
                                 void* qstep, void* stream) {
  if (t_n < 0 || size < 0 || dbits < 1 || dbits > 30)
    return (int)cudaErrorInvalidValue;
  long long n = t_n > size ? t_n : size;
  int nb = blocks(n > 0 ? n : 1);
  if (nb > 132 * 16) nb = 132 * 16;   // grid-stride beyond 16 CTAs an SM
  entry_keys_kernel<<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t_n, static_cast<const long long*>(cum),
      static_cast<const long long*>(ntiles), static_cast<const int*>(tinfo),
      static_cast<const float*>(ftab), static_cast<const float*>(stats),
      n_tx, n_tiles, dbits, size, static_cast<int*>(key),
      static_cast<int*>(tri), static_cast<float*>(qstep));
  return (int)cudaGetLastError();
}

extern "C" int entry_table_launch(long long size, long long e_pad, int t_n,
                                  int n_tiles, int dbits, const void* key,
                                  const void* order, const void* tri,
                                  const void* ftab, void* geom,
                                  void* entry_tri, void* starts,
                                  void* stream) {
  if (size < 0 || e_pad <= size || t_n < 0 || n_tiles < 1 || dbits < 1
      || dbits > 30)
    return (int)cudaErrorInvalidValue;
  entry_table_kernel<<<blocks(e_pad), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      size, e_pad, t_n, n_tiles, dbits, static_cast<const int*>(key),
      static_cast<const long long*>(order), static_cast<const int*>(tri),
      static_cast<const float*>(ftab), static_cast<float*>(geom),
      static_cast<int*>(entry_tri), static_cast<int*>(starts));
  return (int)cudaGetLastError();
}
