// Nearest hit per primary ray over a tile's depth-sorted entry blocks.
//
// Replaces the JAX package's Pallas kernel `_kernel` in
// cpp_cuda_raytracer_dev_tpu/ops/pallas/bin_kernel3.py (launched by
// `pallas_bin_intersect3`). What it computes, per tile t and ray r of the
// tile, over the blocks b = starts[t] / chunk .. (starts[t+1] - 1) / chunk
// (one block for an empty tile), in order:
//
//   gate:   skip block b when  min depth(b) >= max_r min(best_r, bound_r)
//   MT:     det = A.d, u' = B.d, v' = C.d
//           accept when min(u' det, v' det, (det - u' - v') det,
//                           TD det - eps det^2) >= 0 and det^2 >= (k1 eps)^2
//           t = TD / det
//   select: within a block the lowest triangle id at the minimum t;
//           across blocks the best changes only on a strictly smaller t.
//
// Telemetry switch (kernel K3 of the JAX package, `_kernel` in
// ops/pallas/bin_kernel2.py, launched by `pallas_bin_intersect2`): with
// esub > 1 each block is scanned as esub slices of chunk / esub entries,
// each with its own gate (which sees the previous slices' hits); the
// select rules above then hold per slice. When `steps` is not null the
// kernel also writes steps[t] = [slices scanned, blocks walked] per tile.
// Both switches are template parameters: with esub = 1 and steps null the
// instantiation is K1 (ops/pallas/bin_kernel3.py) exactly, in code and in
// time (taking the gate's depth minimum while staging, counting nothing).
// With a run-time esub loop and steps counter in that path, K1 ran
// measurably slower on the H100, by instruction scheduling alone.
//
// Design: one CTA per tile, one thread per ray (P = tile_h * tile_w <= 1024
// threads). The CTA walks the tile's block range; each block (11 float
// rows plus the int32 ids, 24 KB at chunk 512) is copied into shared memory
// cooperatively, one block-wide min (depth) and max (min(best, bound))
// form the gate, then every thread loops over the block's entries reading
// shared memory as broadcasts.
//
// Bound: FP32 issue. A ray-entry pair costs 31 FP32 operations: 24
// multiplies, adds and subtracts (three 3-term dots, 15; det^2, 1; the
// four acceptance terms, 8) and 7 comparisons (five acceptance tests, two
// in the select); the division runs only on accepted entries. The entry rows
// come from shared memory as broadcasts and each block is read from device
// memory once per tile, so the FMA pipes, not bytes, are the limit. The
// depth-sorted gate is what keeps the work down: blocks behind every ray's
// current best are never scanned.
//
// Numerics: build with -fmad=false and without fast math, so every product
// and sum rounds as the plain PyTorch version's separate operations do and
// t = TD / det is IEEE division; the two agree bit for bit. eps,
// (k1 eps)^2 and the draw distance arrive as float32 arguments.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 11;          // A(3) | B(3) | C(3) | TD | depth
constexpr float kMissT = 3.0e38f;  // t of a rejected entry
constexpr float kTinyDet = 1e-30f;

__device__ __forceinline__ float warp_min(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <bool kSliced, bool kSteps>
__global__ void __launch_bounds__(1024)
bin_intersect_kernel(const float4* __restrict__ rays,    // (nT, P) [d, bound]
                     const float* __restrict__ geom,     // (11, epad)
                     const int* __restrict__ entry_tri,  // (epad,)
                     const int* __restrict__ starts,     // (nT + 1,)
                     float* __restrict__ out_t,          // (nT, P)
                     int* __restrict__ out_tri,          // (nT, P)
                     int* __restrict__ steps,            // (nT, 2) or null
                     int p, int epad, int chunk, int esub,
                     float eps, float eps2_det, float draw_distance) {
  extern __shared__ float smem[];            // kRows * chunk floats, chunk ids
  float* g = smem;
  int* ids = reinterpret_cast<int*>(smem + kRows * chunk);
  __shared__ float red_min[32], red_max[32];

  const int tile = blockIdx.x;
  const int r = threadIdx.x;
  const int lane = r & 31, warp = r >> 5, nwarps = p >> 5;
  const float4 ray = rays[(size_t)tile * p + r];

  float best = draw_distance;
  int best_tri = -1;
  const int s0 = starts[tile], s1 = starts[tile + 1];
  const int first = s0 / chunk;
  const int last = s1 > s0 ? (s1 - 1) / chunk : first;

  const int n_slices = kSliced ? esub : 1;
  const int el = chunk / n_slices;
  int n_scanned = 0;
  for (int b = first; b <= last; ++b) {
    __syncthreads();                         // previous block fully read
    const size_t base = (size_t)b * chunk;
    float dmin = __int_as_float(0x7f800000);
    for (int k = r; k < chunk; k += p) {
#pragma unroll
      for (int row = 0; row < kRows; ++row)
        g[row * chunk + k] = geom[(size_t)row * epad + base + k];
      ids[k] = entry_tri[base + k];
      if (!kSliced) dmin = fminf(dmin, g[10 * chunk + k]);
    }
    for (int s = 0; s < n_slices; ++s) {
      // slice 0 reads back only depths this thread staged itself; later
      // slices read other threads' entries and reuse red_min / red_max,
      // so they start at a barrier
      if (s > 0) __syncthreads();
      const int k0 = s * el, k1 = k0 + el;
      if (kSliced) {
        dmin = __int_as_float(0x7f800000);
        for (int k = k0 + r; k < k1; k += p) dmin = fminf(dmin, g[10 * chunk + k]);
      }
      float wmax = fminf(best, ray.w);
      dmin = warp_min(dmin);
      wmax = warp_max(wmax);
      if (lane == 0) {
        red_min[warp] = dmin;
        red_max[warp] = wmax;
      }
      __syncthreads();
      float cmin = red_min[0], wb = red_max[0];
      for (int w = 1; w < nwarps; ++w) {
        cmin = fminf(cmin, red_min[w]);
        wb = fmaxf(wb, red_max[w]);
      }
      if (!(cmin < wb)) continue;            // uniform over the CTA
      ++n_scanned;

      float bt = __int_as_float(0x7f800000);
      int bi = 0x7fffffff;
      for (int k = k0; k < k1; ++k) {
        const float det = ray.x * g[k] + ray.y * g[chunk + k] + ray.z * g[2 * chunk + k];
        const float up = ray.x * g[3 * chunk + k] + ray.y * g[4 * chunk + k]
                       + ray.z * g[5 * chunk + k];
        const float vp = ray.x * g[6 * chunk + k] + ray.y * g[7 * chunk + k]
                       + ray.z * g[8 * chunk + k];
        const float td = g[9 * chunk + k];
        const float dd2 = det * det;
        const bool ok = (up * det >= 0.f) && (vp * det >= 0.f)
                     && ((det - up - vp) * det >= 0.f)
                     && (td * det - eps * dd2 >= 0.f) && (dd2 >= eps2_det);
        float tt = kMissT;
        if (ok) tt = td / (det == 0.f ? kTinyDet : det);
        const int id = ids[k];
        if (tt < bt || (tt == bt && id < bi)) {
          bt = tt;
          bi = id;
        }
      }
      if (bt < best) {
        best = bt;
        best_tri = bi;
      }
    }
  }
  if (kSteps && r == 0) {
    steps[2 * tile] = n_scanned;
    steps[2 * tile + 1] = last - first + 1;
  }
  out_t[(size_t)tile * p + r] = best;
  out_tri[(size_t)tile * p + r] = best_tri;
}

}  // namespace

extern "C" int bin_intersect_launch(const void* rays, const void* geom,
                                    const void* entry_tri, const void* starts,
                                    void* out_t, void* out_tri, void* steps,
                                    int n_tiles, int p, int epad, int chunk,
                                    int esub, float eps, float eps2_det,
                                    float draw_distance, void* stream) {
  // dynamic shared memory above 48 KB (with the static reduction arrays)
  // needs the opt-in; setting it always is one cheap host call
  const size_t smem = (size_t)(kRows + 1) * chunk * sizeof(float);
  auto kernel = esub > 1 ? (steps ? bin_intersect_kernel<true, true>
                                  : bin_intersect_kernel<true, false>)
                         : (steps ? bin_intersect_kernel<false, true>
                                  : bin_intersect_kernel<false, false>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n_tiles, p, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rays), static_cast<const float*>(geom),
      static_cast<const int*>(entry_tri), static_cast<const int*>(starts),
      static_cast<float*>(out_t), static_cast<int*>(out_tri),
      static_cast<int*>(steps), p, epad, chunk, esub, eps, eps2_det,
      draw_distance);
  return (int)cudaGetLastError();
}
