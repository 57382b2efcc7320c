// The brute-force closest-hit fold: (min t, argmin global index) of every
// ray over every sphere, wall and box of the scene, with no chunk gate.
//
// Replaces the TPU kernel `_kernel` of raytracer_tpu/ops/pallas_fold.py
// (built by `_fold_flat`, entry `fold_closest_pallas`), which folds an
// (8, 128) tile of a flattened ray batch in VMEM over the whole primitive
// table, kept in SMEM through scalar prefetch and padded to its unroll:
// every sphere (strict <, ascending index), then every wall, then every box
// (strict <).
//
// Design: one thread per ray of the flat batch, blocks of 256 threads. The
// sphere table streams through shared memory in tiles of 256 spheres: each
// thread of the block loads one sphere's (center, |c|^2 - r^2) as a float4,
// the block syncs, every thread tests its ray against the whole tile, and
// the block syncs again before the next tile, so a scene of any size runs
// in 4 KB of shared memory. The spheres are visited in ascending index with
// a strict <, so ties go to the lower index; the walls and boxes come after
// them with a strict <, from the packed table in device memory (the same
// few addresses for every lane, served by L1). The result is the
// lexicographic minimum of (t, index), which the gated folds
// (fold_shortlist.cu, trace_level.cu) and the plain version compute too.
// Threads past the end of the batch load their share of each tile and test
// nothing.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): the kernel reads 6
// ray planes and writes (t, index): 8 planes, 32 bytes a ray (66 MB at
// 1920x1080, 20 us). Each ray-sphere test is ~21 float32 operations
// (trace_common.cuh's `sphere_t` and the compares), so on scenes past ~30
// spheres operations bound it: grid-1024 at 1920x1080 is ~45 GFLOP, 0.67
// ms. The design keeps the test in registers and the table reads in shared
// memory; it does nothing to skip spheres (that is what the shortlist fold
// is for).
//
// Build with -fmad=false and without fast math (ops/_build.py): the result
// is then bit-identical to the plain PyTorch version's, and a sphere miss is
// rejected through the NaN compare of `tt > 0`.

#include "trace_common.cuh"

namespace {

using namespace rt;

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK) fold_flat_kernel(
    Layout L, const float* __restrict__ g_tab,
    const float* __restrict__ ox_p, const float* __restrict__ oy_p,
    const float* __restrict__ oz_p, const float* __restrict__ dx_p,
    const float* __restrict__ dy_p, const float* __restrict__ dz_p,
    float* __restrict__ t_p, int* __restrict__ i_p, long long n) {
  __shared__ float4 s_sph[BLOCK];  // cx, cy, cz, |c|^2 - r^2 of one tile
  const Tab T = tab_whole(L, g_tab);
  const long long r = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const bool valid = r < n;
  Ray ray{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  if (valid) ray = Ray{ox_p[r], oy_p[r], oz_p[r], dx_p[r], dy_p[r], dz_p[r]};
  const RayTerms q = ray_terms(ray);
  float bt = MISS_T;
  int bi = -1;

  for (int base = 0; base < L.n_s; base += BLOCK) {
    const int j = base + threadIdx.x;
    if (j < L.n_s) s_sph[threadIdx.x] = make_float4(T.sc(0, j), T.sc(1, j), T.sc(2, j), T.sc(3, j));
    __syncthreads();
    const int m = min(BLOCK, L.n_s - base);
    if (valid) {
      for (int k = 0; k < m; ++k) {
        const float4 c = s_sph[k];
        const float tt = sphere_t(c.x, c.y, c.z, c.w, ray, q);  // NaN on a miss
        if (tt > 0.0f && tt < bt) {
          bt = tt;
          bi = base + k;
        }
      }
    }
    __syncthreads();  // the tile is free for the next one
  }
  if (!valid) return;
  fold_walls_boxes(T, ray, q, bt, bi);
  t_p[r] = bt;
  i_p[r] = bi;
}

}  // namespace

extern "C" {

// Folds the n rays of the six planes (any layout, n elements each) into
// t_out and i_out. Returns the CUDA error of the launch (0 on success).
int fold_flat_launch(const float* tab, int n_tab, int n_s, int unroll, int n_w, int n_b,
                     int n_pt, int n_sun, int gate, const float* ox, const float* oy,
                     const float* oz, const float* dx, const float* dy, const float* dz,
                     float* t_out, int* i_out, long long n, void* stream) {
  rt::Layout L = rt::make_layout(n_s, unroll, n_w, n_b, n_pt, n_sun, gate, 0);
  if (L.n_tab != n_tab || n <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + BLOCK - 1) / BLOCK);
  fold_flat_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      L, tab, ox, oy, oz, dx, dy, dz, t_out, i_out, n);
  return (int)cudaGetLastError();
}

const char* fold_flat_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
