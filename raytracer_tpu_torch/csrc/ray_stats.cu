// Per-tile reach statistics of a frame's level-0 rays: the input of phase A
// (ops/cuda_level.py:phase_a), which builds each tile's chunk shortlist for
// the first level of the per-level chain.
//
// Replaces the TPU kernel `_kernel_ray_stats` of
// raytracer_tpu/ops/pallas_fold.py (built by `_ray_stats`, body
// `_reach_stats_rows`), which reduces a (32 or 64, 128) ray tile in VMEM to
// an (8, 128) stats block: the box of the alive rays' segments clipped to
// the sphere slab, their segment-start sums, the used-lane count, an alive
// flag, and per chunk whether any used lane's segment reaches it.
//
// Design: a block of 256 threads reduces one tile of tr x tc pixels (the
// wrapper's tile shape, tr * tc = 256) at a time, one thread per ray, and
// walks the tiles with a grid stride; the grid is as many blocks as fit on
// the card at once (trace_common.cuh's `persistent_grid`), so each block
// copies the table into shared memory once. The ragged edge of the frame is
// masked, so a partial tile counts only its real lanes. The reduction is trace_common.cuh's `tile_stats`: warp shuffles, then the
// block's warps in a fixed order through shared memory (deterministic), and
// the per-chunk union as one ballot per chunk and warp, OR-ed into a shared
// bitmask. The table without its materials (spheres, walls, boxes, chunk
// tables, slab, lights, sky) is copied into shared memory; the kernel reads
// only the slab and the chunk boxes. The row of a tile is 11 + n_c floats
// (trace_common.cuh, NSTAT), where the TPU kernel's (8, 128) block held 896
// chunks at most.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): the kernel reads 7
// planes (6 ray planes and the throughput) and writes a row per tile: at
// 1920x1080, 58 MB, 17 us. Its arithmetic is ~60 float32 operations per lane
// for the slab clip, the segment ends and the sums, and ~22 per chunk for
// the union's gate: ~770 per lane for grid-1024's 32 chunks, 1.6 GFLOP, 24
// us. So it is bound by operations on scenes of many chunks.
//
// Build with -fmad=false and without fast math (ops/_build.py).

#include "trace_common.cuh"

namespace {

using namespace rt;

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK) ray_stats_kernel(
    Layout L, const float* __restrict__ g_tab,
    const float* __restrict__ ox_p, const float* __restrict__ oy_p,
    const float* __restrict__ oz_p, const float* __restrict__ dx_p,
    const float* __restrict__ dy_p, const float* __restrict__ dz_p,
    const float* __restrict__ w_p, float* __restrict__ stats, int H, int W,
    int tr, int tc, int tiles_w, int n_tiles) {
  extern __shared__ float sm[];
  const Tab T = tab_fold_shared(L, g_tab, sm);
  float* scratch = sm + fold_floats(L);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int y = (tile / tiles_w) * tr + threadIdx.x / tc;
    const int x = (tile % tiles_w) * tc + threadIdx.x % tc;
    const bool valid = y < H && x < W;
    Ray ray{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
    float w = 0.0f;
    if (valid) {
      const long long r = (long long)y * W + x;
      ray = Ray{ox_p[r], oy_p[r], oz_p[r], dx_p[r], dy_p[r], dz_p[r]};
      w = w_p[r];
    }
    tile_stats(T, valid, ray, w, scratch, stats + (long long)tile * (NSTAT + L.n_c));
    __syncthreads();  // the scratch is free for the next tile
  }
}

}  // namespace

extern "C" {

// Tiles of tr x tc (= 256) pixels of the [H, W] planes, in row-major order,
// walked by as many blocks as fit on the card; `stats` receives [tiles,
// 11 + n_c].
// Returns the CUDA error of the launch (0 on success).
int ray_stats_launch(const float* tab, int n_tab, int n_s, int unroll, int n_w,
                     int n_b, int n_pt, int n_sun, int gate, const float* ox,
                     const float* oy, const float* oz, const float* dx,
                     const float* dy, const float* dz, const float* w,
                     float* stats, int H, int W, int tr, int tc, void* stream) {
  rt::Layout L = rt::make_layout(n_s, unroll, n_w, n_b, n_pt, n_sun, gate, 0);
  if (L.n_tab != n_tab || H <= 0 || W <= 0 || tr * tc != BLOCK || L.n_c == 0)
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + tc - 1) / tc, n_tiles = tiles_w * ((H + tr - 1) / tr);
  const size_t smem =
      (size_t)(rt::fold_floats(L) + rt::stats_scratch_words(L.n_c)) * sizeof(float);
  int n_blocks = 0;
  cudaError_t err = rt::persistent_grid(ray_stats_kernel, BLOCK, smem, n_tiles, &n_blocks);
  if (err != cudaSuccess) return (int)err;
  ray_stats_kernel<<<n_blocks, BLOCK, smem, (cudaStream_t)stream>>>(
      L, tab, ox, oy, oz, dx, dy, dz, w, stats, H, W, tr, tc, tiles_w, n_tiles);
  return (int)cudaGetLastError();
}

const char* ray_stats_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
