// One bounce level of the per-level chain: the closest-hit fold over each
// tile's chunk shortlist, the winner regather, Blinn-Phong shading or the
// sky, the accumulate and the mirror bounce, and the next level's tile
// statistics.
//
// Replaces the TPU kernel `_kernel_trace_level` of
// raytracer_tpu/ops/pallas_fold.py (built by `_trace_level`, fold
// `_shortlist_fold_core`), which runs one level of a (32, 128) ray tile in
// VMEM over the tile's phase-A shortlist, each listed chunk behind a best-t
// gate taken for the whole tile, and writes the next level's reach stats so
// that a bounce level needs no stats kernel.
//
// Design: a block of 256 threads runs one tile of tr x tc pixels (the
// wrapper's tile shape, tr * tc = 256) at a time, one thread per ray, and
// walks the tiles with a grid stride; the grid is as many blocks as fit on
// the card at once (trace_common.cuh's `persistent_grid`). The ragged edge
// of the frame is masked. The table without its materials (spheres, walls,
// boxes, chunk tables, slab, lights, sky: 22 KB for 1024 spheres, 44 KB for
// 2048) is copied into shared memory; past 48 KB the launch opts in to more
// (up to 227 KB a block); each block copies it once. The materials are read from device memory, one
// winner per lane, through L1. The tile's shortlist (phase A's chunk order
// and count, or every chunk in index order for an identity list) is copied
// into shared memory, and every lane walks it: walls and boxes first, then
// each listed chunk behind the lane's own gate against its segment [t0,
// min(t_ex, best t)], as in trace_whole.cu. The fold breaks ties on the
// global index, so its result does not depend on the order of the list. The
// shading and bounce are trace_whole.cu's (trace_common.cuh). A lane whose
// throughput is 0 writes (MISS_T, -1) and passes its ray and throughput on
// unchanged. With STATS, the block then reduces the next rays into the tile's
// stats row (trace_common.cuh's `tile_stats`, which ray_stats.cu runs on
// level 0), while they are still in registers.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): a level reads 10
// planes (rays, throughput, accumulator) and writes 12 (t, index,
// accumulator, throughput, next rays): 22 planes of 2,073,600 lanes at
// 1920x1080, 182 MB, 54 us. Its arithmetic on grid-1024 is ~2-3 k float32
// operations per alive lane (the floor wall ~40, the slab ~25, ~20 per
// listed chunk's gate, ~22 per sphere of each chunk the gate lets through,
// the record and the shading ~150, and ~20 per chunk for the next stats):
// chip_smoke.py counts them on each run's data. So operations bound it; the
// design spends them only where a lane's gate passes, and keeps every
// intermediate in registers.
//
// Build with -fmad=false and without fast math (ops/_build.py): a lane's
// selections and t are then bit-identical to the plain PyTorch version's.

#include "trace_common.cuh"

namespace {

using namespace rt;

constexpr int BLOCK = 256;

// The planes of one level, each [H, W]; `nxt` may be null (the last level).
struct LevelPlanes {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *w;
  float *ar, *ag, *ab;  // accumulator, updated in place
  float *t;
  int *i;
  float *nox, *noy, *noz, *ndx, *ndy, *ndz, *nw;
};

template <bool STATS>
__global__ void __launch_bounds__(BLOCK) trace_level_kernel(
    Layout L, const float* __restrict__ g_tab, const int* __restrict__ chunk_list,
    const int* __restrict__ counts, LevelPlanes p, float* __restrict__ stats,
    int H, int W, int tr, int tc, int tiles_w, int n_tiles, int is_last) {
  extern __shared__ float sm[];
  int* s_list = reinterpret_cast<int*>(sm + fold_floats(L));
  float* scratch = sm + fold_floats(L) + L.n_c;
  const Tab T = tab_fold_shared(L, g_tab, sm);  // ends with __syncthreads

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int n_list = L.n_c;  // an identity list without chunk_list
    if (chunk_list) {
      n_list = max(counts[tile], 0);
      for (int j = threadIdx.x; j < n_list; j += blockDim.x)
        s_list[j] = chunk_list[(long long)tile * L.n_c + j];
    } else {
      for (int j = threadIdx.x; j < n_list; j += blockDim.x) s_list[j] = j;
    }
    __syncthreads();

    const int y = (tile / tiles_w) * tr + threadIdx.x / tc;
    const int x = (tile % tiles_w) * tc + threadIdx.x % tc;
    const bool valid = y < H && x < W;
    const long long r = (long long)y * W + x;
    Ray ray{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
    float w = 0.0f;
    if (valid) {
      ray = Ray{p.ox[r], p.oy[r], p.oz[r], p.dx[r], p.dy[r], p.dz[r]};
      w = p.w[r];
      if (w > 0.0f) {
        const RayTerms q = ray_terms(ray);
        float bt = MISS_T;
        int bi = -1;
        fold_walls_boxes(T, ray, q, bt, bi);
        float t0, t_ex;
        if (T.n_c && slab_segment(T, ray, q, t0, t_ex)) {
          for (int k = 0; k < n_list; ++k) {
            const int c = s_list[k];
            if (!chunk_gate(T, c, ray, q, t0, fminf(t_ex, bt))) continue;
            fold_chunk(T, c, ray, q, bt, bi);
          }
        }
        float accr = p.ar[r], accg = p.ag[r], accb = p.ab[r];
        p.t[r] = shade_bounce(T, bt, bi, is_last, q, ray, w, accr, accg, accb);
        p.i[r] = bi;
        p.ar[r] = accr; p.ag[r] = accg; p.ab[r] = accb;
      } else {
        p.t[r] = MISS_T;
        p.i[r] = -1;
      }
      if (p.nox) {
        p.nox[r] = ray.ox; p.noy[r] = ray.oy; p.noz[r] = ray.oz;
        p.ndx[r] = ray.dx; p.ndy[r] = ray.dy; p.ndz[r] = ray.dz;
        p.nw[r] = w;
      }
    }
    if (STATS) tile_stats(T, valid, ray, w, scratch, stats + (long long)tile * (NSTAT + L.n_c));
    __syncthreads();  // the list and the scratch are free for the next tile
  }
}

}  // namespace

extern "C" {

// Tiles of tr x tc (= 256) pixels of the [H, W] planes, in row-major order,
// walked by as many blocks as fit on the card. `chunk_list` [tiles, n_c] and `counts` [tiles] hold
// the shortlists, or both are null for identity lists. The next rays and
// throughput go to `next` (7 planes: o xyz, d xyz, w), or nowhere when it is
// null; with `stats` non-null the next level's tile stats go there
// ([tiles, 11 + n_c]). Returns the CUDA error of the launch (0 on success).
int trace_level_launch(const float* tab, int n_tab, int n_s, int unroll, int n_w,
                       int n_b, int n_pt, int n_sun, int gate, const int* chunk_list,
                       const int* counts, const float* ox, const float* oy,
                       const float* oz, const float* dx, const float* dy,
                       const float* dz, const float* w, float* ar, float* ag,
                       float* ab, float* t, int* i, float* nox, float* noy,
                       float* noz, float* ndx, float* ndy, float* ndz, float* nw,
                       float* stats, int H, int W, int tr, int tc, int is_last,
                       void* stream) {
  rt::Layout L = rt::make_layout(n_s, unroll, n_w, n_b, n_pt, n_sun, gate, 0);
  if (L.n_tab != n_tab || H <= 0 || W <= 0 || tr * tc != BLOCK ||
      (!chunk_list) != (!counts) || (stats && (!nox || L.n_c == 0)))
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + tc - 1) / tc, n_tiles = tiles_w * ((H + tr - 1) / tr);
  LevelPlanes p{ox, oy, oz, dx, dy, dz, w, ar, ag, ab, t, i,
                nox, noy, noz, ndx, ndy, ndz, nw};
  const size_t smem = (size_t)(rt::fold_floats(L) + L.n_c +
                               (stats ? rt::stats_scratch_words(L.n_c) : 0)) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  int n_blocks = 0;
  cudaError_t err = stats
      ? rt::persistent_grid(trace_level_kernel<true>, BLOCK, smem, n_tiles, &n_blocks)
      : rt::persistent_grid(trace_level_kernel<false>, BLOCK, smem, n_tiles, &n_blocks);
  if (err != cudaSuccess) return (int)err;
  if (stats)
    trace_level_kernel<true><<<n_blocks, BLOCK, smem, s>>>(
        L, tab, chunk_list, counts, p, stats, H, W, tr, tc, tiles_w, n_tiles, is_last);
  else
    trace_level_kernel<false><<<n_blocks, BLOCK, smem, s>>>(
        L, tab, chunk_list, counts, p, stats, H, W, tr, tc, tiles_w, n_tiles, is_last);
  return (int)cudaGetLastError();
}

const char* trace_level_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
