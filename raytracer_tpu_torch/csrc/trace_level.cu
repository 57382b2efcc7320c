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
// of the frame is masked. The table without its materials is copied into
// shared memory, the spheres as one float4 each (centre, |c|^2 - r^2: one
// broadcast load a sphere where the columns took four) and the walls,
// boxes, chunk tables, slab, lights and sky as they are: 18 KB for 1024
// spheres, 36 KB for 2048; past 48 KB the launch opts in to more (up to 227
// KB a block); each block copies it once. The materials and the winner's
// sphere columns are read from device memory, one winner per lane, through
// L1. The tile's shortlist (phase A's chunk order and count, or every chunk
// in index order for an identity list) is copied into shared memory. Each
// lane folds walls and boxes, then the warp walks the list
// (trace_common.cuh's `tile_fold` and `fold_list`, which fold_shortlist.cu
// runs too): at each chunk every lane whose ray meets the slab gates it
// against its segment [t0, min(t_ex, best t)], as in trace_whole.cu, and a
// ballot counts the lanes that pass. Where at least K_PAIR (8) pass, each of
// them folds the chunk's spheres alone; where fewer pass (bounce rays of a
// 16x16 tile scatter, and dead lanes leave warps half empty), the warp folds
// the chunk for them one ray at a time, lane j testing sphere j, and a warp arg-min
// merges the chunk's nearest hit into the lane's best. The fold breaks ties
// on the global index, so its result depends neither on the order of the
// list nor on who tests which sphere. A sphere a ray misses skips sqrtf's
// slow path for negative operands (`sphere_ahead`, the same bits). The
// shading and bounce are trace_whole.cu's (trace_common.cuh). A lane whose
// throughput is 0 writes (MISS_T, -1) and passes its ray and throughput on
// unchanged. With STATS, the block then reduces the next rays into the tile's
// stats row (trace_common.cuh's `tile_stats`, which ray_stats.cu runs on
// level 0), while they are still in registers; a warp gates only the chunks
// whose box meets its lanes' segment box (`cull_meets`).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): a level reads 10
// planes (rays, throughput, accumulator) and writes 12 (t, index,
// accumulator, throughput, next rays): 22 planes of 2,073,600 lanes at
// 1920x1080, 182 MB, 54 us; chip_smoke.py counts the bytes of each run's
// data (dead lanes move fewer). Its arithmetic on grid-1024 is ~1.5-2.5 k
// float32 operations per alive lane (the floor wall ~40, the slab ~25, ~26
// per listed chunk's gate, ~22 per sphere of the chunks its gate lets
// through, the record and the shading ~150, and the next stats), below the
// bytes at 67 TFLOP/s: bytes bound it, 0.18 ms for a grid-1024 1080p d3
// frame's four launches (PERF.md). The kernels build without FMA
// contraction, so each multiply and add is an instruction of its own, at
// half the rate the operation bound assumes; the design spends them only
// where a lane's gate passes, keeps every intermediate in registers, and
// keeps a warp from folding a chunk 32 times for a few lanes.
//
// Build with -fmad=false and without fast math (ops/_build.py): a lane's
// selections and t are then bit-identical to the plain PyTorch version's.

#include "trace_common.cuh"

namespace {

using namespace rt;

constexpr int BLOCK = 256;

// The planes of one level, each [H, W]; `nxt` may be null (the last level).
struct LevelPlanes {
  RayPlanes in;  // rays and throughput
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
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  int* s_list = reinterpret_cast<int*>(sm + level_table_floats(L));
  float* scratch = sm + level_table_floats(L) + L.n_c;
  const float4* sph;
  const Tab T = tab_level_shared(L, g_tab, sm4, &sph);  // ends with __syncthreads

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const TileLane l = tile_fold(T, sph, chunk_list, counts, s_list, p.in, tile, H, W, tr, tc,
                                 tiles_w);
    const long long r = lane_offset(tile, W, tr, tc, tiles_w);
    Ray ray = l.ray;
    float w = l.w;
    if (l.valid) {
      if (l.alive) {
        float accr = p.ar[r], accg = p.ag[r], accb = p.ab[r];
        p.t[r] = shade_bounce(T, l.bt, l.bi, is_last, l.q, ray, w, accr, accg, accb);
        p.i[r] = l.bi;
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
    if (STATS) tile_stats(T, l.valid, ray, w, scratch, stats + (long long)tile * (NSTAT + L.n_c));
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
  LevelPlanes p{{ox, oy, oz, dx, dy, dz, w}, ar, ag, ab, t, i,
                nox, noy, noz, ndx, ndy, ndz, nw};
  const size_t smem = (size_t)(rt::level_table_floats(L) + L.n_c +
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
