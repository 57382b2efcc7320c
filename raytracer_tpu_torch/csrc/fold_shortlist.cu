// The shortlist closest-hit fold, and with RECORD the winner's full hit
// record: the fold of the closest-hit API (ops/cuda_hit.py).
//
// Replaces two TPU kernels of raytracer_tpu/ops/pallas_fold.py:
// - `_kernel_shortlist` (built by `_fold_shortlist`, entry
//   `fold_closest_pallas_shortlist`): the fold of a (sl_r, 128) ray tile
//   over its phase-A chunk shortlist, each listed chunk behind a best-t gate
//   taken for the whole tile; it writes (t, index);
// - `_kernel_shortlist_hit` (built by `_fold_shortlist_hit`, entry
//   `hit_closest_pallas_shortlist`): the same fold, then the winners'
//   attributes by a masked sweep over the tile's shortlisted chunks, walls
//   and boxes (`_regather_core`) and the record math (`_record_math`); it
//   writes 16 planes: t (recomputed), index, hit point, normal, colour,
//   ambient, metallic, diffuse, specular, exponent.
//
// Design: trace_level.cu's fold without the shading: both kernels run
// trace_common.cuh's `tile_fold`. A block of 256 threads runs one tile of
// tr x tc pixels (tr * tc = 256) at a time, one thread per ray, and walks the
// tiles with a grid stride; the grid is as many blocks as fit on the card at
// once (`persistent_grid`). Each block copies the table without its
// materials into shared memory once (`tab_level_shared`): the spheres as one
// float4 each (centre, |c|^2 - r^2), one broadcast load a sphere test where
// four columns took four, and the walls, boxes, chunk tables, slab, lights
// and sky as they are (18 KB for 1024 spheres, 36 KB for 2048; past 48 KB
// the launch opts in to more). The tile's shortlist (phase A's order and
// count, or every chunk in index order) is copied once per tile. Every lane
// of the tile enters the fold, the ragged edge's too, since the warp's
// ballots and shuffles take all 32 lanes; a lane outside the frame or whose
// alive plane `w` is 0 folds nothing. Each alive lane folds the walls and
// boxes, then the warp walks the list (`fold_list`): each lane that meets
// the slab gates each listed chunk against its own segment [t0, min(t_ex,
// best t)]; where at least K_PAIR (8) lanes of the warp pass, each folds the
// chunk's spheres alone, and where fewer pass (bounce rays scatter, dead
// lanes leave warps half empty) the warp folds the chunk for them one ray
// at a time, lane j testing sphere j, a warp arg-min merging the chunk's
// nearest hit into the lane's best (not for chunks of one sphere, as c1's:
// PAIR_MIN_UNROLL). A sphere the ray misses skips sqrtf,
// whose negative operands take its slow path (`sphere_ahead`, the same
// bits). The fold breaks ties on the global index, so its result depends
// neither on the order of the list nor on who tests which sphere. With
// RECORD the lane regathers its winner by index (its sphere columns and
// materials from device memory, one row per lane), where the TPU kernel
// swept every shortlisted chunk with masked selects, and runs
// `winner_record` (the record part of the level math that trace_whole.cu
// and trace_level.cu run). A miss (or a dead lane) writes (MISS_T, -1), the
// point o + d, the normal (0, 0, 1) and zero materials, as the plain
// version does.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): the fold reads 7
// planes and writes 2 (9 planes, 75 MB at 1920x1080, 22 us); the record
// variant writes 16 (23 planes, 191 MB, 57 us). The arithmetic is ~40
// float32 operations for the walls and the slab, ~25 per listed chunk's
// gate and ~22 per sphere of each chunk the gate lets through, and ~40 for
// the record: chip_smoke.py counts it on each run's data (`fold_ops`). On
// grid-1024 a lane's gate passes a few chunks of 32 spheres: the sphere
// tests, built without FMA contraction, are the work, and the design spends
// them only where a lane's gate passes, keeps a warp from testing a chunk 32
// lanes wide for a few lanes, and keeps every intermediate in registers. On
// scenes of a few primitives bytes bound it.
//
// Build with -fmad=false and without fast math (ops/_build.py): every output
// is then bit-identical to the plain PyTorch version's.

#include "trace_common.cuh"

namespace {

using namespace rt;

constexpr int BLOCK = 256;
constexpr int N_REC = 14;  // record planes after (t, index)

// The planes of one call, each [H, W]; `rec` is used only with RECORD.
struct FoldPlanes {
  RayPlanes in;  // rays and the alive plane
  float* t;
  int* i;
  float* rec[N_REC];  // hit point xyz, normal xyz, colour rgb, amb, met, dif, spe, exp
};

template <bool RECORD>
__global__ void __launch_bounds__(BLOCK) fold_shortlist_kernel(
    Layout L, const float* __restrict__ g_tab, const int* __restrict__ chunk_list,
    const int* __restrict__ counts, FoldPlanes p, int H, int W, int tr, int tc, int tiles_w,
    int n_tiles) {
  extern __shared__ float4 sm4[];
  int* s_list = reinterpret_cast<int*>(reinterpret_cast<float*>(sm4) + level_table_floats(L));
  const float4* sph;
  const Tab T = tab_level_shared(L, g_tab, sm4, &sph);  // ends with __syncthreads

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const TileLane l = tile_fold(T, sph, chunk_list, counts, s_list, p.in, tile, H, W, tr, tc,
                                 tiles_w);
    if (l.valid) {
      const long long r = lane_offset(tile, W, tr, tc, tiles_w);
      const Ray& ray = l.ray;
      p.i[r] = l.bi;
      if (!RECORD) {
        p.t[r] = l.bt;
      } else if (l.bi >= 0) {
        const HitRec h = winner_record(T, l.bt, l.bi, ray, l.q);
        p.t[r] = h.tt;
        p.rec[0][r] = h.hpx; p.rec[1][r] = h.hpy; p.rec[2][r] = h.hpz;
        p.rec[3][r] = h.hnx; p.rec[4][r] = h.hny; p.rec[5][r] = h.hnz;
#pragma unroll
        for (int c = 0; c < 8; ++c) p.rec[6 + c][r] = T.mc(c, l.bi);
      } else {
        p.t[r] = l.bt;
        p.rec[0][r] = ray.ox + ray.dx * 1.0f;
        p.rec[1][r] = ray.oy + ray.dy * 1.0f;
        p.rec[2][r] = ray.oz + ray.dz * 1.0f;
        p.rec[3][r] = 0.0f; p.rec[4][r] = 0.0f; p.rec[5][r] = 1.0f;
#pragma unroll
        for (int c = 0; c < 8; ++c) p.rec[6 + c][r] = 0.0f;
      }
    }
    __syncthreads();  // the list is free for the next tile
  }
}

}  // namespace

extern "C" {

// Tiles of tr x tc (= 256) pixels of the [H, W] planes, in row-major order,
// walked by as many blocks as fit on the card. `chunk_list` [tiles, n_c] and
// `counts` [tiles] hold the shortlists, or both are null for identity lists.
// A lane folds where `w` > 0. With `rec0` non-null the 14 record planes
// `rec0`..`rec13` are written too (all non-null). Returns the CUDA error of
// the launch (0 on success).
int fold_shortlist_launch(const float* tab, int n_tab, int n_s, int unroll, int n_w, int n_b,
                          int n_pt, int n_sun, int gate, const int* chunk_list,
                          const int* counts, const float* ox, const float* oy,
                          const float* oz, const float* dx, const float* dy,
                          const float* dz, const float* w, float* t, int* i,
                          float* rec0, float* rec1, float* rec2, float* rec3, float* rec4,
                          float* rec5, float* rec6, float* rec7, float* rec8, float* rec9,
                          float* rec10, float* rec11, float* rec12, float* rec13, int H,
                          int W, int tr, int tc, void* stream) {
  rt::Layout L = rt::make_layout(n_s, unroll, n_w, n_b, n_pt, n_sun, gate, 0);
  FoldPlanes p{{ox, oy, oz, dx, dy, dz, w}, t, i,
               {rec0, rec1, rec2, rec3, rec4, rec5, rec6, rec7, rec8, rec9, rec10, rec11,
                rec12, rec13}};
  bool rec_ok = true;
  for (int c = 0; c < N_REC; ++c) rec_ok &= (p.rec[c] != nullptr) == (rec0 != nullptr);
  if (L.n_tab != n_tab || H <= 0 || W <= 0 || tr * tc != BLOCK ||
      (!chunk_list) != (!counts) || !rec_ok)
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + tc - 1) / tc, n_tiles = tiles_w * ((H + tr - 1) / tr);
  const size_t smem = (size_t)(rt::level_table_floats(L) + L.n_c) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  int n_blocks = 0;
  cudaError_t err = rec0
      ? rt::persistent_grid(fold_shortlist_kernel<true>, BLOCK, smem, n_tiles, &n_blocks)
      : rt::persistent_grid(fold_shortlist_kernel<false>, BLOCK, smem, n_tiles, &n_blocks);
  if (err != cudaSuccess) return (int)err;
  if (rec0)
    fold_shortlist_kernel<true><<<n_blocks, BLOCK, smem, s>>>(
        L, tab, chunk_list, counts, p, H, W, tr, tc, tiles_w, n_tiles);
  else
    fold_shortlist_kernel<false><<<n_blocks, BLOCK, smem, s>>>(
        L, tab, chunk_list, counts, p, H, W, tr, tc, tiles_w, n_tiles);
  return (int)cudaGetLastError();
}

const char* fold_shortlist_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
