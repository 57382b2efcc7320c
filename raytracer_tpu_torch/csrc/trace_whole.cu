// Whole-trace kernel: every bounce level of every ray in one launch.
//
// Replaces the TPU kernel `_kernel_trace_whole` of
// raytracer_tpu/ops/pallas_fold.py (built by `_trace_whole`), which runs the
// closest-hit fold, the winner regather, Blinn-Phong shading, the sky and the
// mirror bounce for all levels of a (64, 128) ray tile in VMEM.
//
// Design: one thread per ray, one block of 256 threads a tile of pixels of
// the [H, W] planes (cuda_fold.whole_grid). Tiles differ several-fold in
// work (sky against a cluster of spheres), and the card's block scheduler
// balances them where a grid-stride walk of as many blocks as fit did not
// (16-31% slower on the grids; this and the figures below measured on an
// NVIDIA H100 80GB HBM3 at 700 W, PERF.md). The ray, its throughput and its
// accumulator stay in registers across levels, so the only device-memory
// traffic is the 7 input planes and the 3 + 2 * (depth + 1) output planes.
// At each level a lane folds walls and boxes, then the sphere chunks behind
// its gate (the chunk box or bounding sphere against its segment [t0,
// min(t_ex, best t)]), ties to the lower global index, so the result
// depends on no route. Two instantiations, by the scene's chunks:
//
// - The cooperative route (chunks of at least PAIR_MIN_UNROLL spheres):
//   tiles of 32 rows x 8 columns, so a warp is 4 x 8 pixels whose rays
//   reach nearly the same chunks (about 3% faster than 16 x 16 and 11-13%
//   than row strips on the grids). Each block copies the table into
//   shared memory as trace_level.cu does (`tab_level_shared`: the spheres
//   as one float4 each, 14 KB for 768 spheres; the materials and the
//   winner's sphere columns read from device memory, one winner per lane).
//   The warp walks every chunk in index order (trace_common.cuh's
//   `fold_list` over an `IdentityList`, the fold of trace_level.cu and
//   fold_shortlist.cu): where fewer than K_PAIR lanes pass a chunk's gate
//   (bounce rays scatter, dead lanes leave warps half empty) the warp folds
//   it for them one ray at a time, lane j testing sphere j; a sphere a ray
//   misses skips sqrtf (`sphere_ahead`). Every lane of a tile walks the
//   chunks, dead or outside the frame (`fold_list`'s ballots take all 32
//   lanes); a warp whose lanes are all dead skips the level.
// - The lane route (chunks of one sphere, which are never folded
//   cooperatively: sprint3, the demo, frames bound by their bytes): each
//   lane on its own, as the port's first design ran, with no warp
//   collectives, in strips of 256 pixels over the flat planes (whole
//   128-byte rows of every plane), the packed table copied as it is (one
//   loop: the cheapest set-up for these short blocks) and sqrtf taken for
//   every sphere a gate passes (a one-sphere chunk's gate is the sphere's
//   own bounding sphere: nearly every ray it passes hits). Together 6-11%
//   faster for them than the cooperative walk in tiles.
//
// A lane whose throughput is 0 writes (MISS_T, -1) and keeps its ray.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): the sprint3 frame at
// 1920x1080 and depth 3 moves 7 input and 11 output planes of 2,073,600 lanes
// of 4 bytes, 149 MB, at least 45 us; its arithmetic is below that (most
// lanes die at level 0). The grids of 64-768 spheres at 1080p d3 move the
// same bytes; their arithmetic is ~25 operations per chunk gate and ~22 per
// sphere of a chunk a gate lets through, per alive lane and level
// (chip_smoke.py's `trace_whole_ops` counts the least on each run's data).
// The kernels build without FMA contraction, so each multiply and add is an
// instruction of its own; the design spends them only where a lane's gate
// passes, keeps every intermediate in registers, and keeps a warp from
// folding a chunk 32 times for a few lanes.
//
// With `emit_res` (the training forward) the kernel also writes each level
// k >= 1's input rays and throughput, 7 planes per level, which the backward
// kernel (trace_whole_bwd.cu) reads: 21 more output planes at depth 3, 174 MB
// at 1080p, which at least doubles the bound. It is a template parameter,
// so the inference launch compiles to the code without those stores.
//
// The fold, the shading and the bounce are trace_common.cuh's, which the
// per-level kernel (trace_level.cu) shares. Float semantics follow the plain
// PyTorch version op for op (-fmad=false, no fast math): a lane's
// selections, t and accumulators are bit-identical to it.

#include "trace_common.cuh"

namespace {

using namespace rt;

constexpr int BLOCK = 256;

// The planes of one launch: the input rays and throughput (each [H, W]), the
// accumulator [3][H, W], each level's t and index [depth + 1][H, W], and with
// EMIT_RES the residuals [depth][7][H, W].
struct WholePlanes {
  RayPlanes in;
  float *ar, *ag, *ab, *t;
  int* i;
  float* res;
};

template <bool EMIT_RES, bool COOP>
__global__ void __launch_bounds__(BLOCK) trace_whole_kernel(
    Layout L, const float* __restrict__ g_tab, WholePlanes p, int H, int W, int tc_log2) {
  extern __shared__ float4 sm4[];
  const float4* sph = nullptr;
  Tab T;
  if (COOP) {
    T = tab_level_shared(L, g_tab, sm4, &sph);  // ends with __syncthreads
  } else {  // the packed table as it is
    float* tab = reinterpret_cast<float*>(sm4);
    for (int j = threadIdx.x; j < L.n_tab; j += BLOCK) tab[j] = g_tab[j];
    __syncthreads();
    T = tab_whole(L, tab);
  }
  const long long n = (long long)H * W;
  // Block (bx, by) is the tile at column bx, row by; a tile is BLOCK >> tc_log2
  // rows of 1 << tc_log2 pixels, thread t at row t >> tc_log2 of it.
  const int y = (blockIdx.y << (8 - tc_log2)) + (threadIdx.x >> tc_log2);
  const int x = (blockIdx.x << tc_log2) + (threadIdx.x & ((1 << tc_log2) - 1));
  const bool valid = y < H && x < W;
  if (!COOP && !valid) return;  // the lane route has no warp collectives
  const long long r = (long long)y * W + x;
  Ray ray{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  float w = 0.0f;
  if (valid) {
    ray = Ray{p.in.ox[r], p.in.oy[r], p.in.oz[r], p.in.dx[r], p.in.dy[r], p.in.dz[r]};
    w = p.in.w[r];
  }
  float accr = 0.0f, accg = 0.0f, accb = 0.0f;

  for (int k = 0; k <= L.depth; ++k) {
    const long long out = (long long)k * n + r;
    if (EMIT_RES && k >= 1 && valid) {
      float* res = p.res + (long long)(k - 1) * 7 * n + r;
      res[0] = ray.ox; res[n] = ray.oy; res[2 * n] = ray.oz;
      res[3 * n] = ray.dx; res[4 * n] = ray.dy; res[5 * n] = ray.dz; res[6 * n] = w;
    }
    const bool alive = w > 0.0f;  // false outside the frame
    if (COOP ? !__any_sync(FULL, alive) : !alive) {
      if (valid) {
        p.t[out] = MISS_T;
        p.i[out] = -1;
      }
      continue;
    }

    // ---- closest-hit fold: walls, boxes (strict <), then every sphere
    // chunk behind its per-lane gate (ties to the lower global index) ----
    const RayTerms q = ray_terms(ray);
    float bt = MISS_T;
    int bi = -1;
    if (alive) fold_walls_boxes(T, ray, q, bt, bi);
    float t0 = 0.0f, t_ex = 0.0f;
    const bool seg = alive && T.n_c && slab_segment(T, ray, q, t0, t_ex);
    if (COOP) {
      if (__any_sync(FULL, seg))
        fold_list(T, sph, IdentityList{}, T.n_c, seg, ray, q, t0, t_ex, bt, bi);
    } else if (seg) {
      for (int c = 0; c < T.n_c; ++c)
        if (chunk_gate(T, c, ray, q, t0, fminf(t_ex, bt))) fold_chunk(T, c, ray, q, bt, bi);
    }

    // ---- winner record, shading, sky, accumulate, bounce ----
    if (alive) {
      p.t[out] = shade_bounce(T, bt, bi, k == L.depth, q, ray, w, accr, accg, accb);
      p.i[out] = bi;
    } else if (valid) {
      p.t[out] = MISS_T;
      p.i[out] = -1;
    }
  }

  if (valid) {
    p.ar[r] = accr;
    p.ag[r] = accg;
    p.ab[r] = accb;
  }
}

template <bool EMIT_RES, bool COOP>
cudaError_t launch(const Layout& L, const float* tab, const WholePlanes& p, int H, int W,
                   int tc_log2, cudaStream_t s) {
  const int tc = 1 << tc_log2, tr = BLOCK >> tc_log2;
  const long long tiles_w = ((long long)W + tc - 1) / tc, tiles_h = ((long long)H + tr - 1) / tr;
  if (tiles_w > INT_MAX || tiles_h > 65535) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(COOP ? level_table_floats(L) : L.n_tab) * sizeof(float);
  cudaError_t err = opt_in_smem(trace_whole_kernel<EMIT_RES, COOP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)tiles_w, (unsigned)tiles_h);
  trace_whole_kernel<EMIT_RES, COOP><<<grid, BLOCK, smem, s>>>(L, tab, p, H, W, tc_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One block a tile of tr x tc (= 256, tc a power of two) pixels of the
// [H, W] planes, the grid's x the tile's column and its y the tile's row (at
// most 65535 tile rows), on `stream`; `res` is written only with `emit_res`
// (and may be null without). Returns the CUDA error of the launch (0 on
// success).
int trace_whole_launch(const float* tab, int n_tab, int n_s, int unroll, int n_w, int n_b,
                       int n_pt, int n_sun, int gate, int depth, int emit_res,
                       const float* ox, const float* oy, const float* oz, const float* dx,
                       const float* dy, const float* dz, const float* w, float* ar,
                       float* ag, float* ab, float* t_out, int* i_out, float* res, int H,
                       int W, int tr, int tc, void* stream) {
  rt::Layout L = rt::make_layout(n_s, unroll, n_w, n_b, n_pt, n_sun, gate, depth);
  int tc_log2 = 0;
  while (tc_log2 < 8 && (1 << tc_log2) < tc) ++tc_log2;
  if (L.n_tab != n_tab || H <= 0 || W <= 0 || tc != 1 << tc_log2 || tr * tc != BLOCK ||
      (emit_res && depth > 0 && !res))
    return (int)cudaErrorInvalidValue;
  WholePlanes p{{ox, oy, oz, dx, dy, dz, w}, ar, ag, ab, t_out, i_out, res};
  cudaStream_t s = (cudaStream_t)stream;
  // Chunks of one sphere are never folded cooperatively (PAIR_MIN_UNROLL):
  // their scenes take the lane route.
  const bool coop = unroll >= rt::PAIR_MIN_UNROLL;
  if (emit_res)
    return (int)(coop ? launch<true, true>(L, tab, p, H, W, tc_log2, s)
                      : launch<true, false>(L, tab, p, H, W, tc_log2, s));
  return (int)(coop ? launch<false, true>(L, tab, p, H, W, tc_log2, s)
                    : launch<false, false>(L, tab, p, H, W, tc_log2, s));
}

const char* trace_whole_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
