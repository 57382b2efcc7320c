// The backward of one bounce level of the per-level chain.
//
// Replaces the TPU kernel `_kernel_trace_level_bwd` of
// raytracer_tpu/ops/pallas_fold.py (built by `_trace_level_bwd`), which
// regathers a (32, 128) tile's winners, runs `jax.vjp` of `_level_math` in
// VMEM, and scatters the attribute cotangents into a per-tile [rows, 16]
// block by walking the tile's winner chunks (the TPU's way around one-hot
// matmuls), with the light and sky cotangents reduced per tile.
//
// Design: one thread per ray, a grid-stride loop over the rays in as many
// blocks as fit on the card at once (trace_common.cuh's `persistent_grid`).
// The table without its materials is copied into shared memory, as
// trace_level.cu does; the winner's materials are read from device memory.
// A thread reads level k's saved input rays, throughput, t and index, the
// image cotangent and the cotangents of the level's outputs (those of level
// k+1's inputs, which the launch for level k+1 wrote; none after the last
// level), regathers the winner by index and runs trace_common.cuh's
// `level_adjoint`, the adjoint of `_level_math` derived by hand that
// trace_whole_bwd.cu runs for every level in one launch. It writes the 7
// cotangent planes of the level's inputs; a lane whose throughput is 0 is
// dead at this level and passes the cotangents of its outputs through.
//
// Sums over lanes: each lane sums its light and sky cotangents over its
// grid stride in shared slots of its own (no shuffles, no atomics), and
// each block adds them once into a float64 row in device memory; past three
// lights (LANE_LS_MAX) the warps sum them per ray into a shared row
// (trace_common.cuh's LaneLsSink, WarpLsSink and flush_ls, which
// trace_whole_bwd.cu runs too). The 14 attribute cotangents: the lanes of a
// warp that hit the same primitive find each other with one
// `__match_any_sync` and sum their rows in a tree over their ranks in that
// group (`group_sums`: log2 of the largest group steps of 14 shuffles, none
// where every lane hit another primitive), and each group's first lane adds
// the sums: a sphere's into a
// float64 [n_prim, 14] table in device memory with atomicAdd, a wall's or a
// box's into float32 rows in shared memory, which each block adds once into
// the table. Walls and boxes are the rows every warp would hit: grid-1024's
// floor alone is the winner of a third of the camera rays, and float64
// atomics on one address serialize in L2. (Per-block sums of the sphere
// rows too, a [n_s, 14] shared table flushed once per block, measured
// 1.2-1.7x slower: PERF.md.) The float adds come in an order that varies
// between runs; their rounding (float32 over a block's lanes, ~1e-6 of the
// sums) stays within the tolerances the checks hold them to. The chain's
// levels add into the same two tables.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): a level reads, for
// every lane, the throughput, the 3 image cotangents and the 7 cotangents
// of its outputs, and for its alive lanes the 6 ray planes, t and index;
// it writes 7 planes and the float64 sums (its winners' rows, at most
// n_prim x 14 x 8 bytes). At 1920x1080 that is at most 25 planes, 207 MB,
// 62 us, if every lane were alive. The arithmetic is ~550 float32
// operations per alive lane that hits a sphere (as trace_whole_bwd.cu's
// level) and ~60 per miss; chip_smoke.py counts bytes and operations on each
// run's data: bytes bound it, 0.20 ms for a grid-1024 1080p d3 fit step's
// four launches (PERF.md).
//
// Build with -fmad=false and without fast math (ops/_build.py).

#include "trace_common.cuh"

namespace {

using namespace rt;

constexpr int BLOCK = 256;
// Blocks an SM that ptxas fits the registers to: 2 (114 registers, no
// spill); 3 spills 244 bytes and measured 7% slower, 4 (476 bytes) 20%
// slower (PERF.md).
constexpr int MIN_BLOCKS = 2;

// The planes of one level's backward, each [n]; the `cn` (cotangents of the
// level's outputs) are all null after the last level.
struct BwdPlanes {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *w, *t;
  const int* i;
  const float *car, *cag, *cab;
  const float *cnox, *cnoy, *cnoz, *cndx, *cndy, *cndz, *cnw;
  float *cox, *coy, *coz, *cdx, *cdy, *cdz, *cw;
};

template <bool LANE_LS>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS) trace_level_bwd_kernel(
    Layout L, const float* __restrict__ g_tab, BwdPlanes p, double* __restrict__ ga,
    double* __restrict__ gl, long long n, int is_last) {
  const int n_ls = 6 * (L.n_pt + L.n_sun) + 10;
  const int n_rows = 14 * (L.n_w + L.n_b);  // the walls' and boxes' sums
  extern __shared__ float sm[];
  float* s_ls = sm + fold_floats(L);  // ls_floats(n_ls, BLOCK)
  float* s_rows = s_ls + ls_floats(n_ls, BLOCK);
  for (int j = threadIdx.x; j < ls_floats(n_ls, BLOCK) + n_rows; j += BLOCK) s_ls[j] = 0.0f;
  const Tab T = tab_fold_shared(L, g_tab, sm);  // ends with __syncthreads
  const bool has_next = p.cnox != nullptr;

  for (long long base = (long long)blockIdx.x * BLOCK; base < n;
       base += (long long)gridDim.x * BLOCK) {
    const long long r = base + threadIdx.x;
    const bool valid = r < n;
    // Cotangents of the level's outputs: the next rays and throughput.
    float co[3] = {0.0f, 0.0f, 0.0f}, cd[3] = {0.0f, 0.0f, 0.0f}, cw = 0.0f;
    float w = 0.0f;
    if (valid) {
      w = p.w[r];
      if (has_next) {
        co[0] = p.cnox[r]; co[1] = p.cnoy[r]; co[2] = p.cnoz[r];
        cd[0] = p.cndx[r]; cd[1] = p.cndy[r]; cd[2] = p.cndz[r];
        cw = p.cnw[r];
      }
    }
    const bool alive = w > 0.0f;
    if (__any_sync(FULL, alive)) {
      float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 1.0f};
      float t_sel = 0.0f, car = 0.0f, cag = 0.0f, cab = 0.0f;
      int bi = -1;
      if (alive) {
        o[0] = p.ox[r]; o[1] = p.oy[r]; o[2] = p.oz[r];
        d[0] = p.dx[r]; d[1] = p.dy[r]; d[2] = p.dz[r];
        t_sel = p.t[r];
        bi = p.i[r];
        car = p.car[r]; cag = p.cag[r]; cab = p.cab[r];
      }
      float c_o[3], c_d[3], c_w, ca[14];
      bool act;
      if constexpr (LANE_LS)
        act = level_adjoint(T, is_last, alive, o, d, w, t_sel, bi, car, cag, cab, co, cd, cw,
                            c_o, c_d, c_w, ca, LaneLsSink<BLOCK>{s_ls});
      else
        act = level_adjoint(T, is_last, alive, o, d, w, t_sel, bi, car, cag, cab, co, cd, cw,
                            c_o, c_d, c_w, ca, WarpLsSink{s_ls});

      // ---- attribute cotangents: a tree sum per group of equal winners ----
      if (group_sums(act, bi, ca)) {
        if (bi < L.n_s) {
#pragma unroll
          for (int c = 0; c < 14; ++c) atomicAdd(&ga[14 * bi + c], (double)ca[c]);
        } else {
#pragma unroll
          for (int c = 0; c < 14; ++c) atomicAdd(&s_rows[14 * (bi - L.n_s) + c], ca[c]);
        }
      }
      if (alive) {
#pragma unroll
        for (int j = 0; j < 3; ++j) { co[j] = c_o[j]; cd[j] = c_d[j]; }
        cw = c_w;
      }
    }
    if (valid) {
      p.cox[r] = co[0]; p.coy[r] = co[1]; p.coz[r] = co[2];
      p.cdx[r] = cd[0]; p.cdy[r] = cd[1]; p.cdz[r] = cd[2];
      p.cw[r] = cw;
    }
  }

  __syncthreads();
  flush_ls<BLOCK>(s_ls, n_ls, LANE_LS, gl);
  for (int j = threadIdx.x; j < n_rows; j += BLOCK)
    if (s_rows[j] != 0.0f) atomicAdd(&ga[14 * L.n_s + j], (double)s_rows[j]);
}

}  // namespace

extern "C" {

// Launch on `stream` over the n lanes of one level, in as many blocks as fit
// on the card. The 7 `cn*` planes are all null after the last level (zero
// cotangents). The sums are added into `ga` [n_prim, 14] and `gl` [n_ls],
// float64. Returns the CUDA error of the launch (0 on success).
int trace_level_bwd_launch(
    const float* tab, int n_tab, int n_s, int unroll, int n_w, int n_b, int n_pt,
    int n_sun, int gate, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* w,
    const float* t, const int* i, const float* car, const float* cag,
    const float* cab, const float* cnox, const float* cnoy, const float* cnoz,
    const float* cndx, const float* cndy, const float* cndz, const float* cnw,
    float* cox, float* coy, float* coz, float* cdx, float* cdy, float* cdz,
    float* cw, double* ga, double* gl, long long n, int is_last, void* stream) {
  rt::Layout L = rt::make_layout(n_s, unroll, n_w, n_b, n_pt, n_sun, gate, 0);
  const bool some = cnox || cnoy || cnoz || cndx || cndy || cndz || cnw;
  const bool all = cnox && cnoy && cnoz && cndx && cndy && cndz && cnw;
  if (L.n_tab != n_tab || n <= 0 || some != all) return (int)cudaErrorInvalidValue;
  BwdPlanes p{ox, oy, oz, dx, dy, dz, w, t, i, car, cag, cab,
              cnox, cnoy, cnoz, cndx, cndy, cndz, cnw,
              cox, coy, coz, cdx, cdy, cdz, cw};
  const int n_ls = 6 * (n_pt + n_sun) + 10;
  const size_t smem =
      (size_t)(rt::fold_floats(L) + rt::ls_floats(n_ls, BLOCK) + 14 * (n_w + n_b)) * sizeof(float);
  const int groups = (int)((n + BLOCK - 1) / BLOCK < (1 << 30) ? (n + BLOCK - 1) / BLOCK
                                                               : (1 << 30));
  const bool lane_ls = n_ls <= rt::LANE_LS_MAX;
  auto kernel = lane_ls ? trace_level_bwd_kernel<true> : trace_level_bwd_kernel<false>;
  int n_blocks = 0;
  cudaError_t err = rt::persistent_grid(kernel, BLOCK, smem, groups, &n_blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_blocks, BLOCK, smem, (cudaStream_t)stream>>>(L, tab, p, ga, gl, n, is_last);
  return (int)cudaGetLastError();
}

const char* trace_level_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
