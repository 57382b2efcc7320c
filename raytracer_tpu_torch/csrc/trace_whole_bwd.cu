// Whole-trace backward kernel: the reverse sweep over every bounce level of
// every ray in one launch.
//
// Replaces the TPU kernel `_kernel_trace_whole_bwd` of
// raytracer_tpu/ops/pallas_fold.py (built by `_trace_whole_bwd`), which runs
// `jax.vjp` of `_level_math` level by level from the forward's residuals,
// carries the ray and throughput cotangents from level k to level k-1 in
// VMEM, scatters the attribute cotangents into per-tile [rows, 16] blocks and
// reduces the light and sky cotangents per tile.
//
// Design: one thread per ray, a grid-stride loop over the rays in as many
// blocks as fit on the card at once (trace_common.cuh's `persistent_grid`).
// The table without its materials is copied into shared memory once a block
// (`tab_fold_shared`, as trace_level_bwd.cu); the winner's materials are
// read from device memory. For k = depth .. 0 a thread reads level k's
// residuals (input rays, throughput, t, index), regathers the winner by
// index and runs trace_common.cuh's `level_adjoint`, the adjoint of
// `_level_math` derived by hand that the per-level backward
// (trace_level_bwd.cu) shares: the cotangents of the level's increment (the
// image cotangent) and of its outputs (the rays and throughput that level
// k+1 read, carried in registers) give those of its inputs, of the 14
// gathered attributes and of the light and sky scalars. A lane whose
// throughput is 0 at a level is dead there: its cotangents pass through
// unchanged and it adds nothing; a warp whose lanes are all dead skips the
// level. The 7 cotangent planes are written once at the end.
//
// Sums over lanes, as trace_level_bwd.cu sums them: each lane keeps its
// light and sky cotangents in shared slots of its own over everything it
// runs (LaneLsSink: no shuffles, no atomics), and each block adds them once
// into a float64 row in device memory; past three lights (LANE_LS_MAX) the
// warps sum them per ray into a shared row (WarpLsSink). The 14 attribute
// cotangents: the lanes of a warp that hit the same primitive find each
// other with one `__match_any_sync` and sum their rows in a tree
// (`group_sums`), and each group's first lane adds the sums into float32
// rows in shared memory for the hot rows, which each block adds once into a
// float64 [n_prim, 14] table in device memory, and straight into that table
// with float64 atomics for the others. The hot rows are the walls and boxes,
// and the spheres too in scenes of at most SHARED_SPHERES_MAX of them:
// sprint3's one sphere wins most camera rays, where a grid-64 or grid-768
// sphere row is cold and its float64 atomics rarely meet. The float adds
// come in an order that varies between runs; their rounding (float32 over a
// block's lanes, ~1e-6 of the sums) stays within the tolerances the checks
// hold them to.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): at 1920x1080 and
// depth 3 the kernel reads at most 9 residual planes per level (input rays,
// throughput, t, index) and 3 cotangent planes, 39 planes, and writes 7: 46
// planes of 2,073,600 lanes of 4 bytes, 381 MB, 114 us, if every lane stayed
// alive. A lane dead at a level needs only its throughput there, so the
// sprint3 frame, where most lanes die at level 0, needs less: chip_smoke.py
// counts the bytes of each run's alive lanes. The arithmetic is about 550
// float32 operations per alive lane and level that hits a sphere of sprint3
// (the record replay and its adjoint ~113, the shading replay twice and its
// adjoint ~180 per point light and ~135 per sun, the bounce and accumulate
// adjoint ~88, the sums ~26) and ~60 for a miss (`trace_whole_bwd_ops` in
// chip_smoke.py counts them on each run's selections): 0.24 GFLOP for the
// sprint3 frame, 4 us, against 190 MB of its alive lanes' planes, 57 us.
// So the step is bound by its bytes. The design reads each residual plane
// once (an alive lane's planes only), keeps the cotangent chain in
// registers and writes each output plane once. The replay recomputes the
// record and the shading instead of saving them, which would cost more
// bytes than the arithmetic costs time.
//
// Build with -fmad=false and without fast math, as trace_whole.cu.

#include "trace_common.cuh"

namespace {

using namespace rt;

constexpr int BLOCK = 256;
// Blocks an SM that ptxas fits the registers to (by measurement, PERF.md).
constexpr int MIN_BLOCKS = 2;
// Scenes of at most this many spheres (one chunk) sum their sphere rows per
// block in shared memory, as walls and boxes; larger ones add them into the
// float64 table with atomics (by measurement on an NVIDIA H100 80GB HBM3 at
// 700 W, PERF.md: the shared rows 4% faster than atomics at one sphere, the
// atomics 2% faster at 64).
constexpr int SHARED_SPHERES_MAX = 16;

// The first primitive whose attribute row is summed in shared memory.
__host__ __device__ inline int shared_row0(const Layout& L) {
  return L.n_s <= SHARED_SPHERES_MAX ? 0 : L.n_s;
}

// The planes of one launch: level 0's input rays and throughput (each [n]),
// the residuals of levels 1..depth [depth][7][n], the selections t and
// index [depth + 1][n], the image cotangent [3][n] and the 7 cotangent
// planes written.
struct BwdPlanes {
  RayPlanes in;
  const float *res, *t;
  const int* i;
  const float *car, *cag, *cab;
  float *cox, *coy, *coz, *cdx, *cdy, *cdz, *cw;
};

template <bool LANE_LS>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS) trace_whole_bwd_kernel(
    Layout L, const float* __restrict__ g_tab, BwdPlanes p, double* __restrict__ ga,
    double* __restrict__ gl, long long n) {
  const int n_ls = 6 * (L.n_pt + L.n_sun) + 10;
  const int row0 = shared_row0(L);
  const int n_rows = 14 * (L.n_s + L.n_w + L.n_b - row0);  // the hot rows' sums
  extern __shared__ float sm[];
  float* s_ls = sm + fold_floats(L);  // ls_floats(n_ls, BLOCK)
  float* s_rows = s_ls + ls_floats(n_ls, BLOCK);
  for (int j = threadIdx.x; j < ls_floats(n_ls, BLOCK) + n_rows; j += BLOCK) s_ls[j] = 0.0f;
  const Tab T = tab_fold_shared(L, g_tab, sm);  // ends with __syncthreads

  for (long long base = (long long)blockIdx.x * BLOCK; base < n;
       base += (long long)gridDim.x * BLOCK) {
    const long long r = base + threadIdx.x;
    const bool valid = r < n;
    // Cotangents of the rays and throughput that level k+1 read.
    float co[3] = {0.0f, 0.0f, 0.0f}, cd[3] = {0.0f, 0.0f, 0.0f}, cw = 0.0f;
    float car = 0.0f, cag = 0.0f, cab = 0.0f;
    if (valid) { car = p.car[r]; cag = p.cag[r]; cab = p.cab[r]; }

    for (int k = L.depth; k >= 0; --k) {
      const long long plane = (long long)k * n + r;
      const float* lv = k ? p.res + (long long)(k - 1) * 7 * n + r : nullptr;
      float w = 0.0f;
      if (valid) w = k ? lv[6 * n] : p.in.w[r];
      const bool alive = w > 0.0f;
      if (!__any_sync(FULL, alive)) continue;

      float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 1.0f};
      float t_sel = 0.0f;
      int bi = -1;
      if (alive) {
        if (k) {
          o[0] = lv[0]; o[1] = lv[n]; o[2] = lv[2 * n];
          d[0] = lv[3 * n]; d[1] = lv[4 * n]; d[2] = lv[5 * n];
        } else {
          o[0] = p.in.ox[r]; o[1] = p.in.oy[r]; o[2] = p.in.oz[r];
          d[0] = p.in.dx[r]; d[1] = p.in.dy[r]; d[2] = p.in.dz[r];
        }
        t_sel = p.t[plane];
        bi = p.i[plane];
      }
      float c_o[3], c_d[3], c_w, ca[14];
      bool act;
      if constexpr (LANE_LS)
        act = level_adjoint(T, k == L.depth, alive, o, d, w, t_sel, bi, car, cag, cab, co, cd,
                            cw, c_o, c_d, c_w, ca, LaneLsSink<BLOCK>{s_ls});
      else
        act = level_adjoint(T, k == L.depth, alive, o, d, w, t_sel, bi, car, cag, cab, co, cd,
                            cw, c_o, c_d, c_w, ca, WarpLsSink{s_ls});

      // ---- attribute cotangents: a tree sum per group of equal winners ----
      if (group_sums(act, bi, ca)) {
        if (bi < row0) {
#pragma unroll
          for (int c = 0; c < 14; ++c) atomicAdd(&ga[14 * bi + c], (double)ca[c]);
        } else {
#pragma unroll
          for (int c = 0; c < 14; ++c) atomicAdd(&s_rows[14 * (bi - row0) + c], ca[c]);
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
    if (s_rows[j] != 0.0f) atomicAdd(&ga[14 * row0 + j], (double)s_rows[j]);
}

}  // namespace

extern "C" {

// Launch on `stream` over the n lanes, in as many blocks as fit on the card.
// Level k >= 1's input rays and throughput are `res[k - 1]` (7 planes),
// level 0's the separate planes; `t` and `i` hold every level's selections.
// The table cotangents are added into `ga` [n_prim, 14] and `gl` [n_ls],
// float64 (zeroed by the caller). Returns the CUDA error of the launch (0
// on success).
int trace_whole_bwd_launch(
    const float* tab, int n_tab, int n_s, int unroll, int n_w, int n_b, int n_pt, int n_sun,
    int gate, int depth, const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* w, const float* res, const float* t,
    const int* i, const float* car, const float* cag, const float* cab, float* cox,
    float* coy, float* coz, float* cdx, float* cdy, float* cdz, float* cw, double* ga,
    double* gl, long long n, void* stream) {
  rt::Layout L = rt::make_layout(n_s, unroll, n_w, n_b, n_pt, n_sun, gate, depth);
  if (L.n_tab != n_tab || n <= 0 || (depth > 0 && !res)) return (int)cudaErrorInvalidValue;
  BwdPlanes p{{ox, oy, oz, dx, dy, dz, w}, res, t, i, car, cag, cab,
              cox, coy, coz, cdx, cdy, cdz, cw};
  const int n_ls = 6 * (n_pt + n_sun) + 10;
  const int n_rows = 14 * (n_s + n_w + n_b - shared_row0(L));
  const size_t smem =
      (size_t)(rt::fold_floats(L) + rt::ls_floats(n_ls, BLOCK) + n_rows) * sizeof(float);
  const int groups = (int)((n + BLOCK - 1) / BLOCK < (1 << 30) ? (n + BLOCK - 1) / BLOCK
                                                               : (1 << 30));
  const bool lane_ls = n_ls <= rt::LANE_LS_MAX;
  auto kernel = lane_ls ? trace_whole_bwd_kernel<true> : trace_whole_bwd_kernel<false>;
  int n_blocks = 0;
  cudaError_t err = rt::persistent_grid(kernel, BLOCK, smem, groups, &n_blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_blocks, BLOCK, smem, (cudaStream_t)stream>>>(L, tab, p, ga, gl, n);
  return (int)cudaGetLastError();
}

const char* trace_whole_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
