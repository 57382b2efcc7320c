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
// Design: one thread per ray, a grid-stride loop over the rays in a grid of
// at most 8 blocks per SM (the wrapper sizes it). The packed scene table of
// trace_whole.cu is copied into shared memory at block start. For k = depth
// .. 0 a thread reads level k's residuals (input rays, throughput, t, index),
// regathers the winner by index, recomputes its record (t, hit point,
// normal) and its shading, and runs their adjoint, derived by hand from
// `_level_math` in ops/cuda_fold.py (CUDA has no autodiff): the cotangents
// of the level's increment (the image cotangent) and of its outputs (the
// rays and throughput that level k+1 read, carried in registers) give those
// of its inputs, of the 14 gathered attributes and of the light and sky
// scalars. A lane whose throughput is 0 at a level is dead there: it skips
// the level, so its cotangents pass through unchanged and it adds nothing
// (the forward's per-lane skip). A warp whose lanes are all dead skips the
// level. The 7 cotangent planes are written once at the end.
//
// The adjoint is trace_common.cuh's `level_adjoint`, which the per-level
// backward (trace_level_bwd.cu) shares; its derivative rules are stated
// there.
//
// Parameter cotangents: per level, a warp sums the 14 attribute cotangents
// of the lanes that hit the same primitive with shuffles (one group per
// distinct index, in a fixed order), and its lane 0 adds the sums into the
// block's shared [n_prim, 14] accumulator with atomicAdd; the light and sky
// cotangents are summed per warp the same way into a shared [n_ls] row. So
// the order of the adds inside a block, one per warp, varies from run to
// run: the table cotangents may differ in their last bits between runs (a
// relative 1e-7 of the sums, far inside the 1e-3 tolerance of the checks).
// Each block writes its partial sums once, to [n_blocks, n_prim, 14] and
// [n_blocks, n_ls]; the wrapper sums them over blocks (torch.sum, a fixed
// order), as the JAX wrapper sums its per-tile blocks.
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
// registers and writes each output plane once; the partial sums are a few
// MB at most. The replay recomputes the record and the shading instead of
// saving them, which would cost more bytes than the arithmetic costs time.
// The warp sums cost ~5 shuffles per summed value and warp; the lanes of a
// warp that hit different kinds of primitive run their record adjoints one
// after the other.
//
// Build with -fmad=false and without fast math, as trace_whole.cu.

#include "trace_common.cuh"

namespace {

using namespace rt;

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK) trace_whole_bwd_kernel(
    Layout L, const float* __restrict__ g_tab,
    const float* __restrict__ ox0, const float* __restrict__ oy0,
    const float* __restrict__ oz0, const float* __restrict__ dx0,
    const float* __restrict__ dy0, const float* __restrict__ dz0,
    const float* __restrict__ w0, const float* __restrict__ res_p,
    const float* __restrict__ t_p, const int* __restrict__ i_p,
    const float* __restrict__ car_p, const float* __restrict__ cag_p,
    const float* __restrict__ cab_p, float* __restrict__ cox_p,
    float* __restrict__ coy_p, float* __restrict__ coz_p,
    float* __restrict__ cdx_p, float* __restrict__ cdy_p,
    float* __restrict__ cdz_p, float* __restrict__ cw_p,
    float* __restrict__ pg_p, float* __restrict__ pl_p, long long n) {
  const int n_prim = L.n_s + L.n_w + L.n_b;
  const int n_ls = 6 * (L.n_pt + L.n_sun) + 10;
  extern __shared__ float smem[];
  float* tab = smem;
  float* s_pg = smem + L.n_tab;        // [n_prim][14] attribute cotangents
  float* s_ls = s_pg + 14 * n_prim;    // [n_ls] light and sky cotangents
  for (int j = threadIdx.x; j < L.n_tab; j += BLOCK) tab[j] = g_tab[j];
  for (int j = threadIdx.x; j < 14 * n_prim + n_ls; j += BLOCK) s_pg[j] = 0.0f;
  __syncthreads();
  const Tab T = tab_whole(L, tab);

  for (long long base = (long long)blockIdx.x * BLOCK; base < n;
       base += (long long)gridDim.x * BLOCK) {
    const long long r = base + threadIdx.x;
    const bool valid = r < n;
    // Cotangents of the rays and throughput that level k+1 read.
    float co[3] = {0.0f, 0.0f, 0.0f}, cd[3] = {0.0f, 0.0f, 0.0f}, cw = 0.0f;
    float car = 0.0f, cag = 0.0f, cab = 0.0f;
    if (valid) { car = car_p[r]; cag = cag_p[r]; cab = cab_p[r]; }

    for (int k = L.depth; k >= 0; --k) {
      const long long plane = (long long)k * n + r;
      const float* lv = k ? res_p + (long long)(k - 1) * 7 * n + r : nullptr;
      float w = 0.0f;
      if (valid) w = k ? lv[6 * n] : w0[r];
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
          o[0] = ox0[r]; o[1] = oy0[r]; o[2] = oz0[r];
          d[0] = dx0[r]; d[1] = dy0[r]; d[2] = dz0[r];
        }
        t_sel = t_p[plane];
        bi = i_p[plane];
      }
      float c_o[3], c_d[3], c_w, ca[14];
      const bool act = level_adjoint(T, k == L.depth, alive, o, d, w, t_sel, bi, car, cag,
                                     cab, co, cd, cw, c_o, c_d, c_w, ca, s_ls);

      // ---- attribute cotangents: one warp sum per distinct winner ----
      unsigned pending = __ballot_sync(FULL, act);
      while (pending) {
        const int key = __shfl_sync(FULL, bi, __ffs(pending) - 1);
        const bool mine = act && bi == key;
        pending &= ~__ballot_sync(FULL, mine);
#pragma unroll
        for (int c = 0; c < 14; ++c) warp_add(&s_pg[14 * key + c], mine ? ca[c] : 0.0f);
      }

      if (alive) {
#pragma unroll
        for (int j = 0; j < 3; ++j) { co[j] = c_o[j]; cd[j] = c_d[j]; }
        cw = c_w;
      }
    }

    if (valid) {
      cox_p[r] = co[0]; coy_p[r] = co[1]; coz_p[r] = co[2];
      cdx_p[r] = cd[0]; cdy_p[r] = cd[1]; cdz_p[r] = cd[2];
      cw_p[r] = cw;
    }
  }

  __syncthreads();
  float* pg = pg_p + (long long)blockIdx.x * 14 * n_prim;
  for (int j = threadIdx.x; j < 14 * n_prim; j += BLOCK) pg[j] = s_pg[j];
  float* pl = pl_p + (long long)blockIdx.x * n_ls;
  for (int j = threadIdx.x; j < n_ls; j += BLOCK) pl[j] = s_ls[j];
}

}  // namespace

extern "C" {

// Launch `n_blocks` blocks on `stream`. Level k >= 1's input rays and
// throughput are `res[k - 1]` (7 planes), level 0's the separate planes;
// `t` and `i` hold every level's selections. `pg` receives [n_blocks,
// n_prim, 14] and `pl` [n_blocks, n_ls] partial sums. Returns the CUDA error
// of the launch (0 on success).
int trace_whole_bwd_launch(
    const float* tab, int n_tab, int n_s, int unroll, int n_w, int n_b,
    int n_pt, int n_sun, int gate, int depth, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* w, const float* res, const float* t,
    const int* i, const float* car, const float* cag, const float* cab,
    float* cox, float* coy, float* coz, float* cdx, float* cdy, float* cdz,
    float* cw, float* pg, float* pl, long long n, int n_blocks,
    void* stream) {
  rt::Layout L = rt::make_layout(n_s, unroll, n_w, n_b, n_pt, n_sun, gate, depth);
  if (L.n_tab != n_tab || n <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  const int n_prim = n_s + n_w + n_b, n_ls = 6 * (n_pt + n_sun) + 10;
  const size_t smem = (size_t)(n_tab + 14 * n_prim + n_ls) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        trace_whole_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  trace_whole_bwd_kernel<<<n_blocks, BLOCK, smem, (cudaStream_t)stream>>>(
      L, tab, ox, oy, oz, dx, dy, dz, w, res, t, i, car, cag, cab, cox, coy,
      coz, cdx, cdy, cdz, cw, pg, pl, n);
  return (int)cudaGetLastError();
}

const char* trace_whole_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
