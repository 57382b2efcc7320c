// The backward of one bounce level of the per-level chain.
//
// Replaces the TPU kernel `_kernel_trace_level_bwd` of
// raytracer_tpu/ops/pallas_fold.py (built by `_trace_level_bwd`), which
// regathers a (32, 128) tile's winners, runs `jax.vjp` of `_level_math` in
// VMEM, and scatters the attribute cotangents into a per-tile [rows, 16]
// block by walking the tile's winner chunks (the TPU's way around one-hot
// matmuls), with the light and sky cotangents reduced per tile.
//
// Design: one thread per ray, a grid-stride loop over the rays in a grid of
// at most 8 blocks per SM (the wrapper sizes it). The table without its
// materials is copied into shared memory, as trace_level.cu does; the
// winner's materials are read from device memory. A thread reads level k's
// saved input rays, throughput, t and index, the image cotangent and the
// cotangents of the level's outputs (those of level k+1's inputs, which the
// launch for level k+1 wrote; none after the last level), regathers the
// winner by index and runs trace_common.cuh's `level_adjoint`, the adjoint
// of `_level_math` derived by hand that trace_whole_bwd.cu runs for every
// level in one launch. It writes the 7 cotangent planes of the level's
// inputs; a lane whose throughput is 0 is dead at this level and passes the
// cotangents of its outputs through.
//
// Sums over lanes: the light and sky cotangents are summed per warp with
// shuffles into a shared row per block, which each block adds once into a
// float64 row in device memory. The 14 attribute cotangents of a warp's
// lanes that hit the same primitive are summed with shuffles (one group per
// distinct winner, in a fixed order), and lane 0 adds the sums into a
// float64 [n_prim, 14] table in device memory with atomicAdd: no per-block
// [n_prim, 14] partials, which at 1024 spheres would be 1,056 blocks x 57 KB
// per level. The float64 adds come in an order that varies between runs,
// but their rounding (1e-16 of the sums) stays far below the float32 the
// wrapper returns. The chain's levels add into the same two tables.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): a level reads, for
// every lane, the throughput, the 3 image cotangents and the 7 cotangents
// of its outputs, and for its alive lanes the 6 ray planes, t and index;
// it writes 7 planes and the float64 sums (its winners' rows, at most
// n_prim x 14 x 8 bytes). At 1920x1080 that is at most 25 planes, 207 MB,
// 62 us, if every lane were alive. The arithmetic is ~550 float32
// operations per alive lane that hits a sphere (as trace_whole_bwd.cu's
// level) and ~60 per miss; chip_smoke.py counts bytes and operations on each
// run's data. So bytes bound it.
//
// Build with -fmad=false and without fast math (ops/_build.py).

#include "trace_common.cuh"

namespace {

using namespace rt;

constexpr int BLOCK = 256;

// The planes of one level's backward, each [n]; the `cn` (cotangents of the
// level's outputs) are all null after the last level.
struct BwdPlanes {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *w, *t;
  const int* i;
  const float *car, *cag, *cab;
  const float *cnox, *cnoy, *cnoz, *cndx, *cndy, *cndz, *cnw;
  float *cox, *coy, *coz, *cdx, *cdy, *cdz, *cw;
};

__global__ void __launch_bounds__(BLOCK) trace_level_bwd_kernel(
    Layout L, const float* __restrict__ g_tab, BwdPlanes p, double* __restrict__ ga,
    double* __restrict__ gl, long long n, int is_last) {
  const int n_ls = 6 * (L.n_pt + L.n_sun) + 10;
  extern __shared__ float sm[];
  float* s_ls = sm + fold_floats(L);
  for (int j = threadIdx.x; j < n_ls; j += BLOCK) s_ls[j] = 0.0f;
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
      const bool act = level_adjoint(T, is_last, alive, o, d, w, t_sel, bi, car, cag, cab,
                                     co, cd, cw, c_o, c_d, c_w, ca, s_ls);

      // ---- attribute cotangents: one warp sum per distinct winner ----
      unsigned pending = __ballot_sync(FULL, act);
      while (pending) {
        const int key = __shfl_sync(FULL, bi, __ffs(pending) - 1);
        const bool mine = act && bi == key;
        pending &= ~__ballot_sync(FULL, mine);
#pragma unroll
        for (int c = 0; c < 14; ++c) {
          const float v = warp_sum(mine ? ca[c] : 0.0f);
          if ((threadIdx.x & 31) == 0) atomicAdd(&ga[14 * key + c], (double)v);
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
  for (int j = threadIdx.x; j < n_ls; j += BLOCK) atomicAdd(&gl[j], (double)s_ls[j]);
}

}  // namespace

extern "C" {

// Launch `n_blocks` blocks on `stream` over the n lanes of one level. The 7
// `cn*` planes are all null after the last level (zero cotangents). The
// sums are added into `ga` [n_prim, 14] and `gl` [n_ls], float64. Returns
// the CUDA error of the launch (0 on success).
int trace_level_bwd_launch(
    const float* tab, int n_tab, int n_s, int unroll, int n_w, int n_b, int n_pt,
    int n_sun, int gate, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* w,
    const float* t, const int* i, const float* car, const float* cag,
    const float* cab, const float* cnox, const float* cnoy, const float* cnoz,
    const float* cndx, const float* cndy, const float* cndz, const float* cnw,
    float* cox, float* coy, float* coz, float* cdx, float* cdy, float* cdz,
    float* cw, double* ga, double* gl, long long n, int n_blocks, int is_last,
    void* stream) {
  rt::Layout L = rt::make_layout(n_s, unroll, n_w, n_b, n_pt, n_sun, gate, 0);
  const bool some = cnox || cnoy || cnoz || cndx || cndy || cndz || cnw;
  const bool all = cnox && cnoy && cnoz && cndx && cndy && cndz && cnw;
  if (L.n_tab != n_tab || n <= 0 || n_blocks <= 0 || some != all)
    return (int)cudaErrorInvalidValue;
  BwdPlanes p{ox, oy, oz, dx, dy, dz, w, t, i, car, cag, cab,
              cnox, cnoy, cnoz, cndx, cndy, cndz, cnw,
              cox, coy, coz, cdx, cdy, cdz, cw};
  const int n_ls = 6 * (n_pt + n_sun) + 10;
  const size_t smem = (size_t)(rt::fold_floats(L) + n_ls) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        trace_level_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  trace_level_bwd_kernel<<<n_blocks, BLOCK, smem, (cudaStream_t)stream>>>(
      L, tab, p, ga, gl, n, is_last);
  return (int)cudaGetLastError();
}

const char* trace_level_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
