// One level of the soft (relaxed-visibility) renderer: the anchor depth, the
// composite of every primitive's coverage-weighted depth softmax, the blend
// over the sky, and the expected-surface reflection.
//
// Replaces the TPU kernel `_kernel_soft_level` of
// raytracer_tpu/ops/pallas_soft.py (built by `_soft_level`), which runs one
// level of a (32, 128) ray tile in VMEM: `fori_loop`s over 8-sphere chunks
// read from scalar-prefetch tables, each chunk `lax.cond`-skipped when no
// lane of the tile passes its gate, walls and boxes unrolled, and with
// `emit_res` writes the anchor depth and the composite carry for the
// backward.
//
// Design: one thread per ray, a grid-stride loop over the n rays in as many
// blocks of 256 threads as fit on the card at once, so each block copies the
// tables into shared memory once: the sphere table (12 floats a sphere
// padded to whole chunks of 8: 3 KB at 64 spheres, 48 KB at 1024, 96 KB at
// 2048; the launch opts in past 48 KB) with the walls, boxes, lights, sky,
// tau and tau_z, then the gates (12 floats a chunk). A thread runs two
// passes over the sphere chunks, each chunk behind the lane's own gate
// (soft_common.cuh's `chunk_reach`, where every member's coverage sigmoid is
// exactly 0 in float32 outside it, so a skipped chunk would have added
// exactly 0): the anchor depth t_ref (the least t of a primitive with
// coverage above 0.3), then the composite carry (the weight sum, 13 payload
// sums, 3 at the last level, and the log-transmittance), sphere by sphere
// in index order, then the walls, then the boxes; then the tail, and the
// outputs. Everything a lane computes stays in registers; tau and tau_z are
// read from the table at run time (a fit anneals tau).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): a level reads 10
// planes (rays, throughput, accumulator) and writes 10 (accumulator,
// throughput, next rays), plus 16 (6 at the last level) with EMIT: at
// 1920x1080 that is 20-36 planes, 166-299 MB, 50-89 us. The arithmetic is
// ~60 float32 operations per reached sphere in the t_ref pass and ~250 in
// the composite (coverage, hit, normal, Blinn-Phong with one point light
// and one sun, the contribution), ~60 per chunk gate, and ~150 per wall or
// box: at c4's grid-64 and 1080p, with a lane reaching a few chunks of 8,
// some 2-10 k operations a lane, 4-20 GFLOP, 0.06-0.3 ms. chip_smoke.py
// counts both on each run's data (`soft_level_ops`). So operations bound it;
// the design spends them only on the chunks a lane reaches.
//
// Build with -fmad=false and without fast math (ops/_build.py): the sums
// are then those of the plain PyTorch version, which adds the same terms in
// the same order.

#include "soft_common.cuh"

namespace {

using namespace rt::soft;
using rt::FULL;
using rt::persistent_grid;
using rt::srecip;
using rt::warp_add;
using rt::warp_sum;

constexpr int BLOCK = 256;

struct Planes {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *w, *ar, *ag, *ab;
  float* out;  // [n_out, n]: acc rgb, w_next, o_next xyz, d_next xyz, then t_ref, carry
};

template <bool LAST, bool EMIT>
__global__ void __launch_bounds__(BLOCK) soft_level_kernel(Layout L, const float* __restrict__ g_tab,
                                                           const float* __restrict__ g_gate,
                                                           Planes p, long long n) {
  constexpr int NC = NCarry<LAST>::value;
  extern __shared__ float sm[];
  const Tab T = tab_shared(L, g_tab, g_gate, sm);
  const float tau = T.tau(), tau_z = T.tau_z(), tau_eff = fmaxf(tau, 1e-6f);

  for (long long i = (long long)blockIdx.x * BLOCK + threadIdx.x; i < n;
       i += (long long)gridDim.x * BLOCK) {
    Ray r;
    r.o[0] = p.ox[i]; r.o[1] = p.oy[i]; r.o[2] = p.oz[i];
    r.d[0] = p.dx[i]; r.d[1] = p.dy[i]; r.d[2] = p.dz[i];
    const float w = p.w[i];
    const float oo = r.o[0] * r.o[0] + r.o[1] * r.o[1] + r.o[2] * r.o[2];
    const float dod = r.d[0] * r.o[0] + r.d[1] * r.o[1] + r.d[2] * r.o[2];
    const float iv[3] = {srecip(r.d[0]), srecip(r.d[1]), srecip(r.d[2])};

    // ---- pass 1: the anchor depth ----
    float t_ref = FAR;
    for (int c = 0; c < L.n_chunks; ++c) {
      if (!chunk_reach(T, c, r, oo, dod, iv, tau_eff)) continue;
      for (int s = c * CHUNK; s < (c + 1) * CHUNK; ++s) {
        const SphereHit h = sphere_hit(T, s, r, tau);
        t_ref = fminf(t_ref, h.alpha > ALPHA_REF ? h.t : FAR);
      }
    }
    for (int j = 0; j < L.n_w; ++j) {
      const WallHit h = wall_hit(T, j, r, tau);
      t_ref = fminf(t_ref, h.alpha > ALPHA_REF ? h.t : FAR);
    }
    for (int j = 0; j < L.n_b; ++j) {
      const BoxHit h = box_hit(T, j, r, tau);
      t_ref = fminf(t_ref, h.alpha > ALPHA_REF ? h.tn : FAR);
    }

    // ---- pass 2: the composite carry ----
    float carry[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) carry[k] = 0.0f;
    float col[3];
    for (int c = 0; c < L.n_chunks; ++c) {
      if (!chunk_reach(T, c, r, oo, dod, iv, tau_eff)) continue;
      for (int s = c * CHUNK; s < (c + 1) * CHUNK; ++s) {
        const SphereHit h = sphere_hit(T, s, r, tau);
        const Mat m = sphere_mat(T, s);
        shade(T, h.point, h.n, r.d, m, col);
        add_contrib<LAST>(carry, h.alpha, h.t, h.point, h.n, col, m.met, t_ref, tau_z);
      }
    }
    for (int j = 0; j < L.n_w; ++j) {
      const WallHit h = wall_hit(T, j, r, tau);
      const Mat m = wall_mat(T, j);
      shade(T, h.point, h.nrm, r.d, m, col);
      add_contrib<LAST>(carry, h.alpha, h.t, h.point, h.nrm, col, m.met, t_ref, tau_z);
    }
    for (int j = 0; j < L.n_b; ++j) {
      const BoxHit h = box_hit(T, j, r, tau);
      const Mat m = box_mat(T, j);
      shade(T, h.point, h.n, r.d, m, col);
      add_contrib<LAST>(carry, h.alpha, h.tn, h.point, h.n, col, m.met, t_ref, tau_z);
    }

    // ---- the tail and the outputs ----
    const Post q = post<LAST>(T, carry, r, w);
    float* out = p.out;
    out[0 * n + i] = p.ar[i] + w * q.loc[0];
    out[1 * n + i] = p.ag[i] + w * q.loc[1];
    out[2 * n + i] = p.ab[i] + w * q.loc[2];
    out[3 * n + i] = q.w_next;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      out[(4 + k) * n + i] = q.ro[k];
      out[(7 + k) * n + i] = q.rd[k];
    }
    if (EMIT) {
      out[10 * n + i] = t_ref;
#pragma unroll
      for (int k = 0; k < NC; ++k) out[(11 + k) * n + i] = carry[k];
    }
  }
}

template <bool LAST, bool EMIT>
int launch(const Layout& L, const float* tab, const float* gate, const Planes& p, long long n,
           cudaStream_t stream) {
  auto kernel = soft_level_kernel<LAST, EMIT>;
  const size_t smem = (size_t)(L.n_tab + N_GATE * L.n_chunks) * sizeof(float);
  const long long blocks = (n + BLOCK - 1) / BLOCK;
  int n_blocks = 0;
  cudaError_t err = persistent_grid(kernel, BLOCK, smem,
                                    blocks < (1 << 30) ? (int)blocks : (1 << 30), &n_blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_blocks, BLOCK, smem, stream>>>(L, tab, gate, p, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one soft level on `stream` over n lanes. `tab` is the packed table
// (ops/cuda_soft.py's _PACK order, n_tab floats), `gate` the [12, n_s_pad /
// 8] chunk gates; `gate_kind` 0 gates on chunk boxes, 1 on bounding
// spheres. `out` holds 10 planes, then with `emit_res` t_ref and the carry
// (15 planes, 5 at the last level). Returns the CUDA error of the launch (0
// on success).
int soft_level_launch(const float* tab, int n_tab, const float* gate, int n_s_pad, int n_w,
                      int n_b, int n_pt, int n_sun, int gate_kind, const float* ox,
                      const float* oy, const float* oz, const float* dx, const float* dy,
                      const float* dz, const float* w, const float* ar, const float* ag,
                      const float* ab, float* out, long long n, int is_last, int emit_res,
                      void* stream) {
  const rt::soft::Layout L = rt::soft::make_layout(n_s_pad, n_w, n_b, n_pt, n_sun, gate_kind);
  if (L.n_tab != n_tab || n <= 0 || n_s_pad % rt::soft::CHUNK || n_s_pad <= 0)
    return (int)cudaErrorInvalidValue;
  const Planes p{ox, oy, oz, dx, dy, dz, w, ar, ag, ab, out};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_last) return emit_res ? launch<true, true>(L, tab, gate, p, n, s)
                               : launch<true, false>(L, tab, gate, p, n, s);
  return emit_res ? launch<false, true>(L, tab, gate, p, n, s)
                  : launch<false, false>(L, tab, gate, p, n, s);
}

const char* soft_level_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
