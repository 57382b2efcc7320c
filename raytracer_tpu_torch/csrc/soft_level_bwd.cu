// The backward of one soft level.
//
// Replaces the TPU kernel `_kernel_soft_level_bwd` of
// raytracer_tpu/ops/pallas_soft.py (built by `_soft_level_bwd`), which reads
// a (32, 128) tile's saved rays, throughput, anchor depth and composite
// carry, `jax.vjp`s the composite's tail for the carry's cotangent, then
// `jax.vjp`s each primitive's contribution on its own (walls and boxes
// unrolled, sphere chunks in a gated `fori_loop`), and reduces the shared
// table's cotangents to a per-tile block and the spheres' into (8, 128)
// lane-slot planes, under a 64 MB VMEM limit.
//
// Design: one thread per ray, a grid-stride loop over the n rays in as many
// blocks of 256 threads as fit on the card at once. Each block copies the
// table and the gates into shared memory, as soft_level.cu does. A thread
// reads its level's input ray and throughput, t_ref and the carry (the
// forward's residual planes: no sphere pass is run again for them), the
// image cotangent and those of the level's outputs, and runs the adjoint
// derived by hand in soft_common.cuh: `post_bwd` (the tail) gives the
// carry's cotangent, which is every contribution's, since the carry is
// their sum; then for every wall, box and reached sphere the contribution is
// computed again and differentiated (`wall_bwd`, `box_bwd`, `sphere_bwd`),
// so only one primitive's intermediates are live. A chunk its gate rejects
// has coverage exactly 0 on that lane, and every cotangent through it is
// exactly 0, so it is skipped. The ray cotangents sum in registers.
//
// Sums over lanes: a lane's light, tau and tau_z cotangents accumulate in
// its own column of shared memory (6 per light and 2 floats, conflict-free
// at a stride of 256), summed over the block at its end. A wall's or box's
// cotangents and the sky's are summed over the warp with shuffles and added
// into a shared row with shared-memory atomics; each block adds its row
// once into a float64 table in device memory with atomicAdd. A sphere's 12
// cotangents are summed over the warp (one fixed butterfly) and lane 0 adds
// them into the float64 table with atomicAdd: at c4 (64 spheres, 1080p),
// 768 addresses. The order of the float64 adds varies between runs; their
// rounding (1e-16 of the sums) does not reach the float32 that the wrapper
// returns, and the float32 shared-row sums of the walls, boxes, lights and
// sky vary in their last bits. The plain version sums in float64.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): a level reads 7
// planes (rays, throughput), t_ref and 15 carry planes (5 at the last
// level), 3 image cotangents and 7 of its outputs, and writes 7: at
// 1920x1080, 39 planes, 324 MB, 97 us. Its arithmetic is the forward's
// composite again plus the adjoint, some 3x: ~800-1000 float32 operations
// per reached sphere and ~600 per wall or box, so 10-40 k operations a lane
// at c4, 20-80 GFLOP, 0.3-1.2 ms (chip_smoke.py's `soft_level_bwd_ops`
// counts them). So operations bound it, spent only on reached chunks.
//
// Build with -fmad=false and without fast math (ops/_build.py).

#include "soft_common.cuh"

namespace {

using namespace rt::soft;
using rt::FULL;
using rt::persistent_grid;
using rt::srecip;
using rt::warp_add;
using rt::warp_sum;

constexpr int BLOCK = 256;

struct BwdPlanes {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *w, *res;  // res: [1 + NC, n]
  const float *car, *cag, *cab;
  const float *cnox, *cnoy, *cnoz, *cndx, *cndy, *cndz, *cnw;  // all null after the last level
  float* cts;  // [7, n]: ct o xyz, ct d xyz, ct w
};

// Index in the shared row (the table past the spheres) of a lane's
// accumulator j (LtRow order).
__device__ __forceinline__ int lt_slot(const Layout& L, int j) {
  const int np = 6 * L.n_pt, ns = 6 * L.n_sun;
  if (j < np) return L.pt - L.wall + (j % 6) * L.np1 + j / 6;
  if (j < np + ns) return L.sun - L.wall + ((j - np) % 6) * L.nu1 + (j - np) / 6;
  return (j == np + ns ? L.tau : L.tau_z) - L.wall;
}

template <bool LAST>
__global__ void __launch_bounds__(BLOCK) soft_level_bwd_kernel(
    Layout L, const float* __restrict__ g_tab, const float* __restrict__ g_gate, BwdPlanes p,
    double* __restrict__ sums, long long n) {
  constexpr int NC = NCarry<LAST>::value;
  extern __shared__ float sm[];
  const int n_small = L.n_tab - L.wall;
  const int n_lt = lt_tau(L) + 2;
  float* s_ct = sm + L.n_tab + N_GATE * L.n_chunks;
  float* s_lt = s_ct + n_small;
  for (int j = threadIdx.x; j < n_small; j += BLOCK) s_ct[j] = 0.0f;
  for (int j = 0; j < n_lt; ++j) s_lt[j * BLOCK + threadIdx.x] = 0.0f;
  const Tab T = tab_shared(L, g_tab, g_gate, sm);  // ends with __syncthreads
  const LtRow lt{s_lt + threadIdx.x, BLOCK};
  const float tau_eff = fmaxf(T.tau(), 1e-6f);
  const bool has_next = p.cnox != nullptr;
  const int lane = threadIdx.x & 31;

  for (long long base = (long long)blockIdx.x * BLOCK; base < n;
       base += (long long)gridDim.x * BLOCK) {
    const long long i = base + threadIdx.x;
    const bool valid = i < n;
    Ray r = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 1.0f}};
    float w = 0.0f, t_ref = FAR, carry[NC], g[NC];
    float co[3] = {0.0f, 0.0f, 0.0f}, cd[3] = {0.0f, 0.0f, 0.0f}, cw = 0.0f, csky[10];
#pragma unroll
    for (int k = 0; k < NC; ++k) carry[k] = g[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 10; ++k) csky[k] = 0.0f;
    if (valid) {
      r.o[0] = p.ox[i]; r.o[1] = p.oy[i]; r.o[2] = p.oz[i];
      r.d[0] = p.dx[i]; r.d[1] = p.dy[i]; r.d[2] = p.dz[i];
      w = p.w[i];
      t_ref = p.res[i];
#pragma unroll
      for (int k = 0; k < NC; ++k) carry[k] = p.res[(1 + k) * n + i];
      const float ca[3] = {p.car[i], p.cag[i], p.cab[i]};
      float cno[3] = {0.0f, 0.0f, 0.0f}, cnd[3] = {0.0f, 0.0f, 0.0f}, cwn = 0.0f;
      if (has_next) {
        cno[0] = p.cnox[i]; cno[1] = p.cnoy[i]; cno[2] = p.cnoz[i];
        cnd[0] = p.cndx[i]; cnd[1] = p.cndy[i]; cnd[2] = p.cndz[i];
        cwn = p.cnw[i];
      }
      post_bwd<LAST>(T, carry, r, w, ca, cwn, cno, cnd, g, co, cd, cw, csky, lt);
    }
#pragma unroll
    for (int k = 0; k < 10; ++k) warp_add(&s_ct[L.sky - L.wall + k], csky[k]);

    // ---- walls and boxes: warp sums into the shared row ----
    for (int j = 0; j < L.n_w; ++j) {
      float c[N_WALL];
#pragma unroll
      for (int k = 0; k < N_WALL; ++k) c[k] = 0.0f;
      if (valid) wall_bwd<LAST>(T, j, r, t_ref, g, co, cd, c, lt);
#pragma unroll
      for (int k = 0; k < N_WALL; ++k) warp_add(&s_ct[k * L.nw1 + j], c[k]);
    }
    for (int j = 0; j < L.n_b; ++j) {
      float c[N_BOX];
#pragma unroll
      for (int k = 0; k < N_BOX; ++k) c[k] = 0.0f;
      if (valid) box_bwd<LAST>(T, j, r, t_ref, g, co, cd, c, lt);
#pragma unroll
      for (int k = 0; k < N_BOX; ++k) warp_add(&s_ct[L.box - L.wall + k * L.nb1 + j], c[k]);
    }

    // ---- sphere chunks behind the lane's gate: warp sums into float64 ----
    const float oo = r.o[0] * r.o[0] + r.o[1] * r.o[1] + r.o[2] * r.o[2];
    const float dod = r.d[0] * r.o[0] + r.d[1] * r.o[1] + r.d[2] * r.o[2];
    const float iv[3] = {srecip(r.d[0]), srecip(r.d[1]), srecip(r.d[2])};
    for (int c = 0; c < L.n_chunks; ++c) {
      const bool reach = valid && chunk_reach(T, c, r, oo, dod, iv, tau_eff);
      if (!__any_sync(FULL, reach)) continue;
      for (int s = c * CHUNK; s < (c + 1) * CHUNK; ++s) {
        float cs[N_SPH];
#pragma unroll
        for (int k = 0; k < N_SPH; ++k) cs[k] = 0.0f;
        if (reach) sphere_bwd<LAST>(T, s, r, t_ref, g, co, cd, cs, lt);
#pragma unroll
        for (int k = 0; k < N_SPH; ++k) {
          const float v = warp_sum(cs[k]);
          if (lane == 0 && v != 0.0f) atomicAdd(&sums[k * L.n_s_pad + s], (double)v);
        }
      }
    }
    if (valid) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        p.cts[k * n + i] = co[k];
        p.cts[(3 + k) * n + i] = cd[k];
      }
      p.cts[6 * n + i] = cw;
    }
  }

  // ---- the block's sums into the float64 table ----
  for (int j = 0; j < n_lt; ++j) warp_add(&s_ct[lt_slot(L, j)], s_lt[j * BLOCK + threadIdx.x]);
  __syncthreads();
  for (int j = threadIdx.x; j < n_small; j += BLOCK)
    if (s_ct[j] != 0.0f) atomicAdd(&sums[L.wall + j], (double)s_ct[j]);
}

template <bool LAST>
int launch(const Layout& L, const float* tab, const float* gate, const BwdPlanes& p,
           double* sums, long long n, cudaStream_t stream) {
  auto kernel = soft_level_bwd_kernel<LAST>;
  const int n_lt = lt_tau(L) + 2;
  const size_t smem =
      (size_t)(L.n_tab + N_GATE * L.n_chunks + (L.n_tab - L.wall) + n_lt * BLOCK) * sizeof(float);
  const long long blocks = (n + BLOCK - 1) / BLOCK;
  int n_blocks = 0;
  cudaError_t err = persistent_grid(kernel, BLOCK, smem,
                                    blocks < (1 << 30) ? (int)blocks : (1 << 30), &n_blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_blocks, BLOCK, smem, stream>>>(L, tab, gate, p, sums, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the backward of one soft level on `stream` over n lanes: the table,
// gates and counts as soft_level_launch takes them; the level's input rays
// and throughput; `res` its [1 + n_carry, n] residual (t_ref, the carry);
// the image cotangent (car, cag, cab) and those of the level's outputs (the
// next ray xyz xyz and throughput; all null after the last level). Writes
// `cts` [7, n] (o xyz, d xyz, w) and adds the table's cotangent into `sums`
// (float64, n_tab). Returns the CUDA error of the launch (0 on success).
int soft_level_bwd_launch(const float* tab, int n_tab, const float* gate, int n_s_pad, int n_w,
                          int n_b, int n_pt, int n_sun, int gate_kind, const float* ox,
                          const float* oy, const float* oz, const float* dx, const float* dy,
                          const float* dz, const float* w, const float* res, const float* car,
                          const float* cag, const float* cab, const float* cnox,
                          const float* cnoy, const float* cnoz, const float* cndx,
                          const float* cndy, const float* cndz, const float* cnw, float* cts,
                          double* sums, long long n, int is_last, void* stream) {
  const rt::soft::Layout L = rt::soft::make_layout(n_s_pad, n_w, n_b, n_pt, n_sun, gate_kind);
  const bool some = cnox || cnoy || cnoz || cndx || cndy || cndz || cnw;
  const bool all = cnox && cnoy && cnoz && cndx && cndy && cndz && cnw;
  if (L.n_tab != n_tab || n <= 0 || n_s_pad % rt::soft::CHUNK || n_s_pad <= 0 || some != all)
    return (int)cudaErrorInvalidValue;
  const BwdPlanes p{ox, oy, oz, dx, dy, dz, w, res, car, cag, cab,
                    cnox, cnoy, cnoz, cndx, cndy, cndz, cnw, cts};
  cudaStream_t s = (cudaStream_t)stream;
  return is_last ? launch<true>(L, tab, gate, p, sums, n, s)
                 : launch<false>(L, tab, gate, p, sums, n, s);
}

const char* soft_level_bwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
