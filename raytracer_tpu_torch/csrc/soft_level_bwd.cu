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
// Design: one thread per ray, blocks of 256 rays walked with a grid stride
// by as many blocks as fit on the card at once, a lane taking the ray of
// the forward's `order` plane where it has one. The small table stays in
// shared memory and the sphere columns and gates stream through the ring of
// soft_level.cu (tiles of TILE_C chunks, cp.async; culled per warp, then
// each lane's exact gate into a mask and the warp walking the OR of its
// lanes' masks). A thread reads its level's input ray and throughput,
// t_ref and the carry (the forward's residual planes: no sphere pass is run
// again for them), the image cotangent and those of the level's outputs,
// and runs the adjoint derived by hand in soft_common.cuh: `post_bwd` (the
// tail) gives the carry's cotangent, which is every contribution's, since
// the carry is their sum; then for every wall, box and reached sphere the
// contribution is computed again and differentiated (`wall_bwd`, `box_bwd`,
// `sphere_bwd`), so only one primitive's intermediates are live. A chunk
// its gate rejects has coverage exactly 0 on that lane, and every cotangent
// through it is exactly 0, so it is skipped. So are padding spheres (a
// deliberate difference from the JAX package: ops/cuda_soft.py). The
// ray cotangents sum in registers.
//
// Sums over lanes: a lane's light, tau and tau_z cotangents accumulate in
// its own column of shared memory (6 per light and 2 floats, conflict-free
// at a stride of 256), summed over the block at its end. A wall's or box's
// cotangents and the sky's are summed over the warp with shuffles and added
// into a shared row with shared-memory atomics; each block adds its row
// once into a float64 table in device memory with atomicAdd. A sphere's 12
// cotangents are reduce-scattered over the warp (`warp_scatter12`, 16
// shuffles) and added by 12 lanes into accumulators in shared memory (12
// floats a sphere of the tile), and after each tile the block adds the
// nonzero ones into the float64 table with atomicAdd. (Keeping the sums of
// a resident ring over all of a block's rays, without the barriers, was
// slower: PERF.md.) The order of the float32 and float64 adds varies
// between runs; their rounding stays far below the tolerance the checks
// state (PERF.md). The plain version sums in float64.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): a level reads 7
// planes (rays, throughput), t_ref and 15 carry planes (5 at the last
// level), 3 image cotangents and 7 of its outputs, and writes 7: at
// 1920x1080, 39 planes, 324 MB, 97 us. Its arithmetic is the forward's
// composite again plus the adjoint, some 3x: ~800-1000 float32 operations
// per reached sphere and ~600 per wall or box (chip_smoke.py's
// `soft_level_bwd_ops` counts them). So operations bound it, spent only on
// the chunks a warp's lanes reach.
//
// Build with -fmad=false and without fast math (ops/_build.py).

#include <cstdint>

#include "soft_common.cuh"

namespace {

using namespace rt::soft;
using rt::FULL;
using rt::persistent_grid;
using rt::srecip;
using rt::warp_add;

// Blocks an SM keeps: ptxas fits the registers to it (128; the non-last
// instantiation spills 12 bytes). 3 blocks of 80 registers spill ~400 bytes
// and were slower (PERF.md, tools/soft_variants.py).
constexpr int MIN_BLOCKS = 2;
// Chunks of a tile of the sphere ring: measured against 32 and 128 on the
// H100 (PERF.md, tools/soft_variants.py); ops/cuda_soft.py's
// _TILE_CHUNKS_BWD mirrors it.
constexpr int TILE_C = 64;
static_assert(TILE_C % 32 == 0 && TILE_C <= BLOCK, "a tile is whole mask words");

struct BwdPlanes {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *w, *res;  // res: [1 + NC, n]
  const float *car, *cag, *cab;
  const float *cnox, *cnoy, *cnoz, *cndx, *cndy, *cndz, *cnw;  // all null after the last level
  float* cts;  // [7, n]: ct o xyz, ct d xyz, ct w
};

// Shared memory in floats: the ring, the tile's sphere cotangent sums, the
// small table, its cotangent row, each lane's light accumulators (n_lt x
// BLOCK) and each warp's ray bounds.
int smem_floats(int n_small, int n_lt) {
  return 2 * tile_floats(TILE_C) + N_SPH * CHUNK * TILE_C + 2 * round4(n_small) +
         n_lt * BLOCK + (BLOCK / 32) * N_BND;
}

// Adds the nonzero sums of `acc` (12 floats a sphere of tile t) into the
// float64 table and zeroes them. Every thread calls it.
__device__ __forceinline__ void flush_acc(const Layout& L, int t, float* acc, double* sums) {
  constexpr int ts = TILE_C * CHUNK;
  const int s0 = t * ts;
  for (int j = threadIdx.x; j < N_SPH * ts; j += BLOCK) {
    const float v = acc[j];
    if (v != 0.0f) {
      const int col = j / ts;
      atomicAdd(&sums[(size_t)col * L.n_s_pad + s0 + (j - col * ts)], (double)v);
      acc[j] = 0.0f;
    }
  }
}

// Index in the small table of a lane's accumulator j (LtRow order).
__device__ __forceinline__ int lt_slot(const Layout& L, int j) {
  const int np = 6 * L.n_pt, ns = 6 * L.n_sun;
  if (j < np) return L.pt - L.wall + (j % 6) * L.np1 + j / 6;
  if (j < np + ns) return L.sun - L.wall + ((j - np) % 6) * L.nu1 + (j - np) / 6;
  return (j == np + ns ? L.tau : L.tau_z) - L.wall;
}

template <bool LAST>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
    soft_level_bwd_kernel(Layout L, const float* __restrict__ g_tab,
                          const float* __restrict__ g_gate, BwdPlanes p,
                          const int* __restrict__ order, double* __restrict__ sums, long long n) {
  constexpr int NC = NCarry<LAST>::value;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  constexpr int words = TILE_C / 32, ts = TILE_C * CHUNK;
  const int n_tiles = (L.n_chunks + TILE_C - 1) / TILE_C, n_lt = lt_tau(L) + 2;
  Ring ring{g_tab, g_gate, sm, n_tiles, TILE_C, 0, false};
  float* s_acc = sm + 2 * tile_floats(TILE_C);
  float* s_small = s_acc + N_SPH * ts;
  float* s_ct = s_small + round4(L.n_small);
  float* s_lt = s_ct + round4(L.n_small);
  float* s_wb = s_lt + n_lt * BLOCK + (threadIdx.x / 32) * N_BND;
  for (int j = threadIdx.x; j < N_SPH * ts; j += BLOCK) s_acc[j] = 0.0f;
  for (int j = threadIdx.x; j < L.n_small; j += BLOCK) s_ct[j] = 0.0f;
  for (int j = 0; j < n_lt; ++j) s_lt[j * BLOCK + threadIdx.x] = 0.0f;
  const Tab T0 = tab_small(L, g_tab, s_small, TILE_C);
  ring.start(L);  // ends with __syncthreads
  const LtRow lt{s_lt + threadIdx.x, BLOCK};
  const float tau_eff = fmaxf(T0.tau(), 1e-6f);
  const bool has_next = p.cnox != nullptr;
  const int lane = threadIdx.x & 31;

  for (long long base = (long long)blockIdx.x * BLOCK; base < n;
       base += (long long)gridDim.x * BLOCK) {
    const long long i = base + threadIdx.x;
    const bool valid = i < n;
    const long long li = !valid ? 0 : order ? (long long)order[i] : i;
    Ray r = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 1.0f}};
    float w = 0.0f, t_ref = FAR, carry[NC], g[NC];
    float co[3] = {0.0f, 0.0f, 0.0f}, cd[3] = {0.0f, 0.0f, 0.0f}, cw = 0.0f, csky[10];
#pragma unroll
    for (int k = 0; k < NC; ++k) carry[k] = g[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 10; ++k) csky[k] = 0.0f;
    if (valid) {
      r.o[0] = p.ox[li]; r.o[1] = p.oy[li]; r.o[2] = p.oz[li];
      r.d[0] = p.dx[li]; r.d[1] = p.dy[li]; r.d[2] = p.dz[li];
      w = p.w[li];
      t_ref = p.res[li];
#pragma unroll
      for (int k = 0; k < NC; ++k) carry[k] = p.res[(1 + k) * n + li];
      const float ca[3] = {p.car[li], p.cag[li], p.cab[li]};
      float cno[3] = {0.0f, 0.0f, 0.0f}, cnd[3] = {0.0f, 0.0f, 0.0f}, cwn = 0.0f;
      if (has_next) {
        cno[0] = p.cnox[li]; cno[1] = p.cnoy[li]; cno[2] = p.cnoz[li];
        cnd[0] = p.cndx[li]; cnd[1] = p.cndy[li]; cnd[2] = p.cndz[li];
        cwn = p.cnw[li];
      }
      post_bwd<LAST>(T0, carry, r, w, ca, cwn, cno, cnd, g, co, cd, cw, csky, lt);
    }
#pragma unroll
    for (int k = 0; k < 10; ++k) warp_add(&s_ct[L.sky - L.wall + k], csky[k]);

    // ---- walls and boxes: warp sums into the shared row ----
    for (int j = 0; j < L.n_w; ++j) {
      float c[N_WALL];
#pragma unroll
      for (int k = 0; k < N_WALL; ++k) c[k] = 0.0f;
      if (valid) wall_bwd<LAST>(T0, j, r, t_ref, g, co, cd, c, lt);
#pragma unroll
      for (int k = 0; k < N_WALL; ++k) warp_add(&s_ct[k * L.nw1 + j], c[k]);
    }
    for (int j = 0; j < L.n_b; ++j) {
      float c[N_BOX];
#pragma unroll
      for (int k = 0; k < N_BOX; ++k) c[k] = 0.0f;
      if (valid) box_bwd<LAST>(T0, j, r, t_ref, g, co, cd, c, lt);
#pragma unroll
      for (int k = 0; k < N_BOX; ++k) warp_add(&s_ct[L.box - L.wall + k * L.nb1 + j], c[k]);
    }

    // ---- sphere chunks: the tiles of the ring, culled, then the lanes' gates ----
    const float oo = r.o[0] * r.o[0] + r.o[1] * r.o[1] + r.o[2] * r.o[2];
    const float dod = r.d[0] * r.o[0] + r.d[1] * r.o[1] + r.d[2] * r.o[2];
    const float iv[3] = {srecip(r.d[0]), srecip(r.d[1]), srecip(r.d[2])};
    warp_bounds(valid, r.o, iv, s_wb);
    for (int t = 0; t < n_tiles; ++t) {
      const Tab T = T0.at(t, ring.acquire(L));
      for (int wd = 0; wd < words; ++wd) {
        const int cw0 = T.c0 + 32 * wd;
        const unsigned cull = warp_cull(T, cw0, s_wb, tau_eff);
        const unsigned lm = valid ? lane_mask(T, cull, cw0, r, oo, dod, iv, tau_eff) : 0u;
        for (unsigned um = __reduce_or_sync(FULL, lm); um; um &= um - 1) {
          const int b = __ffs(um) - 1;
          const bool mine = (lm >> b) & 1u;
          const int s1 = min((cw0 + b + 1) * CHUNK, L.n_s);
          for (int s = (cw0 + b) * CHUNK; s < s1; ++s) {
            float cs[N_SPH];
#pragma unroll
            for (int k = 0; k < N_SPH; ++k) cs[k] = 0.0f;
            if (mine) sphere_bwd<LAST>(T, s, r, t_ref, g, co, cd, cs, lt);
            const float v = warp_scatter12(cs, lane);
            const int k = lane >> 1;
            if (!(lane & 1) && k < N_SPH && v != 0.0f) atomicAdd(&s_acc[k * ts + (s - T.s0)], v);
          }
        }
      }
      __syncthreads();  // the tile's sums are complete, its buffer read
      flush_acc(L, t, s_acc, sums);
      if (ring.resident) __syncthreads();  // else the next acquire's: zeroed before reuse
      ring.release(true);
    }
    if (valid) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        p.cts[k * n + li] = co[k];
        p.cts[(3 + k) * n + li] = cd[k];
      }
      p.cts[6 * n + li] = cw;
    }
  }
  ring.finish();

  // ---- the block's sums into the float64 table ----
  for (int j = 0; j < n_lt; ++j) warp_add(&s_ct[lt_slot(L, j)], s_lt[j * BLOCK + threadIdx.x]);
  __syncthreads();
  for (int j = threadIdx.x; j < L.n_small; j += BLOCK)
    if (s_ct[j] != 0.0f) atomicAdd(&sums[L.wall + j], (double)s_ct[j]);
}

template <bool LAST>
int launch(const Layout& L, const float* tab, const float* gate, const BwdPlanes& p,
           const int* order, double* sums, long long n, cudaStream_t stream) {
  auto kernel = soft_level_bwd_kernel<LAST>;
  const size_t smem = (size_t)smem_floats(L.n_small, lt_tau(L) + 2) * sizeof(float);
  const long long blocks = (n + BLOCK - 1) / BLOCK;
  int n_blocks = 0;
  cudaError_t err = persistent_grid(kernel, BLOCK, smem,
                                    blocks < (1 << 30) ? (int)blocks : (1 << 30), &n_blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_blocks, BLOCK, smem, stream>>>(L, tab, gate, p, order, sums, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of a launch with n_lt light accumulators
// a lane (ops/cuda_soft.py's soft_launch_plan mirrors it).
long long soft_level_bwd_smem_bytes(int n_small, int n_lt) {
  return (long long)smem_floats(n_small, n_lt) * (long long)sizeof(float);
}

// Launch the backward of one soft level on `stream` over n lanes: the table,
// gates, counts and lane order as soft_level_launch takes them; the
// level's input rays and throughput; `res` its [1 + n_carry, n] residual
// (t_ref, the carry); the image cotangent (car, cag, cab) and those of the
// level's outputs (the next ray xyz xyz and throughput; all null after the
// last level). Writes `cts` [7, n] (o xyz, d xyz, w) and adds the table's
// cotangent into `sums` (float64, n_tab). Returns the CUDA error of the
// launch (0 on success).
int soft_level_bwd_launch(const float* tab, int n_tab, const float* gate, int n_s, int n_s_pad,
                          int n_w, int n_b, int n_pt, int n_sun, int gate_kind,
                          const float* ox, const float* oy, const float* oz, const float* dx,
                          const float* dy, const float* dz, const float* w, const float* res,
                          const float* car, const float* cag, const float* cab,
                          const float* cnox, const float* cnoy, const float* cnoz,
                          const float* cndx, const float* cndy, const float* cndz,
                          const float* cnw, const int* order, float* cts, double* sums,
                          long long n, int is_last, void* stream) {
  const Layout L = make_layout(n_s, n_s_pad, n_w, n_b, n_pt, n_sun, gate_kind);
  const bool some = cnox || cnoy || cnoz || cndx || cndy || cndz || cnw;
  const bool all = cnox && cnoy && cnoz && cndx && cndy && cndz && cnw;
  if (!layout_ok(L, n_tab) || n <= 0 || some != all ||
      (reinterpret_cast<uintptr_t>(tab) & 15))
    return (int)cudaErrorInvalidValue;
  const BwdPlanes p{ox, oy, oz, dx, dy, dz, w, res, car, cag, cab,
                    cnox, cnoy, cnoz, cndx, cndy, cndz, cnw, cts};
  cudaStream_t s = (cudaStream_t)stream;
  return is_last ? launch<true>(L, tab, gate, p, order, sums, n, s)
                 : launch<false>(L, tab, gate, p, order, sums, n, s);
}

const char* soft_level_bwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
