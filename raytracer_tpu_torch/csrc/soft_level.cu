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
// Design: one thread per ray, blocks of 256 rays walked with a grid stride
// by as many blocks as fit on the card at once; a lane takes the ray that
// the optional `order` plane names (ops/cuda_soft.py sorts bounce rays so
// that a warp holds rays that reach the same chunks). The small table
// (walls, boxes, lights, sky, tau, tau_z) stays in shared memory. The
// sphere columns and the chunk gates stream through a ring of two tiles of
// TILE_C chunks (soft_common.cuh's `Ring`, cp.async, the next tile in
// flight while the block works on this one; a scene of at most two tiles is
// copied once, and the block then never waits at a barrier), so the shared
// memory of a block does not depend on the number of spheres. For each 32
// chunks of a tile a warp first rejects the chunks that none of its rays
// can reach (`warp_cull`: one conservative slab test a chunk, a lane each,
// over the bounds of the warp's origins and reciprocal directions), then
// each lane evaluates its exact gate (`chunk_reach`; every member's coverage
// sigmoid is exactly 0 in float32 outside it, so a skipped chunk would have
// added exactly 0) on the surviving chunks only, into a bit mask, and the
// warp walks the OR of its lanes' masks, a lane computing only its own
// chunks. (A cull per block of 256 rays, with the barriers it needs, cost
// more than it saved on small scenes: PERF.md.) Two passes: the anchor
// depth t_ref (the least t of a primitive with coverage above 0.3), then
// the composite carry (the weight sum, 13 payload sums, 3 at the last
// level, and the log-transmittance), sphere by sphere in index order
// (padding spheres skipped, unlike the JAX package: ops/cuda_soft.py), then
// the walls, then the boxes; the second pass reuses the first pass's lane
// masks of the first MASK_WORDS x 32 chunks (faster than recomputing them:
// PERF.md) and recomputes the rest. Then the tail and the outputs. tau and
// tau_z are read from the table at run time.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): a level reads 10
// planes (rays, throughput, accumulator) and writes 10 (accumulator,
// throughput, next rays), plus 16 (6 at the last level) with EMIT: at
// 1920x1080, 20-36 planes, 166-299 MB, 50-89 us. The arithmetic is ~60
// float32 operations per reached sphere in the t_ref pass and ~250 in the
// composite (coverage, hit, normal, Blinn-Phong with one point light and
// one sun, the contribution), ~26 per chunk gate, and ~150 per wall or box:
// operations bound it (chip_smoke.py's `soft_level_ops` counts them on each
// run's data). The design spends them on the chunks a warp's lanes reach,
// and the gates on the chunks the warp may reach.
//
// Build with -fmad=false and without fast math (ops/_build.py): the sums
// are then those of the plain PyTorch version, which adds the same terms in
// the same order.

#include <cstdint>

#include "soft_common.cuh"

namespace {

using namespace rt::soft;
using rt::FULL;
using rt::persistent_grid;
using rt::srecip;

// Blocks an SM keeps: ptxas fits the registers to it (64; the non-last
// instantiations spill 12 bytes, the last none). 3 blocks of 79 registers
// without spills were slower on bounce levels (PERF.md,
// tools/soft_variants.py).
constexpr int MIN_BLOCKS = 4;
// Chunks of a tile of the sphere ring (a multiple of 32, one mask word, at
// most BLOCK): measured against 64 and 128 on the H100 (PERF.md,
// tools/soft_variants.py); ops/cuda_soft.py's _TILE_CHUNKS mirrors it.
constexpr int TILE_C = 32;
static_assert(TILE_C % 32 == 0 && TILE_C <= BLOCK, "a tile is whole mask words");

struct Planes {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *w, *ar, *ag, *ab;
  float* out;  // [n_out, n]: acc rgb, w_next, o_next xyz, d_next xyz, then t_ref, carry
};

// Shared memory in floats: the ring (two tiles), the small table, the lane
// masks (MASK_WORDS x BLOCK words) and each warp's ray bounds.
int smem_floats(int n_small) {
  return 2 * tile_floats(TILE_C) + round4(n_small) + MASK_WORDS * BLOCK + (BLOCK / 32) * N_BND;
}

template <bool LAST, bool EMIT>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
    soft_level_kernel(Layout L, const float* __restrict__ g_tab,
                      const float* __restrict__ g_gate, Planes p, const int* __restrict__ order,
                      long long n) {
  constexpr int NC = NCarry<LAST>::value;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  constexpr int words = TILE_C / 32;
  const int n_tiles = (L.n_chunks + TILE_C - 1) / TILE_C;
  Ring ring{g_tab, g_gate, sm, n_tiles, TILE_C, 0, false};
  float* s_small = sm + 2 * tile_floats(TILE_C);
  unsigned* s_lm = reinterpret_cast<unsigned*>(s_small + round4(L.n_small));
  float* s_wb = reinterpret_cast<float*>(s_lm + MASK_WORDS * BLOCK) + (threadIdx.x / 32) * N_BND;
  const Tab T0 = tab_small(L, g_tab, s_small, TILE_C);
  ring.start(L);  // ends with __syncthreads: the small table is in too
  const float tau = T0.tau(), tau_z = T0.tau_z(), tau_eff = fmaxf(tau, 1e-6f);

  for (long long base = (long long)blockIdx.x * BLOCK; base < n;
       base += (long long)gridDim.x * BLOCK) {
    const long long i = base + threadIdx.x;
    const bool valid = i < n;
    const long long li = !valid ? 0 : order ? (long long)order[i] : i;
    Ray r = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 1.0f}};
    float w = 0.0f;
    if (valid) {
      r.o[0] = p.ox[li]; r.o[1] = p.oy[li]; r.o[2] = p.oz[li];
      r.d[0] = p.dx[li]; r.d[1] = p.dy[li]; r.d[2] = p.dz[li];
      w = p.w[li];
    }
    const float oo = r.o[0] * r.o[0] + r.o[1] * r.o[1] + r.o[2] * r.o[2];
    const float dod = r.d[0] * r.o[0] + r.d[1] * r.o[1] + r.d[2] * r.o[2];
    const float iv[3] = {srecip(r.d[0]), srecip(r.d[1]), srecip(r.d[2])};
    warp_bounds(valid, r.o, iv, s_wb);

    // ---- pass 1: the anchor depth ----
    float t_ref = FAR;
    for (int t = 0; t < n_tiles; ++t) {
      const Tab T = T0.at(t, ring.acquire(L));
      for (int wd = 0; wd < words; ++wd) {
        const int cw = T.c0 + 32 * wd;
        const unsigned cull = warp_cull(T, cw, s_wb, tau_eff);
        const unsigned lm = valid ? lane_mask(T, cull, cw, r, oo, dod, iv, tau_eff) : 0u;
        if (cw / 32 < MASK_WORDS) s_lm[(cw / 32) * BLOCK + threadIdx.x] = lm;
        for (unsigned um = __reduce_or_sync(FULL, lm); um; um &= um - 1) {
          const int b = __ffs(um) - 1;
          if (!((lm >> b) & 1u)) continue;
          const int s1 = min((cw + b + 1) * CHUNK, L.n_s);
          for (int s = (cw + b) * CHUNK; s < s1; ++s) {
            const SphereHit h = sphere_hit(T, s, r, tau);
            t_ref = fminf(t_ref, h.alpha > ALPHA_REF ? h.t : FAR);
          }
        }
      }
      ring.release();
    }
    for (int j = 0; j < L.n_w; ++j) {
      const WallHit h = wall_hit(T0, j, r, tau);
      t_ref = fminf(t_ref, h.alpha > ALPHA_REF ? h.t : FAR);
    }
    for (int j = 0; j < L.n_b; ++j) {
      const BoxHit h = box_hit(T0, j, r, tau);
      t_ref = fminf(t_ref, h.alpha > ALPHA_REF ? h.tn : FAR);
    }

    // ---- pass 2: the composite carry ----
    float carry[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) carry[k] = 0.0f;
    float col[3];
    for (int t = 0; t < n_tiles; ++t) {
      const Tab T = T0.at(t, ring.acquire(L));
      for (int wd = 0; wd < words; ++wd) {
        const int cw = T.c0 + 32 * wd;
        unsigned lm;
        if (cw / 32 < MASK_WORDS) {
          lm = s_lm[(cw / 32) * BLOCK + threadIdx.x];
        } else {
          const unsigned cull = warp_cull(T, cw, s_wb, tau_eff);
          lm = valid ? lane_mask(T, cull, cw, r, oo, dod, iv, tau_eff) : 0u;
        }
        for (unsigned um = __reduce_or_sync(FULL, lm); um; um &= um - 1) {
          const int b = __ffs(um) - 1;
          if (!((lm >> b) & 1u)) continue;
          const int s1 = min((cw + b + 1) * CHUNK, L.n_s);
          for (int s = (cw + b) * CHUNK; s < s1; ++s) {
            const SphereHit h = sphere_hit(T, s, r, tau);
            const Mat m = sphere_mat(T, s);
            shade(T, h.point, h.n, r.d, m, col);
            add_contrib<LAST>(carry, h.alpha, h.t, h.point, h.n, col, m.met, t_ref, tau_z);
          }
        }
      }
      ring.release();
    }
    for (int j = 0; j < L.n_w; ++j) {
      const WallHit h = wall_hit(T0, j, r, tau);
      const Mat m = wall_mat(T0, j);
      shade(T0, h.point, h.nrm, r.d, m, col);
      add_contrib<LAST>(carry, h.alpha, h.t, h.point, h.nrm, col, m.met, t_ref, tau_z);
    }
    for (int j = 0; j < L.n_b; ++j) {
      const BoxHit h = box_hit(T0, j, r, tau);
      const Mat m = box_mat(T0, j);
      shade(T0, h.point, h.n, r.d, m, col);
      add_contrib<LAST>(carry, h.alpha, h.tn, h.point, h.n, col, m.met, t_ref, tau_z);
    }

    // ---- the tail and the outputs ----
    if (!valid) continue;
    const Post q = post<LAST>(T0, carry, r, w);
    float* out = p.out;
    out[0 * n + li] = p.ar[li] + w * q.loc[0];
    out[1 * n + li] = p.ag[li] + w * q.loc[1];
    out[2 * n + li] = p.ab[li] + w * q.loc[2];
    out[3 * n + li] = q.w_next;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      out[(4 + k) * n + li] = q.ro[k];
      out[(7 + k) * n + li] = q.rd[k];
    }
    if (EMIT) {
      out[10 * n + li] = t_ref;
#pragma unroll
      for (int k = 0; k < NC; ++k) out[(11 + k) * n + li] = carry[k];
    }
  }
  ring.finish();
}

template <bool LAST, bool EMIT>
int launch(const Layout& L, const float* tab, const float* gate, const Planes& p,
           const int* order, long long n, cudaStream_t stream) {
  auto kernel = soft_level_kernel<LAST, EMIT>;
  const size_t smem = (size_t)smem_floats(L.n_small) * sizeof(float);
  const long long blocks = (n + BLOCK - 1) / BLOCK;
  int n_blocks = 0;
  cudaError_t err = persistent_grid(kernel, BLOCK, smem,
                                    blocks < (1 << 30) ? (int)blocks : (1 << 30), &n_blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_blocks, BLOCK, smem, stream>>>(L, tab, gate, p, order, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of a launch (ops/cuda_soft.py's
// soft_launch_plan mirrors it).
long long soft_level_smem_bytes(int n_small) {
  return (long long)smem_floats(n_small) * (long long)sizeof(float);
}

// Launch one soft level on `stream` over n lanes. `tab` is the packed table
// (ops/cuda_soft.py's _PACK order, n_tab floats, 16-byte aligned) of n_s
// spheres padded to n_s_pad, `gate` the [12, n_s_pad / 8] chunk gates;
// `gate_kind` 0 gates on chunk boxes, 1 on bounding spheres. `order`
// (n ints, or null) names the ray of each lane. `out` holds 10 planes, then
// with `emit_res` t_ref and the carry (15 planes, 5 at the last level).
// Returns the CUDA error of the launch (0 on success).
int soft_level_launch(const float* tab, int n_tab, const float* gate, int n_s, int n_s_pad,
                      int n_w, int n_b, int n_pt, int n_sun, int gate_kind,
                      const float* ox, const float* oy, const float* oz, const float* dx,
                      const float* dy, const float* dz, const float* w, const float* ar,
                      const float* ag, const float* ab, const int* order, float* out,
                      long long n, int is_last, int emit_res, void* stream) {
  const Layout L = make_layout(n_s, n_s_pad, n_w, n_b, n_pt, n_sun, gate_kind);
  if (!layout_ok(L, n_tab) || n <= 0 || (reinterpret_cast<uintptr_t>(tab) & 15))
    return (int)cudaErrorInvalidValue;
  const Planes p{ox, oy, oz, dx, dy, dz, w, ar, ag, ab, out};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_last) return emit_res ? launch<true, true>(L, tab, gate, p, order, n, s)
                               : launch<true, false>(L, tab, gate, p, order, n, s);
  return emit_res ? launch<false, true>(L, tab, gate, p, order, n, s)
                  : launch<false, false>(L, tab, gate, p, order, n, s);
}

const char* soft_level_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
