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
// Sums over lanes, each in an order that does not vary between runs, so
// the same inputs give the same cotangents bit for bit, run after run, and
// a fit of many steps retraces itself (with float atomics the last bits
// varied, and 600 Adam steps of the c4 fit carried that into a spread of
// final centre errors: tools/fit_spread.py, PERF.md). Warp sums are
// shuffles in a fixed order.
// - The small table (walls, boxes, lights, sky, tau): a lane's light, tau
//   and tau_z cotangents accumulate in its own column of shared memory (6
//   per light and 2 floats, conflict-free at a stride of 256). A wall's or
//   box's cotangents and the sky's are summed over the warp, and lane 0
//   adds them into its warp's own row of shared memory, in program order.
//   At the block's end the light columns go the same way, the block sums
//   its warps' rows in warp order (float64) and writes them to its own row
//   of `rows` ([blocks, n_small] in device memory), which ops/cuda_soft.py
//   sums over the blocks.
// - The spheres: a sphere's 12 cotangents are reduce-scattered over the
//   warp (`warp_scatter12`, 16 shuffles) and added by 12 lanes into
//   accumulators in shared memory (a sphere of the tile has 12), and after
//   each tile the block adds the nonzero ones into the table in device
//   memory. (Keeping the sums of a resident ring over all of a block's rays,
//   without the barriers, was slower: PERF.md.) Here warps and blocks meet
//   in any order, so the sums are in fixed point (`fx_add`): a warp's sum
//   becomes two int64 words, `hi` in units of 2^-20 and the rest in `lo`,
//   in units of 2^-62, added with integer atomics (associative) into the
//   shared accumulators and the table `fx` ([2, n_tab]), which
//   ops/cuda_soft.py turns into float64. A warp's sum keeps its bits down
//   to 2^-62 (all 24 from a magnitude of 2^-39 up): a deliberate floor far
//   below what moves a fit (Adam's epsilon is 1e-8). A sum that is not
//   finite, or of magnitude 2^40 or more, is added into the float64 table
//   `sums` instead, so an inf or NaN still reaches the gradient. The lo
//   words stay within int64 up to 2^27 lanes a launch (a warp adds at most
//   2^41 a sum), which the launch checks.
// The plain version sums in float64.
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
using rt::warp_sum;

// Blocks an SM keeps: ptxas fits the registers to it (at most 128: 127 and
// 121, no spill). 3 blocks of 80 registers spilled ~400 bytes and were
// slower (PERF.md, tools/soft_variants.py).
constexpr int MIN_BLOCKS = 2;
// Chunks of a tile of the sphere ring. With float accumulators (4 bytes a
// value) 64 was faster than 32 and 128 (PERF.md, tools/soft_variants.py).
// The fixed-point ones take 16 bytes a value; at 32 a block's shared memory
// stays where 64 had it (~92 KB at c4), two blocks an SM; at 64 only one
// block would fit. ops/cuda_soft.py's _TILE_CHUNKS_BWD mirrors it.
constexpr int TILE_C = 32;
static_assert(TILE_C % 32 == 0 && TILE_C <= BLOCK, "a tile is whole mask words");

struct BwdPlanes {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *w, *res;  // res: [1 + NC, n]
  const float *car, *cag, *cab;
  const float *cnox, *cnoy, *cnoz, *cndx, *cndy, *cndz, *cnw;  // all null after the last level
  float* cts;  // [7, n]: ct o xyz, ct d xyz, ct w
};

typedef unsigned long long u64;

// Sphere cotangent accumulators of a tile (each a hi and a lo word).
constexpr int N_ACC = N_SPH * CHUNK * TILE_C;
// Lanes a launch may have: the lo words' bound (see above).
constexpr long long MAX_LANES = 1LL << 27;

// Shared memory in bytes: the ring, the small table, each warp's row of
// its cotangent, each lane's light accumulators (n_lt x BLOCK) and each
// warp's ray bounds in floats; the tile's sphere cotangent sums in
// fixed-point pairs of int64 words, placed right after the ring.
long long smem_bytes(int n_small, int n_lt) {
  return 4LL * (2 * tile_floats(TILE_C) + (1 + BLOCK / 32) * round4(n_small) + n_lt * BLOCK +
                (BLOCK / 32) * N_BND) +
         16LL * N_ACC;
}

// Adds `v` into the fixed-point pair (hi[0], lo[0]), shared or in device
// memory: hi in units of 2^-20, lo the rest in units of 2^-62. A value that
// is not finite or has a magnitude of 2^40 or more goes into `*wide`, its
// entry of the float64 table.
__device__ __forceinline__ void fx_add(u64* hi, u64* lo, float v, double* wide) {
  if (v == 0.0f) return;
  if (!(fabsf(v) < 1099511627776.0f)) {  // 2^40; NaN fails the test too
    atomicAdd(wide, (double)v);
    return;
  }
  const double a = (double)v * 1048576.0, h = rint(a);  // 2^20; a - h is exact
  const long long l = __double2ll_rn((a - h) * 4398046511104.0);  // 2^42
  if (h != 0.0) atomicAdd(hi, (u64)(long long)h);
  if (l != 0) atomicAdd(lo, (u64)l);
}

// Sums `v` over the warp and lane 0 adds the sum into entry j of the
// warp's own row; every lane must call it.
__device__ __forceinline__ void warp_row(float* row, int j, float v) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) row[j] += v;
}

// Adds the nonzero sums of `acc` (12 pairs a sphere of tile t) into the
// table `fx` and zeroes them. Every thread calls it.
__device__ __forceinline__ void flush_acc(const Layout& L, int t, u64* acc, u64* fx) {
  constexpr int ts = TILE_C * CHUNK;
  const int s0 = t * ts;
  for (int j = threadIdx.x; j < N_ACC; j += BLOCK) {
    const u64 h = acc[j], l = acc[N_ACC + j];
    if (h | l) {
      const int col = j / ts;
      const size_t g = (size_t)col * L.n_s_pad + s0 + (j - col * ts);
      if (h) atomicAdd(&fx[g], h);
      if (l) atomicAdd(&fx[L.n_tab + g], l);
      acc[j] = acc[N_ACC + j] = 0;
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
                          const int* __restrict__ order, double* __restrict__ sums,
                          u64* __restrict__ fx, double* __restrict__ rows, long long n) {
  constexpr int NC = NCarry<LAST>::value;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  constexpr int words = TILE_C / 32, ts = TILE_C * CHUNK;
  const int n_tiles = (L.n_chunks + TILE_C - 1) / TILE_C, n_lt = lt_tau(L) + 2;
  Ring ring{g_tab, g_gate, sm, n_tiles, TILE_C, 0, false};
  const int n_row = round4(L.n_small);
  u64* s_acc = reinterpret_cast<u64*>(sm + 2 * tile_floats(TILE_C));  // 16-byte aligned
  float* s_small = reinterpret_cast<float*>(s_acc + 2 * N_ACC);
  float* s_rows = s_small + n_row;  // BLOCK / 32 rows of n_row
  float* s_ct = s_rows + (threadIdx.x / 32) * n_row;  // this warp's
  float* s_lt = s_rows + (BLOCK / 32) * n_row;
  float* s_wb = s_lt + n_lt * BLOCK + (threadIdx.x / 32) * N_BND;
  for (int j = threadIdx.x; j < 2 * N_ACC; j += BLOCK) s_acc[j] = 0;
  for (int j = threadIdx.x; j < (BLOCK / 32) * n_row; j += BLOCK) s_rows[j] = 0.0f;
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
    for (int k = 0; k < 10; ++k) warp_row(s_ct, L.sky - L.wall + k, csky[k]);

    // ---- walls and boxes: warp sums into the warp's row ----
    for (int j = 0; j < L.n_w; ++j) {
      float c[N_WALL];
#pragma unroll
      for (int k = 0; k < N_WALL; ++k) c[k] = 0.0f;
      if (valid) wall_bwd<LAST>(T0, j, r, t_ref, g, co, cd, c, lt);
#pragma unroll
      for (int k = 0; k < N_WALL; ++k) warp_row(s_ct, k * L.nw1 + j, c[k]);
    }
    for (int j = 0; j < L.n_b; ++j) {
      float c[N_BOX];
#pragma unroll
      for (int k = 0; k < N_BOX; ++k) c[k] = 0.0f;
      if (valid) box_bwd<LAST>(T0, j, r, t_ref, g, co, cd, c, lt);
#pragma unroll
      for (int k = 0; k < N_BOX; ++k) warp_row(s_ct, L.box - L.wall + k * L.nb1 + j, c[k]);
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
            const int k = lane >> 1, j = k * ts + (s - T.s0);
            if (!(lane & 1) && k < N_SPH)
              fx_add(&s_acc[j], &s_acc[N_ACC + j], v, &sums[(size_t)k * L.n_s_pad + s]);
          }
        }
      }
      __syncthreads();  // the tile's sums are complete, its buffer read
      flush_acc(L, t, s_acc, fx);
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

  // ---- the block's small-table sums into its row of `rows` ----
  for (int j = 0; j < n_lt; ++j) warp_row(s_ct, lt_slot(L, j), s_lt[j * BLOCK + threadIdx.x]);
  __syncthreads();
  for (int j = threadIdx.x; j < L.n_small; j += BLOCK) {
    double v = 0.0;
    for (int w = 0; w < BLOCK / 32; ++w) v += (double)s_rows[w * n_row + j];
    rows[(size_t)blockIdx.x * L.n_small + j] = v;
  }
}

template <bool LAST>
int launch(const Layout& L, const float* tab, const float* gate, const BwdPlanes& p,
           const int* order, double* sums, u64* fx, double* rows, int n_rows, long long n,
           cudaStream_t stream) {
  auto kernel = soft_level_bwd_kernel<LAST>;
  const size_t smem = (size_t)smem_bytes(L.n_small, lt_tau(L) + 2);
  const long long blocks = (n + BLOCK - 1) / BLOCK;
  int n_blocks = 0;
  cudaError_t err = persistent_grid(kernel, BLOCK, smem,
                                    blocks < (1 << 30) ? (int)blocks : (1 << 30), &n_blocks);
  if (err != cudaSuccess) return (int)err;
  if (n_blocks > n_rows) return (int)cudaErrorInvalidValue;
  kernel<<<n_blocks, BLOCK, smem, stream>>>(L, tab, gate, p, order, sums, fx, rows, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of a launch with n_lt light accumulators
// a lane (ops/cuda_soft.py's soft_launch_plan mirrors it).
long long soft_level_bwd_smem_bytes(int n_small, int n_lt) { return smem_bytes(n_small, n_lt); }

// Launch the backward of one soft level on `stream` over n lanes: the table,
// gates, counts and lane order as soft_level_launch takes them; the
// level's input rays and throughput; `res` its [1 + n_carry, n] residual
// (t_ref, the carry); the image cotangent (car, cag, cab) and those of the
// level's outputs (the next ray xyz xyz and throughput; all null after the
// last level). Writes `cts` [7, n] (o xyz, d xyz, w); adds the spheres'
// cotangent into `fx` (int64, [2, n_tab]: hi words in units of 2^-20, then
// lo words in units of 2^-62) and those of its warp sums that are not
// finite or of magnitude 2^40 or more into `sums` (float64, n_tab); writes
// each block's sums of the small table's cotangent to its row of `rows`
// (float64, [n_rows, n_small]; a launch uses at most as many blocks as the
// card holds at once, and fails if that is more than n_rows). At most 2^27
// lanes. Returns the CUDA error of the launch (0 on success).
int soft_level_bwd_launch(const float* tab, int n_tab, const float* gate, int n_s, int n_s_pad,
                          int n_w, int n_b, int n_pt, int n_sun, int gate_kind,
                          const float* ox, const float* oy, const float* oz, const float* dx,
                          const float* dy, const float* dz, const float* w, const float* res,
                          const float* car, const float* cag, const float* cab,
                          const float* cnox, const float* cnoy, const float* cnoz,
                          const float* cndx, const float* cndy, const float* cndz,
                          const float* cnw, const int* order, float* cts, double* sums,
                          long long* fx, double* rows, int n_rows, long long n, int is_last,
                          void* stream) {
  const Layout L = make_layout(n_s, n_s_pad, n_w, n_b, n_pt, n_sun, gate_kind);
  const bool some = cnox || cnoy || cnoz || cndx || cndy || cndz || cnw;
  const bool all = cnox && cnoy && cnoz && cndx && cndy && cndz && cnw;
  if (!layout_ok(L, n_tab) || n <= 0 || n > MAX_LANES || some != all ||
      (reinterpret_cast<uintptr_t>(tab) & 15))
    return (int)cudaErrorInvalidValue;
  const BwdPlanes p{ox, oy, oz, dx, dy, dz, w, res, car, cag, cab,
                    cnox, cnoy, cnoz, cndx, cndy, cndz, cnw, cts};
  cudaStream_t s = (cudaStream_t)stream;
  u64* q = reinterpret_cast<u64*>(fx);
  return is_last ? launch<true>(L, tab, gate, p, order, sums, q, rows, n_rows, n, s)
                 : launch<false>(L, tab, gate, p, order, sums, q, rows, n_rows, n, s);
}

const char* soft_level_bwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
