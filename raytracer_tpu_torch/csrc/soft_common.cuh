// Device code shared by the soft level kernels (soft_level.cu and
// soft_level_bwd.cu): the packed soft table's layout, the chunk gates, each
// primitive's coverage, soft hit and shading, its contribution to the
// composite carry, the composite's tail, and the adjoints of all of these,
// derived by hand.
//
// Every function follows the plain PyTorch version op for op
// (raytracer_tpu_torch/diff/soft.py's formulas and ops/cuda_soft.py's
// level): build with -fmad=false and without fast math (ops/_build.py), so
// each product and sum rounds once, as a separate PyTorch op does. The
// sigmoid is 1 / (1 + expf(-x)) with the accurate expf: it is exactly 0
// below about -89, in value and in the derivative y (1 - y), which makes the
// chunk gates exact.
//
// Derivative rules, those of PyTorch's autograd of the plain version: a
// guarded sqrt, rsqrt, log or divide takes its derivative only on its taken
// branch; masks and selections are constants, and so are t_ref and the
// box's face normal; every max and min against a constant or between two
// values gives each side half of the cotangent at a tie (`wmax`, `wmin`;
// the JAX package's jnp.maximum rule).

#pragma once

#include "trace_common.cuh"

namespace rt {
namespace soft {

constexpr int CHUNK = 8;
constexpr int N_GATE = 12;
constexpr float FAR = 1e4f;
constexpr float ALPHA_REF = 0.3f;
constexpr float ALPHA_MAX = (float)(1.0 - 1e-7);
constexpr float T_MARGIN = 128.0f;
constexpr int GATE_AABB = 0;
constexpr int N_SPH = 12, N_WALL = 23, N_BOX = 14;
constexpr int BLOCK = 256;       // threads of a block of both kernels
constexpr int MASK_WORDS = 8;    // lane-mask words (32 chunks each) the forward keeps for pass 2
constexpr int N_BND = 16;        // a warp's ray bounds: o lo/hi, iv lo/hi (12), not-finite flag

// Offsets (in floats) of each group of the packed table; mirrors _PACK in
// raytracer_tpu_torch/ops/cuda_soft.py. Each group is a run of columns, one
// value per item: spheres (12 columns of n_s_pad, the first n_s real, the
// rest padding), walls (23 of max(n_w, 1)), boxes (14 of max(n_b, 1)),
// point lights and suns (6 of max(n, 1) each), the 10 sky scalars, tau and
// tau_z. Everything past the spheres is the "small table" (n_small floats).
struct Layout {
  int n_s, n_s_pad, n_chunks, n_w, n_b, n_pt, n_sun, gate;
  int nw1, nb1, np1, nu1;
  int wall, box, pt, sun, sky, tau, tau_z, n_tab, n_small;
};

inline Layout make_layout(int n_s, int n_s_pad, int n_w, int n_b, int n_pt, int n_sun,
                          int gate) {
  Layout L;
  L.n_s = n_s; L.n_s_pad = n_s_pad; L.n_chunks = n_s_pad / CHUNK;
  L.n_w = n_w; L.n_b = n_b; L.n_pt = n_pt; L.n_sun = n_sun; L.gate = gate;
  L.nw1 = n_w > 1 ? n_w : 1; L.nb1 = n_b > 1 ? n_b : 1;
  L.np1 = n_pt > 1 ? n_pt : 1; L.nu1 = n_sun > 1 ? n_sun : 1;
  L.wall = N_SPH * n_s_pad;
  L.box = L.wall + N_WALL * L.nw1;
  L.pt = L.box + N_BOX * L.nb1;
  L.sun = L.pt + 6 * L.np1;
  L.sky = L.sun + 6 * L.nu1;
  L.tau = L.sky + 10;
  L.tau_z = L.tau + 1;
  L.n_tab = L.tau_z + 1;
  L.n_small = L.n_tab - L.wall;
  return L;
}

// Whether the launch's arguments describe a table these kernels take.
inline bool layout_ok(const Layout& L, int n_tab) {
  return L.n_tab == n_tab && L.n_s_pad > 0 && L.n_s_pad % CHUNK == 0 && L.n_s >= 0 &&
         L.n_s <= L.n_s_pad;
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Floats of one tile of the sphere ring: 12 columns of 8 tile_c spheres,
// then the 12 gate rows of its tile_c chunks.
__host__ __device__ inline int tile_floats(int tile_c) { return N_SPH * CHUNK * tile_c + N_GATE * tile_c; }

// The table as a kernel sees it: the small table resident in shared memory,
// and one tile of the sphere ring (chunks c0 .. c0 + tile_c - 1, spheres
// s0 = 8 c0 ...) with its gates. Sphere and gate reads must stay inside
// the tile.
struct Tab {
  const float* small;
  const float* sph;
  const float* g;
  int s0, c0, ts, tc;
  Layout L;
  __device__ __forceinline__ float s(int col, int i) const { return sph[col * ts + (i - s0)]; }
  __device__ __forceinline__ float w(int col, int i) const { return small[col * L.nw1 + i]; }
  __device__ __forceinline__ float b(int col, int i) const {
    return small[(L.box - L.wall) + col * L.nb1 + i];
  }
  __device__ __forceinline__ float pt(int col, int j) const {
    return small[(L.pt - L.wall) + col * L.np1 + j];
  }
  __device__ __forceinline__ float sun(int col, int j) const {
    return small[(L.sun - L.wall) + col * L.nu1 + j];
  }
  __device__ __forceinline__ float sky(int k) const { return small[(L.sky - L.wall) + k]; }
  __device__ __forceinline__ float tau() const { return small[L.tau - L.wall]; }
  __device__ __forceinline__ float tau_z() const { return small[L.tau_z - L.wall]; }
  __device__ __forceinline__ float gate(int row, int c) const { return g[row * tc + (c - c0)]; }
  // This view with tile `t` of the ring at `buf`.
  __device__ __forceinline__ Tab at(int t, const float* buf) const {
    Tab v = *this;
    v.c0 = t * tc; v.s0 = v.c0 * CHUNK; v.sph = buf; v.g = buf + N_SPH * ts;
    return v;
  }
};

// Copies the small table into `sm` (n_small floats); the caller syncs.
__device__ __forceinline__ Tab tab_small(const Layout& L, const float* g_tab, float* sm,
                                         int tile_c) {
  for (int j = threadIdx.x; j < L.n_small; j += blockDim.x) sm[j] = g_tab[L.wall + j];
  Tab T;
  T.small = sm; T.sph = nullptr; T.g = nullptr;
  T.s0 = 0; T.c0 = 0; T.tc = tile_c; T.ts = tile_c * CHUNK; T.L = L;
  return T;
}

// ---------------------------------------------------------------------------
// The sphere ring: tiles of whole chunks, copied with cp.async into two
// buffers, the next tile in flight while the block works on the current
// one. Position q of a block's sequence holds tile q % n_tiles in buffer
// q & 1; a scene of at most two tiles is copied once and stays.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues (and commits) the copy of tile t's sphere columns and gates into
// `buf`: 16-byte copies of the columns (n_s_pad and the tile are whole
// chunks of 8 floats, the table 16-byte aligned), 4-byte ones of the gates.
__device__ __forceinline__ void tile_issue(const Layout& L, const float* g_tab,
                                           const float* g_gate, int t, int tile_c, float* buf) {
  const int c0 = t * tile_c;
  const int nc = min(tile_c, L.n_chunks - c0);
  const int n4 = nc * (CHUNK / 4), ts = tile_c * CHUNK;
  for (int j = threadIdx.x; j < N_SPH * n4; j += blockDim.x) {
    const int col = j / n4, q = j - col * n4;
    cp_async16(buf + col * ts + 4 * q, g_tab + (size_t)col * L.n_s_pad + c0 * CHUNK + 4 * q);
  }
  float* gb = buf + N_SPH * ts;
  for (int j = threadIdx.x; j < N_GATE * nc; j += blockDim.x) {
    const int row = j / nc, q = j - row * nc;
    cp_async4(gb + row * tile_c + q, g_gate + (size_t)row * L.n_chunks + c0 + q);
  }
  cp_async_commit();
}

struct Ring {
  const float* g_tab;
  const float* g_gate;
  float* buf;  // two tiles of tile_floats(tile_c)
  int n_tiles, tile_c, q;
  bool resident;

  __device__ __forceinline__ float* slot(int k) const { return buf + k * tile_floats(tile_c); }

  // Starts the copies: the whole ring (at most two tiles, waited for here)
  // or the first tile. Every thread calls it; ends with a __syncthreads.
  __device__ __forceinline__ void start(const Layout& L) {
    q = 0;
    resident = n_tiles <= 2;
    for (int t = 0; t < (resident ? n_tiles : 1); ++t) tile_issue(L, g_tab, g_gate, t, tile_c, slot(t));
    if (resident) cp_async_wait<0>();
    __syncthreads();
  }

  // The buffer of the tile at the current position (tile q % n_tiles):
  // issues the next position's tile into the other buffer, waits for this
  // one. Every thread calls it; a streaming ring's ends with a
  // __syncthreads.
  __device__ __forceinline__ const float* acquire(const Layout& L) {
    if (resident) return slot(q % n_tiles);
    tile_issue(L, g_tab, g_gate, (q + 1) % n_tiles, tile_c, slot((q + 1) & 1));
    cp_async_wait<1>();
    __syncthreads();
    return slot(q & 1);
  }

  // Ends the current position: a streaming ring waits until every thread
  // is done reading its buffer (the next acquire refills it), unless the
  // caller has (`synced`: a __syncthreads since its last read).
  __device__ __forceinline__ void release(bool synced = false) {
    if (!resident && !synced) __syncthreads();
    ++q;
  }

  __device__ __forceinline__ void finish() { cp_async_wait<0>(); }
};

// ---------------------------------------------------------------------------
// Culling the chunks for a warp: one conservative test per chunk, from the
// bounds of the warp's rays, before each lane's exact gate.
// ---------------------------------------------------------------------------

// The warp's ray bounds into `wb` (N_BND floats of shared memory, the
// warp's own): min and max over its valid lanes of each origin and
// reciprocal-direction component, and a flag (not 0) if a valid lane has a
// component that is not finite. Every lane of the warp calls it; ends with
// a __syncwarp.
__device__ __forceinline__ void warp_bounds(bool valid, const float o[3], const float iv[3],
                                            float* wb) {
  bool bad = false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float lo = valid ? o[k] : INFINITY, hi = valid ? o[k] : -INFINITY;
    float ilo = valid ? iv[k] : INFINITY, ihi = valid ? iv[k] : -INFINITY;
    bad |= valid && !(isfinite(o[k]) && isfinite(iv[k]));
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(FULL, lo, off));
      hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, off));
      ilo = fminf(ilo, __shfl_xor_sync(FULL, ilo, off));
      ihi = fmaxf(ihi, __shfl_xor_sync(FULL, ihi, off));
    }
    if ((threadIdx.x & 31) == 0) {
      wb[k] = lo; wb[3 + k] = hi; wb[6 + k] = ilo; wb[9 + k] = ihi;
    }
  }
  const bool any_bad = __any_sync(FULL, bad);
  if ((threadIdx.x & 31) == 0) wb[12] = any_bad ? 1.0f : 0.0f;
  __syncwarp();
}

// Whether some ray of the warp may pass chunk c's box gate: the slab test
// of `chunk_reach` over the box of the warp's origins and reciprocal
// directions (`wb`). Float subtraction and multiplication round
// monotonically, so each lane's slab distance (g - o) iv lies between the
// products of the bounds' corners, and the test rejects no chunk whose
// exact gate a lane passes. A warp with a component that is not finite,
// or the bounding-sphere gate, rejects nothing but chunks of padding only.
__device__ __forceinline__ bool bounds_reach(const Tab& T, int c, const float* wb,
                                             float tau_eff) {
  if (T.gate(4, c) < 0.0f) return false;
  if (T.L.gate != GATE_AABB || wb[12] != 0.0f) return true;
  float tn = -INFINITY, tf = INFINITY;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float lo = INFINITY, hi = -INFINITY;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float g = T.gate(6 + 3 * e + k, c);
      const float a = g - wb[3 + k], b = g - wb[k];
      const float p0 = a * wb[6 + k], p1 = a * wb[9 + k];
      const float p2 = b * wb[6 + k], p3 = b * wb[9 + k];
      lo = fminf(lo, fminf(fminf(p0, p1), fminf(p2, p3)));
      hi = fmaxf(hi, fmaxf(fmaxf(p0, p1), fmaxf(p2, p3)));
    }
    tn = fmaxf(tn, lo);
    tf = fminf(tf, hi);
  }
  return !(tn > tf) && !(tf <= -T_MARGIN * tau_eff);
}

// The warp's mask of the 32 chunks from cw that its rays may reach: lane j
// tests chunk cw + j. Every lane of the warp calls it.
__device__ __forceinline__ unsigned warp_cull(const Tab& T, int cw, const float* wb,
                                              float tau_eff) {
  const int c = cw + (threadIdx.x & 31);
  return __ballot_sync(FULL, c < T.L.n_chunks && bounds_reach(T, c, wb, tau_eff));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Cotangent of x from that of y = sigmoid(x): c (1 - y) y, as PyTorch's.
__device__ __forceinline__ float sigmoid_bwd(float c, float y) { return c * (1.0f - y) * y; }

struct Ray {
  float o[3], d[3];
};

// Whether the ray's line can reach chunk c (cuda_soft.chunk_reachable):
// outside it every member's coverage is exactly 0.
__device__ __forceinline__ bool chunk_reach(const Tab& T, int c, const Ray& r, float oo,
                                            float dod, const float iv[3], float tau_eff) {
  if (T.L.gate == GATE_AABB) {
    float tl[3], th[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      tl[k] = (T.gate(6 + k, c) - r.o[k]) * iv[k];
      th[k] = (T.gate(9 + k, c) - r.o[k]) * iv[k];
    }
    const float tn = fmaxf(fmaxf(fminf(tl[0], th[0]), fminf(tl[1], th[1])), fminf(tl[2], th[2]));
    const float tf = fminf(fminf(fmaxf(tl[0], th[0]), fmaxf(tl[1], th[1])), fmaxf(tl[2], th[2]));
    return tn <= tf && tf > -T_MARGIN * tau_eff && T.gate(4, c) >= 0.0f;
  }
  const float gx = T.gate(0, c), gy = T.gate(1, c), gz = T.gate(2, c);
  const float s_g = r.d[0] * gx + r.d[1] * gy + r.d[2] * gz;
  const float ogc = r.o[0] * gx + r.o[1] * gy + r.o[2] * gz;
  const float tc = s_g - dod;
  const float dist2 = oo - 2.0f * ogc + T.gate(3, c) + tc * (2.0f * (dod - s_g) + tc);
  return dist2 <= T.gate(4, c) && tc + T.gate(5, c) > -T_MARGIN * tau_eff;
}

// A lane's mask of the chunks of `cull` (its warp's mask of the 32 chunks
// from cw) whose exact gate its ray passes.
__device__ __forceinline__ unsigned lane_mask(const Tab& T, unsigned cull, int cw, const Ray& r,
                                              float oo, float dod, const float iv[3],
                                              float tau_eff) {
  unsigned lm = 0;
  for (; cull; cull &= cull - 1) {
    const int b = __ffs(cull) - 1;
    if (chunk_reach(T, cw + b, r, oo, dod, iv, tau_eff)) lm |= 1u << b;
  }
  return lm;
}

// ---------------------------------------------------------------------------
// Coverage and soft hit of each kind, with what the adjoints need.
// ---------------------------------------------------------------------------

struct SphereHit {
  float oc[3], b_half, disc, sq, t, rc, den1, x1, a1, tc, x2, a2, alpha;
  float point[3], nv[3], n2, rs, n[3];
  bool pos;
};

// _sphere_alpha_t_scalar at sphere i.
__device__ __forceinline__ SphereHit sphere_hit(const Tab& T, int i, const Ray& r, float tau) {
  SphereHit h;
  const float c[3] = {T.s(0, i), T.s(1, i), T.s(2, i)}, rad = T.s(3, i);
#pragma unroll
  for (int k = 0; k < 3; ++k) h.oc[k] = r.o[k] - c[k];
  h.b_half = r.d[0] * h.oc[0] + r.d[1] * h.oc[1] + r.d[2] * h.oc[2];
  const float cc = (h.oc[0] * h.oc[0] + h.oc[1] * h.oc[1] + h.oc[2] * h.oc[2]) - rad * rad;
  h.disc = h.b_half * h.b_half - cc;
  h.pos = h.disc > 0.0f;
  h.sq = sqrtf(h.pos ? h.disc : 1.0f);
  h.t = -h.b_half - (h.pos ? h.sq : 0.0f);
  h.rc = fmaxf(rad, 1e-6f);
  h.den1 = tau * 2.0f * h.rc;
  h.x1 = h.disc / h.den1;
  h.a1 = sigmoid(h.x1);
  h.tc = fmaxf(tau, 1e-6f);
  h.x2 = h.t / h.tc;
  h.a2 = sigmoid(h.x2);
  h.alpha = h.a1 * h.a2;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    h.point[k] = r.o[k] + r.d[k] * h.t;
    h.nv[k] = h.point[k] - c[k];
  }
  h.n2 = h.nv[0] * h.nv[0] + h.nv[1] * h.nv[1] + h.nv[2] * h.nv[2];
  h.rs = rsqrtf(fmaxf(h.n2, 1e-12f));
#pragma unroll
  for (int k = 0; k < 3; ++k) h.n[k] = h.nv[k] * h.rs;
  return h;
}

struct WallHit {
  float nrm[3], denom, dd, num, t, point[3], rel[3], u, v;
  float x[5], s[5], p[5], alpha, okf, tc;
  bool ok;
};

// _wall_alpha_t_scalar at wall i (table columns: nx ny nz rx ry rz ux uy uz
// px py pz dplane length width).
__device__ __forceinline__ WallHit wall_hit(const Tab& T, int i, const Ray& r, float tau) {
  WallHit h;
#pragma unroll
  for (int k = 0; k < 3; ++k) h.nrm[k] = T.w(k, i);
  h.denom = r.d[0] * h.nrm[0] + r.d[1] * h.nrm[1] + r.d[2] * h.nrm[2];
  h.ok = fabsf(h.denom) > 1e-6f;
  h.dd = h.ok ? h.denom : 1.0f;
  h.num = T.w(12, i) - (r.o[0] * h.nrm[0] + r.o[1] * h.nrm[1] + r.o[2] * h.nrm[2]);
  h.t = h.num / h.dd;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    h.point[k] = r.o[k] + r.d[k] * h.t;
    h.rel[k] = h.point[k] - T.w(9 + k, i);
  }
  h.u = h.rel[0] * T.w(3, i) + h.rel[1] * T.w(4, i) + h.rel[2] * T.w(5, i);
  h.v = h.rel[0] * T.w(6, i) + h.rel[1] * T.w(7, i) + h.rel[2] * T.w(8, i);
  h.tc = fmaxf(tau, 1e-6f);
  h.x[0] = h.u / tau;
  h.x[1] = (T.w(13, i) - h.u) / tau;
  h.x[2] = h.v / tau;
  h.x[3] = (T.w(14, i) - h.v) / tau;
  h.x[4] = h.t / h.tc;
#pragma unroll
  for (int k = 0; k < 5; ++k) h.s[k] = sigmoid(h.x[k]);
  h.p[0] = h.s[0];  // running products: p[k] = s[0] ... s[k]
#pragma unroll
  for (int k = 1; k < 5; ++k) h.p[k] = h.p[k - 1] * h.s[k];
  h.okf = h.ok ? 1.0f : 0.0f;
  h.alpha = h.p[4] * h.okf;
  return h;
}

struct BoxHit {
  float iv[3], t1[3], t2[3], m[3], M[3], mxy, mnxy, tn, tf, tc, x1, a1, x2, a2, alpha;
  float point[3], n[3];
};

// _box_alpha_t_scalar at box i (table columns: min xyz, max xyz).
__device__ __forceinline__ BoxHit box_hit(const Tab& T, int i, const Ray& r, float tau) {
  BoxHit h;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    h.iv[k] = srecip(r.d[k]);
    h.t1[k] = (T.b(k, i) - r.o[k]) * h.iv[k];
    h.t2[k] = (T.b(3 + k, i) - r.o[k]) * h.iv[k];
    h.m[k] = fminf(h.t1[k], h.t2[k]);
    h.M[k] = fmaxf(h.t1[k], h.t2[k]);
  }
  h.mxy = fmaxf(h.m[0], h.m[1]);
  h.tn = fmaxf(h.mxy, h.m[2]);
  h.mnxy = fminf(h.M[0], h.M[1]);
  h.tf = fminf(h.mnxy, h.M[2]);
  h.tc = fmaxf(tau, 1e-6f);
  h.x1 = (h.tf - h.tn) / h.tc;
  h.a1 = sigmoid(h.x1);
  h.x2 = h.tn / h.tc;
  h.a2 = sigmoid(h.x2);
  h.alpha = h.a1 * h.a2;
  float tf3[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    h.point[k] = r.o[k] + r.d[k] * h.tn;
    tf3[k] = ((r.d[k] >= 0.0f ? T.b(k, i) : T.b(3 + k, i)) - r.o[k]) * h.iv[k];
  }
  const bool bx = tf3[0] >= tf3[1] && tf3[0] >= tf3[2];
  const bool by = !bx && tf3[1] >= tf3[2];
  const bool bz = !bx && !by;
  h.n[0] = bx ? -sgn(r.d[0]) : 0.0f;
  h.n[1] = by ? -sgn(r.d[1]) : 0.0f;
  h.n[2] = bz ? -sgn(r.d[2]) : 0.0f;
  return h;
}

// Material scalars: colour rgb, ambient, diffuse, specular, exponent,
// metallic (the table's column order after the geometry).
struct Mat {
  float col[3], amb, kd, ks, ex, met;
};

__device__ __forceinline__ Mat sphere_mat(const Tab& T, int i) {
  return Mat{{T.s(4, i), T.s(5, i), T.s(6, i)}, T.s(7, i), T.s(8, i), T.s(9, i),
             T.s(10, i), T.s(11, i)};
}
__device__ __forceinline__ Mat wall_mat(const Tab& T, int i) {
  return Mat{{T.w(15, i), T.w(16, i), T.w(17, i)}, T.w(18, i), T.w(19, i), T.w(20, i),
             T.w(21, i), T.w(22, i)};
}
__device__ __forceinline__ Mat box_mat(const Tab& T, int i) {
  return Mat{{T.b(6, i), T.b(7, i), T.b(8, i)}, T.b(9, i), T.b(10, i), T.b(11, i),
             T.b(12, i), T.b(13, i)};
}

// ---------------------------------------------------------------------------
// Shading: Blinn-Phong at a soft hit point (_shade_point_scalar).
// ---------------------------------------------------------------------------

// _light_terms of the soft path: the half vector is scaled before its dot
// with the normal. Fills trace_common.cuh's Lobes (hvdn = hv . n for the
// adjoint), whose `lobes_bwd` is the adjoint.
__device__ __forceinline__ Lobes soft_lobes(const float l[3], const float vw[3],
                                            const float n[3], const Mat& m) {
  Lobes f;
  f.ldn = l[0] * n[0] + l[1] * n[1] + l[2] * n[2];
  f.diffuse = fmaxf(f.ldn, 0.0f);
  f.hvx = vw[0] + l[0]; f.hvy = vw[1] + l[1]; f.hvz = vw[2] + l[2];
  f.n2 = f.hvx * f.hvx + f.hvy * f.hvy + f.hvz * f.hvz;
  f.hsc = rsqrtf(f.n2 > 1e-12f ? f.n2 : 1.0f);
  f.base = fmaxf((f.hvx * f.hsc) * n[0] + (f.hvy * f.hsc) * n[1] + (f.hvz * f.hsc) * n[2], 0.0f);
  f.hvdn = f.hvx * n[0] + f.hvy * n[1] + f.hvz * n[2];
  f.spec = f.base > 0.0f ? expf(m.ex * logf(f.base)) : 0.0f;
  f.term = f.diffuse * m.kd + f.spec * m.ks;
  return f;
}

// A point light's unit direction from the hit point: l = lv rsqrt(max(|lv|^2, 1e-12)).
struct PointDir {
  float lv[3], ln2, lr, l[3];
};

__device__ __forceinline__ PointDir point_dir(const Tab& T, int j, const float p[3]) {
  PointDir q;
#pragma unroll
  for (int k = 0; k < 3; ++k) q.lv[k] = T.pt(k, j) - p[k];
  q.ln2 = q.lv[0] * q.lv[0] + q.lv[1] * q.lv[1] + q.lv[2] * q.lv[2];
  q.lr = rsqrtf(fmaxf(q.ln2, 1e-12f));
#pragma unroll
  for (int k = 0; k < 3; ++k) q.l[k] = q.lv[k] * q.lr;
  return q;
}

// The light sums I (rgb) at a hit point with normal n, seen along d.
__device__ __forceinline__ void light_sums(const Tab& T, const float p[3], const float n[3],
                                           const float d[3], const Mat& m, float I[3]) {
  const float vw[3] = {-d[0], -d[1], -d[2]};
  I[0] = I[1] = I[2] = 0.0f;
  for (int j = 0; j < T.L.n_pt; ++j) {
    const PointDir q = point_dir(T, j, p);
    const float term = soft_lobes(q.l, vw, n, m).term;
#pragma unroll
    for (int k = 0; k < 3; ++k) I[k] = I[k] + T.pt(3 + k, j) * term;
  }
  for (int j = 0; j < T.L.n_sun; ++j) {
    const float l[3] = {T.sun(0, j), T.sun(1, j), T.sun(2, j)};
    const float term = soft_lobes(l, vw, n, m).term;
#pragma unroll
    for (int k = 0; k < 3; ++k) I[k] = I[k] + T.sun(3 + k, j) * term;
  }
}

// ---------------------------------------------------------------------------
// The composite carry: s, the payload sums (13, or 3 at the last level),
// the log-transmittance.
// ---------------------------------------------------------------------------

template <bool LAST>
struct NCarry {
  static constexpr int value = LAST ? 5 : 15;
};

// One primitive's contribution added into the carry (_contrib_of).
template <bool LAST>
__device__ __forceinline__ void add_contrib(float* carry, float alpha, float t, const float p[3],
                                            const float n[3], const float col[3], float met,
                                            float t_ref, float tau_z) {
  const float e = alpha * expf(-fmaxf(t - t_ref, 0.0f) / tau_z);
  carry[0] = carry[0] + e;
#pragma unroll
  for (int k = 0; k < 3; ++k) carry[1 + k] = carry[1 + k] + col[k] * e;
  if (!LAST) {
#pragma unroll
    for (int k = 0; k < 3; ++k) carry[4 + k] = carry[4 + k] + (col[k] * met) * e;
    carry[7] = carry[7] + met * e;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      carry[8 + k] = carry[8 + k] + p[k] * e;
      carry[11 + k] = carry[11 + k] + n[k] * e;
    }
  }
  constexpr int NC = NCarry<LAST>::value;
  carry[NC - 1] = carry[NC - 1] + log1pf(-fminf(alpha, ALPHA_MAX));
}

__device__ __forceinline__ void shade(const Tab& T, const float p[3], const float n[3],
                                      const float d[3], const Mat& m, float col[3]) {
  float I[3];
  light_sums(T, p, n, d, m, I);
#pragma unroll
  for (int k = 0; k < 3; ++k) col[k] = m.col[k] * (I[k] + m.amb);
}

// The sky colour seen along d, and grad = z^exponent (z > 0).
__device__ __forceinline__ void sky_of(const Tab& T, const float d[3], float sk[3], float& grad) {
  const float z = d[2];
  grad = z > 0.0f ? expf(T.sky(9) * logf(z)) : 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    sk[k] = z < 0.0f ? T.sky(6 + k) : T.sky(k) + (T.sky(3 + k) - T.sky(k)) * grad;
}

// ---------------------------------------------------------------------------
// Adjoints. The cotangents of the lights, tau and tau_z go into a lane's own
// row `lt` of shared memory, stride `ls` (LtRow); those of the table's other
// entries are returned to the caller.
// ---------------------------------------------------------------------------

// Reduce-scatter of each lane's 12 values over the warp: lanes 2k and
// 2k + 1 (k < 12) get the warp's sum of value k. The 16 slots (the last 4
// zero) are halved over lane bits 4, 3, 2 and 1, a shuffle a kept pair at
// each step, then summed over bit 0: 16 shuffles where 12 butterflies take
// 60. Every lane must call it.
__device__ __forceinline__ float warp_scatter12(const float v[12], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float a[8], b[4], c[2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float lo = v[j], hi = j + 8 < 12 ? v[j + 8] : 0.0f;
    a[j] = (b4 ? hi : lo) + __shfl_xor_sync(FULL, b4 ? lo : hi, 16);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = (b3 ? a[j + 4] : a[j]) + __shfl_xor_sync(FULL, b3 ? a[j] : a[j + 4], 8);
#pragma unroll
  for (int j = 0; j < 2; ++j) c[j] = (b2 ? b[j + 2] : b[j]) + __shfl_xor_sync(FULL, b2 ? b[j] : b[j + 2], 4);
  float d = (b1 ? c[1] : c[0]) + __shfl_xor_sync(FULL, b1 ? c[0] : c[1], 2);
  return d + __shfl_xor_sync(FULL, d, 1);
}

// A lane's private accumulators of the light, tau and tau_z cotangents:
// 6 per point light (position xyz, colour rgb), 6 per sun (unit direction
// xyz, colour rgb), tau, tau_z.
struct LtRow {
  float* p;
  int stride;
  __device__ __forceinline__ void add(int j, float v) const { p[j * stride] += v; }
};

__host__ __device__ __forceinline__ int lt_tau(const Layout& L) { return 6 * (L.n_pt + L.n_sun); }

// Cotangents of a primitive's contribution (adjoint of add_contrib): from
// the carry cotangent g, those of its coverage, t, hit point, normal,
// colour and metallic, and of tau_z.
struct ContribCt {
  float alpha, t, p[3], n[3], col[3], met;
};

template <bool LAST>
__device__ __forceinline__ ContribCt contrib_bwd(const float* g, float alpha, float t,
                                                 const float p[3], const float n[3],
                                                 const float col[3], float met, float t_ref,
                                                 float tau_z, const LtRow& lt, const Layout& L) {
  constexpr int NC = NCarry<LAST>::value;
  ContribCt c;
  const float dt = t - t_ref;
  const float u = -fmaxf(dt, 0.0f) / tau_z;
  const float E = expf(u);
  const float e = alpha * E;
  float c_e = g[0];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c_e += g[1 + k] * col[k];
    c.col[k] = g[1 + k] * e;
  }
  c.met = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) c.p[k] = c.n[k] = 0.0f;
  if (!LAST) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float cq = g[4 + k] * e;  // (col met) e
      c_e += g[4 + k] * (col[k] * met);
      c.col[k] += cq * met;
      c.met += cq * col[k];
    }
    c_e += g[7] * met;
    c.met += g[7] * e;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c_e += g[8 + k] * p[k] + g[11 + k] * n[k];
      c.p[k] = g[8 + k] * e;
      c.n[k] = g[11 + k] * e;
    }
  }
  // lt = log1p(-min(alpha, ALPHA_MAX))
  const float am = fminf(alpha, ALPHA_MAX);
  c.alpha = (-g[NC - 1] / (1.0f + -am)) * wmin(alpha, ALPHA_MAX);
  // e = alpha E, E = exp(u), u = -max(dt, 0) / tau_z
  c.alpha += c_e * E;
  const float c_u = c_e * alpha * E;
  lt.add(lt_tau(L) + 1, -c_u * u / tau_z);
  c.t = (-c_u / tau_z) * wmax(dt, 0.0f);
  return c;
}

// Adjoint of shade: from the colour's cotangent c_col, adds to the
// cotangents of the hit point (cp), the normal (cn), the direction (cd)
// and the material (cm: colour rgb, amb, kd, ks, exponent), and the lights'
// to `lt`.
__device__ __forceinline__ void shade_bwd(const Tab& T, const float p[3], const float n[3],
                                          const float d[3], const Mat& m, const float c_col[3],
                                          float cp[3], float cn[3], float cd[3], float cm[7],
                                          const LtRow& lt) {
  float I[3];
  light_sums(T, p, n, d, m, I);
  float cI[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    cm[k] += c_col[k] * (I[k] + m.amb);
    cI[k] = c_col[k] * m.col[k];
    cm[3] += cI[k];
  }
  const float vw[3] = {-d[0], -d[1], -d[2]};
  float cvw[3] = {0.0f, 0.0f, 0.0f};
  for (int j = 0; j < T.L.n_pt; ++j) {
    const PointDir q = point_dir(T, j, p);
    const Lobes f = soft_lobes(q.l, vw, n, m);
#pragma unroll
    for (int k = 0; k < 3; ++k) lt.add(6 * j + 3 + k, cI[k] * f.term);
    const float c_term = cI[0] * T.pt(3, j) + cI[1] * T.pt(4, j) + cI[2] * T.pt(5, j);
    float cl[3] = {0.0f, 0.0f, 0.0f};
    lobes_bwd(f, c_term, q.l[0], q.l[1], q.l[2], n[0], n[1], n[2], m.kd, m.ks, m.ex, cl, cn,
              cvw, cm[4], cm[5], cm[6]);
    // l = lv * lr, lr = rsqrt(max(ln2, 1e-12)), ln2 = lv . lv, lv = light - p
    const float c_lr = cl[0] * q.lv[0] + cl[1] * q.lv[1] + cl[2] * q.lv[2];
    const float c_ln2 = c_lr * (-0.5f * (q.lr * q.lr * q.lr)) * wmax(q.ln2, 1e-12f);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float c_lv = cl[k] * q.lr + 2.0f * c_ln2 * q.lv[k];
      lt.add(6 * j + k, c_lv);
      cp[k] -= c_lv;
    }
  }
  const int su = 6 * T.L.n_pt;
  for (int j = 0; j < T.L.n_sun; ++j) {
    const float l[3] = {T.sun(0, j), T.sun(1, j), T.sun(2, j)};
    const Lobes f = soft_lobes(l, vw, n, m);
#pragma unroll
    for (int k = 0; k < 3; ++k) lt.add(su + 6 * j + 3 + k, cI[k] * f.term);
    const float c_term = cI[0] * T.sun(3, j) + cI[1] * T.sun(4, j) + cI[2] * T.sun(5, j);
    float cl[3] = {0.0f, 0.0f, 0.0f};
    lobes_bwd(f, c_term, l[0], l[1], l[2], n[0], n[1], n[2], m.kd, m.ks, m.ex, cl, cn, cvw,
              cm[4], cm[5], cm[6]);
#pragma unroll
    for (int k = 0; k < 3; ++k) lt.add(su + 6 * j + k, cl[k]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) cd[k] -= cvw[k];  // view = -d
}

// Adjoint of sphere i's contribution. Adds to the ray's cotangents (co,
// cd) and writes the sphere's 12 (cs: cx cy cz r colr colg colb amb kd ks
// exp met).
template <bool LAST>
__device__ __forceinline__ void sphere_bwd(const Tab& T, int i, const Ray& r, float t_ref,
                                           const float* g, float co[3], float cd[3],
                                           float cs[12], const LtRow& lt) {
  const float tau = T.tau();
  const SphereHit h = sphere_hit(T, i, r, tau);
  const Mat m = sphere_mat(T, i);
  float col[3];
  shade(T, h.point, h.n, r.d, m, col);
  const ContribCt c = contrib_bwd<LAST>(g, h.alpha, h.t, h.point, h.n, col, m.met, t_ref,
                                        T.tau_z(), lt, T.L);
  float cm[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float cp[3] = {c.p[0], c.p[1], c.p[2]}, cn[3] = {c.n[0], c.n[1], c.n[2]};
  shade_bwd(T, h.point, h.n, r.d, m, c.col, cp, cn, cd, cm, lt);
  // n = nv rs, rs = rsqrt(max(n2, 1e-12)), nv = point - centre
  const float c_rs = cn[0] * h.nv[0] + cn[1] * h.nv[1] + cn[2] * h.nv[2];
  const float c_n2 = c_rs * (-0.5f * (h.rs * h.rs * h.rs)) * wmax(h.n2, 1e-12f);
  float c_c[3], c_t = c.t;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float c_nv = cn[k] * h.rs + 2.0f * c_n2 * h.nv[k];
    cp[k] += c_nv;
    c_c[k] = -c_nv;
    // point = o + d t
    co[k] += cp[k];
    cd[k] += cp[k] * h.t;
    c_t += cp[k] * r.d[k];
  }
  // alpha = a1 a2, a2 = sigmoid(t / tc), a1 = sigmoid(disc / den1)
  const float c_x2 = sigmoid_bwd(c.alpha * h.a1, h.a2);
  const float c_x1 = sigmoid_bwd(c.alpha * h.a2, h.a1);
  c_t += c_x2 / h.tc;
  float c_tau = -c_x2 * h.x2 / h.tc * wmax(tau, 1e-6f);
  float c_disc = c_x1 / h.den1;
  const float c_den1 = -c_x1 * h.x1 / h.den1;
  c_tau += c_den1 * h.rc * 2.0f;  // den1 = (tau 2) rc
  const float rad = T.s(3, i);
  float c_r = c_den1 * (tau * 2.0f) * wmax(rad, 1e-6f);
  // t = -b_half - sqrt(disc) (pos), disc = b_half^2 - cc, cc = oc.oc - r^2
  float c_bh = -c_t;
  if (h.pos) c_disc += -c_t * (0.5f / h.sq);
  c_bh += 2.0f * h.b_half * c_disc;
  const float c_cc = -c_disc;
  c_r += -2.0f * c_cc * rad;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float c_oc = 2.0f * c_cc * h.oc[k] + c_bh * r.d[k];
    cd[k] += c_bh * h.oc[k];
    co[k] += c_oc;
    c_c[k] -= c_oc;
    cs[k] = c_c[k];
  }
  lt.add(lt_tau(T.L), c_tau);
  cs[3] = c_r;
#pragma unroll
  for (int k = 0; k < 7; ++k) cs[4 + k] = cm[k];
  cs[11] = c.met;
}

// Adjoint of wall i's contribution; writes its 23 table cotangents (cw).
template <bool LAST>
__device__ __forceinline__ void wall_bwd(const Tab& T, int i, const Ray& r, float t_ref,
                                         const float* g, float co[3], float cd[3],
                                         float cw[N_WALL], const LtRow& lt) {
  const float tau = T.tau();
  const WallHit h = wall_hit(T, i, r, tau);
  const Mat m = wall_mat(T, i);
  float col[3];
  shade(T, h.point, h.nrm, r.d, m, col);
  const ContribCt c = contrib_bwd<LAST>(g, h.alpha, h.t, h.point, h.nrm, col, m.met, t_ref,
                                        T.tau_z(), lt, T.L);
  float cm[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float cp[3] = {c.p[0], c.p[1], c.p[2]}, cn[3] = {c.n[0], c.n[1], c.n[2]};
  shade_bwd(T, h.point, h.nrm, r.d, m, c.col, cp, cn, cd, cm, lt);
#pragma unroll
  for (int k = 0; k < N_WALL; ++k) cw[k] = 0.0f;
  // alpha = s0 s1 s2 s3 s4 ok (left to right)
  float cP = c.alpha * h.okf, cs[5];
#pragma unroll
  for (int k = 4; k >= 1; --k) {
    cs[k] = cP * h.p[k - 1];
    cP = cP * h.s[k];
  }
  cs[0] = cP;
  float c_u = 0.0f, c_v = 0.0f, c_tau = 0.0f, c_t = c.t;
  float cx[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) cx[k] = sigmoid_bwd(cs[k], h.s[k]);
  // x0 = u / tau, x1 = (length - u) / tau, x2 = v / tau, x3 = (width - v) / tau
  c_u += cx[0] / tau - cx[1] / tau;
  c_v += cx[2] / tau - cx[3] / tau;
  cw[13] += cx[1] / tau;
  cw[14] += cx[3] / tau;
#pragma unroll
  for (int k = 0; k < 4; ++k) c_tau -= cx[k] * h.x[k] / tau;
  // x4 = t / max(tau, 1e-6)
  c_t += cx[4] / h.tc;
  c_tau += -cx[4] * h.x[4] / h.tc * wmax(tau, 1e-6f);
  lt.add(lt_tau(T.L), c_tau);
  // u = rel . right, v = rel . up, rel = point - corner
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float c_rel = c_u * T.w(3 + k, i) + c_v * T.w(6 + k, i);
    cw[3 + k] += c_u * h.rel[k];
    cw[6 + k] += c_v * h.rel[k];
    cp[k] += c_rel;
    cw[9 + k] -= c_rel;
    // point = o + d t
    co[k] += cp[k];
    cd[k] += cp[k] * h.t;
    c_t += cp[k] * r.d[k];
  }
  // t = num / dd; num = dplane - o . n; dd = d . n where |d . n| > 1e-6
  const float c_num = c_t / h.dd;
  const float c_den = h.ok ? -c_t * h.t / h.dd : 0.0f;
  cw[12] += c_num;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    co[k] -= c_num * h.nrm[k];
    cd[k] += c_den * h.nrm[k];
    cw[k] += cn[k] - c_num * r.o[k] + c_den * r.d[k];
  }
#pragma unroll
  for (int k = 0; k < 7; ++k) cw[15 + k] = cm[k];
  cw[22] = c.met;
}

// Adjoint of box i's contribution; writes its 14 table cotangents (cb).
template <bool LAST>
__device__ __forceinline__ void box_bwd(const Tab& T, int i, const Ray& r, float t_ref,
                                        const float* g, float co[3], float cd[3],
                                        float cb[N_BOX], const LtRow& lt) {
  const float tau = T.tau();
  const BoxHit h = box_hit(T, i, r, tau);
  const Mat m = box_mat(T, i);
  float col[3];
  shade(T, h.point, h.n, r.d, m, col);
  const ContribCt c = contrib_bwd<LAST>(g, h.alpha, h.tn, h.point, h.n, col, m.met, t_ref,
                                        T.tau_z(), lt, T.L);
  float cm[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float cp[3] = {c.p[0], c.p[1], c.p[2]}, cn[3] = {0.0f, 0.0f, 0.0f};
  shade_bwd(T, h.point, h.n, r.d, m, c.col, cp, cn, cd, cm, lt);  // the face normal: constant
  // alpha = a1 a2, a1 = sigmoid((tf - tn) / tc), a2 = sigmoid(tn / tc)
  const float c_x1 = sigmoid_bwd(c.alpha * h.a2, h.a1);
  const float c_x2 = sigmoid_bwd(c.alpha * h.a1, h.a2);
  float c_tn = c.t - c_x1 / h.tc + c_x2 / h.tc;
  const float c_tf = c_x1 / h.tc;
  const float c_tc = -c_x1 * h.x1 / h.tc - c_x2 * h.x2 / h.tc;
  lt.add(lt_tau(T.L), c_tc * wmax(tau, 1e-6f));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    co[k] += cp[k];
    cd[k] += cp[k] * h.tn;
    c_tn += cp[k] * r.d[k];
  }
  // tn = max(max(m0, m1), m2), tf = min(min(M0, M1), M2)
  const float c_mxy = c_tn * wmax(h.mxy, h.m[2]);
  const float c_m[3] = {c_mxy * wmax(h.m[0], h.m[1]), c_mxy * wmax(h.m[1], h.m[0]),
                        c_tn * wmax(h.m[2], h.mxy)};
  const float c_mn = c_tf * wmin(h.mnxy, h.M[2]);
  const float c_M[3] = {c_mn * wmin(h.M[0], h.M[1]), c_mn * wmin(h.M[1], h.M[0]),
                        c_tf * wmin(h.M[2], h.mnxy)};
#pragma unroll
  for (int k = 0; k < N_BOX; ++k) cb[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float c_t1 = c_m[k] * wmin(h.t1[k], h.t2[k]) + c_M[k] * wmax(h.t1[k], h.t2[k]);
    const float c_t2 = c_m[k] * wmin(h.t2[k], h.t1[k]) + c_M[k] * wmax(h.t2[k], h.t1[k]);
    // t1 = (min corner - o) iv, t2 = (max corner - o) iv, iv = srecip(d)
    cb[k] = c_t1 * h.iv[k];
    cb[3 + k] = c_t2 * h.iv[k];
    co[k] -= c_t1 * h.iv[k] + c_t2 * h.iv[k];
    const float c_iv = c_t1 * (T.b(k, i) - r.o[k]) + c_t2 * (T.b(3 + k, i) - r.o[k]);
    if (fabsf(r.d[k]) > 1e-12f) cd[k] -= c_iv * (h.iv[k] * h.iv[k]);
  }
#pragma unroll
  for (int k = 0; k < 7; ++k) cb[6 + k] = cm[k];
  cb[13] = c.met;
}

// ---------------------------------------------------------------------------
// The composite's tail (_soft_post): normalise, blend over the sky, and
// before the last level mirror the ray about the expected surface.
// ---------------------------------------------------------------------------

struct Post {
  float cov, inv_s, sk[3], grad, loc[3];
  // before the last level: the expected surface and the reflected ray
  float m_hat, p_hat[3], nv[3], n2, rs, nh[3], off, dn, ro[3], rd[3], w_next;
};

template <bool LAST>
__device__ __forceinline__ Post post(const Tab& T, const float* carry, const Ray& r, float w) {
  constexpr int NC = NCarry<LAST>::value;
  Post q;
  q.cov = 1.0f - expf(carry[NC - 1]);
  q.inv_s = 1.0f / fmaxf(carry[0], 1e-12f);
  sky_of(T, r.d, q.sk, q.grad);
  if (LAST) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      q.loc[k] = carry[1 + k] * q.inv_s * q.cov + q.sk[k] * (1.0f - q.cov);
    q.w_next = w * 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) { q.ro[k] = r.o[k]; q.rd[k] = r.d[k]; }
    return q;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
    q.loc[k] = (carry[1 + k] - carry[4 + k]) * q.inv_s * q.cov + q.sk[k] * (1.0f - q.cov);
  q.m_hat = carry[7] * q.inv_s;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    q.p_hat[k] = carry[8 + k] * q.inv_s;
    q.nv[k] = carry[11 + k] * q.inv_s;
  }
  q.n2 = q.nv[0] * q.nv[0] + q.nv[1] * q.nv[1] + q.nv[2] * q.nv[2];
  q.rs = rsqrtf(fmaxf(q.n2, 1e-12f));
#pragma unroll
  for (int k = 0; k < 3; ++k) q.nh[k] = q.nv[k] * q.rs;
  q.off = fmaxf(6.0f * T.tau(), REFLECT_EPS);
  q.dn = r.d[0] * q.nh[0] + r.d[1] * q.nh[1] + r.d[2] * q.nh[2];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    q.ro[k] = q.p_hat[k] + q.nh[k] * q.off;
    q.rd[k] = r.d[k] - q.nh[k] * (2.0f * q.dn);
  }
  q.w_next = w * (q.m_hat * q.cov);
  return q;
}

// Adjoint of post. In: the image cotangent ca (of w loc), those of the next
// throughput (cwn) and ray (cno, cnd). Out: the carry's cotangent g, added
// to the ray's (co, cd) and the throughput's (cw), the 10 sky scalars' in
// csky; tau's goes to `lt`.
template <bool LAST>
__device__ __forceinline__ void post_bwd(const Tab& T, const float* carry, const Ray& r, float w,
                                         const float ca[3], float cwn, const float cno[3],
                                         const float cnd[3], float* g, float co[3],
                                         float cd[3], float& cw, float csky[10],
                                         const LtRow& lt) {
  constexpr int NC = NCarry<LAST>::value;
  const Post q = post<LAST>(T, carry, r, w);
#pragma unroll
  for (int j = 0; j < NC; ++j) g[j] = 0.0f;
  float c_cov = 0.0f, c_inv = 0.0f, c_sk[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    // w loc; loc = (D inv_s) cov + sk (1 - cov), D = C (last) or C - M
    cw += ca[k] * q.loc[k];
    const float c_loc = ca[k] * w;
    const float D = LAST ? carry[1 + k] : carry[1 + k] - carry[4 + k];
    const float c_di = c_loc * q.cov;
    c_cov += c_loc * (D * q.inv_s) - c_loc * q.sk[k];
    c_sk[k] = c_loc * (1.0f - q.cov);
    const float c_D = c_di * q.inv_s;
    c_inv += c_di * D;
    g[1 + k] = c_D;
    if (!LAST) g[4 + k] = -c_D;
  }
  if (LAST) {
#pragma unroll
    for (int k = 0; k < 3; ++k) { co[k] += cno[k]; cd[k] += cnd[k]; }
  } else {
    // w_next = w (m_hat cov), m_hat = M inv_s
    cw += cwn * (q.m_hat * q.cov);
    const float c_mc = cwn * w;
    const float c_mh = c_mc * q.cov;
    c_cov += c_mc * q.m_hat;
    g[7] = c_mh * q.inv_s;
    c_inv += c_mh * carry[7];
    // ro = p_hat + nh off, off = max(6 tau, 1e-4); rd = d - nh (2 dn), dn = d . nh
    float c_nh[3], c_off = 0.0f, c_dn = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c_off += cno[k] * q.nh[k];
      c_nh[k] = cno[k] * q.off - cnd[k] * (2.0f * q.dn);
      c_dn -= 2.0f * (cnd[k] * q.nh[k]);
      cd[k] += cnd[k];
    }
    lt.add(lt_tau(T.L), c_off * 6.0f * wmax(6.0f * T.tau(), REFLECT_EPS));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      cd[k] += c_dn * q.nh[k];
      c_nh[k] += c_dn * r.d[k];
    }
    // nh = nv rs, rs = rsqrt(max(n2, 1e-12)), nv = N inv_s; p_hat = P inv_s
    const float c_rs = c_nh[0] * q.nv[0] + c_nh[1] * q.nv[1] + c_nh[2] * q.nv[2];
    const float c_n2 = c_rs * (-0.5f * (q.rs * q.rs * q.rs)) * wmax(q.n2, 1e-12f);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float c_nv = c_nh[k] * q.rs + 2.0f * c_n2 * q.nv[k];
      g[11 + k] = c_nv * q.inv_s;
      c_inv += c_nv * carry[11 + k];
      g[8 + k] = cno[k] * q.inv_s;
      c_inv += cno[k] * carry[8 + k];
    }
  }
  // inv_s = 1 / max(s, 1e-12); cov = 1 - exp(lt)
  g[0] = -c_inv * (q.inv_s * q.inv_s) * wmax(carry[0], 1e-12f);
  g[NC - 1] = -c_cov * expf(carry[NC - 1]);
  // sky: ground below the horizon, lerp(horizon, zenith, z^e) above
  const float z = r.d[2];
  float c_grad = 0.0f;
#pragma unroll
  for (int j = 0; j < 10; ++j) csky[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (z < 0.0f) {
      csky[6 + k] = c_sk[k];
    } else {
      csky[k] = c_sk[k] - c_sk[k] * q.grad;
      csky[3 + k] = c_sk[k] * q.grad;
      c_grad += c_sk[k] * (T.sky(3 + k) - T.sky(k));
    }
  }
  if (z > 0.0f) {
    const float ce = c_grad * q.grad;
    csky[9] = ce * logf(z);
    cd[2] += ce * T.sky(9) / z;
  }
}

}  // namespace soft
}  // namespace rt
