// Device code shared by the trace kernels: the packed scene table's layout,
// the closest-hit fold (walls, boxes, gated sphere chunks), one level's
// shading and bounce, the per-tile reach statistics of the per-level chain,
// and the adjoint of one level.
//
// Included by trace_whole.cu, trace_whole_bwd.cu, ray_stats.cu,
// trace_level.cu and trace_level_bwd.cu; ops/_build.py keys each library on
// its .cu and the headers it includes. Every function follows the plain
// PyTorch version in raytracer_tpu_torch/ops/cuda_fold.py op for op: build
// with -fmad=false and without fast math, so each product and sum rounds once
// as a separate PyTorch op does, and a sphere miss is rejected through the
// NaN compare of `tt > 0`.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr float MISS_T = 1e30f;
constexpr float REFLECT_EPS = 1e-4f;
constexpr float BIG = 1e30f;
constexpr int GATE_AABB = 0;
constexpr unsigned FULL = 0xffffffffu;

// Offsets (in floats) of each group of the packed table. Mirrors _LAYOUT in
// raytracer_tpu_torch/ops/cuda_fold.py: each group is a run of columns, each
// column one value per item.
struct Layout {
  int n_s, unroll, n_c, n_w, n_b, n_pt, n_sun, gate, depth;
  int sph, wall, box, mat, chunk, slab, pt, sun, sky, n_tab;
};

inline Layout make_layout(int n_s, int unroll, int n_w, int n_b, int n_pt,
                          int n_sun, int gate, int depth) {
  Layout L;
  L.n_s = n_s; L.unroll = unroll; L.n_w = n_w; L.n_b = n_b;
  L.n_pt = n_pt; L.n_sun = n_sun; L.gate = gate; L.depth = depth;
  L.n_c = n_s ? (n_s + unroll - 1) / unroll : 0;
  L.sph = 0;
  L.wall = L.sph + 5 * n_s;
  L.box = L.wall + 15 * n_w;
  L.mat = L.box + 6 * n_b;
  L.chunk = L.mat + 8 * (n_s + n_w + n_b);
  L.slab = L.chunk + 11 * L.n_c;
  L.pt = L.slab + 6;
  L.sun = L.pt + 6 * n_pt;
  L.sky = L.sun + 6 * n_sun;
  L.n_tab = L.sky + 10;
  return L;
}

// Floats of the table without its material group: what the per-level
// kernels keep in shared memory (they read the materials, one winner per
// lane, from device memory).
__host__ __device__ inline int fold_floats(const Layout& L) { return L.n_tab - (L.chunk - L.mat); }

// A view of the packed table, whose groups may lie in shared or in device
// memory.
struct Tab {
  const float *S, *Wt, *B, *M, *C, *slab, *P, *U, *sky;
  int n_s, n_w, n_b, n_c, n_prim, unroll, gate, n_pt, n_sun;
  __device__ __forceinline__ float sc(int col, int i) const { return S[col * n_s + i]; }
  __device__ __forceinline__ float wc(int col, int i) const { return Wt[col * n_w + i]; }
  __device__ __forceinline__ float bc(int col, int i) const { return B[col * n_b + i]; }
  __device__ __forceinline__ float mc(int col, int i) const { return M[col * n_prim + i]; }
  __device__ __forceinline__ float cc(int col, int i) const { return C[col * n_c + i]; }
};

__device__ __forceinline__ Tab tab_counts(const Layout& L) {
  Tab T;
  T.n_s = L.n_s; T.n_w = L.n_w; T.n_b = L.n_b; T.n_c = L.n_c;
  T.n_prim = L.n_s + L.n_w + L.n_b; T.unroll = L.unroll; T.gate = L.gate;
  T.n_pt = L.n_pt; T.n_sun = L.n_sun;
  return T;
}

// The whole table at `tab` (shared or device memory).
__device__ __forceinline__ Tab tab_whole(const Layout& L, const float* tab) {
  Tab T = tab_counts(L);
  T.S = tab + L.sph; T.Wt = tab + L.wall; T.B = tab + L.box; T.M = tab + L.mat;
  T.C = tab + L.chunk; T.slab = tab + L.slab; T.P = tab + L.pt;
  T.U = tab + L.sun; T.sky = tab + L.sky;
  return T;
}

// Copies the table without its material group into `sm` (fold_floats(L)
// floats); the view reads the materials from `g_tab`. Ends with a
// __syncthreads.
__device__ __forceinline__ Tab tab_fold_shared(const Layout& L, const float* g_tab, float* sm) {
  const int gap = L.chunk - L.mat, n = L.n_tab - gap;
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    sm[j] = g_tab[j < L.mat ? j : j + gap];
  __syncthreads();
  Tab T = tab_counts(L);
  T.S = sm + L.sph; T.Wt = sm + L.wall; T.B = sm + L.box; T.M = g_tab + L.mat;
  T.C = sm + L.chunk - gap; T.slab = sm + L.slab - gap; T.P = sm + L.pt - gap;
  T.U = sm + L.sun - gap; T.sky = sm + L.sky - gap;
  return T;
}

// The grid of a kernel that walks `n_items` work items with a grid stride:
// as many blocks of `block` threads and `smem` bytes of dynamic shared memory
// as fit on the card at once (at most n_items), so each block pays its
// set-up (the table copy) once. Opts the kernel in to more than 48 KB of
// shared memory where it needs it.
template <class K>
inline cudaError_t persistent_grid(K kernel, int block, size_t smem, int n_items,
                                   int* n_blocks) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *n_blocks = n_items < per_sm * n_sm ? n_items : per_sm * n_sm;
  return cudaSuccess;
}

__device__ __forceinline__ float srecip(float c) {
  return fabsf(c) > 1e-12f ? 1.0f / c : (c >= 0.0f ? 1e30f : -1e30f);
}

__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Per-ray terms of the fold: |o|^2, d.o and the safe reciprocal direction.
struct RayTerms {
  float oo, dod, ivx, ivy, ivz;
};

__device__ __forceinline__ RayTerms ray_terms(const Ray& r) {
  RayTerms q;
  q.oo = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
  q.dod = r.dx * r.ox + r.dy * r.oy + r.dz * r.oz;
  q.ivx = srecip(r.dx); q.ivy = srecip(r.dy); q.ivz = srecip(r.dz);
  return q;
}

// Walls, then boxes (strict <), into (bt, bi).
__device__ __forceinline__ void fold_walls_boxes(const Tab& T, const Ray& r, const RayTerms& q,
                                                 float& bt, int& bi) {
  const float ox = r.ox, oy = r.oy, oz = r.oz, dx = r.dx, dy = r.dy, dz = r.dz;
  const int wall_base = T.n_s, box_base = T.n_s + T.n_w;
  for (int i = 0; i < T.n_w; ++i) {
    float nx = T.wc(0, i), ny = T.wc(1, i), nz = T.wc(2, i);
    float denom = dx * nx + dy * ny + dz * nz;
    float num = T.wc(3, i) - (ox * nx + oy * ny + oz * nz);
    bool ok = fabsf(denom) > 1e-12f;
    float tt = num / (ok ? denom : 1.0f);
    float relx = ox + dx * tt - T.wc(10, i);
    float rely = oy + dy * tt - T.wc(11, i);
    float relz = oz + dz * tt - T.wc(12, i);
    float u = relx * T.wc(4, i) + rely * T.wc(5, i) + relz * T.wc(6, i);
    float v = relx * T.wc(7, i) + rely * T.wc(8, i) + relz * T.wc(9, i);
    if (ok && tt > 0.0f && u >= 0.0f && u <= T.wc(13, i) && v >= 0.0f &&
        v <= T.wc(14, i) && tt < bt) {
      bt = tt;
      bi = wall_base + i;
    }
  }
  for (int i = 0; i < T.n_b; ++i) {
    float t1x = (T.bc(0, i) - ox) * q.ivx, t2x = (T.bc(3, i) - ox) * q.ivx;
    float t1y = (T.bc(1, i) - oy) * q.ivy, t2y = (T.bc(4, i) - oy) * q.ivy;
    float t1z = (T.bc(2, i) - oz) * q.ivz, t2z = (T.bc(5, i) - oz) * q.ivz;
    float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
    float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
    if (tn <= tf && tn > 0.0f && tn < bt) {
      bt = tn;
      bi = box_base + i;
    }
  }
}

// The ray's live segment [t0, t_ex] inside the slab of all spheres; false
// when the ray misses the slab (it can hit no sphere).
__device__ __forceinline__ bool slab_segment(const Tab& T, const Ray& r, const RayTerms& q,
                                             float& t0, float& t_ex) {
  const float* slab = T.slab;
  float ax1 = (slab[0] - r.ox) * q.ivx, ax2 = (slab[3] - r.ox) * q.ivx;
  float ay1 = (slab[1] - r.oy) * q.ivy, ay2 = (slab[4] - r.oy) * q.ivy;
  float az1 = (slab[2] - r.oz) * q.ivz, az2 = (slab[5] - r.oz) * q.ivz;
  t0 = fmaxf(fmaxf(fmaxf(fminf(ax1, ax2), fminf(ay1, ay2)), fminf(az1, az2)), 0.0f);
  t_ex = fminf(fminf(fmaxf(ax1, ax2), fmaxf(ay1, ay2)), fmaxf(az1, az2));
  return t_ex >= t0 && t_ex > 0.0f;
}

// Whether the segment [t0, t1] can reach chunk c: its box (GATE_AABB) or
// its bounding sphere.
__device__ __forceinline__ bool chunk_gate(const Tab& T, int c, const Ray& r, const RayTerms& q,
                                           float t0, float t1) {
  if (T.gate == GATE_AABB) {
    float c1x = (T.cc(0, c) - r.ox) * q.ivx, c2x = (T.cc(3, c) - r.ox) * q.ivx;
    float c1y = (T.cc(1, c) - r.oy) * q.ivy, c2y = (T.cc(4, c) - r.oy) * q.ivy;
    float c1z = (T.cc(2, c) - r.oz) * q.ivz, c2z = (T.cc(5, c) - r.oz) * q.ivz;
    float tn = fmaxf(fmaxf(fminf(c1x, c2x), fminf(c1y, c2y)), fminf(c1z, c2z));
    float tf = fminf(fminf(fmaxf(c1x, c2x), fmaxf(c1y, c2y)), fmaxf(c1z, c2z));
    return fmaxf(tn, t0) <= fminf(tf, t1);
  }
  float gx = T.cc(6, c), gy = T.cc(7, c), gz = T.cc(8, c);
  float s_g = r.dx * gx + r.dy * gy + r.dz * gz;
  float m_g = r.ox * gx + r.oy * gy + r.oz * gz;
  float tc = fminf(fmaxf(s_g - q.dod, t0), t1);
  float dist2 = q.oo - 2.0f * m_g + T.cc(9, c) + tc * (2.0f * (q.dod - s_g) + tc);
  return t1 >= t0 && dist2 <= T.cc(10, c);
}

// The spheres of chunk c into (bt, bi), ties to the lower global index.
__device__ __forceinline__ void fold_chunk(const Tab& T, int c, const Ray& r, const RayTerms& q,
                                           float& bt, int& bi) {
  const int i1 = min((c + 1) * T.unroll, T.n_s);
  for (int i = c * T.unroll; i < i1; ++i) {
    float cx = T.sc(0, i), cy = T.sc(1, i), cz = T.sc(2, i);
    float s = r.dx * cx + r.dy * cy + r.dz * cz;
    float m = r.ox * cx + r.oy * cy + r.oz * cz;
    float b_half = q.dod - s;
    float c_full = q.oo - 2.0f * m + T.sc(3, i);
    float disc = b_half * b_half - c_full;
    float tt = -b_half - sqrtf(disc);  // NaN on a miss
    if (tt > 0.0f && (tt < bt || (tt == bt && i < bi))) {
      bt = tt;
      bi = i;
    }
  }
}

// Diffuse and specular lobes of one unit light direction, weighted by the
// material's diffuse and specular strengths.
__device__ __forceinline__ float light_term(
    float lx, float ly, float lz, float vwx, float vwy, float vwz,
    float hnx, float hny, float hnz, float dif, float spe, float exq) {
  float diffuse = fmaxf(lx * hnx + ly * hny + lz * hnz, 0.0f);
  float hvx = vwx + lx, hvy = vwy + ly, hvz = vwz + lz;
  float n2 = hvx * hvx + hvy * hvy + hvz * hvz;
  float hsc = rsqrtf(n2 > 1e-12f ? n2 : 1.0f);
  float base = fmaxf((hvx * hnx + hvy * hny + hvz * hnz) * hsc, 0.0f);
  float specular = base > 0.0f ? expf(exq * logf(base)) : 0.0f;
  return diffuse * dif + specular * spe;
}

// One level after the fold found (bt, bi) for an alive lane: the winner
// record, Blinn-Phong shading or the sky, the accumulator increment and the
// mirror bounce. Updates the ray, the throughput and the accumulator in
// place and returns the level's t (the fold's t on a miss).
__device__ __forceinline__ float shade_bounce(const Tab& T, float bt, int bi, bool is_last,
                                              const RayTerms& q, Ray& r, float& w, float& accr,
                                              float& accg, float& accb) {
  const float ox = r.ox, oy = r.oy, oz = r.oz, dx = r.dx, dy = r.dy, dz = r.dz;
  const int wall_base = T.n_s, box_base = T.n_s + T.n_w;
  const float* sky = T.sky;
  const bool hit = bt < MISS_T;
  float z = dz;
  float grad = z > 0.0f ? expf(sky[9] * logf(z)) : 0.0f;
  float skr = z < 0.0f ? sky[6] : sky[0] + (sky[3] - sky[0]) * grad;
  float skg = z < 0.0f ? sky[7] : sky[1] + (sky[4] - sky[1]) * grad;
  float skb = z < 0.0f ? sky[8] : sky[2] + (sky[5] - sky[2]) * grad;
  if (!hit) {
    accr = accr + skr * w;
    accg = accg + skg * w;
    accb = accb + skb * w;
    w = 0.0f;  // w * (hit ? met : 0)
    return bt;
  }

  float tt = bt;
  float hpx, hpy, hpz, hnx, hny, hnz;
  if (bi < wall_base) {
    float g0 = T.sc(0, bi), g1 = T.sc(1, bi), g2 = T.sc(2, bi), g3 = T.sc(4, bi);
    float ex = ox - g0, ey = oy - g1, ez = oz - g2;
    float bq = 2.0f * (dx * ex + dy * ey + dz * ez);
    float cq = ex * ex + ey * ey + ez * ez - g3 * g3;
    float det = bq * bq - 4.0f * cq;
    // Strict det > 0; at a graze fall back to the fold's t.
    if (det > 0.0f) tt = 0.5f * (-bq - sqrtf(det));
    hpx = ox + dx * tt; hpy = oy + dy * tt; hpz = oz + dz * tt;
    float inv_r = 1.0f / fmaxf(g3, 1e-12f);
    hnx = (hpx - g0) * inv_r; hny = (hpy - g1) * inv_r; hnz = (hpz - g2) * inv_r;
  } else if (bi < box_base) {
    int j = bi - wall_base;
    float g0 = T.wc(0, j), g1 = T.wc(1, j), g2 = T.wc(2, j);
    float denom = dx * g0 + dy * g1 + dz * g2;
    if (fabsf(denom) > 1e-12f)
      tt = ((T.wc(10, j) - ox) * g0 + (T.wc(11, j) - oy) * g1 + (T.wc(12, j) - oz) * g2) / denom;
    hpx = ox + dx * tt; hpy = oy + dy * tt; hpz = oz + dz * tt;
    hnx = g0; hny = g1; hnz = g2;
  } else {
    int j = bi - box_base;
    float g0 = T.bc(0, j), g1 = T.bc(1, j), g2 = T.bc(2, j);
    float g3 = T.bc(3, j), g4 = T.bc(4, j), g5 = T.bc(5, j);
    const float ivx = q.ivx, ivy = q.ivy, ivz = q.ivz;
    tt = fmaxf(fmaxf(fminf((g0 - ox) * ivx, (g3 - ox) * ivx),
                     fminf((g1 - oy) * ivy, (g4 - oy) * ivy)),
               fminf((g2 - oz) * ivz, (g5 - oz) * ivz));
    hpx = ox + dx * tt; hpy = oy + dy * tt; hpz = oz + dz * tt;
    float tx = ((dx >= 0.0f ? g0 : g3) - ox) * ivx;
    float ty = ((dy >= 0.0f ? g1 : g4) - oy) * ivy;
    float tz = ((dz >= 0.0f ? g2 : g5) - oz) * ivz;
    bool bx = tx >= ty && tx >= tz;
    bool by = !bx && ty >= tz;
    bool bz = !bx && !by;
    hnx = bx ? -sgn(dx) : 0.0f;
    hny = by ? -sgn(dy) : 0.0f;
    hnz = bz ? -sgn(dz) : 0.0f;
  }

  const float* P = T.P;
  const float* U = T.U;
  const float met = T.mc(4, bi), dif = T.mc(5, bi), spe = T.mc(6, bi), exq = T.mc(7, bi);
  const float vwx = -dx, vwy = -dy, vwz = -dz;
  float ir = 0.0f, ig = 0.0f, ib = 0.0f;
  for (int li = 0; li < T.n_pt; ++li) {
    float ldx = P[0 * T.n_pt + li] - hpx;
    float ldy = P[1 * T.n_pt + li] - hpy;
    float ldz = P[2 * T.n_pt + li] - hpz;
    float n2 = ldx * ldx + ldy * ldy + ldz * ldz;
    float inv = rsqrtf(fmaxf(n2, 1e-12f));
    float term = light_term(ldx * inv, ldy * inv, ldz * inv, vwx, vwy, vwz,
                            hnx, hny, hnz, dif, spe, exq);
    ir = ir + P[3 * T.n_pt + li] * term;
    ig = ig + P[4 * T.n_pt + li] * term;
    ib = ib + P[5 * T.n_pt + li] * term;
  }
  for (int si = 0; si < T.n_sun; ++si) {
    float term = light_term(U[0 * T.n_sun + si], U[1 * T.n_sun + si],
                            U[2 * T.n_sun + si], vwx, vwy, vwz, hnx, hny, hnz,
                            dif, spe, exq);
    ir = ir + U[3 * T.n_sun + si] * term;
    ig = ig + U[4 * T.n_sun + si] * term;
    ib = ib + U[5 * T.n_sun + si] * term;
  }
  const float amb = T.mc(3, bi);
  float lr = T.mc(0, bi) * (ir + amb);
  float lg = T.mc(1, bi) * (ig + amb);
  float lb = T.mc(2, bi) * (ib + amb);
  if (!is_last) {
    float one_m = 1.0f - met;
    lr = lr * one_m; lg = lg * one_m; lb = lb * one_m;
  }
  accr = accr + lr * w;
  accg = accg + lg * w;
  accb = accb + lb * w;

  w = w * met;
  float dn2 = 2.0f * (dx * hnx + dy * hny + dz * hnz);
  r.ox = hpx + hnx * REFLECT_EPS;
  r.oy = hpy + hny * REFLECT_EPS;
  r.oz = hpz + hnz * REFLECT_EPS;
  r.dx = dx - hnx * dn2;
  r.dy = dy - hny * dn2;
  r.dz = dz - hnz * dn2;
  return tt;
}

// ---------------------------------------------------------------------------
// Per-tile reach statistics (the per-level chain). One block is one tile.
// A tile's row of NSTAT + n_c floats: the box of its used lanes' segments
// (lo xyz, hi xyz; raw, phase A adds the padding), the sums of their segment
// starts (xyz), the used-lane count, whether any lane is alive, then one
// 0/1 per chunk: whether any used lane's segment reaches the chunk's gate.
// A lane is used when it is alive (w > 0) and its ray meets the slab.
// ---------------------------------------------------------------------------

constexpr int NSTAT = 11;
constexpr int MAX_WARPS = 32;

// Shared scratch of tile_stats, in 32-bit words: per-warp partials
// (MAX_WARPS x 10 floats), then the reach bitmask (ceil(n_c / 32) words).
__host__ __device__ inline int stats_scratch_words(int n_c) {
  return MAX_WARPS * 10 + (n_c + 31) / 32;
}

// Reduces the block's lanes into `row` (NSTAT + n_c floats). Every thread of
// the block must call it; `valid` lanes lie inside the frame.
__device__ __forceinline__ void tile_stats(const Tab& T, bool valid, const Ray& r, float w,
                                           float* scratch, float* row) {
  float* part = scratch;
  unsigned* mask = reinterpret_cast<unsigned*>(scratch + MAX_WARPS * 10);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5, n_words = (T.n_c + 31) >> 5;
  for (int j = threadIdx.x; j < n_words; j += blockDim.x) mask[j] = 0u;
  const bool alive = valid && w > 0.0f;
  const RayTerms q = ray_terms(r);
  float t0 = 0.0f, t_ex = 0.0f;
  const bool used = alive && slab_segment(T, r, q, t0, t_ex);
  float v[10];
  if (used) {
    const float p1x = r.ox + t0 * r.dx, p1y = r.oy + t0 * r.dy, p1z = r.oz + t0 * r.dz;
    const float p2x = r.ox + t_ex * r.dx, p2y = r.oy + t_ex * r.dy, p2z = r.oz + t_ex * r.dz;
    v[0] = fminf(p1x, p2x); v[1] = fminf(p1y, p2y); v[2] = fminf(p1z, p2z);
    v[3] = fmaxf(p1x, p2x); v[4] = fmaxf(p1y, p2y); v[5] = fmaxf(p1z, p2z);
    v[6] = p1x; v[7] = p1y; v[8] = p1z; v[9] = 1.0f;
  } else {
    v[0] = v[1] = v[2] = BIG;
    v[3] = v[4] = v[5] = -BIG;
    v[6] = v[7] = v[8] = v[9] = 0.0f;
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
#pragma unroll
    for (int j = 0; j < 3; ++j) v[j] = fminf(v[j], __shfl_xor_sync(FULL, v[j], off));
#pragma unroll
    for (int j = 3; j < 6; ++j) v[j] = fmaxf(v[j], __shfl_xor_sync(FULL, v[j], off));
#pragma unroll
    for (int j = 6; j < 10; ++j) v[j] = v[j] + __shfl_xor_sync(FULL, v[j], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 10; ++j) part[warp * 10 + j] = v[j];
  }
  __syncthreads();  // the mask is zeroed before any warp sets a bit
  // Tube-reach union: the chunk gate over each used lane's whole segment.
  if (__any_sync(FULL, used)) {
    for (int c = 0; c < T.n_c; ++c) {
      const unsigned b = __ballot_sync(FULL, used && chunk_gate(T, c, r, q, t0, t_ex));
      if (lane == 0 && b) atomicOr(&mask[c >> 5], 1u << (c & 31));
    }
  }
  const int any_alive = __syncthreads_or(alive);
  if (threadIdx.x < 10) {
    const int j = threadIdx.x;
    float acc = part[j];
    for (int k = 1; k < n_warps; ++k) {
      const float x = part[k * 10 + j];
      acc = j < 3 ? fminf(acc, x) : (j < 6 ? fmaxf(acc, x) : acc + x);
    }
    row[j] = acc;
  }
  if (threadIdx.x == 10) row[10] = any_alive ? 1.0f : 0.0f;
  for (int c = threadIdx.x; c < T.n_c; c += blockDim.x)
    row[NSTAT + c] = (mask[c >> 5] >> (c & 31)) & 1u ? 1.0f : 0.0f;
}

// ---------------------------------------------------------------------------
// The adjoint of one level (the backward kernels)
// ---------------------------------------------------------------------------

// Share of the cotangent of max(a, b) (min(a, b)) that goes to a.
__device__ __forceinline__ float wmax(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}
__device__ __forceinline__ float wmin(float a, float b) {
  return a < b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

// Sum over the warp, the same value in every lane; every lane must call it.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// Sums `v` over the warp and adds the sum to `*dst` (lane 0); every lane
// must call it.
__device__ __forceinline__ void warp_add(float* dst, float v) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) atomicAdd(dst, v);
}

// One light's diffuse and specular lobes at a hit (light_term), with the
// intermediates its adjoint needs.
struct Lobes {
  float ldn, diffuse, hvx, hvy, hvz, n2, hsc, hvdn, base, spec, term;
};

__device__ __forceinline__ Lobes lobes_fwd(
    float lx, float ly, float lz, float vwx, float vwy, float vwz,
    float hnx, float hny, float hnz, float dif, float spe, float exq) {
  Lobes f;
  f.ldn = lx * hnx + ly * hny + lz * hnz;
  f.diffuse = fmaxf(f.ldn, 0.0f);
  f.hvx = vwx + lx; f.hvy = vwy + ly; f.hvz = vwz + lz;
  f.n2 = f.hvx * f.hvx + f.hvy * f.hvy + f.hvz * f.hvz;
  f.hsc = rsqrtf(f.n2 > 1e-12f ? f.n2 : 1.0f);
  f.hvdn = f.hvx * hnx + f.hvy * hny + f.hvz * hnz;
  f.base = fmaxf(f.hvdn * f.hsc, 0.0f);
  f.spec = f.base > 0.0f ? expf(exq * logf(f.base)) : 0.0f;
  f.term = f.diffuse * dif + f.spec * spe;
  return f;
}

// Adjoint of lobes_fwd for the cotangent `c` of its term: adds to the
// cotangents of the light direction (cl), the normal (chn), the view
// direction (cvw) and the material's diffuse, specular and exponent.
__device__ __forceinline__ void lobes_bwd(
    const Lobes& f, float c, float lx, float ly, float lz, float hnx,
    float hny, float hnz, float dif, float spe, float exq, float* cl,
    float* chn, float* cvw, float& cdif, float& cspe, float& cexq) {
  cdif += c * f.diffuse;
  cspe += c * f.spec;
  const float c_diff = c * dif;
  float c_x = 0.0f;  // cotangent of hvdn * hsc; base > 0 means it passed
  if (f.base > 0.0f) {
    const float ce = c * spe * f.spec;
    cexq += ce * logf(f.base);
    c_x = ce * exq / f.base;
  }
  const float c_hvdn = c_x * f.hsc;
  const float c_hsc = c_x * f.hvdn;
  float chv[3] = {c_hvdn * hnx, c_hvdn * hny, c_hvdn * hnz};
  chn[0] += c_hvdn * f.hvx; chn[1] += c_hvdn * f.hvy; chn[2] += c_hvdn * f.hvz;
  if (f.n2 > 1e-12f) {
    const float c_n2 = c_hsc * (-0.5f * (f.hsc * f.hsc * f.hsc));
    chv[0] += 2.0f * c_n2 * f.hvx;
    chv[1] += 2.0f * c_n2 * f.hvy;
    chv[2] += 2.0f * c_n2 * f.hvz;
  }
  const float c_ldn = c_diff * wmax(f.ldn, 0.0f);
  cl[0] += c_ldn * hnx + chv[0];
  cl[1] += c_ldn * hny + chv[1];
  cl[2] += c_ldn * hnz + chv[2];
  chn[0] += c_ldn * lx; chn[1] += c_ldn * ly; chn[2] += c_ldn * lz;
  cvw[0] += chv[0]; cvw[1] += chv[1]; cvw[2] += chv[2];
}

// The adjoint of one level of one lane at the forward's selections,
// derived by hand from `_level_math` in ops/cuda_fold.py (CUDA has no
// autodiff).
//
// In: the level's input ray (o, d), throughput w, saved t and index bi, the
// image cotangent (car, cag, cab) and the cotangents of the level's outputs
// (co, cd: the next ray; cw: the next throughput). Out, for an alive lane:
// the cotangents of the level's inputs (c_o, c_d, c_w) and of the winner's
// 14 gathered attributes (ca); the light and sky cotangents are summed over
// the warp into the shared row `s_ls` (6 per point light, 6 per sun, the 10
// sky scalars). A dead lane (w == 0) gets zeros: its caller passes its
// cotangents through. Every lane of the warp must call it. Returns whether
// the lane hit a primitive (its attributes have cotangents).
//
// Derivative rules, the same as PyTorch's autograd of the plain version:
// every guarded sqrt, rsqrt, log and divide takes its derivative only on its
// taken branch (strict det > 0, n2 > 1e-12, base > 0, z > 0, |denom| >
// 1e-12, and `srecip`, whose derivative is 0 where it clamps); selections,
// masks, t where it falls back to the saved t, and the box's face normal are
// constants; every `fmaxf`/`fminf` splits the cotangent in half at a tie,
// the box slabs' (torch.maximum/minimum) and the clamps' against a constant
// alike (the diffuse lobe, max(r, 1e-12), max(n2, 1e-12): the JAX package's
// jnp.maximum(x, c), the plain version's `max_c`).
__device__ __forceinline__ bool level_adjoint(
    const Tab& T, bool is_last, bool alive, const float o[3], const float d[3], float w,
    float t_sel, int bi, float car, float cag, float cab, const float co[3],
    const float cd[3], float cw, float c_o[3], float c_d[3], float& c_w, float ca[14],
    float* s_ls) {
  const int n_pt = T.n_pt, n_sun = T.n_sun;
  const int n_ls = 6 * (n_pt + n_sun) + 10;
  const int wall_base = T.n_s, box_base = T.n_s + T.n_w;
  const float* P = T.P;
  const float* U = T.U;
  const float* sky = T.sky;
#pragma unroll
  for (int j = 0; j < 3; ++j) { c_o[j] = 0.0f; c_d[j] = 0.0f; }
  c_w = 0.0f;
#pragma unroll
  for (int c = 0; c < 14; ++c) ca[c] = 0.0f;
  const bool act = alive && bi >= 0;   // a hit: the shading runs
  const bool miss = alive && bi < 0;   // the sky

  // ---- sky (miss lanes): inc = sky * w; rays pass, w_next = 0 ----
  if (__any_sync(FULL, miss)) {
    float csky[10];
#pragma unroll
    for (int j = 0; j < 10; ++j) csky[j] = 0.0f;
    if (miss) {
      const float z = d[2];
      const float grad = z > 0.0f ? expf(sky[9] * logf(z)) : 0.0f;
      const float cimg[3] = {car, cag, cab};
      const float crgb[3] = {car * w, cag * w, cab * w};
      float c_grad = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float sk = z < 0.0f ? sky[6 + j] : sky[j] + (sky[3 + j] - sky[j]) * grad;
        c_w += cimg[j] * sk;
        if (z < 0.0f) {
          csky[6 + j] = crgb[j];
        } else {
          csky[j] = crgb[j] - crgb[j] * grad;
          csky[3 + j] = crgb[j] * grad;
          c_grad += crgb[j] * (sky[3 + j] - sky[j]);
        }
      }
      if (z > 0.0f) {
        const float ce = c_grad * grad;
        csky[9] = ce * logf(z);
        c_d[2] += ce * sky[9] / z;
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) { c_o[j] += co[j]; c_d[j] += cd[j]; }
    }
#pragma unroll
    for (int j = 0; j < 10; ++j) warp_add(&s_ls[n_ls - 10 + j], csky[j]);
  }

  if (!__any_sync(FULL, act)) return act;

  // ---- regather and record replay ----
  float g[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float colr = 0.0f, colg = 0.0f, colb = 0.0f, amb = 0.0f;
  float met = 0.0f, dif = 0.0f, spe = 0.0f, exq = 0.0f;
  float tt = t_sel, hp[3] = {0.0f, 0.0f, 0.0f}, hn[3] = {0.0f, 0.0f, 1.0f};
  float e[3] = {0.0f, 0.0f, 0.0f}, bq = 0.0f, sq = 1.0f, inv_r = 0.0f;
  float denom = 1.0f, num = 0.0f, iv[3] = {0.0f, 0.0f, 0.0f};
  float lo[3] = {0.0f, 0.0f, 0.0f}, hi[3] = {0.0f, 0.0f, 0.0f};
  float m[3] = {0.0f, 0.0f, 0.0f}, mxy = 0.0f;
  bool pos = false, ok = false;
  const int kind = bi < wall_base ? 0 : (bi < box_base ? 1 : 2);
  if (act) {
    colr = T.mc(0, bi); colg = T.mc(1, bi); colb = T.mc(2, bi); amb = T.mc(3, bi);
    met = T.mc(4, bi); dif = T.mc(5, bi); spe = T.mc(6, bi); exq = T.mc(7, bi);
    if (kind == 0) {
      g[0] = T.sc(0, bi); g[1] = T.sc(1, bi); g[2] = T.sc(2, bi); g[3] = T.sc(4, bi);
      e[0] = o[0] - g[0]; e[1] = o[1] - g[1]; e[2] = o[2] - g[2];
      bq = 2.0f * (d[0] * e[0] + d[1] * e[1] + d[2] * e[2]);
      const float cq = e[0] * e[0] + e[1] * e[1] + e[2] * e[2] - g[3] * g[3];
      const float det = bq * bq - 4.0f * cq;
      pos = det > 0.0f;  // strict: else the saved t stands
      if (pos) {
        sq = sqrtf(det);
        tt = 0.5f * (-bq - sq);
      }
      inv_r = 1.0f / fmaxf(g[3], 1e-12f);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        hp[j] = o[j] + d[j] * tt;
        hn[j] = (hp[j] - g[j]) * inv_r;
      }
    } else if (kind == 1) {
      const int q = bi - wall_base;
#pragma unroll
      for (int j = 0; j < 3; ++j) { g[j] = T.wc(j, q); g[3 + j] = T.wc(10 + j, q); }
      denom = d[0] * g[0] + d[1] * g[1] + d[2] * g[2];
      ok = fabsf(denom) > 1e-12f;
      num = (g[3] - o[0]) * g[0] + (g[4] - o[1]) * g[1] + (g[5] - o[2]) * g[2];
      if (ok) tt = num / denom;
#pragma unroll
      for (int j = 0; j < 3; ++j) { hp[j] = o[j] + d[j] * tt; hn[j] = g[j]; }
    } else {
      const int q = bi - box_base;
#pragma unroll
      for (int j = 0; j < 6; ++j) g[j] = T.bc(j, q);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        iv[j] = srecip(d[j]);
        lo[j] = (g[j] - o[j]) * iv[j];
        hi[j] = (g[3 + j] - o[j]) * iv[j];
        m[j] = fminf(lo[j], hi[j]);
      }
      mxy = fmaxf(m[0], m[1]);
      tt = fmaxf(mxy, m[2]);
      float tf[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        hp[j] = o[j] + d[j] * tt;
        tf[j] = ((d[j] >= 0.0f ? g[j] : g[3 + j]) - o[j]) * iv[j];
      }
      const bool bx = tf[0] >= tf[1] && tf[0] >= tf[2];
      const bool by = !bx && tf[1] >= tf[2];
      const bool bz = !bx && !by;
      hn[0] = bx ? -sgn(d[0]) : 0.0f;
      hn[1] = by ? -sgn(d[1]) : 0.0f;
      hn[2] = bz ? -sgn(d[2]) : 0.0f;
    }
  }
  const float vw[3] = {-d[0], -d[1], -d[2]};

  // ---- shading replay: the lights' sums ----
  float ir = 0.0f, ig = 0.0f, ib = 0.0f;
  if (act) {
    for (int li = 0; li < n_pt; ++li) {
      float ld[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) ld[j] = P[j * n_pt + li] - hp[j];
      const float n2 = ld[0] * ld[0] + ld[1] * ld[1] + ld[2] * ld[2];
      const float inv = rsqrtf(fmaxf(n2, 1e-12f));
      const Lobes f = lobes_fwd(ld[0] * inv, ld[1] * inv, ld[2] * inv,
                                vw[0], vw[1], vw[2], hn[0], hn[1], hn[2],
                                dif, spe, exq);
      ir = ir + P[3 * n_pt + li] * f.term;
      ig = ig + P[4 * n_pt + li] * f.term;
      ib = ib + P[5 * n_pt + li] * f.term;
    }
    for (int si = 0; si < n_sun; ++si) {
      const Lobes f = lobes_fwd(U[si], U[n_sun + si], U[2 * n_sun + si],
                                vw[0], vw[1], vw[2], hn[0], hn[1], hn[2],
                                dif, spe, exq);
      ir = ir + U[3 * n_sun + si] * f.term;
      ig = ig + U[4 * n_sun + si] * f.term;
      ib = ib + U[5 * n_sun + si] * f.term;
    }
  }
  const float lr = colr * (ir + amb), lg = colg * (ig + amb), lb = colb * (ib + amb);

  // ---- adjoint of the bounce and the accumulate ----
  float c_hp[3] = {0.0f, 0.0f, 0.0f}, c_hn[3] = {0.0f, 0.0f, 0.0f};
  float c_ir = 0.0f, c_ig = 0.0f, c_ib = 0.0f;
  if (act) {
    // w_next = w * met
    c_w += cw * met;
    ca[10] += cw * w;
    // o_next = hp + hn * eps; d_next = d - hn * dn2, dn2 = 2 (d . hn)
    const float dn2 = 2.0f * (d[0] * hn[0] + d[1] * hn[1] + d[2] * hn[2]);
    const float c_dn2 = -(cd[0] * hn[0] + cd[1] * hn[1] + cd[2] * hn[2]);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      c_hp[j] = co[j];
      c_hn[j] = co[j] * REFLECT_EPS - cd[j] * dn2 + 2.0f * c_dn2 * d[j];
      c_d[j] += cd[j] + 2.0f * c_dn2 * hn[j];
    }
    // inc = hc * w, hc = local * (1 - met) (local on the last level)
    const float one_m = is_last ? 1.0f : 1.0f - met;
    c_w += car * (lr * one_m) + cag * (lg * one_m) + cab * (lb * one_m);
    const float c_lr = car * w * one_m, c_lg = cag * w * one_m, c_lb = cab * w * one_m;
    if (!is_last) ca[10] -= car * w * lr + cag * w * lg + cab * w * lb;
    // local = color * (light sum + ambient)
    ca[6] += c_lr * (ir + amb);
    ca[7] += c_lg * (ig + amb);
    ca[8] += c_lb * (ib + amb);
    ca[9] += c_lr * colr + c_lg * colg + c_lb * colb;
    c_ir = c_lr * colr; c_ig = c_lg * colg; c_ib = c_lb * colb;
  }

  // ---- adjoint of the lights (every lane of the warp runs the loop, for
  // the warp sums of the light cotangents) ----
  float c_vw[3] = {0.0f, 0.0f, 0.0f};
  for (int li = 0; li < n_pt; ++li) {
    float cp[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (act) {
      float ld[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) ld[j] = P[j * n_pt + li] - hp[j];
      const float n2 = ld[0] * ld[0] + ld[1] * ld[1] + ld[2] * ld[2];
      const float inv = rsqrtf(fmaxf(n2, 1e-12f));
      const float l[3] = {ld[0] * inv, ld[1] * inv, ld[2] * inv};
      const Lobes f = lobes_fwd(l[0], l[1], l[2], vw[0], vw[1], vw[2],
                                hn[0], hn[1], hn[2], dif, spe, exq);
      const float lc[3] = {P[3 * n_pt + li], P[4 * n_pt + li], P[5 * n_pt + li]};
      cp[3] = c_ir * f.term; cp[4] = c_ig * f.term; cp[5] = c_ib * f.term;
      const float c_term = c_ir * lc[0] + c_ig * lc[1] + c_ib * lc[2];
      float cl[3] = {0.0f, 0.0f, 0.0f};
      lobes_bwd(f, c_term, l[0], l[1], l[2], hn[0], hn[1], hn[2], dif, spe,
                exq, cl, c_hn, c_vw, ca[11], ca[12], ca[13]);
      // l = ld * inv, inv = rsqrt(max(n2, 1e-12)), ld = light - hp
      const float c_inv = cl[0] * ld[0] + cl[1] * ld[1] + cl[2] * ld[2];
      const float c_n2 = c_inv * (-0.5f * (inv * inv * inv)) * wmax(n2, 1e-12f);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float c_ld = cl[j] * inv + 2.0f * c_n2 * ld[j];
        cp[j] = c_ld;
        c_hp[j] -= c_ld;
      }
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) warp_add(&s_ls[6 * li + j], cp[j]);
  }
  for (int si = 0; si < n_sun; ++si) {
    float cs[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (act) {
      const float l[3] = {U[si], U[n_sun + si], U[2 * n_sun + si]};
      const Lobes f = lobes_fwd(l[0], l[1], l[2], vw[0], vw[1], vw[2],
                                hn[0], hn[1], hn[2], dif, spe, exq);
      cs[3] = c_ir * f.term; cs[4] = c_ig * f.term; cs[5] = c_ib * f.term;
      const float c_term = c_ir * U[3 * n_sun + si] + c_ig * U[4 * n_sun + si]
                           + c_ib * U[5 * n_sun + si];
      lobes_bwd(f, c_term, l[0], l[1], l[2], hn[0], hn[1], hn[2], dif, spe,
                exq, cs, c_hn, c_vw, ca[11], ca[12], ca[13]);
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) warp_add(&s_ls[6 * (n_pt + si) + j], cs[j]);
  }

  // ---- adjoint of the record ----
  if (act) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c_d[j] -= c_vw[j];  // vw = -d
    if (kind == 0) {
      // hn = (hp - g) * inv_r, inv_r = 1 / max(r, 1e-12)
      float c_inv_r = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        c_hp[j] += c_hn[j] * inv_r;
        ca[j] -= c_hn[j] * inv_r;
        c_inv_r += c_hn[j] * (hp[j] - g[j]);
      }
      ca[3] -= c_inv_r * (inv_r * inv_r) * wmax(g[3], 1e-12f);
    } else if (kind == 1) {
#pragma unroll
      for (int j = 0; j < 3; ++j) ca[j] += c_hn[j];  // hn = the normal
    }
    // hp = o + d * tt
    const float c_tt = c_hp[0] * d[0] + c_hp[1] * d[1] + c_hp[2] * d[2];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      c_o[j] += c_hp[j];
      c_d[j] += c_hp[j] * tt;
    }
    if (kind == 0 && pos) {
      // tt = (-bq - sqrt(det)) / 2, det = bq^2 - 4 cq,
      // bq = 2 (d . e), cq = e . e - r^2, e = o - center
      const float c_det = -0.5f * c_tt * (0.5f / sq);
      const float c_bq = -0.5f * c_tt + c_det * 2.0f * bq;
      const float c_cq = -4.0f * c_det;
      ca[3] -= 2.0f * c_cq * g[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float c_e = 2.0f * c_cq * e[j] + 2.0f * c_bq * d[j];
        c_d[j] += 2.0f * c_bq * e[j];
        c_o[j] += c_e;
        ca[j] -= c_e;
      }
    } else if (kind == 1 && ok) {
      // tt = num / denom, num = (corner - o) . normal, denom = d . normal
      const float c_num = c_tt / denom;
      const float c_den = -c_tt * num / (denom * denom);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        ca[j] += c_num * (g[3 + j] - o[j]) + c_den * d[j];
        ca[3 + j] += c_num * g[j];
        c_o[j] -= c_num * g[j];
        c_d[j] += c_den * g[j];
      }
    } else if (kind == 2) {
      // tt = max(max(m_x, m_y), m_z), m = min(lo, hi),
      // lo = (min corner - o) * iv, hi = (max corner - o) * iv, iv = srecip(d)
      const float c_mxy = c_tt * wmax(mxy, m[2]);
      float c_m[3] = {c_mxy * wmax(m[0], m[1]), c_mxy * wmax(m[1], m[0]),
                      c_tt * wmax(m[2], mxy)};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float c_lo = c_m[j] * wmin(lo[j], hi[j]);
        const float c_hi = c_m[j] * wmin(hi[j], lo[j]);
        ca[j] += c_lo * iv[j];
        ca[3 + j] += c_hi * iv[j];
        c_o[j] -= c_lo * iv[j] + c_hi * iv[j];
        const float c_iv = c_lo * (g[j] - o[j]) + c_hi * (g[3 + j] - o[j]);
        if (fabsf(d[j]) > 1e-12f) c_d[j] -= c_iv * (iv[j] * iv[j]);
      }
    }
  }
  return act;
}

}  // namespace rt
