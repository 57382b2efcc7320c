// Whole-trace kernel: every bounce level of every ray in one launch.
//
// Replaces the TPU kernel `_kernel_trace_whole` of
// raytracer_tpu/ops/pallas_fold.py (built by `_trace_whole`), which runs the
// closest-hit fold, the winner regather, Blinn-Phong shading, the sky and the
// mirror bounce for all levels of a (64, 128) ray tile in VMEM.
//
// Design: one thread per ray over the unpadded planes (the ragged end is
// masked). The packed scene table (a few KB) is copied into shared memory at
// block start; the ray, its throughput and its accumulator stay in registers
// across levels, so the only device-memory traffic is the 7 input planes and
// the 3 + 2 * (depth + 1) output planes. The winner's attributes are read by
// direct index instead of the TPU's masked-select sweep. Sphere chunks are
// gated per lane (chunk box or bounding sphere against the ray's live
// segment), and a lane whose throughput is 0 skips the level and writes
// (MISS_T, -1).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): the sprint3 frame at
// 1920x1080 and depth 3 moves 7 input and 11 output planes of 2,073,600 lanes
// of 4 bytes, 149 MB, at least 45 us. Its arithmetic is about 330 float32
// operations per alive lane and level (fold ~100 for the 2 walls, the slab
// and sphere gate and 1 sphere; record ~40; 2 lights ~80; sky, accumulate
// and bounce ~50), at most 2.7 GFLOP over 4 levels if every lane stayed
// alive, 40 us; most lanes die at level 0, so the frame is bound by its
// bytes. The design reads and writes each plane once and keeps every
// intermediate in registers; the 64-sphere grid (4 chunks, ~1,700 operations
// per lane and level ungated) is bound by operations, which the chunk gates
// cut.
//
// With `emit_res` (the training forward) the kernel also writes each level
// k >= 1's input rays and throughput, 7 planes per level, which the backward
// kernel (trace_whole_bwd.cu) reads: 21 more output planes at depth 3, 174 MB
// at 1080p, which at least doubles the bound. It is a template parameter,
// so the inference launch compiles to the code without those stores.
//
// Float semantics follow the plain PyTorch version op for op: build with
// -fmad=false and without fast math, so every product and sum rounds once as
// a separate PyTorch op does, and a sphere miss is rejected through the NaN
// compare of `tt > 0`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float MISS_T = 1e30f;
constexpr float REFLECT_EPS = 1e-4f;
constexpr int GATE_AABB = 0;
constexpr int BLOCK = 256;

// Offsets (in floats) of each group of the packed table. Mirrors _LAYOUT in
// raytracer_tpu_torch/ops/cuda_fold.py: each group is a run of columns, each
// column one value per item.
struct Layout {
  int n_s, unroll, n_c, n_w, n_b, n_pt, n_sun, gate, depth;
  int sph, wall, box, mat, chunk, slab, pt, sun, sky, n_tab;
};

Layout make_layout(int n_s, int unroll, int n_w, int n_b, int n_pt, int n_sun,
                   int gate, int depth) {
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

__device__ __forceinline__ float srecip(float c) {
  return fabsf(c) > 1e-12f ? 1.0f / c : (c >= 0.0f ? 1e30f : -1e30f);
}

__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
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

template <bool EMIT_RES>
__global__ void __launch_bounds__(BLOCK) trace_whole_kernel(
    Layout L, const float* __restrict__ g_tab,
    const float* __restrict__ ox_p, const float* __restrict__ oy_p,
    const float* __restrict__ oz_p, const float* __restrict__ dx_p,
    const float* __restrict__ dy_p, const float* __restrict__ dz_p,
    const float* __restrict__ w_p, float* __restrict__ ar_p,
    float* __restrict__ ag_p, float* __restrict__ ab_p,
    float* __restrict__ t_p, int* __restrict__ i_p, float* __restrict__ res_p,
    long long n) {
  extern __shared__ float tab[];
  for (int j = threadIdx.x; j < L.n_tab; j += blockDim.x) tab[j] = g_tab[j];
  __syncthreads();

  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;

  const float* S = tab + L.sph;    // cx cy cz cr2 srad        [n_s]
  const float* Wt = tab + L.wall;  // nx..wd (15 columns)       [n_w]
  const float* B = tab + L.box;    // min xyz, max xyz          [n_b]
  const float* M = tab + L.mat;    // r g b amb met dif spe exp [n_prim]
  const float* C = tab + L.chunk;  // box lo/hi, gx gy gz gg gr2 [n_c]
  const float* slab = tab + L.slab;
  const float* P = tab + L.pt;     // position xyz, color rgb   [n_pt]
  const float* U = tab + L.sun;    // unit direction, color     [n_sun]
  const float* sky = tab + L.sky;
  const int n_s = L.n_s, n_w = L.n_w, n_b = L.n_b, n_c = L.n_c;
  const int n_prim = n_s + n_w + n_b;
  const int wall_base = n_s, box_base = n_s + n_w;
#define SC(col, i) S[(col) * n_s + (i)]
#define WC(col, i) Wt[(col) * n_w + (i)]
#define BC(col, i) B[(col) * n_b + (i)]
#define MC(col, i) M[(col) * n_prim + (i)]
#define CC(col, i) C[(col) * n_c + (i)]

  float ox = ox_p[r], oy = oy_p[r], oz = oz_p[r];
  float dx = dx_p[r], dy = dy_p[r], dz = dz_p[r];
  float w = w_p[r];
  float accr = 0.0f, accg = 0.0f, accb = 0.0f;

  for (int k = 0; k <= L.depth; ++k) {
    const long long out = (long long)k * n + r;
    if (EMIT_RES && k >= 1) {
      float* res = res_p + (long long)(k - 1) * 7 * n + r;
      res[0] = ox; res[n] = oy; res[2 * n] = oz;
      res[3 * n] = dx; res[4 * n] = dy; res[5 * n] = dz; res[6 * n] = w;
    }
    if (!(w > 0.0f)) {
      t_p[out] = MISS_T;
      i_p[out] = -1;
      continue;
    }

    // ---- closest-hit fold: walls, boxes (strict <), then sphere chunks
    // (ties to the lower global index) ----
    const float oo = ox * ox + oy * oy + oz * oz;
    const float dod = dx * ox + dy * oy + dz * oz;
    const float ivx = srecip(dx), ivy = srecip(dy), ivz = srecip(dz);
    float bt = MISS_T;
    int bi = -1;

    for (int i = 0; i < n_w; ++i) {
      float nx = WC(0, i), ny = WC(1, i), nz = WC(2, i);
      float denom = dx * nx + dy * ny + dz * nz;
      float num = WC(3, i) - (ox * nx + oy * ny + oz * nz);
      bool ok = fabsf(denom) > 1e-12f;
      float tt = num / (ok ? denom : 1.0f);
      float relx = ox + dx * tt - WC(10, i);
      float rely = oy + dy * tt - WC(11, i);
      float relz = oz + dz * tt - WC(12, i);
      float u = relx * WC(4, i) + rely * WC(5, i) + relz * WC(6, i);
      float v = relx * WC(7, i) + rely * WC(8, i) + relz * WC(9, i);
      if (ok && tt > 0.0f && u >= 0.0f && u <= WC(13, i) && v >= 0.0f &&
          v <= WC(14, i) && tt < bt) {
        bt = tt;
        bi = wall_base + i;
      }
    }

    for (int i = 0; i < n_b; ++i) {
      float t1x = (BC(0, i) - ox) * ivx, t2x = (BC(3, i) - ox) * ivx;
      float t1y = (BC(1, i) - oy) * ivy, t2y = (BC(4, i) - oy) * ivy;
      float t1z = (BC(2, i) - oz) * ivz, t2z = (BC(5, i) - oz) * ivz;
      float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
      float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
      if (tn <= tf && tn > 0.0f && tn < bt) {
        bt = tn;
        bi = box_base + i;
      }
    }

    if (n_c) {
      // The ray's live segment [t0, t_ex] inside the slab of all spheres;
      // a ray that misses the slab can hit no sphere.
      float ax1 = (slab[0] - ox) * ivx, ax2 = (slab[3] - ox) * ivx;
      float ay1 = (slab[1] - oy) * ivy, ay2 = (slab[4] - oy) * ivy;
      float az1 = (slab[2] - oz) * ivz, az2 = (slab[5] - oz) * ivz;
      float t0 = fmaxf(fmaxf(fmaxf(fminf(ax1, ax2), fminf(ay1, ay2)),
                             fminf(az1, az2)), 0.0f);
      float t_ex = fminf(fminf(fmaxf(ax1, ax2), fmaxf(ay1, ay2)), fmaxf(az1, az2));
      if (t_ex >= t0 && t_ex > 0.0f) {
        for (int c = 0; c < n_c; ++c) {
          float t1 = fminf(t_ex, bt);
          bool reach;
          if (L.gate == GATE_AABB) {
            float c1x = (CC(0, c) - ox) * ivx, c2x = (CC(3, c) - ox) * ivx;
            float c1y = (CC(1, c) - oy) * ivy, c2y = (CC(4, c) - oy) * ivy;
            float c1z = (CC(2, c) - oz) * ivz, c2z = (CC(5, c) - oz) * ivz;
            float tn = fmaxf(fmaxf(fminf(c1x, c2x), fminf(c1y, c2y)), fminf(c1z, c2z));
            float tf = fminf(fminf(fmaxf(c1x, c2x), fmaxf(c1y, c2y)), fmaxf(c1z, c2z));
            reach = fmaxf(tn, t0) <= fminf(tf, t1);
          } else {
            float gx = CC(6, c), gy = CC(7, c), gz = CC(8, c);
            float s_g = dx * gx + dy * gy + dz * gz;
            float m_g = ox * gx + oy * gy + oz * gz;
            float tc = fminf(fmaxf(s_g - dod, t0), t1);
            float dist2 = oo - 2.0f * m_g + CC(9, c) + tc * (2.0f * (dod - s_g) + tc);
            reach = t1 >= t0 && dist2 <= CC(10, c);
          }
          if (!reach) continue;
          const int i1 = min((c + 1) * L.unroll, n_s);
          for (int i = c * L.unroll; i < i1; ++i) {
            float cx = SC(0, i), cy = SC(1, i), cz = SC(2, i);
            float s = dx * cx + dy * cy + dz * cz;
            float m = ox * cx + oy * cy + oz * cz;
            float b_half = dod - s;
            float c_full = oo - 2.0f * m + SC(3, i);
            float disc = b_half * b_half - c_full;
            float tt = -b_half - sqrtf(disc);  // NaN on a miss
            if (tt > 0.0f && (tt < bt || (tt == bt && i < bi))) {
              bt = tt;
              bi = i;
            }
          }
        }
      }
    }

    // ---- winner record, shading, sky, accumulate, bounce ----
    const bool hit = bt < MISS_T;
    const bool is_last = k == L.depth;
    float z = dz;
    float grad = z > 0.0f ? expf(sky[9] * logf(z)) : 0.0f;
    float skr = z < 0.0f ? sky[6] : sky[0] + (sky[3] - sky[0]) * grad;
    float skg = z < 0.0f ? sky[7] : sky[1] + (sky[4] - sky[1]) * grad;
    float skb = z < 0.0f ? sky[8] : sky[2] + (sky[5] - sky[2]) * grad;
    if (!hit) {
      accr = accr + skr * w;
      accg = accg + skg * w;
      accb = accb + skb * w;
      t_p[out] = bt;
      i_p[out] = -1;
      w = 0.0f;  // w * (hit ? met : 0)
      continue;
    }

    float tt = bt;
    float hpx, hpy, hpz, hnx, hny, hnz;
    if (bi < wall_base) {
      float g0 = SC(0, bi), g1 = SC(1, bi), g2 = SC(2, bi), g3 = SC(4, bi);
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
      float g0 = WC(0, j), g1 = WC(1, j), g2 = WC(2, j);
      float denom = dx * g0 + dy * g1 + dz * g2;
      if (fabsf(denom) > 1e-12f)
        tt = ((WC(10, j) - ox) * g0 + (WC(11, j) - oy) * g1 + (WC(12, j) - oz) * g2) / denom;
      hpx = ox + dx * tt; hpy = oy + dy * tt; hpz = oz + dz * tt;
      hnx = g0; hny = g1; hnz = g2;
    } else {
      int j = bi - box_base;
      float g0 = BC(0, j), g1 = BC(1, j), g2 = BC(2, j);
      float g3 = BC(3, j), g4 = BC(4, j), g5 = BC(5, j);
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

    const float met = MC(4, bi), dif = MC(5, bi), spe = MC(6, bi), exq = MC(7, bi);
    const float vwx = -dx, vwy = -dy, vwz = -dz;
    float ir = 0.0f, ig = 0.0f, ib = 0.0f;
    for (int li = 0; li < L.n_pt; ++li) {
      float ldx = P[0 * L.n_pt + li] - hpx;
      float ldy = P[1 * L.n_pt + li] - hpy;
      float ldz = P[2 * L.n_pt + li] - hpz;
      float n2 = ldx * ldx + ldy * ldy + ldz * ldz;
      float inv = rsqrtf(fmaxf(n2, 1e-12f));
      float term = light_term(ldx * inv, ldy * inv, ldz * inv, vwx, vwy, vwz,
                              hnx, hny, hnz, dif, spe, exq);
      ir = ir + P[3 * L.n_pt + li] * term;
      ig = ig + P[4 * L.n_pt + li] * term;
      ib = ib + P[5 * L.n_pt + li] * term;
    }
    for (int si = 0; si < L.n_sun; ++si) {
      float term = light_term(U[0 * L.n_sun + si], U[1 * L.n_sun + si],
                              U[2 * L.n_sun + si], vwx, vwy, vwz, hnx, hny, hnz,
                              dif, spe, exq);
      ir = ir + U[3 * L.n_sun + si] * term;
      ig = ig + U[4 * L.n_sun + si] * term;
      ib = ib + U[5 * L.n_sun + si] * term;
    }
    const float amb = MC(3, bi);
    float lr = MC(0, bi) * (ir + amb);
    float lg = MC(1, bi) * (ig + amb);
    float lb = MC(2, bi) * (ib + amb);
    if (!is_last) {
      float one_m = 1.0f - met;
      lr = lr * one_m; lg = lg * one_m; lb = lb * one_m;
    }
    accr = accr + lr * w;
    accg = accg + lg * w;
    accb = accb + lb * w;
    t_p[out] = tt;
    i_p[out] = bi;

    w = w * met;
    float dn2 = 2.0f * (dx * hnx + dy * hny + dz * hnz);
    ox = hpx + hnx * REFLECT_EPS;
    oy = hpy + hny * REFLECT_EPS;
    oz = hpz + hnz * REFLECT_EPS;
    dx = dx - hnx * dn2;
    dy = dy - hny * dn2;
    dz = dz - hnz * dn2;
  }
#undef SC
#undef WC
#undef BC
#undef MC
#undef CC

  ar_p[r] = accr;
  ag_p[r] = accg;
  ab_p[r] = accb;
}

}  // namespace

extern "C" {

// Launch on `stream`; `res` is written only with `emit_res` (and may be
// null without). Returns the CUDA error of the launch (0 on success).
int trace_whole_launch(const float* tab, int n_tab, int n_s, int unroll,
                       int n_w, int n_b, int n_pt, int n_sun, int gate,
                       int depth, int emit_res, const float* ox,
                       const float* oy, const float* oz, const float* dx,
                       const float* dy, const float* dz, const float* w,
                       float* ar, float* ag, float* ab, float* t_out,
                       int* i_out, float* res, long long n, void* stream) {
  Layout L = make_layout(n_s, unroll, n_w, n_b, n_pt, n_sun, gate, depth);
  if (L.n_tab != n_tab || n <= 0 || (emit_res && depth > 0 && !res))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + BLOCK - 1) / BLOCK);
  const size_t smem = (size_t)n_tab * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (emit_res)
    trace_whole_kernel<true><<<blocks, BLOCK, smem, s>>>(
        L, tab, ox, oy, oz, dx, dy, dz, w, ar, ag, ab, t_out, i_out, res, n);
  else
    trace_whole_kernel<false><<<blocks, BLOCK, smem, s>>>(
        L, tab, ox, oy, oz, dx, dy, dz, w, ar, ag, ab, t_out, i_out, res, n);
  return (int)cudaGetLastError();
}

const char* trace_whole_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
