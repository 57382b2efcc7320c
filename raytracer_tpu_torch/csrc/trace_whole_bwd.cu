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
// Derivative rules, the same as PyTorch's autograd of the plain version:
// every guarded sqrt, rsqrt, log and divide takes its derivative only on its
// taken branch (strict det > 0, n2 > 1e-12, base > 0, z > 0, |denom| >
// 1e-12, and `srecip`, whose derivative is 0 where it clamps); selections,
// masks, t where it falls back to the saved t, and the box's face normal are
// constants; `fmaxf`/`fminf` in the box slabs split the cotangent in half at
// a tie (torch.maximum/minimum), while the clamps (the diffuse and specular
// lobes, max(r, 1e-12), max(n2, 1e-12)) pass all of it where the value is at
// the clamp (torch.clamp_min).
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float REFLECT_EPS = 1e-4f;
constexpr int BLOCK = 256;
constexpr unsigned FULL = 0xffffffffu;

// Offsets (in floats) of each group of the packed table; the same layout as
// trace_whole.cu and _LAYOUT in raytracer_tpu_torch/ops/cuda_fold.py.
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

// One light's diffuse and specular lobes at a hit (trace_whole.cu's
// light_term), with the intermediates its adjoint needs.
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
  const float c_ldn = f.ldn >= 0.0f ? c_diff : 0.0f;
  cl[0] += c_ldn * hnx + chv[0];
  cl[1] += c_ldn * hny + chv[1];
  cl[2] += c_ldn * hnz + chv[2];
  chn[0] += c_ldn * lx; chn[1] += c_ldn * ly; chn[2] += c_ldn * lz;
  cvw[0] += chv[0]; cvw[1] += chv[1]; cvw[2] += chv[2];
}

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
  const int n_s = L.n_s, n_w = L.n_w, n_b = L.n_b, n_pt = L.n_pt;
  const int n_prim = n_s + n_w + n_b;
  const int n_ls = 6 * (n_pt + L.n_sun) + 10;
  const int wall_base = n_s, box_base = n_s + n_w;
  extern __shared__ float smem[];
  float* tab = smem;
  float* s_pg = smem + L.n_tab;        // [n_prim][14] attribute cotangents
  float* s_ls = s_pg + 14 * n_prim;    // [n_ls] light and sky cotangents
  for (int j = threadIdx.x; j < L.n_tab; j += BLOCK) tab[j] = g_tab[j];
  for (int j = threadIdx.x; j < 14 * n_prim + n_ls; j += BLOCK) s_pg[j] = 0.0f;
  __syncthreads();

  const float* S = tab + L.sph;    // cx cy cz cr2 srad        [n_s]
  const float* Wt = tab + L.wall;  // nx..wd (15 columns)       [n_w]
  const float* B = tab + L.box;    // min xyz, max xyz          [n_b]
  const float* M = tab + L.mat;    // r g b amb met dif spe exp [n_prim]
  const float* P = tab + L.pt;     // position xyz, color rgb   [n_pt]
  const float* U = tab + L.sun;    // unit direction, color     [n_sun]
  const float* sky = tab + L.sky;
#define SC(col, i) S[(col) * n_s + (i)]
#define WC(col, i) Wt[(col) * n_w + (i)]
#define BC(col, i) B[(col) * n_b + (i)]
#define MC(col, i) M[(col) * n_prim + (i)]

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
      const bool act = alive && bi >= 0;   // a hit: the shading runs
      const bool miss = alive && bi < 0;   // the sky
      const bool is_last = k == L.depth;

      // Cotangents of this level's inputs and attributes.
      float c_o[3] = {0.0f, 0.0f, 0.0f}, c_d[3] = {0.0f, 0.0f, 0.0f};
      float c_w = 0.0f;
      float ca[14];
#pragma unroll
      for (int c = 0; c < 14; ++c) ca[c] = 0.0f;

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

      if (__any_sync(FULL, act)) {
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
          colr = MC(0, bi); colg = MC(1, bi); colb = MC(2, bi); amb = MC(3, bi);
          met = MC(4, bi); dif = MC(5, bi); spe = MC(6, bi); exq = MC(7, bi);
          if (kind == 0) {
            g[0] = SC(0, bi); g[1] = SC(1, bi); g[2] = SC(2, bi); g[3] = SC(4, bi);
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
            for (int j = 0; j < 3; ++j) { g[j] = WC(j, q); g[3 + j] = WC(10 + j, q); }
            denom = d[0] * g[0] + d[1] * g[1] + d[2] * g[2];
            ok = fabsf(denom) > 1e-12f;
            num = (g[3] - o[0]) * g[0] + (g[4] - o[1]) * g[1] + (g[5] - o[2]) * g[2];
            if (ok) tt = num / denom;
#pragma unroll
            for (int j = 0; j < 3; ++j) { hp[j] = o[j] + d[j] * tt; hn[j] = g[j]; }
          } else {
            const int q = bi - box_base;
#pragma unroll
            for (int j = 0; j < 6; ++j) g[j] = BC(j, q);
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
          for (int si = 0; si < L.n_sun; ++si) {
            const Lobes f = lobes_fwd(U[si], U[L.n_sun + si], U[2 * L.n_sun + si],
                                      vw[0], vw[1], vw[2], hn[0], hn[1], hn[2],
                                      dif, spe, exq);
            ir = ir + U[3 * L.n_sun + si] * f.term;
            ig = ig + U[4 * L.n_sun + si] * f.term;
            ib = ib + U[5 * L.n_sun + si] * f.term;
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

        // ---- adjoint of the lights (every lane of the warp runs the loop,
        // for the warp sums of the light cotangents) ----
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
            const float c_n2 = n2 >= 1e-12f ? c_inv * (-0.5f * (inv * inv * inv)) : 0.0f;
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
        for (int si = 0; si < L.n_sun; ++si) {
          float cs[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
          if (act) {
            const float l[3] = {U[si], U[L.n_sun + si], U[2 * L.n_sun + si]};
            const Lobes f = lobes_fwd(l[0], l[1], l[2], vw[0], vw[1], vw[2],
                                      hn[0], hn[1], hn[2], dif, spe, exq);
            cs[3] = c_ir * f.term; cs[4] = c_ig * f.term; cs[5] = c_ib * f.term;
            const float c_term = c_ir * U[3 * L.n_sun + si] + c_ig * U[4 * L.n_sun + si]
                                 + c_ib * U[5 * L.n_sun + si];
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
            if (g[3] >= 1e-12f) ca[3] -= c_inv_r * (inv_r * inv_r);
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

        // ---- attribute cotangents: one warp sum per distinct winner ----
        unsigned pending = __ballot_sync(FULL, act);
        while (pending) {
          const int key = __shfl_sync(FULL, bi, __ffs(pending) - 1);
          const bool mine = act && bi == key;
          pending &= ~__ballot_sync(FULL, mine);
#pragma unroll
          for (int c = 0; c < 14; ++c) warp_add(&s_pg[14 * key + c], mine ? ca[c] : 0.0f);
        }
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
#undef SC
#undef WC
#undef BC
#undef MC

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
  Layout L = make_layout(n_s, unroll, n_w, n_b, n_pt, n_sun, gate, depth);
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
