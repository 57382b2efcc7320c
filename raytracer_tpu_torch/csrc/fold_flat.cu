// The brute-force closest-hit fold: (min t, argmin global index) of every
// ray over every sphere, wall and box of the scene, with no chunk gate.
//
// Replaces the TPU kernel `_kernel` of raytracer_tpu/ops/pallas_fold.py
// (built by `_fold_flat`, entry `fold_closest_pallas`), which folds an
// (8, 128) tile of a flattened ray batch in VMEM over the whole primitive
// table, kept in SMEM through scalar prefetch and padded to its unroll:
// every sphere (strict <, ascending index), then every wall, then every box
// (strict <).
//
// Design: blocks of BLOCK threads, each thread R rays of the flat batch (a
// template argument, 1 or 2: cuda_hit.flat_rays picks 2, or 1 for a batch of
// fewer than 100,000 rays, such as each level of a 320x240 frame, whose few
// blocks would leave SMs idle; tools/flat_variants.py adds 4, which lost on
// every workload), ray j of thread k of group g being ray g * BLOCK * R + j *
// BLOCK + k, so each of a warp's loads and stores is one contiguous run. The
// sphere table sits in shared memory as float4 (centre, |c|^2 - r^2): in one
// copy, loaded beside the rays, while it and the walls and boxes take at most
// 48 KB (cuda_hit.flat_plan), else in tiles of 2048 spheres, each copied
// between two __syncthreads. A thread takes the discriminants of GROUP spheres
// for its R rays (one broadcast load a sphere, R independent dependency
// chains), then branches once into the square roots of those tests that meet
// their sphere ahead: disc >= 0 and b_half < 0, the guard of trace_common.cuh's
// `sphere_ahead`, whose parts (`sphere_c_full`, `sphere_disc`, `sphere_guard`,
// `sphere_near`) it calls apart, and whose root has the bits of `sphere_t`
// wherever it is > 0. A ray misses nearly every sphere it is tested against:
// sqrtf of a negative operand takes its slow path, and a branch a test costs
// its convergence barrier too. Where every ray of a block starts at one origin
// (a camera's rays, bit for bit), each sphere's c_full = |o|^2 - 2 o.c + |c|^2
// - r^2 is taken once, in shared memory, from the operands and in the order
// each ray would use (the same bits), and a test is then s, b_half and disc: 8
// float32 operations instead of 16. The walls and boxes go into shared memory
// beside the spheres (their columns as they are in the packed table); a ray's
// safe reciprocal direction is computed only where the scene has boxes, after
// the spheres. The spheres are visited in ascending index with a strict <, so
// ties go to the lower index; the walls and boxes come after them with a strict
// <. The result is the lexicographic minimum of (t, index), which the gated
// folds (fold_shortlist.cu, trace_level.cu) and the plain version compute too.
// The fold is ungated on purpose: every ray tests every primitive, so for
// directions that are not unit it answers where the gated folds may not. Rays
// past the end of the batch are tested as a ray along +z from the origin and
// not stored. cuda_hit.fold_flat_mirror follows this order of work in plain
// PyTorch.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): the kernel reads 6
// ray planes and writes (t, index): 8 planes, 32 bytes a ray (66 MB at
// 1920x1080, 20 us). The operations the function needs (chip_smoke.py's
// `flat_ops`): 10 a ray-sphere test (d.c, b_half, disc, the guard's two
// compares); the origin's term, 8, once a sphere for each distinct origin;
// the root, 4, only for the tests that meet their sphere ahead (~0.1% on
// grid-1024). So on scenes past ~30 spheres operations bound it: grid-1024's
// camera rays at 1920x1080 (one origin) ~21 GFLOP, 0.32 ms; its bounce rays
// (an origin each, 18 a test) ~38 GFLOP, 0.57 ms. That bound counts an FMA
// as two operations; built with -fmad=false a lane retires one float32
// operation a cycle, the rate of its issue slots, so the same count over 132
// SMs x 128 lanes at the SM clock (1.98 GHz under load) is this build's
// floor, twice the bound: 0.64 ms and 1.15 ms. Measured on an H100
// (PERF.md), grid-1024's camera rays take ~16 issue slots a test and its
// bounce levels ~24: the loop's load, guard branch and compares over the
// formula's 10 and 18.
//
// Build with -fmad=false and without fast math (ops/_build.py): the result
// is then bit-identical to the plain PyTorch version's.

#include "trace_common.cuh"

namespace {

using namespace rt;

constexpr int BLOCK = 256;  // threads a block (cuda_hit.FLAT_BLOCK)
constexpr int GROUP = 4;    // spheres whose tests one guard branch covers
// With a block whose rays all start at one origin, each sphere's c_full
// (|o|^2 - 2 o.c + |c|^2 - r^2) is taken once, as the table goes into shared
// memory: the same operands and ops as each ray's own, so the same bits.
constexpr bool ONE_ORIGIN = true;

// Shared bytes of a launch: `tile` spheres (at most n_s) as float4, then the
// wall and box columns of the packed table (15 and 6 floats each).
inline size_t flat_smem(const Layout& L, int tile) {
  return (size_t)(tile < L.n_s ? tile : L.n_s) * sizeof(float4) +
         (size_t)(L.mat - L.wall) * sizeof(float);
}

// b_half and disc of one ray against one sphere (trace_common.cuh's
// sphere_ahead, in parts): c.w is |c|^2 - r^2, or with ONE the whole
// c_full of the block's shared origin.
template <bool ONE>
__device__ __forceinline__ void disc_terms(const float4& c, const Ray& r, const RayTerms& q,
                                           float& b_half, float& disc) {
  const float c_full = ONE ? c.w : sphere_c_full(c.x, c.y, c.z, c.w, r.ox, r.oy, r.oz, q.oo);
  sphere_disc(c.x, c.y, c.z, c_full, r, q, b_half, disc);
}

// sphere_ahead's root where the ray meets sphere i ahead, into (bt, bi).
__device__ __forceinline__ void take_root(float b_half, float disc, int i, float& bt, int& bi) {
  if (sphere_guard(b_half, disc)) {
    const float tt = sphere_near(b_half, disc);
    if (tt > 0.0f && tt < bt) {
      bt = tt;
      bi = i;
    }
  }
}

// Spheres base .. base + m - 1 (sph[0 .. m - 1]) against a thread's R rays,
// in ascending index with a strict <. Each GROUP spheres' tests take their
// discriminants first and branch once into the roots, where any of them
// meets its sphere ahead (rare: a ray misses nearly every sphere).
template <int R, bool ONE>
__device__ __forceinline__ void fold_spheres(const float4* sph, int m, int base, const Ray* ray,
                                             const RayTerms* q, float* bt, int* bi) {
  int k = 0;
  for (; k + GROUP <= m; k += GROUP) {
    float bh[GROUP][R], ds[GROUP][R];
    bool any = false;
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const float4 c = sph[k + g];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        disc_terms<ONE>(c, ray[j], q[j], bh[g][j], ds[g][j]);
        any |= sphere_guard(bh[g][j], ds[g][j]);
      }
    }
    if (any) {
#pragma unroll
      for (int g = 0; g < GROUP; ++g)
#pragma unroll
        for (int j = 0; j < R; ++j) take_root(bh[g][j], ds[g][j], base + k + g, bt[j], bi[j]);
    }
  }
  for (; k < m; ++k) {
    const float4 c = sph[k];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float b_half, disc;
      disc_terms<ONE>(c, ray[j], q[j], b_half, disc);
      take_root(b_half, disc, base + k, bt[j], bi[j]);
    }
  }
}

// Spheres base .. base + m - 1 of the packed table into sm4 as float4:
// the centre and |c|^2 - r^2.
__device__ __forceinline__ void copy_spheres(const Layout& L, const float* g_tab, int base, int m,
                                             float4* sm4) {
  const float* S = g_tab + L.sph;
  for (int k = threadIdx.x; k < m; k += BLOCK) {
    const int j = base + k;
    sm4[k] = make_float4(S[j], S[L.n_s + j], S[2 * L.n_s + j], S[3 * L.n_s + j]);
  }
}

// The w of the entries of sm4[0 .. m - 1] this thread copied (copy_spheres)
// turned into c_full for origin o: |o|^2 - 2 o.c + w, as each ray with that
// origin would take it.
__device__ __forceinline__ void one_origin(float4* sm4, int m, const float* o) {
  const float oo = o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
  for (int k = threadIdx.x; k < m; k += BLOCK) {
    const float4 c = sm4[k];
    sm4[k].w = sphere_c_full(c.x, c.y, c.z, c.w, o[0], o[1], o[2], oo);
  }
}

template <int R>
__global__ void __launch_bounds__(BLOCK) fold_flat_kernel(
    Layout L, const float* __restrict__ g_tab, int tile,
    const float* __restrict__ ox_p, const float* __restrict__ oy_p,
    const float* __restrict__ oz_p, const float* __restrict__ dx_p,
    const float* __restrict__ dy_p, const float* __restrict__ dz_p,
    float* __restrict__ t_p, int* __restrict__ i_p, long long n) {
  extern __shared__ float4 sm4[];
  __shared__ float s_origin[3];
  const int n_tile = min(tile, L.n_s);
  const bool whole = n_tile == L.n_s;
  float* wb = reinterpret_cast<float*>(sm4 + n_tile);
  for (int j = threadIdx.x; j < L.mat - L.wall; j += BLOCK) wb[j] = g_tab[L.wall + j];
  Tab T = tab_counts(L);
  T.Wt = wb;
  T.B = wb + (L.box - L.wall);

  const long long r0 = (long long)blockIdx.x * (BLOCK * R) + threadIdx.x;
  Ray ray[R];
  RayTerms q[R];
  float bt[R];
  int bi[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const long long r = r0 + (long long)j * BLOCK;
    ray[j] = r < n ? Ray{ox_p[r], oy_p[r], oz_p[r], dx_p[r], dy_p[r], dz_p[r]}
                   : Ray{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
    const Ray& a = ray[j];
    q[j].oo = a.ox * a.ox + a.oy * a.oy + a.oz * a.oz;
    q[j].dod = a.dx * a.ox + a.dy * a.oy + a.dz * a.oz;
    bt[j] = MISS_T;
    bi[j] = -1;
  }
  if (whole) copy_spheres(L, g_tab, 0, L.n_s, sm4);  // its loads in flight with the rays'
  if (threadIdx.x == 0) {  // the block's first ray
    s_origin[0] = ray[0].ox;
    s_origin[1] = ray[0].oy;
    s_origin[2] = ray[0].oz;
  }
  __syncthreads();  // s_origin, the walls and boxes (and a whole sphere table) are in
  bool same = true;
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (r0 + (long long)j * BLOCK < n)
      same &= __float_as_uint(ray[j].ox) == __float_as_uint(s_origin[0]) &&
              __float_as_uint(ray[j].oy) == __float_as_uint(s_origin[1]) &&
              __float_as_uint(ray[j].oz) == __float_as_uint(s_origin[2]);
  const bool one = __syncthreads_and(ONE_ORIGIN && same && L.n_s > 0) != 0;
  if (whole && one) {
    one_origin(sm4, L.n_s, s_origin);
    __syncthreads();
  }

  for (int base = 0; base < L.n_s; base += n_tile) {
    const int m = min(n_tile, L.n_s - base);
    if (!whole) {
      __syncthreads();  // every thread is done with the last tile
      copy_spheres(L, g_tab, base, m, sm4);
      if (one) one_origin(sm4, m, s_origin);
      __syncthreads();
    }
    if (one)
      fold_spheres<R, true>(sm4, m, base, ray, q, bt, bi);
    else
      fold_spheres<R, false>(sm4, m, base, ray, q, bt, bi);
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const long long r = r0 + (long long)j * BLOCK;
    if (r >= n) continue;
    if (L.n_b) {  // only boxes read the reciprocal direction
      q[j].ivx = srecip(ray[j].dx);
      q[j].ivy = srecip(ray[j].dy);
      q[j].ivz = srecip(ray[j].dz);
    }
    fold_walls_boxes(T, ray[j], q[j], bt[j], bi[j]);
    t_p[r] = bt[j];
    i_p[r] = bi[j];
  }
}

template <int R>
int launch(const Layout& L, const float* tab, int tile, const float* ox, const float* oy,
           const float* oz, const float* dx, const float* dy, const float* dz, float* t_out,
           int* i_out, long long n, cudaStream_t stream) {
  const long long groups = (n + BLOCK * R - 1) / (BLOCK * R);
  if (groups > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = flat_smem(L, tile);
  cudaError_t err = opt_in_smem(fold_flat_kernel<R>, smem);
  if (err != cudaSuccess) return (int)err;
  fold_flat_kernel<R><<<(unsigned)groups, BLOCK, smem, stream>>>(L, tab, tile, ox, oy, oz, dx, dy,
                                                                 dz, t_out, i_out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared bytes of a fold_flat launch with spheres in tiles of `tile`
// (cuda_hit.flat_smem_bytes mirrors it).
long long fold_flat_smem_bytes(int n_s, int n_w, int n_b, int tile) {
  return (long long)flat_smem(rt::make_layout(n_s, 1, n_w, n_b, 0, 0, 0, 0), tile);
}

// Folds the n rays of the six planes (any layout, n elements each) into
// t_out and i_out, `rays` (1 or 2) a thread, the spheres in shared memory
// in tiles of `tile` (n_s or more: the whole table in one copy). Returns the
// CUDA error of the launch (0 on success).
int fold_flat_launch(const float* tab, int n_tab, int n_s, int unroll, int n_w, int n_b,
                     int n_pt, int n_sun, int gate, int tile, int rays, const float* ox,
                     const float* oy, const float* oz, const float* dx, const float* dy,
                     const float* dz, float* t_out, int* i_out, long long n, void* stream) {
  const rt::Layout L = rt::make_layout(n_s, unroll, n_w, n_b, n_pt, n_sun, gate, 0);
  if (L.n_tab != n_tab || n <= 0 || tile < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (rays) {
    case 1: return launch<1>(L, tab, tile, ox, oy, oz, dx, dy, dz, t_out, i_out, n, st);
    case 2: return launch<2>(L, tab, tile, ox, oy, oz, dx, dy, dz, t_out, i_out, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* fold_flat_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
