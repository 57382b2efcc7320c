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
// The fold, the shading and the bounce are trace_common.cuh's, which the
// per-level kernel (trace_level.cu) shares. Float semantics follow the plain
// PyTorch version op for op (-fmad=false, no fast math).

#include "trace_common.cuh"

namespace {

using namespace rt;

constexpr int BLOCK = 256;

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
  const Tab T = tab_whole(L, tab);

  Ray ray{ox_p[r], oy_p[r], oz_p[r], dx_p[r], dy_p[r], dz_p[r]};
  float w = w_p[r];
  float accr = 0.0f, accg = 0.0f, accb = 0.0f;

  for (int k = 0; k <= L.depth; ++k) {
    const long long out = (long long)k * n + r;
    if (EMIT_RES && k >= 1) {
      float* res = res_p + (long long)(k - 1) * 7 * n + r;
      res[0] = ray.ox; res[n] = ray.oy; res[2 * n] = ray.oz;
      res[3 * n] = ray.dx; res[4 * n] = ray.dy; res[5 * n] = ray.dz; res[6 * n] = w;
    }
    if (!(w > 0.0f)) {
      t_p[out] = MISS_T;
      i_p[out] = -1;
      continue;
    }

    // ---- closest-hit fold: walls, boxes (strict <), then every sphere
    // chunk behind its gate (ties to the lower global index) ----
    const RayTerms q = ray_terms(ray);
    float bt = MISS_T;
    int bi = -1;
    fold_walls_boxes(T, ray, q, bt, bi);
    float t0, t_ex;
    if (T.n_c && slab_segment(T, ray, q, t0, t_ex)) {
      for (int c = 0; c < T.n_c; ++c) {
        if (!chunk_gate(T, c, ray, q, t0, fminf(t_ex, bt))) continue;
        fold_chunk(T, c, ray, q, bt, bi);
      }
    }

    // ---- winner record, shading, sky, accumulate, bounce ----
    t_p[out] = shade_bounce(T, bt, bi, k == L.depth, q, ray, w, accr, accg, accb);
    i_p[out] = bi;
  }

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
  rt::Layout L = rt::make_layout(n_s, unroll, n_w, n_b, n_pt, n_sun, gate, depth);
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
