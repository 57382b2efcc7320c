"""Design variants of the whole-trace kernels, timed on one CUDA card.

    python3 tools/whole_variants.py [--root DIR] [--variants a,b,...] [--out FILE]

Each variant is a copy of the package's csrc/ with one or more lines
changed (``VARIANTS``), or the package with one constant of
``ops/cuda_fold.py`` set otherwise (``PY_VARIANTS``): the fold's
cooperative threshold ``K_PAIR`` of trace_common.cuh (which trace_level.cu
and fold_shortlist.cu share), the lane layout of the cooperative route
(its 32x8 tiles against 16x16 and 8x32 tiles and strips of a row), the backward's light and sky sums per lane against per warp, its
sphere rows summed per block in shared memory against float64 atomics, the
blocks an SM asked of the compiler, and the backward without its attribute
and light sums (timing only: its sums are then wrong). The ``*_parent``
variants patch the package before this design, given with ``--root DIR``
(the package at DIR is the one patched and timed). The named variants (by
default all but the ``*_parent`` ones; ``package`` is the unchanged
package) are built at once with the package's flags and a ``ptxas -v``
report, then run in turns, ``package`` first and last: the forward with and
without its residual planes and the backward on each frame of
``chip_smoke.WHOLE_DIAG_FRAMES``, through ``chip_smoke.whole_diagnosis``.

Prints the card's name and power limit, a line per measurement, and one
JSON line of them all (also written to FILE with ``--out``).
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
# level_variants puts the package at --root first on the path, loads this
# checkout's chip_smoke.py, and patches copies of csrc/ (variant_csrc).
import level_variants as lv  # noqa: E402
import torch  # noqa: E402

from raytracer_tpu_torch.ops import cuda_fold  # noqa: E402  (the package at --root)

cs, sv, _build = lv.cs, lv.sv, lv._build

SOURCES = ("trace_whole", "trace_whole_bwd")
K_PAIR = "constexpr int K_PAIR = 8;"
FWD_BOUNDS = "__global__ void __launch_bounds__(BLOCK) trace_whole_kernel("
BWD_MIN = "constexpr int MIN_BLOCKS = 2;"
SPHERES_MAX = "constexpr int SHARED_SPHERES_MAX = 16;"
# The winner's sphere columns and materials copied into shared memory after
# the fold's table, where the package reads them from device memory.
TABLE_SHARED = {"trace_whole.cu": [
    ("    T = tab_level_shared(L, g_tab, sm4, &sph);  // ends with __syncthreads",
     "    T = tab_level_shared(L, g_tab, sm4, &sph);\n"
     "    float* extra = reinterpret_cast<float*>(sm4) + level_table_floats(L);\n"
     "    for (int j = threadIdx.x; j < 5 * L.n_s + (L.chunk - L.mat); j += blockDim.x)\n"
     "      extra[j] = g_tab[j < 5 * L.n_s ? L.sph + j : L.mat + (j - 5 * L.n_s)];\n"
     "    __syncthreads();\n"
     "    T.S = extra; T.M = extra + 5 * L.n_s;"),
    ("  const size_t smem = (size_t)(COOP ? level_table_floats(L) : L.n_tab) * sizeof(float);",
     "  const size_t smem = (size_t)(COOP ? level_table_floats(L) + 5 * L.n_s + (L.chunk - L.mat)"
     " : L.n_tab) * sizeof(float);"),
]}
# name: {csrc file: [(line in the package's source, its replacement), ...],
#        and optionally "cuda_fold": {constant: value}}
VARIANTS = {
    "package": {},
    # The cooperative fold from fewer than K lanes; 1 never, 33 always.
    **{f"k_pair{k}": {"trace_common.cuh": [(K_PAIR, K_PAIR.replace("8", str(k)))]}
       for k in (1, 4, 12, 16, 33)},
    "table_shared": TABLE_SHARED,
    # sqrtf on every sphere's discriminant, misses included (sphere_t).
    "plain_sqrt": {"trace_common.cuh": [(lv.SQRT_SKIP, "  tt = -b_half - sqrtf(disc);")]},
    **{f"fwd_min_blocks{k}": {"trace_whole.cu": [(FWD_BOUNDS, FWD_BOUNDS.replace(
        "(BLOCK)", f"(BLOCK, {k})"))]} for k in (4, 6)},
    **{f"bwd_min_blocks{k}": {"trace_whole_bwd.cu": [(BWD_MIN, BWD_MIN.replace("2", str(k)))]}
       for k in (1, 3)},
    # The light and sky cotangents summed over the warp per ray.
    "bwd_warp_ls": {"trace_common.cuh": [("constexpr int LANE_LS_MAX = 32;",
                                          "constexpr int LANE_LS_MAX = 0;")]},
    # Every sphere row added with float64 atomics; sphere rows summed per
    # block in shared memory up to 64 and 768 spheres.
    "bwd_sphere_atomics": {"trace_whole_bwd.cu": [(SPHERES_MAX, SPHERES_MAX.replace("16", "-1"))]},
    **{f"bwd_shared_spheres{k}": {"trace_whole_bwd.cu": [(SPHERES_MAX, SPHERES_MAX.replace(
        "16", str(k)))]} for k in (64, 768)},
    # The backward without its attribute and light sums (timing only).
    "bwd_no_sums": {
        "trace_whole_bwd.cu": [("      if (group_sums(act, bi, ca)) {", "      if (false) {")],
        "trace_common.cuh": [("  __device__ __forceinline__ void add(int j, float v) const "
                              "{ s[j * BLOCK + threadIdx.x] += v; }",
                              "  __device__ __forceinline__ void add(int, float) const {}")],
    },
    # The parent's backward without its attribute and light sums (timing
    # only): no ballot loop of warp sums, no warp sums of the light slots.
    "bwd_no_sums_parent": {
        "trace_whole_bwd.cu": [("unsigned pending = __ballot_sync(FULL, act);",
                                "unsigned pending = 0u;")],
        "trace_common.cuh": [("  __device__ __forceinline__ void add(int j, float v) const "
                              "{ warp_add(&s[j], v); }",
                              "  __device__ __forceinline__ void add(int, float) const {}")],
    },
}
# name: {constant of ops/cuda_fold.py: its value for the variant}: warps of
# 32 consecutive pixels of a row (strips of 256 over the flat planes), and
# tiles of other shapes.
PY_VARIANTS = {
    "strips": {"WHOLE_TILE": (1, 256)},
    "tile8x32": {"WHOLE_TILE": (8, 32)},
    "tile16x16": {"WHOLE_TILE": (16, 16)},
    "tile64x4": {"WHOLE_TILE": (64, 4)},
}


def whole_times() -> dict:
    """Per frame of ``chip_smoke.WHOLE_DIAG_FRAMES``, the forward's,
    the forward's with residuals and the backward's ms."""
    diag = cs.whole_diagnosis("cuda", reach=False)
    return {name: {k: sc[k][0] for k in ("fwd_ms", "fwd_res_ms", "bwd_ms")}
            for name, sc in diag["scenes"].items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("whole_variants: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = cs.card_line()
    print(f"{smi} (package at {_build.CSRC.parents[1]})", flush=True)
    names = [n for n in (*VARIANTS, *PY_VARIANTS) if not n.endswith("_parent")]
    if "--variants" in sys.argv:
        names = sys.argv[sys.argv.index("--variants") + 1].split(",")
    package_csrc = _build.CSRC
    scratch = Path(tempfile.mkdtemp(prefix="whole_variants_"))
    dirs = {name: lv.variant_csrc({f: e for f, e in VARIANTS.get(name, {}).items()
                                   if f != "cuda_fold"}, scratch) for name in names}
    builds, reports = [], {}
    for name, csrc in dirs.items():
        if csrc in dirs.values() and name != next(n for n, c in dirs.items() if c == csrc):
            reports[name] = None  # a variant of cuda_fold.py on an earlier variant's csrc/
            continue
        builds += sv.start_builds(csrc, SOURCES)
        reports[name] = cs.ptxas_start(SOURCES)  # reads _build.CSRC, set by start_builds
    sv.finish_builds(builds)
    runs = []
    order = names + ["package"] if "package" in names else names
    for name in order:
        sv.use(dirs[name])
        py = PY_VARIANTS.get(name, VARIANTS.get(name, {}).get("cuda_fold", {}))
        saved = {k: getattr(cuda_fold, k) for k in py}
        for k, v in py.items():
            setattr(cuda_fold, k, v)
        row = {"variant": name, "times": whole_times()}
        for k, v in saved.items():
            setattr(cuda_fold, k, v)
        if reports[name] is not None and name not in {r["variant"] for r in runs}:
            row["ptxas"] = [{k: v for k, v in x.items() if k not in ("cubin", "mangled")}
                            for x in cs.ptxas_finish(reports[name])]
            for x in row["ptxas"]:
                print(f"variant {name} ptxas {x['kernel']}: registers={x.get('registers')} "
                      f"spill_stores={x.get('spill_stores')} spill_loads={x.get('spill_loads')}",
                      flush=True)
        for scene, t in row["times"].items():
            print(f"variant {name} {scene}: trace_whole_ms={t['fwd_ms']:.4f} "
                  f"emit_res_ms={t['fwd_res_ms']:.4f} trace_whole_bwd_ms={t['bwd_ms']:.4f}",
                  flush=True)
        runs.append(row)
    sv.use(package_csrc)
    shutil.rmtree(scratch, ignore_errors=True)
    line = json.dumps({"card": smi, "variants": runs})
    if "--out" in sys.argv:
        Path(sys.argv[sys.argv.index("--out") + 1]).write_text(line)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
