"""Design variants of the per-level kernels, timed on one CUDA card.

    python3 tools/level_variants.py [--root DIR] [--variants a,b,...]
                                    [--compaction] [--out FILE]

Each variant is a copy of the package's csrc/ with one or more lines
changed (``VARIANTS``): the fold's cooperative threshold ``K_PAIR`` of
trace_common.cuh (which fold_shortlist.cu shares), its square root, its blocks an SM, the stats cull, the
backward's light sums and blocks an SM, or the backward's attribute
scatter or light sums cut out (timing only: its sums are then wrong). The
``*_parent`` variants patch the package before this design, given with
``--root DIR`` (the package at DIR is the one patched and timed). The named
variants (by default all but the ``*_parent`` ones; ``package`` is the
unchanged csrc/) are built at once with the package's flags and a ``ptxas
-v`` report, then run in turns, ``package`` first and last: both kernels'
per-level times on grid-1024 and grid-2048 at 1920x1080 d3 and on c5
(grid-1024 at 3840x2160 d4), through ``chip_smoke.level_diagnosis_scene``.

With ``--compaction``, then, on the package's own kernels, the dead-lane
compaction of bounce levels (``chip_smoke.compaction_variant``), timed
against the chain's own work on the same levels.

Prints the card's name and power limit, a line per measurement, and one
JSON line of them all (also written to FILE with ``--out``).
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if "--root" in sys.argv:
    sys.path.insert(0, sys.argv[sys.argv.index("--root") + 1])
sys.path.insert(1, str(ROOT))
sys.path.insert(2, str(ROOT / "tools"))

import torch  # noqa: E402

from raytracer_tpu_torch.ops import _build  # noqa: E402  (the package at --root)

# This checkout's chip_smoke.py, also where a package at --root has its own.
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
sys.modules["chip_smoke"] = cs
_spec.loader.exec_module(cs)
import soft_variants as sv  # noqa: E402

SOURCES = ("trace_level", "trace_level_bwd")
# name: {csrc file: [(line in the package's source, its replacement), ...]}
K_PAIR = "constexpr int K_PAIR = 8;"
SQRT_SKIP = ("  if (!(disc >= 0.0f && b_half < 0.0f)) return false;\n"
             "  tt = -b_half - sqrtf(disc);")
FOLD_LOOP = "  for (int i = c * T.unroll; i < i1; ++i) {\n    const float4 g = sph[i];"
FWD_BOUNDS = "__global__ void __launch_bounds__(BLOCK) trace_level_kernel("
BWD_MIN = "constexpr int MIN_BLOCKS = 2;"
VARIANTS = {
    "package": {},
    # The cooperative fold from fewer than K lanes; 1 never, 33 always.
    **{f"k_pair{k}": {"trace_common.cuh": [(K_PAIR, K_PAIR.replace("8", str(k)))]}
       for k in (1, 4, 12, 16, 33)},
    # sqrtf on every sphere's discriminant, misses included (sphere_t).
    "plain_sqrt": {"trace_common.cuh": [(SQRT_SKIP, "  tt = -b_half - sqrtf(disc);")]},
    # sqrtf of 1 for a miss, no branch.
    "select_sqrt": {"trace_common.cuh": [(
        SQRT_SKIP, "  tt = -b_half - sqrtf(disc >= 0.0f ? disc : 1.0f);\n"
                   "  if (!(disc >= 0.0f)) return false;")]},
    # The per-lane sphere loop unrolled.
    **{f"fold_unroll{k}": {"trace_common.cuh": [(FOLD_LOOP, f"#pragma unroll {k}\n" + FOLD_LOOP)]}
       for k in (2, 4, 8)},
    # The stats' exact gates on every chunk (no warp cull).
    "no_stats_cull": {"trace_common.cuh": [(
        "const bool cull = T.gate == GATE_AABB &&", "const bool cull = false &&")]},
    "fwd_min_blocks5": {"trace_level.cu": [(FWD_BOUNDS, FWD_BOUNDS.replace("(BLOCK)", "(BLOCK, 5)"))]},
    "fwd_min_blocks6": {"trace_level.cu": [(FWD_BOUNDS, FWD_BOUNDS.replace("(BLOCK)", "(BLOCK, 6)"))]},
    **{f"bwd_min_blocks{k}": {"trace_level_bwd.cu": [(BWD_MIN, BWD_MIN.replace("2", str(k)))]}
       for k in (1, 3, 4)},
    # The light and sky cotangents summed over the warp per ray.
    "bwd_warp_ls": {"trace_level_bwd.cu": [(
        "constexpr int LANE_LS_MAX = 32;", "constexpr int LANE_LS_MAX = 0;")]},
    # The backward without its light and sky sums (timing only).
    "bwd_no_light_sums": {"trace_level_bwd.cu": [(
        "  __device__ __forceinline__ void add(int j, float v) const "
        "{ s[j * BLOCK + threadIdx.x] += v; }",
        "  __device__ __forceinline__ void add(int, float) const {}")]},
    # The backward without its attribute scatter (timing only).
    "bwd_no_scatter": {"trace_level_bwd.cu": [("      if (act && rank == 0) {", "      if (false) {")]},
    "bwd_no_scatter_parent": {"trace_level_bwd.cu": [
        ("unsigned pending = __ballot_sync(FULL, act);", "unsigned pending = 0u;")]},
}
SCENES = (("grid1024_1920x1080_d3", 1024, 1920, 1080, 3),
          ("grid2048_1920x1080_d3", 2048, 1920, 1080, 3),
          ("c5_grid1024_3840x2160_d4", 1024, 3840, 2160, 4))


def variant_csrc(edits: dict, root: Path) -> Path:
    """A copy of csrc/ under ``root`` with ``edits`` applied (the
    package's own csrc/ when there are none)."""
    if not edits:
        return _build.CSRC
    out = Path(tempfile.mkdtemp(prefix="csrc_", dir=root))
    for f in _build.CSRC.iterdir():
        shutil.copy(f, out / f.name)
    for name, pairs in edits.items():
        text = (out / name).read_text()
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        (out / name).write_text(text)
    return out


def level_times() -> dict:
    """Per scene of SCENES, both kernels' ms per level."""
    out = {}
    for name, n, width, height, depth in SCENES:
        r = cs.level_diagnosis_scene(n, width, height, depth, "cuda", reach=False)
        out[name] = {"fwd_ms": r["fwd_ms"], "bwd_ms": r["bwd_ms_list"],
                     "no_stats_ms": [x.get("ms_no_stats") for x in r["levels"]],
                     "ray_stats_ms": r["stats_ms"]}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("level_variants: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = cs.card_line()
    print(f"{smi} (package at {_build.CSRC.parents[1]})", flush=True)
    names = [n for n in VARIANTS if not n.endswith("_parent")]
    if "--variants" in sys.argv:
        names = sys.argv[sys.argv.index("--variants") + 1].split(",")
    package_csrc = _build.CSRC
    scratch = Path(tempfile.mkdtemp(prefix="level_variants_"))
    dirs = {name: variant_csrc(VARIANTS[name], scratch) for name in names}
    builds, reports = [], {}
    for name, csrc in dirs.items():
        builds += sv.start_builds(csrc, SOURCES)
        reports[name] = cs.ptxas_start(SOURCES)  # reads _build.CSRC, set by start_builds
    sv.finish_builds(builds)
    runs = []
    order = names + ["package"] if "package" in names else names
    for name in order:
        sv.use(dirs[name])
        row = {"variant": name, "times": level_times()}
        if name not in {r["variant"] for r in runs}:
            row["ptxas"] = [{k: v for k, v in x.items() if k not in ("cubin", "mangled")}
                            for x in cs.ptxas_finish(reports[name])]
            for x in row["ptxas"]:
                print(f"variant {name} ptxas {x['kernel']}: registers={x.get('registers')} "
                      f"spill_stores={x.get('spill_stores')} spill_loads={x.get('spill_loads')}",
                      flush=True)
        for scene, t in row["times"].items():
            print(f"variant {name} {scene}: ray_stats_ms={t['ray_stats_ms']:.4f} "
                  f"trace_level_ms={[round(v, 4) for v in t['fwd_ms']]} "
                  f"no_stats_ms={[None if v is None else round(v, 4) for v in t['no_stats_ms']]} "
                  f"trace_level_bwd_ms={[round(v, 4) for v in t['bwd_ms']]}", flush=True)
        runs.append(row)
    sv.use(package_csrc)
    compaction = None
    if "--compaction" in sys.argv:
        compaction = [cs.compaction_variant(n, w, h, depth, "cuda") for _, n, w, h, depth in SCENES
                      if n == 1024]
        for r in compaction:
            print(f"compaction {r['name']}: {r}", flush=True)
    shutil.rmtree(scratch, ignore_errors=True)
    line = json.dumps({"card": smi, "variants": runs, "compaction": compaction})
    if "--out" in sys.argv:
        Path(sys.argv[sys.argv.index("--out") + 1]).write_text(line)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
