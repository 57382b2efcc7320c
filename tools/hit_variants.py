"""Design variants of the closest-hit shortlist kernels, timed on one CUDA card.

    python3 tools/hit_variants.py [--root DIR] [--variants a,b,...] [--out FILE]

Each variant is a copy of the package's csrc/ with one or more lines
changed (``VARIANTS``): the cooperative threshold ``K_PAIR`` and the least
chunk size that folds cooperatively (trace_common.cuh's ``K_PAIR`` and
``PAIR_MIN_UNROLL``, which trace_level.cu shares), the sphere table as
columns in shared memory (the parent's layout) against float4, the square root of every discriminant, and
the blocks an SM asked of the compiler. The package at ``--root DIR`` is the
one patched and timed. The named variants (by default all; ``package`` is
the unchanged csrc/) are built at once with the package's flags and a
``ptxas -v`` report, then run in turns, ``package`` first and last: both
variants of the kernel (fold and record) per launch on the depth pass's
primary rays of grid-1024, grid-64, sprint3 and grid-2048 at 1920x1080, of c5 (grid-1024 at
3840x2160, 4 row chunks) and of c1, and on each level of the grid-1024
1920x1080 d3 loop around ``closest_hit_soa``, through
``chip_smoke.hit_diagnosis``.

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

cs, sv, _build = lv.cs, lv.sv, lv._build

SOURCES = ("fold_shortlist",)
# name: {csrc file: [(line in the package's source, its replacement), ...]}
K_PAIR = "constexpr int K_PAIR = 8;"
MIN_UNROLL = "constexpr int PAIR_MIN_UNROLL = 2;"
BOUNDS = "__global__ void __launch_bounds__(BLOCK) fold_shortlist_kernel("
SQRT_SKIP = lv.SQRT_SKIP
# The spheres as four columns in shared memory (tab_fold_shared), read by
# both fold routes column by column.
COLUMNS = {
    "fold_shortlist.cu": [
        ("int* s_list = reinterpret_cast<int*>(reinterpret_cast<float*>(sm4) + "
         "level_table_floats(L));",
         "int* s_list = reinterpret_cast<int*>(reinterpret_cast<float*>(sm4) + fold_floats(L));"),
        ("  const float4* sph;\n  const Tab T = tab_level_shared(L, g_tab, sm4, &sph);",
         "  const float4* sph = nullptr;\n"
         "  const Tab T = tab_fold_shared(L, g_tab, reinterpret_cast<float*>(sm4));"),
        ("(size_t)(rt::level_table_floats(L) + L.n_c) * sizeof(float);",
         "(size_t)(rt::fold_floats(L) + L.n_c) * sizeof(float);"),
    ],
    "trace_common.cuh": [
        ("    const float4 g = sph[i];\n",
         "    const float4 g = make_float4(T.sc(0, i), T.sc(1, i), T.sc(2, i), T.sc(3, i));\n"),
        ("has ? sph[i] : make_float4",
         "has ? make_float4(T.sc(0, i), T.sc(1, i), T.sc(2, i), T.sc(3, i)) : make_float4"),
    ],
}
VARIANTS = {
    "package": {},
    # The cooperative fold from fewer than K lanes; 1 never, 33 always.
    **{f"k_pair{k}": {"trace_common.cuh": [(K_PAIR, K_PAIR.replace("8", str(k)))]}
       for k in (1, 6, 10, 12, 16, 33)},
    # The cooperative fold only for chunks of at least U spheres.
    **{f"min_unroll{u}": {"trace_common.cuh": [(MIN_UNROLL, MIN_UNROLL.replace("2", str(u)))]}
       for u in (1, 8, 16, 32)},
    "columns": COLUMNS,
    # sqrtf on every sphere's discriminant, misses included (sphere_t).
    "plain_sqrt": {"trace_common.cuh": [(SQRT_SKIP, "  tt = -b_half - sqrtf(disc);")]},
    **{f"min_blocks{k}": {"fold_shortlist.cu": [(BOUNDS, BOUNDS.replace("(BLOCK)", f"(BLOCK, {k})"))]}
       for k in (4, 5)},
}


def hit_times() -> dict:
    """Per workload of ``chip_smoke.hit_diagnosis``, both variants' ms per
    launch."""
    diag = cs.hit_diagnosis("cuda", reach=False)
    return {name: {"fold_ms": sc["fold_ms"], "hit_ms": sc["hit_ms"]}
            for name, sc in diag["scenes"].items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("hit_variants: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = cs.card_line()
    print(f"{smi} (package at {_build.CSRC.parents[1]})", flush=True)
    names = list(VARIANTS)
    if "--variants" in sys.argv:
        names = sys.argv[sys.argv.index("--variants") + 1].split(",")
    package_csrc = _build.CSRC
    scratch = Path(tempfile.mkdtemp(prefix="hit_variants_"))
    dirs = {name: lv.variant_csrc(VARIANTS[name], scratch) for name in names}
    builds, reports = [], {}
    for name, csrc in dirs.items():
        builds += sv.start_builds(csrc, SOURCES)
        reports[name] = cs.ptxas_start(SOURCES)  # reads _build.CSRC, set by start_builds
    sv.finish_builds(builds)
    runs = []
    order = names + ["package"] if "package" in names else names
    for name in order:
        sv.use(dirs[name])
        row = {"variant": name, "times": hit_times()}
        if name not in {r["variant"] for r in runs}:
            row["ptxas"] = [{k: v for k, v in x.items() if k not in ("cubin", "mangled")}
                            for x in cs.ptxas_finish(reports[name])]
            for x in row["ptxas"]:
                print(f"variant {name} ptxas {x['kernel']}: registers={x.get('registers')} "
                      f"spill_stores={x.get('spill_stores')} spill_loads={x.get('spill_loads')}",
                      flush=True)
        for scene, t in row["times"].items():
            print(f"variant {name} {scene}: fold_shortlist_ms={[round(v, 4) for v in t['fold_ms']]} "
                  f"(sum {sum(t['fold_ms']):.4f}) fold_shortlist_hit_ms="
                  f"{[round(v, 4) for v in t['hit_ms']]} (sum {sum(t['hit_ms']):.4f})", flush=True)
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
