"""Design variants of the brute-force closest-hit kernel, timed on one CUDA card.

    python3 tools/flat_variants.py [--root DIR] [--variants a,b,...] [--sass DIR]
                                   [--out FILE]

Each variant is a copy of the package's csrc/ with one or more lines
changed (``VARIANTS``), or the package with one constant of
``ops/cuda_hit.py`` set otherwise (``PY_VARIANTS``), or both under one
name. The ``*_parent`` variants patch the package before this design,
given with ``--root DIR`` (the package at DIR is the one patched and
timed): the guarded square root (``sphere_ahead``) swapped in and nothing
else changed. The named
variants (by default all but the ``*_parent`` ones; ``package`` is the
unchanged package) are built at once with the package's flags and a
``ptxas -v`` report, then run in turns, ``package`` first and last:
``fold_flat`` on the primary rays of each frame of
``chip_smoke.FLAT_DIAG_FRAMES`` and on each level of the grid-1024
1920x1080 d3 loop, each launch also held bit for bit against the plain
version, through ``chip_smoke.flat_diagnosis``.

With ``--sass DIR``, each variant's SASS (``cuobjdump -sass`` of its
``ptxas -v`` cubin) goes to DIR, and its innermost loops (``sass_loops``:
instructions and opcodes of each backward branch's range) are printed.

Prints the card's name and power limit, a line per measurement, and one
JSON line of them all (also written to FILE with ``--out``).
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
# level_variants puts the package at --root first on the path, loads this
# checkout's chip_smoke.py, and patches copies of csrc/ (variant_csrc).
import level_variants as lv  # noqa: E402
import torch  # noqa: E402

from raytracer_tpu_torch.ops import cuda_hit  # noqa: E402  (the package at --root)

cs, sv, _build = lv.cs, lv.sv, lv._build

SOURCES = ("fold_flat",)
BLOCK = "constexpr int BLOCK = 256;"
GROUP = "constexpr int GROUP = 4;"
BOUNDS = "__global__ void __launch_bounds__(BLOCK) fold_flat_kernel("
ROOT_GUARD = "  if (sphere_guard(b_half, disc)) {"
RAYS2 = "    case 2: return launch<2>(L, tab, tile, ox, oy, oz, dx, dy, dz, t_out, i_out, n, st);"
# name: {csrc file: [(line in the package's source, its replacement), ...]}
VARIANTS = {
    "package": {},
    # Spheres a guard branch covers (1: a branch a sphere for a thread's rays).
    **{f"group{g}": {"fold_flat.cu": [(GROUP, GROUP.replace("4", str(g)))]} for g in (1, 2, 8)},
    # c_full taken by every ray, one origin or not.
    "no_one_origin": {"fold_flat.cu": [("constexpr bool ONE_ORIGIN = true;",
                                         "constexpr bool ONE_ORIGIN = false;")]},
    # Threads a block, blocks an SM asked of the compiler.
    **{f"block{b}": {"fold_flat.cu": [(BLOCK, BLOCK.replace("256", str(b)))]} for b in (128, 512)},
    **{f"min_blocks{k}": {"fold_flat.cu": [(BOUNDS, BOUNDS.replace("(BLOCK)", f"(BLOCK, {k})"))]}
       for k in (4, 6)},
    # sqrtf on every test, misses included (no guard branch).
    "plain_sqrt": {"fold_flat.cu": [
        (ROOT_GUARD, "  {  // sphere_near is NaN on a miss"),
        ("    if (any) {", "    if (true) {")]},
    # The walls and boxes read from the packed table in device memory.
    "walls_global": {"fold_flat.cu": [
        ("  for (int j = threadIdx.x; j < L.mat - L.wall; j += BLOCK) wb[j] = g_tab[L.wall + j];\n", ""),
        ("  T.Wt = wb;\n  T.B = wb + (L.box - L.wall);",
         "  T.Wt = g_tab + L.wall;\n  T.B = g_tab + L.box;")]},
    # Each ray's reciprocal direction before the spheres, boxes or not.
    "recip_always": {"fold_flat.cu": [
        ("    bt[j] = MISS_T;\n",
         "    q[j].ivx = srecip(a.dx);\n    q[j].ivy = srecip(a.dy);\n    q[j].ivz = srecip(a.dz);\n"
         "    bt[j] = MISS_T;\n"),
        ("    if (L.n_b) {  // only boxes read the reciprocal direction", "    if (false) {")]},
    # Four rays a thread, an instantiation the package leaves out (with
    # PY_VARIANTS' rays4: at every batch size).
    "rays4": {"fold_flat.cu": [(RAYS2, RAYS2 + "\n" + RAYS2.replace("2", "4"))]},
    # The first design with the guarded square root, nothing else changed.
    "guard_parent": {"fold_flat.cu": [(
        "        const float tt = sphere_t(c.x, c.y, c.z, c.w, ray, q);  // NaN on a miss\n"
        "        if (tt > 0.0f && tt < bt) {",
        "        float tt;\n"
        "        if (sphere_ahead(c.x, c.y, c.z, c.w, ray, q, tt) && tt < bt) {")]},
}
# name: {constant of ops/cuda_hit.py: its value for the variant}: rays a
# thread at every batch size (1, 2 or 4); the spheres always in tiles of 256
# (the first design's) or 2048, and the whole table in one copy up to the
# 227 KB a block can have.
PY_VARIANTS = {
    "rays1": {"FLAT_SMALL": 1 << 62},
    "rays2": {"FLAT_SMALL": 0},
    "rays4": {"FLAT_SMALL": 0, "FLAT_RAYS": 4},
    "tiles256": {"FLAT_WHOLE_MAX": 0, "FLAT_TILE": 256},
    "tiles2048": {"FLAT_WHOLE_MAX": 0, "FLAT_TILE": 2048},
    "whole_any": {"FLAT_WHOLE_MAX": cuda_hit.cuda_fold._SMEM_MAX},
}


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_BRA_TARGET = re.compile(r"\b0x([0-9a-f]+)")


def sass_loops(cubin: str, out: Path | None = None) -> dict:
    """The innermost loops of each kernel's SASS (``cuobjdump -sass`` of
    the ``ptxas -v`` cubin), by kernel: each backward ``BRA`` whose range
    holds no other backward branch, with its instruction count and opcode
    counts, largest first. With ``out``, the SASS is written there too."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", cubin], check=True, capture_output=True,
                          text=True).stdout
    if out is not None:
        out.write_text(text)
    result = {}
    for part in text.split("Function : ")[1:]:
        name = cs.kernel_label(part.split(None, 1)[0])
        ins = [(int(m[1], 16), m[3], m[4]) for m in _SASS_LINE.finditer(part)]
        back = []
        for addr, op, rest in ins:
            t = _BRA_TARGET.search(rest)
            if op.startswith("BRA") and t and int(t[1], 16) < addr:
                back.append((int(t[1], 16), addr))
        loops = []
        for lo, hi in back:
            if any(lo <= a < b <= hi and (a, b) != (lo, hi) for a, b in back):
                continue
            ops = {}
            for addr, op, _ in ins:
                if lo <= addr <= hi:
                    ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
            loops.append(dict(start=hex(lo), end=hex(hi), instructions=sum(ops.values()),
                              opcodes=dict(sorted(ops.items(), key=lambda kv: -kv[1]))))
        result[name] = sorted(loops, key=lambda x: -x["instructions"])
    return result


def flat_times() -> dict:
    """Per workload of ``chip_smoke.flat_diagnosis``, fold_flat's ms per
    launch and whether every launch equals the plain version."""
    diag = cs.flat_diagnosis("cuda", reach=False)
    return {name: {"ms": sc["ms"], "same": all(r["same"] for r in sc["rows"])}
            for name, sc in diag["scenes"].items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("flat_variants: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = cs.card_line()
    print(f"{smi} (package at {_build.CSRC.parents[1]})", flush=True)
    names = list(dict.fromkeys(n for n in (*VARIANTS, *PY_VARIANTS) if not n.endswith("_parent")))
    if "--variants" in sys.argv:
        names = sys.argv[sys.argv.index("--variants") + 1].split(",")
    package_csrc = _build.CSRC
    scratch = Path(tempfile.mkdtemp(prefix="flat_variants_"))
    dirs = {name: lv.variant_csrc(VARIANTS.get(name, {}), scratch) for name in names}
    builds, reports = [], {}
    for name, csrc in dirs.items():
        if name != next(n for n, c in dirs.items() if c == csrc):
            reports[name] = None  # a variant of cuda_hit.py on an earlier variant's csrc/
            continue
        builds += sv.start_builds(csrc, SOURCES)
        reports[name] = cs.ptxas_start(SOURCES)  # reads _build.CSRC, set by start_builds
    sv.finish_builds(builds)
    runs, ok = [], True
    order = names + ["package"] if "package" in names else names
    for name in order:
        sv.use(dirs[name])
        py = PY_VARIANTS.get(name, {})
        saved = {k: getattr(cuda_hit, k) for k in py}
        for k, v in py.items():
            setattr(cuda_hit, k, v)
        row = {"variant": name, "times": flat_times()}
        for k, v in saved.items():
            setattr(cuda_hit, k, v)
        if reports[name] is not None and name not in {r["variant"] for r in runs}:
            rows = cs.ptxas_finish(reports[name])
            sass = Path(sys.argv[sys.argv.index("--sass") + 1]) if "--sass" in sys.argv else None
            if sass is not None and rows:
                sass.mkdir(parents=True, exist_ok=True)
                loops = sass_loops(rows[0]["cubin"], sass / f"fold_flat_{name}.sass")
                for x in rows:
                    x["loops"] = loops.get(x["kernel"], [])[:4]
            row["ptxas"] = [{k: v for k, v in x.items() if k not in ("cubin", "mangled")}
                            for x in rows]
            for x in row["ptxas"]:
                print(f"variant {name} ptxas {x['kernel']}: registers={x.get('registers')} "
                      f"spill_stores={x.get('spill_stores')} spill_loads={x.get('spill_loads')}"
                      + (f" innermost loops {x['loops']}" if "loops" in x else ""), flush=True)
        for scene, t in row["times"].items():
            ok &= t["same"]
            print(f"variant {name} {scene}: fold_flat_ms={[round(v, 4) for v in t['ms']]} "
                  f"(sum {sum(t['ms']):.4f}) bit_for_bit={t['same']}", flush=True)
        runs.append(row)
    sv.use(package_csrc)
    shutil.rmtree(scratch, ignore_errors=True)
    line = json.dumps({"card": smi, "variants": runs})
    if "--out" in sys.argv:
        Path(sys.argv[sys.argv.index("--out") + 1]).write_text(line)
    print(line, flush=True)
    if not ok:
        print("flat_variants: a variant differs from the plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
