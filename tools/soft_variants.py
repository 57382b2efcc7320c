"""Design variants of the soft kernels, timed on one CUDA card.

    python3 tools/soft_variants.py [--out FILE]

Each variant is a copy of raytracer_tpu_torch/csrc/ with one line
changed: the tile of the sphere ring (``TILE_C`` of soft_level.cu and
soft_level_bwd.cu), the blocks an SM that ptxas fits the registers to
(``MIN_BLOCKS``), the forward's lane masks kept for its second pass
(``MASK_WORDS`` of soft_common.cuh; 0 recomputes every mask), or a
``#pragma unroll 1`` on the loop over a tile's 32-chunk words. All
variants are built at once (one nvcc per source, with the package's flags
and a ``ptxas -v`` report), then run in turns, the package's own kernels
first and last: both kernels' per-level times at 1920x1080, depth 1, on
c4, grid-1024 and grid-2048 (``chip_smoke.soft_level_diagnosis``).

Then, on the package's own kernels, the lane order of the bounce level:
grid-n at 1920x1080 for n from 64 to 2048, its last level's forward and
backward timed with the lanes in the natural order and in
``cuda_soft.soft_lane_order`` (the sort timed too), beside each order's
warp union over lane reach (``chip_smoke.reach_stats``).

Prints the card's name and power limit, a line per measurement, and one
JSON line of them all (also written to FILE with ``--out``).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from raytracer_tpu_torch.core.v3 import V3  # noqa: E402
from raytracer_tpu_torch.ops import _build, cuda_soft  # noqa: E402

SOURCES = ("soft_level", "soft_level_bwd")
FWD_TILE = "constexpr int TILE_C = 32;"
BWD_TILE = "constexpr int TILE_C = 32;"
MASKS = "constexpr int MASK_WORDS = 8;"
WORDS = "      for (int wd = 0; wd < words; ++wd) {"
FWD_MIN = "constexpr int MIN_BLOCKS = 4;"
BWD_MIN = "constexpr int MIN_BLOCKS = 2;"
# name: {csrc file: (line in the package's source, its replacement)}
VARIANTS = {
    "package": {},
    "fwd_tile64": {"soft_level.cu": (FWD_TILE, FWD_TILE.replace("32", "64"))},
    "fwd_tile128": {"soft_level.cu": (FWD_TILE, FWD_TILE.replace("32", "128"))},
    "bwd_tile64": {"soft_level_bwd.cu": (BWD_TILE, BWD_TILE.replace("32", "64"))},
    "fwd_min_blocks3": {"soft_level.cu": (FWD_MIN, FWD_MIN.replace("4", "3"))},
    "bwd_min_blocks3": {"soft_level_bwd.cu": (BWD_MIN, BWD_MIN.replace("2", "3"))},
    "no_mask_reuse": {"soft_common.cuh": (MASKS, MASKS.replace("8", "0"))},
    "fwd_words_rolled": {"soft_level.cu": (WORDS, "#pragma unroll 1\n" + WORDS)},
    "bwd_words_rolled": {"soft_level_bwd.cu": (WORDS, "#pragma unroll 1\n" + WORDS)},
}
ORDER_SIZES = (64, 128, 256, 512, 1024, 2048)


def variant_csrc(edits: dict, root: Path) -> Path:
    """A copy of csrc/ under ``root`` with ``edits`` applied, each line
    replaced wherever it stands (the package's own csrc/ when there are
    none)."""
    if not edits:
        return _build.CSRC
    out = Path(tempfile.mkdtemp(prefix="csrc_", dir=root))
    for f in _build.CSRC.iterdir():
        shutil.copy(f, out / f.name)
    for name, (old, new) in edits.items():
        text = (out / name).read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} is not in the source")
        (out / name).write_text(text.replace(old, new))
    return out


def start_builds(csrc: Path, sources=SOURCES) -> list:
    """Starts nvcc for each of ``sources`` in ``csrc`` not built yet, into
    the path ``_build.load`` looks for: ``[(tmp, final path, process)]``."""
    _build.CSRC = csrc
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in sources:
        out = _build._library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_build.BUILD_DIR)
        os.close(fd)
        cmd = _build.build_command(csrc / f"{name}.cu", Path(tmp), _build._nvcc())
        procs.append((tmp, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    return procs


def finish_builds(procs: list):
    for tmp, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
        os.replace(tmp, out)


def use(csrc: Path):
    """Makes the wrappers load the kernels built from ``csrc``."""
    _build.CSRC = csrc
    _build._loaded.clear()


def level_times() -> dict:
    """Per scene of chip_smoke.SOFT_LEVEL_SCENES, both kernels' ms per
    level at 1920x1080, depth 1."""
    out = {}
    for name, n in cs.SOFT_LEVEL_SCENES:
        r = cs.soft_level_diagnosis(n, "cuda", reach=False)
        out[name] = {"fwd_ms": r["fwd_ms"], "bwd_ms": r["bwd_ms"]}
    return out


def order_sweep(n_spheres: int, width: int = 1920, height: int = 1080) -> dict:
    """The last level of grid-``n_spheres`` (depth 1) timed forward (with
    its residuals) and backward in the natural lane order and in
    ``soft_lane_order``, the sort on its own, and each order's reach."""
    scene = cs.make_scene(("grid_sphere_scene", (n_spheres,)), "cuda")
    o, d, w = cs.frame_rays(width, height, "cuda")
    with torch.no_grad():
        tables = cuda_soft.soft_tables(scene, cs.SOFT_TAU, cs.SOFT_TAU_Z)
    gates = cuda_soft.soft_gate_tables(scene, cs.SOFT_TAU)
    acc = V3(*(torch.zeros_like(w) for _ in range(3)))
    with torch.no_grad():
        acc, w, o, d, _ = cuda_soft.soft_level(tables, gates, o, d, w, acc, False, False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ct = V3(*(torch.randn(w.shape, generator=gen, device="cuda") for _ in range(3)))
    sums = torch.zeros(tables.packed.shape, dtype=torch.float64, device="cuda")
    order = cuda_soft.soft_lane_order(o, d)
    r = {"n_s": n_spheres,
         "sort_ms": cs.event_ms(lambda: cuda_soft.soft_lane_order(o, d), iters=5, warmup=1)}
    with torch.no_grad():
        for key, idx in (("natural", None), ("sorted", order)):
            res = cuda_soft.soft_level(tables, gates, o, d, w, acc, True, True, order=idx)[4]
            r[key] = {
                "fwd_ms": cs.event_ms(lambda: cuda_soft.soft_level(
                    tables, gates, o, d, w, acc, True, True, order=idx), iters=5, warmup=1),
                "bwd_ms": cs.event_ms(lambda: cuda_soft.soft_level_bwd(
                    tables, gates, o, d, w, res, ct, None, True, sums, order=idx),
                    iters=5, warmup=1),
                "warp_ratio": cs.reach_stats(tables, gates, o, d, idx)["warp_ratio"],
            }
    r["natural"]["total_ms"] = r["natural"]["fwd_ms"] + r["natural"]["bwd_ms"]
    r["sorted"]["total_ms"] = r["sort_ms"] + r["sorted"]["fwd_ms"] + r["sorted"]["bwd_ms"]
    return r


def main() -> int:
    if not torch.cuda.is_available():
        print("soft_variants: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = cs.card_line()
    print(smi, flush=True)
    package_csrc = _build.CSRC
    scratch = Path(tempfile.mkdtemp(prefix="soft_variants_"))
    dirs = {name: variant_csrc(edits, scratch) for name, edits in VARIANTS.items()}
    builds, reports = [], {}
    for name, csrc in dirs.items():
        builds += start_builds(csrc)
        reports[name] = cs.ptxas_start(SOURCES)  # reads _build.CSRC, set by start_builds
    finish_builds(builds)
    runs = []
    for name in [*dirs, "package"]:
        use(dirs[name])
        row = {"variant": name, "times": level_times()}
        if name not in {r["variant"] for r in runs}:
            row["ptxas"] = [{k: v for k, v in x.items() if k not in ("cubin", "mangled")}
                            for x in cs.ptxas_finish(reports[name])]
            for x in row["ptxas"]:
                print(f"variant {name} ptxas {x['kernel']}: registers={x['registers']} "
                      f"spill_stores={x['spill_stores']} spill_loads={x['spill_loads']}",
                      flush=True)
        for scene, t in row["times"].items():
            print(f"variant {name} {scene} 1920x1080: "
                  f"soft_level_ms={[round(v, 4) for v in t['fwd_ms']]} "
                  f"soft_level_bwd_ms={[round(v, 4) for v in t['bwd_ms']]}", flush=True)
        runs.append(row)
    use(package_csrc)
    orders = []
    for n in ORDER_SIZES:
        r = order_sweep(n)
        orders.append(r)
        print(f"lane order grid{n} 1920x1080 last level: sort_ms={r['sort_ms']:.4f} "
              + " ".join(f"{key}: soft_level_ms={r[key]['fwd_ms']:.4f} "
                         f"soft_level_bwd_ms={r[key]['bwd_ms']:.4f} "
                         f"total_ms={r[key]['total_ms']:.4f} "
                         f"warp_ratio={r[key]['warp_ratio']:.3f}"
                         for key in ("natural", "sorted")), flush=True)
    shutil.rmtree(scratch, ignore_errors=True)
    line = json.dumps({"card": smi, "variants": runs, "lane_order": orders})
    if "--out" in sys.argv:
        Path(sys.argv[sys.argv.index("--out") + 1]).write_text(line)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
