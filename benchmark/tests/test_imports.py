"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: checked in a fresh interpreter, by
each loaded module's top-level name (the part before the first dot)."""

import json
import subprocess
import sys

from benchmark import harness

_PROBE = r"""
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(imports: str) -> set:
    code = _PROBE.format(root=str(harness.ROOT), imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    top = _loaded(
        "from benchmark import harness, control, compare, devtrace, inputs, work\n"
        "import torch\n"
        "harness.Program(torch.device('cpu'))\n"
        "import importlib.util as u\n"
        "for p in sorted((harness.BENCH_DIR / 'metrics').glob('*.py')):\n"
        "    s = u.spec_from_file_location('m_' + p.stem.replace('.', '_'), p)\n"
        "    s.loader.exec_module(u.module_from_spec(s))\n")
    assert "raytracer_tpu_torch" in top  # the program is loaded
    assert not top & {"jax", "jaxlib", "flax", "raytracer_tpu"}


def test_reference_loads_nothing_of_the_program():
    top = _loaded("from benchmark.reference import common, hard, soft\n"
                  "from benchmark import inputs, compare, work\n")
    assert not top & {"jax", "jaxlib", "flax", "raytracer_tpu", "raytracer_tpu_torch"}


def test_forbidden_names_are_whole_top_level_names():
    assert "raytracer_tpu" in harness.FORBIDDEN
    assert "raytracer_tpu_torch" not in harness.forbidden_modules()
