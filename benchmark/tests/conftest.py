"""The benchmark's own tests: ``python -m pytest benchmark/tests``.

Tests that need a CUDA card carry the ``chip`` marker and skip, with a
reason, where there is none; each decides inside the test.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")
