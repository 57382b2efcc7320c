"""``correct`` comes out false for the control and for each fault a cell
can have, and true for the sound program: whole runs of the harness at a
small size on the CPU, with the look for a card skipped and the timed path
broken underneath.

The control is the plain reference in bfloat16 put in the program's place.
The faults (``benchmark/control.py``): a frame or step that returns its
state unchanged; half of the frame left out (a frame's lower half black, a
fit's loss the mean over the top half of the rows); an answer altered where
it is made (the frame without its tone map, the colours' gradient dropped);
and a fit's centre gradient doubled, which Adam's first steps do not show.
The exchange between cards is no fault a one-card cell can have.
"""

import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark.control import FAULTS, ReferenceProgram
from benchmark.tests.tiny import CELLS, FITS, tiny_spec

pytest.importorskip("raytracer_tpu_torch")
SEED = 2**33 + 17


def _run(cell, program=None, seed=SEED):
    spec = tiny_spec(cell)
    return harness.run_cell(spec, seed, 0.25, False, "cpu", time.perf_counter(), program=program)


@pytest.mark.parametrize("cell", CELLS + FITS[-1:])
def test_sound_program_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS + FITS[-1:])
def test_control_is_not_correct(cell):
    out = _run(cell, ReferenceProgram(torch.device("cpu")))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS["render"]))
def test_render_faults_are_not_correct(fault):
    out = _run(CELLS[0], FAULTS["render"][fault](torch.device("cpu")))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", FITS)
@pytest.mark.parametrize("fault", sorted(FAULTS["fit"]))
def test_fit_faults_are_not_correct(cell, fault):
    out = _run(cell, FAULTS["fit"][fault](torch.device("cpu")))
    assert not out["correct"], out["checks"]


def test_run_refuses_without_a_card(tmp_path):
    """The command exits with 2 and prints no result where it finds fewer
    cards than the cell asks for (here: none is visible)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert out.returncode == 2 and out.stdout.strip() == ""


@pytest.mark.chip
def test_one_cell_on_the_card(tmp_path):
    """One short run of the render cell on a CUDA card: a correct result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload",
                          CELLS[0], "--seed", "11", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=1200, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"correct": true' in out.stdout.strip().splitlines()[-1]
