"""The plain mirrors of the per-level kernels' warp-level design against the
port's plain versions, which tests/test_torch_levels*.py hold against the
JAX package.

``warp_cull_reference`` is ``ray_stats`` with each warp's chunk cull (the
warps of 32 lanes in the kernel's lane order): its stats must equal
``ray_stats_reference``'s bit for bit, so the cull's margin never drops a
chunk some lane's gate reaches; on camera and bounce rays of grid-130 at
333x111 (ragged tiles), on grid-1024's bounce rays at 96x64, and on rays
with zero, tiny and non-finite direction components (which turn the cull
off for their warp). ``pair_fold_reference`` is ``trace_level`` with its
warp-cooperative fold of sparse chunks: every output must equal
``trace_level_reference``'s bit for bit at every threshold K (1: never
cooperative, 33: always), with the tiles' shortlists shuffled, and on a
scene with coincident spheres, where the lower index wins. Inputs and
shuffles come from numpy seeds.
"""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.models import scenes
from raytracer_tpu_torch.ops import cuda_fold, cuda_level
from raytracer_tpu_torch.ops.trace import raygen_tile

torch.set_num_threads(1)


def _rays(w, h):
    o, d = raygen_tile(scenes.reference_demo_camera(device="cpu"), w, h)
    return o.broadcast_to(d.x.shape), d.broadcast_to(d.x.shape), torch.ones(d.x.shape)


def _levels(tables, w, h, depth):
    """Each level's input rays and shortlist through the plain chain:
    ``[(o, d, w, shortlist, is_last)]``."""
    o, d, wt = _rays(w, h)
    acc = V3(*(torch.zeros_like(wt) for _ in range(3)))
    stats = cuda_level.ray_stats_reference(tables, o, d, wt)
    out = []
    for k in range(depth + 1):
        sl = cuda_level.phase_a(stats, tables)
        out.append((o, d, wt, sl, k == depth))
        _, _, acc, wt, o, d, stats = cuda_level.trace_level_reference(
            tables, sl, o, d, wt, acc, k == depth, None, k < depth)
    return out


def _same(a, b) -> bool:
    """Equal bit for bit, NaN where the other is NaN."""
    if a.dtype.is_floating_point:
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def _outputs(r):
    t, i, acc, w, o, d, stats = r
    return [t, i, *acc, w, *o, *d] + ([stats] if stats is not None else [])


@pytest.fixture(scope="module")
def grid130():
    tables = cuda_fold.fused_tables(scenes.grid_sphere_scene(130, device="cpu"))
    return tables, _levels(tables, 333, 111, 2)


@pytest.fixture(scope="module")
def grid1024_bounce():
    tables = cuda_fold.fused_tables(scenes.grid_sphere_scene(1024, device="cpu"))
    return tables, _levels(tables, 96, 64, 2)


def test_lane_slots_are_the_kernels_warps():
    """A 16x16 tile is one block; its warps are two rows of 16 pixels."""
    tid, thread, warp = cuda_level.lane_slots((40, 50))
    assert tid[17, 33].item() == 1 * 4 + 2 and thread[17, 33].item() == 1 * 16 + 1
    assert warp[17, 33].item() == tid[17, 33].item() * 8 + 0
    assert warp[0, 0].item() == warp[1, 15].item() != warp[2, 0].item()
    counts = torch.bincount(warp[:32, :48].reshape(-1))
    assert (counts[counts > 0] == 32).all()


def test_warp_cull_stats_equal_plain_grid130(grid130):
    """Camera rays and the bounce rays of levels 1-2, ragged tiles."""
    tables, levels = grid130
    for o, d, w, _, _ in levels:
        stats, cull = cuda_level.warp_cull_reference(tables, o, d, w)
        assert torch.equal(stats, cuda_level.ray_stats_reference(tables, o, d, w))
        assert cull.shape[1] == tables.counts["n_c"] == 9


def test_warp_cull_stats_equal_plain_grid1024_bounce(grid1024_bounce):
    tables, levels = grid1024_bounce
    culled = []
    for o, d, w, _, _ in levels[1:]:
        stats, cull = cuda_level.warp_cull_reference(tables, o, d, w)
        assert torch.equal(stats, cuda_level.ray_stats_reference(tables, o, d, w))
        culled.append(float(cull[cull.any(dim=1)].sum(dim=1).float().mean()))
    assert all(0 < c < tables.counts["n_c"] for c in culled), culled  # it does cull


def test_warp_cull_edge_directions(grid1024_bounce):
    """Zero, tiny (1e-13) and non-finite direction components, and origins
    set to inf, scattered over grid-1024's camera rays: the warps holding
    them are not culled, the others are, and the stats are the plain ones."""
    tables, levels = grid1024_bounce
    o, d, w, _, _ = levels[0]
    rng = np.random.default_rng(7)
    comps = [c.clone() for c in (*o, *d)]
    n = w.numel()
    for value, planes in ((0.0, (3, 4, 5)), (0.0, (3,)), (0.0, (4, 5)), (1e-13, (3, 4, 5)),
                          (-1e-13, (5,)), (float("nan"), (3,)), (float("inf"), (4,)),
                          (float("-inf"), (5,)), (float("inf"), (0,)), (-0.0, (3, 4))):
        lanes = torch.from_numpy(rng.choice(n, size=n // 64, replace=False))
        for j in planes:
            comps[j].view(-1)[lanes] = value
    eo, ed = V3(*comps[:3]), V3(*comps[3:])
    stats, cull = cuda_level.warp_cull_reference(tables, eo, ed, w)
    assert _same(stats, cuda_level.ray_stats_reference(tables, eo, ed, w))
    full = cull.all(dim=1).sum().item()
    assert 0 < full < cull.shape[0]


@pytest.mark.parametrize("k_min", [1, 4, 12, 33])
def test_pair_fold_equals_plain_grid130(grid130, k_min):
    tables, levels = grid130
    pairs = 0
    for o, d, w, sl, last in levels:
        acc = V3(*(torch.full_like(w, 0.25) for _ in range(3)))
        want = cuda_level.trace_level_reference(tables, sl, o, d, w, acc, last, None, not last)
        got, work = cuda_level.pair_fold_reference(tables, sl, o, d, w, acc, last, k_min,
                                                   None, not last)
        assert all(_same(a, b) for a, b in zip(_outputs(got), _outputs(want)))
        assert work["per_lane"] + work["pair"] == work["warp_chunks"]
        pairs += work["pair"]
    assert (pairs == 0) == (k_min == 1)


def test_pair_fold_shuffled_shortlists(grid130):
    """Each tile's accepted chunks in a random order (numpy seed): the fold,
    cooperative or not, gives the same result."""
    tables, levels = grid130
    rng = np.random.default_rng(3)
    for o, d, w, (chunk_list, counts), last in levels:
        shuffled = chunk_list.clone()
        for tile in range(chunk_list.shape[0]):
            m = int(counts[tile].clamp_min(0))
            shuffled[tile, :m] = chunk_list[tile, torch.from_numpy(rng.permutation(m))]
        acc = V3(*(torch.zeros_like(w) for _ in range(3)))
        want = cuda_level.trace_level_reference(tables, (chunk_list, counts), o, d, w, acc, last)
        for k_min in (1, 12, 33):
            got, _ = cuda_level.pair_fold_reference(tables, (shuffled, counts), o, d, w, acc,
                                                    last, k_min)
            assert all(_same(a, b) for a, b in zip(_outputs(got), _outputs(want)))


def test_pair_fold_coincident_spheres_lower_index_wins():
    """grid-130 with the sphere most camera rays hit copied onto a sphere of
    a later chunk and onto its neighbour in its own chunk: every lane that
    hits the copies keeps the lowest index, cooperatively or not."""
    base = scenes.grid_sphere_scene(130, device="cpu")
    tables = cuda_fold.fused_tables(base)
    o, d, w = _rays(160, 96)
    acc = V3(*(torch.zeros_like(w) for _ in range(3)))
    sl = cuda_level.phase_a(cuda_level.ray_stats_reference(tables, o, d, w), tables)
    i0 = cuda_level.trace_level_reference(tables, sl, o, d, w, acc, True)[1]
    hits = torch.bincount(i0[(i0 >= 0) & (i0 < 130)].reshape(-1).long(), minlength=130)
    j1 = int(hits[:96].argmax())
    copies = (j1 + 1, 16 * ((j1 // 16) + 2) + 3)
    sp = base.spheres
    center = sp.center.clone()
    for j in copies:
        center[j] = center[j1]
    scene = base.replace(spheres=sp.replace(center=center))
    tables = cuda_fold.fused_tables(scene)
    sl = cuda_level.phase_a(cuda_level.ray_stats_reference(tables, o, d, w), tables)
    want = cuda_level.trace_level_reference(tables, sl, o, d, w, acc, True)
    assert (want[1] == j1).sum() > 20
    assert not any(bool((want[1] == j).any()) for j in copies)
    for k_min in (1, 33):
        got, work = cuda_level.pair_fold_reference(tables, sl, o, d, w, acc, True, k_min)
        assert all(_same(a, b) for a, b in zip(_outputs(got), _outputs(want)))
