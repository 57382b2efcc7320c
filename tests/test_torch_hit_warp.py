"""The plain mirrors of the closest-hit kernels' warp-level design against
the port's plain versions, which tests/test_torch_hit*.py hold against the
JAX package.

``fold_shortlist_pair_reference`` and ``fold_shortlist_hit_pair_reference``
are ``fold_shortlist`` and ``fold_shortlist_hit`` with the warp-cooperative
fold of sparse chunks (``cuda_level.pair_fold``, the fold that trace_level
runs too): every plane must equal ``fold_shortlist_reference``'s and
``fold_shortlist_hit_reference``'s bit for bit (NaN where the other is NaN)
at every threshold K (1: never cooperative, 33: always, 8: the kernels').
The cases: camera and level-1 bounce rays of grid-130 at 333x111 (ragged
tiles), the tiles' shortlists shuffled, half the lanes dead and all of
them, identity lists (a scene of fewer than ``_PER_TILE_MIN_CHUNKS``
chunks, with boxes; the demo scene's one-sphere chunk, folded lane by
lane), and coincident spheres, where the lower index wins. ``hit_smem_bytes`` must
match the shared layout the kernel copies. Inputs, masks and shuffles come
from numpy seeds.
"""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.models import scenes
from raytracer_tpu_torch.ops import cuda_fold, cuda_hit, cuda_level
from raytracer_tpu_torch.ops.trace import raygen_tile

torch.set_num_threads(1)


def _rays(w, h):
    o, d = raygen_tile(scenes.reference_demo_camera(device="cpu"), w, h)
    return o.broadcast_to(d.x.shape), d.broadcast_to(d.x.shape), torch.ones(d.x.shape)


def _ray_sets(tables, w, h):
    """``[(name, o, d, w, shortlist)]``: the camera rays and the level-1
    bounce rays of the plain chain, each with its shortlists as
    ``cuda_hit.shortlists`` builds them."""
    o, d, wt = _rays(w, h)
    acc = V3(*(torch.zeros_like(wt) for _ in range(3)))
    sl = cuda_hit.shortlists(tables, o, d, wt)
    _, _, _, w1, o1, d1, _ = cuda_level.trace_level_reference(tables, sl, o, d, wt, acc, False)
    return [("camera", o, d, wt, sl),
            ("bounce", o1, d1, w1, cuda_hit.shortlists(tables, o1, d1, w1))]


def _same(a, b) -> bool:
    """Equal bit for bit, NaN where the other is NaN."""
    if a.dtype.is_floating_point:
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def _check(tables, sl, o, d, w, k_min) -> dict:
    """Both mirrors against both plain versions on one ray set; the fold's
    work dict."""
    (t, i), work = cuda_hit.fold_shortlist_pair_reference(tables, sl, o, d, w, k_min)
    want = cuda_hit.fold_shortlist_reference(tables, sl, o, d, w)
    assert _same(t, want[0]) and _same(i, want[1])
    rec, work_rec = cuda_hit.fold_shortlist_hit_pair_reference(tables, sl, o, d, w, k_min)
    want_rec = cuda_hit.fold_shortlist_hit_reference(tables, sl, o, d, w)
    assert len(rec) == len(want_rec) == cuda_hit.N_RECORD
    assert all(_same(a, b) for a, b in zip(rec, want_rec))
    assert work_rec == work
    assert work["per_lane"] + work["pair"] == work["warp_chunks"]
    return work


@pytest.fixture(scope="module")
def grid130():
    tables = cuda_fold.fused_tables(scenes.grid_sphere_scene(130, device="cpu"))
    return tables, _ray_sets(tables, 333, 111)


@pytest.mark.parametrize("k_min", [1, 8, 12, 33])
def test_pair_fold_equals_plain_grid130(grid130, k_min):
    """Camera and level-1 bounce rays, ragged tiles (333x111); 8 is the
    kernels' own threshold (``cuda_level.PAIR_MIN_LANES``)."""
    tables, sets = grid130
    pairs = 0
    for name, o, d, w, sl in sets:
        assert sl is not None, name
        work = _check(tables, sl, o, d, w, k_min)
        assert work["used"] > 0, name
        pairs += work["pair"]
    assert (pairs == 0) == (k_min == 1)


def test_pair_fold_shuffled_shortlists(grid130):
    """Each tile's accepted chunks in a random order (numpy seed): the fold,
    cooperative or not, gives the plain version's result on the lists in
    phase A's order."""
    tables, sets = grid130
    rng = np.random.default_rng(11)
    for _, o, d, w, (chunk_list, counts) in sets:
        shuffled = chunk_list.clone()
        for tile in range(chunk_list.shape[0]):
            m = int(counts[tile].clamp_min(0))
            shuffled[tile, :m] = chunk_list[tile, torch.from_numpy(rng.permutation(m))]
        want = cuda_hit.fold_shortlist_hit_reference(tables, (chunk_list, counts), o, d, w)
        for k_min in (1, 12, 33):
            got, _ = cuda_hit.fold_shortlist_hit_pair_reference(tables, (shuffled, counts),
                                                                o, d, w, k_min)
            assert all(_same(a, b) for a, b in zip(got, want))


def test_pair_fold_dead_lanes(grid130):
    """Half the camera lanes dead (a numpy mask), then all of them: dead
    lanes get the miss record and leave the warps' passing counts."""
    tables, sets = grid130
    _, o, d, w, _ = sets[0]
    rng = np.random.default_rng(5)
    half = torch.from_numpy((rng.random(tuple(w.shape)) < 0.5).astype(np.float32))
    sl = cuda_hit.shortlists(tables, o, d, half)
    full = _check(tables, sets[0][4], o, d, w, 12)
    work = _check(tables, sl, o, d, half, 12)
    assert 0 < work["used"] < full["used"]
    assert work["pair"] > full["pair"]  # half-empty warps fold more chunks together
    dead = torch.zeros_like(w)
    for k_min in (1, 33):
        work = _check(tables, cuda_hit.shortlists(tables, o, d, dead), o, d, dead, k_min)
        assert work["used"] == work["lane_chunks"] == 0
    (t, i), _ = cuda_hit.fold_shortlist_pair_reference(tables, None, o, d, dead)
    assert bool((i == -1).all()) and bool((t == cuda_hit.MISS_T).all())


def test_pair_fold_identity_lists():
    """The mixed scene (spheres, walls and boxes; fewer chunks than
    ``_PER_TILE_MIN_CHUNKS``) walks every chunk in index order; so does the
    demo scene, whose one chunk holds one sphere (fewer than
    ``PAIR_MIN_UNROLL``), and there every lane folds alone at any K."""
    tables = cuda_fold.fused_tables(scenes.mixed_primitive_scene(device="cpu"))
    assert not cuda_level.uses_shortlists(tables) and tables.counts["n_b"] > 0
    for name, o, d, w, sl in _ray_sets(tables, 160, 96):
        assert sl is None, name
        for k_min in (1, 33):
            _check(tables, None, o, d, w, k_min)
    demo = cuda_fold.fused_tables(scenes.reference_demo_scene(device="cpu"))
    assert demo.counts["unroll"] < cuda_level.PAIR_MIN_UNROLL
    for name, o, d, w, sl in _ray_sets(demo, 160, 96):
        assert sl is None, name
        work = _check(demo, None, o, d, w, 33)
        assert work["lane_chunks"] > 0 and work["pair"] == 0, name


def test_pair_fold_coincident_spheres_lower_index_wins():
    """grid-130 with the sphere most camera rays hit copied onto its
    neighbour in its own chunk and onto a sphere of a later chunk: every
    lane that hits the copies keeps the lowest index, cooperatively or
    not."""
    base = scenes.grid_sphere_scene(130, device="cpu")
    o, d, w = _rays(160, 96)
    tables = cuda_fold.fused_tables(base)
    i0 = cuda_hit.fold_shortlist_reference(tables, cuda_hit.shortlists(tables, o, d, w),
                                           o, d, w)[1]
    hits = torch.bincount(i0[(i0 >= 0) & (i0 < 130)].reshape(-1).long(), minlength=130)
    j1 = int(hits[:96].argmax())
    copies = (j1 + 1, 16 * ((j1 // 16) + 2) + 3)
    center = base.spheres.center.clone()
    for j in copies:
        center[j] = center[j1]
    tables = cuda_fold.fused_tables(base.replace(spheres=base.spheres.replace(center=center)))
    sl = cuda_hit.shortlists(tables, o, d, w)
    want = cuda_hit.fold_shortlist_reference(tables, sl, o, d, w)[1]
    assert (want == j1).sum() > 20
    assert not any(bool((want == j).any()) for j in copies)
    for k_min in (1, 33):
        _check(tables, sl, o, d, w, k_min)


@pytest.mark.parametrize("n", [0, 130, 2048])
def test_hit_smem_bytes_matches_kernel_layout(n):
    """The kernel's shared memory (csrc/fold_shortlist.cu with
    trace_common.cuh's ``tab_level_shared``): 4 floats a sphere, the wall
    (15 floats), box (6), chunk (11), slab (6), light (6) and sky (10)
    groups of the packed table as they are, then ``n_c`` int32 of the tile's
    shortlist; the materials stay in device memory."""
    scene = (scenes.sprint3_scene(device="cpu") if n == 0
             else scenes.grid_sphere_scene(n, device="cpu"))
    tables = cuda_fold.fused_tables(scene)
    c = tables.counts
    n_s, n_w, n_b, n_c = c["n_s"], c["n_w"], c["n_b"], c["n_c"]
    n_tab = (5 * n_s + 15 * n_w + 6 * n_b + 8 * (n_s + n_w + n_b) + 11 * n_c + 6
             + 6 * c["n_pt"] + 6 * c["n_sun"] + 10)
    assert tables.packed.numel() == n_tab
    words = 4 * n_s + 15 * n_w + 6 * n_b + 11 * n_c + 6 + 6 * (c["n_pt"] + c["n_sun"]) + 10
    assert cuda_hit.hit_smem_bytes(tables) == 4 * (words + n_c)
    assert cuda_hit.hit_smem_bytes(tables) == cuda_level.level_smem_bytes(tables, False)
