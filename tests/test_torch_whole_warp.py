"""The plain mirror of the whole-trace kernel's warp-level design against
the port's plain version, which tests/test_torch_trace.py holds against the
JAX package.

``whole_pair_reference`` is ``trace_whole`` as csrc/trace_whole.cu runs it:
each level's fold walks every chunk with the warp-cooperative fold of
sparse chunks (``cuda_level.pair_fold``, the fold of trace_level and the
shortlist kernels) in the kernel's lane layout (``whole_grid``). Every
output (rgb, t, index and the ``emit_res`` planes) must equal
``trace_whole_reference``'s bit for bit at every threshold K (1: never
cooperative, 33: always, 8: the kernels'). The cases: grid-130 at 333x111
(ragged tiles of ``WHOLE_TILE``), the mixed scene (boxes), the demo scene
at depth 10 (its one chunk holds one sphere and is folded lane by lane), a
1-D plane (strips over the flat planes) and coincident spheres, where the
lower index wins. The lane layout must cover every pixel once, and the shared-memory
sizes must match the tables the kernels copy. Inputs come from the demo
camera and numpy seeds.
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


def _same(a, b) -> bool:
    """Equal bit for bit, NaN where the other is NaN."""
    if a.dtype.is_floating_point:
        return a.shape == b.shape and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def _check(tables, o, d, w, depth, k_min, want=None, tile=None) -> list:
    """The mirror against the plain version (with residuals); the fold's
    work per level."""
    got, works = cuda_fold.whole_pair_reference(tables, o, d, w, depth, emit_res=True,
                                                k_min=k_min, tile=tile)
    if want is None:
        want = cuda_fold.trace_whole_reference(tables, o, d, w, depth, emit_res=True)
    assert all(_same(a, b) for a, b in zip(got[0], want[0]))
    assert all(_same(a, b) for a, b in zip(got[1:], want[1:]))
    for work in works:
        assert work["per_lane"] + work["pair"] == work["warp_chunks"]
    return works


@pytest.fixture(scope="module")
def grid130():
    tables = cuda_fold.fused_tables(scenes.grid_sphere_scene(130, device="cpu"))
    o, d, w = _rays(333, 111)
    want = cuda_fold.trace_whole_reference(tables, o, d, w, 3, emit_res=True)
    return tables, (o, d, w), want


@pytest.mark.parametrize("k_min", [1, 8, 33])
def test_whole_mirror_equals_plain_grid130(grid130, k_min):
    """Camera rays and three bounce levels of grid-130 at 333x111, in ragged
    tiles of ``WHOLE_TILE`` (the kernel's tiles on a frame whose edges they
    overhang); 8 is the kernels' threshold (``cuda_level.PAIR_MIN_LANES``)."""
    tables, (o, d, w), want = grid130
    works = _check(tables, o, d, w, 3, k_min, want, tile=cuda_fold.WHOLE_TILE)
    assert all(work["used"] > 0 for work in works)
    pairs = sum(work["pair"] for work in works)
    assert (pairs == 0) == (k_min == 1)
    if k_min == 33:
        assert all(work["per_lane"] == 0 for work in works)


def test_whole_mirror_boxes_and_dead_lanes():
    """The mixed scene (spheres, walls and boxes) at 256x128 d2, with half
    the camera lanes dead (a numpy mask): dead lanes take (MISS_T, -1) and
    leave the warps' passing counts."""
    tables = cuda_fold.fused_tables(scenes.mixed_primitive_scene(device="cpu"))
    assert tables.counts["n_b"] > 0
    o, d, w = _rays(256, 128)
    full = _check(tables, o, d, w, 2, 8)
    rng = np.random.default_rng(3)
    half = torch.from_numpy((rng.random(tuple(w.shape)) < 0.5).astype(np.float32))
    works = _check(tables, o, d, half, 2, 8)
    assert 0 < works[0]["used"] < full[0]["used"]
    assert works[0]["pair"] > full[0]["pair"]
    _, t, i = cuda_fold.whole_pair_reference(tables, o, d, half, 2)[0]
    assert bool((i[0][half == 0] == -1).all()) and bool((t[0][half == 0] == 1e30).all())


def test_whole_mirror_one_sphere_chunk_depth10():
    """The demo scene at depth 10: its one chunk holds one sphere (fewer
    than ``PAIR_MIN_UNROLL``), so every lane folds it alone at any K, in
    strips over the flat planes, as in tiles."""
    tables = cuda_fold.fused_tables(scenes.reference_demo_scene(device="cpu"))
    assert tables.counts["unroll"] < cuda_level.PAIR_MIN_UNROLL
    o, d, w = _rays(64, 48)
    assert cuda_fold.whole_grid(w.shape, tables=tables) == ((1, 3072), (1, 256))
    _check(tables, o, d, w, 10, 8, tile=(16, 16))
    works = _check(tables, o, d, w, 10, 33)
    assert sum(work["lane_chunks"] for work in works) > 0
    assert all(work["pair"] == 0 for work in works)


def test_whole_mirror_flat_planes():
    """A 1-D plane (the camera rays flattened, and a one-row frame) runs in
    strips of 256 over the flat planes, with a ragged end; tiles forced on
    a narrow frame give the same outputs."""
    tables = cuda_fold.fused_tables(scenes.grid_sphere_scene(64, device="cpu"))
    o, d, w = _rays(61, 23)
    flat = lambda v: V3(*(c.reshape(-1).contiguous() for c in v))  # noqa: E731
    n = w.numel()
    assert n % 256 and cuda_fold.whole_grid((n,)) == ((1, n), (1, 256))
    assert cuda_fold.whole_grid((1, n)) == ((1, n), (1, 256))
    assert cuda_fold.whole_grid(w.shape) == ((1, n), (1, 256))  # 64x32 tiles idle > 1/16
    works = _check(tables, flat(o), flat(d), w.reshape(-1), 3, 8)
    assert works[0]["used"] > 0
    _check(tables, o, d, w, 3, 8, tile=(16, 16))


def test_whole_mirror_coincident_spheres_lower_index_wins():
    """grid-130 with the sphere most camera rays hit copied onto its
    neighbour in its own chunk and onto a sphere of a later chunk: every
    lane that hits the copies keeps the lowest index, cooperatively or
    not."""
    base = scenes.grid_sphere_scene(130, device="cpu")
    o, d, w = _rays(96, 64)
    tables = cuda_fold.fused_tables(base)
    i0 = cuda_fold.trace_whole_reference(tables, o, d, w, 0)[2][0]
    hits = torch.bincount(i0[(i0 >= 0) & (i0 < 130)].reshape(-1).long(), minlength=130)
    j1 = int(hits[:96].argmax())
    copies = (j1 + 1, 16 * ((j1 // 16) + 2) + 3)
    center = base.spheres.center.clone()
    for j in copies:
        center[j] = center[j1]
    tables = cuda_fold.fused_tables(base.replace(spheres=base.spheres.replace(center=center)))
    want = cuda_fold.trace_whole_reference(tables, o, d, w, 1, emit_res=True)
    assert (want[2][0] == j1).sum() > 20
    assert not any(bool((want[2] == j).any()) for j in copies)
    for k_min in (1, 33):
        _check(tables, o, d, w, 1, k_min, want)


def test_whole_lane_layout_covers_every_pixel_once():
    """The kernel's map from (block, thread) to a pixel of the [H, W] view
    (csrc/trace_whole.cu: block (bx, by) is the tile at column bx and row
    by, thread t at row t // tc and column t % tc of it, tc a power of two)
    hits every pixel of the planes once, for ragged, full-size, one-row,
    1-D and 3-D planes, and the lanes outside the frame are the tiles'
    ragged edges only."""
    for shape in ((111, 333), (1080, 1920), (1, 1000), (1000,), (4, 5, 70), (7,)):
        n = int(np.prod(shape))
        (h, wd), (tr, tc) = cuda_fold.whole_grid(shape)
        assert h * wd == n and tr * tc == 256 and tc & (tc - 1) == 0, shape
        tiles_w, tiles_h = -(-wd // tc), -(-h // tr)
        assert tiles_h <= 65535, shape
        by, bx = np.divmod(np.arange(tiles_w * tiles_h), tiles_w)
        thread = np.arange(256)[None, :]
        y = by[:, None] * tr + thread // tc
        x = bx[:, None] * tc + thread % tc
        valid = (y < h) & (x < wd)
        r = (y * wd + x)[valid]
        assert np.array_equal(np.sort(r), np.arange(n)), shape
        assert tiles_w * tiles_h * 256 - n <= max(n // 16, 255), shape
    assert cuda_fold.whole_grid((1080, 1920))[1] == cuda_fold.WHOLE_TILE
    assert cuda_fold.whole_grid((20, 1080, 1920)) == ((21600, 1920), cuda_fold.WHOLE_TILE)
    # Scenes of one-sphere chunks run in strips over the flat planes.
    sprint3 = cuda_fold.fused_tables(scenes.sprint3_scene(device="cpu"))
    assert sprint3.counts["unroll"] < cuda_level.PAIR_MIN_UNROLL
    assert cuda_fold.whole_grid((1080, 1920), tables=sprint3) == ((1, 2073600), (1, 256))
    grid64 = cuda_fold.fused_tables(scenes.grid_sphere_scene(64, device="cpu"))
    assert cuda_fold.whole_grid((1080, 1920), tables=grid64) == ((1080, 1920),
                                                                 cuda_fold.WHOLE_TILE)
    # Tiles that would idle more than 1/16 of the lanes give way to strips.
    assert cuda_fold.whole_grid((111, 333), tables=grid64) == ((1, 36963), (1, 256))


def test_whole_smem_bytes_match_kernel_layout():
    """The forward's shared memory (csrc/trace_whole.cu with
    trace_common.cuh's ``tab_level_shared``): 4 floats a sphere, then the
    wall (15 floats), box (6), chunk (11), slab (6), light (6) and sky (10)
    groups of the packed table; for scenes of one-sphere chunks (its lane
    route, sprint3) the packed table; the backward's (``tab_fold_shared``): the
    table without its materials, each lane's light and sky slots (one row
    past ``_LANE_LS_MAX``), and 14 floats of each hot attribute row (walls
    and boxes; spheres too up to ``_SHARED_SPHERES_MAX``)."""
    grid130 = scenes.grid_sphere_scene(130, device="cpu")
    for scene in (scenes.sprint3_scene(device="cpu"), scenes.grid_sphere_scene(64, device="cpu"),
                  scenes.grid_sphere_scene(768, device="cpu"), scenes.mixed_primitive_scene(device="cpu"),
                  grid130.replace(lights=grid130.lights.replace(
                      point_position=grid130.lights.point_position.repeat(4, 1),
                      point_color=grid130.lights.point_color.repeat(4, 1)))):
        tables = cuda_fold.fused_tables(scene)
        c = tables.counts
        n_s, n_w, n_b, n_c = c["n_s"], c["n_w"], c["n_b"], c["n_c"]
        n_prim, n_l = n_s + n_w + n_b, c["n_pt"] + c["n_sun"]
        rest = 15 * n_w + 6 * n_b + 11 * n_c + 6 + 6 * n_l + 10
        assert tables.packed.numel() == 5 * n_s + 8 * n_prim + rest
        if c["unroll"] < cuda_level.PAIR_MIN_UNROLL:  # the lane route: the packed table
            assert cuda_fold.whole_smem_bytes(tables) == 4 * tables.packed.numel()
        else:
            assert cuda_fold.whole_smem_bytes(tables) == 4 * (4 * n_s + rest)
            assert (cuda_fold.whole_smem_bytes(tables)
                    == cuda_level.level_smem_bytes(tables, False) - 4 * n_c)
        n_ls = 6 * n_l + 10
        ls = n_ls * 256 if n_ls <= 32 else n_ls
        rows = n_prim if n_s <= 16 else n_w + n_b
        assert cuda_fold.whole_bwd_smem_bytes(tables) == 4 * (5 * n_s + rest + ls + 14 * rows)
        assert max(cuda_fold.whole_smem_bytes(tables),
                   cuda_fold.whole_bwd_smem_bytes(tables)) <= cuda_fold._SMEM_MAX
