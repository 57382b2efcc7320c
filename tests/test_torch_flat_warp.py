"""The plain mirror of the brute-force closest-hit kernel against the port's
plain version, which tests/test_torch_hit.py holds against the JAX package.

``fold_flat_mirror`` is ``fold_flat`` as csrc/fold_flat.cu runs it: the
flat batch in groups of ``block`` threads of ``rays`` rays each, the
spheres in shared-memory tiles, the square root only where ``disc >= 0``
and ``b_half < 0``, the reciprocal directions only where the scene has
boxes. Its ``(t, index)`` must equal ``fold_flat_reference``'s bit for bit
(NaN where the other is NaN) on grid-130 (a ragged sphere tile) at several
rays a thread, a table past one tile, coincident spheres (the lower index
wins), tangent rays (``disc`` exactly 0), spheres behind the origin and an
origin inside a sphere, boxes met by directions with zero, tiny and
non-finite components, batches that are not a multiple of a group, and a
scene with no spheres. ``flat_smem_bytes`` must match the kernel's shared
layout. Rays come from the demo camera and numpy seeds.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.models import scenes
from raytracer_tpu_torch.ops import cuda_fold, cuda_hit
from raytracer_tpu_torch.ops.trace import raygen_tile

torch.set_num_threads(1)


def _camera_rays(w, h):
    o, d = raygen_tile(scenes.reference_demo_camera(device="cpu"), w, h)
    return V3(*(c.contiguous() for c in o.broadcast_to(d.x.shape))), d


def _planes(a: np.ndarray) -> V3:
    """A V3 of float32 planes from the last axis of ``a`` (size 3)."""
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[..., k], dtype=np.float32))
                for k in range(3)))


def _same(a, b) -> bool:
    """Equal bit for bit, NaN where the other is NaN."""
    if a.dtype.is_floating_point:
        return a.shape == b.shape and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def _check(tables, o, d, **kw):
    """The mirror against the plain version; returns the plain ``(t, index)``
    and the mirror's work."""
    (t, i), work = cuda_hit.fold_flat_mirror(tables, o, d, **kw)
    want = cuda_hit.fold_flat_reference(tables, o, d)
    assert _same(t, want[0]) and _same(i, want[1])
    assert t.dtype == torch.float32 and i.dtype == torch.int32
    return want, work


def _with_spheres(base, center, radius):
    """``base`` with its spheres replaced by these (the first sphere's
    material for every one)."""
    sp, n = base.spheres, len(radius)
    mat = sp.material
    mat = mat.replace(**{f.name: getattr(mat, f.name)[:1].expand(n, *getattr(mat, f.name).shape[1:])
                         .contiguous() for f in dataclasses.fields(mat)})
    return base.replace(spheres=sp.replace(
        center=torch.tensor(center, dtype=torch.float32),
        radius=torch.tensor(radius, dtype=torch.float32), material=mat))


@pytest.fixture(scope="module")
def grid130():
    return cuda_fold.fused_tables(scenes.grid_sphere_scene(130, device="cpu"))


@pytest.mark.parametrize("rays", [1, 4])
def test_flat_mirror_grid130_ragged_tile(grid130, rays):
    """grid-130 at 333x111 (a batch that is no multiple of a group), the
    spheres in tiles of 64 (the last holds 2) and in one copy; the default
    2 rays a thread runs in the other tests."""
    o, d = _camera_rays(333, 111)
    for tile in (64, None):
        (t, i), work = _check(grid130, o, d, rays=rays, tile=tile)
        assert work["tiles"] == (3 if tile else 1)
        assert work["threads"] * rays >= o.x.numel() > (work["threads"] - 256) * rays
        assert work["one_origin_groups"] == work["groups"]  # camera rays: one origin
    assert 0 < work["roots"] < work["tests"] and int((i >= 0).sum()) > 1000
    assert 0 < work["branches_taken"] < work["branches"]


def test_flat_mirror_table_past_one_tile():
    """4100 spheres on a 16x8 frame (64 KB of spheres): streamed in tiles
    of ``FLAT_TILE`` (``flat_plan``; the last holds 4), and in one copy."""
    tables = cuda_fold.fused_tables(scenes.grid_sphere_scene(4100, device="cpu"))
    o, d = _camera_rays(16, 8)
    assert cuda_hit.flat_plan(tables)[0] == cuda_hit.FLAT_TILE == 2048
    (_, i), work = _check(tables, o, d)
    assert work["tiles"] == 3 and int((i >= 0).sum()) > 50
    _, work = _check(tables, o, d, tile=4100)
    assert work["tiles"] == 1


def test_flat_mirror_coincident_spheres_lower_index_wins(grid130):
    """The sphere most camera rays of grid-130 hit, copied onto a sphere of
    its own tile and onto one of a later tile: every lane that hits the
    copies keeps the lowest index, in tiles of 64 or in one copy."""
    base = scenes.grid_sphere_scene(130, device="cpu")
    o, d = _camera_rays(160, 96)
    i0 = cuda_hit.fold_flat_reference(grid130, o, d)[1]
    hits = torch.bincount(i0[(i0 >= 0) & (i0 < 130)].reshape(-1).long(), minlength=130)
    j1 = int(hits[:60].argmax())
    copies = (j1 + 1, 64 + j1 + 3)
    center = base.spheres.center.clone()
    for j in copies:
        center[j] = center[j1]
    tables = cuda_fold.fused_tables(base.replace(spheres=base.spheres.replace(center=center)))
    for tile in (64, None):
        (_, i), _ = _check(tables, o, d, tile=tile)
        assert (i == j1).sum() > 20
        assert not any(bool((i == j).any()) for j in copies)


def test_flat_mirror_tangent_rays():
    """Rays tangent to a sphere of centre (7, 0, 0) and radius 2 from
    (0, +-2, 0) and (0, 0, +-2) along +x: ``disc`` is exactly 0, the root
    is 7 and the ray hits; rays moved a little outward (numpy seed) miss it,
    inward hit it."""
    base = scenes.grid_sphere_scene(4, device="cpu")
    scene = _with_spheres(base, [[7.0, 0.0, 0.0], [40.0, 30.0, 30.0], [40.0, -30.0, 30.0]],
                          [2.0, 1.0, 1.0])
    tables = cuda_fold.fused_tables(scene)
    assert float(tables.cols["cr2"][0]) == 45.0
    rim = np.array([[0, 2, 0], [0, -2, 0], [0, 0, 2], [0, 0, -2]], np.float32)
    rng = np.random.default_rng(3)
    eps = rng.uniform(1e-4, 1e-2, size=(4, 1)).astype(np.float32)
    orig = np.concatenate([rim, rim * (1 + eps), rim * (1 - eps)])
    o, d = _planes(orig), _planes(np.tile(np.float32([1, 0, 0]), (12, 1)))
    (t, i), work = _check(tables, o, d)
    assert torch.equal(t[:4], torch.full((4,), 7.0))
    assert torch.equal(i[:4], torch.zeros(4, dtype=torch.int32))
    assert bool((i[4:8] != 0).all()) and bool((i[8:] == 0).all())
    assert work["roots"] >= 8


def test_flat_mirror_spheres_behind_and_origin_inside():
    """Rays from inside a sphere of radius 3 at the origin (its near root is
    behind them) and rays that point away from every other sphere
    (``b_half >= 0``): no hit on either, the same in both versions."""
    base = scenes.grid_sphere_scene(4, device="cpu")
    scene = _with_spheres(base, [[0.0, 0.0, 0.0], [10.0, 0.0, 0.0], [10.0, 4.0, 0.0]],
                          [3.0, 1.0, 1.0])
    tables = cuda_fold.fused_tables(scene)
    rng = np.random.default_rng(7)
    inside = rng.uniform(-1.5, 1.5, size=(300, 3))
    d_in = rng.normal(size=(300, 3))
    d_in /= np.linalg.norm(d_in, axis=1, keepdims=True)
    behind = np.tile(np.float32([5.0, 0.0, 0.0]), (200, 1)) + rng.uniform(-0.3, 0.3, (200, 3))
    d_behind = np.tile(np.float32([-1.0, 0.0, 0.0]), (200, 1))
    o = _planes(np.concatenate([inside, behind]))
    d = _planes(np.concatenate([d_in, d_behind]))
    (t, i), work = _check(tables, o, d)
    assert not bool((i[:300] == 0).any())
    assert bool(((i[300:] == 0) | (i[300:] == -1)).all())
    assert work["roots"] > 0


def test_flat_mirror_box_directions():
    """The mixed scene (boxes, walls, spheres) with direction components
    set to 0, +-1e-13 (below ``srecip``'s 1e-12), +-inf and NaN (numpy
    seed): the safe reciprocal's every branch, the same bits; and with no
    boxes the mirror takes no reciprocal."""
    tables = cuda_fold.fused_tables(scenes.mixed_primitive_scene(device="cpu"))
    assert tables.counts["n_b"] > 0
    o, d = _camera_rays(48, 32)
    rng = np.random.default_rng(13)
    dd = np.stack([c.numpy() for c in d], axis=-1)
    specials = np.float32([0.0, -0.0, 1e-13, -1e-13, np.inf, -np.inf, np.nan])
    pick = rng.random(dd.shape) < 0.2
    dd = np.where(pick, specials[rng.integers(0, len(specials), dd.shape)], dd)
    (t, i), _ = _check(tables, o, _planes(dd))
    assert bool((i >= tables.counts["n_s"] + tables.counts["n_w"]).any())  # some box wins


def test_flat_mirror_batches_past_a_group(grid130):
    """1, 255, 257 and 1000 rays as 1-D planes and as ``[H, W]`` planes
    (numpy-seeded directions toward the grid; the first half of the rays
    from one origin, the rest from origins near it), at 1, 2 and 4 rays a
    thread: a group's last rays missing, groups of one origin and not."""
    rng = np.random.default_rng(17)
    for n in (1, 255, 257, 1000):
        orig = rng.normal(scale=0.3, size=(n, 3))
        orig[: n // 2] = orig[0]
        dirs = np.float32([1.0, 0.0, 0.0]) + rng.normal(scale=0.3, size=(n, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        for shape in ((n,), (1, n) if n < 255 else (n // 5, 5) if n % 5 == 0 else (1, n)):
            o, d = _planes(orig.reshape(*shape, 3)), _planes(dirs.reshape(*shape, 3))
            for rays in (1, 2, 4):
                (t, i), work = _check(grid130, o, d, rays=rays)
                assert t.shape == shape and work["threads"] * rays >= n
                size = cuda_hit.FLAT_BLOCK * rays
                assert work["one_origin_groups"] == sum(
                    bool((orig[g:g + size] == orig[g]).all()) for g in range(0, n, size))


def test_flat_mirror_walls_only():
    """sprint3 without its sphere: the walls alone, no sphere tile."""
    scene = scenes.sprint3_scene(device="cpu")
    sp, mat = scene.spheres, scene.spheres.material
    scene = scene.replace(spheres=sp.replace(
        center=sp.center[:0], radius=sp.radius[:0],
        material=mat.replace(**{f.name: getattr(mat, f.name)[:0]
                                for f in dataclasses.fields(mat)})))
    tables = cuda_fold.fused_tables(scene)
    assert tables.counts["n_s"] == 0 and tables.counts["n_w"] > 0
    o, d = _camera_rays(64, 48)
    (t, i), work = _check(tables, o, d)
    assert work["tests"] == 0 and work["tiles"] == 0 and bool((i >= 0).any())


def test_flat_smem_bytes_matches_kernel_layout(monkeypatch):
    """The kernel's shared memory (csrc/fold_flat.cu's ``flat_smem``): the
    tile's spheres as float4, then the walls' (15 floats) and boxes' (6)
    columns as they are in the packed table; the whole table while it fits
    ``FLAT_WHOLE_MAX``, else tiles of ``FLAT_TILE`` spheres. And its rays a
    thread: one below ``FLAT_SMALL`` rays, else ``FLAT_RAYS``."""
    assert [cuda_hit.flat_rays(n) for n in (1, 99_999, 100_000, 2_073_600)] == [1, 1, 2, 2]
    cases = [scenes.sprint3_scene(device="cpu"), scenes.mixed_primitive_scene(device="cpu"),
             scenes.grid_sphere_scene(1024, device="cpu")]
    for scene in cases:
        tables = cuda_fold.fused_tables(scene)
        c = tables.counts
        rest = 4 * (15 * c["n_w"] + 6 * c["n_b"])
        assert cuda_fold._LAYOUT[1][0] == "n_w" and len(cuda_fold._LAYOUT[1][1]) == 15
        assert cuda_fold._LAYOUT[2][0] == "n_b" and len(cuda_fold._LAYOUT[2][1]) == 6
        assert cuda_hit.flat_plan(tables) == (max(c["n_s"], 1), 16 * c["n_s"] + rest)
        assert cuda_hit.flat_smem_bytes(tables) <= cuda_hit.FLAT_WHOLE_MAX
    for n_s, tile in ((3068, 3068), (3069, cuda_hit.FLAT_TILE)):  # one wall: 60 bytes
        grid = cuda_fold.fused_tables(scenes.grid_sphere_scene(n_s, device="cpu"))
        assert grid.counts["n_w"] == 1 and grid.counts["n_b"] == 0
        assert cuda_hit.flat_plan(grid) == (tile, 16 * tile + 60)
        assert (16 * n_s + 60 <= 48 * 1024) == (tile == n_s)
    monkeypatch.setattr(cuda_hit, "FLAT_WHOLE_MAX", 8 * 1024)
    monkeypatch.setattr(cuda_hit, "FLAT_TILE", 256)
    assert cuda_hit.flat_plan(tables) == (256, 16 * 256 + rest)
    assert cuda_hit.flat_smem_bytes(tables) == 16 * 256 + rest
