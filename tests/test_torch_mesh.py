"""The port's mesh, hosts and collectives' selection rule in one process (no
spawn, no process group): ``make_mesh`` and its errors, ``pad_scene_spheres``
and ``scene_pspecs`` against the JAX package's, ``_globalize_prim_index``
and the hit combine's rule on hand-made per-shard records,
``initialize_distributed`` without a group, ``RenderConfig.build_mesh`` in
one process, ``benchmark_scaling``'s efficiency, ``dryrun_multichip``'s
CUDA default, and the 1x1 mesh's renders
against the single-rank ones. The four-rank runs are
tests/test_torch_sharded.py's."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from raytracer_tpu.models import scenes as jscenes
from raytracer_tpu.parallel.mesh import pad_scene_spheres as j_pad_scene_spheres
from raytracer_tpu.parallel.mesh import scene_pspecs as j_scene_pspecs
from raytracer_tpu_torch.app.config import BASELINE_CONFIGS
from raytracer_tpu_torch.core.types import Scene
from raytracer_tpu_torch.core.v3 import V3
from raytracer_tpu_torch.diff.soft import render_soft
from raytracer_tpu_torch.models import scenes as tscenes
from raytracer_tpu_torch.ops.trace import MISS_T, SoAHit
from raytracer_tpu_torch.parallel import (
    initialize_distributed,
    is_lead,
    is_multi_host,
    make_mesh,
    pad_scene_spheres,
    render_sharded,
    scene_pspecs,
    slice_mesh,
)
from raytracer_tpu_torch.parallel import comm
from raytracer_tpu_torch.parallel.dryrun import dryrun_multichip
from raytracer_tpu_torch.parallel.mesh import PRIM_AXIS, PX_AXIS, shard_scene
from raytracer_tpu_torch.parallel.render import (
    _combine_hits,
    _globalize_prim_index,
    _planes,
    render_soft_sharded_impl,
)
from raytracer_tpu_torch.render.integrator import render
from raytracer_tpu_torch.utils.profiler import scaling_rows

torch.set_num_threads(1)


def test_make_mesh_shapes_and_errors():
    """Without a process group the only mesh is 1x1 over rank 0, with no
    groups (its collectives are identities); any other shape says what it
    needs."""
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {PX_AXIS: 1, PRIM_AXIS: 1} and mesh.size == 1
    assert mesh.devices.tolist() == [[0]] and mesh.coords == (0, 0) and mesh.rank == 0
    assert mesh.group is mesh.px_group is mesh.prim_group is None
    assert mesh.device == torch.device("cpu")
    assert slice_mesh(device="cpu").devices.tolist() == [[0]]
    with pytest.raises(ValueError, match="not divisible by prim=2"):
        make_mesh(prim=2, device="cpu")
    with pytest.raises(ValueError, match="not divisible by prim=3"):
        slice_mesh(prim=3, device="cpu")
    for shape in ((2, 1), (1, 2)):
        with pytest.raises(ValueError, match="needs a process group of 2 ranks"):
            make_mesh(*shape, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()  # the default device is the card
    assert not dist.is_initialized()


def _j_to_t(jscene) -> Scene:
    from raytracer_tpu.oracle.numpy_ref import scene_to_numpy

    return Scene.from_numpy(scene_to_numpy(jscene, np.float32), device="cpu")


def test_pad_scene_spheres_equals_jax():
    """Leaf for leaf the JAX package's padded scene (pads at 1e8, radius 0,
    zero materials), differentiable in the real spheres only; a multiple
    that divides the count leaves the scene as it is."""
    jscene = jscenes.grid_sphere_scene(5, distance=4.0)
    scene = _j_to_t(jscene)
    want = jax.tree_util.tree_leaves(j_pad_scene_spheres(jscene, 4))
    got = list(pad_scene_spheres(scene, 4).tensors())
    assert len(got) == len(want) == 34
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert pad_scene_spheres(scene, 5) is scene
    center = scene.spheres.center.clone().requires_grad_(True)
    padded = pad_scene_spheres(scene.replace(spheres=scene.spheres.replace(center=center)), 4)
    padded.spheres.center.sum().backward()
    assert torch.equal(center.grad, torch.ones_like(center))


def test_scene_pspecs_and_shard_scene():
    """``scene_pspecs`` marks the same leaves as the JAX package's (spheres
    over ``prim``, the rest whole); ``shard_scene``'s shards join back into
    the padded sphere table and hold every other leaf whole."""
    want = [s == P(PRIM_AXIS) for s in jax.tree_util.tree_leaves(
        j_scene_pspecs(), is_leaf=lambda x: isinstance(x, P))]
    got = [s == PRIM_AXIS for s in scene_pspecs().tensors()]
    assert got == want and sum(got) == 8
    padded = pad_scene_spheres(tscenes.mixed_primitive_scene(device="cpu"), 3)
    shards = [shard_scene(padded, s, 3) for s in range(3)]
    for k, (leaf, marked) in enumerate(zip(padded.tensors(), got)):
        parts = [list(sh.tensors())[k] for sh in shards]
        if marked:
            assert all(p.shape[0] == len(padded.spheres) // 3 for p in parts)
            assert torch.equal(torch.cat(parts), leaf)
        else:
            assert all(p is leaf for p in parts)


def _record(t, index, n: int = 4) -> SoAHit:
    """A hand-made record: ``t`` and ``index`` per ray, every other plane a
    value that names it (its index plus 100 ray ids)."""
    t = torch.tensor(t, dtype=torch.float32)
    i = torch.tensor(index, dtype=torch.int32)
    tag = i.to(torch.float32) * 100.0 + torch.arange(n, dtype=torch.float32)
    v = V3(tag, tag + 1, tag + 2)
    return SoAHit(t=t, hit=i >= 0, point=v, normal=v, prim_index=i, color=v, ambient=tag,
                  metallic=tag, diffuse=tag, specular=tag, specular_exponent=tag)


def test_globalize_prim_index():
    """Shard 2 of 3, 4 local spheres of 10 real ones: local sphere 1 is
    global 9, local wall 0 (index 4) global 10, local box 1 of 2 walls
    (index 7) global 13, a miss stays -1."""
    rec = _globalize_prim_index(_record([1.0] * 4, [1, 4, 7, -1]), 4, 10, 2)
    assert rec.prim_index.tolist() == [9, 10, 13, -1] and rec.prim_index.dtype == torch.int32
    assert torch.equal(rec.t, torch.ones(4))


def test_combine_selection_rule():
    """Three shards' records on four rays, summed as ``masked_sum`` sums
    them: each ray gets its least-``t`` shard's record; a tie (ray 1: a
    wall every shard holds; ray 2: spheres of shards 1 and 2 at one ``t``)
    goes to the lowest shard; a ray every shard misses gets a miss record. With no
    group the combine is the identity."""
    recs = [_record([3.0, 2.0, 5.0, MISS_T], [0, 12, 1, -1]),
            _record([1.0, 2.0, 4.0, MISS_T], [4, 12, 5, -1]),
            _record([2.0, 2.0, 4.0, MISS_T], [8, 12, 9, -1])]
    win = comm.first_min(torch.stack([r.t for r in recs]))
    assert win.tolist() == [1, 0, 1, 0]
    flat = [_planes(r) for r in recs]
    parts = [comm.pick(f, win == s) for s, f in enumerate(flat)]
    summed = [sum(ps) for ps in zip(*parts)]
    want = _planes(_record([1.0, 2.0, 4.0, MISS_T], [4, 12, 5, -1]))
    for got, exp in zip(summed, want, strict=True):
        assert torch.equal(got.to(exp.dtype), exp)
    assert summed[1].dtype == torch.int32 and summed[1].tolist() == [1, 1, 1, 0]
    assert all(a is b for a, b in zip(_planes(_combine_hits(recs[0], None)), flat[0]))


def test_initialize_distributed_without_a_group(monkeypatch):
    """No arguments and no torchrun environment: one process, ``False``,
    and no group; explicit arguments that cannot form a group raise before
    any connection is tried."""
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert initialize_distributed() is False and not dist.is_initialized()
    with pytest.raises(ValueError, match="together"):
        initialize_distributed("127.0.0.1:1")
    with pytest.raises(ValueError, match="process_id 2 is not in"):
        initialize_distributed("127.0.0.1:1", 2, 2, device="cpu")
    assert not dist.is_initialized()
    assert is_multi_host() is False and is_lead() is True


def test_build_mesh_in_one_process(monkeypatch):
    """``None`` gives ``None``; ``"auto"`` gives ``None`` on one device and
    raises on a host of several CUDA devices without torchrun; ``(1, 1)``
    is the one-process mesh; ``(2, 1)`` and ``(1, 2)`` say they need two
    ranks."""
    cfg = BASELINE_CONFIGS["c5-4k-1024sphere"]
    assert cfg.mesh == "auto" and cfg.build_mesh(device="cpu") is None
    assert cfg.build_mesh() is None and cfg.replace(mesh=None).build_mesh() is None
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "device_count", lambda: 2)
        with pytest.raises(RuntimeError, match="launch under torchrun"):
            cfg.build_mesh()
        assert cfg.build_mesh(device="cpu") is None
    assert cfg.replace(mesh=(1, 1)).build_mesh(device="cpu").shape == {PX_AXIS: 1, PRIM_AXIS: 1}
    for shape in ((2, 1), (1, 2)):
        with pytest.raises(ValueError, match="needs 2 ranks, and 1 take part"):
            cfg.replace(mesh=shape).build_mesh(device="cpu")
    assert not dist.is_initialized()


def test_benchmark_scaling_efficiency_from_two():
    """Counts that start at 2: perfect scaling from 2 to 4 is efficiency 1,
    not the 0.5 that dividing by the absolute count gives."""
    rows = scaling_rows([2, 4, 8], [10.0, 5.0, 3.0])
    assert [r["scaling_efficiency"] for r in rows] == pytest.approx([1.0, 1.0, 10 / 3 / 4])
    assert [r["frames_per_first"] for r in rows] == pytest.approx([1.0, 2.0, 10 / 3])
    assert scaling_rows([1, 2], [4.0, 2.5])[1]["scaling_efficiency"] == pytest.approx(0.8)


def test_dryrun_multichip_defaults_to_cuda(monkeypatch):
    """Without ``device`` the dry run puts one rank on each CUDA device, as
    the port's entry points default to CUDA; with fewer cards than ranks it
    raises, naming the count, before it starts a process."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices, one a rank; this host has 1"):
        dryrun_multichip(4)


def test_one_rank_mesh_renders_equal_single_rank():
    """On the 1x1 mesh of one process ``render_sharded`` is ``render`` and
    the sharded soft render is ``render_soft``, bit for bit."""
    mesh = make_mesh(device="cpu")
    scene, cam = tscenes.mixed_primitive_scene(device="cpu"), tscenes.reference_demo_camera(
        device="cpu")
    with torch.no_grad():
        got = render_sharded(scene, cam, 40, 23, mesh=mesh, depth=2)
        assert torch.equal(got, render(scene, cam, 40, 23, depth=2, device="cpu"))
        got = render_soft_sharded_impl(scene, cam, 40, 23, mesh=mesh, tau=0.02, depth=1)
        assert torch.equal(got, render_soft(scene, cam, 40, 23, tau=0.02, depth=1,
                                            device="cpu"))
    with pytest.raises(TypeError, match="Mesh"):
        render_sharded(scene, cam, 8, 8, mesh=object())
