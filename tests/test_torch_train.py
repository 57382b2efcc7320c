"""The port's hard-path gradient end to end on the CPU (the kernels' plain
versions): ``render``'s gradient against ``jax.grad`` of the JAX package's
``render``, the fit step against optax's Adam, material gradients against
central finite differences, and the fit itself."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from raytracer_tpu.models import scenes as jscenes
from raytracer_tpu.oracle.numpy_ref import scene_to_numpy
from raytracer_tpu.parallel.train import merge_params as j_merge_params
from raytracer_tpu.render.integrator import render as j_render
from raytracer_tpu_torch import default_params, make_fit_step, merge_params, render
from raytracer_tpu_torch.core.types import Scene
from raytracer_tpu_torch.models import scenes as tscenes

torch.set_num_threads(1)

SHIFT = {"center": 0.05, "color": -0.2}  # the fit's start: the true scene, moved


def _start(params: dict) -> dict:
    return {k: v + SHIFT[k] for k, v in params.items()}


def test_render_gradient_matches_jax():
    """The gradient of the image MSE with respect to the sphere's center and
    colour (sprint3, 96x64, depth 3, a moved start against the true scene's
    JAX render) agrees with ``jax.grad`` through the JAX ``render`` to 1e-2
    of the gradient's norm. The two normalise the camera rays with rsqrts
    that differ in the last bit, which flips a few silhouette pixels between
    hit and miss; each such pixel moves the MSE's gradient by O(1/pixels),
    and that, not the backward, is what the bar allows for."""
    w, h, depth = 96, 64, 3
    jscene, jcam = jscenes.sprint3_scene(), jscenes.reference_demo_camera()
    scene = Scene.from_numpy(scene_to_numpy(jscene, np.float32), device="cpu")
    cam = tscenes.reference_demo_camera(device="cpu")
    target = render(scene, cam, w, h, depth=depth, device="cpu")  # the same target for both
    p0 = _start({"center": jscene.spheres.center, "color": jscene.spheres.material.color})

    def j_loss(p):
        img = j_render(j_merge_params(jscene, p), jcam, w, h, depth=depth)
        return jnp.mean((img - jnp.asarray(target.numpy())) ** 2)

    want = jax.grad(j_loss)(p0)
    p = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in p0.items()}
    img = render(merge_params(scene, p), cam, w, h, depth=depth, device="cpu")
    got = torch.autograd.grad(torch.mean((img - target) ** 2), list(p.values()))
    g_port = np.concatenate([g.numpy().ravel() for g in got])
    g_jax = np.concatenate([np.asarray(want[k]).ravel() for k in p])
    assert np.isfinite(g_port).all()
    assert np.linalg.norm(g_port - g_jax) <= 1e-2 * np.linalg.norm(g_jax), (g_port, g_jax)


def test_fit_step_is_adam_on_the_port_gradient():
    """One ``step_fn`` equals ``optax.adam(2e-2)`` applied to the port's own
    gradient at the same parameters, to 1e-6."""
    w, h = 48, 32
    scene = tscenes.sprint3_scene(device="cpu")
    cam = tscenes.reference_demo_camera(device="cpu")
    target = render(scene, cam, w, h, depth=2, device="cpu")
    start = merge_params(scene, _start(default_params(scene)))
    init_fn, step_fn = make_fit_step(w, h, depth=2, device="cpu")
    state = init_fn(start)
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    loss = torch.mean((render(merge_params(start, p), cam, w, h, depth=2, device="cpu") - target) ** 2)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    state, step_loss = step_fn(state, start, cam, target)
    assert state.step == 1 and float(step_loss) == pytest.approx(loss.item(), rel=1e-6)
    opt = optax.adam(2e-2)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p0.items()}
    updates, _ = opt.update({k: jnp.asarray(g.numpy()) for k, g in grads.items()}, opt.init(jp), jp)
    want = optax.apply_updates(jp, updates)
    for k in p0:
        np.testing.assert_allclose(state.params[k].detach().numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)
        assert not torch.equal(state.params[k].detach(), p0[k])


def _fd_scene(name: str):
    if name == "grid4":
        return tscenes.grid_sphere_scene(4, distance=4.0, device="cpu")
    return tscenes.mixed_primitive_scene(device="cpu")


@pytest.mark.parametrize("param", ["color", "metallic", "diffuse"])
@pytest.mark.parametrize("scene_name", ["grid4", "mixed"])
def test_material_gradients_match_fd(scene_name, param):
    """Material parameters move no silhouette, so the hard path's gradient
    matches central differences to 2% (the JAX package's bar,
    tests/test_hard_gradients.py), at depth 2 through the bounces."""
    w, h, depth = 64, 48, 2
    scene = _fd_scene(scene_name)
    cam = tscenes.reference_demo_camera(device="cpu")
    target = render(scene, cam, w, h, depth=depth, tonemap=False, device="cpu")
    m = scene.spheres.material

    def loss(x):
        if param == "color":
            col = m.color.clone()
            col[0, 1] = col[0, 1] + x
            mm = m.replace(color=col)
        elif param == "metallic":
            mm = m.replace(metallic=torch.clamp(m.metallic + x, 0.0, 1.0))
        else:
            mm = m.replace(diffuse=m.diffuse + x)
        s2 = scene.replace(spheres=scene.spheres.replace(material=mm))
        img = render(s2, cam, w, h, depth=depth, tonemap=False, device="cpu")
        return torch.mean((img - target) ** 2)

    delta, step = 0.07, 1e-3
    x = torch.tensor(delta, requires_grad=True)
    (g,) = torch.autograd.grad(loss(x), x)
    with torch.no_grad():
        fd = float((loss(torch.tensor(delta + step)) - loss(torch.tensor(delta - step))) / (2 * step))
    assert np.isfinite(float(g)) and np.isfinite(fd)
    assert abs(float(g) - fd) <= 0.02 * max(abs(fd), 1e-6), (float(g), fd)


def test_fit_lowers_the_loss():
    w, h = 64, 48
    scene = tscenes.sprint3_scene(device="cpu")
    cam = tscenes.reference_demo_camera(device="cpu")
    with torch.no_grad():
        target = render(scene, cam, w, h, depth=1, device="cpu")
    start = merge_params(scene, _start(default_params(scene)))
    init_fn, step_fn = make_fit_step(w, h, depth=1, device="cpu")
    state = init_fn(start)
    losses = []
    for _ in range(5):
        state, loss = step_fn(state, start, cam, target)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and state.step == 5
    assert losses[-1] < 0.7 * losses[0], losses


def test_fit_rejects_soft_and_mesh():
    """The pixel-sharded mesh is not ported and raises, with or without
    ``soft``; the soft fit is ported (tests/test_torch_soft_grad.py holds
    it against the JAX package) and takes a step."""
    with pytest.raises(NotImplementedError, match="mesh"):
        make_fit_step(8, 8, mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        make_fit_step(8, 8, mesh=object(), soft=True)
    scene = tscenes.grid_sphere_scene(4, distance=4.0, device="cpu")
    cam = tscenes.reference_demo_camera(device="cpu")
    init_fn, step_fn = make_fit_step(8, 6, depth=1, soft=True, device="cpu")
    state, loss = step_fn(init_fn(scene), scene, cam, torch.zeros((6, 8, 3)))
    assert state.step == 1 and np.isfinite(float(loss)) and float(loss) > 0.0
    assert all(bool(torch.isfinite(v.grad).all()) and float(v.grad.abs().max()) > 0.0
               for v in state.params.values())
