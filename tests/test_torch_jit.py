"""The port's compiled frame and step: `render_jit` and
`make_train_step_jit`, with the bin table at a bucket of the live count
(`bin_triangles(capacity=...)`, `utils/graphs.py`).

On the CPU (no graphs; the same bucketed path and growth check):
- the bucketed table against the live-count table: ``geom``,
  ``entry_tri``, ``starts`` and the plain K1's t and ids bitwise equal on
  every live entry, the dead entries dead, with and without backface cull;
- a bucket below the live count is detected (``num_entries`` above it) and
  `render_jit` redoes the frame at a larger bucket, bitwise `render`'s;
- `render_jit` bitwise the port's `render`, and against JAX's compiled
  frame on the same converted scene (``J.render_jit`` for "bin" and
  "brute"; ``jax.jit(J.render)`` with the accel for "pallas2", whose JAX
  ``render_jit`` takes none; JAX's Pallas kernels in interpret mode, as
  its own tests run them): the tolerances of tests/test_torch_render.py
  (ids equal on >= 99.9% of pixels, each mismatch an exact-t tie at rtol
  1e-5; hit_t rtol 1e-5; radiance rtol 1e-4, atol 1e-5 where the ids
  agree; the image within 1), with "pallas2"'s t at the rtol 1e-4 of
  tests/test_torch_cluster.py (JAX's K4 quantises t);
- the compiled step against ``jax.jit(make_train_step(optax.sgd(lr)))``:
  two steps, the loss at rtol 1e-5, each step's change within 1e-4 of
  JAX's plus one float32 spacing, the parameters at rtol 1e-5 (atol 1e-7),
  as tests/test_torch_train.py; and bitwise the port's eager step;
- refusals: a mesh, and optimizers that cannot be captured.

On the card (marked ``gpu``; they skip here): K1, K2, K4 and K5 each
captured alone and replayed bitwise; replays bitwise `render`'s
frames for every captured method ("bin", "pallas2", "pallas", "grid",
"brute", "fixed", the last two in float64 too), a first call's outputs
unchanged
by a second call, growth captured again and still bitwise, the compiled
step's parameters bitwise the eager step's after 3 steps. The JAX package
is imported inside the CPU tests, so that on the card's machine, which has
no JAX, the GPU tests run with
    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_jit.py
"""

import numpy as np
import pytest
import torch

import cpp_cuda_raytracer_dev_torch as P
from cpp_cuda_raytracer_dev_torch.accel.binning import bin_triangles
from cpp_cuda_raytracer_dev_torch.accel.traverse import bin_object
from cpp_cuda_raytracer_dev_torch.models import renderer
from cpp_cuda_raytracer_dev_torch.models.renderer import (jit_captures,
                                                          render_jit)
from cpp_cuda_raytracer_dev_torch.ops.cuda.bin_intersect import \
    bin_intersect_reference
from cpp_cuda_raytracer_dev_torch.ops.quaternion import from_axis_angle
from cpp_cuda_raytracer_dev_torch.parallel.render_pjit import (
    make_train_step, make_train_step_jit)
from cpp_cuda_raytracer_dev_torch.utils.graphs import GraphCache, next_bucket
from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

RES_W, RES_H = 96, 64
FIELDS = ("image", "radiance", "hit_t", "hit_tri", "hit_obj", "normal",
          "point")
BIN = dict(method="bin", bin_chunk=128)
CLUSTER = dict(leaf_size=32, tile_h=8, tile_w=32, max_candidates=24)


def _port_scene(device, angle=0.6, dtype=torch.float32):
    tv = uv_sphere(50, 50, roughness=0.03)
    color = np.random.default_rng(0).uniform(0.1, 1.0, (tv.shape[0], 3))
    tris = P.Triangles.from_vertices(tv, device=device, dtype=dtype,
                                     color=color.astype(np.float32))
    pose = P.Pose(from_axis_angle([0.3, 1.0, 0.1], angle,
                                  device=device).to(dtype),
                  torch.tensor([0.15, -0.1, 0.2], dtype=dtype, device=device))
    return P.Scene([P.SceneObject(tris, pose)])


def _camera(device, pos=(0.1, 0.3, -3.0), dtype=torch.float32):
    return P.Camera.create(RES_W, RES_H, pos=list(pos), look_at=[0, 0, 0],
                           up=[0, 1, 0], film_h=0.024, focal=0.055,
                           device=device, dtype=dtype)


def _assert_bitwise(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert torch.equal(x, y), f


def _bin_args(scene, cam, cull):
    obj = scene.objects[0]
    tris = obj.tris
    with torch.no_grad():
        return (cam.projection().transformed(obj.pose),
                obj.pose.inv_apply(cam.pos),
                (tris.p1x, tris.p1y, tris.p1z),
                (tris.e1x, tris.e1y, tris.e1z),
                (tris.e2x, tris.e2y, tris.e2z), RES_H, RES_W, 16, 32)


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("extra", [0, 3])
def test_bucketed_table_is_the_live_count_table(cull, extra):
    scene, cam = _port_scene("cpu"), _camera("cpu")
    args = _bin_args(scene, cam, cull)
    with torch.no_grad():
        live = bin_triangles(*args, chunk=128, backface_cull=cull)
        n = live.num_entries
        cap = next_bucket(n, 128) << extra
        got = bin_triangles(*args, chunk=128, backface_cull=cull,
                            capacity=cap)
    assert isinstance(got.num_entries, torch.Tensor)
    assert int(got.num_entries) == n and n > 500
    assert got.geom.shape == (11, cap + 128)
    assert torch.equal(got.starts, live.starts)
    assert int(got.starts[-1]) == n            # the dead entries sort last
    assert torch.equal(got.geom[:, :n], live.geom[:, :n])
    assert torch.equal(got.entry_tri[:n], live.entry_tri[:n])
    assert bool((got.entry_tri[n:] == -1).all())
    assert bool((got.geom[:10, n:] == 0).all())
    assert bool((got.geom[10, n:] == 3.0e38).all())
    assert torch.equal(got.qstep, live.qstep)
    assert torch.equal(got.cross_tris, live.cross_tris)
    rays, _ = bin_object(args[1], scene.objects[0].tris, args[0],
                         P.RenderConfig(**BIN, backface_cull=cull), RES_H,
                         RES_W)
    want = bin_intersect_reference(rays, live.geom, live.entry_tri,
                                   live.starts, 128)
    have = bin_intersect_reference(rays, got.geom, got.entry_tri, got.starts,
                                   128)
    for x, y in zip(have, want):
        assert torch.equal(x, y)
    assert float((have[1] >= 0).float().mean()) > 0.3


def test_undersized_bucket_is_caught_and_redone(monkeypatch):
    scene = _port_scene("cpu")
    near, far = _camera("cpu", (0.0, 0.0, -1.6)), _camera("cpu",
                                                           (0.0, 0.0, -8.0))
    with torch.no_grad():
        n_near = bin_triangles(*_bin_args(scene, near, False),
                               chunk=128).num_entries
        args_far = _bin_args(scene, far, False)
        n_far = bin_triangles(*args_far, chunk=128).num_entries
        small = next_bucket(n_near, 128)
        assert n_far > small            # the far view outgrows the bucket
        cut = bin_triangles(*args_far, chunk=128, capacity=small)
    assert int(cut.num_entries) == n_far > cut.geom.shape[1] - 128

    cache = GraphCache()
    monkeypatch.setattr(renderer, "FRAME_GRAPHS", cache)
    cfg = P.RenderConfig(**BIN)
    for cam in (near, far, near):
        _assert_bitwise(render_jit(scene, cam, cfg),
                        P.render(scene, cam, cfg))
    assert cache.regrown == 1
    assert list(cache.buckets.values()) == [next_bucket(n_far, 128)]
    assert cache.captures == 0 and not cache.graphs     # no graphs here


def test_uncaptured_methods_are_named():
    assert all(jit_captures(P.RenderConfig(method=m)) for m in
               ("bin", "pallas2", "pallas", "grid", "brute", "fixed", "kd"))
    assert not jit_captures(P.RenderConfig(method="raster"))


@pytest.fixture(scope="module")
def converted():
    import jax
    import jax.numpy as jnp

    import cpp_cuda_raytracer_dev_tpu as J
    from cpp_cuda_raytracer_dev_tpu.accel import traverse as jtr
    from cpp_cuda_raytracer_dev_tpu.ops.quaternion import Pose as JPose
    from cpp_cuda_raytracer_dev_tpu.ops.quaternion import \
        from_axis_angle as jaxis_angle
    from cpp_cuda_raytracer_dev_torch.utils.convert import (
        camera_from_numpy, cluster_accel_from_numpy, path_dict,
        scene_from_numpy)

    tv = uv_sphere(50, 50, roughness=0.03)
    tv = np.roll(tv, -tv.shape[0] // 2, axis=0)
    color = np.random.default_rng(0).uniform(0.1, 1.0, (tv.shape[0], 3))
    jtris = J.Triangles.from_vertices(tv, color.astype(np.float32))
    pose = JPose(quat=jaxis_angle(jnp.array([0.3, 1.0, 0.1]), 0.6),
                 translation=jnp.array([0.15, -0.1, 0.2]))
    jscene = J.Scene.create([J.SceneObject.create(jtris, pose)])
    jcam = J.Camera.create(RES_W, RES_H, pos=[0.1, 0.3, -3.0],
                           look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                           film_h=0.024, focal=0.055)
    flat = jax.tree_util.tree_flatten_with_path
    pscene = scene_from_numpy(path_dict(flat(jscene)[0]), "cpu")
    pcam = camera_from_numpy({**path_dict(flat(jcam)[0]), "res_w": RES_W,
                              "res_h": RES_H}, "cpu")
    jaccel = jtr.ClusterAccel.build(jtris, leaf_size=CLUSTER["leaf_size"],
                                    cache=False)
    paccel = cluster_accel_from_numpy(
        {**{f: np.asarray(getattr(jaccel, f)) for f in
            ("bounds_min", "bounds_max", "centers", "geom9_t",
             "slot_mat")}, "leaf_size": CLUSTER["leaf_size"]}, "cpu")
    return jscene, jcam, jaccel, pscene, pcam, paccel


@pytest.mark.parametrize("kw", [
    dict(method="brute", chunk=1024),
    dict(BIN),
    dict(BIN, backface_cull=True),
    dict(method="pallas2", **CLUSTER),
])
def test_render_jit_matches_jax(converted, kw):
    import jax

    import cpp_cuda_raytracer_dev_tpu as J

    jscene, jcam, jaccel, pscene, pcam, paccel = converted
    cluster = kw["method"] == "pallas2"
    jcfg, pcfg = J.RenderConfig(**kw), P.RenderConfig(**kw)
    if cluster:      # JAX's render_jit takes no accel: jit render with it
        jo = jax.jit(J.render, static_argnums=2)(jscene, jcam, jcfg,
                                                  (jaccel,))
    else:
        jo = J.render_jit(jscene, jcam, jcfg)
    accel = (paccel,) if cluster else None
    po = P.render_jit(pscene, pcam, pcfg, accel)
    _assert_bitwise(po, P.render(pscene, pcam, pcfg, accel))
    for f in FIELDS:
        j, p = np.asarray(getattr(jo, f)), getattr(po, f).numpy()
        assert p.shape == j.shape and p.dtype == j.dtype, f
    jtri, ptri = np.asarray(jo.hit_tri), po.hit_tri.numpy()
    jt, pt = np.asarray(jo.hit_t), po.hit_t.numpy()
    assert (ptri >= 0).mean() > 0.5
    same = ptri == jtri
    assert same.mean() >= 0.999
    t_rtol = 1e-4 if cluster else 1e-5
    np.testing.assert_allclose(pt[~same], jt[~same], rtol=t_rtol)
    np.testing.assert_allclose(pt, jt, rtol=t_rtol)
    np.testing.assert_array_equal(po.hit_obj.numpy(), np.asarray(jo.hit_obj))
    np.testing.assert_allclose(po.radiance.numpy()[same],
                               np.asarray(jo.radiance)[same],
                               rtol=1e-4, atol=1e-5)
    diff = np.abs(po.image.numpy().astype(int)
                  - np.asarray(jo.image).astype(int))
    assert diff[same].max() <= 1


STEP_RES, LR = (32, 24), 1e-3


@pytest.mark.parametrize("kw", [dict(method="fixed", chunk=256),
                                dict(BIN)])
def test_compiled_step_matches_jax(kw):
    import jax
    import jax.numpy as jnp
    import optax

    import cpp_cuda_raytracer_dev_tpu as J
    from cpp_cuda_raytracer_dev_tpu.ops.quaternion import Pose as JPose
    from cpp_cuda_raytracer_dev_tpu.ops.quaternion import \
        from_axis_angle as jaxis_angle
    from cpp_cuda_raytracer_dev_tpu.parallel.render_pjit import \
        make_train_step as jmake_train_step
    from cpp_cuda_raytracer_dev_torch.utils.convert import (
        camera_from_numpy, params_to_numpy, path_dict, scene_from_numpy)

    def jscene(angle):
        # start at the equator: triangle 0 is gathered by every miss pixel
        # and must not be the pole's degenerate one (ROADMAP F6)
        tv = np.roll(uv_sphere(12, 12), -72, axis=0)
        color = np.random.default_rng(0).uniform(0.1, 1.0, (tv.shape[0], 3))
        pose = JPose(quat=jaxis_angle(jnp.array([0.3, 1.0, 0.1]), angle),
                     translation=jnp.array([0.15, -0.1, 0.2]))
        return J.Scene.create([J.SceneObject.create(
            J.Triangles.from_vertices(tv, color.astype(np.float32)), pose)])

    flat = jax.tree_util.tree_flatten_with_path
    jcam = J.Camera.create(*STEP_RES, pos=[0.1, 0.3, -3.0],
                           look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                           film_h=0.024, focal=0.055)
    target = np.asarray(J.render(jscene(0.6), jcam,
                                 J.RenderConfig(**kw)).radiance)
    jparams = {"scene": jscene(0.6 + np.radians(2.0)), "camera": jcam}

    def port_params():
        scene = scene_from_numpy(path_dict(flat(jparams["scene"])[0]), "cpu")
        camera = camera_from_numpy({**path_dict(flat(jcam)[0]),
                                    "res_w": STEP_RES[0],
                                    "res_h": STEP_RES[1]},
                                   "cpu").requires_grad_()
        return {"scene": scene, "camera": camera}

    params, eager_params = port_params(), port_params()
    steps = []
    for p, make in ((params, make_train_step_jit),
                    (eager_params, make_train_step)):
        opt = torch.optim.SGD([*p["scene"].parameters(),
                               *p["camera"].parameters()], lr=LR)
        steps.append(make(opt, P.RenderConfig(**kw)))
    jopt = optax.sgd(LR)
    jstep = jax.jit(jmake_train_step(jopt, J.RenderConfig(**kw), None))
    jstate = jopt.init(jparams)

    def leaves(p):
        return {**params_to_numpy(p["scene"]),
                **{"cam." + k: v for k, v in
                   params_to_numpy(p["camera"]).items()}}

    def jleaves(tree):
        return {**path_dict(flat(tree["scene"])[0]),
                **{"cam." + k: v for k, v in
                   path_dict(flat(tree["camera"])[0]).items()}}

    tgt = torch.tensor(target)
    for _ in range(2):
        before = jleaves(jparams)
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(target))
        loss = steps[0](params, tgt)
        eager_loss = steps[1](eager_params, tgt)
        assert not loss.requires_grad
        assert torch.equal(loss, eager_loss)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        want, got, eager = jleaves(jparams), leaves(params), \
            leaves(eager_params)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], eager[k], err_msg=k)
            p0 = np.asarray(before[k], np.float64)
            change = np.asarray(v, np.float64) - p0
            np.testing.assert_array_less(
                np.abs(got[k] - p0 - change),
                1e-4 * np.abs(change) + 1e-5 * np.abs(change).max()
                + np.spacing(np.abs(before[k]).astype(np.float32)),
                err_msg=k)
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    assert float(loss) > 0


def test_compiled_step_refuses_a_mesh_and_uncapturable_optimizers():
    from cpp_cuda_raytracer_dev_torch.parallel.mesh import DeviceMesh

    w = [torch.zeros(3, requires_grad=True)]
    cfg = P.RenderConfig()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step_jit(torch.optim.SGD(w, lr=0.1), cfg,
                            mesh=object.__new__(DeviceMesh))
    for opt in (torch.optim.SGD(w, lr=0.1, momentum=0.9),
                torch.optim.Adam(w, lr=0.1),
                torch.optim.RMSprop(w, lr=0.1)):
        with pytest.raises(ValueError, match="capturable"):
            make_train_step_jit(opt, cfg)
    make_train_step_jit(torch.optim.SGD(w, lr=0.1, weight_decay=0.1), cfg)


# ---- on the card ----

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda", 0)


def _graph_of(fn):
    """One call of ``fn`` captured (after a warm-up on a side stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["K1", "K2", "K4", "K5"])
def test_each_kernel_captures_alone_on_gpu(kernel):
    """A one-kernel graph: the static-runtime library launches into the
    capture stream, with its per-launch attribute call and error checks,
    and the replay writes the eager launch's outputs bit for bit."""
    from cpp_cuda_raytracer_dev_torch.accel import traverse as tr
    from cpp_cuda_raytracer_dev_torch.ops.cuda import bin_intersect as k1
    from cpp_cuda_raytracer_dev_torch.ops.cuda import segment_sum as k2
    from cpp_cuda_raytracer_dev_torch.ops.cuda import tile_intersect as k45

    dev = _cuda()
    scene, cam = _port_scene(dev), _camera(dev)
    tris = scene.objects[0].tris
    with torch.no_grad():
        if kernel == "K1":
            rays, b = bin_object(cam.pos, tris, cam.projection(),
                                 P.RenderConfig(**BIN), RES_H, RES_W)

            def fn():
                return k1.bin_intersect(rays, b.geom, b.entry_tri, b.starts,
                                        128)
        elif kernel == "K2":
            rng = np.random.default_rng(0)
            idx = torch.from_numpy(np.sort(rng.integers(0, 5000, 40000))
                                   .astype(np.int32)).to(dev)
            rows = torch.from_numpy(rng.standard_normal(
                (40000, 12)).astype(np.float32)).to(dev)
            order = torch.from_numpy(rng.permutation(40000)).to(dev)

            def fn():
                return (k2.segment_sum(rows, idx, 5000, order=order),)
        else:
            accel = P.ClusterAccel.build(tris, 32, cache=False)
            cfg = P.RenderConfig(method="pallas2", **CLUSTER)
            tiles, _ = tr._tile_rays(cam.ray_directions(), RES_H, RES_W, 8,
                                     32)
            cand, count, _ = tr._cull(cam.pos, tiles, accel, cfg, 24)
            ops = (tiles.transpose(1, 2).contiguous(), cand, count,
                   tr._candidate_boxes(cam.pos, accel, cand, count))
            root = torch.cat([cam.pos, accel.bounds_min.amin(0),
                              accel.bounds_max.amax(0)])

            def fn():
                if kernel == "K4":
                    return k45.tile_intersect_v2(*ops, root, accel.geom9,
                                                 accel.slot_mat)
                return k45.tile_intersect(*ops, cam.pos.contiguous(),
                                          accel.geom9, accel.slot_mat)
        want = [x.clone() for x in fn()]
        graph, out = _graph_of(fn)
        for x in out:
            x.fill_(-7)
        graph.replay()
    torch.cuda.synchronize()
    for x, y in zip(out, want):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("method,dtype", [
    ("bin", torch.float32), ("pallas2", torch.float32),
    ("pallas", torch.float32), ("grid", torch.float32),
    ("brute", torch.float32), ("fixed", torch.float32),
    ("brute", torch.float64), ("fixed", torch.float64)])
def test_replay_is_bitwise_render_on_gpu(method, dtype):
    dev = _cuda()
    scene, cam = _port_scene(dev, dtype=dtype), _camera(dev, dtype=dtype)
    kw = {"bin": BIN, "brute": dict(method="brute", chunk=1024),
          "fixed": dict(method="fixed", chunk=512)}.get(
              method, dict(method=method, **CLUSTER))
    cfg = P.RenderConfig(**kw)
    accel = (None if "leaf_size" not in kw else
             (P.ClusterAccel.build(scene.objects[0].tris,
                                   CLUSTER["leaf_size"], cache=False),))
    first = render_jit(scene, cam, cfg, accel)
    captures = renderer.FRAME_GRAPHS.captures
    for angle in (0.6, 0.7):             # new leaves, the same graph
        scene2 = _port_scene(dev, angle, dtype)
        _assert_bitwise(render_jit(scene2, cam, cfg, accel),
                        P.render(scene2, cam, cfg, accel))
    assert renderer.FRAME_GRAPHS.captures == captures
    _assert_bitwise(first, P.render(scene, cam, cfg, accel))
    assert first.hit_t.dtype == dtype


@pytest.mark.gpu
def test_outputs_survive_the_next_call_on_gpu():
    dev = _cuda()
    scene = _port_scene(dev)
    cfg = P.RenderConfig(**BIN)
    a = render_jit(scene, _camera(dev), cfg)
    kept = {f: getattr(a, f).clone() for f in FIELDS}
    b = render_jit(scene, _camera(dev, (0.3, -0.2, -2.6)), cfg)
    assert not torch.equal(a.hit_t, b.hit_t)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), kept[f]), f


@pytest.mark.gpu
def test_growth_captures_again_and_stays_bitwise_on_gpu():
    dev = _cuda()
    scene = _port_scene(dev)
    cfg = P.RenderConfig(**BIN, tile_h=8)         # a key of its own
    cache = renderer.FRAME_GRAPHS
    regrown, captures = cache.regrown, cache.captures
    for pos in ((0.0, 0.0, -1.6), (0.0, 0.0, -8.0), (0.0, 0.0, -1.6)):
        cam = _camera(dev, pos)
        _assert_bitwise(render_jit(scene, cam, cfg),
                        P.render(scene, cam, cfg))
    assert cache.regrown == regrown + 1
    assert cache.captures == captures + 2


@pytest.mark.gpu
@pytest.mark.parametrize("kw,adam", [(dict(BIN), False),
                                     (dict(method="fixed", chunk=512), False),
                                     (dict(BIN), True)])
def test_compiled_step_is_bitwise_eager_on_gpu(kw, adam):
    """SGD (optax.sgd), and Adam built with capturable=True, whose state
    the compiled step's eager first step creates."""
    dev = _cuda()
    target = P.render(_port_scene(dev), _camera(dev),
                      P.RenderConfig(**kw)).radiance.clone()
    runs = []
    for make in (make_train_step_jit, make_train_step):
        scene, cam = _port_scene(dev, 0.65), _camera(dev).requires_grad_()
        params = {"scene": scene, "camera": cam}
        leaves = [*scene.parameters(), *cam.parameters()]
        opt = (torch.optim.Adam(leaves, lr=1e-3, capturable=True) if adam
               else torch.optim.SGD(leaves, lr=1e-3))
        step = make(opt, P.RenderConfig(**kw))
        losses = [step(params, target) for _ in range(3)]
        runs.append((losses, [p.detach().clone()
                              for p in (*scene.parameters(),
                                        *cam.parameters())]))
    (jl, jp), (el, ep) = runs
    for a, b in zip(jl, el):
        assert torch.equal(a, b)
    for a, b in zip(jp, ep):
        assert torch.equal(a, b)
