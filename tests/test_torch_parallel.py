"""The port's sharded rendering and training (``parallel/``) against the JAX
package's on the same mesh shapes.

The port runs in real processes: a worker script under ``tmp_path`` is
started once per mesh shape, 2 gloo ranks for the rays mesh (2,) and 4 for
the (2, 2) ("rays", "prims") mesh, each with a free port and its own
timeout; every rank writes its outputs to an ``.npz``. JAX runs here on
the conftest's virtual CPU devices: ``make_mesh(2)`` and
``make_mesh(4, prims=2)``. Inputs: a posed, rough sphere (1,799
triangles, numpy seed 0 colours, its triangle list starting at the
equator, ROADMAP F6) at 64x40, so that a band is 20 rows: one whole 16-row
tile and a partial one for the bin path, two and a half 8-row tiles for
"pallas2".

Tolerances, those of the single-device parity tests of each method
(tests/test_torch_render.py, tests/test_torch_cluster.py):
- against JAX: "fixed" and "bin" ids equal on >= 99.9% of pixels and each
  difference an oracle tie (both triangles' t within 1e-5 relative, printed),
  t at rtol 1e-5; "pallas2" ids on >= 99.9% with each difference a near-tie
  (1e-4, ROADMAP F7), t at rtol 1e-4; radiance at rtol 1e-4, atol 1e-5
  where the ids agree;
- against the port's own single-device `render`: "fixed" bit for bit on the
  rays mesh; "bin" and "pallas2" t bitwise, every differing id an oracle tie
  (a band groups its rays into other tiles and blocks, ROADMAP F2);
- the sharded training step's gradients and post-step parameters against
  the single-device step's, per leaf at rtol 1e-5 with atol 1e-5 * max|g|
  (the bands' partial sums add in another order);
- the sharded gradients against ``jax.grad`` through the same function on
  the same mesh shape at rtol 1e-5, atol 1e-5 * max|g| per leaf (XLA on
  the CPU fuses multiply-adds and sums the gather's VJP by a cumsum
  difference, so single small entries differ by up to 0.5% of themselves
  at 2e-6 of their leaf's largest; tests/test_torch_grad.py); JAX's
  ``render_sharded_2d`` has no gradient (its ``pmin`` has no rule), so the
  port's is held against its single-device gradient (ROADMAP F11);
- the compiled sharded paths against the eager ones on the same mesh, on
  every rank, bit for bit: `make_train_step_jit` with a mesh against
  `make_train_step` from twin parameter sets (loss at each of 3 steps,
  gradients, parameters) for the all-leaves and pose/light/camera-only bin
  steps, and for the all-leaves step whose look_at moves before step 2 so
  that band 0 alone outgrows the bucket (every rank regrows once, to the
  same bucket); `render_sharded_jit` against `render_sharded` for "bin"
  and "pallas2"; the raster step with Adam, which runs uncaptured.
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpp_cuda_raytracer_dev_tpu as J
from cpp_cuda_raytracer_dev_tpu.accel import traverse as jtr
from cpp_cuda_raytracer_dev_tpu.ops.intersect import Hit as JHit
from cpp_cuda_raytracer_dev_tpu.ops.quaternion import Pose as JPose
from cpp_cuda_raytracer_dev_tpu.ops.quaternion import from_axis_angle
from cpp_cuda_raytracer_dev_tpu.parallel import mesh as jmesh
from cpp_cuda_raytracer_dev_tpu.parallel import render_pjit as jpj
from cpp_cuda_raytracer_dev_tpu.parallel.collectives import \
    allreduce_nearest_hit as jallreduce
from cpp_cuda_raytracer_dev_torch import RenderConfig
from cpp_cuda_raytracer_dev_torch.ops.intersect import mt_test
from cpp_cuda_raytracer_dev_torch.parallel.render_pjit import (
    render_sharded_2d_bin, shard_accel)
from cpp_cuda_raytracer_dev_torch.utils.convert import (
    camera_from_numpy, cluster_accel_from_numpy, path_dict, scene_from_numpy)
from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES_W, RES_H = 64, 40
LEAF = 32
KW = {"fixed": dict(method="fixed", chunk=256),
      "bin": dict(method="bin", bin_chunk=128),
      "pallas2": dict(method="pallas2", leaf_size=LEAF, tile_h=8, tile_w=32,
                      max_candidates=24)}
ACCEL_FIELDS = ("bounds_min", "bounds_max", "centers", "geom9_t", "slot_mat")
FIELDS = ("image", "radiance", "hit_t", "hit_tri", "hit_obj", "normal",
          "point")
flat = jax.tree_util.tree_flatten_with_path

# The worker: one rank of an SPMD program; rank r writes rank{r}.npz.
_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[1])
    import torch.distributed as dist
    from cpp_cuda_raytracer_dev_torch import RenderConfig, render
    from cpp_cuda_raytracer_dev_torch import render_differentiable
    from cpp_cuda_raytracer_dev_torch.models.renderer import bin_entry_count
    from cpp_cuda_raytracer_dev_torch.ops.intersect import Hit
    from cpp_cuda_raytracer_dev_torch.parallel import mesh as pm
    from cpp_cuda_raytracer_dev_torch.parallel import render_pjit as pj
    from cpp_cuda_raytracer_dev_torch.parallel.collectives import (
        allreduce_nearest_hit)
    from cpp_cuda_raytracer_dev_torch.utils.convert import (
        camera_from_numpy, cluster_accel_from_numpy, params_to_numpy,
        scene_from_numpy)

    port, world, rank, inp, out = sys.argv[2:7]
    world, rank = int(world), int(rank)
    pm.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                              device_type="cpu")
    data = dict(np.load(inp))
    kw = {"fixed": dict(method="fixed", chunk=256),
          "bin": dict(method="bin", bin_chunk=128),
          "pallas2": dict(method="pallas2", leaf_size=32, tile_h=8,
                          tile_w=32, max_candidates=24)}

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in data.items()
                if k.startswith(prefix)}

    def world_(trainable=False):
        scene = scene_from_numpy(sub("scene."), "cpu")
        cam = camera_from_numpy(sub("cam."), "cpu")
        if trainable:
            cam.requires_grad_()
        return scene, cam

    accel = (cluster_accel_from_numpy(sub("accel."), "cpu"),)
    weight = torch.tensor(data["weight"])
    res = {}

    def keep(prefix, o):
        for f in ("image", "radiance", "hit_t", "hit_tri", "hit_obj",
                  "normal", "point"):
            res[f"{prefix}.{f}"] = getattr(o, f).detach().numpy()

    def grads(prefix, scene, cam):
        for part, mod in (("scene.", scene), ("cam.", cam)):
            for k, v in params_to_numpy(mod, grad=True).items():
                res[f"{prefix}.{part}{k}"] = v

    def params(prefix, scene, cam):
        for part, mod in (("scene.", scene), ("cam.", cam)):
            for k, v in params_to_numpy(mod).items():
                res[f"{prefix}.{part}{k}"] = v

    def step(prefix, mesh):
        scene, cam = world_(trainable=True)
        opt = torch.optim.SGD([*scene.parameters(), *cam.parameters()],
                              lr=1e-3)
        loss = pj.make_train_step(opt, RenderConfig(**kw["bin"]), mesh)(
            {"scene": scene, "camera": cam}, torch.tensor(data["target"]))
        res[prefix + ".loss"] = loss.numpy()
        grads(prefix + ".grad", scene, cam)
        params(prefix + ".param", scene, cam)

    # make_train_step_jit against make_train_step from twin parameter sets,
    # 3 steps each: the all-leaves and the pose/light/camera-only bin steps,
    # and the all-leaves step with look_at moved before step 2 so that band
    # 0 alone outgrows the bucket; render_sharded_jit against
    # render_sharded; raster with Adam, which the compiled step runs
    # uncaptured
    def compiled(mesh):
        cfg = RenderConfig(**kw["bin"])
        tgt = torch.tensor(data["target"])
        for kind in ("all", "pose", "regrow"):
            for name, make in (("jit", pj.make_train_step_jit),
                               ("eager", pj.make_train_step)):
                scene, cam = world_(trainable=True)
                ps = [*scene.parameters(), *cam.parameters()]
                if kind == "pose":
                    scene.objects[0].tris.requires_grad_(False)
                    cam.requires_grad_(False)
                    cam.pos.requires_grad_(True)
                    ps = [*scene.objects[0].pose.parameters(),
                          *scene.phong.parameters(), cam.pos]
                step = make(torch.optim.SGD(ps, lr=1e-3), cfg, mesh)
                p = f"jit.{kind}.{name}"
                for i in range(3):
                    if kind == "regrow" and i == 1:
                        with torch.no_grad():
                            cam.look_at.copy_(torch.tensor([0.0, -0.4, 0.0]))
                        res[f"{p}.band1"] = np.array(bin_entry_count(
                            scene, cam, cfg, *pj._band(cam, mesh)))
                    res[f"{p}.loss{i}"] = step({"scene": scene,
                                                "camera": cam}, tgt).numpy()
                    if name == "jit":
                        res[f"{p}.bucket{i}"] = np.array(
                            list(step.graphs().buckets.values()))
                grads(p + ".grad", scene, cam)
                params(p + ".param", scene, cam)
                if name == "jit":
                    res[p + ".regrown"] = np.array(step.graphs().regrown)
        for name in ("bin", "pallas2"):
            c = RenderConfig(**kw[name])
            a = accel if name == "pallas2" else None
            scene, cam = world_()
            keep(f"jit.frame.{name}", pj.render_sharded_jit(scene, cam, c,
                                                            mesh, a))
            with torch.no_grad():
                keep(f"eager.frame.{name}", pj.render_sharded(scene, cam, c,
                                                              mesh, a))
        res["jit.frame.buckets"] = np.array(
            list(pj.sharded_graphs(mesh).buckets.values()))
        for name, make in (("jit", pj.make_train_step_jit),
                           ("eager", pj.make_train_step)):
            scene, cam = world_(trainable=True)
            step = make(torch.optim.Adam([*scene.parameters(),
                                          *cam.parameters()], lr=1e-3),
                        RenderConfig(method="raster"), mesh)
            res[f"raster.{name}.loss"] = step({"scene": scene,
                                               "camera": cam}, tgt).numpy()
            res[f"raster.{name}.step"] = np.array(step.__qualname__)
            params(f"raster.{name}.param", scene, cam)

    def sharded_grad(prefix, fn, *args):
        scene, cam = world_(trainable=True)
        (fn(scene, cam, *args).radiance * weight).mean().backward()
        pj.allreduce_gradients([*scene.parameters(), *cam.parameters()],
                               mesh)
        grads(prefix, scene, cam)

    if world == 2:
        mesh = pm.make_mesh(2)
        res["band"] = np.array(pm.ray_band(mesh, 40))
        res["placements"] = np.array([str(pm.ray_sharding(mesh)),
                                      str(pm.replicated(mesh))])
        for name in ("fixed", "bin", "pallas2"):
            cfg = RenderConfig(**kw[name])
            a = accel if name == "pallas2" else None
            scene, cam = world_()
            with torch.inference_mode():
                keep(f"sharded.{name}", pj.render_sharded(scene, cam, cfg,
                                                          mesh, a))
                keep(f"single.{name}", render(scene, cam, cfg, a))
        sharded_grad("grad.sharded.fixed", pj.render_sharded,
                     RenderConfig(**kw["fixed"]), mesh)
        step("step.sharded", mesh)
        step("step.single", None)
        compiled(mesh)
        for bad in (dict(n_devices=4), dict(prims=2, prims_axis=False)):
            try:
                pm.make_mesh(**bad)
                res["refused." + ",".join(bad)] = np.array(False)
            except ValueError:
                res["refused." + ",".join(bad)] = np.array(True)
    else:
        # the nearest-hit combine over all 4 ranks, rank r holding shard r
        t = np.full(8, 10.0 + rank, np.float32)
        tri = (np.arange(8, dtype=np.int32) + 100 + 1000 * rank)
        if rank == 1:
            t[3] = 0.5
        t[5] = 2.0                    # an exact tie on every shard
        t[7], tri[7] = 400.0, -1      # every shard misses ray 7
        h = allreduce_nearest_hit(
            Hit(t=torch.tensor(t), tri=torch.tensor(tri),
                obj=torch.full((8,), rank, dtype=torch.int32)),
            dist.group.WORLD)
        res.update({"combine.t": h.t.numpy(), "combine.tri": h.tri.numpy(),
                    "combine.obj": h.obj.numpy()})
        mesh = pm.make_mesh(4, prims=2)
        res["coord"] = np.array([pm.axis_index(mesh, pm.RAYS_AXIS),
                                 pm.axis_index(mesh, pm.PRIMS_AXIS)])
        with torch.inference_mode():
            scene, cam = world_()
            keep("sharded.2d", pj.render_sharded_2d(
                scene, cam, RenderConfig(**kw["fixed"]), mesh))
            keep("sharded.2d_bin", pj.render_sharded_2d_bin(
                scene, cam, RenderConfig(**kw["bin"]), mesh))
            keep("sharded.2d_accel", pj.render_sharded_2d_accel(
                scene, cam, RenderConfig(**kw["pallas2"]), mesh, accel))
        sharded_grad("grad.sharded.2d_bin", pj.render_sharded_2d_bin,
                     RenderConfig(**kw["bin"]), mesh)
        sharded_grad("grad.sharded.2d", pj.render_sharded_2d,
                     RenderConfig(**kw["fixed"]), mesh)
        scene, cam = world_(trainable=True)
        (render_differentiable(scene, cam, RenderConfig(**kw["fixed"]))
         .radiance * weight).mean().backward()
        grads("grad.single.fixed", scene, cam)
        step("step.sharded", mesh)
        step("step.single", None)
        compiled(mesh)
    np.savez(f"{out}/rank{rank}.npz", **res)
    dist.destroy_process_group()
    print(f"rank {rank}: OK")
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(tmp, world: int, inp: str):
    out = tmp / f"world{world}"
    out.mkdir()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), REPO, str(port), str(world),
         str(r), inp, str(out)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    return out, procs


def _join(out, procs, timeout=180):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(len(procs))]


def _jax_camera():
    return J.Camera.create(RES_W, RES_H, pos=[0.1, 0.3, -3.0],
                           look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                           film_h=0.024, focal=0.055)


def _jax_world():
    # 1,799 triangles: the second of two prim ranges ends in a zero triangle
    tv = uv_sphere(30, 30, roughness=0.03)[:-1]
    tv = np.roll(tv, -tv.shape[0] // 2, axis=0)
    color = np.random.default_rng(0).uniform(0.1, 1.0, (tv.shape[0], 3))
    pose = JPose(quat=from_axis_angle(jnp.array([0.3, 1.0, 0.1]), 0.6),
                 translation=jnp.array([0.15, -0.1, 0.2]))
    jtris = J.Triangles.from_vertices(tv, color.astype(np.float32))
    jscene = J.Scene.create([J.SceneObject.create(jtris, pose)])
    jcam = _jax_camera()
    jaccel = jtr.ClusterAccel.build(jtris, leaf_size=LEAF, cache=False)
    return jscene, jcam, jaccel


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns (started first, so that they run while JAX computes
    its side), the JAX outputs and the shared inputs."""
    tmp = tmp_path_factory.mktemp("parallel")
    jscene, jcam, jaccel = _jax_world()
    weight = np.linspace(0.3, 1.7, RES_H * RES_W * 3,
                         dtype=np.float32).reshape(RES_H, RES_W, 3)
    target = np.asarray(J.render(jscene, jcam, J.RenderConfig(
        **KW["fixed"])).radiance)[::-1].copy()
    acc = {f: np.asarray(getattr(jaccel, f)) for f in ACCEL_FIELDS}
    inp = {**{"scene." + k: v for k, v in path_dict(flat(jscene)[0]).items()},
           **{"cam." + k: v for k, v in path_dict(flat(jcam)[0]).items()},
           "cam.res_w": np.int64(RES_W), "cam.res_h": np.int64(RES_H),
           **{"accel." + k: v for k, v in acc.items()},
           "accel.leaf_size": np.int64(LEAF), "weight": weight,
           "target": target}
    np.savez(tmp / "inputs.npz", **inp)
    (tmp / "worker.py").write_text(_WORKER)
    spawned = [_spawn(tmp, w, str(tmp / "inputs.npz")) for w in (2, 4)]
    try:
        jx = _jax_outputs(jscene, jcam, jaccel, weight)
    except BaseException:
        for _, procs in spawned:
            for p in procs:
                p.kill()
        raise
    w2, w4 = (_join(*s) for s in spawned)
    pscene = scene_from_numpy(path_dict(flat(jscene)[0]), "cpu")
    pcam = camera_from_numpy({**path_dict(flat(jcam)[0]), "res_w": RES_W,
                              "res_h": RES_H}, "cpu")
    obj = pscene.objects[0]
    with torch.no_grad():
        rays = (obj.pose.inv_apply(pcam.pos),
                obj.pose.inv_apply_vec(pcam.ray_directions()))
    paccel = cluster_accel_from_numpy({**acc, "leaf_size": LEAF}, "cpu")
    return dict(w2=w2, w4=w4, jax=jx, pscene=pscene, rays=rays,
                jaccel=jaccel, paccel=paccel)


def _jax_outputs(jscene, jcam, jaccel, weight):
    """JAX's side, each function jitted (eager ``shard_map`` dispatches op
    by op and takes minutes)."""
    m2 = jmesh.make_mesh(2)
    m22 = jmesh.make_mesh(4, prims=2)
    out = {}

    def keep(name, fn, *args):
        o = jax.jit(lambda s, c: fn(s, c, *args))(jscene, jcam)
        out.update({f"{name}.{f}": np.asarray(getattr(o, f)) for f in FIELDS})
    for name in ("fixed", "bin", "pallas2"):
        keep(name, jpj.render_sharded, J.RenderConfig(**KW[name]), m2,
             (jaccel,) if name == "pallas2" else None)
    keep("2d", jpj.render_sharded_2d, J.RenderConfig(**KW["fixed"]), m22)
    keep("2d_bin", jpj.render_sharded_2d_bin, J.RenderConfig(**KW["bin"]),
         m22)
    keep("2d_accel", jpj.render_sharded_2d_accel,
         J.RenderConfig(**KW["pallas2"]), m22, (jaccel,))
    w = jnp.asarray(weight)

    def grads(name, fn, *args):
        def loss(s, c):
            return jnp.mean(fn(s, c, *args).radiance * w)
        gs, gc = jax.jit(jax.grad(loss, argnums=(0, 1)))(jscene, jcam)
        out.update({f"{name}.scene.{k}": v
                    for k, v in path_dict(flat(gs)[0]).items()})
        out.update({f"{name}.cam.{k}": v
                    for k, v in path_dict(flat(gc)[0]).items()})
    grads("grad.fixed", jpj.render_sharded, J.RenderConfig(**KW["fixed"]),
          m2)
    grads("grad.2d_bin", jpj.render_sharded_2d_bin,
          J.RenderConfig(**KW["bin"]), m22)
    return out


def _assert_ties(name, tri_a, tri_b, runs, rel):
    """Every pixel where the ids differ is a tie by the oracle: both
    triangles hit, their t within ``rel`` of each other. Prints each."""
    tri_a, tri_b = tri_a.reshape(-1), tri_b.reshape(-1)
    differ = np.nonzero(tri_a != tri_b)[0]
    o, d = runs["rays"]
    tris = runs["pscene"].objects[0].tris
    for i in differ:
        ts = []
        for tri in (tri_a[i], tri_b[i]):
            assert tri >= 0, f"{name} pixel {i}: hit against miss"
            t, _, _, ok = mt_test(o, d[i], tris.p1[tri], tris.e1[tri],
                                  tris.e2[tri])
            assert bool(ok), f"{name} pixel {i}: triangle {tri} not hit"
            ts.append(float(t))
        print(f"{name} pixel {i}: triangles {tri_a[i]} / {tri_b[i]}, oracle "
              f"t {ts[0]!r} / {ts[1]!r}")
        assert abs(ts[0] - ts[1]) <= rel * ts[1], (name, i, ts)


def _assert_matches_jax(name, got, want, runs, tie_rel, t_rtol):
    ptri, jtri = got["hit_tri"], want["hit_tri"]
    assert ptri.shape == jtri.shape == (RES_H, RES_W)
    assert (ptri >= 0).mean() > 0.5
    same = ptri == jtri
    assert same.mean() >= 0.999, (name, same.mean())
    _assert_ties(name, ptri, jtri, runs, tie_rel)
    np.testing.assert_allclose(got["hit_t"][same], want["hit_t"][same],
                               rtol=t_rtol)
    np.testing.assert_array_equal(got["hit_obj"], want["hit_obj"])
    np.testing.assert_allclose(got["radiance"][same], want["radiance"][same],
                               rtol=1e-4, atol=1e-5)
    assert np.abs(got["image"].astype(int)
                  - want["image"].astype(int))[same].max() <= 1


def _sub(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _assert_leaves_close(got, want, rtol, what):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[k], w, rtol=rtol,
                                   atol=1e-5 * np.abs(w).max() + 1e-30,
                                   err_msg=f"{what}: {k}")


def test_mesh_bands_and_refusals(runs):
    bands = [r["band"].tolist() for r in runs["w2"]]
    assert bands == [[0, 20], [20, 20]]
    assert runs["w2"][0]["placements"].tolist() == ["[Shard(dim=0)]",
                                                    "[Replicate()]"]
    assert sorted(tuple(r["coord"]) for r in runs["w4"]) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for key in ("refused.n_devices", "refused.prims,prims_axis"):
        assert all(bool(r[key]) for r in runs["w2"]), key


def test_allreduce_nearest_hit(runs):
    """The case of tests/test_parallel.py (4 shards, 8 rays) plus an exact
    tie on every shard, against JAX's combine on 4 virtual devices."""
    from functools import partial

    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as Pspec

    m = jmesh.make_mesh(4, prims=4)
    t = np.stack([np.full(8, 10.0 + i, np.float32) for i in range(4)])
    t[1, 3] = 0.5
    t[:, 5] = 2.0
    tri = (np.arange(8, dtype=np.int32)[None] + 100
           + 1000 * np.arange(4, dtype=np.int32)[:, None])
    t[:, 7], tri[:, 7] = 400.0, -1
    obj = np.repeat(np.arange(4, dtype=np.int32)[:, None], 8, axis=1)

    @partial(shard_map, mesh=m, in_specs=Pspec(jmesh.PRIMS_AXIS, None),
             out_specs=Pspec(jmesh.PRIMS_AXIS, None))
    def combine(t_, tri_, obj_):
        h = jallreduce(JHit(t=t_[0], tri=tri_[0], obj=obj_[0]),
                       jmesh.PRIMS_AXIS)
        return h.t[None], h.tri[None], h.obj[None]

    jt, jtri, jobj = (np.asarray(x)[0] for x in combine(
        jnp.asarray(t), jnp.asarray(tri), jnp.asarray(obj)))
    for r in runs["w4"]:
        np.testing.assert_array_equal(r["combine.t"], jt)
        np.testing.assert_array_equal(r["combine.tri"], jtri)
        np.testing.assert_array_equal(r["combine.obj"], jobj)
    got = runs["w4"][0]
    assert got["combine.t"][3] == 0.5 and got["combine.tri"][3] == 1103
    assert got["combine.tri"][5] == 105 and got["combine.obj"][5] == 0
    assert got["combine.tri"][7] == -1 and got["combine.obj"][7] == -1
    assert got["combine.t"][7] == 400.0


def test_every_rank_gets_the_whole_frame(runs):
    for world in ("w2", "w4"):
        first = runs[world][0]
        for r in runs[world][1:]:
            for k, v in first.items():
                if k.startswith("sharded."):
                    np.testing.assert_array_equal(r[k], v, err_msg=k)


@pytest.mark.parametrize("name", ["fixed", "bin", "pallas2"])
def test_render_sharded_matches_jax(runs, name):
    got = _sub(runs["w2"][0], f"sharded.{name}.")
    want = _sub(runs["jax"], f"{name}.")
    tie_rel, t_rtol = (1e-4, 1e-4) if name == "pallas2" else (1e-5, 1e-5)
    _assert_matches_jax(name, got, want, runs, tie_rel, t_rtol)


@pytest.mark.parametrize("name", ["fixed", "bin", "pallas2"])
def test_render_sharded_matches_single_device(runs, name):
    got = _sub(runs["w2"][0], f"sharded.{name}.")
    want = _sub(runs["w2"][0], f"single.{name}.")
    if name == "fixed":
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        return
    np.testing.assert_array_equal(got["hit_t"], want["hit_t"])
    _assert_ties(name, got["hit_tri"], want["hit_tri"], runs, 1e-5)


@pytest.mark.parametrize("name", ["2d", "2d_bin", "2d_accel"])
def test_render_sharded_2d_matches_jax(runs, name):
    got = _sub(runs["w4"][0], f"sharded.{name}.")
    want = _sub(runs["jax"], f"{name}.")
    tie_rel, t_rtol = ((1e-4, 1e-4) if name == "2d_accel" else (1e-5, 1e-5))
    _assert_matches_jax(name, got, want, runs, tie_rel, t_rtol)
    # and against the port's single-device frame of the same method
    single = _sub(runs["w2"][0], "single." + {
        "2d": "fixed", "2d_bin": "bin", "2d_accel": "pallas2"}[name] + ".")
    same = got["hit_tri"] == single["hit_tri"]
    assert same.mean() >= 0.999
    _assert_ties(name + " vs single", got["hit_tri"], single["hit_tri"],
                 runs, tie_rel)


def test_shard_accel_matches_jax(runs):
    for nprims in (2, 3):
        j = jpj.shard_accel(runs["jaccel"], nprims)
        p = shard_accel(runs["paccel"], nprims)
        assert p.leaf_size == j.leaf_size == LEAF
        for pf, jf in (("bounds_min", "bounds_min"),
                       ("bounds_max", "bounds_max"), ("centers", "centers"),
                       ("geom9", "geom9_t"), ("slot_mat", "slot_mat")):
            a, b = getattr(p, pf).numpy(), np.asarray(getattr(j, jf))
            assert a.shape == b.shape and a.dtype == b.dtype, pf
            np.testing.assert_array_equal(a, b, err_msg=pf)


@pytest.mark.parametrize("world", ["w2", "w4"])
def test_sharded_train_step_matches_single_device(runs, world):
    for r in runs[world]:
        np.testing.assert_allclose(r["step.sharded.loss"],
                                   r["step.single.loss"], rtol=1e-5)
        for part in ("grad", "param"):
            _assert_leaves_close(_sub(r, f"step.sharded.{part}."),
                                 _sub(r, f"step.single.{part}."), 1e-5,
                                 f"{world} {part}")
    g = _sub(runs[world][0], "step.sharded.grad.")
    assert max(np.abs(v).max() for k, v in g.items() if ".tris." in k) > 0


@pytest.mark.parametrize("name,world", [("fixed", "w2"), ("2d_bin", "w4")])
def test_sharded_gradients_match_jax(runs, name, world):
    got = _sub(runs[world][0], f"grad.sharded.{name}.")
    want = _sub(runs["jax"], f"grad.{name}.")
    _assert_leaves_close(got, want, 1e-5, name)


def test_render_sharded_2d_gradient_matches_single_device(runs):
    r = runs["w4"][0]
    _assert_leaves_close(_sub(r, "grad.sharded.2d."),
                         _sub(r, "grad.single.fixed."), 1e-5, "2d")


def _compiled_against_eager(r, prefix):
    """Every value the worker kept of the compiled run under ``prefix`` (a
    loss a step, the gradients, the parameters) bitwise the eager twin's."""
    got = _sub(r, prefix + ".jit.")
    got = {k: v for k, v in got.items()
           if not k.startswith(("bucket", "regrown", "band1", "step"))}
    want = _sub(r, prefix + ".eager.")
    assert got and set(got) <= set(want), prefix
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=f"{prefix} {k}")


@pytest.mark.parametrize("kind", ["all", "pose", "regrow"])
@pytest.mark.parametrize("world", ["w2", "w4"])
def test_compiled_sharded_step_is_bitwise_the_eager_step(runs, world, kind):
    """make_train_step_jit with a mesh: 3 steps bitwise make_train_step's
    in loss, gradients and parameters, for the all-leaves and the
    pose/light/camera-only bin steps and the all-leaves step that regrows
    at step 2."""
    for r in runs[world]:
        _compiled_against_eager(r, f"jit.{kind}")
        assert sum(f"jit.{kind}.jit.loss{i}" in r for i in range(3)) == 3
    g = _sub(runs[world][0], f"jit.{kind}.jit.grad.")
    trained = [k for k, v in g.items() if np.abs(v).max() > 0]
    assert any(".tris." in k for k in trained) == (kind != "pose"), trained
    assert trained


@pytest.mark.parametrize("world", ["w2", "w4"])
def test_compiled_sharded_step_regrows_in_lockstep(runs, world):
    """look_at moved before step 2: band 0's live count outgrows the
    agreed bucket, band 1's does not, and every rank regrows at step 2 to
    the same bucket (each rank's growth is agreed over the mesh)."""
    rs = runs[world]
    first = int(rs[0]["jit.regrow.jit.bucket0"][0])
    bands = {int(r["jit.regrow.jit.band1"]) for r in rs}
    assert max(bands) > first >= min(bands), (bands, first)
    for r in rs:
        assert [r[f"jit.regrow.jit.bucket{i}"].tolist() for i in range(3)] \
            == [[first], [2 * first], [2 * first]]
        assert int(r["jit.regrow.jit.regrown"]) == 1
        for kind in ("all", "pose"):
            assert int(r[f"jit.{kind}.jit.regrown"]) == 0
            assert r[f"jit.{kind}.jit.bucket2"].tolist() == [first]


@pytest.mark.parametrize("name", ["bin", "pallas2"])
@pytest.mark.parametrize("world", ["w2", "w4"])
def test_render_sharded_jit_is_bitwise_render_sharded(runs, world, name):
    for r in runs[world]:
        got = _sub(r, f"jit.frame.{name}.")
        want = _sub(r, f"eager.frame.{name}.")
        assert sorted(got) == sorted(FIELDS)
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        assert (got["hit_tri"] >= 0).mean() > 0.5
        assert r["jit.frame.buckets"].tolist() == \
            runs[world][0]["jit.frame.buckets"].tolist()


@pytest.mark.parametrize("world", ["w2", "w4"])
def test_compiled_sharded_raster_step_is_the_eager_step(runs, world):
    """Raster is not captured: make_train_step_jit with a mesh returns
    make_train_step's step for any optimizer (Adam here), bitwise."""
    for r in runs[world]:
        assert str(r["raster.jit.step"]) == str(r["raster.eager.step"])
        assert float(r["raster.jit.loss"]) > 0
        _compiled_against_eager(r, "raster")


def test_render_sharded_2d_bin_refuses_with_stats():
    with pytest.raises(ValueError, match="with_stats"):
        render_sharded_2d_bin(None, None, RenderConfig(
            method="bin", with_stats=True), None)


def test_padding_triangles_are_never_hit(runs):
    """A prim range padded with zero triangles: the bin prepass gives a zero
    triangle an entry where its point (the object origin) projects on
    screen, and K1's determinant test rejects it; no hit id lies in the
    padding."""
    from cpp_cuda_raytracer_dev_torch.accel.traverse import (
        bin_object, intersect_binned)
    from cpp_cuda_raytracer_dev_torch.parallel.render_pjit import _shard_tris

    o, d = runs["rays"]
    tris = runs["pscene"].objects[0].tris
    sub, chunk = _shard_tris(tris, 1, 2)
    n_real = tris.p1x.shape[0] - chunk
    assert chunk - n_real == 1
    cam = camera_from_numpy({**path_dict(flat(_jax_camera())[0]),
                             "res_w": RES_W, "res_h": RES_H}, "cpu")
    proj = cam.projection().transformed(runs["pscene"].objects[0].pose)
    cfg = RenderConfig(**KW["bin"])
    with torch.no_grad():
        _, binned = bin_object(o, sub, proj, cfg, RES_H, RES_W)
        hit = intersect_binned(o, d, sub, proj, cfg, RES_H, RES_W)
    pad_entries = int((binned.entry_tri >= n_real).sum())
    print(f"entries of the padding triangle: {pad_entries}")
    assert pad_entries <= 4          # the point's bbox, +-0.5 px
    assert int(hit.tri.max()) < n_real and (hit.tri >= 0).any()
