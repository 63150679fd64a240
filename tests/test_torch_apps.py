"""The port's entry points and their modules against the JAX package's, on
the CPU: ``io/ply.py``, ``utils/image.py``, ``models/animation.py`` with the
quaternion repairs, the KD path (``KDTables``, ``kd_intersect``),
``utils/debug.py``, and ``apps/render_cli.py`` / ``apps/animate.py`` run
with ``--device cpu`` on a small PLY written here.

Tolerances: PLY arrays, image bytes and the HUD text equal; key-script
poses within 1e-6 (XLA on the CPU contracts multiply-adds into FMAs,
PyTorch rounds each operation); KD hit ids equal and t within rtol 2e-6;
rendered PNGs within one level per channel of the JAX package's image of
the same scene, camera and method.
"""

import io
import struct
import zlib

import numpy as np
import pytest
import torch

import cpp_cuda_raytracer_dev_torch as P
from cpp_cuda_raytracer_dev_torch.accel.kd_build import build_kd
from cpp_cuda_raytracer_dev_torch.accel.traverse import KDTables, kd_intersect
from cpp_cuda_raytracer_dev_torch.apps import animate, render_cli
from cpp_cuda_raytracer_dev_torch.io import ply
from cpp_cuda_raytracer_dev_torch.models import animation
from cpp_cuda_raytracer_dev_torch.utils import image
from cpp_cuda_raytracer_dev_torch.utils import profiling
from cpp_cuda_raytracer_dev_torch.utils.debug import checked_render, debug_nans
from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

RES = (64, 48)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small CPU cases run faster on one thread than on a pool that
    shares the cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ply_ascii(verts, faces, props=True):
    head = ["ply", "format ascii 1.0", f"element vertex {len(verts)}"]
    if props:
        head += ["property float x", "property float y", "property float z",
                 "property float confidence"]
    head += [f"element face {len(faces)}"]
    if props:
        head += ["property list uchar int vertex_indices"]
    body = [" ".join(f"{x:.6f}" for x in v) + " 0.5" for v in verts]
    body += [" ".join(str(i) for i in (len(f), *f)) for f in faces]
    return ("\n".join(head + ["end_header"] + body) + "\n").encode()


def _ply_binary(verts, faces):
    head = "\n".join([
        "ply", "format binary_little_endian 1.0",
        f"element vertex {len(verts)}", "property float x",
        "property float y", "property float z",
        f"element face {len(faces)}",
        "property list uchar int vertex_indices", "end_header"]) + "\n"
    body = np.asarray(verts, "<f4").tobytes()
    for f in faces:
        body += struct.pack("<B", len(f)) + np.asarray(f, "<i4").tobytes()
    return head.encode() + body


def _ply_tester(verts, faces):
    lines = [str(len(verts)), str(len(faces))]
    lines += [" ".join(f"{x:.6f}" for x in (*v, 0.0, 0.0, 1.0))
              for v in verts]
    lines += [" ".join(str(i) for i in (len(f), *f)) for f in faces]
    return ("\n".join(lines) + "\n").encode()


def _grid_mesh(quad: bool):
    rng = np.random.default_rng(0)
    verts = rng.standard_normal((9, 3)).astype(np.float32)
    faces = [(0, 1, 2), (2, 3, 4), (4, 5, 6), (6, 7, 8), (8, 0, 3)]
    if quad:
        faces += [(1, 3, 5, 7)]
    return verts, faces


@pytest.mark.parametrize("kind", ["ascii", "ascii_no_props", "binary",
                                  "binary_quad", "ascii_quad", "tester"])
def test_ply_matches_jax(tmp_path, kind):
    from cpp_cuda_raytracer_dev_tpu.io import ply as jply
    verts, faces = _grid_mesh(quad=kind.endswith("quad") or kind == "tester")
    data = {"ascii": lambda: _ply_ascii(verts, faces),
            "ascii_quad": lambda: _ply_ascii(verts, faces),
            "ascii_no_props": lambda: _ply_ascii(verts, faces, props=False),
            "binary": lambda: _ply_binary(verts, faces),
            "binary_quad": lambda: _ply_binary(verts, faces),
            "tester": lambda: _ply_tester(verts, faces)}[kind]()
    path = tmp_path / "m.ply"
    path.write_bytes(data)
    got, want = ply.load_mesh(path), jply.load_mesh(path)
    n_tri = len(faces) + (1 if "quad" in kind or kind == "tester" else 0)
    assert got.num_triangles == want.num_triangles == n_tri
    for f in ("vertices", "tri_vertices", "aabb_min", "aabb_max"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    if kind == "binary":
        assert np.array_equal(ply.read_ply(path).tri_vertices,
                              jply.read_ply(path).tri_vertices)


def test_image_files_and_hud_match_jax(tmp_path):
    from cpp_cuda_raytracer_dev_tpu.utils import image as jimage
    img = np.random.default_rng(1).integers(0, 256, (5, 7, 3), np.uint8)
    for fn in ("write_png", "write_ppm"):
        getattr(image, fn)(str(tmp_path / "a"), img)
        getattr(jimage, fn)(str(tmp_path / "b"), img)
        assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    assert np.array_equal(image.to_display(img), jimage.to_display(img))
    streams = io.StringIO(), io.StringIO()
    for hud_cls, s in zip((image.Hud, jimage.Hud), streams):
        hud = hud_cls(s)
        hud.update(["Resolution: 4 x 2", "Key: W"])
        hud.update(["Resolution: 4 x 2", "Key: R", "third"])
    assert streams[0].getvalue() == streams[1].getvalue()


def _scene_pair(tv, second: bool):
    import jax.numpy as jnp

    import cpp_cuda_raytracer_dev_tpu as J
    from cpp_cuda_raytracer_dev_tpu.ops.quaternion import Pose as JPose
    from cpp_cuda_raytracer_dev_tpu.ops.quaternion import \
        from_axis_angle as jfaa
    from cpp_cuda_raytracer_dev_torch.ops.quaternion import from_axis_angle
    jt = J.Triangles.from_vertices(tv)
    pt = P.Triangles.from_vertices(tv, device="cpu")
    jobj, pobj = [J.SceneObject.create(jt)], [P.SceneObject(pt)]
    if second:
        q, tr = [0.0, 1.0, 0.0], [0.6, 0.0, 0.2]
        jobj.append(J.SceneObject.create(jt, JPose(
            quat=jfaa(jnp.array(q), 0.8), translation=jnp.asarray(
                tr, jnp.float32))))
        pobj.append(P.SceneObject(pt, P.Pose(
            from_axis_angle(q, 0.8, device="cpu"), torch.tensor(tr))))
    return J.Scene.create(jobj), P.Scene(pobj)


def test_key_script_poses_match_jax():
    """Every one of the demo script's 170 ticks on a two-object scene: the
    moved object's quaternion and translation within 1e-6 of JAX's; the
    other object and every Triangles module untouched."""
    import cpp_cuda_raytracer_dev_tpu as J
    from cpp_cuda_raytracer_dev_tpu.models import animation as janim
    tv = uv_sphere(8, 8)
    jscene, pscene = _scene_pair(tv, second=True)
    kw = dict(pos=[0.2, 0.3, -2.5], look_at=[0.0, 0.1, 0.0], up=[0, 1, 0],
              film_h=0.024, focal=0.035)
    jcam = J.Camera.create(32, 16, **kw)
    pcam = P.Camera.create(32, 16, device="cpu", **kw)
    script = animation.demo_script()
    assert script == [animation.KeyEvent(e.key, e.ticks)
                      for e in janim.demo_script()]
    jposes = [(np.asarray(s.objects[0].pose.quat),
               np.asarray(s.objects[0].pose.translation))
              for _, _, s in janim.run_script(jscene, jcam,
                                              janim.demo_script())]
    ticks = list(animation.run_script(pscene, pcam, script))
    assert len(ticks) == len(jposes) == 170
    for (tick, key, s), (jq, jt) in zip(ticks, jposes):
        pose = s.objects[0].pose
        np.testing.assert_allclose(pose.quat.detach().numpy(), jq, atol=1e-6,
                                   err_msg=f"tick {tick} {key}")
        np.testing.assert_allclose(pose.translation.detach().numpy(), jt,
                                   atol=1e-6, err_msg=f"tick {tick} {key}")
        assert s.objects[1].pose is pscene.objects[1].pose
        assert all(o.tris is pscene.objects[0].tris for o in s.objects)
    # one tick of a rotation key moves the object's centroid not at all
    p0 = pscene.objects[0].pose
    after = animation.apply_key(pscene, pcam, "R").objects[0].pose
    c = pscene.objects[0].tris.centroid()
    assert torch.allclose(after.apply(c), p0.apply(c), atol=1e-6)


def _kd_case():
    tv = uv_sphere(16, 16, roughness=0.03)
    amin, amax = tv.min(1), tv.max(1)
    tree = build_kd(amin, amax, min_node_size=6)
    o = np.array([0.1, 0.4, -2.6], np.float32)
    gx, gy = np.meshgrid(np.linspace(-1.3, 1.3, 24),
                         np.linspace(-1.3, 1.3, 20))
    tgt = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], -1)
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return tv, tree, o, d


def test_kd_intersect_matches_jax():
    """The same numpy KD tree through both packages' traversals: ids equal,
    t within rtol 2e-6; runs of rays (ray_chunk) change nothing."""
    import jax.numpy as jnp

    import cpp_cuda_raytracer_dev_tpu as J
    from cpp_cuda_raytracer_dev_tpu.accel import traverse as jtr
    tv, tree, o, d = _kd_case()
    jtab = jtr.KDTables.from_tree(tree, J.Triangles.from_vertices(tv))
    jh = jtr.kd_intersect(jnp.asarray(o), jnp.asarray(d), jtab, ray_chunk=0)
    tab = KDTables.from_tree(tree, P.Triangles.from_vertices(tv, device="cpu"))
    assert tab.max_leaf == int(tree.leaf_count.max()) <= 6
    h = kd_intersect(torch.tensor(o), torch.tensor(d), tab, ray_chunk=0)
    jtri = np.asarray(jh.tri)
    assert (jtri >= 0).mean() > 0.5 and (jtri < 0).any()
    np.testing.assert_array_equal(h.tri.numpy(), jtri)
    hit = jtri >= 0
    np.testing.assert_allclose(h.t.numpy()[hit], np.asarray(jh.t)[hit],
                               rtol=2e-6)
    for chunk in (64, 100):
        hc = kd_intersect(torch.tensor(o), torch.tensor(d), tab,
                          ray_chunk=chunk)
        assert torch.equal(hc.t, h.t) and torch.equal(hc.tri, h.tri)


def _read_png(path) -> np.ndarray:
    """(H, W, 3) uint8 of a PNG that `write_png` wrote (filter 0 rows)."""
    data = path.read_bytes()
    pos, idat, w = 8, b"", 0
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


@pytest.fixture(scope="module")
def mesh_path(tmp_path_factory):
    tv = uv_sphere(16, 16, roughness=0.03)
    verts = tv.reshape(-1, 3)
    # faces (p2, p3, p1): the reader's rewind to (p3, p1, p2) gives back
    # the triangles as generated
    faces = [(3 * i + 1, 3 * i + 2, 3 * i) for i in range(tv.shape[0])]
    path = tmp_path_factory.mktemp("mesh") / "sphere.ply"
    path.write_bytes(_ply_binary(verts, faces))
    return path


def _jax_image(mesh_path, method, focal, objects=1, ticks=0):
    """The JAX package's image of the apps' scene and camera."""
    import jax

    import cpp_cuda_raytracer_dev_tpu as J
    from cpp_cuda_raytracer_dev_tpu.accel import traverse as jtr
    from cpp_cuda_raytracer_dev_tpu.accel.kd_build import build_kd as jbuild
    from cpp_cuda_raytracer_dev_tpu.io import ply as jply
    from cpp_cuda_raytracer_dev_tpu.models import animation as janim
    mesh = jply.load_mesh(mesh_path)
    tv = mesh.tri_vertices
    scene, _ = _scene_pair(tv, second=objects == 2)
    if objects == 2:     # animate's second pose is scaled by the mesh size
        import jax.numpy as jnp
        lo, hi = tv.reshape(-1, 3).min(0), tv.reshape(-1, 3).max(0)
        size = float(np.linalg.norm(hi - lo))
        o1 = scene.objects[1]
        scene = scene.replace(objects=(scene.objects[0], o1.replace(
            pose=o1.pose.replace(translation=jnp.asarray(
                [size * 0.6, 0.0, size * 0.2], jnp.float32)))))
    lo, hi = tv.reshape(-1, 3).min(0), tv.reshape(-1, 3).max(0)
    center, size = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
    cam = J.Camera.create(*RES, pos=center + np.array(
        [0, 0.1 * size, -1.2 * size]), look_at=center, up=[0, 1, 0],
        film_h=0.024, focal=focal)
    for tick, _, s in janim.run_script(scene, cam, janim.demo_script()):
        if tick == ticks:
            break
        scene = s
    cfg = J.RenderConfig(method=method, max_candidates=48,
                         draw_distance=max(400.0, 10 * size))
    accel = None
    if method == "kd":
        accel = (jtr.KDTables.from_tree(
            jbuild(mesh.aabb_min, mesh.aabb_max, 128),
            scene.objects[0].tris),)
    out = jax.jit(lambda s, c: J.render(s, c, cfg, accel))(scene, cam)
    return image.to_display(np.asarray(out.image))


@pytest.mark.parametrize("method", ["fixed", "bin", "kd"])
def test_render_cli_png_matches_jax(mesh_path, tmp_path, method, capsys):
    out = tmp_path / "f.png"
    render_cli.main(["--mesh", str(mesh_path), "--out", str(out), "--res",
                     *map(str, RES), "--method", method, "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "hit rate" in printed and "CPU wall-clock" in printed
    got = _read_png(out).astype(int)
    want = _jax_image(mesh_path, method, focal=0.055).astype(int)
    assert got.shape == (RES[1], RES[0], 3)
    assert np.abs(got - want).max() <= 1
    assert (got != (240, 130, 0)).any(axis=-1).mean() > 0.3


def test_animate_second_object_matches_jax(mesh_path, tmp_path, capsys):
    """Three ticks of the key script on two objects by the bin path; the
    third frame's PNG against JAX's, and the JSON report."""
    import json
    frames, report = tmp_path / "frames", tmp_path / "a.json"
    animate.main(["--mesh", str(mesh_path), "--out", str(frames), "--res",
                  *map(str, RES), "--frames", "3", "--method", "bin",
                  "--second-object", "--json-out", str(report),
                  "--device", "cpu"])
    assert "rendered 3 frames" in capsys.readouterr().out
    got = _read_png(frames / "frame_0002.png").astype(int)
    want = _jax_image(mesh_path, "bin", focal=0.035, objects=2,
                      ticks=3).astype(int)
    assert np.abs(got - want).max() <= 1
    rep = json.loads(report.read_text())
    assert rep["frames"] == 3 and rep["objects"] == 2
    assert rep["device"] == "cpu" and rep["cpu_ms_per_frame"] > 0


@pytest.mark.parametrize("app", [render_cli, animate])
def test_apps_refuse_to_fall_back_to_the_cpu(app, mesh_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        app.main(["--mesh", str(mesh_path)])
    assert e.value.code != 0


def test_checked_render_and_debug_nans():
    tv = np.roll(uv_sphere(10, 10), -30, axis=0)
    tris = P.Triangles.from_vertices(tv, device="cpu")
    scene = P.Scene([P.SceneObject(tris)])
    cam = P.Camera.create(32, 16, pos=[0.0, 0.0, -3.0], look_at=[0, 0, 0],
                          up=[0, 1, 0], device="cpu")
    for method in ("fixed", "bin"):
        cfg = P.RenderConfig(method=method, bin_chunk=128)
        err, frame = checked_render(scene, cam, cfg)
        assert err.get() is None and frame.image.shape == (16, 32, 3)
        err.throw()
        with debug_nans():
            P.render_differentiable(scene, cam, cfg).radiance.sum().backward()
    with torch.no_grad():
        scene.phong.light_pos[1] = float("nan")
    err, _ = checked_render(scene, cam, P.RenderConfig(method="fixed"))
    assert "radiance" in err.get()
    with pytest.raises(ValueError, match="radiance"):
        err.throw()
    with pytest.raises(FloatingPointError, match="NaN"):
        with debug_nans():
            P.render(scene, cam, P.RenderConfig(method="fixed"))


def test_profiling_helpers(tmp_path, monkeypatch):
    calls = []
    dt = profiling.device_time(lambda i: calls.append(i), n_lo=2, n_hi=3,
                               repeats=3, device="cpu")
    assert dt >= 0 and calls == list(range(11))    # distinct indices
    assert profiling.timed(lambda x: x + 1, torch.ones(3), iters=2) >= 0
    timer = profiling.Timer()
    with timer.phase("load", fence=torch.ones(2)):
        pass
    assert "load" in timer.report()
    m = profiling.FrameMetrics(frame_ms=20.0, num_rays=1000, hit_rate=0.5)
    assert m.fps == 50.0 and "50.0 FPS" in profiling.metrics_line(m)
    with profiling.trace(tmp_path / "tr"):
        torch.ones(4).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.device_time(lambda i: None)
