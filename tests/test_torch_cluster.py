"""PyTorch port vs the JAX package: the cluster paths (``method`` "grid",
"pallas", "pallas2") on a posed, rough 3,200-triangle sphere at 64x30
(8x32 tiles, the last tile row padded), 32-triangle clusters.

- ``build_kd`` and ``ClusterAccel.build`` equal JAX's, every array bit for
  bit; the KD disk cache gives the same tree back.
- ``_tile_rays`` / ``_untile``: the same tiles as JAX, and a round trip.
- The cull: ``count`` and ``overflow`` exact, the candidate set of every
  tile equal (its order may differ where XLA and PyTorch round the tile's
  mean direction differently), flat and hierarchical, with and without
  sub-tiles.
- Each method through ``render`` against JAX's on the converted accel:
  hit ids agree on >= 99.9% of pixels and every disagreement is a near-tie
  (the two triangles' oracle t within 1e-4 relative); where the ids
  agree, t within rtol 2e-6 for "grid" and "pallas" (XLA on the CPU
  contracts multiply-adds into FMAs, PyTorch rounds each product; measured
  up to 1.3e-6), and 1e-4 for "pallas2" (JAX's K4 quantises t to about
  2^-16 relative).
- Sub-tiles change nothing; a grazing view with 4 candidates drops hits
  without escalation and recovers them with ``escalate_factor`` 16, with
  hits and stats matching JAX in both.
- Gradients of a "pallas2" render loss against ``jax.grad`` leaf by leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpp_cuda_raytracer_dev_tpu as J
import cpp_cuda_raytracer_dev_torch as P
from cpp_cuda_raytracer_dev_tpu.accel import kd_build as jkd
from cpp_cuda_raytracer_dev_tpu.accel import traverse as jtr
from cpp_cuda_raytracer_dev_tpu.ops.quaternion import Pose as JPose
from cpp_cuda_raytracer_dev_tpu.ops.quaternion import from_axis_angle
from cpp_cuda_raytracer_dev_torch.accel import kd_build as pkd
from cpp_cuda_raytracer_dev_torch.accel import traverse as ptr
from cpp_cuda_raytracer_dev_torch.ops.intersect import mt_test
from cpp_cuda_raytracer_dev_torch.utils import cache
from cpp_cuda_raytracer_dev_torch.utils.convert import (
    camera_from_numpy, cluster_accel_from_numpy, params_to_numpy, path_dict,
    scene_from_numpy)
from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

RES_W, RES_H = 64, 30
LEAF = 32
BASE = dict(leaf_size=LEAF, tile_h=8, tile_w=32, max_candidates=24)
KD_FIELDS = ("bounds_min", "bounds_max", "cut_code", "s1", "s2", "left",
             "right", "parent", "leaf_start", "leaf_count", "perm")
ACCEL_FIELDS = ("bounds_min", "bounds_max", "centers", "geom9_t", "slot_mat")
flat = jax.tree_util.tree_flatten_with_path


def _mesh():
    # start at the equator: the sphere's first (pole) triangles are
    # degenerate, and JAX's gradient there is NaN (ROADMAP F6)
    tv = uv_sphere(40, 40, roughness=0.03)
    return np.roll(tv, -tv.shape[0] // 2, axis=0)


def _camera(pos, look_at=(0.0, 0.0, 0.0)):
    jcam = J.Camera.create(RES_W, RES_H, pos=list(pos), look_at=list(look_at),
                           up=[0.0, 1.0, 0.0], film_h=0.024, focal=0.055)
    pcam = camera_from_numpy({**path_dict(flat(jcam)[0]), "res_w": RES_W,
                              "res_h": RES_H}, "cpu")
    return jcam, pcam


@pytest.fixture(scope="module")
def world():
    tv = _mesh()
    color = np.random.default_rng(0).uniform(0.1, 1.0, (tv.shape[0], 3))
    pose = JPose(quat=from_axis_angle(jnp.array([0.3, 1.0, 0.1]), 0.6),
                 translation=jnp.array([0.15, -0.1, 0.2]))
    jtris = J.Triangles.from_vertices(tv, color.astype(np.float32))
    jscene = J.Scene.create([J.SceneObject.create(jtris, pose)])
    pscene = scene_from_numpy(path_dict(flat(jscene)[0]), "cpu")
    jaccel = jtr.ClusterAccel.build(jtris, leaf_size=LEAF, cache=False)
    paccel = cluster_accel_from_numpy(
        {**{f: np.asarray(getattr(jaccel, f)) for f in ACCEL_FIELDS},
         "leaf_size": LEAF}, "cpu")
    jcam, pcam = _camera((0.1, 0.3, -3.0))
    return jscene, pscene, jaccel, paccel, jcam, pcam


def _object_rays(pscene, pcam):
    obj = pscene.objects[0]
    with torch.no_grad():
        return (obj.pose.inv_apply(pcam.pos),
                obj.pose.inv_apply_vec(pcam.ray_directions()))


def _assert_hits_agree(pt, ptri, jt, jtri, rtol, tris, o, d):
    """ids agree on >= 99.9%, each disagreement a near-tie by the oracle
    (both triangles hit within 1e-4 relative), t within rtol where the ids
    agree."""
    pt, ptri = np.asarray(pt).reshape(-1), np.asarray(ptri).reshape(-1)
    jt, jtri = np.asarray(jt).reshape(-1), np.asarray(jtri).reshape(-1)
    same = ptri == jtri
    assert same.mean() >= 0.999, same.mean()
    for i in np.nonzero(~same)[0]:
        ts = []
        for tri in (ptri[i], jtri[i]):
            assert tri >= 0, f"pixel {i}: hit against miss"
            t, _, _, ok = mt_test(o, d[i], tris.p1[tri], tris.e1[tri],
                                  tris.e2[tri])
            assert bool(ok), f"pixel {i}: triangle {tri} not hit"
            ts.append(float(t))
        assert abs(ts[0] - ts[1]) <= 1e-4 * ts[1], (i, ts)
    np.testing.assert_allclose(pt[same], jt[same], rtol=rtol)


@pytest.mark.parametrize("leaf", [1, 32])
def test_build_kd_matches_jax(leaf):
    tv = _mesh()
    amin, amax = tv.min(axis=1), tv.max(axis=1)
    jt = jkd.build_kd(amin, amax, min_node_size=leaf)
    pt = pkd.build_kd(amin, amax, min_node_size=leaf)
    for f in KD_FIELDS:
        j, p = getattr(jt, f), getattr(pt, f)
        assert p.dtype == j.dtype and p.shape == j.shape, f
        np.testing.assert_array_equal(p, j, err_msg=f)
    pkd.validate_kd(pt, amin, amax)


def test_kd_cache_round_trip(tmp_path):
    tv = _mesh()
    amin, amax = tv.min(axis=1), tv.max(axis=1)
    ref = pkd.build_kd(amin, amax, min_node_size=16)
    first = cache.build_kd_cached(amin, amax, 16, cache_dir=str(tmp_path))
    again = cache.build_kd_cached(amin, amax, 16, cache_dir=str(tmp_path))
    assert len(list(tmp_path.iterdir())) == 1
    for f in KD_FIELDS:
        np.testing.assert_array_equal(getattr(first, f), getattr(ref, f))
        np.testing.assert_array_equal(getattr(again, f), getattr(ref, f))
    assert again.min_node_size == 16
    assert (cache.mesh_key(amin, amax, 16)
            != cache.mesh_key(amin, amax, 8))


def test_cluster_accel_build_through_the_cache(world, tmp_path, monkeypatch):
    _, pscene, _, paccel, _, _ = world
    monkeypatch.setattr(cache, "DEFAULT_CACHE_DIR", str(tmp_path))
    tris = pscene.objects[0].tris
    for _ in range(2):                      # a miss, then a hit
        built = P.ClusterAccel.build(tris, leaf_size=LEAF)
        assert len(list(tmp_path.iterdir())) == 1
        for f in ("bounds_min", "bounds_max", "centers", "geom9",
                  "slot_mat"):
            assert torch.equal(getattr(built, f), getattr(paccel, f)), f


def test_cluster_accel_build_matches_jax(world):
    _, pscene, jaccel, _, _, _ = world
    built = P.ClusterAccel.build(pscene.objects[0].tris, leaf_size=LEAF,
                                 cache=False)
    assert built.num_clusters == jaccel.num_clusters == 128
    assert built.leaf_size == LEAF
    for f in ("bounds_min", "bounds_max", "centers", "slot_mat"):
        j, p = np.asarray(getattr(jaccel, f)), getattr(built, f).numpy()
        assert p.dtype == j.dtype and p.shape == j.shape, f
        np.testing.assert_array_equal(p, j, err_msg=f)
    np.testing.assert_array_equal(built.geom9.numpy(),
                                  np.asarray(jaccel.geom9_t))
    np.testing.assert_array_equal(built.geom_t.numpy(),
                                  np.asarray(jaccel.geom_t))
    np.testing.assert_array_equal(built.slot_tri.numpy(),
                                  np.asarray(jaccel.slot_tri))


@pytest.mark.parametrize("sub", [(0, 0), (4, 16), (2, 8), (8, 32)])
def test_tile_rays_and_untile(sub):
    rng = np.random.default_rng(3)
    d = rng.standard_normal((RES_H * RES_W, 3)).astype(np.float32)
    jtiles, jmeta = jtr._tile_rays(jnp.asarray(d), RES_H, RES_W, 8, 32, *sub)
    ptiles, pmeta = ptr._tile_rays(torch.tensor(d), RES_H, RES_W, 8, 32,
                                   *sub)
    assert pmeta == tuple(jmeta)
    np.testing.assert_array_equal(ptiles.numpy(), np.asarray(jtiles))
    back = ptr._untile(ptiles, pmeta, RES_H, RES_W)
    np.testing.assert_array_equal(back.reshape(-1, 3).numpy(), d)
    ids = torch.arange(ptiles.shape[0] * ptiles.shape[1]).reshape(
        ptiles.shape[:2])
    np.testing.assert_array_equal(
        ptr._untile(ids, pmeta, RES_H, RES_W).numpy(),
        np.asarray(jtr._untile(jnp.asarray(ids.numpy()), jmeta, RES_H,
                               RES_W)))
    assert ptr._corner_idx(8, 32, *sub) == jtr._corner_idx(8, 32, *sub)


@pytest.mark.parametrize("hier", [False, True])
@pytest.mark.parametrize("sub", [(0, 0), (4, 16)])
def test_cull_matches_jax(world, hier, sub):
    jscene, pscene, jaccel, paccel, _, pcam = world
    o, d = _object_rays(pscene, pcam)
    k = 12
    jtiles, _ = jtr._tile_rays(jnp.asarray(d.numpy()), RES_H, RES_W, 8, 32,
                               *sub)
    ptiles, _ = ptr._tile_rays(d, RES_H, RES_W, 8, 32, *sub)
    jo = jnp.asarray(o.numpy())
    if hier:
        jout = jtr.cull_tiles_hier(jo, jtiles, jaccel, 8, 32, k, 8, 4, *sub)
        pout = ptr.cull_tiles_hier(o, ptiles, paccel, 8, 32, k, 8, 4, *sub)
    else:
        jout = jtr.cull_tiles(jo, jtiles, jaccel, 8, 32, k, *sub)
        pout = ptr.cull_tiles(o, ptiles, paccel, 8, 32, k, *sub)
    jcand, jcount, jovf = (np.asarray(x) for x in jout)
    pcand, pcount, povf = (x.numpy() for x in pout)
    assert pcand.dtype == np.int32 and pcand.shape == jcand.shape
    np.testing.assert_array_equal(pcount, jcount)
    np.testing.assert_array_equal(povf, jovf)
    assert povf.sum() > 0 and (pcount > 0).all()
    for t in range(pcand.shape[0]):
        n = pcount[t]
        assert sorted(pcand[t, :n]) == sorted(jcand[t, :n]), t
    boxes = ptr._candidate_boxes(o, paccel, pout[0], pout[1])
    jboxes = jtr._candidate_boxes(jo, jaccel, jnp.asarray(pcand),
                                  jnp.asarray(pcount))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), rtol=1e-6)


@pytest.mark.parametrize("method,rtol", [("grid", 2e-6), ("pallas", 2e-6),
                                         ("pallas2", 1e-4)])
def test_method_matches_jax(world, method, rtol):
    jscene, pscene, jaccel, paccel, jcam, pcam = world
    jo = J.render(jscene, jcam, J.RenderConfig(method=method, **BASE),
                  accel=(jaccel,))
    po = P.render(pscene, pcam, P.RenderConfig(method=method, **BASE),
                  accel=(paccel,))
    assert po.hit_tri.shape == (RES_H, RES_W)
    assert (po.hit_tri.numpy() >= 0).mean() > 0.5
    o, d = _object_rays(pscene, pcam)
    _assert_hits_agree(po.hit_t.numpy(), po.hit_tri.numpy(), jo.hit_t,
                       jo.hit_tri, rtol, pscene.objects[0].tris, o, d)
    np.testing.assert_array_equal(po.hit_obj.numpy(), np.asarray(jo.hit_obj))
    same = po.hit_tri.numpy() == np.asarray(jo.hit_tri)
    np.testing.assert_allclose(po.radiance.numpy()[same],
                               np.asarray(jo.radiance)[same], rtol=1e-4,
                               atol=1e-5)
    # and against the port's own oracle
    ref = P.render(pscene, pcam, P.RenderConfig(method="fixed", chunk=512))
    assert (po.hit_tri == ref.hit_tri).float().mean() >= 0.999


def test_subtiles_never_change_hits(world):
    _, pscene, _, paccel, _, pcam = world
    cfg = dict(method="pallas2", **BASE)
    whole = P.render(pscene, pcam, P.RenderConfig(**cfg), accel=(paccel,))
    for sub in ((4, 16), (1, 1), (8, 8)):
        part = P.render(pscene, pcam, P.RenderConfig(
            **cfg, sub_h=sub[0], sub_w=sub[1]), accel=(paccel,))
        assert torch.equal(part.hit_tri, whole.hit_tri), sub
        assert torch.equal(part.hit_t, whole.hit_t), sub


def test_escalation_and_stats_match_jax(world):
    """A grazing view with 4 candidates a tile: without escalation hits
    drop (and overflow is reported); escalate_factor 16 recovers them.
    Hits and stats match JAX's in both."""
    jscene, pscene, jaccel, paccel, _, _ = world
    jcam, pcam = _camera((1.8, 0.3, 1.6), look_at=(0.15, -0.1, 0.2))
    o, d = _object_rays(pscene, pcam)
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    ref = P.render(pscene, pcam, P.RenderConfig(method="fixed", chunk=512))
    ref_tri = ref.hit_tri.reshape(-1).numpy()
    assert (ref_tri >= 0).mean() > 0.3
    tris = pscene.objects[0].tris
    agree = {}
    for name, esc in (("drop", dict(escalate_tiles=0)),
                      ("fix", dict(escalate_tiles=64, escalate_factor=16))):
        kw = dict(method="pallas2", leaf_size=LEAF, tile_h=8, tile_w=32,
                  max_candidates=4, with_stats=True, debug_mode=1, **esc)
        jhit, jst = jtr.intersect_clustered_pallas_v2(
            jo, jd, jaccel, J.RenderConfig(**kw), RES_H, RES_W)
        phit, pst = ptr.intersect_clustered_pallas_v2(
            o, d, paccel, P.RenderConfig(**kw), RES_H, RES_W)
        _assert_hits_agree(phit.t, phit.tri, jhit.t, jhit.tri, 1e-4, tris,
                           o, d)
        for f in ("count", "overflow", "steps", "mt_subs"):
            np.testing.assert_array_equal(pst[f].numpy(),
                                          np.asarray(jst[f]), err_msg=f)
        agree[name] = (phit.tri.numpy() == ref_tri).mean()
        agree[name + "_ovf"] = int(pst["overflow"].sum())
    assert agree["drop"] < 0.99 and agree["drop_ovf"] > 0, agree
    assert agree["fix"] >= 0.999, agree
    assert agree["fix_ovf"] < agree["drop_ovf"], agree


def test_pallas2_gradients_match_jax(world):
    """Autograd through the pallas2 frame against jax.grad of the same
    weighted loss, every scene and camera leaf: rtol 1e-4, atol 1e-5 of the
    leaf's largest gradient (as tests/test_torch_grad.py holds the bin
    frame)."""
    jscene, pscene, jaccel, paccel, jcam, pcam = world
    cfg = dict(method="pallas2", **BASE)
    w = np.linspace(0.3, 1.7, RES_H * RES_W * 3,
                    dtype=np.float32).reshape(RES_H, RES_W, 3)

    def jloss(scene, cam):
        return jnp.mean(J.render(scene, cam, J.RenderConfig(**cfg),
                                 accel=(jaccel,)).radiance * w)
    jgs, jgc = jax.grad(jloss, argnums=(0, 1))(jscene, jcam)
    scene = scene_from_numpy(path_dict(flat(jscene)[0]), "cpu")
    cam = camera_from_numpy({**path_dict(flat(jcam)[0]), "res_w": RES_W,
                             "res_h": RES_H}, "cpu").requires_grad_()
    out = P.render_differentiable(scene, cam, P.RenderConfig(**cfg),
                                  (paccel,))
    assert (out.hit_tri >= 0).float().mean() > 0.5
    torch.mean(out.radiance * torch.tensor(w)).backward()
    want = {**path_dict(flat(jgs)[0]),
            **{"cam." + k: v for k, v in path_dict(flat(jgc)[0]).items()}}
    got = {**params_to_numpy(scene, grad=True),
           **{"cam." + k: v for k, v in
              params_to_numpy(cam, grad=True).items()}}
    assert sorted(got) == sorted(want)
    for key in want:
        j = np.asarray(want[key])
        assert got[key].shape == j.shape and np.isfinite(got[key]).all(), key
        np.testing.assert_allclose(got[key], j, rtol=1e-4,
                                   atol=1e-5 * np.abs(j).max(), err_msg=key)
    assert np.abs(got["objects.0.tris.p1x"]).max() > 0


def test_cluster_methods_need_accel(world):
    _, pscene, _, paccel, _, pcam = world
    with pytest.raises(ValueError, match="accel"):
        P.render(pscene, pcam, P.RenderConfig(method="pallas2", **BASE))
    # the training step takes the accel too
    from cpp_cuda_raytracer_dev_torch.parallel.render_pjit import \
        make_train_step
    target = torch.zeros(RES_H, RES_W, 3)
    opt = torch.optim.SGD(pscene.phong.parameters(), lr=1e-3)
    before = pscene.phong.light_pos.detach().clone()
    loss = make_train_step(opt, P.RenderConfig(method="pallas", **BASE),
                           accel=(paccel,))({"scene": pscene,
                                             "camera": pcam}, target)
    assert torch.isfinite(loss) and not torch.equal(
        pscene.phong.light_pos.detach(), before)
    with torch.no_grad():
        pscene.phong.light_pos.copy_(before)
