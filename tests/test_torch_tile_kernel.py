"""The tile-intersect kernels K4 (``tile_intersect_v2``) and K5
(``tile_intersect``) through their plain versions, against the JAX
package's Pallas kernels (``pallas_tile_intersect_v2`` /
``pallas_tile_intersect``, interpret mode) on the identical operands: a
posed sphere's culled candidates at 64x30 in 8x32 tiles, 32-triangle
clusters.

- K4: hit ids agree on >= 99.9% of rays, each disagreement a near-tie by
  the oracle; t within rtol 1e-4 (JAX quantises t to about 2^-16 relative
  and takes an approximate reciprocal with one Newton step); candidates
  visited and sub-tile MT executions (``debug_mode`` 1) equal.
- K5: the same id rule; t within rtol 2e-6 (XLA on the CPU contracts
  multiply-adds into FMAs).
- The wrappers run the plain versions on CPU tensors without counting a
  launch, and refuse malformed operands.
- On a CUDA device (``gpu`` marker, skipped here): each kernel equals its
  plain version bit for bit (t, ids, steps), at 256 and 2,048 rays a tile,
  on operands the port's own cull makes.

The JAX package is imported inside the tests that use it, so that the GPU
tests also run where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_tile_kernel.py
"""

import numpy as np
import pytest
import torch

from cpp_cuda_raytracer_dev_torch import Camera, ClusterAccel, Triangles
from cpp_cuda_raytracer_dev_torch.accel import traverse as ptr
from cpp_cuda_raytracer_dev_torch.ops.cuda import tile_intersect as ti
from cpp_cuda_raytracer_dev_torch.ops.intersect import mt_test
from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

RES_W, RES_H = 64, 30
LEAF, K = 32, 16
DRAW = 400.0


def _operands(sub=(0, 0)):
    """The JAX pipeline's kernel operands for one sphere frame, as numpy:
    d_tiles, cand, count, boxes, root, geom9, slot_mat, plus geom_t, the
    mesh and the tiled rays."""
    import jax.numpy as jnp

    import cpp_cuda_raytracer_dev_tpu as J
    from cpp_cuda_raytracer_dev_tpu.accel import traverse as jtr

    res_w, res_h, th, tw = RES_W, RES_H, 8, 32
    tv = uv_sphere(40, 40, roughness=0.03)
    tris = J.Triangles.from_vertices(tv)
    accel = jtr.ClusterAccel.build(tris, leaf_size=LEAF, cache=False)
    cam = J.Camera.create(res_w, res_h, pos=[0.1, 0.3, -3.0],
                          look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                          film_h=0.024, focal=0.055)
    o = jnp.asarray(cam.pos)
    d = cam.ray_directions()
    tiles, _ = jtr._tile_rays(d, res_h, res_w, th, tw, *sub)
    cand, count, _ = jtr.cull_tiles(o, tiles, accel, th, tw, K, *sub)
    boxes = jtr._candidate_boxes(o, accel, cand, count)
    root = jnp.concatenate([o, jnp.min(accel.bounds_min, axis=0),
                            jnp.max(accel.bounds_max, axis=0)])
    return {"d_tiles": np.asarray(tiles.transpose(0, 2, 1)),
            "cand": np.asarray(cand), "count": np.asarray(count),
            "boxes": np.asarray(boxes), "root": np.asarray(root),
            "geom9": np.asarray(accel.geom9_t),
            "slot_mat": np.asarray(accel.slot_mat), "tv": tv,
            "geom_t": np.asarray(accel.geom_t), "tiles": np.asarray(tiles)}


@pytest.fixture(scope="module")
def ops():
    return _operands()


def _port_args(ops, origin_only=False):
    names = ("d_tiles", "cand", "count", "boxes", "root", "geom9", "slot_mat")
    args = [torch.tensor(ops[n]) for n in names]
    if origin_only:
        args[4] = args[4][:3].contiguous()
    return args


def _assert_near_ties(ptri, jtri, ops):
    """Rays whose ids differ must hit both triangles at t within 1e-4."""
    tris = Triangles.from_vertices(ops["tv"], device="cpu")
    o = torch.tensor(ops["root"][:3])
    d = torch.tensor(ops["tiles"]).reshape(-1, 3)
    ptri, jtri = ptri.reshape(-1), jtri.reshape(-1)
    same = ptri == jtri
    assert same.mean() >= 0.999, same.mean()
    for i in np.nonzero(~same)[0]:
        ts = []
        for tri in (ptri[i], jtri[i]):
            assert tri >= 0, f"ray {i}: hit against miss"
            t, _, _, ok = mt_test(o, d[i], tris.p1[tri], tris.e1[tri],
                                  tris.e2[tri])
            assert bool(ok), f"ray {i}: triangle {tri} not hit"
            ts.append(float(t))
        assert abs(ts[0] - ts[1]) <= 1e-4 * ts[1], (i, ts)
    return same


@pytest.mark.parametrize("sub", [(0, 0), (4, 16)])
def test_k4_plain_version_matches_jax_kernel(sub):
    import jax.numpy as jnp

    from cpp_cuda_raytracer_dev_tpu.ops.pallas.intersect_kernel_v2 import \
        pallas_tile_intersect_v2
    ops = _operands(sub=sub)
    n_sub = (8 // sub[0]) * (32 // sub[1]) if sub[0] else 1
    jt, jenc, jsteps = pallas_tile_intersect_v2(
        *(jnp.asarray(ops[n]) for n in ("d_tiles", "cand", "count", "boxes",
                                        "root", "geom9")),
        leaf=ops["geom9"].shape[2], draw_distance=DRAW, n_sub=n_sub,
        debug_mode=1, interpret=True)
    # decode JAX's k * Lpad + slot winners into triangle ids
    jenc = np.asarray(jenc)
    lpad = ops["geom9"].shape[2]
    kwin, slot = np.maximum(jenc, 0) // lpad, np.maximum(jenc, 0) % lpad
    cl = np.take_along_axis(ops["cand"], kwin, axis=1)
    jtri = np.where(jenc >= 0, ops["slot_mat"][cl, np.minimum(slot,
                                                              LEAF - 1)], -1)
    pt, ptri, psteps = ti.tile_intersect_v2_reference(
        *_port_args(ops), draw_distance=DRAW, n_sub=n_sub, count_subs=True)
    assert pt.shape == ptri.shape == jt.shape and psteps.shape == (8, 2)
    assert (ptri.numpy() >= 0).mean() > 0.5
    same = _assert_near_ties(ptri.numpy(), jtri, ops)
    np.testing.assert_allclose(pt.numpy().reshape(-1)[same],
                               np.asarray(jt).reshape(-1)[same], rtol=1e-4)
    np.testing.assert_array_equal(psteps.numpy(), np.asarray(jsteps))
    assert (psteps[:, 0] < torch.tensor(ops["count"])).any()  # exits early


def test_k5_plain_version_matches_jax_kernel(ops):
    import jax.numpy as jnp

    from cpp_cuda_raytracer_dev_tpu.ops.pallas.intersect_kernel import \
        pallas_tile_intersect
    jt, jtri = pallas_tile_intersect(
        *(jnp.asarray(ops[n]) for n in ("d_tiles", "cand", "count")),
        jnp.asarray(ops["boxes"]), jnp.asarray(ops["root"][:3]),
        jnp.asarray(ops["geom_t"]), jnp.asarray(ops["slot_mat"]),
        leaf=LEAF, draw_distance=DRAW, interpret=True)
    pt, ptri, psteps = ti.tile_intersect_reference(
        *_port_args(ops, origin_only=True), draw_distance=DRAW)
    same = _assert_near_ties(ptri.numpy(), np.asarray(jtri), ops)
    np.testing.assert_allclose(pt.numpy().reshape(-1)[same],
                               np.asarray(jt).reshape(-1)[same], rtol=2e-6)
    np.testing.assert_array_equal(psteps[:, 0].numpy(), ops["count"])
    np.testing.assert_array_equal(psteps[:, 1].numpy(), 0)


@pytest.mark.parametrize("v2", [True, False])
def test_wrappers_run_the_plain_version_on_cpu(ops, v2):
    fn = ti.tile_intersect_v2 if v2 else ti.tile_intersect
    plain = (ti.tile_intersect_v2_reference if v2
             else ti.tile_intersect_reference)
    args = _port_args(ops)
    before = fn.launches
    for n_sub, count_subs in ((1, False), (8, True), (256, True)):
        got = fn(*args, n_sub=n_sub, count_subs=count_subs)
        want = plain(*args, n_sub=n_sub, count_subs=count_subs)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        # sub-tiles count, they never change a hit
        base = plain(*args)
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
        assert torch.equal(got[2][:, 0], base[2][:, 0])
    assert fn.launches == before


def test_k4_visits_fewer_candidates_than_k5(ops):
    """The suffix-min certificate stops K4's walk early; K5 visits every
    candidate. Both find the same triangles on this frame."""
    args = _port_args(ops)
    t4, tri4, s4 = ti.tile_intersect_v2(*args, draw_distance=DRAW)
    t5, tri5, s5 = ti.tile_intersect(*args, draw_distance=DRAW)
    assert int(s4[:, 0].sum()) < int(s5[:, 0].sum())
    assert (tri4 == tri5).float().mean() >= 0.999


def test_wrappers_refuse_malformed_operands(ops):
    args = _port_args(ops)
    with pytest.raises(ValueError, match="n_sub"):
        ti.tile_intersect_v2(*args, n_sub=3)
    bad = list(args)
    bad[1] = bad[1].long()
    with pytest.raises(ValueError, match="cand"):
        ti.tile_intersect(*bad)
    bad = list(args)
    bad[4] = bad[4][:3].contiguous()
    with pytest.raises(ValueError, match="K4"):
        ti.tile_intersect_v2(*bad)
    bad = list(args)
    bad[0] = bad[0].transpose(1, 2)
    with pytest.raises(ValueError, match="d_tiles"):
        ti.tile_intersect(*bad)


def test_cluster_accel_holds_the_kernel_layout():
    tv = uv_sphere(20, 20)
    accel = ClusterAccel.build(Triangles.from_vertices(tv, device="cpu"),
                               leaf_size=48, cache=False)
    assert accel.geom9.shape[1:] == (9, 128) and accel.geom9.is_contiguous()
    assert accel.slot_mat.shape[1] == 48
    assert accel.geom_t.shape[1:] == (48, 9)
    assert (accel.geom9[:, :, 48:] == 0).all()


def _port_operands(th, tw, device):
    """Kernel operands from the port's own cull (no JAX): a 128x64 frame of
    the sphere, 32-triangle clusters, 16 candidates a tile."""
    tris = Triangles.from_vertices(uv_sphere(40, 40, roughness=0.03),
                                   device=device)
    accel = ClusterAccel.build(tris, leaf_size=LEAF, cache=False)
    cam = Camera.create(128, 64, pos=[0.1, 0.3, -3.0], look_at=[0.0, 0.0, 0.0],
                        up=[0.0, 1.0, 0.0], film_h=0.024, focal=0.055,
                        device=device)
    with torch.no_grad():
        o = cam.pos
        tiles, _ = ptr._tile_rays(cam.ray_directions(), 64, 128, th, tw)
        cand, count, _ = ptr.cull_tiles(o, tiles, accel, th, tw, K)
        boxes = ptr._candidate_boxes(o, accel, cand, count)
        root = torch.cat([o, accel.bounds_min.amin(dim=0),
                          accel.bounds_max.amax(dim=0)])
    return [tiles.transpose(1, 2).contiguous(), cand, count, boxes, root,
            accel.geom9, accel.slot_mat]


def test_port_operands_give_both_kernels_the_same_hits():
    """The GPU tests' operands (the port's own cull) hold a frame that K4
    and K5 render alike on the CPU."""
    args = _port_operands(8, 32, "cpu")
    assert args[0].shape == (32, 3, 256) and args[1].dtype == torch.int32
    got = ti.tile_intersect_v2(*args)
    want = ti.tile_intersect(*args)
    assert (got[1] >= 0).float().mean() > 0.5
    assert (got[1] == want[1]).float().mean() >= 0.999


def _assert_same_hits_at_infinite_draw(fn, args):
    """An infinite draw distance changes no hit of a frame whose hits all
    lie within the default one, and every miss keeps id -1 and t = inf."""
    t, tri, steps = fn(*args)
    t_inf, tri_inf, steps_inf = fn(*args, draw_distance=float("inf"))
    hit = tri >= 0
    assert hit.float().mean() > 0.5 and (~hit).any()
    assert torch.equal(tri_inf, tri)
    assert torch.equal(t_inf[hit], t[hit])
    assert bool(torch.isinf(t_inf[~hit]).all())
    return t_inf, tri_inf, steps_inf


@pytest.mark.parametrize("v2", [True, False])
def test_plain_version_at_infinite_draw_distance(v2):
    """Rays that pass a cluster's box test but hit none of its triangles
    take nothing from it, even where the draw distance exceeds K4's 3e38
    miss value."""
    args = _port_operands(8, 32, "cpu")
    _assert_same_hits_at_infinite_draw(
        ti.tile_intersect_v2_reference if v2 else ti.tile_intersect_reference,
        args)


def _gpu_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [(8, 32), (32, 64)])
@pytest.mark.parametrize("v2", [True, False])
def test_kernel_matches_plain_version_on_gpu(tile, v2):
    """Bit for bit: t, ids and steps, with and without the sub-tile count;
    32x64 tiles run 2 rays a thread."""
    dev = _gpu_device()
    args = _port_operands(*tile, dev)
    fn = ti.tile_intersect_v2 if v2 else ti.tile_intersect
    plain = (ti.tile_intersect_v2_reference if v2
             else ti.tile_intersect_reference)
    p = tile[0] * tile[1]
    for n_sub, count_subs in ((1, False), (p // 32, True), (p, True)):
        before = fn.launches
        got = fn(*args, n_sub=n_sub, count_subs=count_subs)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        want = plain(*args, n_sub=n_sub, count_subs=count_subs)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("v2", [True, False])
def test_kernel_at_infinite_draw_distance_on_gpu(v2):
    """Bit for bit with the plain version at an infinite draw distance, and
    the same hits as at the default one."""
    dev = _gpu_device()
    args = _port_operands(8, 32, dev)
    fn = ti.tile_intersect_v2 if v2 else ti.tile_intersect
    plain = (ti.tile_intersect_v2_reference if v2
             else ti.tile_intersect_reference)
    got = _assert_same_hits_at_infinite_draw(fn, args)
    want = plain(*args, draw_distance=float("inf"))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
