"""The per-tile bin kernel K6 (``bin_tile_intersect``) through its plain
version, against the JAX package's Pallas kernel (``pallas_bin_intersect``,
interpret mode) on identical operands built from the JAX package's binning
(``bin_triangles``: entry_tri, starts, qstep and the depth row) of a
roughened sphere at 64x32 in 16x32 tiles, chunk 128.

- Decoded hit ids equal, except near-ties that the oracle confirms; t
  within rtol 1e-4 (JAX takes an approximate reciprocal with one Newton step
  and quantises t to about 2^-16 relative, ROADMAP F8); steps (chunks
  walked, chunks in range) equal on every tile, in a front view (where the
  exit fires) and a grazing one, although the exit compares with a best
  that differs from JAX's in the last bits.
- ``debug_mode`` 1 and 2 and ``n_sub`` 2 give the same hits.
- `tile_operands` on the port's own binning gives the hits of K1's plain
  version: the same t bit for bit, ids apart only on exact ties.
- On a CUDA device (``gpu`` marker, skipped here): the kernel equals its
  plain version bit for bit, on operands the port's binning makes.

The JAX package is imported inside the tests that use it, so that the GPU
tests also run where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_bin_tile_kernel.py
"""

import numpy as np
import pytest
import torch

from cpp_cuda_raytracer_dev_torch import Camera, RenderConfig, Triangles
from cpp_cuda_raytracer_dev_torch.accel.traverse import bin_object
from cpp_cuda_raytracer_dev_torch.ops.cuda import bin_intersect as k1
from cpp_cuda_raytracer_dev_torch.ops.cuda import bin_tile_intersect as bt
from cpp_cuda_raytracer_dev_torch.ops.intersect import mt_test
from cpp_cuda_raytracer_dev_torch.utils.procgen import uv_sphere

RES_W, RES_H, TH, TW, CHUNK = 64, 32, 16, 32, 128
DRAW = 400.0
# "grazing": close to the sphere, looking past its limb, so many rays skim
# the surface
CAMERAS = {"front": ([0.1, 0.3, -3.0], [0.0, 0.0, 0.0]),
           "grazing": ([1.1, 0.15, -1.6], [0.95, 0.0, 0.0])}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small CPU cases run faster on one thread than on a pool that
    shares the cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh():
    return uv_sphere(48, 48, roughness=0.03)


def _jax_operands(pos, look_at):
    """K6's operands from the JAX pipeline (bin_triangles, _ray_table), as
    numpy, plus the mesh, the entry ids and the origin."""
    import jax.numpy as jnp

    import cpp_cuda_raytracer_dev_tpu as J
    from cpp_cuda_raytracer_dev_tpu.accel import traverse as jtr
    from cpp_cuda_raytracer_dev_tpu.accel.binning import bin_triangles

    tv = _mesh()
    tris = J.Triangles.from_vertices(tv)
    cam = J.Camera.create(RES_W, RES_H, pos=pos, look_at=look_at,
                          up=[0.0, 1.0, 0.0], film_h=0.024, focal=0.055)
    proj, o = cam.projection(), jnp.asarray(cam.pos)
    b = bin_triangles(proj, o, tris.p1, tris.e1, tris.e2, RES_H, RES_W, TH,
                      TW, e_cap=16384, chunk=CHUNK)
    v = tv.reshape(-1, 3)
    bmin, bmax = v.min(0), v.max(0)
    n_tx = RES_W // TW
    rays = jtr._ray_table(proj, o, jnp.asarray(bmin), jnp.asarray(bmax),
                          (RES_H // TH) * n_tx, n_tx, TH, TW, DRAW)
    et = np.asarray(b.entry_tri)
    p1, e1, e2 = (tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    rows = np.concatenate([p1, e1, e2], 1)[np.maximum(et, 0)].T * (et >= 0)
    geom = np.concatenate([rows, np.asarray(b.geom)[10:11]]).astype(
        np.float32).reshape(10, -1, CHUNK).transpose(1, 0, 2)
    origin10 = np.concatenate([np.asarray(o), bmin, bmax,
                               [float(b.qstep)]]).astype(np.float32)
    return {"d_tiles": np.asarray(rays)[..., :3].transpose(0, 2, 1).copy(),
            "starts": np.asarray(b.starts), "origin10": origin10,
            "geom": np.ascontiguousarray(geom), "entry_tri": et, "tv": tv}


def _args(ops):
    return [torch.tensor(ops[n]) for n in ("d_tiles", "starts", "origin10",
                                           "geom")]


@pytest.fixture(scope="module", params=list(CAMERAS))
def jax_case(request):
    """(operands, JAX kernel's (t, enc, steps)) per camera."""
    import jax.numpy as jnp

    from cpp_cuda_raytracer_dev_tpu.ops.pallas.bin_kernel import \
        pallas_bin_intersect
    ops = _jax_operands(*CAMERAS[request.param])
    out = pallas_bin_intersect(*(jnp.asarray(x) for x in _args(ops)),
                               chunk=CHUNK, draw_distance=DRAW,
                               interpret=True)
    return request.param, ops, tuple(np.asarray(x) for x in out)


def _assert_near_ties(ptri, jtri, ops, rtol=1e-4):
    """Rays whose ids differ must hit both triangles at t within rtol."""
    tris = Triangles.from_vertices(ops["tv"], device="cpu")
    o = torch.tensor(ops["origin10"][:3])
    d = torch.tensor(ops["d_tiles"]).transpose(1, 2).reshape(-1, 3)
    ptri, jtri = ptri.reshape(-1), jtri.reshape(-1)
    same = ptri == jtri
    for i in np.nonzero(~same)[0]:
        ts = []
        for tri in (ptri[i], jtri[i]):
            assert tri >= 0, f"ray {i}: hit against miss"
            t, _, _, ok = mt_test(o, d[i], tris.p1[tri], tris.e1[tri],
                                  tris.e2[tri])
            assert bool(ok), f"ray {i}: triangle {tri} not hit"
            ts.append(float(t))
        assert abs(ts[0] - ts[1]) <= rtol * ts[1], (i, ts)
    return same


def test_plain_version_matches_jax_kernel(jax_case):
    name, ops, (jt, jenc, jsteps) = jax_case
    args = _args(ops)
    pt, penc, psteps = bt.bin_tile_intersect_reference(*args, chunk=CHUNK,
                                                       draw_distance=DRAW)
    starts, et = args[1], torch.tensor(ops["entry_tri"])
    ptri = bt.decode_enc(penc, starts, et, CHUNK).numpy()
    jtri = bt.decode_enc(torch.tensor(jenc), starts, et, CHUNK).numpy()
    assert (ptri >= 0).mean() > 0.3
    same = _assert_near_ties(ptri, jtri, ops)
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(pt.numpy().reshape(-1)[same],
                               jt.reshape(-1)[same], rtol=1e-4)
    # steps equal on every tile: no exit here is a near enough thing for
    # the last bits of wb to move it
    np.testing.assert_array_equal(psteps.numpy(), jsteps)
    s = ops["starts"]
    nch = psteps[:, 1].numpy()
    # a tile whose first chunk carries the previous tile's entries
    assert ((s[:-1] % CHUNK != 0) & (s[:-1] > 0) & (nch > 0)).any()
    if name == "front":
        assert (psteps[:, 0] < psteps[:, 1]).any()       # the exit fires


@pytest.mark.parametrize("kw", [{"debug_mode": 1}, {"debug_mode": 2},
                                {"n_sub": 2}, {"n_sub": 16}])
def test_debug_modes_and_subtiles_give_the_same_hits(jax_case, kw):
    _, ops, _ = jax_case
    args = _args(ops)
    t0, enc0, steps0 = bt.bin_tile_intersect_reference(*args, chunk=CHUNK)
    t, enc, steps = bt.bin_tile_intersect_reference(*args, chunk=CHUNK, **kw)
    assert torch.equal(t, t0) and torch.equal(enc, enc0)
    if kw.get("debug_mode"):
        assert torch.equal(steps[:, 0], steps[:, 1])      # no early exit
    else:
        assert torch.equal(steps, steps0)


def _port_case(view, device, th=TH, tw=TW, res=(RES_W, RES_H)):
    """The port's bin operands (bin_object) for the sphere, and K6's."""
    pos, look_at = view
    tris = Triangles.from_vertices(_mesh(), device=device)
    cam = Camera.create(*res, pos=pos, look_at=look_at,
                        up=[0.0, 1.0, 0.0], film_h=0.024, focal=0.055,
                        device=device)
    cfg = RenderConfig(method="bin", tile_h=th, tile_w=tw, bin_chunk=512)
    with torch.no_grad():
        rays, b = bin_object(cam.pos, tris, cam.projection(), cfg, res[1],
                             res[0])
        ops = bt.tile_operands(rays, b, tris, cam.pos, chunk=CHUNK)
    return rays, b, ops


@pytest.mark.parametrize("cam", list(CAMERAS))
def test_tile_operands_give_k1s_hits(cam):
    """K6 over `tile_operands` and K1 over the same binning compute every
    entry's constants by the same operations, so t is equal bit for bit
    and ids differ only on exact ties."""
    rays, b, ops = _port_case(CAMERAS[cam], "cpu")
    d_tiles, starts, origin10, geom = ops
    assert d_tiles.shape == (4, 3, TH * TW) and geom.shape[1:] == (10, CHUNK)
    assert torch.equal(starts, b.starts)
    assert float(origin10[9]) == float(b.qstep)
    t1, tri1 = k1.bin_intersect_reference(rays, b.geom, b.entry_tri,
                                          b.starts, 512)
    t6, enc6, _ = bt.bin_tile_intersect_reference(*ops, chunk=CHUNK)
    tri6 = bt.decode_enc(enc6, starts, b.entry_tri, CHUNK)
    assert (tri6 >= 0).float().mean() > 0.3
    assert torch.equal(t6, t1)
    differ = tri6 != tri1
    if differ.any():
        tv = _mesh()
        d = d_tiles.transpose(1, 2)[differ]
        tris = Triangles.from_vertices(tv, device="cpu")
        for a in (tri6[differ].long(), tri1[differ].long()):
            t, _, _, ok = mt_test(origin10[:3], d, tris.p1[a], tris.e1[a],
                                  tris.e2[a])
            assert bool(ok.all())


def test_tile_operands_refuse_a_chunk_that_does_not_divide():
    rays, b, _ = _port_case(CAMERAS["front"], "cpu")
    tris = Triangles.from_vertices(_mesh(), device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        bt.tile_operands(rays, b, tris, torch.zeros(3), chunk=1024 * 1024)


def test_wrapper_runs_the_plain_version_on_cpu_and_checks(jax_case):
    _, ops, _ = jax_case
    args = _args(ops)
    before = bt.bin_tile_intersect.launches
    got = bt.bin_tile_intersect(*args, chunk=CHUNK)
    want = bt.bin_tile_intersect_reference(*args, chunk=CHUNK)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert bt.bin_tile_intersect.launches == before
    with pytest.raises(NotImplementedError, match="mt_precision"):
        bt.bin_tile_intersect(*args, chunk=CHUNK, mt_precision="default")
    with pytest.raises(ValueError, match="geom"):
        bt.bin_tile_intersect(*args, chunk=64)
    with pytest.raises(ValueError, match="n_sub|divisible"):
        bt.bin_tile_intersect(*args, chunk=CHUNK, n_sub=3)
    bad = list(args)
    bad[1] = bad[1].long()
    with pytest.raises(ValueError, match="starts"):
        bt.bin_tile_intersect(*bad, chunk=CHUNK)


def test_decode_enc():
    starts = torch.tensor([0, 130, 300], dtype=torch.int32)
    entry_tri = torch.arange(512, dtype=torch.int32) * 10
    enc = torch.tensor([[0, 5, -1], [2, 130, -1]], dtype=torch.int32)
    got = bt.decode_enc(enc, starts, entry_tri, 128)
    assert got.tolist() == [[0, 50, -1], [1300, 2580, -1]]


def _gpu_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [(16, 32), (8, 32)])
@pytest.mark.parametrize("cam", list(CAMERAS))
def test_kernel_matches_plain_version_on_gpu(tile, cam):
    """Bit for bit: t, enc and steps, at every debug mode and at 1, 2 and
    16 sub-tiles; the launch counter moves once a call."""
    dev = _gpu_device()
    _, _, ops = _port_case(CAMERAS[cam], dev, *tile, res=(128, 64))
    for kw in ({}, {"debug_mode": 1}, {"debug_mode": 2}, {"n_sub": 2},
               {"n_sub": 16}):
        before = bt.bin_tile_intersect.launches
        got = bt.bin_tile_intersect(*ops, chunk=CHUNK, **kw)
        torch.cuda.synchronize()
        assert bt.bin_tile_intersect.launches == before + 1
        want = bt.bin_tile_intersect_reference(*ops, chunk=CHUNK, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w), kw
