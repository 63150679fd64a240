"""The plain reference's hits and shading on scenes small enough to check
by hand, and its hit search against every ray tested with every
triangle."""

import math

import pytest
import torch

from benchmark.reference import render as ref


def mesh():
    from benchmark.harness import plugins
    return plugins.load("meshes", "dragon_class_mesh")


def camera(pos=(0.0, 0.0, -3.0), w=9, h=7, film_h=0.024, focal=0.055):
    f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    return {"pos": f(pos), "look_at": f([0.0, 0.0, 0.0]),
            "up": f([0.0, 1.0, 0.0]), "film_w": f(film_h * w / h),
            "film_h": f(film_h), "focal": f(focal), "res_w": w, "res_h": h}


def identity():
    return {"quat": torch.tensor([0.0, 0.0, 0.0, 1.0]),
            "translation": torch.zeros(3)}


def phong():
    return {"light_pos": torch.tensor([2.0, 2.0, 2.0]),
            "light_color": torch.tensor([1.0, 1.0, 1.0]),
            "diffuse": torch.tensor(0.6), "specular": torch.tensor(0.3),
            "exponent": torch.tensor(5.0)}


def tris_of(verts, color=(0.1, 0.55, 0.2)):
    v = torch.tensor(verts, dtype=torch.float32).reshape(-1, 3, 3)
    geom = torch.cat([v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], 1)
    return {"geom": geom, "color": torch.tensor(color).expand(
        v.shape[0], 3).contiguous()}


# a square of two triangles at z = 0, wound to face the camera at z = -3,
# shifted so that no ray runs along the diagonal they share
SQUARE = [[-0.9, -1, 0], [-0.9, 1, 0], [1.1, 1, 0],
          [-0.9, -1, 0], [1.1, 1, 0], [1.1, -1, 0]]


def test_centre_ray_hits_the_square_at_three():
    cam = camera()
    t, tri = ref.nearest_hits(tris_of(SQUARE), identity(), cam, cull=True)
    centre = 3 * 9 + 4                       # (ix, iy) = (4, 3)
    assert tri[centre] in (0, 1)
    assert abs(float(t[centre]) - 3.0) < 1e-6
    # the square fills the view: every ray hits, at t = 3 / cos(angle)
    d = ref.rays(cam)
    assert bool((tri >= 0).all())
    assert torch.allclose(t, 3.0 / d[:, 2], rtol=1e-6)


def test_cull_drops_a_square_facing_away():
    flipped = [v for tri in zip(*[iter(SQUARE)] * 3)
               for v in (tri[0], tri[2], tri[1])]
    t, tri = ref.nearest_hits(tris_of(flipped), identity(), camera(),
                              cull=True)
    assert bool((tri == -1).all()) and bool((t == ref.DRAW_DISTANCE).all())
    t2, tri2 = ref.nearest_hits(tris_of(flipped), identity(), camera(),
                                cull=False)
    assert bool((tri2 >= 0).all())


def test_nearest_wins_and_a_tie_goes_to_the_lowest_id():
    near = [[x, y, z - 1.0] for x, y, z in SQUARE]
    # triangles 0-1 the far square, 2-3 the near one, 4-5 the near again
    _, tri = ref.nearest_hits(tris_of(SQUARE + near + near), identity(),
                              camera(), cull=False)
    assert bool(((tri == 2) | (tri == 3)).all())


def test_pose_moves_the_rays_not_the_geometry():
    # the square turned 180 degrees about y faces away; the pose turns it
    # back
    back = [[-x, y, -z] for x, y, z in SQUARE]
    pose = {"quat": torch.tensor([0.0, 1.0, 0.0, 0.0]),
            "translation": torch.zeros(3)}
    _, tri = ref.nearest_hits(tris_of(back), pose, camera(), cull=True)
    assert bool((tri >= 0).all())


def test_shading_of_the_centre_pixel_by_hand():
    cam = camera()
    tris = tris_of(SQUARE)
    out = ref.render(tris, identity(), cam, phong(), cull=True)
    centre = 3 * 9 + 4
    # hit (0, 0, 0), normal e1 x e2 = (0, 0, -1), ray (0, 0, 1)
    p = torch.tensor([0.0, 0.0, float(out["t"][centre]) - 3.0])
    n = torch.tensor([0.0, 0.0, -1.0])
    d = torch.tensor([0.0, 0.0, 1.0])
    l = (torch.tensor([2.0, 2.0, 2.0]) - p)
    l = l / l.norm()
    c = float(l @ n)
    rsum = float(((l - 2 * c * n) * d).sum())
    spec = 0.3 * abs(rsum) ** 5
    want = [col * 0.6 * abs(c) + spec for col in (0.1, 0.55, 0.2)]
    got = out["radiance"][centre].tolist()
    assert got == pytest.approx(want, rel=1e-5)
    peak = max(want)
    assert out["image"][centre].tolist() == [round(x / peak * 255)
                                             for x in want]


def test_a_miss_is_background_and_zero_radiance():
    far = [[x + 10.0, y, z] for x, y, z in SQUARE]
    out = ref.render(tris_of(far), identity(), camera(), phong(), cull=True)
    assert bool((out["tri"] == -1).all())
    assert bool((out["radiance"] == 0).all())
    assert out["image"][0].tolist() == list(ref.BACKGROUND)


@pytest.mark.parametrize("cull", [False, True])
def test_hit_search_equals_every_pair_tested(cull):
    tv = torch.tensor(mesh().dragon_class_mesh(1200, seed=3))
    geom = torch.cat([tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]], 1)
    tris = {"geom": geom, "color": torch.ones(geom.shape[0], 3)}
    cam = camera(pos=(0.4, 0.3, -2.5), w=48, h=32)
    t, tri = ref.nearest_hits(tris, identity(), cam, cull)
    d = ref.rays(cam)
    # every ray against every triangle
    tt, ok = ref.mt(cam["pos"], d.repeat_interleave(geom.shape[0], 0),
                    geom.repeat(d.shape[0], 1))
    tt = torch.where(ok & (tt < ref.DRAW_DISTANCE), tt, math.inf).reshape(
        d.shape[0], geom.shape[0])
    if cull:
        nrm = torch.cross(geom[:, 3:6], geom[:, 6:9], dim=1)
        away = ((geom[:, 0:3] - cam["pos"]) * nrm).sum(1) > 0
        tt[:, away] = math.inf
    best = tt.min(1).values
    hit = torch.isfinite(best)
    assert torch.equal(tri >= 0, hit)
    assert torch.equal(t[hit], best[hit])
    low = torch.where(tt == best[:, None],
                      torch.arange(geom.shape[0]), 1 << 40).min(1).values
    assert torch.equal(tri[hit], low[hit])


def test_chunks_do_not_change_the_hits(monkeypatch):
    tv = torch.tensor(mesh().dragon_class_mesh(800, seed=1))
    geom = torch.cat([tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]], 1)
    tris = {"geom": geom, "color": torch.ones(geom.shape[0], 3)}
    cam = camera(w=40, h=30)
    whole = ref.nearest_hits(tris, identity(), cam, True)
    monkeypatch.setattr(ref, "PAIRS_PER_CHUNK", 97)
    parts = ref.nearest_hits(tris, identity(), cam, True)
    assert all(torch.equal(a, b) for a, b in zip(whole, parts))


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -3.14159265, 0.0])
    y = ref.tf32(x)
    assert y[:4].tolist() == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9]
    assert abs(float(y[4]) + 3.14159265) < 2**-9 * 4
    assert float(y[5]) == 0.0
    assert bool((y.view(torch.int32) & 0x1FFF == 0).all())
