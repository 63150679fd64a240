"""The plain reference renderer: primary rays, the nearest Möller–Trumbore
hit, Phong shading and the framebuffer, as the reference CUDA renderer
defines them (its README.md:8-19; Camera.cpp:32-72 for the camera,
Trixel.cu:106-127 for the acceptance test, Camera.cu:19-69 for the
shading). Plain PyTorch in float32 with TF32 off; it imports nothing of
the program under test and takes nothing the program made.

The nearest hit is found without an acceleration structure of the
program's kind: every triangle is tested against every pixel of its own
projected bounding box, widened by a pixel (all primary rays share the
camera's origin, so a ray can hit a triangle only inside that box). The
tests run in chunks of pairs, and the nearest valid hit of each pixel
wins, the lowest triangle id at an equal t.

Inputs are plain dicts of tensors:
- ``tris``: ``geom`` (T, 9) object-frame p1, e1 = p2 - p1, e2 = p3 - p1,
  and ``color`` (T, 3);
- ``pose``: ``quat`` (4,) as (x, y, z, w) and ``translation`` (3,), object
  to world; rays move into the object frame;
- ``camera``: ``pos``, ``look_at``, ``up`` (3,), ``film_w``, ``film_h``,
  ``focal`` (scalars), and the ints ``res_w``, ``res_h``;
- ``phong``: ``light_pos``, ``light_color`` (3,), ``diffuse``,
  ``specular``, ``exponent`` (scalars).

`tf32` rounds every input to TF32's 10-bit mantissa, as a TF32 tensor-core
product reads its operands: the reference computed one step of precision
below the configuration's, which is the control of the correctness check.
"""

from __future__ import annotations

import torch

MT_EPS = 1e-16              # the reference's acceptance epsilon
DRAW_DISTANCE = 400.0       # its ray termination distance
BACKGROUND = (240, 130, 0)  # its miss colour
PAIRS_PER_CHUNK = 1 << 24   # ray-triangle pairs tested at once
_NO_TRI = torch.iinfo(torch.int64).max


def tf32(x: torch.Tensor) -> torch.Tensor:
    """A float32 tensor rounded to TF32 (10 mantissa bits), to nearest
    even."""
    i = x.contiguous().view(torch.int32)
    r = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return r.view(torch.float32)


def rounded(d: dict) -> dict:
    """A copy of an input dict with every float tensor rounded by `tf32`."""
    return {k: tf32(v) if torch.is_tensor(v) and v.is_floating_point()
            else v for k, v in d.items()}


def rotation(quat: torch.Tensor) -> torch.Tensor:
    """3x3 rotation of the quaternion (x, y, z, w)."""
    x, y, z, w = quat.unbind(-1)
    return torch.stack((
        1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w,
        2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w,
        2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y,
    )).reshape(3, 3)


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _unit(a):
    inv = torch.rsqrt(_dot(a, a))
    return tuple(c * inv for c in a)


def _adjust(res: int) -> float:
    """The pixel-centre offset: res // 2, less half a pixel when even."""
    return res // 2 - (0.5 if res % 2 == 0 else 0.0)


def basis(camera: dict):
    """(n, u, v): view, screen-right and screen-up unit vectors."""
    n = _unit(tuple(camera["look_at"] - camera["pos"]))
    up = _unit(tuple(camera["up"]))
    v = _unit(_cross(n, _cross(up, n)))
    u = _cross(v, n)
    return n, u, v


def rays(camera: dict) -> torch.Tensor:
    """Unit world directions (H * W, 3) of every pixel; pixel i is
    (ix, iy) = (i % W, i // W), row 0 at the bottom."""
    w, h = camera["res_w"], camera["res_h"]
    n, u, v = basis(camera)
    pix_w, pix_h = camera["film_w"] / w, camera["film_h"] / h
    i = torch.arange(w * h, device=camera["pos"].device)
    ix = (i % w).to(torch.float32)
    iy = (i // w).to(torch.float32)
    d = [n[k] * camera["focal"] + u[k] * pix_w * (ix - _adjust(w))
         + v[k] * pix_h * (iy - _adjust(h)) for k in range(3)]
    return torch.stack(_unit(d), dim=-1)


def _object_frame(pose: dict, camera: dict, d: torch.Tensor):
    """The camera origin and ray directions in the object's frame:
    R^T (o - t) and R^T d."""
    r = rotation(pose["quat"])
    o = camera["pos"] - pose["translation"]
    o_obj = torch.stack([r[0, k] * o[0] + r[1, k] * o[1] + r[2, k] * o[2]
                         for k in range(3)])
    d_obj = torch.stack([r[0, k] * d[:, 0] + r[1, k] * d[:, 1]
                         + r[2, k] * d[:, 2] for k in range(3)], dim=-1)
    return o_obj, d_obj


def _boxes(geom: torch.Tensor, pose: dict, camera: dict):
    """Each triangle's pixel box (x0, x1, y0, y1), inclusive, widened by a
    pixel and clipped to the frame; a triangle with a vertex at or behind
    the camera's plane gets the whole frame."""
    w, h = camera["res_w"], camera["res_h"]
    r = rotation(pose["quat"])
    n, u, v = basis(camera)
    p1 = geom[:, 0:3]
    verts = torch.stack([p1, p1 + geom[:, 3:6], p1 + geom[:, 6:9]], dim=1)
    world = verts @ r.T + pose["translation"] - camera["pos"]
    depth = sum(world[..., k] * n[k] for k in range(3))
    sx = camera["focal"] * w / camera["film_w"]
    sy = camera["focal"] * h / camera["film_h"]
    safe = torch.clamp_min(depth, 1e-6)
    px = _adjust(w) + sx * sum(world[..., k] * u[k] for k in range(3)) / safe
    py = _adjust(h) + sy * sum(world[..., k] * v[k] for k in range(3)) / safe
    behind = (depth <= 1e-6).any(dim=1)
    big = float(4 * max(w, h))
    x0 = torch.floor(px.amin(1).clamp(-big, big)) - 1
    x1 = torch.ceil(px.amax(1).clamp(-big, big)) + 1
    y0 = torch.floor(py.amin(1).clamp(-big, big)) - 1
    y1 = torch.ceil(py.amax(1).clamp(-big, big)) + 1
    x0 = torch.where(behind, 0, x0.clamp_min(0)).long()
    y0 = torch.where(behind, 0, y0.clamp_min(0)).long()
    x1 = torch.where(behind, w - 1, x1.clamp_max(w - 1)).long()
    y1 = torch.where(behind, h - 1, y1.clamp_max(h - 1)).long()
    return x0, x1, y0, y1


def _mt_parts(o, d, g):
    """Möller–Trumbore's (det, u, v, t) of rays (o (3,) or (N, 3), d
    (N, 3)) against the planes of triangle rows ``g`` (N, 9)."""
    p1, e1, e2 = g[:, 0:3].T, g[:, 3:6].T, g[:, 6:9].T
    dd = d.T
    pvec = _cross(dd, e2)
    det = _dot(e1, pvec)
    tvec = tuple((o[k] if o.dim() == 1 else o[:, k]) - p1[k]
                 for k in range(3))
    qvec = _cross(tvec, e1)
    inv = 1.0 / torch.where(det == 0.0, 1.0, det)
    u = _dot(tvec, pvec) * inv
    v = _dot(dd, qvec) * inv
    t = _dot(e2, qvec) * inv
    return det, u, v, t


def mt(o, d, g):
    """Möller–Trumbore of rays (o (3,) or (N, 3), d (N, 3)) against
    triangle rows ``g`` (N, 9): (t, valid), two-sided, accepted where
    |det| >= eps, u >= eps, v >= eps, u + v <= 1 + eps and t >= eps."""
    det, u, v, t = _mt_parts(o, d, g)
    valid = ((det.abs() >= MT_EPS) & (u >= MT_EPS) & (v >= MT_EPS)
             & (u + v <= 1.0 + MT_EPS) & (t >= MT_EPS))
    return t, valid


@torch.no_grad()
def nearest_hits(tris: dict, pose: dict, camera: dict, cull: bool,
                 d: torch.Tensor | None = None):
    """(t (R,), tri (R,) int64): each pixel's nearest hit, -1 and
    `DRAW_DISTANCE` on a miss. ``cull`` drops the triangles that face away
    from the camera's origin, (e1 x e2) . (p1 - o) > 0 in the object frame
    (the configuration's backface cull)."""
    geom = tris["geom"]
    w, h = camera["res_w"], camera["res_h"]
    if d is None:
        d = rays(camera)
    o_obj, d_obj = _object_frame(pose, camera, d)
    x0, x1, y0, y1 = _boxes(geom, pose, camera)
    keep = (x0 <= x1) & (y0 <= y1)
    if cull:
        nrm = _cross(geom[:, 3:6].T, geom[:, 6:9].T)
        keep &= _dot(nrm, tuple(geom[:, k] - o_obj[k]
                                for k in range(3))) <= 0
    ids = torch.nonzero(keep).squeeze(1)
    bw = (x1 - x0 + 1)[ids]
    area = bw * (y1 - y0 + 1)[ids]
    ends = torch.cumsum(area, 0)
    found_t, found_pix, found_tri = [], [], []
    start_pair, lo = 0, 0
    total = int(ends[-1]) if ids.numel() else 0
    while start_pair < total:
        hi = int(torch.searchsorted(ends, start_pair + PAIRS_PER_CHUNK,
                                    right=True))
        hi = max(hi, lo + 1)
        cid = ids[lo:hi]
        carea = area[lo:hi]
        owner = torch.repeat_interleave(torch.arange(cid.numel(),
                                                     device=d.device), carea)
        first = torch.cumsum(carea, 0) - carea
        off = torch.arange(owner.numel(), device=d.device) - first[owner]
        tri = cid[owner]
        px = x0[tri] + off % bw[lo:hi][owner]
        py = y0[tri] + off // bw[lo:hi][owner]
        pix = py * w + px
        t, valid = mt(o_obj, d_obj[pix], geom[tri])
        valid &= t < DRAW_DISTANCE
        found_t.append(t[valid])
        found_pix.append(pix[valid])
        found_tri.append(tri[valid])
        start_pair = int(ends[hi - 1])
        lo = hi
    n_pix = w * h
    best_t = torch.full((n_pix,), DRAW_DISTANCE, device=d.device)
    best_tri = torch.full((n_pix,), -1, dtype=torch.int64, device=d.device)
    if found_t:
        t, pix, tri = (torch.cat(found_t), torch.cat(found_pix),
                       torch.cat(found_tri))
        best_t = best_t.scatter_reduce(0, pix, t, "amin")
        at = t == best_t[pix]
        low = torch.full((n_pix,), _NO_TRI, device=d.device).scatter_reduce(
            0, pix[at], tri[at], "amin")
        best_tri = torch.where(low == _NO_TRI, -1, low)
    return best_t, best_tri


def shade(tris: dict, pose: dict, camera: dict, phong: dict,
          hit_t: torch.Tensor, hit_tri: torch.Tensor,
          d: torch.Tensor | None = None, cosines: list | None = None
          ) -> torch.Tensor:
    """Phong radiance (R, 3) of each pixel's hit, 0 on a miss;
    differentiable in every input (the hit itself is discrete). The hit's
    t is computed again from its triangle where the test accepts it
    there, so that gradients reach the geometry, the pose and the camera.

    L = normalize(light - p), c = L . N, r = (L - 2 c N) * d,
    rgb = color * kd |c| * light_color + light_color * ks |sum r| ^ exp.

    ``cosines``: a list that gets |d . N| of each pixel's hit (0 on a
    miss) appended."""
    if d is None:
        d = rays(camera)
    hit = hit_tri >= 0
    idx = torch.clamp_min(hit_tri, 0)
    g = tris["geom"][idx]
    o_obj, d_obj = _object_frame(pose, camera, d)
    t_new, valid = mt(o_obj, d_obj, g)
    t = torch.where(valid & hit, t_new, hit_t)
    p = camera["pos"][None, :] + t[:, None] * d
    e1, e2 = g[:, 3:6].T, g[:, 6:9].T
    n_obj = _cross(e1, e2)
    inv = torch.rsqrt(torch.clamp_min(_dot(n_obj, n_obj), 1e-30))
    n_obj = tuple(c * inv for c in n_obj)
    r = rotation(pose["quat"])
    nrm = tuple(r[k, 0] * n_obj[0] + r[k, 1] * n_obj[1] + r[k, 2] * n_obj[2]
                for k in range(3))
    lp = phong["light_pos"]
    lv = _unit(tuple(lp[k] - p[:, k] for k in range(3)))
    c = _dot(lv, nrm)
    rsum = sum((lv[k] - 2.0 * c * nrm[k]) * d[:, k] for k in range(3))
    diffuse = phong["diffuse"] * c.abs()
    spec = phong["specular"] * rsum.abs() ** phong["exponent"]
    lc = phong["light_color"]
    col = tris["color"][idx]
    rgb = torch.stack([col[:, k] * diffuse * lc[k] + lc[k] * spec
                       for k in range(3)], dim=-1)
    if cosines is not None:
        cosines.append(torch.where(hit, _dot(tuple(d.T), nrm).abs(), 0.0))
    return torch.where(hit[:, None], rgb, 0.0)


def image(radiance: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """uint8 (R, 3): each hit's radiance over its largest channel, times
    255, rounded half to even; the background colour on a miss."""
    peak = radiance.amax(dim=-1, keepdim=True)
    shaded = torch.clamp(torch.round(
        radiance / torch.where(peak > 0, peak, 1.0) * 255.0), 0.0, 255.0)
    bg = torch.tensor(BACKGROUND, dtype=radiance.dtype,
                      device=radiance.device)
    return torch.where(hit[:, None], shaded, bg).to(torch.uint8)


@torch.no_grad()
def choice(tris: dict, pose: dict, camera: dict, phong: dict,
           hit_tri: torch.Tensor, d: torch.Tensor | None = None) -> dict:
    """This reference's frame of a given choice of triangle at each pixel
    (``hit_tri`` (R,), -1 a miss; another renderer's choice when judging
    it): flat ``t``, the distance to the chosen triangle's plane (its MT
    t; `DRAW_DISTANCE` on a miss), ``margin``, the ray's barycentric
    distance inside the triangle, min(u, v, 1 - u - v) (negative outside),
    ``cos`` |d . N|, and the ``radiance`` and ``image`` of that choice."""
    if d is None:
        d = rays(camera)
    hit = hit_tri >= 0
    g = tris["geom"][torch.clamp_min(hit_tri, 0)]
    o_obj, d_obj = _object_frame(pose, camera, d)
    _, u, v, t = _mt_parts(o_obj, d_obj, g)
    t = torch.where(hit, t, DRAW_DISTANCE)
    margin = torch.where(hit, torch.minimum(torch.minimum(u, v),
                                            1.0 - u - v), 0.0)
    cos: list = []
    rad = shade(tris, pose, camera, phong, t, hit_tri, d, cos)
    return {"t": t, "tri": hit_tri, "margin": margin, "cos": cos[0],
            "radiance": rad, "image": image(rad, hit)}


@torch.no_grad()
def render(tris: dict, pose: dict, camera: dict, phong: dict, cull: bool,
           precision: str = "float32") -> dict:
    """One frame: the nearest hits and `choice`'s frame of them (flat
    ``t``, ``tri``, ``margin``, ``cos``, ``radiance``, ``image``).
    ``precision`` "tf32" is the control: every input rounded by `tf32`."""
    if precision == "tf32":
        tris, pose, camera, phong = (rounded(x) for x in
                                     (tris, pose, camera, phong))
    elif precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    d = rays(camera)
    t, tri = nearest_hits(tris, pose, camera, cull, d)
    return dict(choice(tris, pose, camera, phong, tri, d), t=t)


def loss(tris: dict, pose: dict, camera: dict, phong: dict, cull: bool,
         target: torch.Tensor, keep: torch.Tensor | None = None
         ) -> torch.Tensor:
    """The fitting loss mean((radiance - target) ** 2) over every pixel and
    channel; ``target`` (R, 3). Differentiable in the float inputs.
    ``keep`` (R,) bool: the mean over those pixels alone."""
    d = rays(camera)
    t, tri = nearest_hits(tris, pose, camera, cull, d.detach())
    rad = shade(tris, pose, camera, phong, t, tri, d)
    if keep is not None:
        rad, target = rad[keep], target[keep]
    return torch.mean((rad - target) ** 2)
