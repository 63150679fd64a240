"""The training shading: `shade_hits` and `compose_framebuffer` as one
``torch.autograd.Function`` of two hand-written launches, kernel K10 forward
and kernel K12 backward (``csrc/shade.cu``), in place of some 800 autograd
nodes a step.

- Forward: `shade_compose` (``ops/cuda/shade.py``): K10 on CUDA tensors,
  the plain ``models/renderer.py`` `shade_compose_reference` on CPU tensors;
  the outputs are bitwise the autograd chain's. Nothing is gathered or
  packed: the backward recomputes each ray from its hit, as K10 does.
- Backward: K12 (``ops/cuda/shade.py`` `shade_grad`) on CUDA tensors,
  its plain twin `shade_grad_reference` on CPU tensors; the two agree bit
  for bit. Either writes, for every ray, the cotangent of its direction
  ``rmd``, one column a ray of the partials of every scalar leaf (`GRAD_COLS` of the world origin and the Phong
  parameters, then `OBJ_GRAD_COLS` an object of its rotation matrix R and
  its object-frame origin R^T (o - t)), and, where a triangle table needs
  a gradient, the (R, 12) cotangent rows of the hit triangle's leaves in
  ``ops/gather.py``'s packed order. The backward is itself not
  differentiable (``once_differentiable``): a second derivative through
  the training shading raises.
- What stays plain PyTorch, the same on both routes: the sum of the
  partials over the rays (one ``torch.sum``, no float atomics, so a step
  repeats bitwise), the triangle rows' segment sums (``ops/gather.py``
  `segment_sum_rows`: a stable sort and kernel K2; ``index_add_`` where
  `shade_hits` takes `take_rows`), and the chain from each object's R and
  origin to its quaternion and translation (`_pose_grads`).

The twin follows autograd's conventions: ``torch.where``'s masks, ``abs``'s
sgn(0) = 0, ``clamp_min``'s gradient 0 below the clamp, ``rsqrt``'s
-x^3 / 2, ``reciprocal(where(det == 0, 1, det))``, and ``pow``'s exponent
gradient 0 where the base is 0 (``pow_backward_exponent``). Its order of
operations is K12's: every product and sum its own rounding, dots summed
as (x + y) + z.

``models/renderer.py`` `shade_and_compose` takes `shade_compose_grad`
when autograd is on and an input requires grad; ``.plain`` on it counts
the CUDA backward passes that did not launch K12.
"""

from __future__ import annotations

import torch

from ..ops import gather
from ..ops.cuda import shade as k10
from ..ops.cuda.shade import GRAD_COLS, OBJ_GRAD_COLS
from ..ops.intersect import Hit
from ..ops.quaternion import to_matrix

_TABLES = ("p1x", "p1y", "p1z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z",
           "color")
_PHONG = ("light_pos", "light_color", "diffuse", "specular", "exponent")
# the Function's arguments: scene, config, hit.tri, hit.obj, then these,
# then the Phong leaves and each object's quaternion, translation, tables
_ORIGIN, _RMD, _HIT_T, _LEAD = 4, 5, 6, 7
_PER_OBJ = 2 + len(_TABLES)
_K12 = k10.shade_grad   # K12's wrapper, whose counter a test's patch keeps


def _cross(a, b):
    """a x b on (x, y, z) tuples, each component a0 b1 - a1 b0."""
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def shade_grad_reference(scene, origin, rmd, hit, config, cts, rows: bool,
                         ray_ct: bool, tri_ct: bool, hit_t_ct: bool):
    """Kernel K12's plain twin: the backward of `shade_compose` for the
    unit rays ``rmd`` (R, 3) from ``origin`` and their ``hit`` over
    ``scene``'s objects. ``cts``: the cotangents of radiance, normal and
    point, (R, 3) each or None. Returns (partials (GRAD_COLS +
    OBJ_GRAD_COLS * n, R), or None without ``rows``; consts (n, 12), each
    object's R and o - t; the cotangents of ``rmd`` (R, 3), of the
    tables' rows (R, 12) and of ``hit.t`` (R,), each None unless
    ``ray_ct``, ``tri_ct``, ``hit_t_ct``)."""
    dt, dev = rmd.dtype, rmd.device
    num_r = rmd.shape[0]
    eps = config.eps
    g_rad, g_nrm, g_pnt = cts
    rmd, origin = rmd.detach(), origin.detach().to(dt)
    lp, lc, kd, ks, ex = (getattr(scene.phong, f).detach().to(dt)
                          for f in _PHONG)
    zero = torch.zeros((num_r,), dtype=dt, device=dev)
    tri_idx = torch.clamp_min(hit.tri, 0)
    d = rmd.unbind(1)
    shared = [zero] * GRAD_COLS
    cols, consts = [], []
    g_rmd, g_rows, g_ht = [zero] * 3, [zero] * 12, zero
    for oi, obj in enumerate(scene.objects):
        mask = (hit.obj == oi) & (hit.tri >= 0)
        tables = [getattr(obj.tris, f).detach() for f in _TABLES]
        # the forward, as models/renderer.py shade_hits computes it
        m = to_matrix(obj.pose.quat.detach())
        v_o = origin - obj.pose.translation.detach().to(dt)
        oo = v_o @ m
        consts.append(torch.cat([m.reshape(9), v_o]))
        leaf = [t.index_select(0, tri_idx) for t in tables]
        p1, e1, e2 = leaf[0:3], leaf[3:6], leaf[6:9]
        col = leaf[9].unbind(1)
        dd = tuple(m[0, j] * d[0] + m[1, j] * d[1] + m[2, j] * d[2]
                   for j in range(3))
        tv = tuple(oo[k] - p1[k] for k in range(3))
        pv = _cross(dd, e2)
        det = _dot(e1, pv)
        qv = _cross(tv, e1)
        inv = torch.reciprocal(torch.where(det == 0.0, 1.0, det))
        u = _dot(tv, pv) * inv
        v = _dot(dd, qv) * inv
        e_t = _dot(e2, qv)
        t_mt = e_t * inv
        sel = ((det.abs() >= eps) & (u >= eps) & (v >= eps)
               & (u + v <= 1.0 + eps) & (t_mt >= eps)) & mask
        t = torch.where(sel, t_mt, hit.t)
        p = tuple(origin[k] + t * d[k] for k in range(3))
        cn = _cross(e1, e2)
        cs = _dot(cn, cn)
        inv_n = torch.rsqrt(torch.clamp_min(cs, 1e-30))
        n_ = tuple(c * inv_n for c in cn)
        nw = tuple(m[i, 0] * n_[0] + m[i, 1] * n_[1] + m[i, 2] * n_[2]
                   for i in range(3))

        # the backward, in K12's order
        g_nw, g_p, g_d = [zero] * 3, [zero] * 3, [zero] * 3
        g_lp, g_lc, g_col = [zero] * 3, [zero] * 3, [zero] * 3
        g_kd = g_ks = g_ex = zero
        if g_rad is not None:
            l_ = tuple(lp[k] - p[k] for k in range(3))
            inv_len = torch.rsqrt(_dot(l_, l_))
            lh = tuple(x * inv_len for x in l_)
            dot = _dot(lh, nw)
            two = 2.0 * dot
            r = tuple(lh[k] - two * nw[k] for k in range(3))
            rsum = _dot(r, d)
            dif = kd * dot.abs()
            a = rsum.abs()
            pw = torch.pow(a, ex)
            spec = ks * pw
            gr = g_rad.unbind(1)
            ga = tuple(gr[k] * lc[k] for k in range(3))
            g_col = [ga[k] * dif for k in range(3)]
            g_dif = _dot(ga, col)
            g_lc = [gr[k] * (col[k] * dif) + gr[k] * spec for k in range(3)]
            g_spec = (ga[0] + ga[1]) + ga[2]
            g_ks = g_spec * pw
            g_pw = g_spec * ks
            g_a = torch.where(ex == 0.0, 0.0,
                              g_pw * (ex * torch.pow(a, ex - 1.0)))
            g_ex = g_pw * torch.where((a == 0.0) & (ex >= 0.0), 0.0,
                                      pw * torch.log(a))
            g_rsum = g_a * torch.sign(rsum)
            g_kd = g_dif * dot.abs()
            g_dot = (g_dif * kd) * torch.sign(dot)
            g_r = tuple(g_rsum * d[k] for k in range(3))
            g_d = [g_rsum * r[k] for k in range(3)]
            g_two = -_dot(g_r, nw)
            g_nw = [-(g_r[k] * two) for k in range(3)]
            g_dot = g_dot + 2.0 * g_two
            g_lh = tuple(g_r[k] + g_dot * nw[k] for k in range(3))
            g_nw = [g_nw[k] + g_dot * lh[k] for k in range(3)]
            g_l = [g_lh[k] * inv_len for k in range(3)]
            g_ls = (-0.5 * _dot(g_lh, l_)) * (inv_len * inv_len * inv_len)
            g_l = [g_l[k] + (2.0 * g_ls) * l_[k] for k in range(3)]
            g_lp = g_l
            g_p = [-x for x in g_l]
        if g_nrm is not None:
            g_nw = [g_nw[k] + x for k, x in enumerate(g_nrm.unbind(1))]
        if g_pnt is not None:
            g_p = [g_p[k] + x for k, x in enumerate(g_pnt.unbind(1))]
        g_t = _dot(g_p, d)
        g_d = [g_d[k] + g_p[k] * t for k in range(3)]
        g_m = [g_nw[i] * n_[j] for i in range(3) for j in range(3)]
        g_n = tuple(g_nw[0] * m[0, j] + g_nw[1] * m[1, j] + g_nw[2] * m[2, j]
                    for j in range(3))
        g_cn = [g_n[k] * inv_n for k in range(3)]
        g_cs = torch.where(cs >= 1e-30, (-0.5 * _dot(g_n, cn))
                           * (inv_n * inv_n * inv_n), 0.0)
        g_cn = tuple(g_cn[k] + (2.0 * g_cs) * cn[k] for k in range(3))
        g_e1 = list(_cross(e2, g_cn))
        g_e2 = list(_cross(g_cn, e1))
        g_tm = torch.where(sel, g_t, 0.0)
        g_e = g_tm * inv
        g_det = torch.where(det == 0.0, 0.0,
                            -((g_tm * e_t) * (inv * inv)))
        g_e2 = [g_e2[k] + g_e * qv[k] for k in range(3)]
        g_qv = tuple(g_e * e2[k] for k in range(3))
        g_e1 = [g_e1[k] + g_det * pv[k] for k in range(3)]
        g_pv = tuple(g_det * e1[k] for k in range(3))
        g_tv = _cross(e1, g_qv)
        g_e1 = [g_e1[k] + x for k, x in enumerate(_cross(g_qv, tv))]
        g_dd = _cross(e2, g_pv)
        g_e2 = [g_e2[k] + x for k, x in enumerate(_cross(g_pv, dd))]
        g_m = [g_m[3 * i + j] + g_dd[j] * d[i] for i in range(3)
               for j in range(3)]
        g_d = [g_d[i] + (m[i, 0] * g_dd[0] + m[i, 1] * g_dd[1]
                         + m[i, 2] * g_dd[2]) for i in range(3)]

        def keep(xs, acc):
            return [torch.where(mask, x, a) for x, a in zip(xs, acc)]
        shared = keep([*g_p, *g_lp, *g_lc, g_kd, g_ks, g_ex], shared)
        cols += keep([*g_m, *g_tv], [zero] * OBJ_GRAD_COLS)
        g_rmd = keep(g_d, g_rmd)
        g_rows = keep([*(-x for x in g_tv), *g_e1, *g_e2, *g_col], g_rows)
        g_ht = torch.where(mask & ~sel, g_t, g_ht)
    return (torch.stack(shared + cols) if rows else None,
            torch.stack(consts), torch.stack(g_rmd, 1) if ray_ct else None,
            torch.stack(g_rows, 1) if tri_ct else None,
            g_ht if hit_t_ct else None)


def _pose_grads(sums, consts, quats):
    """Each object's (quaternion, translation) gradients and the world
    origin's share through the objects, from the summed partials ``sums``
    of R and of R^T (o - t) and each object's R and o - t (``consts``)."""
    n = consts.shape[0]
    g_obj = sums[GRAD_COLS:].reshape(n, OBJ_GRAD_COLS)
    m = consts[:, :9].reshape(n, 3, 3)
    v = consts[:, 9:]
    g_oo = g_obj[:, 9:]
    g_v = (m @ g_oo.unsqueeze(-1)).squeeze(-1)
    g = g_obj[:, :9].reshape(n, 3, 3) + v.unsqueeze(-1) * g_oo.unsqueeze(1)
    # d R(q) / d q for R of ops/quaternion.py to_matrix: with A = G + G^T,
    # D = G - G^T and its axial vector a, g_xyz = 2 (A xyz - 2 tr(G) xyz
    # + w a) and g_w = 2 a . xyz
    q = torch.stack(quats)
    xyz, w = q[:, :3], q[:, 3:]
    gt = g.transpose(1, 2)
    sym, skew = g + gt, g - gt
    axial = torch.stack([skew[:, 2, 1], skew[:, 0, 2], skew[:, 1, 0]], 1)
    trace = g.diagonal(dim1=1, dim2=2).sum(1, keepdim=True)
    g_xyz = 2.0 * ((sym @ xyz.unsqueeze(-1)).squeeze(-1)
                   - (2.0 * trace) * xyz + w * axial)
    g_w = 2.0 * (axial * xyz).sum(1, keepdim=True)
    return torch.cat([g_xyz, g_w], 1), -g_v, g_v.sum(0)


class _ShadeCompose(torch.autograd.Function):
    """K10 forward, K12 backward (the module's docstring)."""

    @staticmethod
    def forward(ctx, scene, config, hit_tri, hit_obj, origin, rmd, hit_t,
                *leaves):
        ctx.set_materialize_grads(False)
        hit = Hit(t=hit_t, tri=hit_tri, obj=hit_obj)
        out = k10.shade_compose(scene, origin, rmd, hit, config)
        ctx.mark_non_differentiable(out["image"])
        ctx.scene, ctx.config = scene, config
        ctx.save_for_backward(origin, rmd, hit_t, hit_tri, hit_obj, *leaves)
        return out["image"], out["radiance"], out["normal"], out["point"]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, _g_image, g_rad, g_nrm, g_pnt):
        n_in = len(ctx.needs_input_grad)
        if g_rad is None and g_nrm is None and g_pnt is None:
            return (None,) * n_in
        origin, rmd, hit_t, hit_tri, hit_obj, *leaves = ctx.saved_tensors
        need = ctx.needs_input_grad
        n_p = len(_PHONG)
        n_obj = (len(leaves) - n_p) // _PER_OBJ
        per = [leaves[n_p + _PER_OBJ * i:n_p + _PER_OBJ * (i + 1)]
               for i in range(n_obj)]
        base = _LEAD + n_p
        obj_need = [need[base + _PER_OBJ * i:base + _PER_OBJ * (i + 1)]
                    for i in range(n_obj)]
        rows = need[_ORIGIN] or any(need[_LEAD:base]) or any(
            any(on[:2]) for on in obj_need)
        tri_ct = any(any(on[2:]) for on in obj_need)
        hit = Hit(t=hit_t, tri=hit_tri, obj=hit_obj)
        on_card = rmd.device.type == "cuda"
        before = _K12.launches
        partials, consts, g_rmd, g_rows, g_ht = (
            k10.shade_grad if on_card else shade_grad_reference)(
            ctx.scene, origin, rmd, hit, ctx.config, (g_rad, g_nrm, g_pnt),
            rows, need[_RMD], tri_ct, need[_HIT_T])
        if on_card and _K12.launches == before:
            shade_compose_grad.plain += 1

        grads = [None] * n_in
        grads[_RMD], grads[_HIT_T] = g_rmd, g_ht
        if rows:
            sums = partials.sum(dim=1)
            g_q, g_t, g_o = _pose_grads(sums, consts, [o[0] for o in per])
            if need[_ORIGIN]:
                grads[_ORIGIN] = (sums[0:3] + g_o).to(origin.dtype)
            phong_g = (sums[3:6], sums[6:9], sums[9], sums[10], sums[11])
            for k, (x, g) in enumerate(zip(leaves[:n_p], phong_g)):
                if need[_LEAD + k]:
                    grads[_LEAD + k] = g.to(x.dtype)
        for oi, (on, (quat, trans, *tables)) in enumerate(zip(obj_need,
                                                               per)):
            at = base + _PER_OBJ * oi
            if on[0]:
                grads[at] = g_q[oi].to(quat.dtype)
            if on[1]:
                grads[at + 1] = g_t[oi].to(trans.dtype)
            if any(on[2:]):
                seg = _table_sums(g_rows, hit_tri, hit_obj, oi,
                                  tables[0].shape[0], ctx.config, rmd.dtype)
                for k, table in enumerate(tables):
                    if on[2 + k]:
                        grads[at + 2 + k] = (seg[:, k] if k < 9 else
                                             seg[:, 9:12]).to(table.dtype)
        return tuple(grads)


def _table_sums(g_rows, hit_tri, hit_obj, oi: int, t_rows: int, config,
                dtype) -> torch.Tensor:
    """(t_rows, 12) sums of object ``oi``'s cotangent rows by triangle, as
    `shade_hits`'s gather backward sums them: K2's segment sum in float32
    with ``sorted_scatter``, ``index_add_`` otherwise. Rays of other
    objects and misses go to a row past the table, which is dropped."""
    idx = torch.where(hit_obj == oi, hit_tri, t_rows)
    if config.sorted_scatter and dtype == torch.float32:
        return gather.segment_sum_rows(g_rows, idx, t_rows + 1)[:t_rows]
    out = torch.zeros((t_rows + 1, 12), dtype=g_rows.dtype,
                      device=g_rows.device)
    return out.index_add_(0, idx, g_rows)[:t_rows]


def shade_compose_grad(scene, origin: torch.Tensor, rmd: torch.Tensor, hit,
                       config) -> dict:
    """`shade_compose`'s dict of flat per-ray outputs, differentiable in
    ``origin``, ``rmd``, ``hit.t`` and every leaf of ``scene`` through
    `_ShadeCompose` (K10 forward, K12 backward on the card)."""
    leaves = [getattr(scene.phong, f) for f in _PHONG]
    for obj in scene.objects:
        leaves += [obj.pose.quat, obj.pose.translation,
                   *(getattr(obj.tris, f) for f in _TABLES)]
    image, radiance, normal, point = _ShadeCompose.apply(
        scene, config, hit.tri, hit.obj, origin, rmd, hit.t, *leaves)
    return dict(image=image, radiance=radiance, hit_t=hit.t, hit_tri=hit.tri,
                hit_obj=hit.obj, normal=normal, point=point)


shade_compose_grad.plain = 0
