"""The numbers that decide ``correct``, each against its limit
(``limits/<cell>.json``, set from the readings of sound runs and of the
control, the reference in TF32; see PERF.md).

Serving (frames of the window against the reference on the same pose).
The reference judges each pixel's choice of triangle first, then renders
that choice. A choice is sound where it is the reference's nearest hit or
differs from it only by rounding: the rays of two renderers that compute
Moller-Trumbore in another order part only where a ray passes within
rounding of a triangle's edge. So another triangle is sound where the ray
meets it inside its edges, within `TIE_EDGE`, and
- meets it on the surface of the reference's nearest hit, within
  `TIE_SURFACE` (a shared edge); or
- meets it in front of the reference's hit, within `TIE_EDGE` of its edge
  (a grazed triangle the reference missed); or
- meets it behind a reference hit that is within `TIE_EDGE` of its own
  edge (the grazed nearest missed, the next surface found);
a hit where the reference misses is sound within `TIE_EDGE` of the
triangle's edge, and a miss where it hits, within `TIE_EDGE` of that
hit's edge. The distance from an edge is the barycentric margin
min(u, v, 1 - u - v) times |d . N|: rounding moves u and v by about the
unit roundoff over the ray's cosine with the plane's normal.
- ``pixel_off_share``: the share of pixels whose choice is not sound, or
  whose image differs from the reference's image of the choice by more
  than one step of 255 in a channel;
- ``radiance_gap``: the largest gap of a radiance channel on the pixels
  that hit a soundly chosen triangle;
- ``surface_gap``: the largest gap between the program's hit point and the
  reference's on that triangle there, along the triangle's normal, over
  the distance: |t - t_ref| |d . N| / t_ref (a ray that grazes a plane
  fixes its distance along the ray only to rounding over the cosine; its
  distance from the plane it fixes well).

Training (the first three steps of the step object the window runs,
against the reference's three SGD steps from the same parameters):
- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the first gradient, by the worst leaf: the gap between the
  norms of the program's and the reference's gradient of a leaf, over the
  larger of the reference's norm of that leaf and of the median leaf;
- ``change_gap``: the parameters' change over the three steps, by the
  median leaf: the same gap of each leaf's change, over the leaves whose
  reference gradient is at least a thousandth of the median leaf's, and
  the median of those gaps. Not the worst leaf: an SGD update of a few
  float32 spacings of its leaf's values (the camera's up and focal length,
  the quaternion's w) rounds by a spacing more or less on either side, so
  the worst leaf reads rounding, up to 6e-2 on sound runs (PERF.md).
"""

from __future__ import annotations

import math

import torch


# ties (PERF.md gives the readings they were set from)
TIE_EDGE = 3e-4         # barycentric margin times |d . N|
TIE_SURFACE = 3e-5      # distance from the nearest hit, normal, over t


def choices(prog: dict, ref: dict, chosen: dict) -> dict:
    """Each pixel's kind of choice (bool (R,) each): ``same`` as the
    reference, a ``shared_edge``, a ``grazed_front``, a ``grazed_behind``,
    an ``edge_hit`` or an ``edge_miss`` tie; ``sound``, any of them."""
    a, b = prog["tri"].long(), ref["tri"]
    hit_a, hit_b = a >= 0, b >= 0
    both = hit_a & hit_b & (a != b)
    edge_a = chosen["margin"] * chosen["cos"]
    edge_b = ref["margin"] * ref["cos"]
    inside = edge_a >= -TIE_EDGE
    near = ((chosen["t"] - ref["t"]).abs() * ref["cos"]
            <= TIE_SURFACE * ref["t"])
    out = {"same": a == b,
           "shared_edge": both & inside & near,
           "grazed_front": both & inside & (edge_a <= TIE_EDGE)
           & (chosen["t"] < ref["t"]),
           "grazed_behind": both & inside & (edge_b <= TIE_EDGE)
           & (chosen["t"] > ref["t"]),
           "edge_hit": hit_a & ~hit_b & (edge_a.abs() <= TIE_EDGE),
           "edge_miss": ~hit_a & hit_b & (edge_b <= TIE_EDGE)}
    sound = torch.zeros_like(hit_a)
    for v in out.values():
        sound |= v
    out["sound"] = sound
    return out


def frame_numbers(prog: dict, ref: dict, chosen: dict) -> dict:
    """Counts and gaps of one frame. ``prog`` holds flat ``image`` (R, 3)
    uint8, ``radiance`` (R, 3), ``t`` (R,) and ``tri`` (R,); ``ref`` is the
    reference's frame and ``chosen`` its frame of the program's choice of
    triangles (`reference.render` and `reference.choice`: ``t``, ``tri``,
    ``margin``, ``cos``, ``radiance``, ``image``)."""
    kinds = choices(prog, ref, chosen)
    sound = kinds["sound"]
    off = ~sound | ((prog["image"].int() - chosen["image"].int()).abs()
                    .amax(-1) > 1)
    on = sound & (prog["tri"] >= 0)
    rad = (prog["radiance"] - chosen["radiance"]).abs().amax(-1)[on]
    t = ((prog["t"] - chosen["t"]).abs() * chosen["cos"] / chosen["t"])[on]
    ties = {k: int(v.sum()) for k, v in kinds.items()
            if k not in ("same", "sound")}
    ties["unsound"] = int((~sound).sum())
    return {"off": int(off.sum()), "pixels": off.numel(),
            "radiance_gap": float(rad.max()) if rad.numel() else 0.0,
            "surface_gap": float(t.max()) if t.numel() else 0.0,
            "ties": ties}


def tie_summary(frames: list) -> dict:
    """The frames' counts of each kind of tie, and of unsound choices,
    summed (logged, not compared)."""
    out: dict = {}
    for f in frames:
        for k, v in f["ties"].items():
            out[k] = out.get(k, 0) + v
    return out


def serve_numbers(frames: list) -> dict:
    if not frames:
        return {"pixel_off_share": math.nan, "radiance_gap": math.nan,
                "surface_gap": math.nan}
    return {"pixel_off_share": sum(f["off"] for f in frames)
            / sum(f["pixels"] for f in frames),
            "radiance_gap": max(f["radiance_gap"] for f in frames),
            "surface_gap": max(f["surface_gap"] for f in frames)}


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def worst_leaf(prog: dict, ref: dict, keys) -> tuple[float, str]:
    """(the largest gap of a leaf's norm, that leaf): |program's norm -
    reference's| over the larger of the reference's norm of the leaf and
    of the median leaf."""
    if not keys:
        return math.nan, ""
    pn, rn = _norms({k: prog[k] for k in keys}), _norms(
        {k: ref[k] for k in keys})
    median = sorted(rn.values())[len(rn) // 2]
    return max((abs(pn[k] - rn[k]) / max(rn[k], median, 1e-300), k)
               for k in keys)


def median_leaf(prog: dict, ref: dict, keys) -> float:
    """The median over ``keys`` of the gaps `worst_leaf` takes the largest
    of."""
    if not keys:
        return math.nan
    pn, rn = _norms({k: prog[k] for k in keys}), _norms(
        {k: ref[k] for k in keys})
    median = sorted(rn.values())[len(rn) // 2]
    gaps = sorted(abs(pn[k] - rn[k]) / max(rn[k], median, 1e-300)
                  for k in keys)
    return gaps[len(gaps) // 2]


def moved_leaves(ref: dict) -> list[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    gn = _norms(ref["grad"])
    median = sorted(gn.values())[len(gn) // 2]
    return [k for k in sorted(gn) if gn[k] >= 1e-3 * median]


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` hold ``losses`` (three floats), ``grad`` (leaf
    -> the first step's gradient) and ``change`` (leaf -> parameters after
    three steps less before)."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in
                   zip(prog["losses"], ref["losses"]))
    return {"loss_gap": loss_gap,
            "grad_gap": worst_leaf(prog["grad"], ref["grad"],
                                   sorted(ref["grad"]))[0],
            "change_gap": median_leaf(prog["change"], ref["change"],
                                      moved_leaves(ref))}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number finite and at most its limit, {name: {"value",
    "limit"}}); a number with no limit fails."""
    out, ok = {}, True
    for k, v in numbers.items():
        lim = limits.get(k, {}).get("limit")
        out[k] = {"value": v, "limit": lim}
        ok &= lim is not None and math.isfinite(v) and v <= lim
    return ok, out
