"""The serving check judges each pixel's choice of triangle before its
colour: a different triangle passes only where it ties with the nearest
hit within rounding."""

import torch

from benchmark.harness import check


def frame(tri, image=None, t=None, margin=None, cos=None):
    n = len(tri)
    return {"tri": torch.tensor(tri),
            "image": torch.tensor(image or [[10, 20, 30]] * n,
                                  dtype=torch.uint8),
            "radiance": torch.full((n, 3), 0.5),
            "t": torch.tensor(t or [2.0] * n),
            "margin": torch.tensor(margin or [0.2] * n),
            "cos": torch.tensor(cos or [0.8] * n)}


def test_ties_pass_and_other_choices_do_not():
    e, eps_s = check.TIE_EDGE, check.TIE_SURFACE
    # pixel: 0 the same triangle; 1 another at a shared edge, on the
    # surface; 2 another well outside its edges; 3 another on its edge,
    # behind a hit well inside its own; 4 a grazed triangle in front; 5 the
    # next surface behind a grazed hit; 6 a hit on a grazed edge where the
    # reference misses; 7 a miss where the reference hits well inside; 8 a
    # miss where its hit grazes an edge; 9 the same triangle in another
    # colour; 10 both miss
    ref = frame([5, 5, 5, 5, 5, 5, -1, 5, 5, 5, -1],
                margin=[0.2] * 5 + [e / 2, 0.0, 0.3, e / 2, 0.2, 0.0],
                cos=[1.0] * 11)
    prog = frame([5, 6, 7, 8, 9, 4, 3, -1, -1, 5, -1],
                 image=[[10, 20, 30]] * 9 + [[10, 23, 30], [10, 20, 30]])
    chosen = frame([5, 6, 7, 8, 9, 4, 3, -1, -1, 5, -1],
                   t=[2.0, 2.0 * (1 + eps_s / 2), 2.0, 2.5, 1.5, 2.5, 2.5,
                      2.0, 2.0, 2.0, 2.0],
                   margin=[0.2, -e / 2, -0.1, 0.0, e / 2, 0.2, -e / 2, 0.0,
                           0.0, 0.2, 0.0],
                   cos=[1.0] * 11)
    out = check.frame_numbers(prog, ref, chosen)
    assert out["off"] == 4                      # pixels 2, 3, 7 and 9
    assert out["ties"] == {"shared_edge": 1, "grazed_front": 1,
                           "grazed_behind": 1, "edge_hit": 1,
                           "edge_miss": 1, "unsound": 3}


def test_the_edge_tolerance_scales_with_the_cosine():
    """A grazing ray (small |d . N|) rounds its barycentrics more: the same
    margin outside an edge is a tie there and not where the ray meets the
    plane square on."""
    e = check.TIE_EDGE
    ref = frame([5, 5], margin=[0.2, 0.2], cos=[1.0, 1.0])
    prog = frame([6, 6])
    chosen = frame([6, 6], t=[2.0, 2.0], margin=[-10 * e, -10 * e],
                   cos=[0.05, 1.0])
    out = check.frame_numbers(prog, ref, chosen)
    assert out["ties"]["shared_edge"] == 1 and out["ties"]["unsound"] == 1


def test_tie_summary_sums_counts():
    a = {"shared_edge": 1, "unsound": 0}
    b = {"shared_edge": 2, "unsound": 1}
    s = check.tie_summary([{"ties": a}, {"ties": b}])
    assert s == {"shared_edge": 3, "unsound": 1}
