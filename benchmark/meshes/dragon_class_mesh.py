"""The stand-in for the reference's Stanford dragon (800k primitives, its
README.md:19), whose PLY the repository does not hold: a UV sphere with
welded radial noise, frozen here as a pure-numpy copy of the port's
procedural generator (``utils/procgen.py``), so that the yardstick does
not move when the program's own generator changes.
``dragon_class_mesh(800_000)`` has 800,130 triangles."""

from __future__ import annotations

import numpy as np


def uv_sphere(lat: int, lon: int, radius: float = 1.0,
              roughness: float = 0.0, seed: int = 0) -> np.ndarray:
    """(2 * lat * lon, 3, 3) float32 triangles: a lat x lon quad grid over
    the sphere, each quad split in two; ``roughness`` displaces the
    vertices radially by seeded noise, welded at the seam and the poles so
    that the surface stays closed."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(0.0, np.pi, lat + 1)
    phi = np.linspace(0.0, 2 * np.pi, lon + 1)
    t, p = np.meshgrid(theta, phi, indexing="ij")
    if roughness:
        noise = rng.standard_normal(t.shape)
        noise[:, -1] = noise[:, 0]
        noise[0, :] = noise[0, 0]
        noise[-1, :] = noise[-1, 0]
        r = radius * (1.0 + roughness * noise)
    else:
        r = radius
    x = r * np.sin(t) * np.cos(p)
    y = r * np.cos(t)
    z = r * np.sin(t) * np.sin(p)
    v = np.stack([x, y, z], axis=-1).astype(np.float32)
    a, b, c, d = v[:-1, :-1], v[:-1, 1:], v[1:, 1:], v[1:, :-1]
    t1 = np.stack([a, b, c], axis=2)
    t2 = np.stack([a, c, d], axis=2)
    tris = np.concatenate([t1[:, :, None], t2[:, :, None]], axis=2)
    return tris.reshape(-1, 3, 3)


def dragon_class_mesh(num_tris: int = 800_000, seed: int = 0) -> np.ndarray:
    """A closed mesh of about ``num_tris`` triangles (within one row)."""
    lat = int(np.sqrt(num_tris / 4))
    lon = int(np.ceil(num_tris / (2 * lat)))
    return uv_sphere(lat, lon, roughness=0.03, seed=seed)


def vertices(params: dict) -> np.ndarray:
    """``params``: ``triangles`` (the count asked for) and ``seed``."""
    return dragon_class_mesh(params["triangles"], params["seed"])
