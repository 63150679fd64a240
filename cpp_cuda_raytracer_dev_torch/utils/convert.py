"""Scene and camera to and from the JAX package's parameters, as numpy
arrays.

The dict holds numpy arrays keyed by pytree path, with the path's entries
joined by dots: ``objects.0.tris.p1x``, ``objects.0.pose.quat``,
``phong.light_pos``, ``pos``, ``film_w``. `path_dict` makes that dict from
``jax.tree_util.tree_flatten_with_path(tree)[0]`` without importing JAX.
The port's module attributes follow the same paths, so `params_to_numpy`
(parameters or their gradients) gives the same keys back.

`cluster_accel_from_numpy` takes the JAX ``ClusterAccel``'s arrays, so a
test can feed both packages the identical cluster structure.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..accel.traverse import ClusterAccel
from ..models.camera import Camera
from ..models.scene import (TRI_FIELDS, PhongParams, Scene, SceneObject,
                            Triangles)
from ..ops.quaternion import Pose

_PHONG_FIELDS = ("light_pos", "light_color", "diffuse", "specular",
                 "exponent")


def _key_name(k) -> str:
    for attr in ("name", "idx", "key"):     # GetAttrKey, SequenceKey, DictKey
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def path_dict(path_leaves) -> dict[str, np.ndarray]:
    """[(key path, leaf), ...] -> {"a.0.b": numpy array}."""
    return {".".join(_key_name(k) for k in path): np.asarray(leaf)
            for path, leaf in path_leaves}


def scene_from_numpy(d: dict, device) -> Scene:
    def t(key):
        return torch.tensor(np.asarray(d[key]), device=device)

    n_obj = 1 + max(int(k.split(".")[1]) for k in d
                    if k.startswith("objects."))
    objects = []
    for i in range(n_obj):
        pre = f"objects.{i}."
        tris = Triangles(*(t(pre + "tris." + f) for f in TRI_FIELDS),
                         t(pre + "tris.color"))
        pose = Pose(t(pre + "pose.quat"), t(pre + "pose.translation"))
        objects.append(SceneObject(tris, pose))
    phong = PhongParams(*(t("phong." + f) for f in _PHONG_FIELDS))
    return Scene(objects, phong)


def camera_from_numpy(d: dict, device) -> Camera:
    """The JAX Camera's leaves plus its static ``res_w`` and ``res_h``
    (which are not pytree leaves) as ints."""
    return Camera(**{f: torch.tensor(np.asarray(d[f]), device=device)
                     for f in Camera.LEAVES},
                  res_w=int(d["res_w"]), res_h=int(d["res_h"]))


def params_to_numpy(module: nn.Module, grad: bool = False
                    ) -> dict[str, np.ndarray]:
    """A Scene's or a Camera's parameters, or with ``grad`` their ``.grad``
    (zeros where there is none), as numpy arrays keyed by the JAX pytree
    paths that `scene_from_numpy` / `camera_from_numpy` read."""
    out = {}
    for name, p in module.named_parameters():
        x = p if not grad else (p.grad if p.grad is not None
                                else torch.zeros_like(p))
        out[name] = x.detach().cpu().numpy()
    return out


def cluster_accel_from_numpy(d: dict, device) -> ClusterAccel:
    """The JAX ``ClusterAccel``'s fields as numpy arrays (``bounds_min``,
    ``bounds_max``, ``centers``, ``geom9_t``, ``slot_mat``) plus its static
    ``leaf_size`` -> the port's ClusterAccel (``geom9_t`` becomes
    ``geom9``; the JAX ``geom_t`` is the port's `geom_t` view of it)."""
    def t(key):
        return torch.tensor(np.asarray(d[key]), device=device)
    return ClusterAccel(bounds_min=t("bounds_min"), bounds_max=t("bounds_max"),
                        centers=t("centers"), geom9=t("geom9_t"),
                        slot_mat=t("slot_mat"), leaf_size=int(d["leaf_size"]))
