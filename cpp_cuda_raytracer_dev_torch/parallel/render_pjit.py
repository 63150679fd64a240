"""Image loss and training step over scene and camera parameters (the JAX
package's ``parallel/render_pjit.py`` ``make_loss_fn`` /
``make_train_step``), single device.

``params`` is ``{"scene": Scene, "camera": Camera}``. The optimizer is a
``torch.optim`` optimizer over the parameters to train; ``torch.optim.SGD``
without momentum is ``optax.sgd``. Parameters left out of it, or with
``requires_grad`` off, stay fixed: with the triangle tables frozen the step
is the pose/light/camera-only step of ``bench.py`` and the gather backward
(kernel K2) does not run.
"""

from __future__ import annotations

import torch

from ..models.renderer import render_differentiable
from ..utils.config import RenderConfig


def _single_device(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the sharded renderer and training step are ROADMAP queue 1 "
            "item 9 (sharding), not ported yet; pass mesh=None")


def make_loss_fn(config: RenderConfig, mesh=None, accel=None):
    """L2 image loss ``mean((radiance - target)**2)`` against a target
    (H, W, 3), differentiable with respect to (scene, camera). ``accel``:
    one `ClusterAccel` per object for the cluster methods, built once and
    held fixed (the traversal is discrete; gradients flow through the
    shading only)."""
    _single_device(mesh)

    def loss_fn(params, target: torch.Tensor) -> torch.Tensor:
        rad = render_differentiable(params["scene"], params["camera"],
                                    config, accel).radiance
        return torch.mean((rad - target) ** 2)
    return loss_fn


def make_train_step(optimizer: torch.optim.Optimizer, config: RenderConfig,
                    mesh=None, accel=None):
    """``step(params, target)``: zero the gradients, backpropagate the
    loss, step the optimizer (updating the parameters in place) and return
    the loss (detached)."""
    loss_fn = make_loss_fn(config, mesh, accel)

    def step(params, target: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, target)
        loss.backward()
        optimizer.step()
        return loss.detach()
    return step
