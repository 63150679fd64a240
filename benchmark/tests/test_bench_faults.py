"""A run with the timed path broken underneath comes out not correct, and
a sound one correct (CPU, the cells cut to a 2,024-triangle mesh at 64x36,
held to the cells' own limits). The harness's look for a card is skipped:
``run_cell`` on the CPU runs everything else of a run."""

import time

import pytest
import torch

from conftest import small_cell


def run(cell, seed=11):
    from benchmark import run as bench_run
    return bench_run.run_cell(cell, seed, 0.3, False, "cpu",
                              t0=time.perf_counter())


def stale(render_jit):
    """Every frame returns the first frame's output: the camera's update
    is lost."""
    first = []

    def fn(*args, **kw):
        out = render_jit(*args, **kw)
        if not first:
            first.append(out)
        return first[0]
    return fn


def half_rays(render_jit):
    """Half the frame's rows are left out: misses over the background."""
    def fn(*args, **kw):
        out = render_jit(*args, **kw)
        h = out.image.shape[0] // 2
        out.image[h:] = torch.tensor([240, 130, 0], dtype=torch.uint8)
        out.hit_tri[h:] = -1
        out.radiance[h:] = 0
        return out
    return fn


def altered_block(render_jit):
    """A 4x4 block of each frame's answer altered where it is produced
    (0.7% of a 64x36 frame; a 16x32 tile is 0.1% of a 960x540 one)."""
    def fn(*args, **kw):
        out = render_jit(*args, **kw)
        h, w = out.image.shape[:2]
        out.image[h // 2:h // 2 + 4, w // 2:w // 2 + 4] += 64
        return out
    return fn


@pytest.mark.parametrize("cell", ["bin.orbit", "kd.orbit"])
def test_sound_serving_run_is_correct(cell):
    out = run(small_cell(cell))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["bin.orbit", "kd.orbit"])
@pytest.mark.parametrize("fault", [stale, half_rays, altered_block],
                         ids=lambda f: f.__name__)
def test_broken_frame_is_not_correct(cell, fault, monkeypatch):
    import cpp_cuda_raytracer_dev_torch as port
    monkeypatch.setattr(port, "render_jit", fault(port.render_jit))
    out = run(small_cell(cell))
    assert out["correct"] is False, out["checks"]


def frozen_state(monkeypatch):
    """Every optimizer step leaves the parameters as they were."""
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, *a, **k: None)


def half_batch(monkeypatch):
    """The loss's mean over half the pixels (the other rows left out)."""
    from cpp_cuda_raytracer_dev_torch.models import renderer
    from cpp_cuda_raytracer_dev_torch.parallel import render_pjit

    def make_loss_fn(config, mesh=None, accel=None):
        def loss_fn(params, target):
            rad = renderer.render_differentiable(
                params["scene"], params["camera"], config, accel).radiance
            h = rad.shape[0] // 2
            return torch.mean((rad[:h] - target[:h]) ** 2)
        return loss_fn
    monkeypatch.setattr(render_pjit, "make_loss_fn", make_loss_fn)


@pytest.mark.parametrize("cell", ["bin.fit-all", "kd.fit-pose"])
def test_sound_training_run_is_correct(cell):
    out = run(small_cell(cell))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["bin.fit-all", "kd.fit-pose"])
@pytest.mark.parametrize("fault", [frozen_state, half_batch],
                         ids=lambda f: f.__name__)
def test_broken_step_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run(small_cell(cell))
    assert out["correct"] is False, out["checks"]
