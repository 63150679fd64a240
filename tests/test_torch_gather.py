"""The port's `gather_rows` (forward and sorted segment-sum backward) and the
segment sum's plain version against the JAX package's ``ops/gather.py``,
and kernel K2 against its plain version on the card.

Tolerances:
- forward: equal (a row gather moves bits);
- gradients against ``jax.grad`` of the JAX custom VJP: rtol/atol 1e-5, as
  ``tests/test_gather.py`` holds the JAX VJP against the scatter VJP;
- the plain segment sum against ``_segment_sum_pallas`` in interpret mode:
  rtol/atol 1e-4 (the TPU kernel keeps about 16 bits of each cotangent
  through its bf16 hi/lo split), and against ``_bwd_cumsum``: rtol/atol
  1e-4 (a difference of running sums loses the prefix's magnitude);
- every segment sum against a float64 sum: within n·2⁻²³·Σ|x| for a
  segment of n rows (a float32 sum of n terms in any order), and exactly 0
  for ids without rows;
- on integer rows whose partial sums stay below 2²⁴, which float32 adds
  exactly in any order: equal to the float64 sum. On a long segment the
  bound above exceeds the sum itself; this check still fails on a dropped
  or doubled row.

The JAX package is imported inside the tests that use it, so that the GPU
tests also run where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_gather.py
"""

import numpy as np
import pytest
import torch

from cpp_cuda_raytracer_dev_torch.ops import gather as pg
from cpp_cuda_raytracer_dev_torch.ops.cuda import segment_sum as k2


def _rand_case(rng, t_rows, r_rows, widths):
    idx = rng.integers(0, t_rows, r_rows).astype(np.int32)
    tabs = tuple(rng.standard_normal((t_rows, w)).astype(np.float32)
                 for w in widths)
    return idx, tabs


def _assert_within_sum_bound(got, block, idx, t_rows):
    """|got - exact| <= n_seg * 2**-23 * sum|x| per id; 0 where n_seg = 0."""
    got = np.asarray(got, np.float64)
    b = np.asarray(block, np.float64)
    exact = np.zeros((t_rows, b.shape[1]))
    np.add.at(exact, idx, b)
    mag = np.zeros_like(exact)
    np.add.at(mag, idx, np.abs(b))
    n_seg = np.bincount(idx, minlength=t_rows)[:, None]
    assert (np.abs(got - exact) <= n_seg * 2.0 ** -23 * mag).all()
    assert (got[n_seg[:, 0] == 0] == 0).all()


def _integer_cases(long_rows):
    """The segment cases on integer rows in [-16, 16], plus one segment of
    ``long_rows`` rows (many runs of the kernel) amid short ones."""
    rng = np.random.default_rng(1)
    idx = np.sort(np.concatenate([np.full(long_rows, 3, np.int64),
                                  rng.integers(0, 5000, long_rows // 4)]))
    cases = [*_segment_cases(),
             ("long segment 3", np.zeros((idx.shape[0], 12), np.float32),
              idx.astype(np.int32), 5000)]
    for name, block, idx, t_rows in cases:
        block = rng.integers(-16, 17, block.shape).astype(np.float32)
        exact = np.zeros((t_rows, block.shape[1]))
        np.add.at(exact, idx, block.astype(np.float64))
        yield name, block, idx, t_rows, exact.astype(np.float32)


def _segment_cases():
    """(name, block (R, F) f32, sorted idx (R,) i32, t_rows)."""
    rng = np.random.default_rng(0)
    out = []
    for name, idx, t_rows, f in (
            ("random", rng.integers(0, 3000, 5000), 3000, 12),
            ("one id", np.full(3000, 7), 100, 12),
            ("less than one run", rng.integers(0, 50, 37), 50, 12),
            ("T not a multiple", rng.integers(0, 997, 2999), 997, 5),
            ("empty segments", rng.choice(np.arange(0, 5000, 7), 1100),
             5003, 12),
            ("long segment 0", np.concatenate(
                [np.zeros(1800, np.int64), rng.integers(0, 997, 900)]),
             997, 12)):
        idx = np.sort(idx).astype(np.int32)
        block = rng.standard_normal((idx.shape[0], f)).astype(np.float32)
        out.append((name, block, idx, t_rows))
    return out


def test_forward_matches_take():
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    idx, tabs = _rand_case(rng, 257, 1000, (3, 3, 1))
    got = pg.gather_rows(tuple(torch.tensor(t) for t in tabs),
                         torch.tensor(idx))
    for g, t in zip(got, tabs):
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(jnp.take(jnp.asarray(t), idx, axis=0)))


@pytest.mark.parametrize("t_rows,r_rows", [(1000, 4096), (127, 63), (3, 1)])
def test_grad_matches_jax(t_rows, r_rows):
    import jax
    import jax.numpy as jnp

    from cpp_cuda_raytracer_dev_tpu.ops.gather import gather_rows

    rng = np.random.default_rng(t_rows)
    idx, tabs = _rand_case(rng, t_rows, r_rows, (3, 3, 3, 1))
    w = [rng.standard_normal(r_rows).astype(np.float32) for _ in tabs]

    def jloss(tabs):
        outs = gather_rows(tabs, jnp.asarray(idx))
        return sum(jnp.sum(wi[:, None] * o) for wi, o in zip(w, outs))

    want = jax.grad(jloss)(tuple(jnp.asarray(t) for t in tabs))
    ptabs = [torch.tensor(t, requires_grad=True) for t in tabs]
    outs = pg.gather_rows(tuple(ptabs), torch.tensor(idx))
    sum((torch.tensor(wi)[:, None] * o).sum()
        for wi, o in zip(w, outs)).backward()
    for p, j in zip(ptabs, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(j),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", range(len(_segment_cases())),
                         ids=[c[0] for c in _segment_cases()])
def test_segment_sum_reference_matches_jax(case):
    import jax.numpy as jnp

    from cpp_cuda_raytracer_dev_tpu.ops.gather import (_bwd_cumsum,
                                                       _segment_sum_pallas)

    _, block, idx, t_rows = _segment_cases()[case]
    got = k2.segment_sum_reference(torch.tensor(block), torch.tensor(idx),
                                   t_rows).numpy()
    jb, ji = jnp.asarray(block), jnp.asarray(idx)
    np.testing.assert_allclose(
        got, np.asarray(_segment_sum_pallas(jb, ji, t_rows, interpret=True)),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(_bwd_cumsum(jb, ji, t_rows)),
                               rtol=1e-4, atol=1e-4)
    _assert_within_sum_bound(got, block, idx, t_rows)


def test_wrapper_runs_plain_version_for_cpu_tensors():
    _, block, idx, t_rows = _segment_cases()[0]
    before = k2.segment_sum.launches
    got = k2.segment_sum(torch.tensor(block), torch.tensor(idx), t_rows)
    want = k2.segment_sum_reference(torch.tensor(block), torch.tensor(idx),
                                    t_rows)
    assert torch.equal(got, want)
    assert k2.segment_sum.launches == before       # no kernel launched


def test_wrapper_rejects_bad_operands():
    _, block, idx, t_rows = _segment_cases()[0]
    b, i = torch.tensor(block), torch.tensor(idx)
    with pytest.raises(ValueError, match="float32"):
        k2.segment_sum(b.double(), i, t_rows)
    with pytest.raises(ValueError, match="int32"):
        k2.segment_sum(b, i.long(), t_rows)
    with pytest.raises(ValueError, match="int32"):
        k2.segment_sum(b, i[:-1], t_rows)
    with pytest.raises(ValueError, match="contiguous"):
        k2.segment_sum(b.T.contiguous().T, i, t_rows)
    with pytest.raises(ValueError, match="t_rows"):
        k2.segment_sum(b, i, 0)


def test_backward_sorts_and_sums_only_when_a_table_needs_grad(monkeypatch):
    """The pose/light/camera-only step: with no table requiring a gradient
    nothing is sorted and no segment sum runs; with one, exactly one."""
    calls = {"sort": 0, "segment_sum": 0}
    sort, segsum = torch.sort, k2.segment_sum

    def spy_sort(*a, **kw):
        calls["sort"] += 1
        return sort(*a, **kw)

    def spy_segsum(*a, **kw):
        calls["segment_sum"] += 1
        return segsum(*a, **kw)

    monkeypatch.setattr(torch, "sort", spy_sort)
    monkeypatch.setattr(k2, "segment_sum", spy_segsum)
    rng = np.random.default_rng(2)
    idx, (tab,) = _rand_case(rng, 40, 300, (12,))
    scale = torch.tensor(1.5, requires_grad=True)
    table = torch.tensor(tab)
    rows, = pg.gather_rows((table,), torch.tensor(idx))
    (scale * rows).sum().backward()
    assert scale.grad is not None
    assert calls == {"sort": 0, "segment_sum": 0}

    table.requires_grad_(True)
    rows, = pg.gather_rows((table,), torch.tensor(idx))
    (scale * rows).sum().backward()
    assert calls == {"sort": 1, "segment_sum": 1}
    np.testing.assert_allclose(
        table.grad.numpy(), 1.5 * np.bincount(idx, minlength=40)[:, None]
        * np.ones((1, 12)), rtol=1e-6)


def test_take_rows_is_index_select_autograd():
    """sorted_scatter=False: the same rows and the same gradient through
    index_select's own backward."""
    rng = np.random.default_rng(3)
    idx, tabs = _rand_case(rng, 60, 500, (12,))
    a = torch.tensor(tabs[0], requires_grad=True)
    b = torch.tensor(tabs[0], requires_grad=True)
    w = torch.tensor(rng.standard_normal((500, 12)).astype(np.float32))
    ra, = pg.gather_rows((a,), torch.tensor(idx))
    rb, = pg.take_rows((b,), torch.tensor(idx))
    assert torch.equal(ra, rb)
    (w * ra).sum().backward()
    (w * rb).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_plain_version_sums_integer_rows_exactly():
    for name, block, idx, t_rows, exact in _integer_cases(20_000):
        got = k2.segment_sum(torch.tensor(block), torch.tensor(idx), t_rows)
        np.testing.assert_array_equal(got.numpy(), exact, err_msg=name)


@pytest.mark.gpu
def test_kernel_sums_integer_rows_exactly_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for name, block, idx, t_rows, exact in _integer_cases(300_000):
        got = k2.segment_sum(torch.tensor(block).cuda(),
                             torch.tensor(idx).cuda(), t_rows)
        np.testing.assert_array_equal(got.cpu().numpy(), exact, err_msg=name)


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_gpu():
    """Within the float32 sum bound of an exact sum, bitwise the same on
    two launches, one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for name, block, idx, t_rows in _segment_cases():
        b, i = torch.tensor(block).cuda(), torch.tensor(idx).cuda()
        before = k2.segment_sum.launches
        got = k2.segment_sum(b, i, t_rows)
        again = k2.segment_sum(b, i, t_rows)
        torch.cuda.synchronize()
        assert k2.segment_sum.launches == before + 2, name
        assert torch.equal(got, again), name
        _assert_within_sum_bound(got.cpu().numpy(), block, idx, t_rows)
        plain = k2.segment_sum_reference(b, i, t_rows).cpu().numpy()
        _assert_within_sum_bound(plain, block, idx, t_rows)
