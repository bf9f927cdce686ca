"""Product-grid factors (ops/score.py `grid_factors`, `factor_rows`) and the
scorer's `factors` argument.

On the CPU: every grid style the receiver builds factors with its clock
axis's length L, and the factors expand back to the grid bit for bit; a CSV
grid, a row-shuffled grid and a slice that cuts a run do not factor; the
plain scorer's results do not depend on the factors; the dispatch hands
each manifold its own factors, and a mesh rank its rows' factors only where
its rows start and end on runs. On the card (marked `cuda`; skips without a
CUDA device): the factored kernel equals the per-point kernel and the plain
version bit for bit (on the spread grid, a small one, and the dense 75^4
grid, whose launches take 25 clock values a thread) and counts its launches
under its own keys; the weighted modes, sinc and a clock axis the kernel's
step does not divide run the per-point kernel.

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_grid_factors.py
"""

import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu_torch.models.grid import load_grid_csv, make_grid
from navlab_dpe_sdr_tpu_torch.ops import _build, dpe_real, score

torch.set_num_threads(2)

# (style, make_grid arguments, L): small n where the default is large
STYLES = [("spread", {}, 25), ("uniform", {}, 15), ("uniform", dict(n=7), 7),
          ("arthur", {}, 25), ("exponential", dict(n=10), 10),
          ("dense", dict(n=9), 9)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _offsets(grid, manifold):
    if manifold == "pos":
        return _t(grid.d_enu), _t(grid.dt_m)
    return _t(grid.dv_enu), _t(grid.dtdot)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("manifold", ["pos", "vel"])
@pytest.mark.parametrize("style,kw,run", STYLES)
def test_every_grid_style_factors(style, kw, run, manifold):
    off3, off1 = _offsets(make_grid(style, **kw), manifold)
    f = score.grid_factors(off3, off1)
    g = off3.shape[0]
    assert f is not None
    assert f.o3u.shape == (g // run, 3) and f.o1u.shape == (run,)
    assert f.fits == (run % score.CLOCK_STEP == 0)
    assert torch.equal(_bits(f.o3u.repeat_interleave(run, dim=0)),
                       _bits(off3))
    assert torch.equal(_bits(f.o1u.repeat(g // run)), _bits(off1))


def test_csv_shuffled_and_cut_grids_do_not_factor(tmp_path):
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((500, 4)) * 30.0
    path = tmp_path / "grid.csv"
    np.savetxt(path, rows, delimiter=",")
    assert score.grid_factors(*_offsets(load_grid_csv(str(path)),
                                        "pos")) is None
    np.savetxt(path, rows[:, :3], delimiter=",")       # no clock column
    assert score.grid_factors(*_offsets(load_grid_csv(str(path)),
                                        "pos")) is None

    off3, off1 = _offsets(make_grid("spread"), "pos")
    perm = torch.from_numpy(rng.permutation(off3.shape[0]))
    assert score.grid_factors(off3[perm], off1[perm]) is None
    moved = off1.clone()
    moved[-3] += 0.5                     # one clock value off its axis
    assert score.grid_factors(off3, moved) is None

    f = score.grid_factors(off3, off1)
    g = off3.shape[0]
    assert score.grid_factors(off3[10:g - 10], off1[10:g - 10]) is None
    assert score.factor_rows(f, 10, g - 10) is None
    assert score.factor_rows(f, 100, g - 13) is None
    assert score.factor_rows(f, 300, 300) is None
    lo, hi = 4 * 25, g - 8 * 25
    rows_f = score.factor_rows(f, lo, hi)
    want = score.grid_factors(off3[lo:hi], off1[lo:hi])
    assert torch.equal(rows_f.o3u, want.o3u)
    assert torch.equal(rows_f.o1u, want.o1u)
    assert rows_f.fits and want.fits


def _scorer_inputs(seed, n, grid, manifold, w=16):
    rng = np.random.default_rng(seed)
    win = np.abs(rng.standard_normal((n, 8, w))).astype(np.float32) + 0.1
    win[:, :, w // 2 - 1:w // 2 + 2] += [4.0, 10.0, 4.0]
    los = rng.standard_normal((n, 8, 3))
    los /= np.linalg.norm(los, axis=2, keepdims=True)
    centers = w / 2.0 + rng.standard_normal((n, 8)) * 0.4
    coefs = np.full((n, 8), 0.00834 if manifold == "pos" else 0.05)
    r0 = np.full((n, 8), 2.2e7) if manifold == "pos" else None
    off3, off1 = _offsets(grid, manifold)
    return [None if a is None else _t(a)
            for a in (win, los, centers, coefs, r0)] + [off3, off1]


@pytest.mark.parametrize("interp", ["quadratic", "linear", "sinc"])
@pytest.mark.parametrize("manifold", ["pos", "vel"])
def test_plain_scorer_ignores_factors(manifold, interp):
    grid = make_grid("uniform", n=10, pos_spacing=15.0, vel_spacing=1.0)
    args = _scorer_inputs(3, 4, grid, manifold)
    f = score.grid_factors(args[5], args[6])
    assert f is not None and f.o1u.shape == (10,)
    for weighted in (False, True):
        for block_sum in (False, True):
            kw = dict(interp=interp, weighted=weighted, block_sum=block_sum)
            want = score.score_argmax(*args, **kw)
            got = score.score_argmax(*args, factors=f, **kw)
            for x, y in zip(want, got):
                assert torch.equal(_bits(x), _bits(y)), (kw, x, y)


def test_factors_of_another_grid_are_refused():
    grid = make_grid("uniform", n=10)
    args = _scorer_inputs(3, 2, grid, "pos")
    f = score.grid_factors(args[5], args[6])
    with pytest.raises(ValueError, match="do not factor"):
        score.score_argmax(*args[:5], args[5][:-10], args[6][:-10],
                           factors=f)


class _Rows:
    """A mesh as `_score_rows` sees it: this rank's rows, and the combine
    (here the one rank's result)."""

    def __init__(self, lo, hi):
        self.rows = (lo, hi)

    def grid_rows(self, g):
        return self.rows

    def best_over_grid(self, results):
        return results


def test_dispatch_hands_each_manifold_its_factors(monkeypatch):
    calls = []

    def record(*a, **kw):
        calls.append((a[5].shape[0], kw.get("factors")))
        n = a[0].shape[0]
        return torch.zeros(n), torch.zeros(n, dtype=torch.int32)

    monkeypatch.setattr(dpe_real, "score_argmax", record)
    grid = make_grid("uniform", n=10)
    pos3, pos1 = _offsets(grid, "pos")
    vel3, vel1 = _offsets(grid, "vel")
    fp, fv = score.grid_factors(pos3, pos1), score.grid_factors(vel3, vel1)
    out = dpe_real.RealBlockOut(torch.ones(3, 8, 12), torch.ones(3, 8, 24),
                                torch.zeros(3, 8, dtype=torch.bool))
    fpk = torch.ones(3, dpe_real.FPK_ROWS, 8)
    dpe_real._score_both(None, out, fpk, pos3, pos1, vel3, vel1,
                         "quadratic", 1, False, False, factors=(fp, fv))
    assert [c[1] for c in calls] == [fp, fv]

    calls.clear()                    # a mesh rank's rows, on runs and not
    g = pos3.shape[0]
    for lo, hi, aligned in ((0, 5000, True), (5000, g, True),
                            (0, 5001, False), (5001, g, False)):
        dpe_real._score_both(_Rows(lo, hi), out, fpk, pos3, pos1, vel3,
                             vel1, "quadratic", 1, False, False,
                             factors=(fp, fv))
        for (rows, f), full in zip(calls, (fp, fv)):
            assert rows == hi - lo
            if aligned:
                assert torch.equal(f.o3u, full.o3u[lo // 10:hi // 10])
                assert f.o1u is full.o1u
            else:
                assert f is None
        calls.clear()


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _cuda_args(args, device):
    return [None if a is None else a.to(device) for a in args]


def _hold(got, want, kw):
    for x, y in zip(want, got):
        assert torch.equal(_bits(x.cpu()), _bits(y.cpu())), (kw, x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 50])
@pytest.mark.parametrize("style,kw", [("spread", {}),
                                      ("uniform", dict(n=10))])
def test_factored_kernel_bit_equal_to_per_point(style, kw, n, cuda_device):
    """Both argmax modes, quadratic and linear, both manifolds, l_power 1
    and 3: best and arg equal to the per-point kernel's bits and to the
    plain version's (on CPU copies of the inputs; at N = 50 on the card,
    whose plain results have the CPU's bits: test_torch_score), each launch
    under its own key."""
    grid = make_grid(style, **kw)
    for manifold in ("pos", "vel"):
        host = _scorer_inputs(11, n, grid, manifold)
        args = _cuda_args(host, cuda_device)
        ref = args if n == 50 else host
        f = score.grid_factors(args[5], args[6])
        for interp in ("quadratic", "linear"):
            for l_power in (1, 3):
                for block_sum in (False, True):
                    kw = dict(interp=interp, l_power=l_power,
                              block_sum=block_sum)
                    key = "score_argmax_sum" if block_sum else \
                        "score_argmax"
                    before = _build.launch_counts()
                    want = score.score_argmax(*args, **kw)
                    got = score.score_argmax(*args, factors=f, **kw)
                    after = _build.launch_counts()
                    assert after[key] == before[key] + 1
                    assert (after[key + "_factored"]
                            == before[key + "_factored"] + 1)
                    _hold(got, want, kw)
                    _hold(got, score.score_argmax_plain(*ref, **kw), kw)


@pytest.mark.cuda
def test_factored_kernel_on_the_dense_grid_equals_plain(cuda_device):
    """The dense 75^4 grid at N = 1: its tiles at 25 clock values a thread
    fill the card, so its launches take the wide step and the tap index by
    the 1.5 * 2^23 shift. Both manifolds, quadratic and linear, per block
    and block-summed (at N = 1 the same surface): best and arg equal to the
    plain version's bits on CPU copies and to the per-point kernel's."""
    grid = make_grid("dense")
    for manifold in ("pos", "vel"):
        host = _scorer_inputs(23, 1, grid, manifold)
        args = _cuda_args(host, cuda_device)
        f = score.grid_factors(args[5], args[6])
        assert f is not None and f.fits and f.o1u.shape == (75,)
        for interp in ("quadratic", "linear"):
            want = score.score_argmax_plain(*host, interp=interp)
            before = _build.launch_counts()
            got = score.score_argmax(*args, interp=interp, factors=f)
            got_sum = score.score_argmax(*args, interp=interp,
                                         block_sum=True, factors=f)
            after = _build.launch_counts()
            for key in ("score_argmax_factored", "score_argmax_sum_factored"):
                assert after[key] == before[key] + 1, key
            _hold(got, want, interp)
            _hold([t[None] for t in got_sum], want, interp)
            _hold(got, score.score_argmax(*args, interp=interp), interp)


@pytest.mark.cuda
def test_unfactorable_calls_take_the_per_point_kernel(cuda_device):
    """The weighted modes, sinc and a clock axis of 7 (no multiple of the
    kernel's step) run the per-point kernel; offsets 4 bytes off a 16-byte
    boundary, which the factored kernel does not read, take it with the
    per-point kernel's bits."""
    grid = make_grid("uniform", n=7)
    args = _cuda_args(_scorer_inputs(5, 4, grid, "pos"), cuda_device)
    f7 = score.grid_factors(args[5], args[6])
    assert f7 is not None and not f7.fits
    spread = make_grid("spread")
    sargs = _cuda_args(_scorer_inputs(5, 4, spread, "pos"), cuda_device)
    fs = score.grid_factors(sargs[5], sargs[6])
    before = _build.launch_counts()
    score.score_argmax(*args, factors=f7)
    score.score_argmax(*sargs, interp="sinc", factors=fs)
    for block_sum in (False, True):
        want = score.score_argmax(*sargs, weighted=True, block_sum=block_sum)
        got = score.score_argmax(*sargs, weighted=True, block_sum=block_sum,
                                 factors=fs)
        _hold(got, want, block_sum)
    after = _build.launch_counts()
    assert after["score_argmax"] == before["score_argmax"] + 4
    assert after["score_argmax_sum"] == before["score_argmax_sum"] + 2
    for key in ("score_argmax_factored", "score_argmax_sum_factored"):
        assert after[key] == before[key], key

    off3 = torch.empty(sargs[5].numel() + 1, device=cuda_device)[1:].view(
        -1, 3)
    off3.copy_(sargs[5])
    want = score.score_argmax(*sargs)
    got = score.score_argmax(*sargs[:5], off3, sargs[6], factors=fs)
    assert (_build.launch_counts()["score_argmax_factored"]
            == after["score_argmax_factored"] + 1)
    _hold(got, want, "unaligned")

    # factors on another device than the call's are refused before a launch
    host = score.grid_factors(sargs[5].cpu(), sargs[6].cpu())
    with pytest.raises(ValueError, match="factors on cpu"):
        score.score_argmax(*sargs, factors=host)
