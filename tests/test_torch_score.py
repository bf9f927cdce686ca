"""Port scorer (K1's contract) vs the JAX reference.

The plain PyTorch `score_argmax` is held to the XLA streaming scan
`_local_argmax_scan` (run with a 1000-point chunk so chunk boundaries are
crossed) and to the argmax of the Pallas kernel `score_chunk_pallas` in
interpret mode. Tolerance rtol 2e-4 / atol 2e-4 (as
tests/test_pallas_score.py); argmaxes exact. `score_surface_argmax` (the
surface with its max and first index) is held to `_score_chunk`, the scan
and `score_manifolds_mag`, with an exact tie. The CUDA kernel is held to the
plain version on the card, bit for bit (marked `cuda`; skips without a CUDA
device): ragged grids at every N the paths use, strided parameters,
unaligned offsets, ties across tiles, repeatable weighted sums, the
shared-memory limit; the block-summed mode the same way, at 4 points a
thread and 1 and over several staged batches; sinc within rtol 1e-5
(`torch.sinc` and the kernel's `sinpif` round differently).
JAX is imported inside the tests that use it, so the `cuda` tests also run
where only PyTorch is installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_score.py
"""

import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu_torch.ops import _build, score

torch.set_num_threads(2)

INTERPS = ("quadratic", "linear")


@pytest.fixture
def f32_taps():
    import jax.numpy as jnp

    from navlab_dpe_sdr_tpu.ops import dpe_real as jreal

    old = jreal.SCORE_TAP_DTYPE
    jreal.SCORE_TAP_DTYPE = jnp.float32
    yield
    jreal.SCORE_TAP_DTYPE = old


def _inputs(rng_seed=7, n=3, c=8, w=24, g=5000, with_r0=True):
    rng = np.random.default_rng(rng_seed)
    win = np.abs(rng.standard_normal((n, c, w))).astype(np.float32) + 0.1
    win[:, :, w // 2 - 1:w // 2 + 2] += [4.0, 10.0, 4.0]
    los = rng.standard_normal((n, c, 3)).astype(np.float32)
    los /= np.linalg.norm(los, axis=2, keepdims=True)
    centers = (np.full((n, c), w / 2.0)
               + rng.standard_normal((n, c)) * 0.4).astype(np.float32)
    coefs = np.full((n, c), 0.00834, np.float32)
    r0 = np.full((n, c), 2.2e7, np.float32) if with_r0 else None
    o3 = (rng.standard_normal((g, 3)) * 60).astype(np.float32)
    o1 = (rng.standard_normal(g) * 40).astype(np.float32)
    return win, los, centers, coefs, r0, o3, o1


def _jax_scan(args, interp, l_power, weighted):
    import jax.numpy as jnp

    from navlab_dpe_sdr_tpu.ops import dpe_real as jreal

    res = jreal._local_argmax_scan(
        *(None if a is None else jnp.asarray(a) for a in args), None,
        interp, l_power, 1000, block_sum=False, psum_axis=None,
        weighted=weighted)
    return [np.asarray(r) for r in res]


def _port(args, interp, l_power, weighted, device="cpu"):
    res = score.score_argmax(
        *(None if a is None else torch.from_numpy(a).to(device)
          for a in args), interp=interp, l_power=l_power, weighted=weighted)
    return [r.cpu().numpy() for r in res]


def _check(out, ref, weighted):
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_allclose(out[0], ref[0], rtol=2e-4, atol=2e-4)
    if weighted:
        np.testing.assert_allclose(out[3], ref[3], rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(out[2] / out[3][:, None],
                                   ref[2] / ref[3][:, None],
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("interp", ["quadratic", "linear"])
@pytest.mark.parametrize("l_power", [1, 2])
@pytest.mark.parametrize("with_r0", [True, False])
def test_score_argmax_matches_jax(with_r0, l_power, interp, weighted,
                                  f32_taps):
    args = _inputs(with_r0=with_r0)
    ref = _jax_scan(args, interp, l_power, weighted)
    out = _port(args, interp, l_power, weighted)
    assert out[0].dtype == np.float32 and out[1].dtype == np.int32
    _check(out, ref, weighted)
    if interp == "quadratic":
        import jax.numpy as jnp

        from navlab_dpe_sdr_tpu.ops import pallas_score as jpallas

        pk = np.asarray(jpallas.score_chunk_pallas(
            *(None if a is None else jnp.asarray(a) for a in args),
            quad_range=with_r0, l_power=l_power, interpret=True))
        np.testing.assert_array_equal(out[1], np.argmax(pk, axis=1))


@pytest.mark.parametrize("interp", ["quadratic", "linear"])
def test_score_argmax_odd_sizes(interp, f32_taps):
    args = _inputs(rng_seed=11, n=2, c=5, w=9, g=777)
    ref = _jax_scan(args, interp, 1, True)
    out = _port(args, interp, 1, True)
    _check(out, ref, True)
    # a plain scan whose chunks do not divide G gives the same answer
    small = score.score_argmax_plain(
        *(None if a is None else torch.from_numpy(a) for a in args),
        interp=interp, weighted=True, chunk=100)
    np.testing.assert_array_equal(small[1].numpy(), out[1])
    np.testing.assert_allclose(small[0].numpy(), out[0], rtol=1e-6)


def test_score_argmax_exact_tie_takes_first_index(f32_taps):
    """Every grid point appears twice (second copy 700 points later, across
    a JAX chunk boundary): the argmax must be the first copy."""
    win, los, centers, coefs, r0, o3, o1 = _inputs(rng_seed=3, g=700)
    args = (win, los, centers, coefs, r0, np.concatenate([o3, o3]),
            np.concatenate([o1, o1]))
    ref = _jax_scan(args, "quadratic", 1, False)
    out = _port(args, "quadratic", 1, False)
    np.testing.assert_array_equal(out[1], ref[1])
    assert (out[1] < 700).all()


def test_score_argmax_rejects_unported_interp():
    """Quadratic, linear and sinc are ported; any other name is refused."""
    args = _inputs(g=10)
    with pytest.raises(ValueError, match="interp='cubic'"):
        _port(args, "cubic", 1, False)
    assert len(_port(args, "sinc", 1, False)) == 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("interp", ["quadratic", "linear"])
@pytest.mark.parametrize("with_r0", [True, False])
def test_kernel_matches_plain_on_card(with_r0, interp, weighted,
                                      cuda_device):
    args = _inputs(rng_seed=5, n=4, c=8, w=24 if not with_r0 else 8,
                   g=50_000, with_r0=with_r0)
    before = _build.launch_counts()["score_argmax"]
    out = _port(args, interp, 2, weighted, device=cuda_device)
    assert _build.launch_counts()["score_argmax"] == before + 1
    t = [None if a is None else torch.from_numpy(a).to(cuda_device)
         for a in args]
    plain = [r.cpu().numpy() for r in score.score_argmax_plain(
        *t, interp=interp, l_power=2, weighted=weighted)]
    _check(out, plain, weighted)


# -- the fused surface + argmax return (K2's contract) ----------------------

def _port_surface(args, interp, l_power, device="cpu"):
    res = score.score_surface_argmax(
        *(None if a is None else torch.from_numpy(a).to(device)
          for a in args), interp=interp, l_power=l_power)
    return [r.cpu().numpy() for r in res]


@pytest.mark.parametrize("interp,l_power", [("quadratic", 1),
                                            ("quadratic", 2), ("linear", 1)])
@pytest.mark.parametrize("with_r0", [True, False])
def test_score_surface_argmax_matches_jax(with_r0, interp, l_power,
                                          f32_taps):
    """(surface, best, arg) of every block against the JAX `_score_chunk`
    surface (rtol 2e-4 as the scan above, another summation order) and the
    streaming scan's (best, first index)."""
    import jax.numpy as jnp

    from navlab_dpe_sdr_tpu.ops import dpe_real as jreal

    args = _inputs(rng_seed=13, n=2, g=3001, with_r0=with_r0)
    surf, best, arg = _port_surface(args, interp, l_power)
    assert surf.shape == (2, 3001) and surf.dtype == np.float32
    assert best.dtype == np.float32 and arg.dtype == np.int32
    ref = np.asarray(jreal._score_chunk(
        *(None if a is None else jnp.asarray(a) for a in args), interp,
        l_power))
    np.testing.assert_allclose(surf, ref, rtol=2e-4, atol=2e-4)
    scan = _jax_scan(args, interp, l_power, False)
    np.testing.assert_array_equal(arg, scan[1])
    np.testing.assert_array_equal(arg, np.argmax(surf, axis=1))
    np.testing.assert_array_equal(best, surf[np.arange(2), arg])
    np.testing.assert_array_equal(
        surf, score.score_surface(
            *(None if a is None else torch.from_numpy(a) for a in args),
            interp=interp, l_power=l_power).numpy())


def test_score_surface_argmax_exact_tie_takes_first_index(f32_taps):
    """The grid twice over: every score appears at g and g + 700, and the
    index returned beside the surface is the first, as the JAX
    `score_manifolds_mag` argmax is."""
    import jax.numpy as jnp

    from navlab_dpe_sdr_tpu.ops import dpe as jdpe_ops
    from navlab_dpe_sdr_tpu.ops import dpe_real as jreal

    win, los, centers, coefs, r0, o3, o1 = _inputs(rng_seed=3, n=1, g=700)
    o3, o1 = np.concatenate([o3, o3]), np.concatenate([o1, o1])
    surf, best, arg = _port_surface((win, los, centers, coefs, r0, o3, o1),
                                    "quadratic", 1)
    np.testing.assert_array_equal(surf[0, :700], surf[0, 700:])
    assert arg[0] < 700 and best[0] == surf[0, arg[0]] == surf[0].max()
    jp = jdpe_ops.ManifoldParams(*(jnp.asarray(a) for a in (
        los[0], r0[0], centers[0], coefs[0], centers[0], coefs[0])))
    ref = jreal.score_manifolds_mag(jnp.asarray(win[0]), jnp.asarray(win[0]),
                                    jp, *(jnp.asarray(a) for a in
                                          (o3, o1, o3, o1)))
    assert int(ref[1]) == int(arg[0])


# -- the kernel against its plain version on the card ------------------------

def _card(args, device):
    return [None if a is None else torch.from_numpy(a).to(device)
            for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 10, 50])
@pytest.mark.parametrize("g", [100, 777, 390_625])
def test_kernel_bit_equal_ragged_grids(g, n, cuda_device):
    """G below one tile, a small odd G, and the spread grid's odd 390 625
    (no multiple of the points a thread owns), at the N of every path:
    best, arg, the surface and its argmax equal the plain version's bits."""
    t = _card(_inputs(rng_seed=17, n=n, c=8, w=12, g=g), cuda_device)
    for interp in INTERPS:
        got = score.score_argmax(*t, interp=interp)
        want = score.score_argmax_plain(*t, interp=interp)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if n <= 10:
        surf, best, arg = score.score_surface_argmax(*t)
        plain = score.score_surface_plain(*t)
        assert torch.equal(surf, plain)
        assert torch.equal(arg.long(), plain.argmax(dim=1))
        assert torch.equal(best, plain.max(dim=1).values)



@pytest.mark.cuda
@pytest.mark.parametrize("l_power", [1, 2, 3])
def test_kernel_strided_parameters_and_unaligned_offsets(l_power,
                                                         cuda_device):
    """Slices of a packed parameter tensor go in by their strides, and grid
    offsets that start 4 bytes off a 16-byte boundary take the one-point
    loads: the same bits as the plain version on contiguous copies."""
    n, c, w, g = 6, 8, 36, 5001
    t = _card(_inputs(rng_seed=19, n=n, c=c, w=w, g=g + 1), cuda_device)
    pk = torch.empty((n, 11, c), device=cuda_device)
    pk[:, 3:6] = t[1].transpose(1, 2)
    pk[:, 6], pk[:, 7], pk[:, 8] = t[4], t[2], t[3]
    views = (t[0], pk[:, 3:6].transpose(1, 2), pk[:, 7], pk[:, 8], pk[:, 6])
    assert not views[1].is_contiguous() and not views[2].is_contiguous()
    for o3, o1 in ((t[5], t[6]), (t[5][1:], t[6][1:])):
        got = score.score_argmax(*views, o3, o1, l_power=l_power,
                                 weighted=True)
        want = score.score_argmax_plain(*t[:5], o3, o1, l_power=l_power,
                                        weighted=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        torch.testing.assert_close(got[2] / got[3][:, None],
                                   want[2] / want[3][:, None], rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.cuda
def test_kernel_tie_across_tiles_takes_smaller_index(cuda_device):
    """The grid twice over, 50 000 points apart: the two copies of the
    maximum lie in different tiles (and thread blocks), and both the
    streaming argmax and the surface's take the first."""
    win, los, centers, coefs, r0, o3, o1 = _inputs(rng_seed=3, g=50_000)
    t = _card((win, los, centers, coefs, r0, np.concatenate([o3, o3]),
               np.concatenate([o1, o1])), cuda_device)
    best, arg = score.score_argmax(*t)
    want = score.score_argmax_plain(*t)
    assert torch.equal(arg, want[1]) and torch.equal(best, want[0])
    assert bool((arg < 50_000).all())
    _, sbest, sarg = score.score_surface_argmax(*t)
    assert torch.equal(sarg, arg) and torch.equal(sbest, best)


@pytest.mark.cuda
def test_kernel_weighted_sums_repeat_bitwise(cuda_device):
    """No floating atomics: two runs give the same bits in every output."""
    t = _card(_inputs(rng_seed=23, n=10, c=8, w=12, g=200_001), cuda_device)
    a = score.score_argmax(*t, weighted=True)
    b = score.score_argmax(*t, weighted=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_kernel_refuses_windows_beyond_shared_memory(cuda_device):
    """One block's staged windows (16 bytes a tap) must fit the kernel's
    shared memory: the widest that does runs, the next is refused by the
    wrapper with the limit in its message."""
    lib = score._lib()
    c = 8
    w = max(w for w in range(3, 4096)
            if lib.score_shared_bytes(c, w, 0, 0) <= lib.score_max_shared())
    t = _card(_inputs(rng_seed=29, n=1, c=c, w=w, g=300), cuda_device)
    got = score.score_argmax(*t)
    want = score.score_argmax_plain(*t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    t = _card(_inputs(rng_seed=29, n=1, c=c, w=w + 1, g=300), cuda_device)
    with pytest.raises(ValueError, match="KB of shared memory"):
        score.score_argmax(*t)


# -- the block-summed mode and sinc on the card -------------------------------

def _sum_pair(t, **kw):
    got = score.score_argmax(*t, block_sum=True, **kw)
    want = score.score_argmax_plain(*t, block_sum=True, **kw)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8, 50])
@pytest.mark.parametrize("g", [100, 777, 390_625])
def test_kernel_block_sum_bit_equal(g, n, cuda_device):
    """The scores of all blocks summed per grid point inside the kernel
    (f32, ascending n): best and arg equal the plain version's bits, on
    both manifolds, and the launch counts once."""
    for with_r0 in (True, False):
        t = _card(_inputs(rng_seed=41, n=n, c=8, w=12, g=g,
                          with_r0=with_r0), cuda_device)
        for kw in (dict(), dict(interp="linear"), dict(l_power=2)):
            before = _build.launch_counts()["score_argmax"]
            got, want = _sum_pair(t, **kw)
            assert _build.launch_counts()["score_argmax"] == before + 1
            assert got[0].shape == () and got[1].dtype == torch.int32
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_kernel_block_sum_many_epochs_and_points(cuda_device):
    """N = 300 epochs of 36-tap windows are staged in several batches with
    the sums held in registers, at the offsets as allocated (4 points a
    thread) and 4 bytes off a 16-byte boundary (1 point a thread): both
    give the plain version's bits."""
    t = _card(_inputs(rng_seed=43, n=300, c=8, w=36, g=20_001,
                      with_r0=False), cuda_device)
    got, want = _sum_pair(t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    off = (*t[:5], t[5][1:], t[6][1:])
    got, want = _sum_pair(off)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_kernel_block_sum_strided_unaligned_weighted(cuda_device):
    """Slices of a packed parameter tensor, offsets 4 bytes off a 16-byte
    boundary, weighted: best and arg bit-equal, the weighted means within
    rtol 1e-4 (f64 sums in another order), and bitwise equal run to run."""
    n, c, w, g = 16, 8, 12, 70_001
    t = _card(_inputs(rng_seed=47, n=n, c=c, w=w, g=g + 1), cuda_device)
    pk = torch.empty((n, 11, c), device=cuda_device)
    pk[:, 3:6] = t[1].transpose(1, 2)
    pk[:, 6], pk[:, 7], pk[:, 8] = t[4], t[2], t[3]
    views = (t[0], pk[:, 3:6].transpose(1, 2), pk[:, 7], pk[:, 8], pk[:, 6])
    for o3, o1 in ((t[5], t[6]), (t[5][1:], t[6][1:])):
        got = score.score_argmax(*views, o3, o1, weighted=True,
                                 block_sum=True)
        again = score.score_argmax(*views, o3, o1, weighted=True,
                                   block_sum=True)
        want = score.score_argmax_plain(*t[:5], o3, o1, weighted=True,
                                        block_sum=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[2].shape == (4,) and got[3].shape == ()
        torch.testing.assert_close(got[2] / got[3], want[2] / want[3],
                                   rtol=1e-4, atol=1e-6)
        for x, y in zip(got, again):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_kernel_block_sum_tie_across_tiles(cuda_device):
    """The grid twice over, 50 000 points apart: the summed scores tie
    exactly in two thread blocks and the smaller index wins."""
    win, los, centers, coefs, r0, o3, o1 = _inputs(rng_seed=3, n=8, g=50_000)
    t = _card((win, los, centers, coefs, r0, np.concatenate([o3, o3]),
               np.concatenate([o1, o1])), cuda_device)
    got, want = _sum_pair(t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1]) < 50_000


def _assert_argmax_or_tie(t, got, want, n_rows, block_sum):
    """Indices equal, or the plain scores at the two indices within 1e-6
    relative (a tie to the rounding of sinc)."""
    ga, wa = got[1].reshape(-1).tolist(), want[1].reshape(-1).tolist()
    for row, (a, b) in enumerate(zip(ga, wa)):
        if a == b:
            continue
        sel = slice(None) if block_sum else slice(row, row + 1)
        args = [None if x is None else x[sel] for x in t[:5]]
        at = score.score_points(*args, t[5][[a, b]], t[6][[a, b]], "sinc",
                                1).sum(dim=0)
        assert abs(float(at[0] - at[1])) <= 1e-6 * abs(float(at[1])), (a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("with_r0", [True, False])
def test_kernel_sinc_within_tolerance(with_r0, cuda_device):
    """sinc in every mode the wrapper reaches: per-block argmax, the block
    sum and the surface, scores within rtol 1e-5 of the plain version."""
    t = _card(_inputs(rng_seed=53, n=6, c=8, w=12, g=30_001,
                      with_r0=with_r0), cuda_device)
    for block_sum in (False, True):
        got = score.score_argmax(*t, interp="sinc", weighted=True,
                                 block_sum=block_sum)
        want = score.score_argmax_plain(*t, interp="sinc", weighted=True,
                                        block_sum=block_sum)
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0.0)
        _assert_argmax_or_tie(t, got, want, 6, block_sum)
        torch.testing.assert_close(got[2] / got[3][..., None],
                                   want[2] / want[3][..., None], rtol=1e-4,
                                   atol=1e-5)
    surf, best, arg = score.score_surface_argmax(*t, interp="sinc",
                                                 l_power=2)
    plain = score.score_surface_plain(*t, interp="sinc", l_power=2)
    torch.testing.assert_close(surf, plain, rtol=1e-5, atol=1e-5)
    assert torch.equal(best, surf.max(dim=1).values)
    assert torch.equal(arg.long(), surf.argmax(dim=1))
