"""Port scorer (K1's contract) vs the JAX reference.

The plain PyTorch `score_argmax` is held to the XLA streaming scan
`_local_argmax_scan` (run with a 1000-point chunk so chunk boundaries are
crossed) and to the argmax of the Pallas kernel `score_chunk_pallas` in
interpret mode. Tolerance rtol 2e-4 / atol 2e-4 (as
tests/test_pallas_score.py); argmaxes exact. The CUDA kernel is held to the
plain version on the card (marked `cuda`; skips without a CUDA device).
JAX is imported inside the tests that use it, so the `cuda` tests also run
where only PyTorch is installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_score.py
"""

import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu_torch.ops import _build, score

torch.set_num_threads(2)


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
    args = _inputs(g=10)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port(args, "sinc", 1, False)


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
