"""File-mode staging of the port's DPE receiver: the read-ahead thread
`_RawPrefetcher` (order, depth, reader errors, `close()` mid-run, as
tests/test_runtime.py holds the JAX receiver's) and file-mode runs against
device-resident runs on the CPU: the fixes are identical. Imports nothing
of JAX, so the `cuda`-marked case also runs where only PyTorch is
installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_prefetch.py
"""

import copy
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu_torch.io.rawfile import DTYPE_IQ16, SampleFile
from navlab_dpe_sdr_tpu_torch.io.scenario import make_scenario
from navlab_dpe_sdr_tpu_torch.models.dpe import (DPEConfig, DPEReceiver,
                                                 _RawPrefetcher)
from navlab_dpe_sdr_tpu_torch.models.grid import uniform_grid

torch.set_num_threads(2)

FS = 2.5e6


class FakeRaw:
    """Blocks of 10 samples whose values are the block's number."""

    def __init__(self, n_blocks, fail_at=None):
        self.i = 0
        self.n = n_blocks
        self.fail_at = fail_at

    def read_block_raw(self):
        if self.fail_at is not None and self.i == self.fail_at:
            raise IOError("disk gone")
        if self.i >= self.n:
            raise EOFError("past end")
        b = np.full((10, 2), self.i, np.int16)
        self.i += 1
        return b


def _wait_for(cond, seconds=5.0):
    t0 = time.perf_counter()
    while not cond() and time.perf_counter() - t0 < seconds:
        time.sleep(0.01)
    return cond()


def test_prefetcher_stages_in_order_and_reads_ahead():
    raw = FakeRaw(12)
    pf = _RawPrefetcher(raw, [2, 3, 2, 2, 3], "cpu", depth=2)
    # two batches queued and a third read, waiting for room: never more
    assert _wait_for(lambda: raw.i == 7)
    time.sleep(0.3)
    assert raw.i == 7 and pf._q.qsize() == 2
    got = [pf.get() for _ in range(5)]
    assert [tuple(t.shape) for t in got] == [(2, 10, 2), (3, 10, 2),
                                             (2, 10, 2), (2, 10, 2),
                                             (3, 10, 2)]
    assert all(t.dtype == torch.int16 and t.device.type == "cpu"
               for t in got)
    assert [int(t[0, 0, 0]) for t in got] == [0, 2, 5, 7, 9]
    assert _wait_for(lambda: not pf._thread.is_alive())
    pf.close()


def test_prefetcher_reader_error_surfaces_in_get():
    pf = _RawPrefetcher(FakeRaw(6, fail_at=3), [2, 2, 2], "cpu")
    assert int(pf.get()[0, 0, 0]) == 0
    with pytest.raises(IOError, match="disk gone"):
        pf.get()
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_close_mid_run_ends_the_thread():
    """The consumer abandons the queue after one batch: close() must not
    deadlock on the reader's bounded put and must join the thread."""
    before = threading.active_count()
    raw = FakeRaw(20)
    pf = _RawPrefetcher(raw, [2] * 10, "cpu")
    pf.get()
    pf.close()
    assert not pf._thread.is_alive()
    assert threading.active_count() <= before
    assert raw.i < 20           # it stopped reading


@pytest.fixture(scope="module")
def scenario():
    sim, hand, arr = make_scenario(nav_data=True)
    iq = sim.generate(50000 * 14)
    samples = np.empty(iq.shape[0], DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    return samples, hand, arr, uniform_grid(n=7, pos_spacing=15.0,
                                            vel_spacing=1.0)


def _receiver(scenario, device, **cfg):
    samples, hand, arr, grid = scenario
    return DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                       copy.deepcopy(hand), grid=grid,
                       config=DPEConfig(ekf_mode="alpha", **cfg),
                       eph=copy.deepcopy(arr), device=device)


def _file_and_resident(scenario, device, run, **cfg):
    samples = scenario[0]
    cap = torch.from_numpy(samples.view(np.int16).reshape(-1, 50000, 2)
                           ).to(device)
    a, b = _receiver(scenario, device, **cfg), _receiver(scenario, device,
                                                         **cfg)
    run(a, None)
    run(b, cap)
    assert len(a.fixes) == len(b.fixes) > 0
    for fa, fb in zip(a.fixes, b.fixes):
        assert fa.mc == fb.mc
        np.testing.assert_array_equal(fa.x_ecef, fb.x_ecef)
        assert (fa.pos_score, fa.vel_score) == (fb.pos_score, fb.vel_score)
    for x, y in zip(a.flip_log, b.flip_log):
        np.testing.assert_array_equal(x, y)
    return a


def _batched(rx, cap):
    # 14 blocks in batches of 4, 4, 4, 2, two in flight
    rx.run_batched(14, lookahead=4, raw_blocks_dev=cap, pipeline=True,
                   pipeline_depth=2)


def _integrated(rx, cap):
    rx.run_integrated(3, 4, raw_blocks_dev=cap, coherent=True)


def test_file_mode_run_batched_equals_device_resident(scenario):
    rx = _file_and_resident(scenario, "cpu", _batched)
    assert len(rx.fixes) == 14
    assert rx.rawfile.sample_pos == 14 * 50000
    assert not [t for t in threading.enumerate()
                if t.name == "raw-prefetch"]


def test_file_mode_run_integrated_equals_device_resident(scenario):
    rx = _file_and_resident(scenario, "cpu", _integrated, refine="newton")
    assert len(rx.fixes) == 3 and rx.rawfile.sample_pos == 12 * 50000


def test_file_mode_reader_error_leaves_no_thread(scenario):
    """The file ends inside the third batch: the reader's EOFError comes
    out of run_batched and the prefetcher is closed."""
    samples, hand, arr, grid = scenario
    rx = DPEReceiver(SampleFile(samples=samples[:50000 * 10].copy(), fs=FS),
                     copy.deepcopy(hand), grid=grid, eph=copy.deepcopy(arr),
                     device="cpu")
    with pytest.raises(EOFError):
        rx.run_batched(12, lookahead=4)
    assert len(rx.fixes) == 8
    assert _wait_for(lambda: not [t for t in threading.enumerate()
                                  if t.name == "raw-prefetch"])


def test_file_mode_reads_a_capture_file_without_warnings(scenario, tmp_path,
                                                         monkeypatch):
    """Batches staged from a capture file (a read-only memmap) are copied
    before torch takes them (torch warns on a non-writable array, once a
    process, so the test watches torch.from_numpy itself); the fixes are
    those of the samples in memory."""
    samples, hand, arr, grid = scenario
    path = tmp_path / "cap.dat"
    samples[:50000 * 8].tofile(path)
    rxs = [_receiver(scenario, "cpu"),
           DPEReceiver(SampleFile(str(path), fs=FS), copy.deepcopy(hand),
                       grid=grid, config=DPEConfig(ekf_mode="alpha"),
                       eph=copy.deepcopy(arr), device="cpu")]
    from_numpy = torch.from_numpy

    def writable_only(a):
        assert a.flags.writeable, "a read-only batch reached torch"
        return from_numpy(a)

    monkeypatch.setattr(torch, "from_numpy", writable_only)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for rx in rxs:
            rx.run_batched(8, lookahead=4)
    for fa, fb in zip(*(rx.fixes for rx in rxs)):
        np.testing.assert_array_equal(fa.x_ecef, fb.x_ecef)


@pytest.mark.cuda
def test_file_mode_equals_device_resident_on_card(scenario):
    """Pinned ring buffers, the copy stream and its events: the staged
    batches are the file's, so the fixes are the device-resident run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _file_and_resident(scenario, "cuda", _batched)
    _file_and_resident(scenario, "cuda", _integrated)
