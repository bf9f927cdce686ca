"""The port's mesh on the card: NCCL at world size 1 in this process, and
two gloo ranks sharing cuda:0 (NCCL refuses two ranks on one device), each
held to the single-device run on the card (no channel split): fixes and
flips to the bit. At world size 1 nothing is split; on two ranks each
correlates 3 or 2 of a dispatch's 5 blocks, and K5's windows do not
depend on which blocks share its launch, so they are the whole batch's
bits (chip_smoke.py phase 25 holds that at full width). Marked `cuda`;
they skip without a card. This file imports nothing of JAX or of the JAX
package, so it runs on a machine with the card alone:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_mesh_cuda.py
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu_torch.io.handoff import write_handoff
from navlab_dpe_sdr_tpu_torch.io.rawfile import DTYPE_IQ16
from navlab_dpe_sdr_tpu_torch.io.scenario import make_scenario
from navlab_dpe_sdr_tpu_torch.libgnss import frames
from navlab_dpe_sdr_tpu_torch.parallel import mesh as pmesh

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_mesh_ranks as ranks  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NCCL and the kernels)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """10 blocks of the 8-PRN scenario, its handoff 50 m off truth."""
    d = tmp_path_factory.mktemp("mesh_cuda")
    sim, hand, _ = make_scenario(nav_data=True)
    n = 50000 * 10
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    hand.x_ecef[0:3] = frames.enu_to_ecef(hand.x_ecef[0:3],
                                          np.array([30.0, -40.0, 15.0]))
    np.save(d / "s8.npy", samples)
    write_handoff(str(d / "s8.csv"), hand)
    return d


def test_nccl_world_one_equals_single(dev, inputs):
    want = ranks.run_case("batched", str(inputs), None, device=dev)
    m = pmesh.make_mesh(device=dev)
    try:
        assert m.backend == "nccl" and m.size == 1
        got = ranks.run_case("batched", str(inputs), m)
        assert m.collectives > 0
    finally:
        m.close()
    for k in ("fixes", "flips"):
        np.testing.assert_array_equal(got[k], want[k])


def test_two_gloo_ranks_share_the_card(dev, inputs, tmp_path):
    want = ranks.run_case("batched", str(inputs), None, device=dev)
    runs = ranks.run_ranks(tmp_path, 2, 1, inputs, ["batched"], 600,
                           device="cuda:0")
    for run in runs:
        np.testing.assert_array_equal(run["batched.fixes"], want["fixes"])
        np.testing.assert_array_equal(run["batched.flips"], want["flips"])
