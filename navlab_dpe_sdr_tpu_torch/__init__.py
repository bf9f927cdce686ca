"""navlab_dpe_sdr_tpu_torch — the PyTorch/CUDA port of navlab_dpe_sdr_tpu.

The port runs the receiver on an NVIDIA H100 (Hopper, sm_90a). It mirrors
the JAX package's layout module for module, and holds itself to that
package, which stays the reference:

- host-side float64 numpy layers (constants, io/*, libgnss/*, models/grid,
  models/ekf) are the port's own copies under the old names, held
  bit-equal to the JAX package's by tests/test_torch_hostlayers.py; objects
  of either package (Handoff, EphArray, Grid, SampleFile) are taken by
  their fields, and the handoff file reads both ways;
- device work is plain PyTorch on explicit `torch.device`s (ops/*,
  models/*), with every TPU kernel of the ported path rewritten by hand
  for Hopper (ops/csrc/*.cu, built at first use by ops/_build.py).

Nothing here imports jax or any module of navlab_dpe_sdr_tpu: at run time
the port needs torch, numpy and scipy alone. Its tests run on the CPU
against the JAX package,

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py -q -m 'not slow'

and `python3 chip_smoke.py` drives it on a machine with an H100 (it builds
the kernels with nvcc there and holds each to its plain PyTorch version).
"""

__version__ = "0.1.0"
