"""navlab_dpe_sdr_tpu_torch — the PyTorch/CUDA port of navlab_dpe_sdr_tpu.

The port runs the receiver on an NVIDIA H100 (Hopper, sm_90a). It mirrors
the JAX package's layout module for module, and holds itself to that
package, which stays the reference:

- host-side float64 numpy layers (constants, libgnss, io, models/grid,
  models/ekf) are imported from navlab_dpe_sdr_tpu, not copied;
- device work is plain PyTorch on explicit `torch.device`s (ops/*,
  models/*), with every TPU kernel of the ported path rewritten by hand
  for Hopper (ops/csrc/*.cu, built at first use by ops/_build.py).

Nothing here imports jax.
"""

__version__ = "0.1.0"
