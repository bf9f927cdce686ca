#!/usr/bin/env python3
"""The port's benchmark: bench.py's protocol on navlab_dpe_sdr_tpu_torch.

    python3 bench_torch.py [n_blocks [lookahead [group_k [depth]]]] [--device cuda|cpu]

Defaults 2250 50 5 4 on the card ("cuda"; raises without one). The kernels
are built from the checkout's sources at first use. The last line of
standard output is the JSON object (navlab_dpe_sdr_tpu_torch/bench.py).
"""

import sys

from navlab_dpe_sdr_tpu_torch.bench import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
