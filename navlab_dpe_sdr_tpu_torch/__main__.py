"""`python -m navlab_dpe_sdr_tpu_torch` == the port's CLI (cli.main).

Importing this module runs nothing; the CLI starts only under __main__.
"""

from .cli import main

if __name__ == "__main__":
    main()
