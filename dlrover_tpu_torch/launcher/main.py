"""Console entry of ``tpurun-torch``: the port of ``dlrover_tpu/launcher/main.py``."""

import sys

from .elastic_run import main

if __name__ == "__main__":
    sys.exit(main())
