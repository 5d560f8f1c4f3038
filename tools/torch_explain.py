#!/usr/bin/env python3
"""tdr_explain for the PyTorch port: straggler, critical-path and
postmortem readouts over the port's segments and bundles.

A thin wrapper around ``rocnrdma_tpu_torch.tools.explain.main``, the
port's counterpart of ``tools/tdr_explain.py``; it takes the same
options and prints the same text and JSON::

    python3 tools/torch_explain.py --postmortem DIR
    python3 tools/torch_explain.py --collect HOST:PORT --world NAME
    python3 tools/torch_explain.py --trace RAW.json --json --out fleet.json
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from rocnrdma_tpu_torch.tools.explain import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
