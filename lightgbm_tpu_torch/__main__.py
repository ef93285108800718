"""``python -m lightgbm_tpu_torch`` — the CLI entry (src/main.cpp analog;
port of ``lightgbm_tpu/__main__.py``)."""

import sys

from .cli import main

sys.exit(main())
