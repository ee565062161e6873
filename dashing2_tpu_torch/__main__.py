"""`python -m dashing2_tpu_torch` == the dashing2-tpu-torch CLI."""

import sys

from .cli import main

sys.exit(main())
