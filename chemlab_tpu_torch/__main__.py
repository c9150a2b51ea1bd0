"""``python -m chemlab_tpu_torch @params``: the CLI, on the card."""

import sys

from .start_simulation import main

if __name__ == "__main__":
    sys.exit(main())
