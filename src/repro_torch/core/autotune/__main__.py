"""Entry point: ``python -m repro_torch.core.autotune`` (see package
docstring)."""
import sys

from . import main

if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. `... | head` closing the pipe early
        sys.exit(0)
