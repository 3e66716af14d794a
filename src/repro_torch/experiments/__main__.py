"""``python -m repro_torch.experiments`` entry point (port of ``repro.experiments``)."""
import sys

from repro_torch.experiments import main

if __name__ == "__main__":
    sys.exit(main())
