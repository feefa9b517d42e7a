import sys

from .cli import main

# The __name__ guard matters: spawn-based multiprocessing workers
# (repro_torch.sim.batch once CUDA is up or on multithreaded parents)
# re-import the parent's main module, and an unguarded sys.exit(main())
# would re-run the CLI there.
if __name__ == "__main__":
    sys.exit(main())
