"""Everything before the window: the process's imports, the inputs made
from the seed, the kernels built or loaded, the program's set-up and the
warm-up (compilation included)."""


def read(run):
    return run.setup_s
