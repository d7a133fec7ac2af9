"""setup_s: seconds from the start of the process to the start of the
measured window: imports, the host matrix, the program's set-up and first
factor, the mix's pool on the device and the warm-up systems (with the
kernels' build in a checkout's first run)."""


def read(run):
    return run.setup_s
