"""setup_s: seconds from the process's start to the measured window's
start — data made from the seed, the program set up, the shapes warmed."""


def read(run):
    return run.setup_s
