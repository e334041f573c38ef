"""Set-up seconds: everything before the window (the kernel library's
build or load, the inputs from the seed, the program's set-up, the
warm-up of the cell's own shapes), by the host clock."""


def read(out):
    return out.setup_s
