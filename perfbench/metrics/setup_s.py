"""From the process's start to the window's: imports, data, building the
program and loading the weights, warming and capturing every shape the
traffic reaches (the kernels' build too, on a checkout's first run), and the
steps the comparison reads."""


def read(r):
    return r.setup_s
