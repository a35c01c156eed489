"""Seconds from the process's start to the window's: importing torch and
the port, loading (or, in a fresh checkout, building) the kernels, the
inputs and weights, and one run of each pool batch, which captures its
program."""


def read(run):
    return run.setup_s
