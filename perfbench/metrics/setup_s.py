"""Seconds from the process's start to the window's: imports, the card's
context, the columns, building the kernels where they are not built, and
the warm-up query."""


def read(run):
    return run.setup_s
