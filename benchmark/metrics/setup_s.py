"""Seconds from the process's start to the window's: imports, corpus,
the program's build, the weights, warm-up (and, in a checkout's first
run, the kernels' build)."""


def read(rec):
    return rec["setup_s"]
