"""Seconds from the process's start to the window's first request: import,
inputs, kernel libraries, index build and warm-up."""


def read(run):
    return run.setup_s
