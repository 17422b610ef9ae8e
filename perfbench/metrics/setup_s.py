"""setup_s: seconds from the process's start to the window's first iteration."""


def read(run):
    return run.setup_s
