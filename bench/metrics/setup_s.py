"""setup_s: seconds from the process's start to the window's start
(loading, input generation, the program's build, capture and warm-up)."""


def read(run):
    return run.setup_s
