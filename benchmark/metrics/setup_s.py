"""setup_s (s, host_clock): seconds from the process's start to the window's
start: imports, making the inputs, loading and quantizing, building the
index, every kernel build and the warm-up steps."""


def read(r):
    return r.setup_s
