"""setup_s: from the process's start to the window's: imports, the CUDA
context, the kernels' libraries (built on a checkout's first run), the
instance, and a warm call of the cell's entry point at its shapes."""


def read(r):
    return r["setup_s"]
