"""setup_s [s]: from the start of the benchmark's process to the start
of the window: imports, CUDA start, the kernels' load (their build on a
checkout's first run), the traffic's data, the sessions and one warm-up
request a client."""


def read(run):
    return run.setup_s
