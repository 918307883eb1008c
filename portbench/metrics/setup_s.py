"""setup_s: process start to the first timed request: imports, CUDA context,
kernel builds or loads, the backend and its warmup captures, the prefill,
the warm-up load (host clock)."""


def read(run):
    return run["setup_s"]
