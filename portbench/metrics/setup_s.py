"""setup_s: seconds from the process's start to the first timed call
(imports, CUDA, the plan, inputs from the seed, warm-up; nvcc in a
checkout's first run).  Host clock."""


def read(run):
    return run.setup_s
