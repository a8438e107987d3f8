"""Set-up: from the start of the process that prints the result to the
first timed tick's dispatch (torch and CUDA start-up, kernels loaded or
built, the world made from the seed, the engine built, the storm and the
warm ticks); host clock."""


def read(run):
    return run.setup_s
