"""setup_s: seconds from the process's start to the first timed step:
imports, the kernels' build or load, the inputs from the seed, the
warm-up of every shape the cell uses."""


def read(rec):
    return rec["setup_s"]
