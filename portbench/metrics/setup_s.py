"""Process start to the first timed request: imports, the kernel library,
the inputs and the warm-up."""


def read(record):
    return record["setup_s"]
