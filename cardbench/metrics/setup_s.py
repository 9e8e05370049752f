"""setup_s: seconds from the process's start to the window's (host clock):
importing torch, building or loading the kernels, drawing the operands on
the device and the warm rounds."""


def read(record):
    return record["setup_s"]
