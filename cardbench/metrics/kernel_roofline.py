"""kernel_roofline: the profiled calls' bounds (cardbench.roofline) over the
device time of the program's two kernels in the trace, in %.  Nothing when
the trace holds no kernel or not one kernel a call."""


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("kernel_s"):
        return None
    return 100.0 * tr["bound_s"] / tr["kernel_s"]
