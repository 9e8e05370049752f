"""enqueue_us: host microseconds a call of the program takes to return, no
synchronise, as a mean over the window's calls outside the profiled rounds
(the launch path: mode choice, autotune, launch table, the ctypes launch)."""


def read(record):
    if not record.get("calls"):
        return None
    return 1e6 * record["enqueue_s"] / record["calls"]
