"""device_idle: the share of the traced window in which no operation ran on
the device, in %."""


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("busy_s") or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
