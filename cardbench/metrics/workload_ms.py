"""workload_ms: one round's time, the whole window over the rounds completed
in it (host clock; the paper's computation time of the workload)."""


def read(record):
    if not record.get("rounds"):
        return None
    return 1e3 * record["window_s"] / record["rounds"]
