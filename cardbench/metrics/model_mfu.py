"""model_mfu: the useful FLOPs of the prefill rounds completed in the traced
span of the loop, rounds still in flight (``cardbench/lfm2_roofline.py``),
over the traced window times the card's peak in the configuration's dtype,
in %.  Nothing where the trace saw no device time."""


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("busy_s") or not tr.get("window_s"):
        return None
    return 100.0 * tr["flops"] / (tr["window_s"] * record["peak_flops"])
