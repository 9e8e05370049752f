"""mla_roofline: the MLA blocks' bound (each of the five projections'
``roofline.call_bound_s`` and the causal core's FLOPs at the card's peak,
``cardbench/glm_roofline.py``, a block for each ``repro_torch.mla.core`` span
begun in the traced span of the loop) over the device time of every kernel
the host launched inside ``repro_torch.mla.proj`` and ``repro_torch.mla.core``
spans there (matched by correlation id), in %.  Nothing where the trace
holds no such span or kernel."""


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("mla_kernel_s") or not tr.get("mla_bound_s"):
        return None
    return 100.0 * tr["mla_bound_s"] / tr["mla_kernel_s"]
