"""expert_roofline: the expert calls' bound (``cardbench.roofline`` over
each call's routed tenant shapes, from the program's per-layer expert row
counts) over the device time of the fused-GEMM kernels the host launched
inside ``repro_torch.moe.experts`` spans, in the traced span of the loop,
in %.  Nothing where the trace holds no such kernel or the program counts
no routed rows."""


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("expert_kernel_s") or not tr.get("expert_bound_s"):
        return None
    return 100.0 * tr["expert_bound_s"] / tr["expert_kernel_s"]
