"""moe_host_us: host microseconds a MoE layer takes from its router's
launch to its last expert call's return, the wait for its count read
included and the host's work on the other round in flight at the layer's
pause left out: the mean over the traced span's MoE layers, from the
program's armed clock (``repro_torch.models.routed_experts.moe_stats``).
Nothing where the program keeps no such clock."""


def read(record):
    moe = record.get("moe")
    if not moe or not moe.get("armed_layers"):
        return None
    return 1e-3 * moe["layer_ns"] / moe["armed_layers"]
