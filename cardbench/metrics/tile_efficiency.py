"""tile_efficiency: the multiply-adds the tenants' GEMMs need over those the
kernels' K loops issue (whole 64 x 64 tiles, the depth rounded up to the K
slice), in %, from the program's launch counters
(``repro_torch.kernels.launch_stats``) over the run's launches: every round
replays one plan, so each counts alike.  Nothing where the run launched no
kernel (a CPU run) or the program keeps no such counters."""


def read(record):
    if not sum(record.get("launches", {}).values()):
        return None
    try:
        from repro_torch.kernels import launch_stats
    except ImportError:
        return None
    stats = launch_stats()
    if not stats["macs_issued"]:
        return None
    return 100.0 * stats["macs_useful"] / stats["macs_issued"]
