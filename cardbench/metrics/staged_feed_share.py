"""staged_feed_share: the live operands of the run's bfloat16 launches (the
x of each live tenant, the w of each live segment) that reached the kernels
by the staged feed, over all their live operands, in %, from the launcher's
own counts by feed (``repro_torch.kernels.launch_stats()["feed"]``: a
tensor map of their own, a shared one, staged).  Nothing where the run
launched no kernel (a CPU run), launched no bfloat16 kernel, or the program
keeps no such counter."""


def read(record):
    if not sum(record.get("launches", {}).values()):
        return None
    try:
        from repro_torch.kernels import launch_stats
    except ImportError:
        return None
    feed = launch_stats().get("feed")
    if not feed or not sum(feed.values()):
        return None
    return 100.0 * feed["staged"] / sum(feed.values())
