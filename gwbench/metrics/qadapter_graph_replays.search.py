"""qadapter_graph_replays: the share (%) of the card's gradient-free Q-scan
and Q-adapter calls that a CUDA graph's replay served, from the port's
counters (``gwkit_torch.utils.tracing.COUNTERS``) over the whole run, read
as ``padded_windows.search.py`` reads them: the warm segment, where the
front end's one eager call and its capture fall, and the window. None on a
program without the counters or with no such call."""


def read(ctx):
    try:
        from gwkit_torch.utils.tracing import COUNTERS
    except ImportError:
        return None
    if "qadapter_graph_replays" not in COUNTERS:
        return None
    replays, eager = COUNTERS["qadapter_graph_replays"], COUNTERS.get("qadapter_eager_calls", 0)
    return 100.0 * replays / (replays + eager) if replays + eager else None
