"""padded_windows: the share (%) of the windows handed to the model that are
the wrap-padding of a block's last batch, from the port's counters
(``gwkit_torch.utils.tracing.COUNTERS``). The driver hands the slice only the
kernels' launch counts, so this reads the counters over the whole run: the
warm segment and the window, whose segments share one geometry, so the share
is the traced slice's too. None on a program without the counters."""


def read(ctx):
    try:
        from gwkit_torch.utils.tracing import COUNTERS
    except ImportError:
        return None
    real, padded = COUNTERS.get("windows", 0), COUNTERS.get("padded_windows", 0)
    return 100.0 * padded / (real + padded) if real + padded else None
