"""mlp_split_share: the share (%) of the encoder layers run on the kernel
chain whose MLP ran as two launches of kernel B, from the port's counters
over the whole run (the warm batch and the window):
``mlp_split_layers`` over it, ``mlp_fused_layers`` (kernel C) and the
plain layer's calls (``_cuda.PLAIN_CALLS["block"]``). 100 when every
layer's MLP ran on B. None on a program without the counters or with no
such layer."""


def read(ctx):
    try:
        from gwkit_torch.ops._cuda import PLAIN_CALLS
        from gwkit_torch.utils.tracing import COUNTERS
    except ImportError:
        return None
    if "mlp_split_layers" not in COUNTERS or "mlp_fused_layers" not in COUNTERS:
        return None
    split = COUNTERS["mlp_split_layers"]
    total = split + COUNTERS["mlp_fused_layers"] + PLAIN_CALLS.get("block", 0)
    return 100.0 * split / total if total else None
