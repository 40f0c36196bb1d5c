"""Share of the attended query tokens that are padding: the port's
``StageTimer`` counters ``swin.pad_tokens`` over ``swin.tokens``, which
the engine counts once a dispatch from the network's own account of its
windows at the input size, times the slots. Silent where the program
counts no ``swin.tokens``."""


def read(ctx):
    stages = ctx["tallies"]["stages"]
    if not stages.get("swin.tokens"):
        return None
    return 100.0 * stages.get("swin.pad_tokens", 0) / stages["swin.tokens"]
