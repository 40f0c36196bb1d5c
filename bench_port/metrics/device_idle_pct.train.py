"""Share of the traced window in which no operation ran on the card, while
the model trains."""


def read(ctx):
    d = ctx["device"]
    if d["platform"] != "gpu" or not d["window_s"]:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
