"""The real seeds of the sampled steps completed in the window, over the
window's seconds."""


def read(r):
    if r["mode"] != "sampled":
        return None
    return r["seeds"] / r["window_s"]
