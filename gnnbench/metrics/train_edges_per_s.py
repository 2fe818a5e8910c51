"""The graph's real directed edges times the training steps (trial
iterations) completed in the window, over the window's seconds."""


def read(r):
    if r["mode"] not in ("full", "trial"):
        return None
    return r["edges"] * r["steps"] / r["window_s"]
