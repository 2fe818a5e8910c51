"""The 95th percentile of every step's (trial iteration's) time in the
window, host clock, each ending in the hook's own synchronise."""

import numpy as np


def read(r):
    if not r.get("step_s"):
        return None
    return 1e3 * float(np.percentile(np.asarray(r["step_s"]), 95))
