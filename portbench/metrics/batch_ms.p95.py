"""The 95th percentile, over every call of the window, of the time from
the call's start to its outputs on the host (host clock), in ms."""

import numpy as np


def read(ctx):
    if not ctx.latencies:
        return None
    return 1e3 * float(np.percentile(ctx.latencies, 95))
