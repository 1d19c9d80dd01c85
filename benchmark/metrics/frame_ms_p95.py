"""The 95th percentile of all the window's frame times, each from one
``step()`` return to the next (host clock), linear between ranks."""

import numpy as np


def read(rec):
    return float(np.percentile(rec.frame_ms, 95)) if rec.frame_ms else None
