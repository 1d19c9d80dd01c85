"""Seconds from the process's start to the end of the warm-up pass:
imports, the card's context, seeding, the sim, the kernels' build on a
first run, one pass of the span."""


def read(rec):
    return rec.setup_s
