"""The step's own CG iteration count, a mean over the profiled pass."""


def read(rec):
    if not rec.counts:
        return None
    return sum(c["cg_iters"] for c in rec.counts) / len(rec.counts)
