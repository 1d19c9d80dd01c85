"""The SPD re-solve's CG iterations (part of the step's ``cg_iters``), a
mean over the profiled pass; None where the counts lack them."""


def read(rec):
    if not rec.counts or "spd_iters" not in rec.counts[0]:
        return None
    return sum(c["spd_iters"] for c in rec.counts) / len(rec.counts)
