"""1 - (the union of the device's operation intervals / the profiled
pass's span), in percent."""


def read(rec):
    t = rec.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t["window_s"] else None
