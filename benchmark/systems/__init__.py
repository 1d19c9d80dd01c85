"""The adapters of the configurations' systems, one module a system, named
by a configuration's ``system``: each builds the program's sim on the
benchmark's start state, replays it, copies its state and compares it with
its plain reference."""


def check_covered(cfg: dict, covered: dict):
    """Raise where the configuration sets a parameter to another value than
    the plain reference computes."""
    for key, want in covered.items():
        if cfg["params"].get(key, want) != want:
            raise ValueError(f"{cfg['name']}: {key}={cfg['params'][key]!r} "
                             f"lies outside the reference ({want!r})")
