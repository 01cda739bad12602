"""Share (%) of the traced training steps in which no operation ran on
the card: 1 - the union of the device intervals over the stretch."""


def read(run):
    tr = run.get("trace")
    idle = tr.idle_share() if tr is not None else None
    return None if idle is None else 100.0 * idle
