"""Device operations a tick: every kernel, copy and fill the card ran in
the traced stretch, over the ticks the stretch ran (entry layer:
``engine.Crate``, ``sweep.BatchedCrates.run``, ``graphs.StepGraph``)."""


def read(view):
    if not view.ops:
        return None
    return len(view.ops) / view.ticks
