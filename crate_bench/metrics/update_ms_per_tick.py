"""Device milliseconds a tick in the velocity update and the boundary:
B2 (``ops/kick.py``, ``kick_kernel``: the kicks, wall bounce, CCD and the
integrate) and B1 (``ops/boundary.py``, ``ghost_kernel``: the virtual
colliders and the hard wall, in full and positions-only)."""

KERNELS = ("kick_kernel", "ghost_kernel")


def read(view):
    ops = view.kernels(KERNELS)
    if not ops:
        return None
    return view.ms_per_tick(ops)
