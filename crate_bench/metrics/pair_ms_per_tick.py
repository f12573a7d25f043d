"""Device milliseconds a tick in the pair-sum kernels: K1/K2 and K10 of
``ops/pmajor.py`` (``pm_kernel``, ``pms_kernel``), D1 and D2 of
``ops/pair_batch.py`` (``dense_order_kernel``, ``dense_pass_kernel``,
``window_pass_kernel``) and the grid passes of ``ops/pair_kernel.py``
(``slab_pass_kernel``, ``pass_b_kernel``)."""

KERNELS = ("pm_kernel", "pms_kernel", "dense_order_kernel", "dense_pass_kernel",
           "window_pass_kernel", "slab_pass_kernel", "pass_b_kernel")


def read(view):
    ops = view.kernels(KERNELS)
    if not ops:
        return None
    return view.ms_per_tick(ops)
