"""Device milliseconds a tick of the pair glue: every kernel, fill and
copy on the card of the traced stretch that is neither a pair-sum kernel
(``pair_ms_per_tick``), nor the velocity update or boundary
(``update_ms_per_tick``), nor a copy to the host (``d2h_ms_per_tick``):
the cell sort, ``ops/pmajor.py``'s ranges and feature rows, the vmapped
stacks of ``sweep`` and the state's copies."""


def read(view):
    named = view.metric("pair_ms_per_tick").KERNELS + view.metric("update_ms_per_tick").KERNELS
    ops = [o for o in view.ops
           if not (o.cat == "kernel" and any(n in o.name for n in named))
           and not (o.cat == "gpu_memcpy" and "DtoH" in o.name)]
    if not ops:
        return None
    return view.ms_per_tick(ops)
