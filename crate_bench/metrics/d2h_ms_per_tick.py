"""Device milliseconds a tick of copies from the card to the host: the
frame copies of ``Crate.stream_frames`` and the datagen frame (with the
small read-backs of the tick's diagnostics)."""


def read(view):
    ops = [o for o in view.ops if o.cat == "gpu_memcpy" and "DtoH" in o.name]
    if not ops:
        return None
    return view.ms_per_tick(ops)
