"""The pair kernels' share of their roofline, in %: the least time one
tick's pair sums could take on the card (``yardstick.pair_min_seconds``:
the alive particles' fields read once and their sums written once at the
memory rate, or the counted pairs' operations at the float32 peak,
whichever is longer; counted from a snapshot of the state at the traced
stretch's start), over the measured time a tick of the kernels that
``pair_ms_per_tick`` names."""

from crate_bench.yardstick import pair_min_seconds



def read(view):
    ops = view.kernels(view.metric("pair_ms_per_tick").KERNELS)
    work = view.pair_work
    if not ops or not work or not work.get("alive"):
        return None
    least, _ = pair_min_seconds(work["alive"], work["pairs"])
    return 100.0 * least * 1e3 / view.ms_per_tick(ops)
