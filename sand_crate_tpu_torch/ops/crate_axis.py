"""The crate axis shared by the pair operators and their batched cases.

A crate-axis operator (``sand_crate::dense_pairs`` and ``::window_pairs``
in ops/pair_batch.py, ``::pm_pass`` in ops/pmajor.py, ``::pair_pass_a`` and
``::pair_pass_b_emit`` in ops/pair_kernel.py) takes its per-crate operands
with a leading crate axis B and launches one kernel for all B crates on the
card; on the CPU it runs its plain version crate by crate
(:func:`crates_plain`).  :func:`register_crate_vmap` gives it the vmap rule
that folds a vmapped batch into that axis.  :func:`padded_crates` and
:func:`spread_widely` make and describe the batched hard inputs of
ops/pmajor_cases.py and ops/grid_cases.py.
"""

from __future__ import annotations

import torch

# The name of the batched cases' crate with no alive particle.
EMPTY = "empty"


def on_cpu_or_cuda(what: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on the CPU or a CUDA device.  The entries
    check before they call an operator: a tensor on the meta device never
    reaches the operator's body (the dispatcher asks for a fake
    implementation first)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors on {t.device}; expected cpu or cuda")


def crates_plain(name, plain, per_crate, *rest):
    """A crate-axis operator's plain version: ``plain`` on each crate's
    ``per_crate`` operands alone, stacked; a batch of no crates raises."""
    if per_crate[0].shape[0] == 0:
        raise ValueError(f"{name}: a batch of no crates")
    outs = [plain(*(x[b] for x in per_crate), *rest) for b in range(per_crate[0].shape[0])]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(torch.stack(o) for o in zip(*outs))


def _fold(x, dim, n):
    """A per-crate operand under vmap as (n * B, ...), contiguous: the
    vmapped dim moved to the front (an unbatched operand expanded to the n
    vmapped crates), merged with the operator's own crate axis B."""
    x = x.unsqueeze(0).expand((n,) + x.shape) if dim is None else x.movedim(dim, 0)
    return x.reshape((-1,) + tuple(x.shape[2:])).contiguous()


def _unfold(out, n):
    return out.reshape((n, out.shape[0] // n) + tuple(out.shape[1:]))


def register_crate_vmap(op, n_per: int) -> None:
    """The vmap rule of a crate-axis operator whose first ``n_per``
    arguments are per crate: the vmapped batch folded into the operator's
    crate axis, one call (one launch a kernel) for all of it."""
    def rule(info, in_dims, *args):
        n = info.batch_size
        out = op(*(_fold(x, d, n) for x, d in zip(args[:n_per], in_dims)), *args[n_per:])
        if isinstance(out, tuple):
            return tuple(_unfold(o, n) for o in out), (0,) * len(out)
        return _unfold(out, n), 0

    op.register_vmap(rule)


def padded_crates(names, sorted_particles, n_cells: int, device) -> list:
    """Each of the cases ``names`` as (pos, vel, alive, cell ids int32) in
    cell-sorted order, from ``sorted_particles(name)`` (EMPTY: no alive
    particle), padded with dead particles (cell id ``n_cells``, sorted
    last) to the largest case's size."""
    none = torch.zeros((0, 2), dtype=torch.float32, device=device)
    crates = [(none, none, torch.zeros(0, dtype=torch.bool, device=device),
               torch.zeros(0, dtype=torch.int32, device=device)) if name == EMPTY
              else sorted_particles(name) for name in names]
    P = max(c[0].shape[0] for c in crates)
    pad = torch.nn.functional.pad
    return [(pad(pos, (0, 0, 0, P - pos.shape[0])), pad(vel, (0, 0, 0, P - pos.shape[0])),
             pad(alive, (0, P - pos.shape[0]), value=False),
             pad(cid.to(torch.int32), (0, P - pos.shape[0]), value=n_cells))
            for pos, vel, alive, cid in crates]


def spread_widely(counts) -> bool:
    """Whether a batch's alive counts hold an empty crate and live crates
    ten times apart or more."""
    live = [c for c in counts if c]
    return 0 in counts and len(live) > 1 and max(live) >= 10 * min(live)
