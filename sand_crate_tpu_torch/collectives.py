"""The collectives of the spatial bands, on one process or on several.

The JAX spatial step runs per shard inside ``jax.shard_map`` and talks to
its neighbors with ``lax.axis_index``, ``lax.ppermute`` on the forward and
backward rings, ``lax.psum`` and ``lax.all_gather``.  The port's band step
(``spatial.py``) takes the same small interface from a *member* object,
one per shard:

* ``rank`` / ``size``;
* ``exchange(to_next, to_prev) -> (from_prev, from_next)``: both rings at
  once, as lists of tensors; ``to_next[i]`` arrives at rank + 1 as its
  ``from_prev[i]``, ``to_prev[i]`` at rank - 1 as its ``from_next[i]``
  (the ring wraps, as ``ppermute`` over a full permutation does);
* ``psum(x)`` and ``all_gather(x)`` (a new leading axis of ``size``, in
  rank order).

Two implementations, which agree bit for bit (every collective of the band
step moves data or int32 counts, never a floating-point sum):

* :class:`LocalGroup`: every shard in this process on one device, one
  Python thread per shard (a pool of ``size`` threads) taking turns:
  exchanges meet in shared slots, a wait has a timeout, and a shard that
  raises aborts the others, so a failing shard fails the whole call
  instead of leaving the others waiting.  Tensors pass between the threads
  by reference; on a GPU every thread enqueues on the stream and device
  that are current in the thread that called ``run`` (PyTorch's current
  stream is per thread), so a tensor is produced before any thread that
  received it enqueues a read, and a band step captured as a CUDA graph
  records every shard's launches.  The counterpart of JAX's virtual CPU
  mesh.
* :class:`DistGroup`: one shard per process of an initialised
  ``torch.distributed`` group: ``batch_isend_irecv`` for the rings,
  ``all_reduce`` and ``all_gather_into_tensor``.  NCCL takes CUDA tensors,
  gloo CPU tensors; a tensor on the other kind of device raises (nothing
  is staged through the host).
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from .state import resolve_device

# Seconds a LocalGroup shard waits for its turn at one exchange.
BARRIER_TIMEOUT = 600.0


def shard_generator(seed: int, rank: int, device) -> torch.Generator:
    """The generator of shard ``rank``: the same rule in every group, so a
    band run draws the same numbers on LocalGroup and DistGroup."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) * 1_000_003 + int(rank))
    return g


def _current_stream(device: torch.device):
    """The calling thread's current stream on ``device`` (None off CUDA)."""
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


@contextlib.contextmanager
def _on_stream(stream):
    """Make ``stream`` (and its device) current in this thread."""
    if stream is None:
        yield
        return
    with torch.cuda.device(stream.device), torch.cuda.stream(stream):
        yield


class GroupAborted(RuntimeError):
    """Raised in a LocalGroup shard when another shard failed or an
    exchange timed out."""


class _LocalMember:
    """One shard's view of a :class:`LocalGroup`."""

    def __init__(self, group: "LocalGroup", rank: int) -> None:
        self.group = group
        self.rank = rank
        self.size = group.size
        self.round = 0

    def _meet(self, value):
        """Publish ``value`` and return every shard's, in rank order."""
        g = self.group
        buf = g._slots[self.round % 2]
        self.round += 1
        buf[self.rank] = value
        g._pass_turn(self.rank)
        g._await_turn(self.rank)
        return list(buf)

    def exchange(self, to_next, to_prev):
        values = self._meet((list(to_next), list(to_prev)))
        return values[(self.rank - 1) % self.size][0], values[(self.rank + 1) % self.size][1]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        values = self._meet(x)
        total = values[0]
        for v in values[1:]:
            total = total + v
        return total

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack(self._meet(x))


class LocalGroup:
    """``n_shards`` band shards in this process, on ``device`` (the card
    unless the caller asks for the CPU), one thread each.

    The threads take turns: one runs at a time, in rank order, and hands
    the turn to the next shard at each collective (after publishing its
    value) and when it returns.  Shard r - 1 publishes before shard r
    runs, so when shard 0 gets the turn back every shard has published;
    two slot buffers alternate between rounds, so a round's values stay
    until every shard has read them.  Taking turns keeps the threads from
    contending for the interpreter lock at every tensor operation (on a
    GPU each enqueues its kernels; the device runs them in stream order).
    A wait longer than ``timeout`` seconds, or a shard that raises, aborts
    the call: every other shard raises :class:`GroupAborted`."""

    def __init__(self, n_shards: int, device="cuda", timeout: float = BARRIER_TIMEOUT) -> None:
        if n_shards < 1:
            raise ValueError(f"LocalGroup needs at least one shard, got {n_shards}")
        self.size = int(n_shards)
        self.device = resolve_device(device, "LocalGroup")
        self.timeout = timeout
        self._turn = [threading.Event() for _ in range(self.size)]
        self._slots = [[None] * self.size, [None] * self.size]
        self._aborted = False
        self._pool = ThreadPoolExecutor(self.size, thread_name_prefix="band")
        self._lock = threading.Lock()

    def _pass_turn(self, rank: int) -> None:
        self._turn[(rank + 1) % self.size].set()

    def _await_turn(self, rank: int) -> None:
        if not self._turn[rank].wait(self.timeout):
            self._abort()
            raise GroupAborted(f"shard {rank} waited {self.timeout} s for its turn")
        self._turn[rank].clear()
        if self._aborted:
            raise GroupAborted("another shard failed")

    def _abort(self) -> None:
        self._aborted = True
        for e in self._turn:
            e.set()

    def members(self) -> list[_LocalMember]:
        return [_LocalMember(self, r) for r in range(self.size)]

    def run(self, fn, *per_shard_args) -> list:
        """``fn(member, *args)`` on every shard, one thread each, taking
        turns, each on the caller's current stream and device;
        ``per_shard_args`` are sequences indexed by rank.  Returns the
        results in rank order.  If a shard raises, the others raise
        :class:`GroupAborted` at their next turn and the first shard's own
        error is raised here."""
        stream = _current_stream(self.device)
        with self._lock:  # one run at a time
            self._aborted = False
            for e in self._turn:
                e.clear()
            self._turn[0].set()
            futures = [
                self._pool.submit(self._shard, fn, m, stream,
                                  *(a[m.rank] for a in per_shard_args))
                for m in self.members()
            ]
            results, errors = [], []
            for f in futures:
                try:
                    results.append(f.result())
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    errors.append(e)
            self._slots = [[None] * self.size, [None] * self.size]
            if errors:
                real = [e for e in errors if not isinstance(e, GroupAborted)]
                raise (real or errors)[0]
            return results

    def _shard(self, fn, member, stream, *args):
        try:
            self._await_turn(member.rank)
            with _on_stream(stream):
                out = fn(member, *args)
        except BaseException:
            self._abort()
            raise
        self._pass_turn(member.rank)
        return out

    def close(self) -> None:
        self._pool.shutdown(wait=True)


class DistGroup:
    """This process's shard of an initialised ``torch.distributed`` group
    (rank and world size from it).  ``device`` is where the shard's tensors
    live: CUDA under NCCL (the default, the card), the CPU under gloo."""

    def __init__(self, device="cuda") -> None:
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistGroup: call torch.distributed.init_process_group first")
        self._dist = dist
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.backend = str(dist.get_backend()).lower()
        self.device = resolve_device(device, "DistGroup")
        want = {"nccl": "cuda", "gloo": "cpu"}.get(self.backend)
        if want is None:
            raise ValueError(f"DistGroup: backend {self.backend!r} is neither nccl nor gloo")
        if self.device.type != want:
            raise ValueError(f"DistGroup: the {self.backend} backend takes {want} tensors, "
                             f"not {self.device}")

    def _check(self, t: torch.Tensor) -> torch.Tensor:
        if t.device.type != self.device.type:
            raise ValueError(f"DistGroup ({self.backend}): a tensor on {t.device}, expected "
                             f"{self.device.type}")
        return t.contiguous()

    def exchange(self, to_next, to_prev):
        to_next = [self._check(t) for t in to_next]
        to_prev = [self._check(t) for t in to_prev]
        if self.size == 1:  # the ring is this shard itself
            return to_next, to_prev
        dist = self._dist
        nxt, prv = (self.rank + 1) % self.size, (self.rank - 1) % self.size
        from_prev = [torch.empty_like(t) for t in to_next]
        from_next = [torch.empty_like(t) for t in to_prev]
        # Tags pair each send with its receive (gloo matches on them; with
        # two ranks the previous and the next shard are one process).
        k = len(to_next)
        ops = [dist.P2POp(dist.isend, t, nxt, tag=i) for i, t in enumerate(to_next)]
        ops += [dist.P2POp(dist.irecv, t, prv, tag=i) for i, t in enumerate(from_prev)]
        ops += [dist.P2POp(dist.isend, t, prv, tag=k + i) for i, t in enumerate(to_prev)]
        ops += [dist.P2POp(dist.irecv, t, nxt, tag=k + i) for i, t in enumerate(from_next)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return from_prev, from_next

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        out = self._check(x).clone()
        self._dist.all_reduce(out)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        x = self._check(x)
        out = torch.empty((self.size * x.numel(),), dtype=x.dtype, device=x.device)
        self._dist.all_gather_into_tensor(out, x.reshape(-1))
        return out.view((self.size,) + tuple(x.shape))
