"""The one generator of the benchmark's traffic.

A mix (``traffic/<mix>.json``) names the entry point of the port that the
window drives (``entry``) and its parameters; a configuration
(``configs/<config>.json``) gives the world and how many crates run it.
Each entry is a class with the same surface: ``set_up()`` builds and warms
the program from the seed, ``unit()`` runs one unit of the window (a tick
or a frame) and returns the particle-steps it completed, ``drain()`` waits
for the work in flight and returns its particle-steps, and the checked
ticks (snapshots of the program's state before and after one tick of the
timed path) are kept for the comparison after the window.

* ``physics_tick``: one ``Crate.physics_tick()`` a unit, timed on the host
  clock (it ends with its own read-back of ``force_dv``).  The alive count
  is the one ``set_debug_prints`` wrote.
* ``stream_frames``: one frame of ``Crate.stream_frames(...,
  ticks_per_frame)`` a unit; each frame's alive mask is counted (touched)
  and the frame dropped.  Frames carry no identity or velocity, so once
  the window closes a stream of a few chunks is recorded, replayed one
  tick at a time from the same state, and each frame held to its tick.
* ``batched_run``: ``BatchedCrates.run(ticks_per_frame)`` then the batch's
  frame copied into one of ``host_buffers`` reused pinned buffers; a
  buffer's alive masks are counted when it is reused or drained.  A
  checked frame runs as ``run(1)`` and ``run(ticks_per_frame - 1)``.

Nothing here sets a knob of the program: ``run.py`` clears every
``SAND_CRATE_*`` variable before the program is imported.
"""

from __future__ import annotations

import os
import random
import tempfile
import time

import numpy as np
import torch

from . import check


def world_config(cfg: dict):
    from sand_crate_tpu_torch import load_config_dict

    return load_config_dict({"world": cfg["world"]})


def coefficients(cfg: dict, seed: int, device) -> dict:
    """Each crate's coefficients as (B,) float32 tensors (gravity (B, 2),
    max_particles (B,) int32): the configuration's, and for each key of
    ``random_ranges``, a uniform draw in its range for every crate, in the
    file's key order, from a generator on the card seeded with the file's
    ``coefficient_seed``.  So every run has the same set of coefficients;
    ``seed`` deals them out to the crates in an order of its own."""
    B = cfg.get("crates", 1)
    out = {}
    for k, v in cfg["world"]["coefficients"].items():
        dtype = torch.int32 if k == "max_particles" else torch.float32
        t = torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
        out[k] = t.expand((B,) + t.shape).clone()
    ranges = cfg.get("random_ranges") or {}
    if ranges:
        gen = torch.Generator(device=device)
        gen.manual_seed(cfg["coefficient_seed"])
        for k, (lo, hi) in ranges.items():
            u = torch.rand((B,), generator=gen, device=device)
            lo_t = torch.tensor(lo, dtype=torch.float32, device=device)
            hi_t = torch.tensor(hi, dtype=torch.float32, device=device)
            out[k] = lo_t + u * (hi_t - lo_t)
        gen.manual_seed(seed)
        order = torch.randperm(B, generator=gen, device=device)
        out = {k: v[order] for k, v in out.items()}
    return out


def _check_units(mix: dict, seed: int, offset: int) -> set:
    lo, hi = mix.get("check_span", (1, 1))
    rng = random.Random(seed)
    return {offset + rng.randint(lo, hi) for _ in range(mix.get("check_ticks", 0))}


class Entry:
    """What every entry keeps: the checked ticks and the start."""

    batched = False

    def __init__(self, cfg: dict, mix: dict, seed: int, device, skip_units: int = 0):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.coef = coefficients(cfg, seed, device)
        self.checked = []  # (before, after, generator state)
        self.frame_gaps = []  # each recorded frame against its state, where frames are recorded
        self.start = None  # the state before the first tick
        self.check_at = _check_units(mix, seed, skip_units)
        self.n = 0  # units run in the window
        self.tick_ms = []

    def _snap(self, state):
        return check.snapshot(state, self.batched)

    def after_window(self):
        """A checked unit the window did not reach (a short window) runs
        now, through the same entry."""
        for _ in range(sum(k > self.n for k in self.check_at)):
            self._checked_tick()


class PhysicsTick(Entry):
    def _build(self):
        from sand_crate_tpu_torch import Crate

        kw = {} if self.cfg.get("forces_mode", "auto") == "auto" else {
            "forces_mode": self.cfg["forces_mode"]}
        self.crate = Crate(world_config(self.cfg).world_config, seed=self.seed,
                           device=self.device, **kw)
        self.start = check.to_host(self._snap(self.crate.state))

    def set_up(self):
        self._build()
        for _ in range(self.mix["warm_ticks"]):
            self.crate.physics_tick()

    def _checked_tick(self):
        before = self._snap(self.crate.state)
        self.crate.physics_tick()
        self.checked.append((before, self._snap(self.crate.state), None))

    def _alive(self) -> int:
        text = self.crate.debug_prints
        i = text.index("Particles: ") + 11
        return int(text[i:text.index("\n", i)])

    def unit(self) -> int:
        self.n += 1
        check_now = self.n in self.check_at
        if check_now:
            before = self._snap(self.crate.state)
        t0 = time.perf_counter()
        self.crate.physics_tick()
        self.tick_ms.append((time.perf_counter() - t0) * 1e3)
        if check_now:
            self.checked.append((before, self._snap(self.crate.state), None))
        return self._alive()

    def drain(self) -> int:
        return 0

    @property
    def state(self):
        return self.crate.state

    def release(self):
        del self.crate


class StreamFrames(PhysicsTick):
    def set_up(self):
        self._build()
        tpf = self.mix["ticks_per_frame"]
        for _ in self.crate.stream_frames(self.mix["warm_ticks"] // tpf, tpf,
                                          self.mix["chunk_frames"]):
            pass
        self.stream = self.crate.stream_frames(1 << 40, tpf, self.mix["chunk_frames"])

    def unit(self) -> int:
        self.n += 1
        frame = next(self.stream)
        return int(np.count_nonzero(frame["alive"])) * self.mix["ticks_per_frame"]

    def drain(self) -> int:
        self.stream.close()
        torch.cuda.synchronize(self.device) if self.device.type == "cuda" else None
        return 0

    def after_window(self):
        """The checked stream: ``check_frames`` frames of ``stream_frames``
        in chunks of ``chunk_frames`` from the state the window left, as
        the window runs it (a chunk in flight while the one before is
        copied), each frame copied out as it is yielded.  The crate is then
        put back into that state (``save_checkpoint``,
        ``restore_checkpoint``) and runs the same ticks one
        ``physics_tick()`` at a time: every frame is held to the state after
        its tick (``frame_gap``), and ``check_ticks`` of those ticks, drawn
        from the seed, are the checked ticks."""
        tpf, n = self.mix["ticks_per_frame"], self.mix["check_frames"]
        fd, path = tempfile.mkstemp(suffix=".npz")
        os.close(fd)
        try:
            self.crate.save_checkpoint(path)
            frames = [{k: np.array(v) for k, v in f.items() if k in check.FRAME_FIELDS}
                      for f in self.crate.stream_frames(n, tpf, self.mix["chunk_frames"])]
            self.crate.restore_checkpoint(path)
        finally:
            os.unlink(path)
        rng = random.Random(self.seed)
        at = {rng.randint(1, n) for _ in range(self.mix.get("check_ticks", 0))}
        for i, frame in enumerate(frames, 1):
            before = self._snap(self.crate.state) if i in at else None
            for _ in range(tpf):
                self.crate.physics_tick()
            after = self._snap(self.crate.state)
            self.frame_gaps.append(check.frame_gap(frame, after))
            if before is not None:
                self.checked.append((before, after, None))

class BatchedRun(Entry):
    batched = True

    def set_up(self):
        from sand_crate_tpu_torch import Params
        from sand_crate_tpu_torch.sweep import BatchedCrates

        params = Params(**{k: self.coef[k] for k in Params._fields})
        self.crates = BatchedCrates(world_config(self.cfg), params, seed=self.seed,
                                    device=self.device)
        self.start = check.to_host(self._snap(self.crates.state))
        warm, at = self.mix["warm_ticks"], self.mix.get("setup_check_tick")
        if at:
            self.crates.run(at)
            self._checked_tick()
            warm -= at + 1
        self.crates.run(warm)
        st = self.crates.state
        pin = self.device.type == "cuda"
        self.host = [{k: torch.empty(getattr(st, k).shape, dtype=getattr(st, k).dtype,
                                     pin_memory=pin) for k in self.mix["frame_fields"]}
                     for _ in range(self.mix["host_buffers"])]
        self.done = [None] * len(self.host)
        self._copy(0)
        self._retire(0)

    def _checked_tick(self):
        before = self._snap(self.crates.state)
        gen_state = self.crates.generator.get_state()
        self.crates.run(1)
        self.checked.append((before, self._snap(self.crates.state), gen_state))

    def _copy(self, slot: int):
        st = self.crates.state
        for k, buf in self.host[slot].items():
            buf.copy_(getattr(st, k), non_blocking=True)
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self.done[slot] = ev
        else:
            self.done[slot] = True

    def _retire(self, slot: int) -> int:
        ev = self.done[slot]
        if ev is None:
            return 0
        if ev is not True:
            ev.synchronize()
        self.done[slot] = None
        return int(np.count_nonzero(self.host[slot]["alive"].numpy())) * self.mix["ticks_per_frame"]

    def unit(self) -> int:
        slot = self.n % len(self.host)
        self.n += 1
        tpf = self.mix["ticks_per_frame"]
        if self.n in self.check_at:
            self._checked_tick()
            if tpf > 1:
                self.crates.run(tpf - 1)
        else:
            self.crates.run(tpf)
        steps = self._retire(slot)
        self._copy(slot)
        return steps

    def drain(self) -> int:
        return sum(self._retire(s) for s in range(len(self.host)))

    @property
    def state(self):
        return self.crates.state

    def release(self):
        del self.crates


ENTRIES = {"physics_tick": PhysicsTick, "stream_frames": StreamFrames,
           "batched_run": BatchedRun}


def entry(cfg: dict, mix: dict, seed: int, device, skip_units: int = 0) -> Entry:
    """The mix's entry; no checked unit falls in the first ``skip_units``."""
    return ENTRIES[mix["entry"]](cfg, mix, seed, device, skip_units)
