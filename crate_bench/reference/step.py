"""One tick of the liquid, written plainly: the reference the runs are judged by.

Plain PyTorch over a batch of crates (a leading crate axis B), in any float
type (float64 for the reference, bfloat16 for the control), from the
state before the tick to the state after it.  It follows the upstream
sand_crate tick (crate.py: spawn, cull, bodies, virtual colliders and the
hard wall, pressures and surface normals, tension, gravity, pressure,
viscosity, wall bounce, continuous collision, integrate) and imports
nothing of the program: it finds neighbours with its own cell list over
pair lists, and sums with ``index_add_``.

The collider jitter is an input of the tick, as the upstream engine draws
it: ``Jitter`` says how.  ``slot_hash`` is the jitter of the large-crate
backend: both particles of a pair are moved by ``(u - 0.5) * amp / sqrt(2)``
with ``u`` an integer hash of the particle's place in the cell-sorted order
after the tick and of the tick; ``generator`` is the jitter of the small
crates: one uniform ``(u - 0.5) * amp`` per particle, drawn from a torch
generator after the emitters' draws, and only the neighbour is moved.

Where the tick decides by a threshold (the diameter cut-off of a pair, the
1.2 r reach of a virtual collider, a move that grazes a padded wall, the
box a particle is culled outside of), a float32 program and this reference
may decide differently within rounding, and the particle's result then
differs by a whole term.  ``flags`` marks each such particle, and each
particle with a neighbour whose pair sums such a pair decided, so that the
comparison can hold the others tightly and count these apart.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .world import FIXED, FREE, MOTORED, RefWorld

EPS = 1e-12
# A distance within this much (in box units) of its threshold is one a
# float32 program may decide either way: a float32 coordinate of magnitude
# up to 4 rounds by up to 2.4e-7, and a difference of two such by 3.4e-7.
BAND = 4e-7
# A move's direction is known to about this share of its length (the
# velocity it comes from is a float32 sum of many terms).
MOVE_BAND = 1e-2
# A jittered pair distance below this share of the diameter leaves the
# pair's direction to rounding.
NEAR = 5e-2

_M32 = 0xFFFFFFFF


def slot_hash_u01(key: torch.Tensor, tick: torch.Tensor) -> torch.Tensor:
    """The collider jitter's integer hash -> [0, 1) with 24 bits, exact:
    h = key * 0x9E3779B9 ^ tick * 0xC2B2AE35 (mod 2^32), then h ^= h >> 15,
    h *= 0x85EBCA6B, h ^= h >> 13, u = (h >> 8) / 2^24."""
    h = (key.long() * 0x9E3779B9) & _M32
    h = h ^ ((tick.long() * 0xC2B2AE35) & _M32)
    h = h ^ (h >> 15)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    return (h >> 8).double() * 2.0**-24


@dataclass
class Jitter:
    kind: str  # "slot_hash" or "generator"
    out_slot: torch.Tensor | None = None  # (B, P): each input slot's place after the tick
    generator_state: torch.Tensor | None = None  # the generator's state before the tick


def _rot90_cw(v):
    return torch.stack([v[..., 1], -v[..., 0]], dim=-1)


def _motor(m, t):
    return m[..., 3] + m[..., 0] * torch.cos(m[..., 1] * t + m[..., 2])


def pair_list(pos, group, diam, cell):
    """Ordered pairs (i, j), i != j, of the same group with |p_i - p_j| <=
    diam[group]: a cell list of size ``cell`` >= every diameter, searched
    over the 3 x 3 cells around each particle.  ``pos`` (N, 2)."""
    dev = pos.device
    n = pos.shape[0]
    if n == 0:
        e = torch.zeros(0, dtype=torch.long, device=dev)
        return e, e
    nx = int(np.ceil(1.0 / cell)) + 4
    c = torch.clamp(torch.floor(pos.double() / cell).long() + 2, 0, nx - 1)
    key = (group * nx + c[:, 1]) * nx + c[:, 0]
    skey, order = torch.sort(key)
    ii, jj = [], []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            target = key + dy * nx + dx
            lo = torch.searchsorted(skey, target)
            hi = torch.searchsorted(skey, target, right=True)
            cnt = hi - lo
            for k in range(int(cnt.max())):
                sel = torch.nonzero(cnt > k).squeeze(1)
                j = order[lo[sel] + k]
                d = pos[sel] - pos[j]
                ok = (group[sel] == group[j]) & (sel != j) & (
                    (d * d).sum(-1) <= diam[group[sel]] ** 2)
                ii.append(sel[ok])
                jj.append(j[ok])
    return torch.cat(ii), torch.cat(jj)


def step(inp: dict, coef: dict, world: RefWorld, jitter: Jitter, dtype=torch.float64) -> dict:
    """The state after one tick of every crate.

    ``inp``: pos, vel (B, P, 2), alive (B, P), uid (B, P), segments
    (B, S, 2, 2), body_lin_vel (B, NB, 2), body_ang_vel (B, NB), time (B,),
    tick (B,).  ``coef``: each coefficient of the configuration as a (B,)
    tensor (gravity (B, 2)).  Returns the new pos, vel, alive, pressure,
    segments, body_lin_vel, body_ang_vel, each by input slot,
    ``flags`` (B, P): particles whose result may differ by rounding (see
    the module's note), and ``gross_dv`` (B, P): dt times the summed
    magnitudes of each particle's pair terms (tension, pressure, viscosity),
    the size of its velocity change before the terms cancel."""
    dev = inp["pos"].device
    f = lambda x: torch.as_tensor(x, device=dev).to(dtype)  # noqa: E731
    pos, vel = f(inp["pos"]).clone(), f(inp["vel"]).clone()
    alive = inp["alive"].clone().bool()
    B, P = alive.shape
    c = {k: f(v) for k, v in coef.items() if k != "max_particles"}
    dt, r, g = c["dt"], c["particle_radius"], c["gravity"]
    diam = 2.0 * r
    flags = torch.zeros((B, P), dtype=torch.bool, device=dev)
    gen = None
    if jitter.kind == "generator":
        gen = torch.Generator(device=dev)
        gen.set_state(jitter.generator_state)

    # -- spawn: each active source emits Binomial(flow, dt) particles into
    # the lowest free slots, within the max_particles budget --
    if world.sources:
        ns = world.max_spawn(P)
        budget = torch.clamp(coef["max_particles"].to(dev).long() - alive.sum(1), min=0)
        used = torch.zeros(B, dtype=torch.long, device=dev)
        free = [torch.nonzero(~alive[b]).squeeze(1) for b in range(B)]
        p = torch.clamp(coef["dt"].to(dev).float(), 0.0, 1.0)
        active_tick = inp["tick"].to(dev).long()
        for src in world.sources:
            n_raw = torch.binomial(torch.zeros_like(p) + src["flow"], p, generator=gen).long()
            u_pos = torch.rand((B, ns, 2), generator=gen, device=dev)
            u_vel = torch.rand((B, ns, 2), generator=gen, device=dev)
            want = torch.where(active_tick < src["active_ticks"], n_raw, 0)
            n = torch.clamp(torch.minimum(want, budget), max=ns)
            for b in torch.nonzero(n).squeeze(1).tolist():
                slots = free[b][int(used[b]):int(used[b] + n[b])]
                k = slots.numel()
                pos[b, slots] = f(src["position"]) + (f(u_pos[b, :k]) - 0.5) * src["radius"]
                vel[b, slots] = f(src["velocity"]) + (f(u_vel[b, :k]) - 0.5) * src["noise"]
                alive[b, slots] = True
            budget = budget - n
            used = used + n

    # -- cull outside [-r, 1 + r]^2 --
    lo_, hi_ = -r[:, None, None], 1.0 + r[:, None, None]
    inside = ((pos >= lo_) & (pos <= hi_)).all(-1)
    edge = (torch.minimum((pos - lo_).abs(), (pos - hi_).abs()) < BAND).any(-1)
    flags |= alive & edge
    alive &= inside

    # -- rigid bodies: motors at the new time; segments carried by their body --
    t_new = f(inp["time"]) + dt
    lin, ang = f(inp["body_lin_vel"]).clone(), f(inp["body_ang_vel"]).clone()
    mlin, mang, center = f(world.motor_lin), f(world.motor_ang), f(world.body_center)
    for b_i, kind in enumerate(world.body_kind):
        if kind == MOTORED:
            lin[:, b_i] = _motor(mlin[b_i], t_new[:, None])
            ang[:, b_i] = _motor(mang[b_i], t_new)
    sb = torch.as_tensor(world.seg_body, device=dev)
    segs = f(inp["segments"])[:, : world.num_segments]
    moving = torch.tensor([world.body_kind[b] != FIXED for b in world.seg_body], device=dev)
    ends_vel = lin[:, sb][:, :, None] + ang[:, sb][:, :, None, None] * _rot90_cw(
        segs - center[sb][None, :, None])
    segs = torch.where(moving[None, :, None, None], segs + ends_vel * dt[:, None, None, None], segs)
    free_b = torch.tensor([k == FREE for k in world.body_kind], device=dev)
    lin_out = torch.where(free_b[None, :, None], lin + dt[:, None, None] * g[:, None], lin)

    # -- virtual colliders: a mirror ghost for each segment within 1.2 r;
    # the hard wall pushes the particle out to r from each --
    a = segs[:, :, 0]  # (B, S, 2)
    ab = segs[:, :, 1] - a
    ap = pos[:, None] - a[:, :, None]  # (B, S, P, 2)
    tt = torch.clamp((ap * ab[:, :, None]).sum(-1) / torch.clamp((ab * ab).sum(-1), min=EPS)[..., None],
                     0.0, 1.0)
    near = a[:, :, None] + ab[:, :, None] * tt[..., None]  # (B, S, P, 2)
    dist = torch.sqrt(((near - pos[:, None]) ** 2).sum(-1))
    reach = 1.2 * r[:, None, None]
    gm = (dist <= reach) & alive[:, None]
    flags |= (alive[:, None] & ((dist - reach).abs() < BAND)).any(1)
    gv = 2.0 * (pos[:, None] - near)
    gn = torch.sqrt((gv * gv).sum(-1))
    vrd = torch.clamp(r[:, None, None] / torch.clamp(gn, min=EPS), min=0.5) - 0.5
    gmf = gm.to(dtype)[..., None]
    pos = torch.where(alive[..., None], pos + (gmf * gv * vrd[..., None]).sum(1), pos)
    g_cnt = gm.to(dtype).sum(1)
    gsum = (gmf * gv).sum(1)
    b_lin, b_ang, b_c = lin[:, sb][:, :, None], ang[:, sb][:, :, None], center[sb][None, :, None]
    gvel = torch.stack([b_lin[..., 0] + b_ang * (near[..., 1] - b_c[..., 1]),
                        b_lin[..., 1] - b_ang * (near[..., 0] - b_c[..., 0])], -1)
    gvel_sum = (gmf * gvel).sum(1)

    # -- pairs within a diameter (exact positions); jittered directions --
    amp = diam * c["collider_noise_level"]
    if jitter.kind == "slot_hash":
        slot = jitter.out_slot.to(dev).long()
        tick = inp["tick"].to(dev).long()[:, None]
        s2 = 0.7071067811865476
        nz = torch.stack([slot_hash_u01(2 * slot, tick), slot_hash_u01(2 * slot + 1, tick)], -1)
        noise_self = f(nz - 0.5) * (amp * s2)[:, None, None]
        noise_nb = noise_self
    else:
        u = torch.rand((B, P, 2), generator=gen, device=dev)
        noise_self = torch.zeros_like(pos)
        noise_nb = (f(u) - 0.5) * amp[:, None, None]
    flat = torch.nonzero(alive.reshape(-1)).squeeze(1)
    grp = flat // P
    pa_ = pos.reshape(-1, 2)[flat]
    # candidates a little past the cut-off, to flag those decided within rounding
    i, j = pair_list(pa_, grp, diam + BAND, float(diam.double().max()) + BAND)
    gi = grp[i]
    d_exact = torch.sqrt(((pa_[i] - pa_[j]) ** 2).sum(-1))
    rr = (pa_[i] + noise_self.reshape(-1, 2)[flat][i]) - (pa_[j] + noise_nb.reshape(-1, 2)[flat][j])
    d = torch.clamp(torch.sqrt((rr * rr).sum(-1)), min=EPS)
    w = 1.0 - torch.clamp(d / diam[gi], max=1.0)
    amb = (d_exact - diam[gi]).abs() < BAND
    amb_pairs = (i[amb], j[amb], w[amb] > 0)
    within = d_exact <= diam[gi]
    i, j, gi, rr, d, w = i[within], j[within], gi[within], rr[within], d[within], w[within]
    nh = rr / d[:, None]
    n_al = flat.numel()
    z1 = lambda: torch.zeros(n_al, dtype=dtype, device=dev)  # noqa: E731
    z2 = lambda: torch.zeros((n_al, 2), dtype=dtype, device=dev)  # noqa: E731
    cnt = z1().index_add_(0, i, torch.ones_like(w))
    w_sum = z1().index_add_(0, i, w)
    s = z2().index_add_(0, i, ((1.0 - w) * w)[:, None] * nh)
    vf = vel.reshape(-1, 2)[flat]
    vsum = z2().index_add_(0, i, vf[j])
    p_i = torch.where(cnt > 0, torch.clamp(w_sum - c["ignored_pressure"][grp], min=0.0), 0.0)
    align = ((s[i] - s[j]) * nh).sum(-1) * c["surface_smoothing"][gi]
    tc = align + (p_i[j] + p_i[i] - 2.0 * c["target_pressure"][gi])
    tension = z2().index_add_(0, i, tc[:, None] * nh)
    press = z2().index_add_(0, i, (p_i[i] + p_i[j])[:, None] * nh)
    # the gross size of each particle's pair kicks: its pair terms'
    # magnitudes summed, before they cancel (the comparison's scale)
    gross = z1().index_add_(0, i, tc.abs() + c["pressure_amplifier"][gi] * (p_i[i] + p_i[j]).abs()
                            + c["viscosity"][gi] * (vf[j] - vf[i]).norm(dim=-1))

    # particles with a pair decided within rounding: such a pair moves its
    # own two particles' sums by a whole term, and where its jittered
    # weight w is not 0, the p and s that their neighbours read as well
    hop = torch.zeros(n_al, dtype=torch.bool, device=dev)
    seed = torch.zeros(n_al, dtype=torch.bool, device=dev)
    ia, ja, wa = amb_pairs
    hop[ia] = True
    hop[ja] = True
    seed[ia[wa]] = True
    seed[ja[wa]] = True
    hop[i[seed[j]]] = True
    near = d / diam[gi] < NEAR
    hop[i[near]] = True
    hop[j[near]] = True
    fl = flags.reshape(-1)
    fl[flat] |= hop
    flags = fl.reshape(B, P)

    def grid(x):
        out = torch.zeros((B * P,) + x.shape[1:], dtype=dtype, device=dev)
        out[flat] = x
        return out.reshape((B, P) + x.shape[1:])

    p_i, cnt, tension, press, vsum = grid(p_i), grid(cnt), grid(tension), grid(press), grid(vsum)
    gross = grid(gross) * dt[:, None]

    # -- the kicks, in order, on alive particles --
    al = alive[..., None]
    dt3 = dt[:, None, None]
    v = vel
    v = torch.where(al, v + dt3 * tension, v)
    v = torch.where(al, v + dt3 * g[:, None], v)
    v = torch.where(al, v + dt3 * c["pressure_amplifier"][:, None, None] * (press + p_i[..., None] * gsum), v)
    v = torch.where(al, v + dt3 * c["viscosity"][:, None, None] * (vsum - cnt[..., None] * v), v)
    # wall bounce against the contact velocity of the virtual colliders
    den = torch.clamp(g_cnt, min=1.0)[..., None]
    nrm = gsum / den
    nu = nrm / torch.clamp(torch.sqrt((nrm * nrm).sum(-1, keepdim=True)), min=EPS)
    approach = ((v - gvel_sum / den) * nu).sum(-1)
    hit = alive & (g_cnt > 0) & (approach < 0)
    decay = c["wall_collision_decay"][:, None, None]
    v = torch.where(hit[..., None], v - approach[..., None] * nu * (1.0 + decay), v)

    # -- continuous collision: a move that crosses a wall padded by r, from
    # the side it faces, is cut where it crosses --
    wa, wb = segs[:, :, 0], segs[:, :, 1]
    nrm_w = _rot90_cw(wb - wa)
    off = nrm_w * (r[:, None, None] / torch.clamp(torch.sqrt((nrm_w * nrm_w).sum(-1, keepdim=True)),
                                                  min=EPS))
    walls = torch.cat([torch.stack([wa + off, wb + off], 2), torch.stack([wb - off, wa - off], 2)], 1)
    cw, dw = walls[:, :, 0][:, :, None], walls[:, :, 1][:, :, None]  # (B, W, 1, 2)
    mv = v * dt3
    pa, pb = pos[:, None], (pos + mv)[:, None]
    wdir = dw - cw
    cross = lambda u_, w_: u_[..., 0] * w_[..., 1] - u_[..., 1] * w_[..., 0]  # noqa: E731
    approaching = (_rot90_cw(wdir) * mv[:, None]).sum(-1) < 0
    o1, o2 = cross(pb - pa, cw - pb), cross(pb - pa, dw - pb)
    o3, o4 = cross(dw - cw, pa - dw), cross(dw - cw, pb - dw)
    crossing = approaching & (torch.sign(o1) != torch.sign(o2)) & (torch.sign(o3) != torch.sign(o4))
    den_w = cross(wdir, mv[:, None])
    safe = torch.where(den_w.abs() > EPS, den_w, torch.where(den_w >= 0, EPS, -EPS))
    t_hit = cross(pa - cw, wdir) / safe
    crossing &= alive[:, None]
    factor = torch.where(crossing, t_hit, torch.inf).amin(1)
    v = v * torch.clamp(factor, max=1.0)[..., None]
    # a crossing decided within rounding: an end of either segment near the
    # other's line, or a move near parallel to the wall, where the other
    # tests do not already rule the crossing out
    lw = torch.clamp(torch.sqrt((wdir * wdir).sum(-1)), min=EPS)
    lm = torch.clamp(torch.sqrt((mv * mv).sum(-1)), min=EPS)[:, None]
    tol = BAND + MOVE_BAND * lm
    amb1 = (o1.abs() / lm < tol) | (o2.abs() / lm < tol)
    amb2 = (o3.abs() / lw < BAND) | (o4.abs() / lw < tol)
    amb_a = (_rot90_cw(wdir) * mv[:, None]).sum(-1).abs() / lw < tol
    s1 = (torch.sign(o1) != torch.sign(o2)) | amb1
    s2 = (torch.sign(o3) != torch.sign(o4)) | amb2
    graze = s1 & s2 & (approaching | amb_a) & (amb1 | amb2 | amb_a)
    flags |= alive & graze.any(1)

    new_pos = torch.where(al, pos + dt3 * v, pos)
    return dict(pos=new_pos, vel=v, alive=alive, pressure=torch.where(alive, p_i, 0.0),
                segments=segs, body_lin_vel=lin_out, body_ang_vel=ang, flags=flags,
                gross_dv=gross)
