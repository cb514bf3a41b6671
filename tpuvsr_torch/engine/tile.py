"""The BFS's tile pipeline on the device: kernels K7 (work-queue
compaction), K8 (the fused tile commit and the level step), K15 (the
per-action commit) and K17 (the ample-set step of the partial-order
reduction), and the carry they share.

The counterpart of the device code of ``tpuvsr/engine/device_bfs.py``
that ``run_fused`` runs: the per-action ``jnp.nonzero(size=E_a)``
compaction of ``_fused_body_factory`` (:838), its committed-action
prefix and headroom gate (:806-931), the rank scatter, commit flag and
reason priority (:942-985), and the tail of ``_make_multilevel``'s
``obody`` (:1231-1300) that appends a finished level's trace pointers,
records its size and makes the next buffer the frontier; and the commit
of the per-action body ``make_body`` (:458-673), one insert an action,
whose chain from one action to the next (the commit flag, the flags of
the tile's verdict, the first violating item) lives in a per-tile state
vector on the device (``PA_FIELDS``, ``enum PaTile``), so a per-action
tile needs no host read between its actions.

**The carry** is one int64 vector on the device that holds the whole
loop state of the fused pass (``C_*`` below, then ``need`` and ``act``,
one entry per action).  The kernels read it and update it in place, so
a tile needs no host read: the host reads the carry once per quantum
of tiles.  ``halt`` is set when a tile stops with a reason or a level
step meets a stop condition (``stop``); from then on K6 and K7 do
nothing, ``commit_prefix`` masks every item out, ``commit_finish``
scatters nothing (it counts the replay in ``idle``) and ``level_step``
does nothing, so a tile replayed after the stop commits nothing.  The
layout is ``enum Carry`` of ``csrc/tile_commit.cu``.  Under the ample-set
reduction ``gen`` and ``act`` count the kept expansions, ``gfull`` the
unreduced ones and ``amp`` the rows that took the ample shortcut with
work elided (the JAX body's ``gfull``/``amp``, :989-1013).

**K17** (``csrc/por_ample.cu``) is the POR block of the fused body
(``tpuvsr/engine/device_bfs.py:783-799``, ``:909-931``, ``:989-1019``):
``por_cand`` finds each tile row's ample candidate from the guard
matrix, ``por_probe`` probes the candidate's successors' level markers
in the pre-insert FPSet (it must run before K1's insert), and
``por_keep`` writes the keep mask ``commit_prefix`` ANDs into the commit
mask, the kept and amp counts ``commit_finish`` folds into the carry,
and the marker values (depth + 1) K11 stores on the fresh lanes.

Each wrapper sends CPU tensors to its plain PyTorch version (in this
module) and CUDA tensors to its kernel (``csrc/compact.cu``,
``csrc/tile_commit.cu``: K8 and K15).  Both write their outputs into the
buffers they are given, so a CUDA graph can hold them; the plain
versions read values to the host where that is simpler and never run
inside a graph.
"""

from __future__ import annotations

import torch

from .. import kernels
from .fpset import lookup_gids_plain

I64 = torch.int64
I32 = torch.int32

# the bag-overflow bit of a successor's err word, the engine's contract
# with every model (models/vsr.py and models/st03.py use this bit, and
# DeviceBFS refuses a kernel whose ERR_BAG_OVERFLOW differs); K8 holds
# the same constant (csrc/tile_commit.cu); any other bit is a slot error
ERR_BAG_OVERFLOW = 1

# level-pass stop reasons (the JAX engine's codes)
RUNNING = 0
R_VIOLATION = 2      # an invariant failed on a generated state
R_BAG_GROW = 3       # a successor needs more message-table slots
R_FPSET_GROW = 4     # fingerprint probing exhausted (table too full)
R_NEXT_GROW = 5      # next-frontier buffer out of capacity
R_SLOT_ERR = 6       # dense-layout slot collision (config limitation)
R_DEADLOCK = 7       # a frontier state has no enabled successor
R_EXPAND_GROW = 8    # per-action compaction buffer too small
R_EDGE_FLUSH = 10    # edge buffers out of headroom: the host drains them

# carry layout (csrc/tile_commit.cu enum Carry)
CARRY_FIELDS = (
    "t", "reason", "halt", "stop", "nn", "n_front", "depth", "level_base",
    "fp_count", "gen", "tiles", "lvl_cur", "viol_row", "viol_aid",
    "viol_lane", "dead", "grow_aid", "idle", "want_deadlock", "max_depth",
    "max_states", "max_lvls", "next_cap", "tp_cap", "gfull", "amp")
(C_T, C_REASON, C_HALT, C_STOP, C_NN, C_N_FRONT, C_DEPTH, C_LEVEL_BASE,
 C_FP_COUNT, C_GEN, C_TILES, C_LVL_CUR, C_VIOL_ROW, C_VIOL_AID, C_VIOL_LANE,
 C_DEAD, C_GROW_AID, C_IDLE, C_WANT_DEADLOCK, C_MAX_DEPTH, C_MAX_STATES,
 C_MAX_LVLS, C_NEXT_CAP, C_TP_CAP, C_GFULL, C_AMP) = range(len(CARRY_FIELDS))
C_NEED = len(CARRY_FIELDS)          # need[n_act], then act[n_act]

# the tile's verdict, written by commit_prefix and read by commit_finish
# (csrc/tile_commit.cu enum Tile), then one flag word per action
# (1 violation, 2 bag overflow, 4 slot error)
TILE_FIELDS = ("first_bad", "room", "viol", "slot", "bag", "ovf",
               "grow_aid", "vrow", "vaid", "vlane")
(F_FIRST_BAD, F_ROOM, F_VIOL, F_SLOT, F_BAG, F_OVF, F_GROW_AID, F_VROW,
 F_VAID, F_VLANE) = range(len(TILE_FIELDS))
F_AFLAGS = len(TILE_FIELDS)

MAX_ACTIONS = 64     # the kernels' per-action shared arrays

# K15's per-tile chain (csrc/tile_commit.cu enum PaTile): the commit
# flag carried from one action to the next, the last action's commit_a,
# the headroom gate, the verdict's flags, the first overflowing action
# and the first violating item (tile row, action, lane)
PA_FIELDS = ("commit", "commit_a", "room", "viol", "slot", "bag", "ovf_e",
             "ovf_i", "grow_aid", "vrow", "vaid", "vlane")
(P_COMMIT, P_COMMIT_A, P_ROOM, P_VIOL, P_SLOT, P_BAG, P_OVF_E, P_OVF_I,
 P_GROW_AID, P_VROW, P_VAID, P_VLANE) = range(len(PA_FIELDS))


def new_carry(n_act, device, **vals):
    """A carry vector with every field 0 except ``vals`` (by name) and
    the "none yet" markers (-1) of viol, dead and grow_aid."""
    c = [0] * (C_NEED + 2 * n_act)
    for k in ("viol_row", "viol_aid", "viol_lane", "dead", "grow_aid"):
        c[CARRY_FIELDS.index(k)] = -1
    for k, v in vals.items():
        c[CARRY_FIELDS.index(k)] = int(v)
    return torch.tensor(c, dtype=I64, device=device)


class Segments:
    """The work queue's segment table: for each action its first lane
    in the guard matrix, its lane count L_a, its cap E_a and its offset
    in the queue (``host`` as Python ints, ``dev`` as an int32 tensor
    ``[n_act, 4]``)."""

    def __init__(self, lane_off, lanes, caps, device):
        qoff, self.host = 0, []
        for lo, L, E in zip(lane_off, lanes, caps):
            self.host.append((int(lo), int(L), int(E), qoff))
            qoff += int(E)
        self.total = qoff
        self.dev = torch.tensor(self.host, dtype=I32,
                                device=device).reshape(-1, 4)


def queue_buffers(total, n_act, device):
    """The work queue's output buffers (zero: every index in range)."""
    z = lambda n, dt: torch.zeros((n,), dtype=dt, device=device)
    return {"pidx": z(total, I32), "lane": z(total, I32),
            "aid": z(total, I32), "ok": z(total, torch.bool),
            "cnts": z(n_act, I64), "ovf": z(n_act, torch.bool)}


# ----------------------------------------------------------------------
# K7: work-queue compaction
# ----------------------------------------------------------------------
def compact(en, valid, segs, q, carry=None, action=None):
    """K7 wrapper.  ``en`` [T, n_lanes] bool guard matrix of a tile,
    ``valid`` [T] bool rows in the frontier, ``segs`` a ``Segments``.
    Writes into the queue buffers ``q`` (``queue_buffers``): for action
    a, entries ``qoff .. qoff + E_a`` hold the first E_a enabled (row,
    lane) items of valid rows in (row, lane) order, then fill entries
    (row T-1, lane 0, ok False) — ``jnp.nonzero(en_f, size=E_a,
    fill_value=T*L_a)`` split into row and lane; ``aid`` the action;
    ``cnts`` the exact enabled count, ``ovf`` count > E_a.  With a
    ``carry`` it does nothing once the carry is halted and otherwise
    raises ``need`` to the counts.  With ``action`` = a it compacts
    that action's segment alone (the per-action commit)."""
    if en.device.type == "cpu":
        return compact_plain(en, valid, segs, q, carry, action)
    return _compact_kernel(en, valid, segs, q, carry, action)


def _select(m, cap, fill):
    pos = torch.cumsum(m, 0) - 1
    dest = torch.where(m & (pos < cap), pos, cap)
    out = torch.full((cap + 1,), fill, dtype=I64, device=m.device)
    out.scatter_(0, dest, torch.arange(m.shape[0], device=m.device))
    return out[:cap]


def compact_plain(en, valid, segs, q, carry=None, action=None):
    if carry is not None and bool(carry[C_HALT] != 0):
        return q
    T = en.shape[0]
    n_act = len(segs.host)
    for a, (lo, L, E, qo) in enumerate(segs.host):
        if action is not None and a != action:
            continue
        TL = T * L
        en_f = (en[:, lo:lo + L] & valid[:, None]).reshape(TL)
        sel = _select(en_f, E, TL)
        q["pidx"][qo:qo + E] = torch.clamp(sel // L, 0, T - 1)
        q["lane"][qo:qo + E] = sel % L
        q["aid"][qo:qo + E] = a
        q["ok"][qo:qo + E] = sel < TL
        q["cnts"][a] = en_f.sum()
        q["ovf"][a] = q["cnts"][a] > E
        if carry is not None:
            carry[C_NEED + a] = torch.maximum(carry[C_NEED + a],
                                              q["cnts"][a])
    return q


def _compact_kernel(en, valid, segs, q, carry, action=None):
    T, n_lanes = en.shape
    n_act = len(segs.host)
    ck = kernels.check
    total = segs.total
    a0, rows = (0, n_act) if action is None else (int(action), 1)
    ck(segs.dev, "segs", I32, (n_act, 4))
    ck(q["cnts"], "cnts", I64, (n_act,))
    ck(q["ovf"], "ovf", torch.bool, (n_act,))
    kernels.launch(
        "compact", "tpuvsr_compact",
        ck(en, "en", torch.bool, (T, n_lanes)), ck(valid, "valid",
                                                   torch.bool, (T,)),
        T, n_lanes, segs.dev[a0].data_ptr(), rows, a0,
        ck(q["pidx"], "pidx", I32, (total,)),
        ck(q["lane"], "lane", I32, (total,)),
        ck(q["aid"], "aid", I32, (total,)),
        ck(q["ok"], "ok", torch.bool, (total,)),
        q["cnts"][a0].data_ptr(), q["ovf"][a0].data_ptr(),
        None if carry is None else ck(carry, "carry", I64),
        C_HALT, C_NEED + a0, kernels.stream_of(en))
    return q


# ----------------------------------------------------------------------
# K8: commit_prefix
# ----------------------------------------------------------------------
def commit_prefix(carry, q, en2, iok, err, tile, mcommit, keep=None):
    """K8 wrapper, first entry: the tile's verdict before the insert.
    ``en2`` [total] bool successors enabled, ``iok`` [total] bool
    invariants hold, ``err`` [total] int32 error flags of the queue
    ``q``.  Writes ``tile`` (int64 ``[F_AFLAGS + n_act]``: the first
    failing action, the headroom gate ``nn + total <= next_cap``, the
    violation/slot/bag/overflow flags, the overflowing action, the first
    violating item's (row, action, lane), per-action flags) and
    ``mcommit`` [total] bool: the enabled items of actions before the
    first failing one, none when the gate fails or the carry is
    halted.  Under POR ``keep`` ([total] bool, K17's keep mask) is
    ANDed into ``mcommit``; the flags still see every item."""
    if en2.device.type == "cpu":
        return commit_prefix_plain(carry, q, en2, iok, err, tile, mcommit,
                                   keep)
    return _prefix_kernel(carry, q, en2, iok, err, tile, mcommit, keep)


def commit_prefix_plain(carry, q, en2, iok, err, tile, mcommit, keep=None):
    n_act = q["cnts"].shape[0]
    total = en2.shape[0]
    ok = en2 & q["ok"]
    errv = torch.where(ok, err, 0)
    viol = ok & ~iok & (errv == 0)
    aid = q["aid"].long()
    per = lambda m: torch.zeros((n_act,), dtype=I64, device=en2.device
                                ).index_add_(0, aid, m.long()) > 0
    v_a = per(viol)
    b_a = per((errv & ERR_BAG_OVERFLOW) != 0)
    s_a = per((errv & ~ERR_BAG_OVERFLOW) != 0)
    ovf = q["ovf"]
    bad = (v_a | b_a | s_a | ovf).tolist()
    first_bad = bad.index(True) if True in bad else n_act
    c = carry.tolist()
    room = c[C_NEXT_CAP] - c[C_NN] >= total
    vrow = vaid = vlane = -1
    if bool(v_a.any()):
        vaid = v_a.tolist().index(True)
        items = torch.nonzero(viol & (aid == vaid))[:, 0]
        i = int(items.min())
        vrow, vlane = int(q["pidx"][i]), int(q["lane"][i])
    ovl = ovf.tolist()
    flags = [first_bad, int(room), int(v_a.any()), int(s_a.any()),
             int(b_a.any()), int(ovf.any()),
             ovl.index(True) if True in ovl else -1, vrow, vaid, vlane]
    aflags = v_a.long() | (b_a.long() << 1) | (s_a.long() << 2)
    tile.copy_(torch.cat([torch.tensor(flags, dtype=I64,
                                       device=tile.device), aflags]))
    m = ok & (aid < first_bad) & room & (c[C_HALT] == 0)
    mcommit.copy_(m if keep is None else m & keep)
    return tile, mcommit


def _prefix_kernel(carry, q, en2, iok, err, tile, mcommit, keep=None):
    total = en2.shape[0]
    n_act = q["cnts"].shape[0]
    if n_act > MAX_ACTIONS:
        raise ValueError(f"commit_prefix: {n_act} actions, the kernel "
                         f"takes at most {MAX_ACTIONS}")
    ck = kernels.check
    kernels.launch(
        "commit_prefix", "tpuvsr_commit_prefix",
        ck(carry, "carry", I64), ck(en2, "en2", torch.bool, (total,)),
        ck(iok, "iok", torch.bool, (total,)),
        ck(err, "err", I32, (total,)),
        ck(q["pidx"], "pidx", I32, (total,)),
        ck(q["lane"], "lane", I32, (total,)),
        ck(q["aid"], "aid", I32, (total,)),
        ck(q["ok"], "ok", torch.bool, (total,)),
        ck(q["ovf"], "ovf", torch.bool, (n_act,)),
        None if keep is None else ck(keep, "keep", torch.bool, (total,)),
        total, n_act, ck(mcommit, "mcommit", torch.bool, (total,)),
        ck(tile, "tile", I64, (F_AFLAGS + n_act,)),
        kernels.stream_of(en2))
    return tile, mcommit


# ----------------------------------------------------------------------
# K8: commit_finish
# ----------------------------------------------------------------------
def commit_finish(carry, q, tile, fresh, ovf_i, en_any, valid, bufs,
                  dest, kept=None, amp=None):
    """K8 wrapper, second entry: after the insert (K1's ``fresh`` [total]
    bool and its overflow flag ``ovf_i``, a 0-dim int32 tensor).  Writes
    ``dest`` [total] int32 = ``nn + cumsum(fresh) - 1`` for fresh items
    and -1 for the rest (K4's pack-scatter rows), scatters each fresh
    item's (tile base + row, action, lane) into ``bufs`` (``par``,
    ``act``, ``prm``) at ``dest``, and steps the carry as the JAX body
    does: ``nn``, ``fp_count`` by the fresh count; the reason by the
    priority next-buffer gate > violation > slot > bag > expand >
    fpset, then deadlock (a valid row of ``en_any`` [T] with nothing
    enabled, when the carry asks for it); on a commit ``gen`` and
    ``act`` by the tile's counts; ``t`` and ``tiles`` by one when the
    tile commits and the reason stays RUNNING; ``halt`` on any reason.
    A halted carry gets ``dest`` all -1 and one more ``idle`` replay.
    Under POR (``kept`` [n_act] int64 and ``amp`` [1] int64, K17's) a
    commit adds the kept counts to ``gen`` and ``act``, the unreduced
    counts to ``gfull`` and ``amp`` to ``amp``."""
    if fresh.device.type == "cpu":
        return commit_finish_plain(carry, q, tile, fresh, ovf_i, en_any,
                                   valid, bufs, dest, kept, amp)
    return _finish_kernel(carry, q, tile, fresh, ovf_i, en_any, valid,
                          bufs, dest, kept, amp)


def commit_finish_plain(carry, q, tile, fresh, ovf_i, en_any, valid, bufs,
                        dest, kept=None, amp=None):
    c = carry.tolist()
    if c[C_HALT]:
        return _halted_plain(carry, dest, True)
    n_act = q["cnts"].shape[0]
    nn = c[C_NN]
    nfi = _rank_scatter_plain(fresh, nn, c[C_T] * valid.shape[0], q, bufs,
                              dest)
    f = tile.tolist()
    oi = bool(ovf_i)
    c[C_NN] = nn + nfi
    c[C_FP_COUNT] += nfi
    _fold_verdict_plain(
        c, f[F_ROOM], f[F_VIOL], f[F_SLOT], f[F_BAG], f[F_OVF], oi,
        f[F_ROOM] and f[F_FIRST_BAD] >= n_act and not oi, f[F_GROW_AID],
        f[F_VROW], f[F_VAID], f[F_VLANE], en_any, valid, q["cnts"],
        kept, amp)
    carry.copy_(torch.tensor(c, dtype=I64, device=carry.device))
    return dest


def _halted_plain(carry, dest, idle):
    """The two finishes on a halted carry: ``dest`` all -1, and one more
    idle replay where ``idle`` (the tile's last call)."""
    dest.fill_(-1)
    if idle:
        carry[C_IDLE] += 1
    return dest


def _rank_scatter_plain(fresh, nn, row0, q, bufs, dest):
    """The two finishes' scatter: ``dest`` = ``nn`` + the rank of each
    fresh item (-1 for the rest), and each fresh item's (``row0`` + row,
    action, lane) in ``bufs`` at ``dest``; returns the fresh count."""
    rank = torch.cumsum(fresh.long(), 0) - 1 + nn
    dest.copy_(torch.where(fresh, rank, -1))
    idx = torch.nonzero(fresh)[:, 0]
    rows = rank[idx]
    bufs.par[rows] = (row0 + q["pidx"][idx]).to(I32)
    bufs.act[rows] = q["aid"][idx]
    bufs.prm[rows] = q["lane"][idx]
    return int(fresh.sum())


def _fold_verdict_plain(c, room, viol, slot, bag, ovf_e, ovf_i, commit,
                        grow_aid, vrow, vaid, vlane, en_any, valid, cnts,
                        kept=None, amp=None):
    """The two finishes' verdict at the tile's end, on the carry list
    ``c``: the reason by its priority, then deadlock; the violation's and
    the first overflow's ids; on a commit ``gen`` and ``act`` by
    ``cnts`` (by ``kept`` under POR, with ``gfull`` by ``cnts`` and
    ``amp`` by ``amp``), and ``t`` and ``tiles`` by one while the reason
    stays RUNNING; ``halt`` on any reason."""
    T, t = valid.shape[0], c[C_T]
    if not room:
        reason = R_NEXT_GROW
    elif viol:
        reason = R_VIOLATION
    elif slot:
        reason = R_SLOT_ERR
    elif bag:
        reason = R_BAG_GROW
    elif ovf_e:
        reason = R_EXPAND_GROW
    elif ovf_i:
        reason = R_FPSET_GROW
    else:
        reason = RUNNING
    dead = (valid & ~en_any).tolist()
    if reason == RUNNING and c[C_WANT_DEADLOCK] and commit and any(dead):
        reason = R_DEADLOCK
        c[C_DEAD] = t * T + dead.index(True)
    if reason == R_VIOLATION:
        c[C_VIOL_ROW] = t * T + vrow
        c[C_VIOL_AID], c[C_VIOL_LANE] = vaid, vlane
    if ovf_e:
        c[C_GROW_AID] = grow_aid
    if commit:
        counts = (cnts if kept is None else kept).tolist()
        n_act = len(counts)
        c[C_GEN] += sum(counts)
        for a in range(n_act):
            c[C_NEED + n_act + a] += counts[a]
        if kept is not None:
            c[C_GFULL] += int(cnts.sum())
            c[C_AMP] += int(amp.sum())
        if reason == RUNNING:
            c[C_T] = t + 1
            c[C_TILES] += 1
    c[C_REASON] = reason
    if reason != RUNNING:
        c[C_HALT] = 1


def _finish_kernel(carry, q, tile, fresh, ovf_i, en_any, valid, bufs,
                   dest, kept=None, amp=None):
    total = fresh.shape[0]
    n_act = q["cnts"].shape[0]
    T = valid.shape[0]
    ck = kernels.check
    kernels.launch(
        "commit_finish", "tpuvsr_commit_finish",
        ck(carry, "carry", I64), ck(tile, "tile", I64,
                                    (F_AFLAGS + n_act,)),
        ck(fresh, "fresh", torch.bool, (total,)),
        ck(ovf_i, "ovf_i", I32, ()),
        ck(q["pidx"], "pidx", I32, (total,)),
        ck(q["lane"], "lane", I32, (total,)),
        ck(q["aid"], "aid", I32, (total,)), total,
        ck(q["cnts"], "cnts", I64, (n_act,)), n_act,
        ck(en_any, "en_any", torch.bool, (T,)),
        ck(valid, "valid", torch.bool, (T,)), T,
        ck(bufs.par, "par", I32), ck(bufs.act, "act", I32),
        ck(bufs.prm, "prm", I32), ck(dest, "dest", I32, (total,)),
        None if kept is None else ck(kept, "kept", I64, (n_act,)),
        None if amp is None else ck(amp, "amp", I64, (1,)),
        kernels.stream_of(fresh))
    return dest


# ----------------------------------------------------------------------
# K8: level_step
# ----------------------------------------------------------------------
def level_step(carry, bufs, front, tp, lvl_buf, tile_size):
    """K8 wrapper, third entry: when the tile loop of a level is done
    (halt clear and ``t`` past the level's last tile), append the
    level's trace pointers (``bufs.par + level_base``, ``bufs.act``,
    ``bufs.prm`` of its ``nn`` rows) at ``level_base + n_front`` of
    ``tp`` = (tpp, tpa, tpm), record a non-empty level's size in
    ``lvl_buf[lvl_cur]``, copy the ``nn`` packed rows of ``bufs.nb`` to
    ``front`` (the next level's frontier), advance ``depth``,
    ``level_base`` and ``n_front``, reset ``t`` and ``nn``, and set
    ``stop`` and ``halt`` on the JAX ``ocond`` terms: an empty
    frontier, ``max_depth``, ``max_states``, ``max_lvls`` levels
    recorded, or trace-pointer headroom for one more level."""
    if carry.device.type == "cpu":
        return level_step_plain(carry, bufs, front, tp, lvl_buf, tile_size)
    return _level_kernel(carry, bufs, front, tp, lvl_buf, tile_size)


def level_step_plain(carry, bufs, front, tp, lvl_buf, tile_size):
    c = carry.tolist()
    T = tile_size
    nf = c[C_N_FRONT]
    if c[C_HALT] or c[C_T] < (nf + T - 1) // T:
        return carry
    n, lb = c[C_NN], c[C_LEVEL_BASE]
    tpp, tpa, tpm = tp
    lo = lb + nf
    tpp[lo:lo + n] = bufs.par[:n] + lb
    tpa[lo:lo + n] = bufs.act[:n]
    tpm[lo:lo + n] = bufs.prm[:n]
    front[:n] = bufs.nb[:n]
    if n > 0:
        if c[C_LVL_CUR] < lvl_buf.shape[0]:
            lvl_buf[c[C_LVL_CUR]] = n
        c[C_LVL_CUR] += 1
    c[C_LEVEL_BASE] = lb + nf
    c[C_N_FRONT] = n
    c[C_T] = c[C_NN] = 0
    c[C_DEPTH] += 1
    if (n == 0 or c[C_DEPTH] >= c[C_MAX_DEPTH]
            or c[C_FP_COUNT] >= c[C_MAX_STATES]
            or c[C_LVL_CUR] >= c[C_MAX_LVLS]
            or c[C_LEVEL_BASE] + n + c[C_NEXT_CAP] > c[C_TP_CAP]):
        c[C_STOP] = c[C_HALT] = 1
    carry.copy_(torch.tensor(c, dtype=I64, device=carry.device))
    return carry


def _level_kernel(carry, bufs, front, tp, lvl_buf, tile_size):
    words = bufs.nb.shape[1]
    tpp, tpa, tpm = tp
    ck = kernels.check
    kernels.launch(
        "level_step", "tpuvsr_level_step",
        ck(carry, "carry", I64), ck(bufs.nb, "nb", I32),
        ck(bufs.par, "par", I32), ck(bufs.act, "act", I32),
        ck(bufs.prm, "prm", I32), ck(front, "front", I32), words,
        ck(tpp, "tpp", I32), ck(tpa, "tpa", I32), ck(tpm, "tpm", I32),
        ck(lvl_buf, "lvl_buf", I64), lvl_buf.shape[0], tile_size,
        kernels.stream_of(carry))
    return carry


# ----------------------------------------------------------------------
# K15: the per-action commit, action_gate and action_finish
# ----------------------------------------------------------------------
def action_gate(carry, pa, q, o, a, total_e, mcommit):
    """K15 wrapper, first entry, before action ``a``'s insert.  ``q``
    holds a's queue segment (``pidx``, ``lane``, ``ok``: [E] views) and
    its overflow flag ``ovf`` (a one-element view of K7's), ``o`` a's
    successors (``en2``, ``iok``, ``err``: [E]).  At ``a`` = 0 it opens
    the tile's chain in ``pa`` (int64 ``[len(PA_FIELDS)]``): the
    headroom gate ``next_cap - nn >= total_e`` is the first commit flag.
    Then it raises the tile's violation/slot/bag/overflow flags by a's
    items, records the first violating item (row, a, lane) and the
    first overflowing action, and writes ``commit_a`` = commit and no
    violation, slot error, full bag or overflow in a, nothing once the
    carry is halted, and ``mcommit`` [E] = a's enabled items when
    commit_a holds."""
    if mcommit.device.type == "cpu":
        return action_gate_plain(carry, pa, q, o, a, total_e, mcommit)
    return _gate_kernel(carry, pa, q, o, a, total_e, mcommit)


def action_gate_plain(carry, pa, q, o, a, total_e, mcommit):
    c = carry.tolist()
    p = pa.tolist()
    if a == 0:
        room = int(c[C_NEXT_CAP] - c[C_NN] >= total_e)
        p = [room, 0, room, 0, 0, 0, 0, 0, -1, -1, -1, -1]
    ok = o["en2"] & q["ok"]
    errv = torch.where(ok, o["err"], 0)
    viol = ok & ~o["iok"] & (errv == 0)
    have_v = bool(viol.any())
    bag = bool(((errv & ERR_BAG_OVERFLOW) != 0).any())
    slot = bool(((errv & ~ERR_BAG_OVERFLOW) != 0).any())
    ovf = bool(q["ovf"][0])
    if have_v and p[P_VROW] < 0:
        i = int(torch.nonzero(viol)[0, 0])
        p[P_VROW], p[P_VAID], p[P_VLANE] = (int(q["pidx"][i]), a,
                                            int(q["lane"][i]))
    if ovf and not p[P_OVF_E]:
        p[P_GROW_AID] = a
    p[P_VIOL] |= have_v
    p[P_BAG] |= bag
    p[P_SLOT] |= slot
    p[P_OVF_E] |= ovf
    commit_a = bool(p[P_COMMIT]) and not (have_v or slot or bag or ovf) \
        and c[C_HALT] == 0
    p[P_COMMIT_A] = int(commit_a)
    pa.copy_(torch.tensor(p, dtype=I64, device=pa.device))
    mcommit.copy_(ok & commit_a)
    return mcommit


def _gate_kernel(carry, pa, q, o, a, total_e, mcommit):
    E = mcommit.shape[0]
    ck = kernels.check
    kernels.launch(
        "action_gate", "tpuvsr_action_gate",
        ck(carry, "carry", I64), ck(pa, "pa", I64, (len(PA_FIELDS),)),
        ck(o["en2"], "en2", torch.bool, (E,)),
        ck(o["iok"], "iok", torch.bool, (E,)),
        ck(o["err"], "err", I32, (E,)),
        ck(q["pidx"], "pidx", I32, (E,)), ck(q["lane"], "lane", I32, (E,)),
        ck(q["ok"], "ok", torch.bool, (E,)),
        ck(q["ovf"], "ovf", torch.bool, (1,)), int(a), E, int(total_e),
        ck(mcommit, "mcommit", torch.bool, (E,)), kernels.stream_of(mcommit))
    return mcommit


def action_finish(carry, pa, q, fresh, ovf_i, a, cnts, en_any, valid, bufs,
                  dest):
    """K15 wrapper, second entry, after action ``a``'s insert (K1's
    ``fresh`` [E] bool over a's segment ``q``, whose ``aid`` is a, and
    its overflow ``ovf_i``, a 0-dim int32 tensor or a bool).  Writes
    ``dest`` [E] int32 = ``nn + cumsum(fresh) - 1`` for fresh items and
    -1 for the rest (K4's pack-scatter rows), scatters each fresh item's
    (tile base + row, a, lane) into ``bufs`` (``par``, ``act``,
    ``prm``), adds a's fresh
    count to the carry's ``nn`` and ``fp_count``, and carries the chain
    on: commit = commit_a and no probe overflow.  After the last action
    (``a`` = n_act - 1, ``cnts`` [n_act] K7's exact counts of the tile)
    it folds the tile's verdict into the carry as ``commit_finish``
    does: the reason by the priority next-buffer gate > violation >
    slot > bag > expand > fpset, then deadlock (a valid row of
    ``en_any`` [T] with nothing enabled, when the carry asks for it);
    on the final commit ``gen`` and ``act`` by the counts; ``t`` and
    ``tiles`` by one when it commits and the reason stays RUNNING;
    ``halt`` on any reason.  A halted carry gets ``dest`` all -1, and
    one more ``idle`` replay at the last action."""
    if fresh.device.type == "cpu":
        return action_finish_plain(carry, pa, q, fresh, ovf_i, a, cnts,
                                   en_any, valid, bufs, dest)
    return _action_finish_kernel(carry, pa, q, fresh, ovf_i, a, cnts,
                                 en_any, valid, bufs, dest)


def action_finish_plain(carry, pa, q, fresh, ovf_i, a, cnts, en_any, valid,
                        bufs, dest):
    last = a == cnts.shape[0] - 1
    c = carry.tolist()
    if c[C_HALT]:
        return _halted_plain(carry, dest, last)
    nn = c[C_NN]
    nfi = _rank_scatter_plain(fresh, nn, c[C_T] * valid.shape[0], q, bufs,
                              dest)
    oi = bool(ovf_i)
    p = pa.tolist()
    c[C_NN] = nn + nfi
    c[C_FP_COUNT] += nfi
    p[P_OVF_I] |= int(oi)
    p[P_COMMIT] = int(bool(p[P_COMMIT_A]) and not oi)
    if last:
        _fold_verdict_plain(
            c, p[P_ROOM], p[P_VIOL], p[P_SLOT], p[P_BAG], p[P_OVF_E],
            p[P_OVF_I], p[P_COMMIT], p[P_GROW_AID], p[P_VROW], p[P_VAID],
            p[P_VLANE], en_any, valid, cnts)
    carry.copy_(torch.tensor(c, dtype=I64, device=carry.device))
    pa.copy_(torch.tensor(p, dtype=I64, device=pa.device))
    return dest


def _action_finish_kernel(carry, pa, q, fresh, ovf_i, a, cnts, en_any,
                          valid, bufs, dest):
    E = fresh.shape[0]
    n_act = cnts.shape[0]
    T = valid.shape[0]
    ck = kernels.check
    kernels.launch(
        "action_finish", "tpuvsr_action_finish",
        ck(carry, "carry", I64), ck(pa, "pa", I64, (len(PA_FIELDS),)),
        ck(fresh, "fresh", torch.bool, (E,)), ck(ovf_i, "ovf_i", I32, ()),
        ck(q["pidx"], "pidx", I32, (E,)), ck(q["lane"], "lane", I32, (E,)),
        ck(q["aid"], "aid", I32, (E,)), int(a), E, n_act,
        ck(cnts, "cnts", I64, (n_act,)),
        ck(en_any, "en_any", torch.bool, (T,)),
        ck(valid, "valid", torch.bool, (T,)), T,
        ck(bufs.par, "par", I32), ck(bufs.act, "act", I32),
        ck(bufs.prm, "prm", I32), ck(dest, "dest", I32, (E,)),
        kernels.stream_of(fresh))
    return dest


# ----------------------------------------------------------------------
# K17: the ample-set step (partial-order reduction)
# ----------------------------------------------------------------------
def por_tables(amat, device):
    """The reduction's tables for one ``PORFilter`` on ``device``:
    ``amat`` ([n_act, n_act] bool, the plain versions' matrix) and
    ``conf`` ([n_act] int64 bit patterns of uint64 masks: bit b of
    ``conf[a]`` is ``~amat[a, b]``, the actions whose being enabled
    vetoes a; K17's cand reads these)."""
    amat = torch.as_tensor(amat, dtype=torch.bool)
    n_act = amat.shape[0]
    if n_act > MAX_ACTIONS:
        raise ValueError(f"por: {n_act} actions, K17 takes at most "
                         f"{MAX_ACTIONS}")
    conf = []
    for a in range(n_act):
        m = 0
        for b in range(n_act):
            if not bool(amat[a, b]):
                m |= 1 << b
        conf.append(m - (1 << 64) if m >= 1 << 63 else m)
    return {"amat": amat.to(device),
            "conf": torch.tensor(conf, dtype=I64, device=device)}


def por_buffers(T, total, n_act, device):
    """K17's outputs for a tile of ``T`` rows and a queue of ``total``
    items: per row ``has_cand``, ``aid_star``, ``n_en``, ``amp_bad``; per
    item ``keep`` and ``mark``; ``kept`` [n_act] and ``amp`` [1]."""
    z = lambda n, dt: torch.zeros((n,), dtype=dt, device=device)
    return {"has_cand": z(T, torch.bool), "aid_star": z(T, I32),
            "n_en": z(T, I32), "amp_bad": z(T, I32),
            "keep": z(total, torch.bool), "mark": z(total, I32),
            "kept": z(n_act, I64), "amp": z(1, I64)}


def por_cand(en, valid, segs, pt, P):
    """K17 wrapper, first entry.  ``en`` [T, n_lanes] bool guard matrix
    of a tile, ``valid`` [T] bool, ``segs`` a ``Segments`` (each action's
    first lane and lane count), ``pt`` ``por_tables``.  Writes into
    ``P`` (``por_buffers``): ``has_cand`` (some enabled action of the
    row conflicts with no enabled action), ``aid_star`` (the lowest such
    action, 0 when none), ``n_en`` (the row's enabled actions);
    ``amp_bad``, ``kept`` and ``amp`` are cleared."""
    if en.device.type == "cpu":
        return por_cand_plain(en, valid, segs, pt, P)
    T, n_lanes = en.shape
    n_act = len(segs.host)
    ck = kernels.check
    kernels.launch(
        "por_cand", "tpuvsr_por_cand",
        ck(en, "en", torch.bool, (T, n_lanes)),
        ck(valid, "valid", torch.bool, (T,)), T, n_lanes,
        ck(segs.dev, "segs", I32, (n_act, 4)), n_act,
        ck(pt["conf"], "conf", I64, (n_act,)),
        ck(P["has_cand"], "has_cand", torch.bool, (T,)),
        ck(P["aid_star"], "aid_star", I32, (T,)),
        ck(P["n_en"], "n_en", I32, (T,)),
        ck(P["amp_bad"], "amp_bad", I32, (T,)),
        ck(P["kept"], "kept", I64, (n_act,)),
        ck(P["amp"], "amp", I64, (1,)), kernels.stream_of(en))
    return P


def por_cand_plain(en, valid, segs, pt, P):
    """Plain version of ``por_cand``: the JAX body's matmul (``conflict =
    en_act @ ~amat.T > 0``, an int32 one there; float32 here, which
    PyTorch multiplies on the card too, and exact: each sum counts at
    most 64 ones) and argmax."""
    en_act = torch.stack([en[:, lo:lo + L].any(dim=1)
                          for lo, L, _E, _qo in segs.host],
                         dim=1) & valid[:, None]
    conflict = (en_act.float() @ (~pt["amat"]).float().T) > 0
    cand = en_act & ~conflict
    P["has_cand"].copy_(cand.any(dim=1))
    P["aid_star"].copy_(torch.argmax(cand.to(torch.int8), dim=1))
    P["n_en"].copy_(en_act.sum(dim=1))
    P["amp_bad"].zero_()
    P["kept"].zero_()
    P["amp"].zero_()
    return P


def por_probe(table, gids, fps, en2, q, P, pdepth):
    """K17 wrapper, second entry, BEFORE K1's insert: the ample items
    (enabled, of a row with a candidate, of its ``aid_star``) probe
    their fingerprints ``fps`` ([total, 4] int32) in ``table``'s slots
    and the level-marker column ``gids``; a stored marker ``0 <= g <=
    pdepth`` (``pdepth`` a one-word int64 tensor: an old state) sets
    ``P["amp_bad"]`` of the item's row."""
    if fps.device.type == "cpu":
        return por_probe_plain(table, gids, fps, en2, q, P, pdepth)
    slots = table["slots"]
    cap = slots.shape[0]
    total = fps.shape[0]
    T = P["has_cand"].shape[0]
    ck = kernels.check
    kernels.launch(
        "por_probe", "tpuvsr_por_probe",
        ck(slots, "slots", I32, (cap, 5)), cap,
        ck(gids, "gids", I32, (cap,)), ck(fps, "fps", I32, (total, 4)),
        ck(en2, "en2", torch.bool, (total,)),
        ck(q["ok"], "ok", torch.bool, (total,)),
        ck(q["pidx"], "pidx", I32, (total,)),
        ck(q["aid"], "aid", I32, (total,)), total,
        ck(P["has_cand"], "has_cand", torch.bool, (T,)),
        ck(P["aid_star"], "aid_star", I32, (T,)),
        ck(pdepth, "pdepth", I64, (1,)),
        ck(P["amp_bad"], "amp_bad", I32, (T,)), kernels.stream_of(fps))
    return P


def por_probe_plain(table, gids, fps, en2, q, P, pdepth):
    """Plain version of ``por_probe``: ``lookup_gids_plain`` of the ample
    items and a scatter amax of the old ones onto their rows."""
    pidx = q["pidx"].long()
    is_amp = (en2 & q["ok"] & P["has_cand"][pidx]
              & (q["aid"] == P["aid_star"][pidx]))
    g = lookup_gids_plain(table, gids, fps, is_amp)
    old = is_amp & (g >= 0) & (g <= int(pdepth))
    P["amp_bad"].scatter_reduce_(0, pidx, old.to(I32), "amax")
    return P


def por_keep(en2, q, P, pdepth):
    """K17 wrapper, third entry: ``take`` = has_cand and not amp_bad per
    row; ``P["keep"]`` = enabled items of rows that do not take the
    shortcut, and of those that do, their ``aid_star`` items only;
    ``P["kept"]`` the kept items per action; ``P["amp"]`` the rows that
    take it with more than one action enabled; ``P["mark"]`` = pdepth +
    1 (the level marker K11 stores on the fresh lanes)."""
    if en2.device.type == "cpu":
        return por_keep_plain(en2, q, P, pdepth)
    total = en2.shape[0]
    T = P["has_cand"].shape[0]
    n_act = P["kept"].shape[0]
    ck = kernels.check
    kernels.launch(
        "por_keep", "tpuvsr_por_keep",
        ck(en2, "en2", torch.bool, (total,)),
        ck(q["ok"], "ok", torch.bool, (total,)),
        ck(q["pidx"], "pidx", I32, (total,)),
        ck(q["aid"], "aid", I32, (total,)), total,
        ck(P["has_cand"], "has_cand", torch.bool, (T,)),
        ck(P["aid_star"], "aid_star", I32, (T,)),
        ck(P["n_en"], "n_en", I32, (T,)),
        ck(P["amp_bad"], "amp_bad", I32, (T,)), T,
        ck(pdepth, "pdepth", I64, (1,)),
        ck(P["keep"], "keep", torch.bool, (total,)),
        ck(P["mark"], "mark", I32, (total,)),
        ck(P["kept"], "kept", I64, (n_act,)),
        ck(P["amp"], "amp", I64, (1,)), kernels.stream_of(en2))
    return P


def por_keep_plain(en2, q, P, pdepth):
    """Plain version of ``por_keep`` (the JAX body's keep_q, kept_act and
    amp expressions)."""
    pidx = q["pidx"].long()
    take = P["has_cand"] & (P["amp_bad"] == 0)
    keep = en2 & q["ok"] & (~take[pidx] | (q["aid"] == P["aid_star"][pidx]))
    P["keep"].copy_(keep)
    P["mark"].fill_(int(pdepth) + 1)
    P["kept"].copy_(torch.zeros_like(P["kept"]).index_add_(
        0, q["aid"].long(), keep.to(I64)))
    P["amp"].copy_((take & (P["n_en"] > 1)).sum().reshape(1))
    return P
