"""Parity of the port's VR_STATE_TRANSFER (ST03) model with the JAX
package's on the CPU: the codec (``models/st03.py``), the guards (K13's
plain version), the transition relation and invariants (K14's plain
version) and the fingerprints (K3 with ST03's global row), bit for bit.

For every lane of every action on each input row, the JAX package's
``act_*`` (vmapped, from ``seed_touch``), ``lane_replica`` and
``invariant_fn`` over all of ``INVARIANT_FNS`` give the successor, its
enabled bit, its error flags, the touch list ``_ts``/``_tn``, the lane
replica and the invariants; ``successors_plain`` must give the same.
Inputs, per case (cfg, NoProgressChangeLimit, MAX_MSGS):

* rows reached by stepping the JAX ST03Kernel from the all-zero Init
  with every replica in view 1 (``ST03Codec.init_dense``) along
  numpy-seeded random walks;
* rows of the state-transfer era met on those walks (a replica in
  StateTransfer, or a GetState or NewState in the bag), which half of
  the walkers reach by leaving one replica behind a view change (the
  era opens on the shipped cfg only: with one value SendGetState never
  fires);
* in the small case, a row whose bag is full (every send overflows) and
  a row whose free slots hold, as count-0 tombstones, the records one of
  its actions sends (the upsert revives them).

The cases cover both cfgs of ``tpuvsr_torch/configs`` with
NoProgressChangeLimit 0 and 1 (the second enables NoProgressChange's
SUBSET lanes).  Plus the host tables K13 and K14 read against the enums
of their CUDA sources.  Everything compared is integer: tolerance 0."""

import functools
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_gids import expand_macros
from tests.test_torch_vsr_kernel import WIDE_WORDS, wide_word_check
from tpuvsr.analysis.passes.widths import derive_ranges_from as j_ranges
from tpuvsr.engine.device_bfs import DeviceBFS as JDeviceBFS
from tpuvsr.engine.pack import build_pack_spec as j_pack_spec
from tpuvsr.frontend.cfg import parse_cfg_file as j_cfg
from tpuvsr.models.st03 import ST03Codec as JCodec
from tpuvsr.models.st03_kernel import ST03Kernel as JKernel
from tpuvsr_torch import kernels
from tpuvsr_torch.analysis.widths import derive_ranges_from
from tpuvsr_torch.engine.spec import load_binding
from tpuvsr_torch.models import st03 as pst
from tpuvsr_torch.models import st03_kernel as psk
from tpuvsr_torch.models.registry import make_model
from tpuvsr_torch.models.st03_kernel import (ACTION_NAMES, ALL_KEYS,
                                             GUARD_PLANES)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "tpuvsr_torch", "configs")
SMALL = os.path.join(CONFIGS, "VR_STATE_TRANSFER_small.cfg")
SHIPPED = os.path.join(CONFIGS, "VR_STATE_TRANSFER_shipped.cfg")
CSRC = os.path.join(ROOT, "tpuvsr_torch", "csrc")
MODULE = "VR_STATE_TRANSFER"
FIELDS = ("succ", "en2", "err", "ts", "tn", "ri", "iok")
# name -> (cfg, NoProgressChangeLimit, MAX_MSGS, walk seed)
CASES = {"small": (SMALL, 0, 32, 21), "small_np1": (SMALL, 1, 16, 22),
         "shipped": (SHIPPED, 0, 32, 24), "shipped_np1": (SHIPPED, 1, 24, 25)}


def _binding(path, np_limit):
    b = load_binding(path, MODULE)
    b.cfg.constants["NoProgressChangeLimit"] = np_limit
    return b


def _jax_codec(path, np_limit, max_msgs):
    cfg = j_cfg(path)
    cfg.constants["NoProgressChangeLimit"] = np_limit
    return JCodec(cfg.constants, max_msgs=max_msgs)


def _jax_all_lanes(jk, invariants=None):
    """jit(vmap over states) of every lane of every action of a JAX
    kernel of the family, from ``seed_touch``: (successor, enabled,
    _ts, _tn, lane replica, the conjunction of ``invariants``, by default
    all of the kernel's), each with a [B, n_lanes] leading pair of
    axes."""
    inv = jk.invariant_fn(list(invariants or jk.INVARIANT_FNS))

    def per_state(st):
        outs = []
        for name, fn in zip(jk.action_names, jk._action_fns()):
            def one(ln, fn=fn, name=name):
                succ, en = fn(jk.seed_touch(st), ln)
                clean = {k: v for k, v in succ.items()
                         if not k.startswith("_")}
                return (clean, en, succ["_ts"], succ["_tn"],
                        jk.lane_replica(name, st, ln), inv(clean))
            outs.append(jax.vmap(one)(
                jnp.arange(jk._lane_count(name), dtype=jnp.int32)))
        return jax.tree.map(lambda *xs: jnp.concatenate(xs), *outs)
    return jax.jit(jax.vmap(per_state))


# every JAX call takes PAD states (fingerprints: CHUNK), padded with
# copies of the first, so each function compiles once per case
PAD = 64
CHUNK = 4096


def _run(fn, batch, size=PAD):
    """``fn`` on ``batch`` (a dict of [n, ...] arrays) in padded pieces
    of ``size`` states; the outputs, as numpy, trimmed to n."""
    n = len(next(iter(batch.values())))
    outs = []
    for lo in range(0, n, size):
        part = {k: v[lo:lo + size] for k, v in batch.items()}
        m = len(next(iter(part.values())))
        part = {k: np.concatenate([v, np.repeat(v[:1], size - m, 0)])
                for k, v in part.items()}
        outs.append(jax.tree.map(lambda x: np.asarray(x)[:m], fn(part)))
    return jax.tree.map(lambda *xs: np.concatenate(xs), *outs)


@functools.lru_cache(maxsize=None)
def _jax(name):
    path, np_limit, mm, _seed = CASES[name]
    return jax_fns_of(JKernel(_jax_codec(path, np_limit, mm)))


def jax_fns_of(jk):
    """(JAX kernel, all-lanes step, fingerprint, guard matrix, every
    invariant and hunt_score, parent parts) of a JAX kernel of the
    family, each jitted."""
    fns = [getattr(jk, f) for f in jk.INVARIANT_FNS.values()]
    mat = JDeviceBFS._guard_matrix(None, jk)
    return SimpleNamespace(
        jk=jk, step=_jax_all_lanes(jk), fp=jax.jit(jax.vmap(jk.fingerprint)),
        guards=jax.jit(lambda b: jnp.concatenate(mat(b), axis=1)),
        invs=jax.jit(jax.vmap(lambda st: tuple(f(st) for f in fns)
                              + (jk.hunt_score(st),))),
        parts=jax.jit(jax.vmap(jk.parent_parts)))


def _fps(J, states):
    return _run(J.fp, states, CHUNK)


def _batch(rows):
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def _is_era(row):
    """A replica in StateTransfer, or a GetState/NewState in the bag."""
    t = row["m_hdr"][:, pst.H_TYPE]
    return bool((row["status"] == pst.STATETRANSFER).any()
                or ((row["m_present"] == 1)
                    & ((t == pst.M_GETSTATE) | (t == pst.M_NEWSTATE))).any())


# lane weights of the guided walkers: a view change, a new primary and
# its client requests first, then the state transfer (and I01's resends)
GUIDE = {"TimerSendSVC": 0.2, "ReceiveClientRequest": 50.0, "SendSV": 30.0,
         "SendDVC": 20.0,
         "ReceiveMatchingDVC": 10.0, "ReceiveMatchingSVC": 10.0,
         "ReceiveHigherSVC": 10.0, "SendGetState": 50.0,
         "ReceiveGetState": 50.0, "ReceiveNewState": 50.0,
         "ResendSVC": 10.0}


def _walk_rows(jk, f, init, seed, walkers=PAD, steps=24, lag=16,
               guide=None):
    """Distinct rows along numpy-seeded random walks from ``init``, with
    the enabled bits of each (a walker with no enabled lane, or whose
    chosen successor overflows the bag, stays put).  Half of the walkers
    choose lanes uniformly; the other half are guided by ``GUIDE`` and,
    for their first ``lag`` steps, take no lane of the last replica and
    no client request of the first (view 1's primary): the last replica
    lags behind a view change, a Prepare of the newer view reaches it,
    and the state-transfer era opens where the cfg allows it (two values
    or more: SendGetState needs a Prepare two ops ahead)."""
    rng = np.random.default_rng(seed)
    batch = {k: np.repeat(np.asarray(v)[None], walkers, 0)
             for k, v in init.items()}
    names = jk.action_names
    guide = GUIDE if guide is None else guide
    weight = np.array([guide.get(n, 1.0) for n in names])[jk.lane_action]
    crq = jk.lane_action == names.index("ReceiveClientRequest")
    seen, rows, ens = set(), [], []
    for step in range(steps):
        succ, en, _ts, _tn, ri = f(batch)[:5]
        en, ri = np.asarray(en), np.asarray(ri)
        err = np.asarray(succ["err"])
        for w in range(walkers):
            row = {k: v[w] for k, v in batch.items()}
            key = b"".join(np.ascontiguousarray(row[k]).tobytes()
                           for k in sorted(row))
            if key not in seen:
                seen.add(key)
                rows.append(row)
                ens.append(en[w])
        pick = np.full(walkers, -1)
        for w in range(walkers):
            ok = en[w] & (err[w] == 0)
            guided = w < walkers // 2
            if guided and step < lag:
                ok &= (ri[w] != jk.R - 1) & ~(crq & (ri[w] == 0))
            ok = np.nonzero(ok)[0]
            if len(ok):
                p = weight[ok] if guided else np.ones(len(ok))
                pick[w] = rng.choice(ok, p=p / p.sum())
        nxt = {}
        for k, v in succ.items():
            v = np.asarray(v)
            nxt[k] = np.where(
                (pick >= 0).reshape((-1,) + (1,) * (v.ndim - 2)),
                v[np.arange(walkers), np.maximum(pick, 0)], batch[k])
        batch = nxt
    return rows, ens


def _full_bag_row(row, M, anydest=True):
    """``row`` with every free message slot holding a distinct record no
    action sends and none receives (a PrepareOk of view 0, count 1),
    each field inside its packing range; a destination of -1 (AnyDest)
    only where the model declares AnyDest."""
    row = {k: np.array(v) for k, v in row.items()}
    combos = iter([(op, dest, src) for op in range(-1, 3)
                   for dest in range(-1 if anydest else 0, 4)
                   for src in range(4)])
    for m in range(M):
        if row["m_present"][m] == 0:
            op, dest, src = next(combos)
            row["m_present"][m] = 1
            row["m_count"][m] = 1
            row["m_hdr"][m, :] = 0
            row["m_hdr"][m, pst.H_TYPE] = pst.M_PREPAREOK
            row["m_hdr"][m, pst.H_OP] = op
            row["m_hdr"][m, pst.H_DEST] = dest
            row["m_hdr"][m, pst.H_SRC] = src
    assert row["m_present"].all()
    return row


def _tombstone_row(kern, rows):
    """A row whose free slots hold, as count-0 tombstones, the records
    the first enabled ReceiveClientRequest lane of one of ``rows``
    broadcasts: that lane's upsert must revive them.  Returns (row,
    lane index in the lane table, the revived slots)."""
    a = ACTION_NAMES.index("ReceiveClientRequest")
    lo = sum(kern._lane_count(n) for n in ACTION_NAMES[:a])
    for row in rows:
        flat = kern.pk.flatten({k: torch.as_tensor(v)[None]
                                for k, v in row.items()})
        for p in range(kern._lane_count("ReceiveClientRequest")):
            one = torch.zeros((1,), dtype=torch.int32)
            o = kern.successors_plain(flat, one, one + a, one + p, 0)
            if not bool(o["en2"][0]):
                continue
            succ = kern.pk.unflatten(o["succ"])
            new = torch.nonzero((succ["m_present"][0] == 1)
                                & (torch.as_tensor(row["m_present"]) == 0)
                                )[:, 0].tolist()
            t = {k: np.array(v) for k, v in row.items()}
            for m in new:
                for k in ("m_hdr", "m_entry", "m_log"):
                    t[k][m] = succ[k][0, m].numpy()
                t["m_present"][m] = 1
                t["m_count"][m] = 0
            return t, lo + p, new
    raise AssertionError("no enabled ReceiveClientRequest lane")


def _jax_outputs(pk, f, batch):
    clean, en, ts, tn, ri, iok = _run(f, batch)
    B, L = np.asarray(en).shape
    succ = pk.flatten({k: torch.as_tensor(np.array(v)).reshape(
        (B * L,) + tuple(np.asarray(v).shape[2:])) for k, v in
        clean.items()}).numpy().reshape(B, L, -1)
    return ({"succ": succ, "en2": np.asarray(en),
             "err": np.asarray(clean["err"]), "ts": np.asarray(ts),
             "tn": np.asarray(tn), "ri": np.asarray(ri),
             "iok": np.asarray(iok)},
            {k: np.asarray(v) for k, v in clean.items()})


def _port_outputs(kern, flat):
    B, L = flat.shape[0], kern.n_lanes
    pidx = torch.arange(B, dtype=torch.int32).repeat_interleave(L)
    aid = torch.as_tensor(kern.lane_action).repeat(B)
    lane = torch.as_tensor(kern.lane_param).repeat(B)
    mask = kern.invariant_mask(list(kern.INVARIANT_FNS))
    assert mask == (1 << len(kern.INVARIANT_FNS)) - 1
    o = kern.successors(flat, pidx, aid, lane, mask)
    return {k: v.numpy().reshape((B, L) + tuple(v.shape[1:]))
            for k, v in o.items()}


@functools.lru_cache(maxsize=None)
def _case(name):
    """The case's rows: Init, one walked row enabling each action that is
    enabled on some walked row, more walked rows up to 40, up to 12 rows
    of the state-transfer era; in the small case the full-bag and
    tombstone rows."""
    path, np_limit, mm, seed = CASES[name]
    J = _jax(name)
    jk, f = J.jk, J.step
    _c, kern = make_model(_binding(path, np_limit), max_msgs=mm)
    init = kern.codec.init_dense()
    walked, ens = _walk_rows(jk, f, init, seed)
    rng = np.random.default_rng(seed)
    chosen = set()
    for a in range(len(ACTION_NAMES)):
        hit = [i for i, e in enumerate(ens) if e[jk.lane_action == a].any()]
        if hit:
            chosen.add(int(rng.choice(hit)))
    rest = [i for i in range(len(walked)) if i not in chosen]
    era = [i for i in rest if _is_era(walked[i])]
    plain = [i for i in rest if not _is_era(walked[i])]
    pick = lambda idx, n: list(rng.choice(idx, size=min(n, len(idx)),
                                          replace=False)) if idx else []
    chosen |= set(pick(plain, 40 - len(chosen))) | set(pick(era, 12))
    rows = [init] + [walked[i] for i in sorted(chosen)]
    info = {"era": sum(_is_era(r) for r in rows)}
    if name == "small":
        rows.append(_full_bag_row(init, mm))
        t, lane, revived = _tombstone_row(kern, rows[:-1])
        rows.append(t)
        info.update(full=len(rows) - 2, tomb=len(rows) - 1, tomb_lane=lane,
                    revived=revived)
    batch = _batch(rows)
    flat = kern.pk.flatten({k: torch.as_tensor(v)
                            for k, v in batch.items()}).contiguous()
    want, jsucc = _jax_outputs(kern.pk, f, batch)
    return SimpleNamespace(name=name, J=J, jk=jk, kern=kern, rows=rows,
                           batch=batch, flat=flat, info=info, want=want,
                           jsucc=jsucc, got=_port_outputs(kern, flat))


# the cases of this file (tests/test_torch_st03_shipped.py runs the same
# tests on the shipped cfg's)
@pytest.fixture(scope="module", params=["small", "small_np1"])
def case(request):
    return _case(request.param)


# ----------------------------------------------------------------------
# (a) the codec and its packed layout
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_codec_layout_matches_jax(name):
    path, np_limit, mm, _seed = CASES[name]
    jc = _jax_codec(path, np_limit, mm)
    codec, kern = make_model(_binding(path, np_limit), max_msgs=mm)
    jz, pz = jc.zero_state(), codec.zero_state()
    assert list(jz) == list(pz)
    for k in jz:
        assert jz[k].shape == pz[k].shape and jz[k].dtype == pz[k].dtype, k
    constants = kern.codec.constants
    assert derive_ranges_from(constants, MODULE) == \
        j_ranges(jc.constants, MODULE)
    ranges = derive_ranges_from(constants, MODULE)
    assert codec.plane_bounds(ranges) == jc.plane_bounds(ranges)
    jpk = j_pack_spec(jc, ranges=j_ranges(jc.constants, MODULE))
    assert kern.pk.version == jpk.version
    assert kern.pk.words == jpk.words
    init = codec.init_dense()
    assert (init["view"] == 1).all()
    assert all(not v.any() for k, v in init.items() if k != "view")


def test_codec_round_trip_matches_jax(case):
    """decode(row) prints as the JAX codec's decode(row); encode brings
    it back to the row, its bag in the decoded record order (a bag's
    slot order is not part of the state: the fingerprint sums the
    slots)."""
    jc, codec, kern = case.jk.codec, case.kern.codec, case.kern
    back = []
    for row in case.rows:
        st = codec.decode(row)
        assert repr(st) == repr(jc.decode(row))
        enc = codec.encode(st)
        for k in row:
            if k not in codec.MSG_KEYS:
                assert np.array_equal(enc[k], row[k]), k
        assert int(enc["m_present"].sum()) == int(row["m_present"].sum())
        back.append(enc)
    flat = kern.pk.flatten({k: torch.as_tensor(v)
                            for k, v in _batch(back).items()})
    assert torch.equal(kern.fingerprint(flat), kern.fingerprint(case.flat))


def test_pack_round_trip(case):
    pk = case.kern.pk
    assert torch.equal(pk.unpack(pk.pack(case.flat)), case.flat)


# ----------------------------------------------------------------------
# (b) the guards, (c) the successors and invariants
# ----------------------------------------------------------------------
# the actions no state of a cfg enables: with one value no log holds
# two entries, so SendGetState (a Prepare two ops ahead) never fires and
# the state-transfer era stays closed; NoProgressChange needs its limit
STATE_TRANSFER = ["SendGetState", "ReceiveGetState", "ReceiveNewState"]


def test_inputs_cover_the_actions(case):
    """Every action a case's cfg can enable is enabled somewhere on its
    rows; the state-transfer era is met where it opens."""
    en = case.got["en2"]
    per = {n: bool(en[:, case.kern.lane_action == a].any())
           for a, n in enumerate(ACTION_NAMES)}
    path, np_limit = CASES[case.name][:2]
    off = [n for n, hit in per.items() if not hit]
    want = ((STATE_TRANSFER if path == SMALL else [])
            + ([] if np_limit else ["NoProgressChange"]))
    assert off == want, off
    assert case.info["era"] >= (0 if path == SMALL else 4)


def test_guard_matrix_matches_jax(case):
    want = _run(case.J.guards, case.batch)
    en, en_any = case.kern.guard_matrix(case.flat)
    assert en.shape == (case.flat.shape[0], case.kern.n_lanes)
    assert np.array_equal(en.numpy(), want)
    assert np.array_equal(en_any.numpy(), want.any(axis=1))
    # the guards are the actions' enabled bits
    assert np.array_equal(en.numpy(), case.got["en2"])


@pytest.mark.parametrize("action", ACTION_NAMES)
def test_successors_plain_matches_jax(case, action):
    a = ACTION_NAMES.index(action)
    cols = np.nonzero(case.kern.lane_action == a)[0]
    for k in FIELDS:
        g = case.got[k][:, cols]
        w = case.want[k][:, cols].astype(g.dtype)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        assert np.array_equal(g, w), (case.name, action, k)


def test_invariants_match_jax(case):
    """Each invariant alone, and hunt_score, on the rows and on every
    enabled successor."""
    kern = case.kern
    en = case.want["en2"]
    succ = {k: v[en] for k, v in case.jsucc.items()}
    for batch, size in ((case.batch, PAD), (succ, CHUNK)):
        want = _run(case.J.invs, batch, size)
        st = {k: torch.as_tensor(v) for k, v in batch.items()}
        for w, (_n, f) in zip(want, kern.invariant_fns(
                list(kern.INVARIANT_FNS))):
            assert np.array_equal(w, f(st).numpy()), _n
        assert np.array_equal(want[-1], kern.hunt_score(st).numpy())
    # the cfg's conjunction
    names = _binding(SMALL, 0).invariants
    st = {k: torch.as_tensor(v) for k, v in case.batch.items()}
    want = np.logical_and.reduce([f(st).numpy() for _n, f in
                                  kern.invariant_fns(names)])
    assert np.array_equal(kern.invariant_fn(names)(st).numpy(), want)


def test_full_bag_overflows_and_tombstones_revive():
    """At MAX_MSGS 32 the full bag overflows on a send (the record lands
    in slot 0) while the tombstones revive; the new primary's own
    DoViewChange is inserted processed (count 0, SendAsReceived)."""
    case = _case("small")
    kern, got, i = case.kern, case.got, case.info
    en = got["en2"]
    full_err = got["err"][i["full"]]
    assert (full_err[en[i["full"]]] & pst.ERR_BAG_OVERFLOW).any()
    lane = i["tomb_lane"]
    assert en[i["tomb"], lane] and i["revived"]
    st = kern.pk.unflatten(torch.as_tensor(got["succ"][i["tomb"], lane]
                                           [None]))
    tomb = case.rows[i["tomb"]]
    for m in i["revived"]:
        assert tomb["m_count"][m] == 0 and st["m_count"][0, m] == 1
    assert np.array_equal(st["m_present"][0].numpy(), tomb["m_present"])
    # SendAsReceived somewhere on the rows
    a = ACTION_NAMES.index("SendDVC")
    born = 0
    for b, row in enumerate(case.rows):
        for c in np.nonzero((kern.lane_action == a) & en[b])[0]:
            s = kern.pk.unflatten(torch.as_tensor(got["succ"][b, c][None]))
            new = (s["m_present"][0].numpy() == 1) & (row["m_present"] == 0)
            born += int((s["m_count"][0].numpy()[new] == 0).sum())
    assert born > 0


# ----------------------------------------------------------------------
# (d) K3: full, parts, incremental
# ----------------------------------------------------------------------
def test_fingerprints_match_jax(case):
    kern = case.kern
    want = _fps(case.J, case.batch)
    assert np.array_equal(want, kern.fingerprint(case.flat).numpy()
                          .view(np.uint32))
    en = case.want["en2"]
    succ = {k: v[en] for k, v in case.jsucc.items()}
    got = kern.fingerprint(torch.as_tensor(case.want["succ"][en]))
    assert np.array_equal(_fps(case.J, succ), got.numpy().view(np.uint32))


def test_parent_parts_match_jax(case):
    jr, js, jt = _run(case.J.parts, case.batch)
    pr, ps, pt = case.kern.parent_parts(case.flat)
    assert np.array_equal(jr[:, 0], pr.numpy().view(np.uint32))
    assert np.array_equal(js[:, 0], ps.numpy().view(np.uint32))
    assert np.array_equal(jt[:, 0], pt.numpy().view(np.uint32))


def test_incremental_fingerprints_match_jax(case):
    """The incremental fingerprint of every (row, lane) item from its
    parent's parts, NoProgressChange (the global row alone) included,
    equals the JAX kernel's incremental one, and on the enabled items
    without an error the full fingerprint of the successor."""
    jk, kern = case.jk, case.kern
    B, L = case.want["en2"].shape
    pidx = np.repeat(np.arange(B), L)
    flat_succ = torch.as_tensor(np.array(case.want["succ"].reshape(B * L,
                                                                   -1)))
    got = kern.fingerprint_incremental(
        flat_succ, torch.as_tensor(case.want["ri"].reshape(-1)),
        torch.as_tensor(case.want["ts"].reshape(B * L, -1)),
        torch.as_tensor(pidx, dtype=torch.int32), case.flat,
        kern.parent_parts(case.flat)).numpy().view(np.uint32)
    parts = _run(case.J.parts, case.batch)
    succ = {k: v.reshape((B * L,) + v.shape[2:])
            for k, v in case.jsucc.items()}
    succ["_ts"] = case.want["ts"].reshape(B * L, -1)

    def one(s, ri, parts_one, parent):
        return jk.fingerprint_incremental(s, ri, parts_one, parent)
    want = np.asarray(jax.jit(jax.vmap(one))(
        succ, case.want["ri"].reshape(-1),
        jax.tree_util.tree_map(lambda v: v[pidx], parts),
        {k: v[pidx] for k, v in case.batch.items()}))
    assert np.array_equal(got, want)
    # a successor that overflowed the bag (two sends into slot 0 touch it
    # twice) is never committed: the rest hash as the full fingerprint
    en = case.want["en2"].reshape(-1) & (case.want["err"].reshape(-1) == 0)
    full = kern.fingerprint(flat_succ[torch.as_tensor(en)])
    assert np.array_equal(got[en], full.numpy().view(np.uint32))
    npc = np.tile(kern.lane_action == ACTION_NAMES.index(
        "NoProgressChange"), B)
    if CASES[case.name][1]:
        assert (en & npc).any()


@pytest.mark.parametrize("what", WIDE_WORDS)
def test_fingerprints_of_wide_words_match_jax(case, what):
    """Parts, full and incremental fingerprints with the global row on
    words at and past 2^31, no touched slot and R + 1 of them
    (``testing.fp_wide_case``)."""
    wide_word_check(case.jk, case.kern, what, seed=23)


def test_plain_calls_are_counted():
    _c, kern = make_model(_binding(SMALL, 0), max_msgs=8)
    flat = kern.pk.flatten({k: torch.as_tensor(v)[None] for k, v in
                            kern.codec.init_dense().items()})
    g0, a0 = psk.PLAIN_CALLS["guards"], psk.PLAIN_CALLS["actions"]
    kern.guard_matrix(flat)
    one = torch.zeros((1,), dtype=torch.int32)
    kern.successors(flat, one, one, one, 0)
    assert psk.PLAIN_CALLS == {"guards": g0 + 1, "actions": a0 + 1}


def test_halt_writes_nothing():
    _c, kern = make_model(_binding(SMALL, 0), max_msgs=8)
    row = kern.pk.flatten({k: torch.as_tensor(v)[None] for k, v in
                           kern.codec.init_dense().items()})
    one = torch.zeros((1,), dtype=torch.int32)
    out = kern.successor_buffers(1, "cpu")
    out["succ"].fill_(7)
    halt = torch.ones((1,), dtype=torch.int64)
    # TimerSendSVC of replica 2, enabled in Init
    kern.successors(row, one, one, one + 1, 1, out, halt=halt)
    assert (out["succ"] == 7).all() and not out["en2"].any()
    g = (torch.zeros((1, kern.n_lanes), dtype=torch.bool),
         torch.ones((1,), dtype=torch.bool))
    kern.guard_matrix(row, g, halt)
    assert not g[0].any() and g[1].all()
    kern.successors(row, one, one, one + 1, 1, out,
                    halt=torch.zeros((1,), dtype=torch.int64))
    assert bool(out["en2"][0]) and not (out["succ"] == 7).all()


# ----------------------------------------------------------------------
# the host tables against the kernel sources
# ----------------------------------------------------------------------
def _enum(src, name):
    body = re.search(r"enum " + name + r" \{(.*?)\};", src, re.S).group(1)
    return [x.strip().split(" = ")[0] for x in body.replace("\n", " ")
            .split(",") if x.strip()]


def _upper_snake(camel):
    return re.sub(r"(?<!^)(?=[A-Z][a-z])", "_", camel).upper()


def _signature(src, entry):
    sig = re.search(r"TPUVSR_EXPORT int " + entry + r"\((.*?)\)",
                    expand_macros(src), re.S).group(1)
    return "".join("p" if "*" in a else "i" for a in sig.split(","))


CONSTS = ("NORMAL", "VIEWCHANGE", "STATETRANSFER", "M_PREPARE",
          "M_PREPAREOK", "M_SVC", "M_DVC", "M_SV", "M_GETSTATE",
          "M_NEWSTATE", "H_TYPE", "H_VIEW", "H_OP", "H_COMMIT", "H_DEST",
          "H_SRC", "ANYDEST")


def _consts_match(src, names):
    for const in names:
        m = re.search(r"\b" + const + r" = (-?\d+)", src)
        assert m and int(m.group(1)) == getattr(pst, const), const


def test_action_tables_match_the_kernel_source():
    src = open(os.path.join(CSRC, "st03_actions.cu")).read()
    _c, kern = make_model(_binding(SMALL, 0), max_msgs=16)
    assert _enum(src, "Plane") == ["P_" + k.upper() for k in ALL_KEYS] \
        + ["N_ST03_PLANES"]
    assert list(kern.codec.zero_state()) == list(ALL_KEYS)
    names = [f.__name__[len("act_"):].upper() for f in kern._action_fns()]
    assert _enum(src, "Action") == ["A_" + n for n in names] \
        + ["N_ST03_ACTIONS"]
    assert _enum(src, "Invariant") == [
        "I_" + _upper_snake(n) for n in kern.INVARIANT_FNS] \
        + ["N_INVARIANTS"]
    start = {k: a for k, _s, a, _e in kern.pk._splits}
    assert kern.action_tables("cpu").tolist() == [start[k] for k in ALL_KEYS]
    _consts_match(src, CONSTS + ("H_X", "H_FIRST", "H_LNV",
                                 "ERR_BAG_OVERFLOW"))
    assert _signature(src, "tpuvsr_st03_actions") == \
        kernels._ENTRY["tpuvsr_st03_actions"]
    assert kernels.KERNELS["st03_actions"][0] == "st03_actions"


def test_guard_tables_match_the_kernel_source():
    src = open(os.path.join(CSRC, "st03_guards.cu")).read()
    _c, kern = make_model(_binding(SMALL, 0), max_msgs=16)
    assert _enum(src, "Plane") == ["P_" + k.upper() for k in GUARD_PLANES] \
        + ["N_PLANES"]
    start = {k: a for k, _s, a, _e in kern.pk._splits}
    t = kern.guard_tables("cpu")
    assert t["planes"].tolist() == [start[k] for k in GUARD_PLANES]
    assert np.array_equal(t["lane_action"].numpy(), kern.lane_action)
    assert np.array_equal(t["lane_param"].numpy(), kern.lane_param)
    _consts_match(src, CONSTS)
    assert _signature(src, "tpuvsr_st03_guards") == \
        kernels._ENTRY["tpuvsr_st03_guards"]


def test_fingerprint_layout_matches_the_kernel_source():
    """vsr_fingerprint.cu takes the optional global row: the ctypes
    table, and the row tables of both models (VSR: none)."""
    src = open(os.path.join(CSRC, "vsr_fingerprint.cu")).read()
    layout = re.search(r"#define TPUVSR_LAYOUT_ARGS(.*?)\n#define", src,
                       re.S).group(1).replace("\\", "")
    kinds = "".join("p" if "*" in a else "i" for a in layout.split(","))
    assert kinds == kernels._LAYOUT
    for entry in ("tpuvsr_vsr_fp_parts", "tpuvsr_vsr_fp_incremental"):
        sig = re.search(r"TPUVSR_EXPORT int " + entry
                        + r"\(\s*TPUVSR_LAYOUT_ARGS,(.*?)\)", src,
                        re.S).group(1)
        rest = "".join("p" if "*" in a else "i" for a in sig.split(","))
        assert kernels._LAYOUT + rest == kernels._ENTRY[entry]
    _c, kern = make_model(_binding(SMALL, 0), max_msgs=16)
    start = {k: a for k, _s, a, _e in kern.pk._splits}
    assert kern.nglob == kern.R + 1
    assert kern._glob_cols.tolist() == \
        list(range(start["no_prog"], start["no_prog"] + kern.R)) \
        + [start["np_ctr"]]
    _c, vk = make_model(load_binding(os.path.join(
        ROOT, "examples", "VSR_defect.cfg"), "VSR"), max_msgs=8)
    assert vk.nglob == 0 and vk._k_glob is None
