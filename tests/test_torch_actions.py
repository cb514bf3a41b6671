"""Parity of the port's VSR transition relation (``VSRKernel.successors``,
the plain version of kernel K10) with the JAX VSRKernel on the CPU.

For every lane of every action on each input row, the JAX package's
``act_*`` (vmapped, from ``seed_touch``), ``lane_replica`` and
``invariant_fn`` over all of ``INVARIANT_FNS`` give the successor, its
enabled bit, its error flags, the touch list ``_ts``/``_tn``, the lane
replica and the invariants; ``successors_plain`` must give the same, bit
for bit.  Inputs:

* the 30 states of examples/found_violation_trace.txt (MAX_MSGS 48);
* rows reached by stepping the JAX kernel from VSR.tla's Init along
  numpy-seeded random walks: the defect cfg at MAX_MSGS 32 and the
  shipped model (tpuvsr_torch/configs/VSR_shipped.cfg) at MAX_MSGS 24;
* at MAX_MSGS 32 also a row whose message bag is full (every send
  overflows: the record lands in slot 0 with ERR_BAG_OVERFLOW) and a row
  whose slots hold, as count-0 tombstones, the very records one of its
  actions sends (the upsert revives them).

Plus the host tables K10 reads against the enums of csrc/vsr_actions.cu.
Everything compared is integer: tolerance 0."""

import functools
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuvsr.frontend.cfg import parse_cfg_file as j_cfg
from tpuvsr.frontend.parser import parse_module_text
from tpuvsr.frontend.trace_parse import parse_trace_file
from tpuvsr.interp.evalr import Evaluator
from tpuvsr.models.vsr import VSRCodec as JCodec
from tpuvsr.models.vsr_kernel import VSRKernel as JKernel
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tpuvsr_torch import kernels
from tpuvsr_torch.engine.spec import load_binding
from tpuvsr_torch.models import vsr as pvsr
from tpuvsr_torch.models.registry import make_model
from tpuvsr_torch.models.vsr_kernel import ACTION_NAMES, ALL_KEYS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFECT = os.path.join(ROOT, "examples", "VSR_defect.cfg")
SHIPPED = os.path.join(ROOT, "tpuvsr_torch", "configs", "VSR_shipped.cfg")
TRACE = os.path.join(ROOT, "examples", "found_violation_trace.txt")
SOURCE = os.path.join(ROOT, "tpuvsr_torch", "csrc", "vsr_actions.cu")
FIELDS = ("succ", "en2", "err", "ts", "tn", "ri", "iok")
SETS = ("golden48", "seeded32", "seeded24")


def _jax_all_lanes(jk):
    """jit(vmap over states) of every lane of every action, from
    ``seed_touch``: (successor, enabled, _ts, _tn, lane replica, all
    invariants), each with a [B, n_lanes] leading pair of axes."""
    inv = jk.invariant_fn(list(jk.INVARIANT_FNS))

    def per_state(st):
        outs = []
        for name, fn in zip(ACTION_NAMES, jk._action_fns()):
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


def _walk_rows(jk, f, init, n_rows, seed, walkers=48, steps=10):
    """Distinct rows along numpy-seeded random walks from ``init``."""
    rng = np.random.default_rng(seed)
    batch = {k: np.repeat(np.asarray(v)[None], walkers, 0)
             for k, v in init.items()}
    seen, rows = set(), []
    for _ in range(steps):
        succ, en = f(batch)[:2]
        en = np.asarray(en)
        pick = np.array([rng.choice(np.nonzero(e)[0]) for e in en])
        batch = {k: np.asarray(v)[np.arange(walkers), pick]
                 for k, v in succ.items()}
        for w in range(walkers):
            row = {k: v[w] for k, v in batch.items()}
            key = b"".join(np.ascontiguousarray(row[k]).tobytes()
                           for k in sorted(row))
            if key not in seen:
                seen.add(key)
                rows.append(row)
    idx = rng.choice(len(rows), size=n_rows, replace=False)
    return [rows[i] for i in sorted(idx)]


def _full_bag_row(row, M):
    """``row`` with every free message slot holding a distinct record
    no action sends (type PrepareOk, op 100 + slot, count 1)."""
    row = {k: np.array(v) for k, v in row.items()}
    for m in range(M):
        if row["m_present"][m] == 0:
            row["m_present"][m] = 1
            row["m_count"][m] = 1
            row["m_hdr"][m, :] = 0
            row["m_hdr"][m, pvsr.H_TYPE] = pvsr.M_PREPAREOK
            row["m_hdr"][m, pvsr.H_OP] = 100 + m
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
                for k in ("m_hdr", "m_entry", "m_log", "m_log_len",
                          "m_has_log"):
                    t[k][m] = succ[k][0, m].numpy()
                t["m_present"][m] = 1
                t["m_count"][m] = 0
            return t, lo + p, new
    raise AssertionError("no enabled ReceiveClientRequest lane")


def _port_outputs(kern, dense):
    B = len(dense)
    flat = kern.pk.flatten({k: torch.as_tensor(np.stack([d[k] for d in
                                                         dense]))
                            for k in dense[0]}).contiguous()
    L = kern.n_lanes
    pidx = torch.arange(B, dtype=torch.int32).repeat_interleave(L)
    aid = torch.as_tensor(kern.lane_action).repeat(B)
    lane = torch.as_tensor(kern.lane_param).repeat(B)
    mask = kern.invariant_mask(list(kern.INVARIANT_FNS))
    assert mask == 31
    o = kern.successors_plain(flat, pidx, aid, lane, mask)
    return {k: v.numpy().reshape((B, L) + tuple(v.shape[1:]))
            for k, v in o.items()}, flat


def _jax_outputs(kern, f, dense):
    batch = {k: np.stack([d[k] for d in dense]) for k in dense[0]}
    clean, en, ts, tn, ri, iok = f(batch)
    B, L = np.asarray(en).shape
    succ = kern.pk.flatten({k: torch.as_tensor(np.array(v)).reshape(
        (B * L,) + tuple(np.asarray(v).shape[2:])) for k, v in
        clean.items()}).numpy().reshape(B, L, -1)
    return {"succ": succ, "en2": np.asarray(en), "err":
            np.asarray(clean["err"]), "ts": np.asarray(ts),
            "tn": np.asarray(tn), "ri": np.asarray(ri),
            "iok": np.asarray(iok)}


def _golden():
    cfg = j_cfg(DEFECT)
    mod = parse_module_text("---- MODULE VSR ----\nCONSTANTS "
                            + ", ".join(cfg.constants) + "\n====\n")
    shim = SimpleNamespace(cfg=cfg, ev=Evaluator(mod, cfg.constants))
    jcodec = JCodec(cfg.constants, max_msgs=48)
    dense = [jcodec.encode(e.state) for e in parse_trace_file(TRACE, shim)]
    return JKernel(jcodec), dense, {}


def _seeded(cfg_path, max_msgs, seed, extra):
    cfg = j_cfg(cfg_path)
    jcodec = JCodec(cfg.constants, max_msgs=max_msgs)
    jk = JKernel(jcodec)
    f = _jax_all_lanes(jk)
    init = jcodec.zero_state()
    init["view"][:] = 1
    init["ct"][:, :, 2] = 1
    n = 48 - (2 if extra else 0)
    dense = _walk_rows(jk, f, init, n, seed)
    info = {}
    if extra:
        _c, kern = make_model(load_binding(cfg_path, "VSR"),
                              max_msgs=max_msgs)
        dense.append(_full_bag_row(dense[-1], max_msgs))
        t, lane, revived = _tombstone_row(kern, dense[:-1] + [init])
        dense.append(t)
        info = {"full": len(dense) - 2, "tomb": len(dense) - 1,
                "tomb_lane": lane, "revived": revived}
    return jk, dense, info, f


@functools.lru_cache(maxsize=None)
def _case(name):
    if name == "golden48":
        jk, dense, info = _golden()
        f = _jax_all_lanes(jk)
        cfg_path, mm = DEFECT, 48
    elif name == "seeded32":
        jk, dense, info, f = _seeded(DEFECT, 32, seed=11, extra=True)
        cfg_path, mm = DEFECT, 32
    else:
        jk, dense, info, f = _seeded(SHIPPED, 24, seed=12, extra=False)
        cfg_path, mm = SHIPPED, 24
    _c, kern = make_model(load_binding(cfg_path, "VSR"), max_msgs=mm)
    got, flat = _port_outputs(kern, dense)
    want = _jax_outputs(kern, f, dense)
    return SimpleNamespace(name=name, kern=kern, dense=dense, info=info,
                           got=got, want=want, flat=flat)


@pytest.fixture(scope="module", params=SETS)
def case(request):
    return _case(request.param)


@pytest.mark.parametrize("action", ACTION_NAMES)
def test_successors_plain_matches_jax(case, action):
    kern = case.kern
    a = ACTION_NAMES.index(action)
    cols = np.nonzero(kern.lane_action == a)[0]
    for k in FIELDS:
        g = case.got[k][:, cols]
        w = case.want[k][:, cols].astype(g.dtype)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        assert np.array_equal(g, w), (case.name, action, k)


def test_full_bag_overflows_and_tombstones_revive():
    """At MAX_MSGS 32 the full bag overflows on a send (the record lands
    in slot 0) while the tombstones revive."""
    case = _case("seeded32")
    kern, got = case.kern, case.got
    en = got["en2"]
    i = case.info
    full_err = got["err"][i["full"]]
    assert (full_err[en[i["full"]]] & pvsr.ERR_BAG_OVERFLOW).any()
    # the overflowing record lands in slot 0, as the plain version puts it
    succ = kern.pk.unflatten(torch.as_tensor(got["succ"][i["full"]]))
    over = np.nonzero(full_err & pvsr.ERR_BAG_OVERFLOW)[0]
    parent = case.dense[i["full"]]
    assert (succ["m_hdr"][over, 0].numpy() != parent["m_hdr"][0]).any()
    lane = i["tomb_lane"]
    assert en[i["tomb"], lane] and i["revived"]
    st = kern.pk.unflatten(torch.as_tensor(got["succ"][i["tomb"], lane]
                                           [None]))
    tomb = case.dense[i["tomb"]]
    for m in i["revived"]:
        assert tomb["m_count"][m] == 0 and st["m_count"][0, m] == 1
    # no new slot was taken: the revived records were found, not added
    assert np.array_equal(st["m_present"][0].numpy(), tomb["m_present"])


# ----------------------------------------------------------------------
# the host tables against the kernel source
# ----------------------------------------------------------------------
def _enum(src, name):
    body = re.search(r"enum " + name + r" \{(.*?)\};", src, re.S).group(1)
    return [x.strip() for x in body.replace("\n", " ").split(",")
            if x.strip()]


def _upper_snake(camel):
    return re.sub(r"(?<!^)(?=[A-Z][a-z])", "_", camel).upper()


def test_plane_and_action_tables_match_the_kernel_source():
    src = open(SOURCE).read()
    planes = _enum(src, "Plane")
    assert planes[-1] == "N_PLANES"
    assert planes[:-1] == ["P_" + k.upper() for k in ALL_KEYS]
    acts = _enum(src, "Action")
    names = [f.__name__[len("act_"):].upper() for f in
             make_model(load_binding(DEFECT, "VSR"))[1]._action_fns()]
    assert acts == ["A_" + n for n in names] + ["N_ACTIONS"]
    _c, kern = make_model(load_binding(DEFECT, "VSR"), max_msgs=32)
    invs = _enum(src, "Invariant")
    assert invs == ["I_" + _upper_snake(n) for n in kern.INVARIANT_FNS] \
        + ["N_INVARIANTS"]
    # every plane of the layout, at its first lane
    start = {k: a for k, _s, a, _e in kern.pk._splits}
    assert set(start) == set(ALL_KEYS)
    assert kern.action_tables("cpu").tolist() == [start[k] for k in ALL_KEYS]
    # the codec's encodings the kernel copies
    for const in ("NORMAL", "VIEWCHANGE", "RECOVERING", "M_PREPARE",
                  "M_PREPAREOK", "M_SVC", "M_DVC", "M_SV", "M_GETSTATE",
                  "M_NEWSTATE", "M_RECOVERY", "M_RECOVERYRESP", "H_TYPE",
                  "H_VIEW", "H_OP", "H_COMMIT", "H_DEST", "H_SRC", "H_X",
                  "H_FIRST", "H_LNV", "E_VIEW", "E_OPER", "E_CLIENT",
                  "E_REQ", "T_REQ", "T_OP", "T_EXEC", "ERR_BAG_OVERFLOW",
                  "ERR_DVC_OVERFLOW", "ERR_REC_OVERFLOW"):
        m = re.search(r"\b" + const + r" = (\d+)", src)
        assert m and int(m.group(1)) == getattr(pvsr, const), const


def test_entry_signature_matches_the_ctypes_table():
    src = open(SOURCE).read()
    sig = re.search(r"TPUVSR_EXPORT int tpuvsr_vsr_actions\((.*?)\)",
                    src, re.S).group(1)
    kinds = ["p" if "*" in a else "i" for a in sig.split(",")]
    assert "".join(kinds) == kernels._ENTRY["tpuvsr_vsr_actions"]
    assert kernels.KERNELS["vsr_actions"][0] == "vsr_actions"


def test_invariant_mask():
    _c, kern = make_model(load_binding(DEFECT, "VSR"), max_msgs=8)
    assert kern.invariant_mask(["AcknowledgedWriteNotLost"]) == 1
    assert kern.invariant_mask(["AllReplicasMoveToSameView",
                                "NoLogDivergence"]) == 0b10100
    assert kern.invariant_mask([]) == 0
    with pytest.raises(KeyError):
        kern.invariant_mask(["NoSuchInvariant"])


def test_successors_halted_writes_nothing():
    _c, kern = make_model(load_binding(DEFECT, "VSR"), max_msgs=8)
    row = kern.pk.flatten({k: torch.as_tensor(v)[None] for k, v in
                           kern.codec.init_dense().items()})
    one = torch.zeros((1,), dtype=torch.int32)
    out = kern.successor_buffers(1, "cpu")
    out["succ"].fill_(7)
    kern.successors(row, one, one, one, 1, out,
                    halt=torch.ones((1,), dtype=torch.int64))
    assert (out["succ"] == 7).all() and not out["en2"].any()
    kern.successors(row, one, one, one, 1, out,
                    halt=torch.zeros((1,), dtype=torch.int64))
    assert not (out["succ"] == 7).all()
