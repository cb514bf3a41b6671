"""Parity of the port's VR_ASSUME_NEWVIEWCHANGE (A01) model with the JAX
package's on the CPU, and the machinery the family's other parity files
(tests/test_torch_i01.py, tests/test_torch_as04.py) share.

For each model (``FAMILY``) and case (cfg, NoProgressChangeLimit,
MAX_MSGS), the same numpy-seeded rows go through the JAX kernel and the
port's plain versions (``device="cpu"``), bit for bit (tolerance 0):

* the codec's layout, pack digest and round trip;
* the guard matrix (K13's plain version) against the JAX engine's
  ``_guard_matrix``;
* the successor of every lane of every action, enabled or not, with its
  enabled bit, error flags, touch list, lane replica and the AND of all
  of ``INVARIANT_FNS`` (K14's plain version against the JAX ``act_*``
  from ``seed_touch``, ``lane_replica`` and ``invariant_fn``);
* each invariant alone and ``hunt_score``, on the rows and on every
  enabled successor;
* the full, parts and incremental fingerprints (K3's plain versions);
* the host tables K13 and K14 read against the enums of their CUDA
  sources, and the C signatures against ``kernels._ENTRY``;
* the levels of ``DeviceBFS.run()`` and ``run_fused()`` against a
  host-driven level BFS over the JAX kernel from the same Init: the
  small cfg to depth 8, the shipped constants to depth 5.

Rows: Init (``init_dense``), rows met on numpy-seeded random walks of
the JAX kernel from it (half the walkers guided so that a replica lags
behind a view change), and hand-built rows per model.  A01's: a row
whose logs hold packed entries (``value_id << 8 | view``) of an
acknowledged value, on which ST03's undecoded ``_replica_has_op`` finds
no op (so ST03's AcknowledgedWriteNotLost fails) and A01's finds it."""

import functools
import os
import re
import sys
from types import SimpleNamespace

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402

from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_st03 import (  # noqa: E402
    CHUNK, GUIDE, PAD, _batch, _enum, _fps, _full_bag_row, _is_era,
    _jax_outputs, _port_outputs, _run, _signature, _walk_rows, jax_fns_of)
from tests.test_torch_st03_bfs import level_bfs  # noqa: E402
from tpuvsr.analysis.passes.widths import derive_ranges_from as j_ranges
from tpuvsr.engine.pack import build_pack_spec as j_pack_spec
from tpuvsr.frontend.cfg import parse_cfg_file as j_cfg
from tpuvsr.models.a01 import A01Codec as JA01Codec
from tpuvsr.models.a01_kernel import A01Kernel as JA01Kernel
from tpuvsr.models.as04 import AS04Codec as JAS04Codec
from tpuvsr.models.as04_kernel import AS04Kernel as JAS04Kernel
from tpuvsr.models.cp06 import CP06Codec as JCP06Codec
from tpuvsr.models.cp06_kernel import CP06Kernel as JCP06Kernel
from tpuvsr.models.i01 import I01Codec as JI01Codec
from tpuvsr.models.i01_kernel import I01Kernel as JI01Kernel
from tpuvsr.models.al05 import AL05Codec as JAL05Codec
from tpuvsr.models.al05_kernel import AL05Kernel as JAL05Kernel
from tpuvsr.models.rr05 import RR05Codec as JRR05Codec
from tpuvsr.models.rr05_kernel import RR05Kernel as JRR05Kernel
from tpuvsr_torch import kernels
from tpuvsr_torch.analysis.widths import NONCE_UNBOUNDED, derive_ranges_from
from tpuvsr_torch.engine.device_bfs import DeviceBFS
from tpuvsr_torch.engine.spec import load_binding
from tpuvsr_torch.models import st03_kernel as psk
from tpuvsr_torch.models.registry import make_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "tpuvsr_torch", "configs")
CSRC = os.path.join(ROOT, "tpuvsr_torch", "csrc")
FIELDS = ("succ", "en2", "err", "ts", "tn", "ri", "iok")


def _cfgs(module, wide="shipped"):
    return (os.path.join(CONFIGS, f"{module}_small.cfg"),
            os.path.join(CONFIGS, f"{module}_{wide}.cfg"))


def _model(key, module, jcodec, jkernel, small_levels, shipped_levels,
           wide="shipped", small_depth=8, wide_depth=5, seeds=(31, 32, 34),
           guide=None):
    """A model of the family; ``wide`` names its cfg with wider constants
    (``_shipped.cfg``, or ``_wide.cfg`` where the reference ships none)
    and the case that runs it; ``seeds`` are the cases' walk seeds and
    ``guide`` the guided walkers' action weights (the st03 tests'
    ``GUIDE`` when None)."""
    small, shipped = _cfgs(module, wide)
    return SimpleNamespace(
        key=key, module=module, jcodec=jcodec, jkernel=jkernel,
        small=small, shipped=shipped, wide=wide, guide=guide,
        # name -> (cfg, NoProgressChangeLimit, MAX_MSGS, walk seed)
        cases={"small": (small, 0, 32, seeds[0]),
               "small_np1": (small, 1, 16, seeds[1]),
               wide: (shipped, 0, 32, seeds[2])},
        # (cfg, depth, the JAX-kernel host BFS's levels): the small cfg's
        # are the first levels of its fixpoint (scripts/fixpoints.json,
        # scripts/recovery_fixpoints.json)
        bfs={"small": ("small", small_depth, small_levels),
             wide: (wide, wide_depth, shipped_levels)},
        # the cases of the records chip_smoke.py holds the card to (run
        # this file as a script)
        records={"small": (small, 0, 32, 0), wide: (shipped, 0, 48, 0)})


# the CP06 walkers' weights: ST03's, with Crash rare and the recovery
# exchange and ReceiveHigherDVC favoured
CP06_GUIDE = dict(GUIDE, Crash=0.02, ReceiveHigherDVC=50.0,
                  ReceiveGetCheckpointMsg=5.0, ReceiveNewCheckpointMsg=20.0,
                  ReceiveRecoveryMsg=20.0, ReceiveRecoveryResponseMsg=20.0,
                  CompleteRecovery=50.0)
FAMILY = {
    "A01": _model("A01", "VR_ASSUME_NEWVIEWCHANGE", JA01Codec, JA01Kernel,
                  [1, 3, 8, 24, 68, 163, 332, 595, 968],
                  [1, 4, 16, 56, 198, 667]),
    "I01": _model("I01", "VR_INC_RESEND", JI01Codec, JI01Kernel,
                  [1, 3, 8, 24, 68, 163, 332, 595, 968],
                  [1, 4, 15, 47, 143, 401]),
    "AS04": _model("AS04", "VR_APP_STATE", JAS04Codec, JAS04Kernel,
                   [1, 3, 8, 24, 68, 162, 331, 593, 965],
                   [1, 4, 17, 63, 238, 850]),
    # the crash-recovery models (CrashLimit 1): the small cfg's levels
    # are the first of scripts/recovery_fixpoints.json's AL05 fixpoint
    # and of scripts/recovery_fixpoints.log's RR05 run
    "RR05": _model("RR05", "VR_REPLICA_RECOVERY", JRR05Codec, JRR05Kernel,
                   [1, 6, 23, 77, 227, 593, 1364],
                   [1, 7, 35, 151, 595], wide="wide", small_depth=6,
                   wide_depth=4, seeds=(31, 35, 34)),
    "AL05": _model("AL05", "VR_REPLICA_RECOVERY_ASYNC_LOG", JAL05Codec,
                   JAL05Kernel, [1, 6, 24, 85, 261, 702, 1665],
                   [1, 7, 37, 171, 697], wide="wide", small_depth=6,
                   wide_depth=4, seeds=(31, 35, 35)),
    # the checkpointing model: the small cfg's levels are the first of
    # scripts/recovery_fixpoints.json's CP06 fixpoint; its walkers crash
    # seldom (Crash has R x (MAX_OPS + 1) lanes, and a Recovering replica
    # blocks the view change the other actions need)
    "CP06": _model("CP06", "VR_REPLICA_RECOVERY_CP", JCP06Codec,
                   JCP06Kernel, [1, 6, 23, 68, 181, 426, 879, 1605],
                   [1, 7, 35, 140, 510], wide="wide", small_depth=7,
                   wide_depth=4,
                   seeds=(33, 33, 32), guide=CP06_GUIDE),
}
KEY = "A01"


def binding(model, path, np_limit):
    b = load_binding(path, model.module)
    b.cfg.constants["NoProgressChangeLimit"] = np_limit
    return b


def jax_codec(model, path, np_limit, max_msgs):
    cfg = j_cfg(path)
    cfg.constants["NoProgressChangeLimit"] = np_limit
    return model.jcodec(cfg.constants, max_msgs=max_msgs)


@functools.lru_cache(maxsize=None)
def jax_fns(key, name):
    """(JAX kernel, all-lanes step, fingerprint, guard matrix, every
    invariant and hunt_score, parent parts) of a model's case, each
    jitted once and shared across the file."""
    model = FAMILY[key]
    path, np_limit, mm, _seed = model.cases.get(name) or model.records[
        name.split(":")[1]]
    return jax_fns_of(model.jkernel(jax_codec(model, path, np_limit, mm)))


def choose_rows(names, lane_action, walked, ens, seed, n=40, n_era=12):
    """Init's walk rows: one row enabling each action that is enabled on
    some walked row, more up to ``n``, up to ``n_era`` rows of the
    state-transfer era."""
    rng = np.random.default_rng(seed)
    chosen = set()
    for a in range(len(names)):
        hit = [i for i, e in enumerate(ens) if e[lane_action == a].any()]
        if hit:
            chosen.add(int(rng.choice(hit)))
    rest = [i for i in range(len(walked)) if i not in chosen]
    era = [i for i in rest if _is_era(walked[i])]
    plain = [i for i in rest if not _is_era(walked[i])]
    pick = lambda idx, k: list(rng.choice(idx, size=min(k, len(idx)),
                                          replace=False)) if idx else []
    chosen |= set(pick(plain, n - len(chosen))) | set(pick(era, n_era))
    return [walked[i] for i in sorted(chosen)]


@functools.lru_cache(maxsize=None)
def family_case(key, name, extra=None):
    """A model's case: its rows (Init, walked rows, the full-bag row in
    the small case, and the rows ``extra(case)`` builds), with both
    packages' outputs on every lane of every action."""
    model = FAMILY[key]
    path, np_limit, mm, seed = model.cases[name]
    J = jax_fns(key, name)
    jk, f = J.jk, J.step
    _c, kern = make_model(binding(model, path, np_limit), max_msgs=mm)
    init = kern.codec.init_dense()
    walked, ens = _walk_rows(jk, f, init, seed, guide=model.guide)
    rows = [init] + choose_rows(jk.action_names, jk.lane_action, walked,
                                ens, seed)
    case = SimpleNamespace(key=key, name=name, model=model, J=J, jk=jk,
                           kern=kern, walked=walked, info={})
    case.info["era"] = sum(_is_era(r) for r in rows)
    if name == "small":
        rows.append(_full_bag_row(init, mm, kern.codec.anydest is not None))
        case.info["full"] = len(rows) - 1
    if extra is not None:
        built = extra(case, rows)
        case.info["built"] = list(range(len(rows), len(rows) + len(built)))
        rows = rows + built
    case.rows = rows
    case.batch = _batch(rows)
    case.flat = kern.pk.flatten({k: torch.as_tensor(v)
                                 for k, v in case.batch.items()}
                                ).contiguous()
    case.want, case.jsucc = _jax_outputs(kern.pk, f, case.batch)
    case.got = _port_outputs(kern, case.flat)
    return case


# ----------------------------------------------------------------------
# the checks each family file runs on its cases
# ----------------------------------------------------------------------
def check_codec_layout(key, name):
    model = FAMILY[key]
    path, np_limit, mm, _seed = model.cases[name]
    jc = jax_codec(model, path, np_limit, mm)
    codec, kern = make_model(binding(model, path, np_limit), max_msgs=mm)
    assert type(codec).__name__ == type(jc).__name__
    jz, pz = jc.zero_state(), codec.zero_state()
    assert list(jz) == list(pz)
    for k in jz:
        assert jz[k].shape == pz[k].shape and jz[k].dtype == pz[k].dtype, k
    constants = kern.codec.constants
    ranges = derive_ranges_from(constants, model.module)
    jranges = j_ranges(jc.constants, model.module)
    if model.module in NONCE_UNBOUNDED:
        # RetryRecovery re-mints the nonce: the port derives no bound
        # where the JAX pass does (1 + CrashLimit), and the two pack
        # manifests differ; the codecs agree on the port's ranges
        assert jranges.pop("recovery_nonce") == (
            0, 1 + constants["CrashLimit"])
        assert "recovery_nonce" not in ranges
        assert j_pack_spec(jc, ranges=j_ranges(
            jc.constants, model.module)).version != kern.pk.version
    assert ranges == jranges
    assert codec.plane_bounds(ranges) == jc.plane_bounds(ranges)
    jpk = j_pack_spec(jc, ranges=ranges)
    assert kern.pk.version == jpk.version
    assert kern.pk.words == jpk.words
    init = codec.init_dense()
    assert (init["view"] == 1).all()
    assert all(not v.any() for k, v in init.items() if k != "view")
    # the kernel's rows, lanes and key draws are the JAX kernel's
    jk = model.jkernel(jc)
    assert kern.action_names == jk.action_names
    assert np.array_equal(kern.lane_action, jk.lane_action)
    assert np.array_equal(kern.lane_param, jk.lane_param)
    assert kern.REP_KEYS == jk.REP_KEYS
    assert list(kern.INVARIANT_FNS) == list(jk.INVARIANT_FNS)
    for a, b in ((kern._k_rep, jk._k_rep), (kern._k_msg, jk._k_msg),
                 (kern._k_glob, jk._k_glob), (kern._seeds, jk._seeds)):
        assert np.array_equal(a, np.asarray(b))


def check_round_trip(case):
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


def check_pack_round_trip(case):
    pk = case.kern.pk
    assert torch.equal(pk.unpack(pk.pack(case.flat)), case.flat)


def check_covers(case, off):
    """The actions no row of the case enables are exactly ``off``."""
    en = case.got["en2"]
    per = {n: bool(en[:, case.kern.lane_action == a].any())
           for a, n in enumerate(case.kern.action_names)}
    assert [n for n, hit in per.items() if not hit] == off


def check_guard_matrix(case):
    want = _run(case.J.guards, case.batch)
    en, en_any = case.kern.guard_matrix(case.flat)
    assert en.shape == (case.flat.shape[0], case.kern.n_lanes)
    assert np.array_equal(en.numpy(), want)
    assert np.array_equal(en_any.numpy(), want.any(axis=1))
    # the guards are the actions' enabled bits
    assert np.array_equal(en.numpy(), case.got["en2"])


def check_successors(case, action):
    a = case.kern.action_names.index(action)
    cols = np.nonzero(case.kern.lane_action == a)[0]
    assert len(cols)
    for k in FIELDS:
        g = case.got[k][:, cols]
        w = case.want[k][:, cols].astype(g.dtype)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        assert np.array_equal(g, w), (case.key, case.name, action, k)


def check_invariants(case):
    """Each invariant alone, and hunt_score, on the rows and on every
    enabled successor; the cfg's conjunction on the rows."""
    kern = case.kern
    en = case.want["en2"]
    succ = {k: v[en] for k, v in case.jsucc.items()}
    for batch, size in ((case.batch, PAD), (succ, CHUNK)):
        want = _run(case.J.invs, batch, size)
        st = {k: torch.as_tensor(v) for k, v in batch.items()}
        for w, (n, f) in zip(want, kern.invariant_fns(
                list(kern.INVARIANT_FNS))):
            assert np.array_equal(w, f(st).numpy()), n
        assert np.array_equal(want[-1], kern.hunt_score(st).numpy())
    names = binding(case.model, case.model.small, 0).invariants
    st = {k: torch.as_tensor(v) for k, v in case.batch.items()}
    want = np.logical_and.reduce([f(st).numpy() for _n, f in
                                  kern.invariant_fns(names)])
    assert np.array_equal(kern.invariant_fn(names)(st).numpy(), want)


def check_fingerprints(case):
    kern = case.kern
    assert np.array_equal(_fps(case.J, case.batch),
                          kern.fingerprint(case.flat).numpy().view(np.uint32))
    en = case.want["en2"]
    succ = {k: v[en] for k, v in case.jsucc.items()}
    got = kern.fingerprint(torch.as_tensor(case.want["succ"][en]))
    assert np.array_equal(_fps(case.J, succ), got.numpy().view(np.uint32))


def check_parent_parts(case):
    jr, js, jt = _run(case.J.parts, case.batch)
    pr, ps, pt = case.kern.parent_parts(case.flat)
    assert np.array_equal(jr[:, 0], pr.numpy().view(np.uint32))
    assert np.array_equal(js[:, 0], ps.numpy().view(np.uint32))
    assert np.array_equal(jt[:, 0], pt.numpy().view(np.uint32))


def check_incremental(case):
    """The incremental fingerprint of every (row, lane) item from its
    parent's parts equals the JAX kernel's incremental one, and on the
    enabled items without an error the full fingerprint."""
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
    en = case.want["en2"].reshape(-1) & (case.want["err"].reshape(-1) == 0)
    full = kern.fingerprint(flat_succ[torch.as_tensor(en)])
    assert np.array_equal(got[en], full.numpy().view(np.uint32))


def check_counterexample(key, steps):
    """A counterexample's (action, lane) steps from Init through the
    port's plain K14 and the JAX kernel: every step enabled and the same
    state in both, and on the last one NoLogDivergence,
    NoAppStateDivergence and CommitNumberNeverHigherThanOpNumber fail
    in both packages."""
    case = family_case(key, "small")
    kern, J = case.kern, case.J
    jk = J.jk
    row = kern.codec.init_dense()
    one = torch.zeros((1,), dtype=torch.int32)
    for name, lane in steps:
        a = kern.action_names.index(name)
        flat = kern.pk.flatten({k: torch.as_tensor(v)[None]
                                for k, v in row.items()})
        o = kern.successors_plain(flat, one, one + a, one + lane, 0)
        assert bool(o["en2"][0]), name
        clean, en = _run(J.step, _batch([row]))[:2]
        col = int(np.nonzero((jk.lane_action == a)
                             & (jk.lane_param == lane))[0][0])
        assert bool(en[0, col]), name
        nxt = {k: v[0, col] for k, v in clean.items()}
        got = kern.pk.unflatten(o["succ"])
        for k in nxt:
            assert np.array_equal(got[k][0].numpy(), nxt[k]), (name, k)
        row = nxt
    st = {k: torch.as_tensor(v)[None] for k, v in row.items()}
    want = _run(J.invs, {k: v[None] for k, v in row.items()})
    names = list(kern.INVARIANT_FNS)
    for inv in ("NoLogDivergence", "NoAppStateDivergence",
                "CommitNumberNeverHigherThanOpNumber"):
        assert not bool(getattr(kern, kern.INVARIANT_FNS[inv])(st)[0])
        assert not bool(want[names.index(inv)][0])


def _snake(camel):
    return re.sub(r"(?<=[a-z])(?=[A-Z])", "_", camel).upper()


def check_tables(key):
    """The model's K13 and K14 tables against the family enums of
    csrc/st03_guards.cu and csrc/st03_actions.cu, its KERNELS names and
    the C signatures of its entry points."""
    model = FAMILY[key]
    _c, kern = make_model(binding(model, model.small, 0), max_msgs=16)
    start = {k: a for k, _s, a, _e in kern.pk._splits}
    act = open(os.path.join(CSRC, "st03_actions.cu")).read()
    assert _enum(act, "FamilyPlane") == [
        "P_" + k.upper() for k in psk.FAMILY_PLANES] + ["N_FAMILY_PLANES"]
    assert kern.PLANE_KEYS == psk.ALL_KEYS + psk.FAMILY_PLANES
    assert kern.action_tables("cpu").tolist() == [
        start.get(k, -1) for k in kern.PLANE_KEYS]
    # every plane of the model's layout has an offset
    assert set(start) <= set(kern.PLANE_KEYS)
    assert _enum(act, "FamilyAction") == [
        "A_" + _snake(n).replace("_MSG", "")
        for n in psk.FAMILY_ACTIONS[len(psk.ACTION_NAMES):]] \
        + ["N_FAMILY_ACTIONS"]
    ids = kern.family_action_ids()
    fam = _enum(act, "Action")[:-1] + _enum(act, "FamilyAction")[:-1]
    for name, fid in zip(kern.action_names, ids):
        want = psk.ACTION_ALIASES.get(name, name)
        assert fam[fid] == "A_" + _snake(want).replace(
            "_MSG", ""), (name, fam[fid])
    assert kern.action_map("cpu").tolist() == ids.tolist()
    inv = _enum(act, "Invariant")[:-1] + _enum(act, "FamilyInvariant")[:-1]
    assert inv == ["I_" + _snake(n) for n in psk.FAMILY_INVARIANTS]
    all_bits = (1 << len(kern.INVARIANT_FNS)) - 1
    assert kern.family_mask(all_bits) == sum(
        1 << psk.FAMILY_INVARIANTS.index(n) for n in kern.INVARIANT_FNS)
    grd = open(os.path.join(CSRC, "st03_guards.cu")).read()
    assert _enum(grd, "FamilyPlane") == [
        "P_" + k.upper() for k in psk.FAMILY_GUARD_PLANES] \
        + ["N_FAMILY_PLANES"]
    t = kern.guard_tables("cpu")
    assert t["planes"].tolist() == [start.get(k, -1)
                                    for k in kern.GUARD_KEYS]
    assert np.array_equal(t["lane_action"].numpy(), ids[kern.lane_action])
    assert np.array_equal(t["lane_param"].numpy(), kern.lane_param)
    low = key.lower()
    for src, (name, entry), stem in (
            (grd, kern.GUARDS_KERNEL, "st03_guards"),
            (act, kern.ACTIONS_KERNEL, "st03_actions")):
        assert (name, entry) == (f"{low}_{stem[5:]}",
                                 f"tpuvsr_{low}_{stem[5:]}")
        assert kernels.KERNELS[name][0] == stem
        assert _signature(src, entry) == kernels._ENTRY[entry]
        assert _signature(src, entry) == _signature(
            src, f"tpuvsr_{stem}")
    for part, name in kern.FP_KERNELS.items():
        assert name == f"{low}_fp_{part}"
        assert kernels.KERNELS[name][0] == "vsr_fingerprint"
    assert kern.nglob == kern.R + 1 and kern.nrep == kern._rep_cols.shape[1]


def check_plain_calls(key):
    """Every call of the model's plain guard and action functions counts
    in st03_kernel.PLAIN_CALLS (the doors chip_smoke.py reads)."""
    model = FAMILY[key]
    _c, kern = make_model(binding(model, model.small, 0), max_msgs=8)
    flat = kern.pk.flatten({k: torch.as_tensor(v)[None] for k, v in
                            kern.codec.init_dense().items()})
    g0, a0 = psk.PLAIN_CALLS["guards"], psk.PLAIN_CALLS["actions"]
    kern.guard_matrix(flat)
    one = torch.zeros((1,), dtype=torch.int32)
    kern.successors(flat, one, one, one, 0)
    assert psk.PLAIN_CALLS == {"guards": g0 + 1, "actions": a0 + 1}


# ----------------------------------------------------------------------
# the BFS levels against a JAX-kernel host BFS
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _cached_level_bfs(key, name, depth):
    return level_bfs(jax_fns(key, name), depth)


def jax_level_bfs(key, name, depth, on_level=None):
    """The JAX-kernel host BFS's levels of a model's case (cached when
    no ``on_level`` probe is given)."""
    if on_level is None:
        return _cached_level_bfs(key, name, depth)
    return level_bfs(jax_fns(key, name), depth, on_level)


def engine(model, path, **kw):
    return DeviceBFS(load_binding(path, model.module), tile_size=64,
                     chunk_tiles=8, fpset_capacity=1 << 14,
                     next_capacity=1 << 10, device="cpu", **kw)


def check_bfs(key, name, entry):
    model = FAMILY[key]
    case, depth, levels = model.bfs[name]
    assert jax_level_bfs(key, case, depth) == levels
    eng = engine(model, model.cases[case][0])
    res = getattr(eng, entry)(max_depth=depth)
    assert res.ok and res.levels == levels
    assert res.distinct_states == sum(levels)
    assert res.error == f"depth limit {depth} reached"
    assert type(eng.kern).__name__ == model.jkernel.__name__


def check_bag_growth(key, entry):
    """From MAX_MSGS 4 the small cfg grows its bag (the packed buffers
    re-laid and the kernel rebuilt with its K13/K14/K3 tables); the
    levels are the record's."""
    model = FAMILY[key]
    eng = engine(model, model.small, max_msgs=4)
    res = getattr(eng, entry)(max_depth=6)
    assert res.metrics["counters"]["grow_message_table"] >= 1
    assert eng.kern.M == eng.codec.shape.MAX_MSGS > 4
    assert res.levels == model.bfs["small"][2][:7]


# ----------------------------------------------------------------------
# A01
# ----------------------------------------------------------------------
def _packed_acked_row(case, rows):
    """Init with the acknowledged value v1 committed on two replicas as
    the packed entry ``1 << 8 | 1`` (view 1): A01's invariants find the
    op; ST03's undecoded ``_replica_has_op`` (log == value id) does not,
    so ST03's AcknowledgedWriteNotLost fails on it."""
    row = {k: np.array(v) for k, v in rows[0].items()}
    row["log"][:2, 0] = (1 << 8) | 1
    row["op"][:2] = 1
    row["commit"][:2] = 1
    row["aux_acked"][0] = 2
    return [row]


def _a01_extra(case, rows):
    return _packed_acked_row(case, rows)


@pytest.fixture(scope="module", params=["small", "small_np1", "shipped"])
def case(request):
    return family_case(KEY, request.param,
                       _a01_extra if request.param == "small" else None)


@pytest.mark.parametrize("name", list(FAMILY[KEY].cases))
def test_codec_layout_matches_jax(name):
    check_codec_layout(KEY, name)


def test_codec_round_trip_matches_jax(case):
    check_round_trip(case)


def test_pack_round_trip(case):
    check_pack_round_trip(case)


def test_inputs_cover_the_actions(case):
    check_covers(case, [] if case.name == "small_np1"
                 else ["NoProgressChange"])


def test_guard_matrix_matches_jax(case):
    check_guard_matrix(case)


@pytest.mark.parametrize("action", JA01Kernel.action_names)
def test_successors_plain_matches_jax(case, action):
    check_successors(case, action)


def test_invariants_match_jax(case):
    check_invariants(case)


def test_fingerprints_match_jax(case):
    check_fingerprints(case)


def test_parent_parts_match_jax(case):
    check_parent_parts(case)


def test_incremental_fingerprints_match_jax(case):
    check_incremental(case)


def test_packed_entries_decode_in_the_invariants():
    """On the packed-entry row the A01 invariants hold while ST03's,
    which compare a log entry with a value id, report a lost write; both
    packages agree on the A01 verdict and on hunt_score."""
    case = family_case(KEY, "small", _a01_extra)
    kern = case.kern
    b = case.info["built"][0]
    st = {k: torch.as_tensor(v[b:b + 1]) for k, v in case.batch.items()}
    assert (st["aux_acked"] == 2).any()
    assert bool(kern.inv_acknowledged_write_not_lost(st)[0])
    assert bool(kern.inv_acknowledged_writes_exist_on_majority(st)[0])
    # ST03's check, value ids against the packed codes: no op found
    has = psk.ST03Kernel._replica_has_op(kern, st).any(dim=1)
    assert not bool((~(st["aux_acked"] == 2) | has).all(dim=1)[0])
    assert int(kern.hunt_score(st)[0]) == 2
    want = _run(case.J.invs, {k: v[b:b + 1] for k, v in
                              case.batch.items()})
    names = list(kern.INVARIANT_FNS)
    assert bool(want[names.index("AcknowledgedWriteNotLost")][0])
    assert int(want[-1][0]) == 2


def test_tables_match_the_kernel_source():
    check_tables(KEY)


def test_plain_calls_are_counted():
    check_plain_calls(KEY)


@pytest.mark.parametrize("key", list(FAMILY))
def test_plane_table_refuses_a_key_not_in_the_layout(key):
    """Only a family plane the model lacks gets offset -1; any other key
    missing from the pack spec raises."""
    model = FAMILY[key]
    _c, kern = make_model(binding(model, model.small, 0), max_msgs=8)
    start = {k: a for k, _s, a, _e in kern.pk._splits}
    lacks = [k for k in psk.FAMILY_PLANES if k not in start]
    assert kern._plane_table("lacks", lacks, "cpu").tolist() == \
        [-1] * len(lacks)
    for keys in (["view", "no_such_plane"], ["vieww"]):
        with pytest.raises(KeyError):
            kern._plane_table("typo", keys, "cpu")


@pytest.mark.parametrize("entry", ["run", "run_fused"])
@pytest.mark.parametrize("name", ["small", "shipped"])
def test_bfs_levels_match_jax(name, entry):
    check_bfs(KEY, name, entry)


def test_bag_growth_keeps_levels():
    check_bag_growth(KEY, "run_fused")


if __name__ == "__main__":
    # python tests/test_torch_a01.py {A01|I01|AS04} {small|shipped} DEPTH
    # prints the JAX-kernel host BFS's levels (small: MAX_MSGS 32, to the
    # fixpoint at DEPTH 24; shipped: MAX_MSGS 48), the records
    # chip_smoke.py phase 11 holds the card's runs against
    import time
    t0 = time.time()
    print(jax_level_bfs(sys.argv[1], "record:" + sys.argv[2],
                        int(sys.argv[3])), f"{time.time() - t0:.1f}s",
          flush=True)
