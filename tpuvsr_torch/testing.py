"""The counter stub and the SymPair stub, as torch codecs and kernels.

A port of ``tpuvsr/testing.py:counter_spec``, ``stub_model_factory``,
``stub_fleet``, ``stub_device_engine``, a ``stub_simulator`` beside them,
``stub_trace_records``, ``stub_validator``, ``stub_sym_factory``,
``stub_sym_engine``, ``stub_ticker_factory``, ``canon_csr`` and
``stub_graph_engine``, and the parsed fixtures of the speclint passes
and the ample-set reduction: ``counter_spec`` (with its ``inv_free``,
``dead_action`` and ``nonlinear_guard`` variants), ``sym_pair_spec``,
``ticker_spec`` and the ``POR_STUB_*`` oracles.  ``counter_spec`` parses
the inline counter module with the port's own frontend; the engines take
it or the cfg-only ``counter_binding``.
It implements the kernel contract the device BFS and the walker fleet
consume (``action_names``, ``_lane_count``, ``lane_action``,
``lane_param``, ``_guard_fns``, ``_action_fns``, ``fingerprint``,
``fingerprint_batch``, ``hunt_score``, ``invariant_fns``/
``invariant_fn``, ``invariant_mask``/``state_predicates``, ``pk``) over a
state space of ``STUB_DISTINCT`` = 16 states with level sizes
``STUB_LEVELS`` — small enough that every engine path (growth pauses,
violation, deadlock, trace replay) runs in seconds.  SymPair (two write-once registers over a symmetric set of
three model values, SYMMETRY ``Permutations(Vals)``) has 16 states in 5
orbits; its kernel declares ``SYM_PLANES`` and no ``_permuted``, so it
drives the table action of ``engine/canon.py``.  The Ticker (a
stoppable counter modulo ``modulus`` whose wrap edge leads back to a
level-0 state) is the behaviour-graph fixture of ``PagedBFS(edges=True)``
and ``engine/device_liveness.DeviceGraph``.

``checkpoint_rows`` builds the three dense rows of VR_REPLICA_RECOVERY_CP
(CP06) that exercise its checkpoint forms, which no short walk and no
recording run of its cfgs to a budgeted depth meets: the parity tests
(``tests/test_torch_cp06.py``) and ``chip_smoke.py`` phase 13 hold CP06's
kernels to their plain versions on them.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.values import ModelValue
from .engine.pack import build_pack_spec, to_i32
from .engine.spec import SpecBinding, SpecModel, permutations
from .frontend.cfg import parse_cfg_text
from .frontend.parser import parse_module_text

COUNTER = """---- MODULE ObsCounter ----
EXTENDS Naturals
CONSTANTS Limit
VARIABLES x, y

Init == x = 0 /\\ y = 0

IncX ==
    /\\ x < Limit
    /\\ x' = x + 1
    /\\ UNCHANGED y

IncY ==
    /\\ y < Limit
    /\\ y' = y + 1
    /\\ UNCHANGED x

Next == IncX \\/ IncY

Bound == x + y <= 2 * Limit
====
"""
COUNTER_CFG = ("CONSTANTS\n    Limit = 3\n"
               "INIT Init\nNEXT Next\nINVARIANT Bound\n")

#: the counter spec's exact fixpoint
STUB_DISTINCT = 16
STUB_LEVELS = [1, 2, 3, 4, 3, 2, 1]

#: the ``inv_free`` fixture's fixpoint under the ample-set partial-order
#: reduction: IncX and IncY are independent and invisible, so every
#: state expands one action, the (Limit, Limit) deadlock survives, and
#: generated kept / generated full is 6 / 9
POR_STUB_DISTINCT = 7
POR_STUB_LEVELS = [1, 1, 1, 1, 1, 1, 1]
POR_STUB_KEPT = 6
POR_STUB_FULL = 9

#: the dead-action fixture: ``Limit > 5`` folds FALSE under Limit = 3,
#: so Jump never fires; the bounds pass proves it dead
DEAD_ACTION = """Jump ==
    /\\ Limit > 5
    /\\ x' = x + 2
    /\\ UNCHANGED y

"""


class _Shape:
    MAX_MSGS = 4


class StubCodec:
    MSG_KEYS = ()

    def __init__(self, limit=3):
        self.shape = _Shape()
        self.limit = limit

    def zero_state(self):
        z = np.zeros((), np.int32)
        return {"status": z, "x": z.copy(), "y": z.copy(), "err": z.copy()}

    def plane_bounds(self, ranges):
        return {"status": (0, 1), "x": (0, self.limit + 1),
                "y": (0, self.limit + 1), "err": (0, 1)}

    def init_dense(self):
        return self.zero_state()

    def decode(self, d):
        return {"x": int(np.asarray(d["x"])), "y": int(np.asarray(d["y"]))}

    def encode(self, st):
        return {"status": np.int32(0), "x": np.int32(st["x"]),
                "y": np.int32(st["y"]), "err": np.int32(0)}

    def pad_msgs(self, batch, old):
        return batch


class _OnePredicate:
    """The K18 contract of the stubs (``invariant_mask``,
    ``state_predicates``), plain on every device: a stub has no hand
    kernels, and every invariant name checks its one predicate
    (``invariant_fns``), so every name's bit is bit 0."""

    def invariant_mask(self, names):
        return 1 if names else 0

    def state_predicates(self, flat, mask):
        st = self.pk.unflatten(flat)
        ok = self.invariant_fns(["_"])[0][1](st)
        return (ok.to(torch.int32) * (int(mask) & 1)).to(torch.int32)


class StubKern(_OnePredicate):
    action_names = ("IncX", "IncY")
    n_lanes = 2
    lane_action = np.array([0, 1], np.int32)
    lane_param = np.array([0, 0], np.int32)

    def __init__(self, codec, limit=3, inv_bound=None, inv_x_bound=None,
                 dead_action=False):
        self.limit = limit
        self.inv_bound = inv_bound
        self.inv_x_bound = inv_x_bound
        self.dead_action = dead_action
        if dead_action:
            # the never-enabled Jump lane of the JAX stub's dead-action
            # fixture
            self.action_names = ("IncX", "IncY", "Jump")
            self.n_lanes = 3
            self.lane_action = np.array([0, 1, 2], np.int32)
            self.lane_param = np.array([0, 0, 0], np.int32)
        self.pk = build_pack_spec(codec)

    def _lane_count(self, name):
        return 1

    def _guard_fns(self):
        lim = self.limit
        fns = [lambda st: (st["x"] < lim)[:, None],
               lambda st: (st["y"] < lim)[:, None]]
        if self.dead_action:
            fns.append(lambda st: torch.zeros_like(st["x"],
                                                   dtype=torch.bool)[:, None])
        return fns

    def _action_fns(self):
        lim = self.limit

        def incx(st, lane):
            return ({"status": st["status"], "x": st["x"] + 1,
                     "y": st["y"], "err": torch.zeros_like(st["err"])},
                    st["x"] < lim)

        def incy(st, lane):
            return ({"status": st["status"], "x": st["x"],
                     "y": st["y"] + 1, "err": torch.zeros_like(st["err"])},
                    st["y"] < lim)

        def jump(st, lane):
            return ({"status": st["status"], "x": st["x"] + 2,
                     "y": st["y"], "err": torch.zeros_like(st["err"])},
                    torch.zeros_like(st["x"], dtype=torch.bool))
        return [incx, incy, jump] if self.dead_action else [incx, incy]

    def fingerprint(self, flat):
        st = self.pk.unflatten(flat)
        x = st["x"].to(torch.int64)
        y = st["y"].to(torch.int64)
        return to_i32(torch.stack([(x * 7 + y + 1), x + 1, y + 1,
                                   torch.full_like(x, 99)], dim=1)
                      & 0xFFFFFFFF)

    def fingerprint_batch(self, batch):
        return self.fingerprint(self.pk.flatten(batch).contiguous())

    def hunt_score(self, st):
        """Deeper x = closer to the ``inv_x_bound`` violation."""
        return st["x"].to(torch.float32)

    def invariant_fns(self, names):
        if self.inv_x_bound is not None:
            b = self.inv_x_bound
            f = lambda st: st["x"] <= b
        elif self.inv_bound is None:
            f = lambda st: torch.ones_like(st["x"], dtype=torch.bool)
        else:
            b = self.inv_bound
            f = lambda st: st["x"] + st["y"] <= b
        return [(n, f) for n in names]

    def invariant_fn(self, names):
        fns = self.invariant_fns(names)

        def check(st):
            ok = torch.ones_like(st["x"], dtype=torch.bool)
            for _n, f in fns:
                ok = ok & f(st)
            return ok
        return check


def counter_spec(inv_bound=None, inv_x_bound=None, dead_action=False,
                 nonlinear_guard=False, limit=None, inv_free=False):
    """The inline two-counter spec (16 states, diameter 6), parsed by the
    port's frontend (``tpuvsr/testing.py:78-129``).  ``inv_bound``
    tightens Bound to ``x + y <= inv_bound``, ``inv_x_bound`` to ``x <=
    inv_x_bound`` (pair each with ``stub_model_factory``'s); ``limit``
    overrides the cfg's Limit.  ``dead_action`` adds Jump, whose guard
    folds FALSE under the cfg (pair with
    ``stub_model_factory(dead_action=True)``); ``nonlinear_guard`` makes
    IncX's guard ``x * x < Limit``, outside the bounds pass's interval
    domain (tightening refused); ``inv_free`` replaces Bound with
    ``Limit >= 0``, which reads neither counter, so IncX and IncY are
    independent and invisible: the ample-set reduction's fixture."""
    src = COUNTER
    if inv_free:
        src = src.replace("Bound == x + y <= 2 * Limit",
                          "Bound == Limit >= 0")
    if inv_x_bound is not None:
        src = src.replace("Bound == x + y <= 2 * Limit",
                          f"Bound == x <= {int(inv_x_bound)}")
    elif inv_bound is not None:
        src = src.replace("Bound == x + y <= 2 * Limit",
                          f"Bound == x + y <= {int(inv_bound)}")
    if nonlinear_guard:
        src = src.replace("/\\ x < Limit", "/\\ x * x < Limit")
    if dead_action:
        src = src.replace("Next == IncX \\/ IncY",
                          DEAD_ACTION + "Next == IncX \\/ IncY \\/ Jump")
    cfg = COUNTER_CFG
    if limit is not None:
        cfg = cfg.replace("Limit = 3", f"Limit = {int(limit)}")
    return SpecModel(parse_module_text(src), parse_cfg_text(cfg))


def counter_binding():
    """The counter spec's binding: Init is x = y = 0."""
    cfg = parse_cfg_text(COUNTER_CFG)
    return SpecBinding(module="ObsCounter", cfg=cfg,
                       init=lambda codec: [codec.init_dense()],
                       invariants=list(cfg.invariants))


def stub_model_factory(limit=3, inv_bound=None, inv_x_bound=None,
                       dead_action=False):
    """A ``model_factory`` producing (codec, kernel) for the counter
    spec; ``inv_bound`` tightens Bound to x + y <= b (a reachable
    violation), ``inv_x_bound`` to x <= b (the unique-witness variant:
    the first violating state is (b + 1, 0)); ``dead_action`` adds the
    never-enabled Jump lane."""
    def make(binding, max_msgs=None):
        codec = StubCodec(limit)
        return codec, StubKern(codec, limit, inv_bound, inv_x_bound,
                               dead_action)
    return make


def stub_device_engine(inv_bound=None, device=None, limit=3, spec=None,
                       dead_action=False, inv_x_bound=None, cls=None,
                       **kw):
    """A small DeviceBFS (or ``cls``, e.g. ``PagedBFS``) over the counter
    stub (the JAX harness's defaults: tile 4, FPSet 2^8 slots, next
    buffer 2^6 rows) and ``spec`` (default the cfg-only
    ``counter_binding``; a parsed ``counter_spec`` gives the engine's
    speclint, bounds and POR something to analyse); keywords such as
    ``commit="per-action"`` or ``por="on"`` reach the engine."""
    from .engine.device_bfs import DeviceBFS
    cls = cls or DeviceBFS
    return cls(spec or counter_binding(),
               model_factory=stub_model_factory(
                   limit=limit, inv_bound=inv_bound,
                   inv_x_bound=inv_x_bound, dead_action=dead_action),
               tile_size=kw.pop("tile_size", 4),
               fpset_capacity=kw.pop("fpset_capacity", 1 << 8),
               next_capacity=kw.pop("next_capacity", 1 << 6),
               device=device, **kw)


def stub_fleet(inv_bound=None, inv_x_bound=None, walkers=64, device=None,
               **kw):
    """A small walker fleet over the counter stub (the counterpart of
    ``tpuvsr/testing.py:stub_fleet``: chunks of 4 steps)."""
    from .sim.fleet import FleetSimulator
    return FleetSimulator(
        counter_binding(), walkers=walkers,
        model_factory=stub_model_factory(inv_bound=inv_bound,
                                         inv_x_bound=inv_x_bound),
        chunk_steps=kw.pop("chunk_steps", 4), device=device, **kw)


def stub_simulator(inv_bound=None, inv_x_bound=None, walkers=16,
                   device=None, dead_action=False, **kw):
    """A small ``DeviceSimulator`` over the counter stub (chunks of 4
    steps); keywords such as ``dispatch``, ``guided``,
    ``action_weights`` and ``swarm_sigma`` reach the simulator."""
    from .engine.device_sim import DeviceSimulator
    return DeviceSimulator(
        counter_binding(), walkers=walkers,
        model_factory=stub_model_factory(inv_bound=inv_bound,
                                         inv_x_bound=inv_x_bound,
                                         dead_action=dead_action),
        chunk_steps=kw.pop("chunk_steps", 4), device=device, **kw)


def stub_trace_records(n=8, depth=6, seed=0, spec=None, mutate=None,
                       drop_vars=(), blank_every=None, drop_actions=False):
    """Deterministic TRACE.jsonl records from host random walks of the
    counter spec (``tpuvsr/testing.py:326``: the same walks for the same
    seed).  Each record fully observes a genuine walk (so it must
    validate) unless mutated:

    * ``mutate=(i, s[, delta])`` shifts the first observed variable of
      trace i's event s by ``delta`` (default +7): off every reachable
      transition, so trace i diverges at exactly event s;
    * ``drop_vars`` removes variables from every observation and
      ``blank_every=k`` blanks every k-th event (partial observation);
    * ``drop_actions`` removes the recorded action names.
    """
    import random
    spec = spec or counter_spec()
    rng = random.Random(seed)
    drop = set(drop_vars)
    inits = list(spec.init_states())
    records = []
    for i in range(n):
        st = rng.choice(inits)
        init = {k: str(v) for k, v in sorted(st.items()) if k not in drop}
        events = []
        for s in range(depth):
            succs = list(spec.successors(st))
            if not succs:
                break
            action, st = rng.choice(succs)
            if blank_every and (s + 1) % blank_every == 0:
                events.append({})
                continue
            ev = {"vars": {k: str(v) for k, v in sorted(st.items())
                           if k not in drop}}
            if not drop_actions:
                ev["action"] = action.name
            if not ev["vars"]:
                del ev["vars"]
            events.append(ev)
        records.append({"trace": f"t-{i:04d}", "init": init,
                        "events": events})
    if mutate is not None:
        i, s = mutate[0], mutate[1]
        delta = mutate[2] if len(mutate) > 2 else 7
        ev = records[i]["events"][s]
        var = sorted(ev.get("vars") or {"x": "0"})[0]
        old = int(ev.get("vars", {}).get(var, 0))
        ev.setdefault("vars", {})[var] = str(old + delta)
    return records


def stub_validator(spec=None, batch=64, cand_cap=4, chunk_steps=4,
                   device=None, **kw):
    """A small ``validate.BatchValidator`` over the counter spec and the
    stub kernel (``tpuvsr/testing.py:381``)."""
    from .validate.batch import BatchValidator
    return BatchValidator(spec or counter_spec(), batch=batch,
                          cand_cap=cand_cap, chunk_steps=chunk_steps,
                          model_factory=stub_model_factory(), device=device,
                          **kw)


# ---------------------------------------------------------------------
# SymPair: the symmetric fixture (tpuvsr/testing.py:403-470)
# ---------------------------------------------------------------------
SYMPAIR = """---- MODULE ObsSymPair ----
CONSTANTS Vals
VARIABLES a, b

Init == a = 0 /\\ b = 0

WriteA ==
    /\\ a = 0
    /\\ \\E v \\in Vals : a' = v
    /\\ UNCHANGED b

WriteB ==
    /\\ b = 0
    /\\ \\E v \\in Vals : b' = v
    /\\ UNCHANGED a

Next == WriteA \\/ WriteB

Symm == Permutations(Vals)

NoPair == a = 0 \\/ b = 0

AllOk == TRUE
====
"""
SYMPAIR_CFG = ("CONSTANTS\n    Vals = {v1, v2, v3}\n"
               "INIT Init\nNEXT Next\nSYMMETRY Symm\nINVARIANT {inv}\n")

#: exact fixpoints of SymPair: symmetry off (every orbit member) and on
SYMPAIR_DISTINCT = 16
SYMPAIR_ORBITS = 5
SYMPAIR_LEVELS = [1, 6, 9]
SYMPAIR_ORBIT_LEVELS = [1, 2, 2]


def sympair_binding(inv_pair=False, symmetry=True):
    """SymPair's binding, made directly (the port has no .tla): Init is
    a = b = 0 and ``Symm == Permutations(Vals)``.  ``inv_pair`` checks
    NoPair (a = 0 or b = 0; violated at depth 2) instead of AllOk;
    ``symmetry=False`` drops the SYMMETRY declaration."""
    text = SYMPAIR_CFG.replace("{inv}", "NoPair" if inv_pair else "AllOk")
    if not symmetry:
        text = text.replace("SYMMETRY Symm\n", "")
    cfg = parse_cfg_text(text)
    return SpecBinding(
        module="ObsSymPair", cfg=cfg,
        init=lambda codec: [codec.init_dense()],
        invariants=list(cfg.invariants),
        symmetry_perms=(permutations(cfg.constants["Vals"])
                        if cfg.symmetry else []))


def sym_pair_spec(inv_pair=False, symmetry=True):
    """SymPair parsed by the port's frontend (``tpuvsr/testing.py:438``):
    the same cfg as ``sympair_binding``'s."""
    cfg = SYMPAIR_CFG.replace("{inv}", "NoPair" if inv_pair else "AllOk")
    if not symmetry:
        cfg = cfg.replace("SYMMETRY Symm\n", "")
    return SpecModel(parse_module_text(SYMPAIR), parse_cfg_text(cfg))


class _SymShape:
    MAX_MSGS = 4
    V = 3


class SymCodec:
    """The registers ``a``/``b`` hold value ids (0 = unset)."""
    MSG_KEYS = ()

    def __init__(self, values):
        self.shape = _SymShape()
        self.values = values                   # id - 1 -> ModelValue
        self.value_id = {v: i + 1 for i, v in enumerate(values)}

    def zero_state(self):
        z = np.zeros((), np.int32)
        return {"status": z, "a": z.copy(), "b": z.copy(), "err": z.copy()}

    def plane_bounds(self, ranges):
        V = self.shape.V
        return {"status": (0, 1), "a": (0, V), "b": (0, V), "err": (0, 1)}

    def init_dense(self):
        return self.zero_state()

    def decode(self, d):
        def dec(x):
            i = int(np.asarray(x))
            return self.values[i - 1] if i else 0
        return {"a": dec(d["a"]), "b": dec(d["b"])}

    def encode(self, st):
        def enc(v):
            return self.value_id[v] if isinstance(v, ModelValue) else int(v)
        return {"status": np.int32(0), "a": np.int32(enc(st["a"])),
                "b": np.int32(enc(st["b"])), "err": np.int32(0)}

    def pad_msgs(self, batch, old):
        return batch


class SymKern(_OnePredicate):
    action_names = ("WriteA", "WriteB")
    V = 3
    # both registers hold bare value ids: a permutation remaps every lane
    SYM_PLANES = {"a": "all", "b": "all"}

    def __init__(self, codec, inv_pair=False):
        self.inv_pair = inv_pair
        self.pk = build_pack_spec(codec)

    def _lane_count(self, name):
        return self.V

    def _guard_fns(self):
        V = self.V
        return [lambda st: (st["a"] == 0)[:, None].expand(-1, V),
                lambda st: (st["b"] == 0)[:, None].expand(-1, V)]

    def _action_fns(self):
        def wa(st, lane):
            return ({"status": st["status"], "a": (lane + 1).to(torch.int32),
                     "b": st["b"], "err": torch.zeros_like(st["err"])},
                    st["a"] == 0)

        def wb(st, lane):
            return ({"status": st["status"], "a": st["a"],
                     "b": (lane + 1).to(torch.int32),
                     "err": torch.zeros_like(st["err"])},
                    st["b"] == 0)
        return [wa, wb]

    def fingerprint(self, flat):
        st = self.pk.unflatten(flat)
        a = st["a"].to(torch.int64)
        b = st["b"].to(torch.int64)
        return to_i32(torch.stack([a * 8 + b + 1, a + 1, b + 1,
                                   torch.full_like(a, 77)], dim=1))

    def invariant_fns(self, names):
        if self.inv_pair:
            f = lambda st: (st["a"] == 0) | (st["b"] == 0)
        else:
            f = lambda st: torch.ones_like(st["a"], dtype=torch.bool)
        return [(n, f) for n in names]

    def invariant_fn(self, names):
        fns = self.invariant_fns(names)

        def check(st):
            ok = torch.ones_like(st["a"], dtype=torch.bool)
            for _n, f in fns:
                ok = ok & f(st)
            return ok
        return check


def stub_sym_factory(inv_pair=False):
    """``model_factory`` for SymPair: the value ids follow the names of
    ``Vals``."""
    def make(binding, max_msgs=None):
        values = sorted((v for v in binding.cfg.constants["Vals"]
                         if isinstance(v, ModelValue)),
                        key=lambda v: v.name)
        codec = SymCodec(values)
        return codec, SymKern(codec, inv_pair)
    return make


def stub_sym_engine(symmetry="auto", inv_pair=False, device=None, spec=None,
                    cls=None, **kw):
    """A small DeviceBFS (or ``cls``) over SymPair (the JAX harness's
    defaults: tile 4, FPSet 2^8 slots, next buffer 2^6 rows) and
    ``spec`` (default the cfg-only ``sympair_binding``; ``sym_pair_spec``
    is the parsed one)."""
    from .engine.device_bfs import DeviceBFS
    cls = cls or DeviceBFS
    return cls(spec or sympair_binding(inv_pair=inv_pair),
               model_factory=stub_sym_factory(inv_pair=inv_pair),
               symmetry=symmetry, tile_size=kw.pop("tile_size", 4),
               fpset_capacity=kw.pop("fpset_capacity", 1 << 8),
               next_capacity=kw.pop("next_capacity", 1 << 6),
               device=device, **kw)


# ---------------------------------------------------------------------
# Ticker: the behaviour-graph fixture (tpuvsr/testing.py:590-776)
# ---------------------------------------------------------------------
TICKER = """---- MODULE ObsTicker ----
EXTENDS Naturals
VARIABLES x, stopped

Init ==
    /\\ x = 0
    /\\ stopped = FALSE

Tick ==
    /\\ stopped = FALSE
    /\\ x' = (x + 1) % {mod}
    /\\ UNCHANGED stopped

Stop ==
    /\\ stopped' = TRUE
    /\\ UNCHANGED x

Next ==
    \\/ Tick
    \\/ Stop

AtZero == x = 0
Hit == x = 2

Spec == Init /\\ [][Next]_vars
FairSpec == Init /\\ [][Next]_vars /\\ WF_vars(Tick)

AlwaysEventuallyZero == []<>AtZero
EventuallyHit == AtZero ~> Hit

vars == <<x, stopped>>
====
"""


def ticker_spec(spec_name="FairSpec", props=("AlwaysEventuallyZero",),
                modulus=3, stop=True):
    """The Ticker parsed by the port's frontend (``tpuvsr/testing.py:638``):
    ``2 * modulus`` states (``modulus`` with ``stop=False``) and a
    PROPERTY cfg."""
    src = TICKER.replace("{mod}", str(int(modulus)))
    if not stop:
        src = src.replace("    \\/ Stop\n", "")
    cfg = parse_cfg_text(f"SPECIFICATION {spec_name}\nPROPERTY\n"
                         + "\n".join(props) + "\n")
    return SpecModel(parse_module_text(src), cfg)


def ticker_binding(modulus=3, stop=True, spec_name="FairSpec",
                   props=("AlwaysEventuallyZero",)):
    """The Ticker spec's binding, made directly (the port has no .tla):
    Init is x = 0, stopped = FALSE; Tick steps x modulo ``modulus``
    while not stopped, Stop (left out with ``stop=False``) stops it.
    ``2 * modulus`` reachable states (``modulus`` without Stop), and a
    PROPERTY cfg, as in the JAX package's ``ticker_spec``."""
    cfg = parse_cfg_text(f"SPECIFICATION {spec_name}\nPROPERTY\n"
                         + "\n".join(props) + "\n")
    return SpecBinding(module="ObsTicker", cfg=cfg,
                       init=lambda codec: [codec.init_dense()],
                       invariants=list(cfg.invariants))


class TickCodec:
    MSG_KEYS = ()

    def __init__(self, modulus):
        self.shape = _Shape()
        self.modulus = modulus

    def zero_state(self):
        z = np.zeros((), np.int32)
        return {"status": z, "x": z.copy(), "stopped": z.copy(),
                "err": z.copy()}

    def plane_bounds(self, ranges):
        return {"status": (0, 1), "x": (0, self.modulus - 1),
                "stopped": (0, 1), "err": (0, 1)}

    def init_dense(self):
        return self.zero_state()

    def decode(self, d):
        return {"x": int(np.asarray(d["x"])),
                "stopped": bool(int(np.asarray(d["stopped"])))}

    def encode(self, st):
        return {"status": np.int32(0), "x": np.int32(st["x"]),
                "stopped": np.int32(bool(st["stopped"])),
                "err": np.int32(0)}

    def pad_msgs(self, batch, old):
        return batch


class TickKern(_OnePredicate):
    def __init__(self, codec, modulus, stop):
        self.modulus = modulus
        self.action_names = ("Tick", "Stop") if stop else ("Tick",)
        self.n_lanes = len(self.action_names)
        self.lane_action = np.arange(self.n_lanes, dtype=np.int32)
        self.lane_param = np.zeros(self.n_lanes, np.int32)
        self.pk = build_pack_spec(codec)

    def _lane_count(self, name):
        return 1

    def _guard_fns(self):
        fns = [lambda st: (st["stopped"] == 0)[:, None],
               lambda st: (st["status"] == 0)[:, None]]       # TRUE
        return fns[:self.n_lanes]

    def _action_fns(self):
        mod = self.modulus

        def tick(st, lane):
            return ({"status": st["status"], "x": (st["x"] + 1) % mod,
                     "stopped": st["stopped"],
                     "err": torch.zeros_like(st["err"])},
                    st["stopped"] == 0)

        def stp(st, lane):
            return ({"status": st["status"], "x": st["x"],
                     "stopped": torch.ones_like(st["stopped"]),
                     "err": torch.zeros_like(st["err"])},
                    st["status"] == 0)
        return [tick, stp][:self.n_lanes]

    def fingerprint(self, flat):
        st = self.pk.unflatten(flat)
        x = st["x"].to(torch.int64)
        s = st["stopped"].to(torch.int64)
        return to_i32(torch.stack([x * 2 + s + 1, x + 1, s + 1,
                                   torch.full_like(x, 55)], dim=1))

    def invariant_fns(self, names):
        return [(n, lambda st: torch.ones_like(st["x"], dtype=torch.bool))
                for n in names]

    def invariant_fn(self, names):
        return lambda st: torch.ones_like(st["x"], dtype=torch.bool)


def stub_ticker_factory(modulus=3, stop=True):
    """``model_factory`` for the Ticker fixture."""
    def make(binding, max_msgs=None):
        codec = TickCodec(modulus)
        return codec, TickKern(codec, modulus, stop)
    return make


def canon_csr(csr_or_graph):
    """Per-source sorted CSR segments: the one comparison form of the
    streamed/two-pass contract (edge order within one source's segment
    is free).  Takes a DeviceGraph or an ``(indptr, aid, tid)`` triple."""
    indptr, aid, tid = getattr(csr_or_graph, "csr", csr_or_graph)
    return [sorted(zip(aid[indptr[u]:indptr[u + 1]].tolist(),
                       tid[indptr[u]:indptr[u + 1]].tolist()))
            for u in range(len(indptr) - 1)]


def stub_graph_engine(binding=None, modulus=3, stop=True, device=None,
                      **kw):
    """A small ``PagedBFS(retain_levels=True, edges=True)`` over the
    Ticker (the JAX harness's defaults: tile 4, FPSet 2^8 slots, next
    buffer 2^6 rows); two-pass oracles pass ``edges=False``."""
    from .engine.paged_bfs import PagedBFS
    return PagedBFS(
        binding or ticker_binding(modulus=modulus, stop=stop),
        model_factory=stub_ticker_factory(modulus=modulus, stop=stop),
        tile_size=kw.pop("tile_size", 4),
        fpset_capacity=kw.pop("fpset_capacity", 1 << 8),
        next_capacity=kw.pop("next_capacity", 1 << 6),
        retain_levels=kw.pop("retain_levels", True),
        edges=kw.pop("edges", True), device=device, **kw)


# ----------------------------------------------------------------------
# CP06's hand-built rows
# ----------------------------------------------------------------------
def _cp_msg(row, k, hdr, count=1, log=(), cp=(), entry=0):
    """Bag slot k of a dense CP06 row holding the record whose header
    columns are ``hdr``."""
    row["m_present"][k] = 1
    row["m_count"][k] = count
    row["m_hdr"][k, :] = 0
    for c, v in hdr.items():
        row["m_hdr"][k, c] = v
    row["m_entry"][k] = entry
    row["m_log"][k] = 0
    row["m_log"][k, :len(log)] = log
    row["m_cp"][k] = 0
    row["m_cp"][k, :len(cp)] = cp


def checkpoint_rows(codec):
    """Three dense rows of a ``models/cp06.CP06Codec`` layout (MAX_MSGS
    >= 9), built from Init:

    * replies: replica 1, the Normal primary of view 1, all committed with
      its first op GC'd (NoOp), answers a RecoveryMsg and a GetState from
      op 0 in the checkpoint form (flag 1; a lane per cp when two values
      leave a cp above HighestGCedOp) and a RecoveryMsg and a GetState
      from op 1 in the suffix form; replica 2 is in StateTransfer with a flag-1 NewState
      to take; replica 3 is Recovering (nonce 1) with a flag-1 response
      from replica 1 and a Nil one from replica 2 in its slots (so
      CompleteRecovery takes the checkpoint form), a flag-1 response,
      a first_op response from replica 2 (different from its slot: it
      sets ERR_REC_OVERFLOW), a NewCheckpoint and its GetCheckpoint in
      the bag;
    * a view change to view 2: replica 2, its primary, holds two
      DoViewChange slots equal in (lnv, op) that part on their
      checkpoints (WinningDVC's tie), a higher DoViewChange and a
      StartView with checkpoints go to replica 3, a different second
      DoViewChange from replica 3 to replica 2 (ERR_DVC_OVERFLOW), a
      processed SVC lets replica 2 send its own DoViewChange, and with
      two values a Prepare two ops ahead of replica 3 opens state
      transfer;
    * a NoOp prefix: replicas 1 and 2 committed v1, replica 1's log slot
      GC'd and its app state holding v1 (the invariants read it through
      OpOf).
    """
    from .models.rr05 import M_RECOVERY, M_RECOVERYRESP, RECOVERING
    from .models.cp06 import M_GETCP, M_NEWCP
    from .models.st03 import (ANYDEST, M_DVC, M_GETSTATE, M_NEWSTATE,
                              M_PREPARE, M_SV, M_SVC, STATETRANSFER,
                              VIEWCHANGE)
    from .models.vsr import (H_COMMIT, H_CP, H_DEST, H_FIRST, H_FLAG,
                             H_LNV, H_OP, H_SRC, H_TYPE, H_VIEW, H_X)
    OPS, NOOP = codec.shape.MAX_OPS, codec.noop_id
    full = list(range(1, OPS + 1))          # v1..v_OPS committed
    gcd = [NOOP] + full[1:]                 # the first op GC'd

    def pad(vals):
        row = np.zeros(OPS, np.int32)
        row[:len(vals)] = vals
        return row

    def new():
        return {k: np.array(v) for k, v in codec.init_dense().items()}

    a = new()
    a["op"][0] = a["commit"][0] = OPS
    a["log"][0], a["app"][0] = pad(gcd), pad(full)
    a["status"][1] = STATETRANSFER
    a["status"][2], a["view"][2] = RECOVERING, 0
    a["rec_number"][2], a["aux_restart"][()] = 1, 1
    a["aux_acked"][0] = 2
    for key, val in (("rec", 1), ("rec_view", 1), ("rec_op", OPS),
                     ("rec_commit", OPS), ("rec_has_log", 1),
                     ("rec_flag", 1), ("rec_cpn", 1), ("rec_first", 2)):
        a[key][2, 0] = val
    a["rec_cp"][2, 0], a["rec_log"][2, 0] = pad([1]), pad(full[1:])
    a["rec"][2, 1], a["rec_view"][2, 1] = 1, 1
    a["rec_commit"][2, 1] = a["rec_first"][2, 1] = -1
    cp1 = dict(log=full[1:], cp=[1])
    _cp_msg(a, 0, {H_TYPE: M_RECOVERY, H_DEST: 1, H_SRC: 3, H_X: 1})
    _cp_msg(a, 1, {H_TYPE: M_GETSTATE, H_VIEW: 1, H_DEST: ANYDEST,
                   H_SRC: 2})
    _cp_msg(a, 2, {H_TYPE: M_NEWSTATE, H_VIEW: 1, H_OP: OPS, H_COMMIT: 1,
                   H_DEST: 2, H_SRC: 1, H_FLAG: 1, H_CP: 1}, **cp1)
    _cp_msg(a, 3, {H_TYPE: M_RECOVERYRESP, H_VIEW: 1, H_OP: OPS,
                   H_COMMIT: OPS, H_DEST: 3, H_SRC: 1, H_X: 1, H_FLAG: 1,
                   H_CP: 1}, **cp1)
    _cp_msg(a, 4, {H_TYPE: M_NEWCP, H_DEST: 3, H_SRC: 2, H_CP: 1}, cp=[1])
    _cp_msg(a, 5, {H_TYPE: M_GETCP, H_DEST: ANYDEST, H_SRC: 3})
    _cp_msg(a, 6, {H_TYPE: M_RECOVERYRESP, H_VIEW: 1, H_OP: OPS,
                   H_COMMIT: OPS, H_DEST: 3, H_SRC: 2, H_X: 1, H_FIRST: 1},
            log=full)
    _cp_msg(a, 7, {H_TYPE: M_GETSTATE, H_VIEW: 1, H_OP: 1, H_DEST: ANYDEST,
                   H_SRC: 2})
    _cp_msg(a, 8, {H_TYPE: M_RECOVERY, H_OP: 1, H_DEST: 1, H_SRC: 3, H_X: 1})

    b = new()
    b["status"][:2], b["view"][:2] = VIEWCHANGE, 2
    b["op"][:2] = b["commit"][:2] = OPS
    b["log"][0], b["log"][1] = pad(full), pad(gcd)
    b["app"][:2] = pad(full)
    b["sent_dvc"][0] = 1
    for j, cpn in ((0, 1), (2, 0)):
        b["dvc"][1, j], b["dvc_cpn"][1, j] = 1, cpn
        b["dvc_op"][1, j] = b["dvc_commit"][1, j] = OPS
        b["dvc_cp"][1, j] = pad(full[:cpn])
        b["dvc_log"][1, j] = pad(full[cpn:])
    _cp_msg(b, 0, {H_TYPE: M_DVC, H_VIEW: 2, H_OP: OPS, H_COMMIT: OPS,
                   H_DEST: 3, H_SRC: 1, H_CP: 1}, **cp1)
    _cp_msg(b, 1, {H_TYPE: M_SV, H_VIEW: 2, H_OP: OPS, H_COMMIT: OPS,
                   H_DEST: 3, H_SRC: 2, H_CP: 1}, **cp1)
    _cp_msg(b, 2, {H_TYPE: M_DVC, H_VIEW: 2, H_OP: OPS, H_COMMIT: OPS,
                   H_DEST: 2, H_SRC: 3, H_LNV: 1}, log=full)
    _cp_msg(b, 3, {H_TYPE: M_SVC, H_VIEW: 2, H_DEST: 2, H_SRC: 1},
            count=0)
    if OPS >= 2:
        _cp_msg(b, 4, {H_TYPE: M_PREPARE, H_VIEW: 2, H_OP: OPS, H_DEST: 3,
                       H_SRC: 2}, entry=OPS)

    c = new()
    c["op"][:2] = c["commit"][:2] = 1
    c["log"][0], c["log"][1] = pad([NOOP]), pad([1])
    c["app"][:2] = pad([1])
    c["aux_acked"][0] = 2
    return [a, b, c]
