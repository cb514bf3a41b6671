"""The single-device scan simulator ``DeviceSimulator`` (a port of
``tpuvsr/engine/device_sim.py:125-508``), and the replay of a recorded
walk that it and the walker fleet (``sim/fleet.py``) share.

Semantics are TLC's simulator: each walk starts at the initial state
and repeatedly jumps to a successor chosen uniformly at random from the
full (action x lane) successor list, checking the invariants at every
visited state, up to a depth bound.  A walker with no enabled successor
stays put (with ``check_deadlock`` the first one is reported).  Unlike
the fleet, every walker of a round draws from one shared key stream:
a round splits its key off the run's, each chunk its key off the
round's and one key a step off the chunk's, and walker w's numbers are
row w of the step's draw of shape (walkers, lanes) (``sim/rng.py``).
The walks, histories, verdicts and traces are the JAX package's for
the same seed.

**A chunk** advances every walker ``chunk_steps`` steps with no host
synchronisation inside, and one host read at its end (the chunk's
first violation and deadlock, the bag and dispatch-cap flags, the step
count).  A step is the guard matrix over every lane (kernel K6 on the
VSR model, K13 on the ST03 family), the draw and lane choice (kernel K5
in its shared layout, ``csrc/fleet_draw.cu``), the chosen (action,
lane) of every walker (K10, K14 on the family) and the invariants (the
same launch).  ``dispatch="dense"`` runs that launch over every walker;
``"grouped"`` (the default) first gathers the walkers by the action
they chose into a fixed cap an action, and a cap that overflows is
doubled and the chunk redrawn from its entry states (same keys, same
draws), as a full message table is (the table doubles).  Both give the
same walks.  On the card a chunk is one CUDA graph of its steps.

``guided=True`` resamples the walkers at every chunk boundary with
probability ~ exp(``split_beta`` * ``kern.hunt_score``), drawn from
``numpy.random.default_rng(seed ^ 0x5EED)``, the histories permuted
with them.  ``action_weights`` selects the two-stage draw (an enabled
action by weight, then a uniform enabled lane of it) and
``swarm_sigma`` per-walker log-normal noise on the weights, drawn once
a round (K5's shared noise entry).

A violation the device flags is replayed through the kernel into a
TRACE-format counterexample, and its last state is checked again with
the kernel's invariant functions: the JAX package checks it with the
interpreter, which the port does not have; a disagreement raises
``TLAError``.  Left out: the observer, journal and timers.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.values import TLAError
from ..device import resolve_device
from .. import kernels
from .simulate import SimResult
from .tile import _select
from .trace import TraceEntry

I32 = torch.int32


def apply_one(kern, flat, aid, param):
    """One (action id, lane param) step of the one state ``flat`` [1,
    lanes]: (successor [1, lanes], enabled bool).  K10 where the kernel
    has it (``successors``), else the action's function."""
    dev = flat.device
    if hasattr(kern, "successors"):
        one = lambda v: torch.full((1,), int(v), dtype=torch.int32,
                                   device=dev)
        o = kern.successors(flat, one(0), one(aid), one(param), 0)
        return o["succ"], bool(o["en2"][0])
    succ, en = kern._action_fns()[int(aid)](
        kern.pk.unflatten(flat), torch.tensor([int(param)], device=dev))
    return (kern.pk.flatten({k: v for k, v in succ.items()
                             if not k.startswith("_")}), bool(en[0]))


def materialize_walk(kern, codec, st0, aids, prms, n_steps, device):
    """Re-execute a recorded (action id, lane param) choice sequence
    from the dense state ``st0`` (numpy arrays) on ``device`` into a
    TRACE-format counterexample (``apply_one`` per step).  Stops at
    ``n_steps`` or the first ``-1`` action (a frozen walker); raises
    when a recorded lane is not enabled.  The cfg-only binding has no
    action locations, so ``location`` is None."""
    pk = kern.pk
    flat = pk.flatten({k: torch.as_tensor(np.asarray(v))[None].to(device)
                       for k, v in st0.items()}).contiguous()

    def decode(f):
        return codec.decode({k: v[0].cpu().numpy()
                             for k, v in pk.unflatten(f).items()})

    out = [TraceEntry(position=1, action_name=None, location=None,
                      state=decode(flat))]
    for i in range(min(int(n_steps), len(aids))):
        aid = int(aids[i])
        if aid < 0:
            break
        flat, en = apply_one(kern, flat, aid, int(prms[i]))
        if not en:
            raise TLAError(f"replay chose a disabled lane (step {i + 1}, "
                           f"{kern.action_names[aid]} lane {int(prms[i])})")
        out.append(TraceEntry(position=i + 2,
                              action_name=kern.action_names[aid],
                              location=None, state=decode(flat)))
    return out


class DeviceSimulator:
    """The single-device simulator (module docstring).  ``walkers``
    walk at a time, ``chunk_steps`` steps a host read;
    ``action_weights`` (dict name -> weight, or one weight per action),
    ``swarm_sigma``, ``guided`` with ``split_beta``, ``dispatch``
    ("grouped" or "dense") with its starting ``group_caps``, and
    ``model_factory(spec, max_msgs=..) -> (codec, kernel)`` (default
    the registry's hand kernels) as in the JAX package.  Runs on CUDA
    unless ``device`` says otherwise."""

    def __init__(self, spec, max_msgs=None, walkers=256, chunk_steps=32,
                 action_weights=None, swarm_sigma=0.0, guided=False,
                 split_beta=1.5, dispatch="grouped", group_caps=None,
                 model_factory=None, device=None):
        if dispatch not in ("grouped", "dense"):
            raise ValueError(f"dispatch must be 'grouped' or 'dense' "
                             f"(got {dispatch!r})")
        from ..models import registry
        self.device = resolve_device(device)
        self._model_factory = model_factory or registry.make_model
        self.spec = spec
        self.W = int(walkers)
        self.chunk = int(chunk_steps)
        self.inv_names = list(spec.invariants)
        self.swarm_sigma = float(swarm_sigma)
        self._action_weights = action_weights
        self.guided = bool(guided)
        self.split_beta = float(split_beta)
        self.dispatch = dispatch
        self.group_caps = (None if group_caps is None
                           else [int(c) for c in group_caps])
        self.log_w = None
        self.counters = {}
        # on the card a chunk replays a CUDA graph of its steps; a
        # caller that must see every kernel call turns this off
        self.graphs = self.device.type == "cuda"
        self._build(max_msgs)

    def _count(self, what, by=1):
        self.counters[what] = self.counters.get(what, 0) + by

    def _build(self, max_msgs):
        """(Re)build codec and kernel for a message-table bound."""
        self.codec, self.kern = self._model_factory(self.spec,
                                                    max_msgs=max_msgs)
        kern, dev = self.kern, self.device
        names = list(kern.action_names)
        aw = self._action_weights
        if aw is None:
            self.log_w = None
        else:
            if isinstance(aw, dict):
                w = np.ones(len(names))
                for name, x in aw.items():
                    w[names.index(name)] = x
            else:
                w = np.asarray(aw, float)
            if w.shape != (len(names),) or (w <= 0).any():
                raise ValueError("action_weights must be positive, one "
                                 "per action")
            self.log_w = np.log(w)
        self._inv = kern.invariant_fn(self.inv_names)
        self._inv_mask = (kern.invariant_mask(self.inv_names)
                          if hasattr(kern, "successors") else None)
        self._lane_aid = torch.as_tensor(kern.lane_action, dtype=I32,
                                         device=dev)
        self._lane_prm = torch.as_tensor(kern.lane_param, dtype=I32,
                                         device=dev)
        if self.group_caps is None:
            # an even split plus slack; an overflow doubles the cap
            self.group_caps = [min(self.W, max(32, self.W // 4))] \
                * len(names)
        if self.guided and not hasattr(kern, "hunt_score"):
            raise ValueError("guided simulation needs a kernel hunt_score")
        self._bufs = None
        self._graphs = {}

    # -- one step ------------------------------------------------------
    # Walker states live as one flat [W, lanes] int32 tensor in the
    # packing layout's lane order (engine/pack.py).
    def _guard_all(self, states):
        """[W, n_lanes] guard matrix: K6 (K13) where the model has it,
        else the guard loop."""
        kern = self.kern
        if hasattr(kern, "guard_matrix"):
            return kern.guard_matrix(states)[0]
        st = kern.pk.unflatten(states)
        return torch.cat([g(st) for g in kern._guard_fns()], dim=1)

    def _apply(self, b, states, aid, prm, alive):
        """Every walker's chosen (action, lane): (successors [W, lanes],
        err [W], invariants hold [W], per-action cap overflow [n_act]).
        Dense: one launch of K10 over every walker (or every action's
        function on every walker, selected).  Grouped: the walkers of
        each action gathered into its cap, then one K10 launch over the
        gathered queue (or each action's function on its group), the
        results scattered back; a walker past its action's cap keeps its
        state and flags the overflow."""
        kern, W, pk = self.kern, self.W, self.kern.pk
        n_act = len(kern.action_names)
        if self.dispatch == "dense":
            ovf = torch.zeros((n_act,), dtype=torch.bool,
                              device=states.device)
            if hasattr(kern, "successors"):
                o = kern.successors(states, b["wid"], aid.to(I32),
                                    prm.to(I32), self._inv_mask)
                return o["succ"], o["err"], o["iok"], ovf
            out = states
            st = pk.unflatten(states)
            for a, f in enumerate(kern._action_fns()):
                s_a, _en = f(st, prm.long())
                flat = pk.flatten({k: v for k, v in s_a.items()
                                   if not k.startswith("_")})
                out = torch.where((aid == a)[:, None], flat, out)
            clean = pk.unflatten(out)
            return out, clean["err"], self._inv(clean), ovf
        sels, ovf = [], []
        for a in range(n_act):
            C = min(int(self.group_caps[a]), W)
            m = (aid == a) & alive
            ovf.append(m.sum() > C)
            sels.append(_select(m, C, W))
        ovf = torch.stack(ovf)
        out = torch.cat([states, states[:1]])      # row W absorbs pads
        if hasattr(kern, "successors"):
            sel = torch.cat(sels)
            idx = sel.clamp(max=W - 1)
            lane = torch.where(sel == W, 0, prm[idx]).to(I32)
            o = kern.successors(states, idx.to(I32), b["group_aid"], lane,
                                self._inv_mask)
            out.index_copy_(0, sel, o["succ"])
            err = torch.zeros((W + 1,), dtype=I32, device=states.device)
            err.index_copy_(0, sel, o["err"])
            iok = torch.ones((W + 1,), dtype=torch.bool,
                             device=states.device)
            iok.index_copy_(0, sel, o["iok"])
            return out[:W], err[:W], iok[:W], ovf
        for a, f in enumerate(kern._action_fns()):
            sel = sels[a]
            idx = sel.clamp(max=W - 1)
            s_a, _en = f(pk.unflatten(states[idx]),
                         torch.where(sel == W, 0, prm[idx]))
            out.index_copy_(0, sel, pk.flatten(
                {k: v for k, v in s_a.items() if not k.startswith("_")}))
        clean = pk.unflatten(out[:W])
        return out[:W], clean["err"], self._inv(clean), ovf

    def _step(self, b):
        """One step of every walker, in place on the chunk buffers ``b``
        (no host sync: the body a chunk's CUDA graph captures).
        ``b["t"]`` is the step's row in the chunk (its key, its
        histories)."""
        from ..sim import rng
        states, was_alive = b["states"], b["was_alive"]
        en = self._guard_all(states)
        lane, alive = rng.choose_shared(b["keys"], b["t"], en,
                                        self._lane_aid, b["logw"])
        lane = lane.long()
        aid = self._lane_aid[lane]
        prm = self._lane_prm[lane]
        succ, errv, iok, ovf = self._apply(b, states, aid, prm, alive)
        err = alive & (errv != 0)
        badw = alive & ~iok & ~err
        d = b["t"].long()
        hit = badw.any() & (b["bad"][0] < 0)
        first = torch.argmax(badw.to(torch.int8)).reshape(1)
        b["bad"].copy_(torch.where(hit, torch.cat([first, d]), b["bad"]))
        dw = was_alive & ~alive
        hitd = dw.any() & (b["dead"][0] < 0)
        first = torch.argmax(dw.to(torch.int8)).reshape(1)
        b["dead"].copy_(torch.where(hitd, torch.cat([first, d]),
                                    b["dead"]))
        b["err"].logical_or_(err.any())
        b["ovf"].logical_or_(ovf)
        b["steps"].add_(alive.sum())
        b["ha"].index_copy_(0, d, torch.where(alive, aid, -1)[None]
                            .to(I32))
        b["hp"].index_copy_(0, d, torch.where(alive, prm, 0)[None]
                            .to(I32))
        states.copy_(torch.where(alive[:, None], succ, states))
        was_alive.copy_(alive)
        b["t"].add_(1)

    def _buffers(self, weighted):
        """The chunk buffers: the CUDA graphs' static inputs and outputs,
        kept while the kernel, the caps and the draw stay."""
        W, dev, kern = self.W, self.device, self.kern
        b = self._bufs
        if b is not None and (b["logw"] is not None) == weighted:
            return b
        self._graphs = {}
        z = lambda *shape, dtype=I32: torch.zeros(shape, dtype=dtype,
                                                  device=dev)
        n_act = len(kern.action_names)
        # the step keys as K5 reads them: int32 words on the card, the
        # plain version's int64 words on the CPU
        kdt = I32 if dev.type == "cuda" else torch.int64
        self._bufs = {
            "keys": z(self.chunk, 2, dtype=kdt), "t": z(1),
            "logw": z(W, n_act, dtype=torch.float32) if weighted else None,
            "states": z(W, kern.pk.lanes),
            "was_alive": z(W, dtype=torch.bool),
            "bad": z(2, dtype=torch.int64), "dead": z(2, dtype=torch.int64),
            "err": z(1, dtype=torch.bool), "ovf": z(n_act, dtype=torch.bool),
            "steps": z(1, dtype=torch.int64),
            "ha": z(self.chunk, W), "hp": z(self.chunk, W),
            "wid": torch.arange(W, dtype=I32, device=dev),
            "group_aid": None}
        return self._bufs

    def _run_steps(self, b, k):
        """``k`` steps on ``b``: on the card the replay of a CUDA graph
        of the k steps (captured on first use for this k, the kernel
        and the caps, after a warm-up on a scratch copy of ``b``, on
        the current stream), else eagerly."""
        if not self.graphs:
            for _ in range(k):
                self._step(b)
            return
        replay = self._graphs.get(k)
        if replay is None:
            warm = {n: (v.clone() if isinstance(v, torch.Tensor) else v)
                    for n, v in b.items()}
            for _ in range(k):
                self._step(warm)

            def chunk():
                for _ in range(k):
                    self._step(b)
            replay = self._graphs[k] = kernels.capture(chunk)
            self._count("graph_captures")
        replay()
        self._count("graph_replays")

    def _chunk(self, states, was_alive, keys, logw, k):
        """``k`` steps of every walker from (``states``, ``was_alive``)
        with the step keys ``keys`` [k, 2], no host sync inside, then the
        chunk's one host read.  Returns the new states and alive mask,
        the first violation and deadlock ([walker, step] or [-1, -1]),
        the bag flag, the per-action cap overflow, the steps taken and
        the histories (aid, prm) [k, W]."""
        b = self._buffers(logw is not None)
        if self.dispatch == "grouped" and \
                hasattr(self.kern, "successors") and b["group_aid"] is None:
            caps = [min(int(c), self.W) for c in self.group_caps]
            b["group_aid"] = torch.repeat_interleave(
                torch.arange(len(caps), dtype=I32, device=self.device),
                torch.tensor(caps, device=self.device))
        b["keys"][:k].copy_(keys.to(b["keys"].dtype))
        b["states"].copy_(states)
        b["was_alive"].copy_(was_alive)
        if logw is not None:
            b["logw"].copy_(logw)
        b["t"].zero_()
        b["bad"].fill_(-1)
        b["dead"].fill_(-1)
        for n in ("err", "ovf", "steps"):
            b[n].zero_()
        self._run_steps(b, k)
        self._count("chunks")
        h = torch.cat([b["bad"], b["dead"], b["err"].long(),
                       b["steps"], b["ovf"].long()]).cpu().numpy()
        self._count("host_reads")
        return (b["states"].clone(), b["was_alive"].clone(), h[0:2],
                h[2:4], bool(h[4]), h[6:].astype(bool), int(h[5]),
                (b["ha"][:k].clone(), b["hp"][:k].clone()))

    # -- host side -------------------------------------------------------
    def _resample(self, rng_np, states, was_alive, hists):
        """Importance splitting: W walker indices drawn with probability
        ~ exp(beta * hunt_score), states and every history chunk
        permuted by the draw (clones inherit their parent's past)."""
        scores = self.kern.hunt_score(self.kern.pk.unflatten(states)) \
            .cpu().numpy().astype(np.float64)
        if scores.max() == scores.min():
            return states, was_alive, hists, scores.max()
        z = self.split_beta * (scores - scores.max())
        p = np.exp(z)
        p /= p.sum()
        sel = torch.as_tensor(rng_np.choice(self.W, size=self.W, p=p),
                              device=self.device)
        self._count("splits")
        return (states[sel], was_alive[sel],
                [(ha[:, sel], hp[:, sel]) for ha, hp in hists],
                scores.max())

    def _round_logw(self, key):
        """Per-walker action log-weights of one round [W, n_act]
        (the base weights and, with ``swarm_sigma``, K5's shared noise
        from the round's key), or None when drawing TLC-uniform."""
        if self.log_w is None:
            return None
        logw = torch.as_tensor(self.log_w, dtype=torch.float32,
                               device=self.device)
        if self.swarm_sigma > 0.0:
            from ..sim import rng
            return rng.shared_noise(key.to(self.device), logw,
                                    self.swarm_sigma, self.W)
        return logw[None, :].expand(self.W, -1).contiguous()

    def _grow_msgs(self, init, states):
        """Double MAX_MSGS: the dense init batch (numpy) and the flat
        walker states gain all-zero message slots (content-neutral)."""
        old, old_pk = self.codec.shape.MAX_MSGS, self.kern.pk
        self._build(old * 2)
        ini = self.codec.pad_msgs({k: torch.as_tensor(v)
                                   for k, v in init.items()}, old)
        dense = self.codec.pad_msgs(old_pk.unflatten(states), old)
        return ({k: v.numpy() for k, v in ini.items()},
                self.kern.pk.flatten(dense).contiguous())

    def first_failing(self, dense):
        """Name of the first cfg invariant the one dense state (numpy
        arrays) fails, or None."""
        st = {k: torch.as_tensor(np.asarray(v))[None].to(self.device)
              for k, v in dense.items()}
        for name, f in self.kern.invariant_fns(self.inv_names):
            if not bool(f(st)[0]):
                return name
        return None

    def run(self, num=1000, depth=100, seed=0, check_deadlock=False,
            log=None, max_seconds=None) -> SimResult:
        """Run ``num`` walks of ``depth`` steps (``walkers`` at a time,
        ``chunk_steps`` steps a host read)."""
        from ..sim import rng
        spec, codec, W, dev = self.spec, self.codec, self.W, self.device
        res = SimResult()
        res.walkers = W
        t0 = time.time()
        init0 = spec.init_dense(codec)[0]
        init = {k: np.repeat(np.asarray(v)[None], W, axis=0)
                for k, v in init0.items()}
        bad0 = self.first_failing(init0)
        if bad0:
            res.ok = False
            res.violated_invariant = bad0
            return self._finish(res, t0)
        key = rng.prng_key(seed)
        rng_np = np.random.default_rng(seed ^ 0x5EED)
        init_flat = self.kern.pk.flatten(
            {k: torch.as_tensor(v, device=dev) for k, v in init.items()}
        ).contiguous()
        stop = False
        best_score = self.best_score = 0
        while res.walks < num and not stop:
            states = init_flat
            was_alive = torch.ones((W,), dtype=torch.bool, device=dev)
            hists = []
            d = 0
            key, wkey = rng.split(key)
            logw = self._round_logw(wkey)
            while d < depth:
                k = min(self.chunk, depth - d)
                key, sub = rng.split(key)
                keys = rng.split(sub, k)
                while True:
                    (nstates, alive, bad, dead, err_any, ovf, steps,
                     hist) = self._chunk(states, was_alive, keys, logw, k)
                    if err_any:
                        # a full bag inside the chunk: grow the table,
                        # pad the entry states, redraw the chunk
                        init, states = self._grow_msgs(init, states)
                        init_flat = self.kern.pk.flatten(
                            {n: torch.as_tensor(v, device=dev)
                             for n, v in init.items()}).contiguous()
                        self._count("grow_message_table")
                        if log:
                            log(f"message table grown to "
                                f"{self.codec.shape.MAX_MSGS} slots")
                        continue
                    if ovf.any():
                        # a dispatch group overflowed its cap: double the
                        # flagged caps, redraw (same keys, same draws)
                        for a in np.nonzero(ovf)[0]:
                            self.group_caps[a] = min(
                                W, self.group_caps[a] * 2)
                            if log:
                                log(f"dispatch group for "
                                    f"{self.kern.action_names[a]} grown "
                                    f"to {self.group_caps[a]}")
                        self._count("grow_dispatch_group",
                                    int(ovf.sum()))
                        self._bufs = None
                        continue
                    break
                hists.append(hist)
                res.steps += steps
                # the earlier event of the chunk; within one step a
                # deadlock is checked first
                dead_first = (check_deadlock and dead[0] >= 0
                              and (bad[0] < 0 or dead[1] <= bad[1]))
                if dead_first:
                    w, ds = int(dead[0]), int(dead[1])
                    res.ok = False
                    res.deadlocks += 1
                    res.trace = self._replay(init, hists, w, d + ds)
                    res.violated_invariant = None
                    self.event = {"walker": w, "step": d + ds}
                    return self._finish(res, t0)
                if bad[0] >= 0:
                    w, ds = int(bad[0]), int(bad[1])
                    res.ok = False
                    res.trace = self._replay(init, hists, w, d + ds + 1)
                    confirmed = self.first_failing(
                        codec.encode(res.trace[-1].state))
                    if confirmed is None:
                        err = TLAError(
                            "device invariant pass reported a violation "
                            f"at walker {w} depth {d + ds + 1} that the "
                            "replayed state does not show")
                        err.trace = res.trace
                        raise err
                    res.violated_invariant = confirmed
                    self.event = {"walker": w, "step": d + ds + 1}
                    return self._finish(res, t0)
                states, was_alive = nstates, alive
                d += k
                if self.guided and d < depth:
                    states, was_alive, hists, sc = self._resample(
                        rng_np, states, was_alive, hists)
                    best_score = max(best_score, int(sc))
                if max_seconds and time.time() - t0 > max_seconds:
                    stop = True
                    break
            res.walks += W
            self.best_score = best_score
        return self._finish(res, t0)

    def _replay(self, init, hists, w, n_steps):
        """Re-execute walker ``w``'s first ``n_steps`` recorded choices
        into a TRACE-format counterexample."""
        aids = np.concatenate([ha[:, w].cpu().numpy() for ha, _hp in hists])
        prms = np.concatenate([hp[:, w].cpu().numpy() for _ha, hp in hists])
        return materialize_walk(self.kern, self.codec,
                                {k: v[w] for k, v in init.items()}, aids,
                                prms, n_steps, self.device)

    def _finish(self, res, t0):
        res.elapsed = time.time() - t0
        res.metrics = {
            "gauges": {"walkers": self.W, "dispatch": self.dispatch,
                       "max_msgs": int(self.codec.shape.MAX_MSGS),
                       "group_caps": list(self.group_caps)},
            "counters": dict(self.counters)}
        return res


def device_simulate(spec, num=1000, depth=100, seed=0, walkers=256,
                    max_msgs=None, check_deadlock=False, log=None,
                    max_seconds=None, chunk_steps=32, action_weights=None,
                    swarm_sigma=0.0, guided=False, split_beta=1.5,
                    fleet=False, model_factory=None,
                    device=None) -> SimResult:
    """One-call simulation on ``device`` (CUDA unless the caller asks
    for the CPU): ``DeviceSimulator``, or with ``fleet=True`` the walker
    fleet (``sim/fleet.fleet_simulate``; ``guided`` maps onto its
    novelty splitting)."""
    if fleet:
        from ..sim import NoveltySplitter, fleet_simulate
        return fleet_simulate(spec, num=num, depth=depth, seed=seed,
                              walkers=walkers, max_msgs=max_msgs,
                              chunk_steps=chunk_steps,
                              action_weights=action_weights,
                              swarm_sigma=swarm_sigma,
                              split=NoveltySplitter() if guided else None,
                              log=log, max_seconds=max_seconds,
                              model_factory=model_factory, device=device)
    sim = DeviceSimulator(spec, max_msgs=max_msgs, walkers=walkers,
                          chunk_steps=chunk_steps,
                          action_weights=action_weights,
                          swarm_sigma=swarm_sigma, guided=guided,
                          split_beta=split_beta,
                          model_factory=model_factory, device=device)
    return sim.run(num=num, depth=depth, seed=seed,
                   check_deadlock=check_deadlock, log=log,
                   max_seconds=max_seconds)
