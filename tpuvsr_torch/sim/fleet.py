"""The walker fleet on one device (a port of ``tpuvsr/sim/fleet.py``).

**Seed-reproducibility contract.**  Walk ``i`` is a pure function of
``(seed, i)``: every per-step draw comes from
``fold_in(fold_in(PRNGKey(seed), i), step)`` (``sim/rng.py``, bit-exact
with ``jax.random``), so a walk's action sequence does not depend on the
walker count.  Rounds cover contiguous walk-id ranges in increasing
order, a violating round runs to its full depth before reporting, and
the reported violation is the one on the minimum walk id (at that
walk's first violating step).  The walks, and so the counterexamples,
are those of the JAX package for the same seed.  Importance splitting
(``splitting.py``) trades the walker-count leg of this contract for hit
rate: a guided run is a function of ``(seed, walkers)``.

**A chunk** advances every walker ``chunk_steps`` steps with no host
synchronisation inside, as the JAX ``lax.scan`` does: the guard matrix
over every lane (kernel K6, ``csrc/vsr_guards.cu``, on the VSR model),
the draw and lane choice (kernel K5, ``csrc/fleet_draw.cu``), each
walker's chosen action and the invariants (kernel K10,
``csrc/vsr_actions.cu``: one launch over every walker on the card, its
plain version on the CPU).  A model without K10 runs the grouped
dispatch instead (each action body on the walkers that chose it,
gathered by a sync-free cumsum-and-scatter compaction into a fixed
per-action cap; a cap overflow grows the flagged caps to the exact count
and redraws the chunk from the committed boundary: same keys, same
draws).  The exact per-action chooser counts come out at the chunk's end
with the step and event counts, in one device-to-host read; a
message-table overflow grows the table and redraws.

Symmetry (``symmetry="auto" | True | False``, the JAX meaning: auto is
on iff the cfg declares SYMMETRY) reaches only the novelty seen-set: the
splitter keys it by the fingerprints of canonical images
(``engine/canon.py``), so novelty counts orbits.  Walks and verdicts do
not depend on it.

Left out of this port (ROADMAP.md): fleet snapshots, rescue and resume;
the OOM degrade ladder and elastic reshaping; the dispatch window (the
port runs chunks synchronously; guided runs force a window of 1 in JAX
too); the dense dispatch, the mesh and sharding; the observer/journal;
``sim/hunt.py``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.values import TLAError
from ..device import resolve_device
from ..engine.canon import build_canon_spec
from ..engine.device_sim import failing_row, materialize_walk
from ..engine.simulate import SimResult
from .. import kernels
from ..models import registry
from . import rng

I32 = torch.int32


def _align8(n):
    return ((int(n) + 7) // 8) * 8


def _select(m, cap, fill):
    """Indices of the first ``cap`` True entries of ``m``, in order,
    padded with ``fill`` (the sync-free counterpart of
    ``jnp.nonzero(m, size=cap, fill_value=fill)``)."""
    pos = torch.cumsum(m, 0) - 1
    dest = torch.where(m & (pos < cap), pos, cap)
    out = torch.full((cap + 1,), fill, dtype=torch.int64, device=m.device)
    out.scatter_(0, dest, torch.arange(m.shape[0], device=m.device))
    return out[:cap]


class FleetSimulator:
    """The walker fleet (module docstring has the contract).

    ``walkers`` is the fleet size; ``action_weights`` (dict name ->
    weight, or one weight per action) switches to the two-stage draw
    (an enabled action by weight, then a uniform enabled lane of it),
    ``swarm_sigma`` multiplies per-walker log-normal noise onto the
    weights; ``split=NoveltySplitter(...)`` turns on importance
    splitting at chunk boundaries; ``symmetry`` keys its seen-set by
    orbits (module docstring).  Runs on CUDA unless ``device`` says
    otherwise."""

    def __init__(self, spec, walkers=4096, chunk_steps=16, max_msgs=None,
                 action_weights=None, swarm_sigma=0.0, split=None,
                 model_factory=None, log=None, device=None,
                 symmetry="auto"):
        self.device = resolve_device(device)
        self._symmetry_req = symmetry
        self._model_factory = model_factory or registry.make_model
        self.spec = spec
        self.inv_names = list(spec.invariants)
        self.chunk = int(chunk_steps)
        self.swarm_sigma = float(swarm_sigma)
        self._action_weights = action_weights
        self._log = log
        self.splitter = split
        if walkers < 1:
            raise ValueError(f"walkers must be >= 1 (got {walkers})")
        self.walkers = self.W_pad = int(walkers)
        self.group_caps = None
        self.counters = {}
        # on the card a chunk replays a CUDA graph of one step; a caller
        # that must see every kernel call as it happens turns this off
        self.graphs = self.device.type == "cuda"
        self._bufs = None
        self._build(max_msgs)

    def log(self, msg):
        if self._log:
            self._log(f"fleet: {msg}")

    def _count(self, what, by=1):
        self.counters[what] = self.counters.get(what, 0) + by

    # -- construction --------------------------------------------------
    def _build(self, max_msgs):
        """(Re)build codec and kernel for a message-table bound."""
        self.codec, self.kern = self._model_factory(self.spec,
                                                    max_msgs=max_msgs)
        kern, dev = self.kern, self.device
        names = list(kern.action_names)
        n_act = len(names)
        self.log_w = None
        if self._action_weights is not None:
            aw = self._action_weights
            if isinstance(aw, dict):
                w = np.ones(n_act)
                for name, x in aw.items():
                    w[names.index(name)] = x
            else:
                w = np.asarray(aw, float)
            if w.shape != (n_act,) or (w <= 0).any():
                raise ValueError("action_weights must be positive, "
                                 "one per action")
            self.log_w = np.log(w)
        self._inv = kern.invariant_fn(self.inv_names)
        self._inv_mask = (kern.invariant_mask(self.inv_names)
                          if hasattr(kern, "successors") else None)
        self._lane_aid = torch.as_tensor(kern.lane_action, dtype=I32,
                                         device=dev)
        self._lane_prm = torch.as_tensor(kern.lane_param, dtype=I32,
                                         device=dev)
        if self.group_caps is None:
            W = self.W_pad
            self.group_caps = [min(W, max(32, W // 4))] * n_act
        # rebuilt with the codec: the key positions follow the layout
        self._canon = build_canon_spec(self.spec, self.codec, kern,
                                       self._symmetry_req)
        if self.splitter is not None:
            self.splitter.bind(kern, canon=self._canon)
        self._init_cache = None
        self._graph = None       # it baked in the old kernel's tensors

    def _grow_msgs(self, flat, init_states):
        """Double MAX_MSGS: the flat walker states and the round's init
        batch gain all-zero message slots (content-neutral)."""
        old, old_pk = self.codec.shape.MAX_MSGS, self.kern.pk
        self._build(old * 2)
        dense = self.codec.pad_msgs(old_pk.unflatten(flat), old)
        ini = self.codec.pad_msgs({k: torch.as_tensor(v)
                                   for k, v in init_states.items()}, old)
        return (self.kern.pk.flatten(dense).contiguous(),
                {k: v.numpy() for k, v in ini.items()})

    # -- one chunk -----------------------------------------------------
    # Walker states live as one flat [W, lanes] int32 tensor in the
    # packing layout's lane order (engine/pack.py); the kernel's guards,
    # actions and invariants read per-plane views of it.
    def _guard_all(self, states):
        """[W, n_lanes] guard matrix: K6 where the model has it
        (``guard_matrix``; the same lane order), else the guard loop."""
        kern = self.kern
        if hasattr(kern, "guard_matrix"):
            return kern.guard_matrix(states)[0]
        st = kern.pk.unflatten(states)
        return torch.cat([g(st) for g in kern._guard_fns()], dim=1)

    def _apply_grouped(self, states, aid, prm, act):
        """Each action body on just the walkers that chose it (at most
        its cap; a walker past the cap keeps its state and the chunk is
        redrawn).  Returns (successors, exact per-action counts)."""
        W, pk = self.W_pad, self.kern.pk
        out = torch.cat([states, states[:1]])     # row W absorbs pads
        cnt = []
        for a, f in enumerate(self.kern._action_fns()):
            C = min(int(self.group_caps[a]), W)
            m = (aid == a) & act
            cnt.append(m.sum())
            sel = _select(m, C, W)
            idx = sel.clamp(max=W - 1)
            # pad rows run lane 0 (in range for every action); their
            # successors land in the spare row W
            s_a, _en = f(pk.unflatten(states[idx]),
                         torch.where(sel == W, 0, prm[idx]))
            out.index_copy_(0, sel, pk.flatten(s_a))
        return out[:W], torch.stack(cnt)

    def _step(self, b):
        """One step of every walker, in place on the chunk buffers ``b``
        (no host sync: the body the CUDA graph captures).  ``b["d"]`` is
        the step (a device scalar), ``b["t"]`` its row in the chunk's
        histories."""
        states, alive = b["states"], b["alive"]
        en = self._guard_all(states)
        lane, can = rng.choose_lanes(b["wkeys"], b["d"], en,
                                     self._lane_aid, b["wlogw"])
        lane = lane.long()
        act = alive & can
        aid = self._lane_aid[lane]
        prm = self._lane_prm[lane]
        kern = self.kern
        if self._grouped_now():
            succ, cnt = self._apply_grouped(states, aid, prm, act)
            new = torch.where(act[:, None], succ, states)
            st = kern.pk.unflatten(new)
            err = act & (st["err"] != 0)
            iok = self._inv(st)
        else:
            # K10: every walker's chosen (action, lane) in one launch; a
            # walker that takes no step keeps its row
            o = kern.successors(states, b["wid"], aid, prm, self._inv_mask)
            new = torch.where(act[:, None], o["succ"], states)
            err = act & (o["err"] != 0)
            iok = o["iok"]
            cnt = torch.zeros_like(b["need"]).index_add_(0, aid.long(),
                                                          act.long())
        badw = act & ~iok & ~err
        d = b["d"]
        b["dead"].copy_(torch.where(alive & ~can & (b["dead"] < 0), d,
                                    b["dead"]))
        b["violated"].copy_(torch.where(badw & (b["violated"] < 0), d + 1,
                                        b["violated"]))
        b["states"].copy_(new)
        b["alive"].copy_(alive & can & ~badw)
        b["steps"].add_(act.sum())
        b["err"].logical_or_(err.any())
        torch.maximum(b["need"], cnt, out=b["need"])
        b["ha"].index_copy_(0, b["t"], torch.where(act, aid, -1)[None]
                            .to(I32))
        b["hp"].index_copy_(0, b["t"], torch.where(act, prm, 0)[None]
                            .to(I32))
        b["d"].add_(1)
        b["t"].add_(1)

    def _buffers(self, weighted):
        """The chunk buffers: the CUDA graph's static inputs and outputs,
        kept while the kernel (its lane layout) stays the same."""
        W, dev, kern = self.W_pad, self.device, self.kern
        b = self._bufs
        if b is not None and b["kern"] is kern \
                and (b["wlogw"] is not None) == weighted:
            return b
        z = lambda *shape, dtype=I32: torch.zeros(shape, dtype=dtype,
                                                  device=dev)
        n_act = len(kern.action_names)
        self._bufs = {
            "kern": kern, "wkeys": z(W, 2, dtype=torch.int64),
            "wlogw": z(W, n_act, dtype=torch.float32) if weighted else None,
            "states": z(W, kern.pk.lanes), "alive": z(W, dtype=torch.bool),
            "violated": z(W), "dead": z(W), "d": z(1),
            "t": z(1, dtype=torch.int64), "ha": z(self.chunk, W),
            "hp": z(self.chunk, W), "steps": z(1, dtype=torch.int64),
            "err": z(1, dtype=torch.bool), "need": z(n_act,
                                                     dtype=torch.int64),
            "wid": torch.arange(W, dtype=I32, device=dev)}
        return self._bufs

    def _replay_graph(self, b):
        """One step through the CUDA graph of ``_step`` on ``b``,
        captured on first use and again whenever the dispatch caps or
        the kernel change (``kernels.capture`` counts the kernels inside
        at every replay).  The warm-up runs on the current stream, as
        the fused BFS pass's does (a side-stream warm-up broke a fresh
        process's first fused graph on the card, PERF.md)."""
        caps = tuple(self.group_caps)
        if self._graph is None or self._graph[0] != caps \
                or self._graph[1] is not b:
            self._graph = None
            # warm-up on a scratch copy: fills the index caches
            self._step({k: (v.clone() if isinstance(v, torch.Tensor)
                            else v) for k, v in b.items()})
            # the graph holds b (its tensors are the graph's addresses)
            self._graph = (caps, b, kernels.capture(lambda: self._step(b)))
            self._count("graph_captures")
        self._graph[2]()

    def _chunk(self, wkeys, wlogw, states, alive, violated, dead, step0,
               depth):
        """``chunk_steps`` steps of every walker, no host sync inside.
        Returns the new (states, alive, violated, dead), the histories
        ``(aid, prm)`` [chunk, W] and one int64 tensor of host-bound
        counts: [steps, alive, events, err, need per action].  On the
        card a full chunk replays a CUDA graph of one step; past the
        round's depth nothing moves (JAX masks those steps with `on`)."""
        b = self._buffers(wlogw is not None)
        for k, v in (("wkeys", wkeys), ("wlogw", wlogw), ("states", states),
                     ("alive", alive), ("violated", violated),
                     ("dead", dead)):
            if v is not None:
                b[k].copy_(v)
        b["d"].fill_(step0)
        b["t"].zero_()
        b["ha"].fill_(-1)
        for k in ("hp", "steps", "err", "need"):
            b[k].zero_()
        live = min(self.chunk, depth - step0)
        graphs = self.graphs and live == self.chunk
        for _ in range(live):
            if graphs:
                self._replay_graph(b)
            else:
                self._step(b)
        events = ((b["violated"] >= 0) | (b["dead"] >= 0)).sum()
        counts = torch.cat([b["steps"], b["alive"].sum()[None],
                            events[None], b["err"].long(), b["need"]])
        return (b["states"].clone(), b["alive"].clone(),
                b["violated"].clone(), b["dead"].clone(),
                (b["ha"].clone(), b["hp"].clone()), counts)

    def _grouped_now(self):
        """The step runs the grouped dispatch (and so has caps)."""
        return not hasattr(self.kern, "successors")

    # -- replay --------------------------------------------------------
    def replay(self, init_row, hists, slot, n_steps):
        """Re-execute walker ``slot``'s first ``n_steps`` recorded
        choices into a TRACE-format counterexample."""
        aids = (np.concatenate([ha[:, slot].cpu().numpy()
                                for ha, _hp in hists])
                if hists else np.zeros((0,), np.int32))
        prms = (np.concatenate([hp[:, slot].cpu().numpy()
                                for _ha, hp in hists])
                if hists else np.zeros((0,), np.int32))
        return materialize_walk(self.kern, self.codec, init_row, aids,
                                prms, n_steps, self.device)

    def first_failing(self, dense):
        """Name of the first cfg invariant the one dense state (numpy
        arrays) fails, or None (``failing_row``)."""
        flat = self.kern.pk.flatten(
            {k: torch.as_tensor(np.asarray(v))[None].to(self.device)
             for k, v in dense.items()}).contiguous()
        hit = failing_row(self.kern, flat, self.inv_names)
        return None if hit is None else hit[1]

    # -- round driver --------------------------------------------------
    def _init_batch(self, base, active):
        """Walker slot s begins at init state ``(base + s) % n_init``."""
        if self._init_cache is None:
            init = self.spec.init_dense(self.codec)
            self._init_cache = ({k: np.stack([np.asarray(d[k])
                                              for d in init])
                                 for k in init[0]}, len(init))
        batch, n_init = self._init_cache
        idx = (base + np.arange(self.W_pad)) % n_init
        return ({k: v[idx] for k, v in batch.items()},
                np.arange(self.W_pad) < active)

    def walker_keys(self, key, base):
        """[W, 2] keys ``fold_in(key, walk_id)`` of the round at
        ``base``, and the per-walker log-weights (None: unweighted)."""
        ids = (base + np.arange(self.W_pad)) % (1 << 31)
        wkeys = rng.fold_in(key.to(self.device)[None, :],
                            torch.as_tensor(ids, device=self.device))
        wlogw = None
        if self.log_w is not None:
            logw = torch.as_tensor(self.log_w, dtype=torch.float32,
                                   device=self.device)
            if self.swarm_sigma > 0.0:
                wlogw = rng.swarm_noise(wkeys, logw, self.swarm_sigma)
            else:
                wlogw = logw[None, :].expand(self.W_pad, -1).contiguous()
        return wkeys, wlogw

    def run_round(self, *, base, active, depth, key, deadline=None,
                  chunks_before=0):
        """Run one round: walkers at slots [0, active) walk walk-ids
        [base, base+active) to ``depth`` (or until every walker froze).
        Returns ``(violated_at, dead_at, hists, init_states, steps,
        completed, chunks)`` — event arrays over the slot axis (numpy),
        the recorded histories, the round's init batch (numpy), the
        steps taken, whether the round ran to its natural end, and the
        cumulative committed-chunk index."""
        splitter, dev, W = self.splitter, self.device, self.W_pad
        h_states, h_alive = self._init_batch(base, active)
        init_states = h_states
        committed = (self.kern.pk.flatten(
                         {k: torch.as_tensor(v, device=dev)
                          for k, v in h_states.items()}).contiguous(),
                     torch.as_tensor(h_alive, device=dev),
                     torch.full((W,), -1, dtype=I32, device=dev),
                     torch.full((W,), -1, dtype=I32, device=dev))
        hists = []
        if splitter is not None:
            splitter.reset(W, dev)
        wkeys, wlogw = self.walker_keys(key, base)
        step, steps_total, chunk_idx, stop = 0, 0, chunks_before, False
        while step < depth:
            out = self._chunk(wkeys, wlogw, *committed, step, depth)
            self._count("chunks")
            c = out[5].cpu().numpy()
            steps_k, n_alive, _events, err_any = (int(x) for x in c[:4])
            need = c[4:]
            if err_any:
                # bag overflow inside the chunk: grow the message table,
                # pad the committed states and the init batch, redraw
                st_pad, init_states = self._grow_msgs(committed[0],
                                                      init_states)
                committed = (st_pad,) + committed[1:]
                self._count("grow_message_table")
                self.log(f"message table grown to "
                         f"{self.codec.shape.MAX_MSGS} slots")
                continue
            caps_now = np.minimum(np.asarray(self.group_caps, np.int64), W)
            over = need > caps_now
            if over.any() and self._grouped_now():
                # grow the flagged caps to the exact chooser count and
                # redraw the chunk (same keys, same draws)
                for a in np.nonzero(over)[0]:
                    self.group_caps[a] = int(min(W, _align8(need[a])))
                self._count("grow_dispatch_group", int(over.sum()))
                continue
            committed = out[:4]
            hists.append(out[4])
            step = min(step + self.chunk, depth)
            steps_total += steps_k
            chunk_idx += 1
            if splitter is not None and step < depth and n_alive > 1:
                states_s, alive_s, hists, init_states = splitter.resample(
                    committed[0], committed[1], hists, init_states)
                committed = (states_s, alive_s) + committed[2:]
                self._count("splits")
            if n_alive == 0:
                break
            if deadline is not None and time.time() > deadline:
                stop = True
                break
        return (committed[2].cpu().numpy(), committed[3].cpu().numpy(),
                hists, init_states, steps_total, not stop, chunk_idx)

    # -- the TLC-simulator entry ---------------------------------------
    def run(self, num=1000, depth=100, seed=0,
            max_seconds=None) -> SimResult:
        """Run walks until ``num`` of them completed (rounds of
        ``walkers`` at a time), reporting the minimum-walk-id violation
        of the first violating round."""
        res = SimResult()
        self.event = None

        def on_round(violated, hists, init_states, base, active):
            slots = np.nonzero(violated[:active] >= 0)[0]
            if not len(slots):
                return False
            # the minimum walk id, at its first violating step
            slot = int(slots[0])
            ev_depth = int(violated[slot])
            self.event = {"walk": int(base + slot), "slot": slot,
                          "step": ev_depth}
            res.ok = False
            res.trace = self.replay({k: v[slot]
                                     for k, v in init_states.items()},
                                    hists, slot, ev_depth)
            confirmed = self.first_failing(
                self.codec.encode(res.trace[-1].state))
            if confirmed is None:
                err = TLAError(
                    "fleet invariant pass reported a violation at walk "
                    f"{base + slot} step {ev_depth} that the replayed "
                    "state does not show")
                err.trace = res.trace
                raise err
            res.violated_invariant = confirmed
            return True

        return drive_rounds(self, res, depth=depth, seed=seed, num=num,
                            max_seconds=max_seconds, on_round=on_round)



def drive_rounds(sim, res, *, depth, seed, on_round, num=None,
                 max_seconds=None) -> SimResult:
    """The round loop (the core of ``tpuvsr/sim/fleet.py:drive_rounds``):
    the init-state invariant pre-check, round sizing, walks/steps/
    deadlocks accounting; ``on_round(violated, hists, init_states,
    base, active)`` handles a committed round's violations and returns
    True to stop."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1 (got {depth})")
    res.walkers = sim.walkers
    t0 = time.time()
    init0 = sim.spec.init_dense(sim.codec)[0]
    bad0 = sim.first_failing(init0)
    if bad0:
        res.ok = False
        res.violated_invariant = bad0
        return _finish(sim, res, t0)
    key = rng.prng_key(seed, device=sim.device)
    deadline = (t0 + max_seconds) if max_seconds else None
    base = chunks = 0
    while True:
        if num is not None and res.walks >= num:
            break
        if deadline is not None and time.time() > deadline:
            break
        active = (min(sim.walkers, num - res.walks) if num is not None
                  else sim.walkers)
        (violated, dead, hists, init_states, steps, completed,
         chunks) = sim.run_round(base=base, active=active, depth=depth,
                                 key=key, deadline=deadline,
                                 chunks_before=chunks)
        res.steps += steps
        res.deadlocks += int((dead >= 0).sum())
        stop = bool(on_round(violated, hists, init_states, base, active))
        if completed:
            res.walks += active
            base += active
        if stop or not completed:
            break
    return _finish(sim, res, t0)


def _finish(sim, res, t0):
    res.elapsed = time.time() - t0
    gauges = {"walkers": sim.walkers,
              "max_msgs": int(sim.codec.shape.MAX_MSGS),
              "group_caps": list(sim.group_caps)}
    if sim.splitter is not None:
        gauges.update(sim.splitter.gauges())
    res.metrics = {"gauges": gauges, "counters": dict(sim.counters)}
    return res


def fleet_simulate(spec, num=1000, depth=100, seed=0, walkers=4096,
                   max_msgs=None, chunk_steps=16, action_weights=None,
                   swarm_sigma=0.0, split=None, log=None, max_seconds=None,
                   model_factory=None, device=None,
                   symmetry="auto") -> SimResult:
    """One-call fleet simulation on ``device`` (CUDA unless the caller
    asks for the CPU)."""
    sim = FleetSimulator(spec, walkers=walkers, max_msgs=max_msgs,
                         chunk_steps=chunk_steps,
                         action_weights=action_weights,
                         swarm_sigma=swarm_sigma, split=split,
                         model_factory=model_factory, log=log,
                         device=device, symmetry=symmetry)
    return sim.run(num=num, depth=depth, seed=seed,
                   max_seconds=max_seconds)
