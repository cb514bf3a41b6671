"""Batched trace validation on the card (a port of
``tpuvsr/validate/batch.py``).

``BatchValidator`` checks many recorded implementation traces against a
model kernel at once.  Each trace keeps a set of up to ``cand_cap``
candidate states (every spec state consistent with its observations so
far).  A step advances every trace of a round through one recorded
event: every candidate's full successor set is computed, the successors
consistent with the event (its action, and the variables it pins) are
kept, deduplicated by fingerprint, and become the next candidate set.
An empty set is the divergence, reported with the spec-side enabled
actions at that point.

**The step on the card** (one round of T traces, K candidate slots
each, rows in the packing layout's flat lane order):

1. the guard matrix of the [T*K] candidate rows: K6 (VSR) or K13 (the
   ST03 family), or the guard functions of a model without one;
2. K16's ``select`` (``csrc/validate_step.cu``): the enabled lanes of
   live candidates of active traces whose action matches the event's
   (``aid_obs``, -1 = any), compacted into a work queue in (trace,
   candidate, lane) order, the order of the JAX package's
   first-occurrence scan; the host reads the queue's size between its
   two launches (one read a step), which sizes the queue and the
   successor launch;
3. the queue's successors (K10 / K14, or the action functions) and
   their fingerprints (K3, incremental where the model has parent
   parts);
4. K16's ``commit``, one block a trace: the observation filter, the
   ``err`` exclusion, the first occurrence of each fingerprint (a hash
   table of the trace's items keyed by fingerprint, holding the least
   queue index: no pairwise comparison), the ranks, the scatter of the
   kept rows into the candidate buffer, and the divergence bookkeeping
   (``div_at``, ``div_en``, ``div_cand``), with the chunk's overflow,
   error, remaining and diverged counts.

The JAX step compares every pair of a trace's K*L successors
(``batch.py:238-240``) and expands all of them; this one expands only
the queue and deduplicates by hash, which gives the same sets.  A
plain PyTorch version of ``select`` and ``commit`` (sort and
``scatter_reduce`` amin in place of the hash) runs on CPU tensors and is
the kernels' yardstick on the card.

**Exactness.**  A step whose consistent successors exceed ``cand_cap``
is reported by the chunk; the host doubles the cap and redraws the
round from step 0, as a successor that fills its message table doubles
the table and redraws (no randomness: the redraw is exact).  Every
divergence the card reports is confirmed by the interpreter validator
(``host.validate_trace``) unless ``confirm=False``; a spec with no
next-state relation to interpret (a cfg-only binding) needs
``confirm=False``.  Validation tracks concrete states: the model is
built with an identity permutation table, so symmetry never folds two
candidates together.

Left out of the port, each waiting for its module: the dispatch window
(one chunk is in flight), rescue snapshots and resume, the run observer
and journal, the OOM ladder and ``run_validate_job``.
"""

from __future__ import annotations

import hashlib
import json
import time

import numpy as np
import torch

from .. import kernels
from ..core.values import TLAError
from ..device import resolve_device
from .host import ValidateResult, divergence_record, validate_trace

I32 = torch.int32
I64 = torch.int64

# the commit's reduction vector: traces x steps that overflowed the cap,
# that met a full message table, and at the chunk's last step the
# traces still running past it and those diverged
RED_OVF, RED_ERR, RED_REM, RED_DIV = range(4)


class ObservationUnsupported(TLAError):
    """The codec cannot express a trace observation as encoded-leaf
    comparisons: the caller should fall back to the interpreter
    validator (``host.host_validate_batch``)."""


def encode_obs(codec, tmpl, var, value):
    """Encode one pinned spec variable as ``{leaf_key: (mask, values)}``
    against the codec's state layout.  Codecs may provide their own
    ``encode_obs(var, value)`` hook; the default covers a scalar int or
    bool variable stored under its own leaf key.  Anything else raises
    :class:`ObservationUnsupported`."""
    hook = getattr(codec, "encode_obs", None)
    if hook is not None:
        return hook(var, value)
    if var not in tmpl:
        raise ObservationUnsupported(
            f"codec {type(codec).__name__} has no leaf for variable "
            f"{var!r} and no encode_obs hook")
    leaf = tmpl[var]
    if not isinstance(value, (bool, int, np.integer)):
        raise ObservationUnsupported(
            f"variable {var!r}: only scalar int/bool observations are "
            f"encodable without a codec encode_obs hook "
            f"(got {type(value).__name__})")
    vals = np.full(leaf.shape, int(value), leaf.dtype)
    # an observation that does not round-trip through the leaf dtype
    # would compare equal to the wrong encoded state: a false accept
    if int(vals.flat[0]) != int(value):
        raise ObservationUnsupported(
            f"variable {var!r}: observation {value!r} does not fit "
            f"the encoded leaf dtype {leaf.dtype}")
    return {var: (np.ones(leaf.shape, bool), vals)}


def traces_digest(traces):
    """Identity of a trace batch (the JAX package stamps it into rescue
    snapshots)."""
    h = hashlib.sha1()
    for t in traces:
        h.update(json.dumps(t.to_record(), sort_keys=True).encode())
    return h.hexdigest()[:16]


# ----------------------------------------------------------------------
# K16: the validation step
# ----------------------------------------------------------------------
def _queue(n, device):
    z = lambda: torch.zeros((n,), dtype=I32, device=device)
    return {"pidx": z(), "aid": z(), "lane": z()}


def select(en, alive, div_at, tlen, aid, lane_aid, lane_prm, K, s):
    """K16 wrapper, first entry.  ``en`` [T*K, L] bool guard matrix of
    the candidate rows, ``alive`` [T*K] bool, ``div_at``/``tlen``/``aid``
    [T] int32 (the event's action id, -1 = unobserved), ``lane_aid`` and
    ``lane_prm`` [L] int32 lane tables, step ``s``.  Returns the work
    queue (``pidx`` candidate row, ``aid`` action, ``lane`` its lane
    parameter [Q] int32) of the lanes enabled in live
    candidates of active traces (``s < tlen``, not diverged) whose action
    matches ``aid``, in (row, lane) order, and ``roff`` [T*K+1] int64,
    row r's items at ``roff[r]:roff[r+1]``."""
    if en.device.type == "cpu":
        return select_plain(en, alive, div_at, tlen, aid, lane_aid,
                            lane_prm, K, s)
    return _select_kernel(en, alive, div_at, tlen, aid, lane_aid, lane_prm,
                          K, s)


def _select_mask(en, alive, div_at, tlen, aid, lane_aid, K, s):
    act = (s < tlen) & (div_at < 0)                        # [T]
    a = aid.long()
    match = (a[:, None] < 0) | (lane_aid.long()[None, :] == a[:, None])
    m = en & alive[:, None]
    return m & (act[:, None] & match).repeat_interleave(K, dim=0)


def select_plain(en, alive, div_at, tlen, aid, lane_aid, lane_prm, K, s):
    m = _select_mask(en, alive, div_at, tlen, aid, lane_aid, K, s)
    roff = torch.zeros((m.shape[0] + 1,), dtype=I64, device=en.device)
    roff[1:] = torch.cumsum(m.sum(dim=1), 0)
    rows, lanes = m.nonzero(as_tuple=True)                  # row-major
    q = {"pidx": rows.to(I32), "aid": lane_aid[lanes].to(I32),
         "lane": lane_prm[lanes].to(I32)}
    return q, roff


def _select_kernel(en, alive, div_at, tlen, aid, lane_aid, lane_prm, K, s,
                   Q=None):
    """The queue's size is read from the card between the two launches
    (one host read a step) unless the caller gives it as ``Q``."""
    R, L = en.shape
    T = R // K
    ck = kernels.check
    args = (ck(en, "en", torch.bool, (R, L)),
            ck(alive, "alive", torch.bool, (R,)),
            ck(div_at, "div_at", I32, (T,)), ck(tlen, "tlen", I32, (T,)),
            ck(aid, "aid", I32, (T,)),
            ck(lane_aid, "lane_aid", I32, (L,)), R, K, L, int(s))
    cnt = torch.empty((R,), dtype=I32, device=en.device)
    kernels.launch("validate_select", "tpuvsr_vstep_count", *args,
                   cnt.data_ptr(), kernels.stream_of(en))
    roff = torch.zeros((R + 1,), dtype=I64, device=en.device)
    roff[1:] = torch.cumsum(cnt, 0, dtype=I64)
    if Q is None:
        Q = int(roff[-1])
    q = _queue(Q, en.device)
    if Q:
        kernels.launch("validate_select", "tpuvsr_vstep_fill", *args,
                       ck(lane_prm, "lane_prm", I32, (L,)),
                       ck(roff, "roff", I64, (R + 1,)),
                       q["pidx"].data_ptr(), q["aid"].data_ptr(),
                       q["lane"].data_ptr(), kernels.stream_of(en))
    return q, roff


def commit(st, roff, succ, en2, err, fp, en, o_lo, o_hi, obs_w, obs_v, s,
           last, step_end):
    """K16 wrapper, second entry: one step of every trace of the round.
    ``st`` holds the round's state, updated in place: ``cands`` [T*K, W]
    int32 candidate rows, ``alive`` [T*K] bool, ``div_at`` [T] int32
    (-1 = not diverged), ``div_en`` [T, L] bool, ``div_cand`` [T] int32,
    ``tlen`` [T] int32 and ``red`` [4] int64 (``RED_*``, summed over the
    chunk).  ``roff`` and the queue's successor rows ``succ`` [Q, W],
    ``en2`` [Q] bool, ``err`` [Q] int32 and fingerprints ``fp`` [Q, 4]
    int32 come from ``select`` and the model; ``en`` is the guard matrix
    (``div_en`` is its OR over the live candidates of a diverging
    trace).  The event's observations: trace t pins word ``obs_w[j]`` of
    the row to ``obs_v[j]`` for j in ``o_lo[t]:o_hi[t]``.  ``last`` adds
    the remaining (``tlen > step_end``) and diverged counts."""
    if en.device.type == "cpu":
        return commit_plain(st, roff, succ, en2, err, fp, en, o_lo, o_hi,
                            obs_w, obs_v, s, last, step_end)
    return _commit_kernel(st, roff, succ, en2, err, fp, en, o_lo, o_hi,
                          obs_w, obs_v, s, last, step_end)


def _obs_dense(o_lo, o_hi, obs_w, obs_v, T, W):
    """The observations of one step as [T, W] (mask, value) planes."""
    dev = obs_w.device
    n = (o_hi - o_lo).long()
    tr = torch.repeat_interleave(torch.arange(T, device=dev), n)
    j = (torch.arange(int(n.sum()), device=dev)
         - torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
         + torch.repeat_interleave(o_lo.long(), n))
    om = torch.zeros((T, W), dtype=torch.bool, device=dev)
    ov = torch.zeros((T, W), dtype=I32, device=dev)
    om[tr, obs_w[j].long()] = True
    ov[tr, obs_w[j].long()] = obs_v[j]
    return om, ov


def commit_plain(st, roff, succ, en2, err, fp, en, o_lo, o_hi, obs_w,
                 obs_v, s, last, step_end):
    cands, alive = st["cands"], st["alive"]
    div_at, tlen = st["div_at"], st["tlen"]
    T = div_at.shape[0]
    K = cands.shape[0] // T
    W, L = cands.shape[1], en.shape[1]
    dev = cands.device
    Q = succ.shape[0]
    # the trace of each queue item: its row's, the queue being row-major
    tq = torch.div(torch.searchsorted(roff, torch.arange(Q, device=dev),
                                      right=True) - 1, K,
                   rounding_mode="floor")
    om, ov = _obs_dense(o_lo, o_hi, obs_w, obs_v, T, W)
    match = ((succ == ov[tq]) | ~om[tq]).all(dim=1) & en2
    errf = err != 0
    ok = match & ~errf
    errhit = torch.zeros((T,), dtype=torch.bool, device=dev)
    errhit[tq[match & errf]] = True
    # first occurrence of each (trace, fingerprint) among the ok items
    idx = torch.arange(Q, device=dev)
    key = torch.cat([tq[:, None], fp.long() & 0xFFFFFFFF], dim=1)[ok]
    uniq = torch.zeros((Q,), dtype=torch.bool, device=dev)
    if key.shape[0]:
        _u, inv = torch.unique(key, dim=0, return_inverse=True)
        first = torch.full((int(inv.max()) + 1,), Q, dtype=I64, device=dev)
        first.scatter_reduce_(0, inv, idx[ok], "amin")
        uniq[idx[ok][first[inv] == idx[ok]]] = True
    n_new = torch.zeros((T,), dtype=I64, device=dev)
    n_new.index_add_(0, tq[uniq], torch.ones_like(tq[uniq]))
    start = torch.cumsum(n_new, 0) - n_new
    rank = torch.cumsum(uniq.long(), 0) - 1 - start[tq]
    keep = uniq & (rank < K)
    act = (s < tlen) & (div_at < 0)
    upd = act & (n_new > 0)
    div_now = act & (n_new == 0)
    st["red"][RED_OVF] += int((act & (n_new > K)).sum())
    st["red"][RED_ERR] += int((act & errhit).sum())
    al = alive.view(T, K)
    st["div_cand"][:] = torch.where(div_now, al.sum(dim=1).to(I32),
                                    st["div_cand"])
    st["div_en"][:] = torch.where(
        div_now[:, None], (en.view(T, K, L) & al[:, :, None]).any(dim=1),
        st["div_en"])
    div_at[:] = torch.where(div_now, torch.full_like(div_at, int(s)),
                            div_at)
    new_c = torch.zeros_like(cands)
    new_al = torch.zeros_like(alive)
    dest = tq[keep] * K + rank[keep]
    new_c[dest] = succ[keep]
    new_al[dest] = True
    rows = upd.repeat_interleave(K)
    cands[rows] = new_c[rows]
    alive[rows] = new_al[rows]
    if last:
        st["red"][RED_REM] += int(((div_at < 0) & (tlen > step_end)).sum())
        st["red"][RED_DIV] += int((div_at >= 0).sum())
    return st


def _commit_kernel(st, roff, succ, en2, err, fp, en, o_lo, o_hi, obs_w,
                   obs_v, s, last, step_end):
    cands = st["cands"]
    T = st["div_at"].shape[0]
    R, W = cands.shape
    K = R // T
    L = en.shape[1]
    Q = succ.shape[0]
    ck = kernels.check
    dev = cands.device
    if Q and fp.data_ptr() % 16:
        raise ValueError("fp: the kernel reads 16-byte rows; expected an "
                         "aligned tensor")
    # per-item scratch: a hash table of 2 slots an item (each trace's
    # items own slots 2*roff[tK] .. 2*roff[(t+1)K]), the item flags, the
    # queue index of each kept rank and each trace's kept count
    table = torch.empty((max(2 * Q, 1),), dtype=I32, device=dev)
    flag = torch.empty((max(Q, 1),), dtype=torch.uint8, device=dev)
    sel = torch.empty((R,), dtype=I32, device=dev)
    kept = torch.empty((T,), dtype=I32, device=dev)
    kernels.launch(
        "validate_commit", "tpuvsr_vstep_commit", T, K, W, L, int(s),
        int(last), int(step_end), ck(roff, "roff", I64, (R + 1,)),
        ck(succ, "succ", I32, (Q, W)) if Q else None,
        ck(en2, "en2", torch.bool, (Q,)) if Q else None,
        ck(err, "err", I32, (Q,)) if Q else None,
        ck(fp, "fp", I32, (Q, 4)) if Q else None,
        ck(en, "en", torch.bool, (R, L)),
        ck(o_lo, "o_lo", I32, (T,)), ck(o_hi, "o_hi", I32, (T,)),
        ck(obs_w, "obs_w", I32), ck(obs_v, "obs_v", I32),
        ck(cands, "cands", I32, (R, W)),
        ck(st["alive"], "alive", torch.bool, (R,)),
        ck(st["div_at"], "div_at", I32, (T,)),
        ck(st["div_en"], "div_en", torch.bool, (T, L)),
        ck(st["div_cand"], "div_cand", I32, (T,)),
        ck(st["tlen"], "tlen", I32, (T,)), table.data_ptr(),
        flag.data_ptr(), sel.data_ptr(), kept.data_ptr(),
        ck(st["red"], "red", I64, (4,)),
        kernels.stream_of(cands))
    return st


# ----------------------------------------------------------------------
# the validator
# ----------------------------------------------------------------------
class BatchValidator:
    """The trace-validation engine (module docstring).

    ``batch`` traces run a round; ``cand_cap`` is the per-trace
    candidate-set bound (doubled on overflow); ``chunk_steps`` the steps
    between two host reads of the chunk's flags (the queue's size is
    read once a step besides); ``model_factory(spec,
    max_msgs=..) -> (codec, kernel)`` (default the registry's hand
    kernels, which take an identity permutation table); ``confirm=False``
    skips the interpreter's confirmation of each divergence.  ``spec``
    needs ``cfg``, ``init_states()`` (interpreter states, which the
    traces' initial observations select from) and, to confirm,
    ``successors``: an ``engine/spec.SpecModel``.  Runs on CUDA unless
    ``device`` says otherwise."""

    def __init__(self, spec, batch=1024, chunk_steps=8, cand_cap=4,
                 max_msgs=None, model_factory=None, confirm=True, log=None,
                 device=None):
        from ..models import registry
        self.device = resolve_device(device)
        self._model_factory = model_factory or registry.make_model
        if confirm and not callable(getattr(spec, "successors", None)):
            raise TLAError(
                "confirm=True needs a spec whose next-state relation the "
                "interpreter can run (an engine/spec.SpecModel); this spec "
                "has none, so pass confirm=False to validate without the "
                "interpreter's confirmation")
        if cand_cap < 1:
            raise ValueError(f"cand_cap must be >= 1 (got {cand_cap})")
        if batch < 1:
            raise ValueError(f"batch must be >= 1 (got {batch})")
        self.spec = spec
        self.batch = int(batch)
        self.chunk = int(chunk_steps)
        self.confirm = bool(confirm)
        self.K = int(cand_cap)
        self._log = log
        self._obs_checked = None
        self.counters = {}
        # candidate-set sizes after each event, by trace id (the last
        # round's redraw), and the largest
        self.sizes = {}
        self._build(max_msgs)

    def log(self, msg):
        if self._log:
            self._log(f"validate: {msg}")

    def _count(self, what, by=1):
        self.counters[what] = self.counters.get(what, 0) + by

    # -- construction --------------------------------------------------
    def _build(self, max_msgs):
        """(Re)build codec and kernel for a message-table bound."""
        self._max_msgs = max_msgs
        self.codec, self.kern = self._model_factory(self.spec,
                                                    max_msgs=max_msgs)
        kern, dev = self.kern, self.device
        self.pk = kern.pk
        st0 = next(iter(self.spec.init_states()))
        self._tmpl = {k: np.asarray(v)
                      for k, v in self.codec.encode(st0).items()}
        self._split = {k: (a, e) for k, _s, a, e in self.pk._splits}
        missing = set(self._tmpl) ^ set(self._split)
        if missing:
            raise TLAError(f"the codec's encoded leaves and the packing "
                           f"layout's planes differ: {sorted(missing)}")
        self._init_enc = None
        self.W = self.pk.lanes
        self._lane_aid = torch.as_tensor(kern.lane_action, dtype=I32,
                                         device=dev)
        self._lane_prm = torch.as_tensor(kern.lane_param, dtype=I32,
                                         device=dev)
        self.L = int(self._lane_aid.shape[0])
        self._k10 = hasattr(kern, "successors")
        self._inv_mask = kern.invariant_mask([]) if self._k10 else None
        self._incremental = hasattr(kern, "parent_parts")

    def _flat(self, enc):
        """One encoded state (numpy leaves) -> its flat row."""
        return np.concatenate([np.asarray(enc[k], np.int32).reshape(-1)
                               for k, _s, _a, _e in self.pk._splits])

    # -- host-side encoding --------------------------------------------
    def _init_states_enc(self):
        if self._init_enc is None:
            states = list(self.spec.init_states())
            self._init_enc = (states,
                              [self._flat(self.codec.encode(st))
                               for st in states])
        return self._init_enc

    def check_observations(self, traces):
        """Fail fast (``ObservationUnsupported``, or ``TLAError`` for an
        action the kernel has no lane for) if any observation in
        ``traces`` cannot be encoded against this codec, before any
        device time."""
        for t in traces:
            for k, v in t.init.items():
                encode_obs(self.codec, self._tmpl, k, v)
            for ev in t.events:
                if ev.action is not None and \
                        ev.action not in self.kern.action_names:
                    raise TLAError(
                        f"trace {t.tid}: action {ev.action!r} has no "
                        f"kernel lane (spec actions: "
                        f"{list(self.kern.action_names)})")
                for k, v in ev.vars.items():
                    encode_obs(self.codec, self._tmpl, k, v)
        self._obs_checked = traces

    def _obs_words(self, ev):
        """The flat (word, value) pairs an event pins, sorted by word."""
        words = {}
        for var, val in ev.vars.items():
            for k, (m, v) in encode_obs(self.codec, self._tmpl, var,
                                        val).items():
                a = self._split[k][0]
                m = np.asarray(m, bool).reshape(-1)
                v = np.broadcast_to(np.asarray(v), m.shape).reshape(-1)
                for j in np.nonzero(m)[0]:
                    words[a + int(j)] = int(v[j])
        return sorted(words.items())

    def _encode_round(self, rtraces):
        """Host arrays of one round: the initial candidates (their slots
        ``init_idx`` in the round's [T*K] rows and their flat rows
        ``init_rows``), lengths, the action observations and the variable
        observations as (word, value) lists by (trace, step).  Returns ``(arrays, pre_div, S)``;
        ``pre_div`` holds the traces whose initial observation matches no
        initial state (they never reach the card), S the round's step
        count.  Grows ``cand_cap`` first when an initial set alone
        exceeds it."""
        from .host import _obs_matches
        states, encs = self._init_states_enc()
        init_sets = [[j for j, st in enumerate(states)
                      if _obs_matches(st, t.init)] for t in rtraces]
        need = max([len(x) for x in init_sets] or [1])
        if need > self.K:
            while self.K < need:
                self.K *= 2
            self.log(f"initial candidate sets need {need} slots; growing "
                     f"cand_cap to {self.K}")
        T, K, W = len(rtraces), self.K, self.W
        S = max(max([len(t.events) for t in rtraces] or [0]), 1)
        init_idx, init_rows = [], []
        tlen = np.zeros((T,), np.int32)
        aid_obs = np.full((T, S), -1, np.int32)
        ptr = np.zeros((T, S + 1), np.int32)
        ow, ovals = [], []
        pre_div = {}
        names = list(self.kern.action_names)
        for i, t in enumerate(rtraces):
            if not init_sets[i]:
                pre_div[i] = True
            else:
                tlen[i] = len(t.events)
                for c, j in enumerate(init_sets[i]):
                    init_idx.append(i * K + c)
                    init_rows.append(encs[j])
            for s in range(S):
                ptr[i, s] = len(ow)
                if s < tlen[i]:
                    ev = t.events[s]
                    if ev.action is not None:
                        aid_obs[i, s] = names.index(ev.action)
                    for w, v in self._obs_words(ev):
                        ow.append(w)
                        ovals.append(v)
            ptr[i, S] = len(ow)
        arrays = {"init_idx": np.asarray(init_idx, np.int64),
                  "init_rows": np.asarray(init_rows, np.int32).reshape(-1, W),
                  "tlen": tlen, "aid_obs": aid_obs, "ptr": ptr,
                  "obs_w": np.asarray(ow, np.int32),
                  "obs_v": np.asarray(ovals, np.int32)}
        return arrays, pre_div, S

    def _round_state(self, arrays):
        """The round's state (``commit``'s ``st``) and observations on the
        device: the initial candidates scattered into zero rows, no
        divergence yet; ``self.hist`` the per-step candidate counts."""
        dev = self.device
        T, S = arrays["aid_obs"].shape
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        idx = t(arrays["init_idx"])
        st = {"cands": torch.zeros((T * self.K, self.W), dtype=I32,
                                   device=dev),
              "alive": torch.zeros((T * self.K,), dtype=torch.bool,
                                   device=dev),
              "div_at": torch.full((T,), -1, dtype=I32, device=dev),
              "div_en": torch.zeros((T, self.L), dtype=torch.bool,
                                    device=dev),
              "div_cand": torch.zeros((T,), dtype=I32, device=dev),
              "tlen": t(arrays["tlen"]),
              "red": torch.zeros((4,), dtype=I64, device=dev)}
        st["cands"][idx] = t(arrays["init_rows"])
        st["alive"][idx] = True
        obs = {"aid": t(arrays["aid_obs"]), "ptr": t(arrays["ptr"]),
               "obs_w": t(arrays["obs_w"]), "obs_v": t(arrays["obs_v"])}
        self.hist = torch.zeros((T, S), dtype=I32, device=dev)
        return st, obs

    # -- one step ------------------------------------------------------
    def _guards(self, flat):
        kern = self.kern
        if hasattr(kern, "guard_matrix"):
            return kern.guard_matrix(flat)[0]
        st = self.pk.unflatten(flat)
        return torch.cat([g(st) for g in kern._guard_fns()], dim=1)

    def _successors(self, flat, q):
        """(succ [Q, W], en2 [Q], err [Q], fp [Q, 4]) of the queue ``q``
        over the candidate rows ``flat``."""
        kern = self.kern
        Q = q["pidx"].shape[0]
        if self._k10:
            o = kern.successors(flat, q["pidx"], q["aid"], q["lane"],
                                self._inv_mask)
        else:
            # a model without a successor kernel: each action's function
            # on its items, scattered back to queue order
            o = {"succ": torch.zeros((Q, self.W), dtype=I32,
                                     device=flat.device),
                 "en2": torch.zeros((Q,), dtype=torch.bool,
                                    device=flat.device),
                 "err": torch.zeros((Q,), dtype=I32, device=flat.device)}
            for a, fn in enumerate(kern._action_fns()):
                ix = (q["aid"] == a).nonzero(as_tuple=True)[0]
                if ix.numel() == 0:
                    continue
                succ, en2 = fn(self.pk.unflatten(flat[q["pidx"][ix].long()]),
                               q["lane"][ix].long())
                clean = {k: v for k, v in succ.items()
                         if not k.startswith("_")}
                o["succ"][ix] = self.pk.flatten(clean)
                o["en2"][ix] = en2
                o["err"][ix] = clean["err"].reshape(ix.shape[0], -1).ne(
                    0).any(dim=1).to(I32)
        if self._incremental:
            fp = kern.fingerprint_incremental(
                o["succ"], o["ri"], o["ts"], q["pidx"], flat,
                kern.parent_parts(flat))
        else:
            fp = kern.fingerprint(o["succ"].contiguous())
        return o["succ"], o["en2"], o["err"], fp

    def _step(self, st, dev_obs, s, last, step_end):
        """Advance every trace of the round through event ``s``."""
        self._count("steps")
        en = self._guards(st["cands"])
        q, roff = select(en, st["alive"], st["div_at"], st["tlen"],
                         dev_obs["aid"][:, s].contiguous(), self._lane_aid,
                         self._lane_prm, self.K, s)
        Q = q["pidx"].shape[0]
        self._count("queue_items", Q)
        if Q:
            succ, en2, err, fp = self._successors(st["cands"], q)
        else:
            dev = st["cands"].device
            succ = torch.zeros((0, self.W), dtype=I32, device=dev)
            en2 = torch.zeros((0,), dtype=torch.bool, device=dev)
            err = torch.zeros((0,), dtype=I32, device=dev)
            fp = torch.zeros((0, 4), dtype=I32, device=dev)
        commit(st, roff, succ, en2, err, fp, en,
               dev_obs["ptr"][:, s].contiguous(),
               dev_obs["ptr"][:, s + 1].contiguous(), dev_obs["obs_w"],
               dev_obs["obs_v"], s, last, step_end)
        self.hist[:, s] = st["alive"].view(-1, self.K).sum(dim=1)

    # -- one round -----------------------------------------------------
    def _run_round(self, rtraces, deadline):
        """Validate one round to completion, redrawing from step 0 on a
        growth (candidate cap, message table).  Returns ``(div_at,
        div_en, div_cand, pre_div, stopped)`` as host arrays."""
        while True:
            arrays, pre_div, S = self._encode_round(rtraces)
            st, dev_obs = self._round_state(arrays)
            grown, stopped = False, False
            step = 0
            while step < S:
                st["red"].zero_()
                end = step + self.chunk
                for s in range(step, min(end, S)):
                    self._step(st, dev_obs, s, s == min(end, S) - 1, end)
                ovf, err, rem, _n_div = st["red"].tolist()
                self._count("host_reads")
                if err:
                    old = self.codec.shape.MAX_MSGS
                    self._build(old * 2)
                    self._count("grow_message_table")
                    self.log(f"message table grown to "
                             f"{self.codec.shape.MAX_MSGS} slots; "
                             f"redrawing the round")
                    grown = True
                    break
                if ovf:
                    self.K *= 2
                    self._count("grow_cand_cap")
                    self.log(f"candidate set overflowed; cand_cap grown "
                             f"to {self.K}; redrawing the round")
                    grown = True
                    break
                step = end
                if rem == 0:
                    break
                if deadline is not None and time.time() > deadline:
                    stopped = True
                    break
            if not grown:
                break
        div_at = st["div_at"].cpu().numpy()
        hist = self.hist.cpu().numpy()
        for i, tr in enumerate(rtraces):
            n = len(tr.events) if div_at[i] < 0 else int(div_at[i])
            self.sizes[tr.tid] = [int(x) for x in hist[i, :n]]
        return (div_at, st["div_en"].cpu().numpy(),
                st["div_cand"].cpu().numpy(), pre_div, stopped)

    # -- divergence reporting ------------------------------------------
    def _enabled_from_lanes(self, mask):
        """Lane mask -> the sorted spec-side enabled set, aggregated to
        the action level (the interpreter validator's record shape)."""
        names = self.kern.action_names
        la = np.asarray(self.kern.lane_action)
        locs = {a.name: a.location
                for a in getattr(self.spec, "actions", ())}
        seen = sorted({names[int(la[ln])]
                       for ln in np.nonzero(np.asarray(mask))[0]})
        return [{"action": a, "location": locs.get(a)} for a in seen]

    def _commit_round(self, res, rtraces, div_at, div_en, div_cand,
                      pre_div):
        for i, t in enumerate(rtraces):
            res.traces_checked += 1
            if i in pre_div:
                res.divergences.append(divergence_record(
                    t, validate_trace(self.spec, t)))
                continue
            if div_at[i] < 0:
                res.accepted += 1
                continue
            step = int(div_at[i])
            ev = (t.events[step].to_record()
                  if step < len(t.events) else {})
            rec = {"trace": t.tid, "step": step, "event": ev,
                   "enabled": self._enabled_from_lanes(div_en[i]),
                   "candidates": int(div_cand[i])}
            if self.confirm:
                verdict = validate_trace(self.spec, t)
                if verdict.ok or verdict.diverged_at != step:
                    said = ("accepted" if verdict.ok
                            else f"event {verdict.diverged_at}")
                    raise TLAError(
                        f"device/interpreter divergence: the batch "
                        f"validator reports trace {t.tid} diverging at "
                        f"event {step}, but the interpreter says {said}")
                if verdict.violated_invariant:
                    rec["invariant"] = verdict.violated_invariant
                    rec["invariant_step"] = verdict.violated_at
            res.divergences.append(rec)

    # -- the entry -----------------------------------------------------
    def run(self, traces, *, log=None, max_seconds=None) -> ValidateResult:
        """Validate ``traces`` (a list of :class:`Trace`) in rounds of
        ``batch``; the divergence records are those of the interpreter
        validator, in trace order."""
        if log is not None:
            self._log = self._log or log
        if self._obs_checked is not traces:
            self.check_observations(traces)
        res = ValidateResult(batch=self.batch)
        t0 = time.time()
        deadline = (t0 + max_seconds) if max_seconds else None
        base = 0
        while base < len(traces):
            rtraces = traces[base:base + self.batch]
            div_at, div_en, div_cand, pre_div, stopped = \
                self._run_round(rtraces, deadline)
            if stopped:
                # a half-scanned round is neither accepted nor diverged
                res.error = "deadline"
                break
            self._commit_round(res, rtraces, div_at, div_en, div_cand,
                               pre_div)
            base += len(rtraces)
        res.ok = not res.divergences
        res.elapsed = time.time() - t0
        res.metrics = {
            "counters": dict(self.counters),
            "gauges": {"cand_cap": self.K,
                       "max_msgs": getattr(getattr(self.codec, "shape",
                                                   None), "MAX_MSGS", None),
                       "max_candidates": max(
                           [max(v) for v in self.sizes.values() if v]
                           or [0])}}
        return res


def batch_validate(spec, traces, *, batch=1024, chunk_steps=8, cand_cap=4,
                   max_msgs=None, confirm=True, model_factory=None, log=None,
                   max_seconds=None, device=None) -> ValidateResult:
    """One-call batched validation."""
    bv = BatchValidator(spec, batch=batch, chunk_steps=chunk_steps,
                        cand_cap=cand_cap, max_msgs=max_msgs,
                        confirm=confirm, model_factory=model_factory,
                        log=log, device=device)
    return bv.run(traces, log=log, max_seconds=max_seconds)


def validate_result_summary(res):
    """ValidateResult -> a JSON-able summary."""
    return {"ok": bool(res.ok), "traces": int(res.traces_checked),
            "accepted": int(res.accepted),
            "divergences": list(res.divergences or []),
            "first_divergence": res.first_divergence,
            "error": res.error,
            "elapsed_s": round(float(res.elapsed or 0.0), 3)}
