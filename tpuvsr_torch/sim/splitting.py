"""Importance splitting for the walker fleet (a port of
``tpuvsr/sim/splitting.py``).

At each chunk boundary every live walker's state is fingerprinted (K3,
``VSRKernel.fingerprint``; with a ``CanonSpec`` bound, of the state's
canonical image, K9 then K3, so novelty counts symmetry orbits) and
inserted into a device-resident
seen-set (the port's FPSet, K1 ``insert_core``).  A walker that landed
on a never-seen state earns novelty; one that landed where the fleet
has been decays toward zero.  The lowest-scoring fraction of the live
population is killed and its slots respawned as clones of the
highest-scoring walkers; clones inherit their source's recorded history
and init state, so a violating clone still replays into a complete
counterexample.  ``kern.hunt_score`` can be blended in with
``hunt_beta``.

The novelty EMA and the kill/clone selection run on the host in float64
numpy, exactly as in JAX: a pure sort over ``(score, slot)``.

Which lane is fresh.  The JAX insert runs on the CPU, where among lanes
with EQUAL new fingerprints the scatter's last writer (the highest lane)
wins and only it is fresh; its novelty is what the kill/clone order
sees.  K1 on the card names an arbitrary winner among equal
fingerprints, so the batch is first reduced to the last occurrence of
each fingerprint (K2 on the reversed batch), on every device: the fresh
mask is then JAX's on the card and on the CPU alike.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine import fpset


class NoveltySplitter:
    """Kill-and-clone resampler over a fingerprint-novelty score.

    ``frac``: fraction of the live population killed at each chunk
    boundary (the same count is cloned from the top); ``decay``:
    novelty EMA decay per boundary; ``hunt_beta``: weight of
    ``kern.hunt_score`` blended into the score (0 = pure novelty).  The
    seen-set starts at ``CAPACITY`` slots and grows on overflow."""

    CAPACITY = 1 << 14

    def __init__(self, frac=0.25, decay=0.5, hunt_beta=0.0):
        self.frac = float(frac)
        self.decay = float(decay)
        self.hunt_beta = float(hunt_beta)
        self.table = None
        self.novelty = None          # host float64 [W]
        self.fresh_total = 0
        self.inserted_total = 0
        self.best = 0.0
        self._kern = None
        self._fp = None
        self._score = None

    def bind(self, kern, canon=None):
        """(Re)bind to the fleet's kernel after a rebuild; with a
        ``CanonSpec`` the seen-set holds the fingerprints of canonical
        images (``canon.fingerprint_fn``), as in JAX."""
        self._kern = kern
        self._fp = (kern.fingerprint if canon is None
                    else canon.fingerprint_fn(kern))
        self._score = (kern.hunt_score
                       if self.hunt_beta > 0.0 and hasattr(kern, "hunt_score")
                       else None)

    def reset(self, w_pad, device):
        """Round start: novelty zeroes; the seen-set persists (novelty is
        relative to everything the fleet has ever seen)."""
        self.novelty = np.zeros((w_pad,), np.float64)
        if self.table is None:
            self.table = fpset.empty_table(self.CAPACITY, device)

    def gauges(self):
        eff = (self.fresh_total / self.inserted_total
               if self.inserted_total else 0.0)
        return {"novelty_best": round(self.best, 4),
                "split_efficiency": round(eff, 4)}

    # -- the split ----------------------------------------------------
    def observe(self, states, alive):
        """Insert the live walkers' fingerprints (``states``: flat
        [W, lanes] rows); returns the [W] bool numpy mask of walkers
        that landed on a never-seen state."""
        fps = self._fp(states)
        mask = alive & fpset.dedup_keep(fps.flip(0).contiguous(),
                                        alive.flip(0).contiguous()).flip(0)
        fresh = torch.zeros_like(mask)
        pending = mask
        while True:
            # the insert is in place: lanes that won are in the table;
            # after a probe overflow the rest retry in a grown table
            # (a lane that resolved as a duplicate resolves so again)
            _t, won, ovf = fpset.insert_core(self.table, fps, pending)
            fresh = fresh | won
            if not bool(ovf):
                break
            pending = pending & ~won
            self.table = fpset.grow(self.table)
        return fresh.cpu().numpy()

    def resample(self, states, alive, hists, init_states):
        """Observe the population (flat [W, lanes] states), update
        novelty, kill/clone.  Returns ``(states, alive, hists,
        init_states)`` with the killed slots
        overwritten by clones.  Walkers with an event (violated/dead)
        are not alive: never killed, never cloned from."""
        w_pad = self.novelty.shape[0]
        alive_h = alive.cpu().numpy()
        fresh = self.observe(states, alive)
        self.fresh_total += int(fresh[alive_h].sum())
        self.inserted_total += int(alive_h.sum())
        self.novelty = self.novelty * self.decay + fresh
        score = self.novelty.copy()
        if self._score is not None:
            score += self.hunt_beta * self._score(
                self._kern.pk.unflatten(states)).cpu().numpy().astype(
                np.float64)
        n_el = int(alive_h.sum())
        k = min(int(self.frac * n_el), n_el // 2)
        self.best = max(self.best,
                        float(score[alive_h].max()) if n_el else 0.0)
        if k < 1 or n_el < 2:
            return states, alive, hists, init_states
        slots = np.nonzero(alive_h)[0]
        order = slots[np.lexsort((slots, score[slots]))]
        kills = order[:k]
        sources = order[-k:][::-1]   # best walker seeds the worst slot
        sel = np.arange(w_pad)
        sel[kills] = sources
        self.novelty[kills] = self.novelty[sources]
        sel_t = torch.as_tensor(sel, device=alive.device)
        states = states[sel_t]
        hists = [(ha[:, sel_t], hp[:, sel_t]) for ha, hp in hists]
        init_states = {key: np.asarray(v)[sel]
                       for key, v in init_states.items()}
        return states, alive[sel_t], hists, init_states
