"""Replay of a recorded walk (a copy of
``tpuvsr/engine/device_sim.py:materialize_walk``).

``DeviceSimulator``, the JAX package's single-device scan simulator, is
not ported (ROADMAP.md); the walker fleet (``sim/fleet.py``) is the
port's simulator and uses this replay for its counterexamples.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.values import TLAError
from .trace import TraceEntry


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
