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


def materialize_walk(kern, codec, st0, aids, prms, n_steps, device):
    """Re-execute a recorded (action id, lane param) choice sequence
    from the dense state ``st0`` (numpy arrays) through the kernel's
    action functions on ``device`` into a TRACE-format counterexample.
    Stops at ``n_steps`` or the first ``-1`` action (a frozen walker);
    raises when a recorded lane is not enabled.  The cfg-only binding
    has no action locations, so ``location`` is None."""
    fns = kern._action_fns()
    st = {k: torch.as_tensor(np.asarray(v))[None].to(device)
          for k, v in st0.items()}

    def decode(s):
        return codec.decode({k: v[0].cpu().numpy() for k, v in s.items()})

    out = [TraceEntry(position=1, action_name=None, location=None,
                      state=decode(st))]
    for i in range(min(int(n_steps), len(aids))):
        aid = int(aids[i])
        if aid < 0:
            break
        succ, en = fns[aid](st, torch.tensor([int(prms[i])],
                                             device=device))
        if not bool(en[0]):
            raise TLAError(f"replay chose a disabled lane (step {i + 1}, "
                           f"{kern.action_names[aid]} lane {int(prms[i])})")
        st = {k: v for k, v in succ.items() if not k.startswith("_")}
        out.append(TraceEntry(position=i + 2,
                              action_name=kern.action_names[aid],
                              location=None, state=decode(st)))
    return out
