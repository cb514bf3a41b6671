"""tpuvsr_torch.sim — the walker-fleet simulator on one device (a port
of ``tpuvsr/sim``).

* ``rng.py`` — ``jax.random``'s threefry draws in plain PyTorch, and
  the wrappers of kernel K5 (the fleet's draw and lane choice);
* ``fleet.py`` — :class:`FleetSimulator`, with the seed contract of the
  JAX fleet (walk ``i`` is a pure function of ``(seed, i)``);
* ``splitting.py`` — importance splitting over a fingerprint-novelty
  seen-set;
* ``defect_hunt.py`` — the guided hunt for the state-transfer defect
  (``python -m tpuvsr_torch.sim.defect_hunt``).
"""

from __future__ import annotations

from .fleet import FleetSimulator, fleet_simulate
from .splitting import NoveltySplitter

__all__ = ["FleetSimulator", "fleet_simulate", "NoveltySplitter"]
