"""Defect-reproduction hunt: find the state-transfer data-loss violation
of ``examples/VSR_defect.cfg`` with the walker fleet (the counterpart of
``scripts/defect_hunt.py``).

Weighted two-stage action sampling plus swarm scheduler noise, and in
guided mode fingerprint-novelty importance splitting with the VSR
kernel's ``hunt_score`` blended in.

Usage: python -m tpuvsr_torch.sim.defect_hunt [walkers] [depth]
       [max_seconds] [seed] [swarm_sigma] [mode]

Modes:
  uniform  — TLC's uniform-over-successors draw (no action weighting)
  flat     — two-stage sampling, uniform over enabled ACTIONS
  weighted — two-stage sampling with weights biased toward the defect
             path (SendGetState truncation + view changes)
  guided   — weighted + importance splitting

Prints the trace and one result JSON line (``backend`` is the card's
name); writes no file.  Runs on CUDA (``device="cpu"`` from Python for
the plain versions).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

from ..engine.spec import load_binding
from .fleet import FleetSimulator
from .splitting import NoveltySplitter

DEFECT_CFG = Path(__file__).resolve().parents[2] / "examples" / \
    "VSR_defect.cfg"

# Action weights biased toward the defect path: the violation needs view
# changes interleaved with the SendGetState truncation (VSR.tla:491-516)
# and the final ReceiveSV log wipe; unlisted actions weigh 1.
WEIGHTS = {
    "TimerSendSVC": 3.0,
    "SendGetState": 6.0,
    "SendDVC": 2.0,
    "SendSV": 2.0,
    "ReceiveSV": 2.0,
    "ReceiveClientRequest": 2.0,
}


def modes(sigma):
    return {
        "uniform": dict(action_weights=None, split=False, swarm=0.0),
        "flat": dict(action_weights={}, split=False, swarm=sigma),
        "weighted": dict(action_weights=WEIGHTS, split=False, swarm=sigma),
        "guided": dict(action_weights=WEIGHTS, split=True, swarm=sigma),
    }


def make_fleet(walkers=4096, sigma=1.0, mode="guided", device=None,
               log=None):
    """The hunt's fleet: chunks of 8 steps, MAX_MSGS 48, and in guided
    mode ``NoveltySplitter(frac=0.25, decay=0.5, hunt_beta=1.5)``."""
    mcfg = modes(sigma)[mode]
    split = (NoveltySplitter(frac=0.25, decay=0.5, hunt_beta=1.5)
             if mcfg["split"] else None)
    return FleetSimulator(load_binding(str(DEFECT_CFG), "VSR"), walkers=walkers,
                          chunk_steps=8, max_msgs=48,
                          action_weights=mcfg["action_weights"],
                          swarm_sigma=mcfg["swarm"], split=split,
                          device=device, log=log)


def hunt(walkers=4096, depth=48, max_seconds=600.0, seed=0, sigma=1.0,
         mode="guided", device=None, log=None):
    """Run the hunt; returns (result dict or None, SimResult, fleet).
    The dict is the JSON line ``scripts/defect_hunt.py`` prints, with
    ``backend`` the device's name."""
    sim = make_fleet(walkers, sigma, mode, device, log)
    t0 = time.time()
    res = sim.run(num=10 ** 9, depth=depth, seed=seed,
                  max_seconds=max_seconds)
    ttv = time.time() - t0
    if not res.trace:
        return None, res, sim
    mcfg = modes(sigma)[mode]
    backend = (torch.cuda.get_device_name(sim.device)
               if sim.device.type == "cuda" else "cpu")
    result = {"time_to_violation_s": round(ttv, 1),
              "violated": res.violated_invariant,
              "engine": "fleet-sim",
              "walkers": walkers, "mesh_devices": 1,
              "depth": depth, "seed": seed,
              "swarm_sigma": mcfg["swarm"],
              "split_enabled": bool(mcfg["split"]),
              "mode": mode,
              "walks": res.walks, "steps": res.steps,
              "trace_len": len(res.trace),
              "final_action": res.trace[-1].action_name,
              "backend": backend}
    return result, res, sim


def main(argv):
    walkers = int(argv[1]) if len(argv) > 1 else 4096
    depth = int(argv[2]) if len(argv) > 2 else 48
    max_seconds = float(argv[3]) if len(argv) > 3 else 600
    seed = int(argv[4]) if len(argv) > 4 else 0
    sigma = float(argv[5]) if len(argv) > 5 else 1.0
    mode = argv[6] if len(argv) > 6 else "guided"
    if mode not in modes(sigma):
        print(f"unknown mode {mode!r} (one of {sorted(modes(sigma))})",
              file=sys.stderr)
        return 2
    t0 = time.time()
    result, res, _sim = hunt(
        walkers, depth, max_seconds, seed, sigma, mode,
        log=lambda m: print(f"hunt: {m} ({time.time() - t0:.0f}s)",
                            file=sys.stderr))
    print(f"\nelapsed {res.elapsed:.1f}s, walks {res.walks}, "
          f"steps {res.steps}")
    print(f"ok={res.ok} violated={res.violated_invariant}")
    if result is not None:
        print(f"trace length {len(res.trace)}")
        for te in res.trace:
            print(f"  {te.position}: {te.action_name}")
        last = res.trace[-1].state
        print("final logs:", last["rep_log"])
        print("acked:", last["aux_client_acked"])
        print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
