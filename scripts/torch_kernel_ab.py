#!/usr/bin/env python3
"""Two builds of the VSR successors (K10, ``csrc/vsr_actions.cu``), the
batch dedup (K2, ``csrc/dedup.cu``), the fingerprint (K3,
``csrc/vsr_fingerprint.cu``) and the work-queue compaction (K7,
``csrc/compact.cu``) of the PyTorch/CUDA port, timed in turns on one
NVIDIA card.

``--other DIR`` holds another tree's ``vsr_actions.cu``, ``dedup.cu``,
``compact.cu``, ``vsr_fingerprint.cu`` and ``common.cuh`` (for example
a parent commit's, from ``git show``); they are built with the port's
nvcc flags into a temporary directory.  A build whose K2 entry point
wants its scratch on every call (before the one-block path) is called
through ``parent_dedup``, that wrapper as it was (the C signature is
the same; the script tells the two apart by the source).  The inputs are recorded once, with this checkout's kernels:
the defect config's ``run()`` to depth 10 (K3's parts and incremental
fingerprints, and the full one of the initial state), an eager
``run_fused()`` to depth 10 (K7; K10's and K2's fused queue; K6 and
K4's unpack at the tile's shape, [128, lanes]), an eager per-action
``run_fused()`` to depth 8 (K2's reversed batch), the shipped model's
symmetric ``run()`` to depth 9 (K3's full fingerprint of K9's canonical
images, K10's queue), the hunt's first round, eager (K10's step and
K2's splitter batch), as ``chip_smoke.py`` phases 3, 6a, 7a, 8a and 15
record them, and a ``run()`` of each family model's small cfg to depth
14 (its K3 calls, as phases 10a-13a record them); the hunt splitter's
full fingerprint is timed at its shape on random rows.  Then, for each
build in the order other, this, this, other:

* each kernel on its recorded input, held bit for bit against its plain
  version (K10 over the whole queue, fill entries included) and timed
  as ``chip_smoke.cuda_ms`` times it (K10 and the family's K3 after an
  L2 flush, as phases 7b and 10b-13a time them), beside
  ``torch.nonzero`` of K7's masked matrix and the ``torch.sort``
  lexsort of K2's batches;
* the walls of ``run()`` and ``run_fused()`` to depth 10 on the defect
  config and of ``run_fused()`` to depth 16 on the shipped model with
  symmetry on (the entry point's call, the engine built before; their
  levels held to ``chip_smoke``'s records), and one
  profiled quantum of each ``run_fused()``: busy share and device ms by
  kernel.

It prints the card's name and power limit, a line a measurement, and
writes everything to ``--out``::

    python3 scripts/torch_kernel_ab.py --other DIR --out FILE
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEMS = ("compact", "vsr_fingerprint", "vsr_actions", "dedup")
BFS = {"tile_size": 128, "chunk_tiles": 64, "fpset_capacity": 1 << 26,
       "device": "cuda"}
FAMILY_DEPTH = 14


def build_other(src, out_dir):
    """{stem: library} of ``src``'s sources of ``STEMS``."""
    from tpuvsr_torch import kernels
    procs = []
    for stem in STEMS:
        out = os.path.join(out_dir, f"lib{stem}.so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", src, "-o", out,
               os.path.join(src, f"{stem}.cu")]
        procs.append((stem, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {}
    for stem, out, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{stem}.cu:\n{log.decode(errors='replace')}")
        libs[stem] = kernels.load(out)
    return libs


def record(defect, shipped):
    """The recorded inputs: chip_smoke's Recorder over run(), its
    FusedRecorder over an eager run_fused() (with K10's queue, K2's
    batch and the tile-shape K6 and K4 unpack calls), K2's batch of an
    eager per-action run_fused(), its CanonRecorder over the symmetric
    run() (with K10's queue) and its HuntRecorder over the hunt's first
    round."""
    import chip_smoke as CS
    from tpuvsr_torch.engine.device_bfs import DeviceBFS
    rec, fused, canon = CS.Recorder(), CS.FusedRecorder(), CS.CanonRecorder()
    un = rec.install()
    DeviceBFS(defect, **BFS).run(max_depth=10)
    un()
    k10_fused, k10_shipped = CS.Recorder(), CS.Recorder()
    tile = TileRecorder(BFS["tile_size"])
    uns = [fused.install(), CS.record_actions(k10_fused), tile.install()]
    eng = DeviceBFS(defect, **BFS)
    eng.graphs = False
    eng.run_fused(max_depth=10)
    for u in reversed(uns):
        u()
    per_action = TileRecorder(BFS["tile_size"])
    un = per_action.install()
    eng = DeviceBFS(defect, commit="per-action", **BFS)
    eng.graphs = False
    eng.run_fused(max_depth=8)
    un()
    uns = [canon.install(), CS.record_actions(k10_shipped)]
    DeviceBFS(shipped, symmetry="auto", **BFS).run(max_depth=9)
    for u in reversed(uns):
        u()
    del eng
    hunt = record_hunt()
    import torch
    from tpuvsr_torch.models.registry import make_model
    from tpuvsr_torch.testing import fp_wide_case
    _c, hk = make_model(defect, max_msgs=48)
    rows = torch.as_tensor(fp_wide_case(hk, n=4096, T=1).succ,
                           device=BFS["device"])
    CS.need(torch.equal(hk.fingerprint(rows), hk.fingerprint_plain(rows)),
            "full differs from its plain version at the hunt's shape")
    return {**rec.calls, "compact": fused.calls["compact"],
            "vsr_fp_full_canon": canon.calls["vsr_fp_full"],
            "hunt_shape": (hk, rows),
            "vsr_actions_fused": k10_fused.calls["vsr_actions"],
            "vsr_actions_shipped": k10_shipped.calls["vsr_actions"],
            "vsr_actions_hunt": hunt.calls["vsr_actions"],
            "dedup_fused": tile.calls["dedup_batch"],
            "dedup_per_action": per_action.calls["dedup_batch"],
            "dedup_hunt": hunt.calls["dedup_batch"],
            "unpack_tile": tile.calls["unpack"],
            "guards_tile": tile.calls["vsr_guards"]}


class TileRecorder:
    """Keeps, during an eager run_fused(), the K2 call with the largest
    batch, and the K6 guard matrix and K4 unpack calls at the tile's
    shape (``tile`` rows) with the most enabled lanes and rows."""

    def __init__(self, tile):
        self.tile = tile
        self.calls = {}

    def keep(self, name, size, make):
        if size > self.calls.get(name, (-1, None))[0]:
            self.calls[name] = (size, make())

    def install(self):
        from tpuvsr_torch.engine import device_bfs as D
        from tpuvsr_torch.engine.pack import PackSpec
        from tpuvsr_torch.models.vsr_kernel import VSRKernel
        rec, T = self, self.tile
        ded, unpack, guards = D.dedup_keep, PackSpec.unpack, \
            VSRKernel.guard_matrix

        def p_dedup(fps, mask):
            rec.keep("dedup_batch", fps.shape[0],
                     lambda: (fps.clone(), mask.clone()))
            return ded(fps, mask)

        def p_unpack(self, packed, rows=None):
            if rows is not None and rows.shape[0] == T:
                rec.keep("unpack", 1, lambda: (self, packed.clone(),
                                               rows.clone()))
            return unpack(self, packed, rows)

        def p_guards(self, flat, out=None, halt=None):
            r = guards(self, flat, out, halt)
            if flat.shape[0] == T and not (halt is not None
                                           and bool(halt[0])):
                rec.keep("vsr_guards", int(r[0].sum()),
                         lambda: (self, flat.clone()))
            return r
        D.dedup_keep, PackSpec.unpack = p_dedup, p_unpack
        VSRKernel.guard_matrix = p_guards

        def uninstall():
            D.dedup_keep, PackSpec.unpack = ded, unpack
            VSRKernel.guard_matrix = guards
        return uninstall


def record_hunt():
    """chip_smoke's HuntRecorder over the hunt's first round, eager (as
    phase 6a records it): K10's step and K2's splitter batch."""
    import chip_smoke as CS
    import torch
    from tpuvsr_torch.sim import rng
    from tpuvsr_torch.sim.defect_hunt import make_fleet
    H = CS.HUNT
    rec = CS.HuntRecorder(H["walkers"])
    un = rec.install()
    sim = make_fleet(H["walkers"], H["sigma"], H["mode"], device="cuda")
    sim.graphs = False
    sim.run_round(base=0, active=H["walkers"], depth=H["depth"],
                  key=rng.prng_key(list(CS.HUNT_RECORD)[0], device="cuda"))
    torch.cuda.synchronize()
    un()
    return rec


def parent_dedup(fps, mask):
    """K2's wrapper before its one-block path: a scratch hash of at
    least 2n slots on every call (csrc/dedup.cu takes the same
    arguments)."""
    import torch
    from tpuvsr_torch import kernels
    n = fps.shape[0]
    keep = torch.empty((n,), dtype=torch.bool, device=fps.device)
    hcap = 64
    while hcap < 2 * n:
        hcap *= 2
    dev = fps.device
    hkeys = torch.empty((hcap, 4), dtype=torch.int32, device=dev)
    hstate = torch.empty((hcap,), dtype=torch.int32, device=dev)
    hmin = torch.empty((hcap,), dtype=torch.int32, device=dev)
    lane_slot = torch.empty((n,), dtype=torch.int32, device=dev)
    ck = kernels.check
    kernels.launch(
        "dedup_batch", "tpuvsr_dedup_batch",
        ck(fps, "fps", torch.int32, (n, 4)),
        ck(mask, "mask", torch.bool, (n,)), n, keep.data_ptr(),
        hkeys.data_ptr(), hstate.data_ptr(), hmin.data_ptr(), hcap,
        lane_slot.data_ptr(), kernels.stream_of(fps))
    return keep


def record_family():
    """{model: chip_smoke.ST03Recorder calls} of a run() of each family
    model's small cfg to depth FAMILY_DEPTH (the largest K3 calls: a
    tile's 128 parents and their successors)."""
    import chip_smoke as CS
    from tpuvsr_torch.engine.device_bfs import DeviceBFS
    from tpuvsr_torch.engine.spec import load_binding
    out = {}
    for module, cfg in CS.EDGE_LAYOUTS[1:]:
        rec = CS.ST03Recorder()
        un = rec.install()
        DeviceBFS(load_binding(cfg, module), **BFS).run(
            max_depth=FAMILY_DEPTH)
        un()
        out[module] = rec.calls
    return out


def family_times(family):
    """{model: {kernel: (ms, issue ms, timed_by)}} of each family
    model's K3 on its recorded calls (parts, incremental, and full on
    the incremental call's successors), each after an L2 flush as
    chip_smoke's phases 10b-13a time them, held against the plain
    versions first."""
    import torch
    import chip_smoke as CS
    out = {}
    for module, calls in family.items():
        names = next(v[1][0] for v in calls.values()).FP_KERNELS
        kern, flat = calls[names["parts"]][1]
        kern, *args = calls[names["incremental"]][1]
        succ = args[0]
        CS.need(all(torch.equal(a, b) for a, b in zip(
            kern.parent_parts(flat), kern.parent_parts_plain(flat)))
            and torch.equal(kern.fingerprint_incremental(*args),
                            kern.fingerprint_incremental_plain(*args))
            and torch.equal(kern.fingerprint(succ),
                            kern.fingerprint_plain(succ)),
            f"{module}: K3 differs from its plain version")
        evict = CS.l2_evict(flat.device)
        out[module] = {
            "shapes": [list(flat.shape), list(succ.shape)],
            "parts": CS.cuda_ms(lambda: kern.parent_parts(flat),
                                evict=evict),
            "incremental": CS.cuda_ms(
                lambda: kern.fingerprint_incremental(*args), evict=evict),
            "full": CS.cuda_ms(lambda: kern.fingerprint(succ), evict=evict)}
        del evict
    return out


def kernel_times(calls):
    """{row: (ms, issue ms, timed_by)} of K3, K7, K10, K2, K6 and K4's
    unpack on the recorded inputs, each held against its plain version
    first."""
    import torch
    import chip_smoke as CS
    from tpuvsr_torch.engine import tile as TL
    out = {}
    kern, flat = calls["vsr_fp_parts"][1]
    CS.need(all(torch.equal(a, b) for a, b in zip(
        kern.parent_parts(flat), kern.parent_parts_plain(flat))),
        "parts differs from its plain version")
    out["vsr_fp_parts"] = CS.cuda_ms(lambda: kern.parent_parts(flat))
    kern, *args = calls["vsr_fp_incremental"][1]
    CS.need(torch.equal(kern.fingerprint_incremental(*args),
                        kern.fingerprint_incremental_plain(*args)),
            "incremental differs from its plain version")
    out["vsr_fp_incremental"] = CS.cuda_ms(
        lambda: kern.fingerprint_incremental(*args))
    kern, flat = calls["vsr_fp_full_canon"][1]
    CS.need(torch.equal(kern.fingerprint(flat), kern.fingerprint_plain(flat)),
            "full differs from its plain version")
    out["vsr_fp_full_canon"] = CS.cuda_ms(lambda: kern.fingerprint(flat))
    en, valid, segs, total, carry = calls["compact"][1]
    n_act = len(segs.host)
    qa, qb = (TL.queue_buffers(total, n_act, en.device) for _ in range(2))
    ca, cb = carry.clone(), carry.clone()
    TL.compact(en, valid, segs, qa, ca)
    TL.compact_plain(en, valid, segs, qb, cb)
    CS.need(all(torch.equal(qa[k], qb[k]) for k in qa)
            and torch.equal(ca, cb), "compact differs from its plain version")
    out["compact"] = CS.cuda_ms(lambda: TL.compact(en, valid, segs, qa, ca))
    m = en & valid[:, None]
    out["torch.nonzero"] = CS.cuda_ms(lambda: torch.nonzero(m))
    kern, flat = calls["vsr_fp_full"][1]
    out["vsr_fp_full_init"] = CS.cuda_ms(lambda: kern.fingerprint(flat))
    # the hunt splitter's shape, [4096, 1803] at MAX_MSGS 48, on rows of
    # random words (a full fingerprint's time does not depend on them)
    kern, rows = calls["hunt_shape"]
    out["vsr_fp_full_hunt_shape"] = CS.cuda_ms(lambda: kern.fingerprint(rows))
    out.update(k10_k2_times(calls))
    return out


def k10_k2_times(calls):
    """{row: (ms, issue ms, timed_by)} of K10 on its three recorded
    queues (after an L2 flush), K2 on its three recorded batches beside
    the torch.sort lexsort, and K6 and K4's unpack at the tile's shape;
    ``<row>_identical`` says whether the build equals the plain version
    there (the whole output)."""
    import torch
    import chip_smoke as CS
    from tpuvsr_torch.engine import fpset as F
    out = {}
    for key in ("fused", "shipped", "hunt"):
        kern, flat, pidx, aid, lane, mask, _ok = calls[f"vsr_actions_{key}"][1]
        a = kern.successors(flat, pidx, aid, lane, mask)
        p = kern.successors_plain(flat, pidx, aid, lane, mask)
        out[f"vsr_actions_{key}_identical"] = all(
            torch.equal(a[k], p[k]) for k in a)
        buf = kern.successor_buffers(pidx.shape[0], flat.device)
        evict = CS.l2_evict(flat.device)
        out[f"vsr_actions_{key}"] = CS.cuda_ms(
            lambda: kern.successors(flat, pidx, aid, lane, mask, buf),
            evict=evict)
        del evict
    for key in ("fused", "per_action", "hunt"):
        fps, mask = calls[f"dedup_{key}"][1]
        perm, keep = F.dedup_batch(fps, mask)
        want = torch.zeros_like(mask)
        want[perm] = keep
        out[f"dedup_{key}_identical"] = torch.equal(F.dedup_keep(fps, mask),
                                                    want)
        out[f"dedup_{key}"] = CS.cuda_ms(lambda: F.dedup_keep(fps, mask))
        out[f"lexsort_{key}"] = CS.cuda_ms(
            lambda: CS.lexsort_keep(fps, mask))
    pk, packed, rows = calls["unpack_tile"][1]
    CS.need(torch.equal(pk.unpack(packed, rows),
                        pk.unpack_plain(packed, rows)),
            "unpack differs from its plain version at the tile's shape")
    out["unpack_tile"] = CS.cuda_ms(lambda: pk.unpack(packed, rows))
    kern, flat = calls["guards_tile"][1]
    CS.need(all(torch.equal(a, b) for a, b in zip(
        kern.guard_matrix(flat), kern.guard_matrix_plain(flat))),
        "guards differ from their plain version at the tile's shape")
    out["vsr_guards_tile"] = CS.cuda_ms(lambda: kern.guard_matrix(flat))
    return out


def walls(defect, shipped):
    """Walls of the three runs, levels held to the records, and one
    profiled quantum of each run_fused()."""
    import torch
    import chip_smoke as CS
    from tpuvsr_torch.engine.device_bfs import DeviceBFS
    out = {}
    runs = (("run", defect, "run", 10, CS.LEVELS, {}),
            ("run_fused", defect, "run_fused", 10, CS.LEVELS, {}),
            ("symmetric_run_fused", shipped, "run_fused", 16,
             CS.SHIPPED_LEVELS, {"symmetry": "auto"}))
    for key, binding, entry, depth, levels, kw in runs:
        eng = DeviceBFS(binding, **BFS, **kw)
        torch.cuda.synchronize()
        t0 = time.time()
        res = getattr(eng, entry)(max_depth=depth)
        torch.cuda.synchronize()
        out[key] = time.time() - t0
        CS.need(res.ok and res.levels == levels[:depth + 1],
                f"{key} levels {res.levels}")
        del eng, res
        gc.collect()
        torch.cuda.empty_cache()
    CS.profile_quantum(out, "fused_quantum", DeviceBFS(defect, **BFS), 9)
    CS.profile_quantum(out, "symmetric_quantum",
                       DeviceBFS(shipped, symmetry="auto", **BFS), 12)
    for k in ("fused_quantum", "symmetric_quantum"):
        out[k].pop("table")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="directory with the other build's sources")
    ap.add_argument("--out", help="write the measurements to this JSON file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from tpuvsr_torch import kernels
    from tpuvsr_torch.engine.spec import load_binding
    kernels.build()
    this = {stem: kernels._lib(stem) for stem in STEMS}
    tmp = tempfile.mkdtemp(prefix="kernel_ab_")
    other = build_other(os.path.abspath(args.other), tmp)
    doc = {"card": CS.gpu_line(), "order": ["other", "this", "this", "other"],
           "rounds": []}
    print(doc["card"], flush=True)
    defect = load_binding(CS.DEFECT, "VSR")
    shipped = load_binding(CS.SHIPPED, "VSR")
    calls = record(defect, shipped)
    family = record_family()
    doc["shapes"] = {k: [list(x.shape) for x in v[1]
                         if isinstance(x, torch.Tensor)][:1]
                     for k, v in calls.items() if k in (
                         "vsr_fp_parts", "vsr_fp_incremental",
                         "vsr_fp_full_canon", "compact", "dedup_fused",
                         "dedup_per_action", "dedup_hunt", "unpack_tile",
                         "guards_tile")}
    for key in ("fused", "shipped", "hunt"):
        _k, flat, pidx, *_r, ok = calls[f"vsr_actions_{key}"][1]
        doc["shapes"][f"vsr_actions_{key}"] = {
            "queue": pidx.shape[0], "lanes": flat.shape[1],
            "parents": int(torch.unique(pidx).numel()),
            "filled": None if ok is None else int(ok.sum())}
    from tpuvsr_torch.engine import fpset as F
    this_dedup = F._dedup_kernel
    # a K2 source without the one-block kernel wants scratch on every call
    with open(os.path.join(args.other, "dedup.cu")) as f:
        old_dedup = "dedup_block_kernel" not in f.read()
    doc["other_dedup_wrapper"] = "parent_dedup" if old_dedup else "this"
    for which in doc["order"]:
        kernels._libs.update(other if which == "other" else this)
        F._dedup_kernel = (parent_dedup if which == "other"
                           and old_dedup else this_dedup)
        r = {"build": which, "kernels": kernel_times(calls),
             "family": family_times(family)}
        r.update(walls(defect, shipped))
        doc["rounds"].append(r)
        print(json.dumps(r, default=str), flush=True)
    kernels._libs.update(this)
    F._dedup_kernel = this_dedup
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
