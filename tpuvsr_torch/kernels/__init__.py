"""Hand kernels for Hopper: build, load, launch and count.

Each CUDA source under ``tpuvsr_torch/csrc/`` is compiled with ``nvcc``
for ``sm_90a`` into its own shared library with a plain C interface,
at first use, under ``build/tpuvsr_torch/`` at the repository root (the
file name carries a digest of the sources and flags, so a stale build is
never loaded), and bound with ``ctypes``.  ``build()`` starts one
``nvcc`` per source, all at once.

The wrappers that call these kernels live beside their plain PyTorch
versions (``engine/fpset.py``, ``engine/pack.py``, ``engine/tile.py``,
``engine/edges.py``, ``engine/canon.py``, ``models/fingerprint.py``,
``models/vsr_kernel.py``, ``models/st03_kernel.py`` and the family's
subclasses, ``sim/rng.py``, ``validate/batch.py``).
A wrapper sends a CPU tensor to the plain version and a CUDA tensor to
``launch()``, which raises when the C entry point reports a CUDA error
and otherwise adds one to the kernel's launch count.  A launch recorded
into a CUDA graph runs only when the graph replays: ``capture()`` keeps
those launches apart and counts them at each replay.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuvsr_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> (source stem, the JAX function it replaces)
KERNELS = {
    "fpset_insert": ("fpset_insert",
                     "tpuvsr/engine/fpset.py:111 insert_core"),
    "dedup_batch": ("dedup", "tpuvsr/engine/fpset.py:70 dedup_batch"),
    "vsr_fp_full": ("vsr_fingerprint",
                    "tpuvsr/models/vsr_kernel.py:1079 fingerprint"),
    "vsr_fp_parts": ("vsr_fingerprint",
                     "tpuvsr/models/vsr_kernel.py:1093 parent_parts"),
    "vsr_fp_incremental": (
        "vsr_fingerprint",
        "tpuvsr/models/vsr_kernel.py:1132 fingerprint_incremental"),
    "pack": ("pack", "tpuvsr/engine/pack.py:199 PackSpec.pack"),
    "unpack": ("pack", "tpuvsr/engine/pack.py:220 PackSpec.unpack"),
    "fleet_choose": ("fleet_draw",
                     "tpuvsr/sim/fleet.py:387 chunk_fn step draws"),
    "fleet_choose_shared": ("fleet_draw", "tpuvsr/engine/device_sim.py:245 "
                            "chunk_fn step draws (:247-267)"),
    "fleet_noise_shared": ("fleet_draw", "tpuvsr/engine/device_sim.py:325 "
                           "_round_logw"),
    "fleet_swarm_noise": ("fleet_draw",
                          "tpuvsr/sim/fleet.py:374 chunk_fn swarm noise"),
    "vsr_guards": ("vsr_guards",
                   "tpuvsr/engine/device_bfs.py:398 _guard_matrix"),
    "compact": ("compact", "tpuvsr/engine/device_bfs.py:838 "
                "_fused_body_factory work-queue compaction"),
    "commit_prefix": ("tile_commit", "tpuvsr/engine/device_bfs.py:806 "
                      "_fused_body_factory headroom gate and "
                      "committed-action prefix (:806-931)"),
    "commit_finish": ("tile_commit", "tpuvsr/engine/device_bfs.py:942 "
                      "_fused_body_factory rank scatter, commit and "
                      "reason (:942-985)"),
    "level_step": ("tile_commit", "tpuvsr/engine/device_bfs.py:1191 "
                   "_make_multilevel obody level step (:1231-1300)"),
    "action_gate": ("tile_commit", "tpuvsr/engine/device_bfs.py:458 "
                    "make_body headroom gate, an action's flags and commit "
                    "(:500-511, :560-587)"),
    "action_finish": ("tile_commit", "tpuvsr/engine/device_bfs.py:458 "
                      "make_body rank scatter, chain and reason "
                      "(:589-609, :626-667)"),
    "vsr_canon": ("canon", "tpuvsr/engine/canon.py:202 "
                  "CanonSpec.canonicalize"),
    "vsr_actions": ("vsr_actions", "tpuvsr/models/vsr_kernel.py:331-894 "
                    "act_* (+ :1176-1191 inv_*, :1238 invariant_fn)"),
    "fpset_store_gids": ("fpset_gids",
                         "tpuvsr/engine/fpset.py:223 store_gids (+ :256 "
                         "insert_gids, grow's column :289-333)"),
    "fpset_probe": ("fpset_gids", "tpuvsr/engine/fpset.py:270 lookup_gids "
                    "(+ :193 query_core)"),
    "edge_emit": ("edge_emit", "tpuvsr/engine/device_bfs.py:1030-1048 "
                  "_fused_body_factory edge block"),
    "st03_fp_full": ("vsr_fingerprint",
                     "tpuvsr/models/st03_kernel.py:841 fingerprint "
                     "(+ :813 _glob_hash)"),
    "st03_fp_parts": ("vsr_fingerprint",
                      "tpuvsr/models/st03_kernel.py:847 parent_parts"),
    "st03_fp_incremental": (
        "vsr_fingerprint",
        "tpuvsr/models/st03_kernel.py:879 fingerprint_incremental"),
    "st03_guards": ("st03_guards", "tpuvsr/engine/device_bfs.py:398 "
                    "_guard_matrix over tpuvsr/models/st03_kernel.py:"
                    "578-710"),
    "st03_actions": ("st03_actions", "tpuvsr/models/st03_kernel.py:261-570 "
                     "act_* (+ :183-227 bag primitives, :723 lane_replica, "
                     ":912-938 inv_*, :976 invariant_fn)"),
    # the family's other models: K13, K14 and K3 instantiated for each
    "a01_fp_full": ("vsr_fingerprint",
                    "tpuvsr/models/st03_kernel.py:841 fingerprint on "
                    "tpuvsr/models/a01_kernel.py's rows"),
    "a01_fp_parts": ("vsr_fingerprint",
                     "tpuvsr/models/st03_kernel.py:847 parent_parts on "
                     "tpuvsr/models/a01_kernel.py's rows"),
    "a01_fp_incremental": (
        "vsr_fingerprint", "tpuvsr/models/st03_kernel.py:879 "
        "fingerprint_incremental on tpuvsr/models/a01_kernel.py's rows"),
    "a01_guards": ("st03_guards", "tpuvsr/engine/device_bfs.py:398 "
                   "_guard_matrix over tpuvsr/models/a01_kernel.py:61,71 "
                   "(+ st03_kernel.py:578-710)"),
    "a01_actions": ("st03_actions", "tpuvsr/models/a01_kernel.py:53-117 "
                    "(+ st03_kernel.py:261-570 act_*, :912-938 inv_*)"),
    "i01_fp_full": ("vsr_fingerprint",
                    "tpuvsr/models/st03_kernel.py:841 fingerprint on "
                    "tpuvsr/models/i01_kernel.py's rows (REP_KEYS :45)"),
    "i01_fp_parts": ("vsr_fingerprint",
                     "tpuvsr/models/st03_kernel.py:847 parent_parts on "
                     "tpuvsr/models/i01_kernel.py's rows"),
    "i01_fp_incremental": (
        "vsr_fingerprint", "tpuvsr/models/st03_kernel.py:879 "
        "fingerprint_incremental on tpuvsr/models/i01_kernel.py's rows"),
    "i01_guards": ("st03_guards", "tpuvsr/engine/device_bfs.py:398 "
                   "_guard_matrix over tpuvsr/models/i01_kernel.py:150,"
                   "173,253,303,340 (+ a01, st03 guards)"),
    "i01_actions": ("st03_actions", "tpuvsr/models/i01_kernel.py:78-397 "
                    "(+ a01_kernel.py, st03_kernel.py act_*, inv_*)"),
    "as04_fp_full": ("vsr_fingerprint",
                     "tpuvsr/models/st03_kernel.py:841 fingerprint on "
                     "tpuvsr/models/as04_kernel.py's rows (REP_KEYS :43)"),
    "as04_fp_parts": ("vsr_fingerprint",
                      "tpuvsr/models/st03_kernel.py:847 parent_parts on "
                      "tpuvsr/models/as04_kernel.py's rows"),
    "as04_fp_incremental": (
        "vsr_fingerprint", "tpuvsr/models/st03_kernel.py:879 "
        "fingerprint_incremental on tpuvsr/models/as04_kernel.py's rows"),
    "as04_guards": ("st03_guards", "tpuvsr/engine/device_bfs.py:398 "
                    "_guard_matrix over tpuvsr/models/as04_kernel.py:319,"
                    "324 (+ st03 guards)"),
    "as04_actions": ("st03_actions", "tpuvsr/models/as04_kernel.py:76-346 "
                     "(+ st03_kernel.py act_*, inv_*)"),
    "rr05_fp_full": ("vsr_fingerprint",
                     "tpuvsr/models/st03_kernel.py:841 fingerprint on "
                     "tpuvsr/models/rr05_kernel.py's rows (REP_KEYS :48)"),
    "rr05_fp_parts": ("vsr_fingerprint",
                      "tpuvsr/models/st03_kernel.py:847 parent_parts on "
                      "tpuvsr/models/rr05_kernel.py's rows"),
    "rr05_fp_incremental": (
        "vsr_fingerprint", "tpuvsr/models/st03_kernel.py:879 "
        "fingerprint_incremental on tpuvsr/models/rr05_kernel.py's rows"),
    "rr05_guards": ("st03_guards", "tpuvsr/engine/device_bfs.py:398 "
                    "_guard_matrix over tpuvsr/models/rr05_kernel.py:132-"
                    "308 (+ as04, st03 guards)"),
    "rr05_actions": ("st03_actions", "tpuvsr/models/rr05_kernel.py:88-313 "
                     "(+ as04_kernel.py, st03_kernel.py act_*, inv_*)"),
    "al05_fp_full": ("vsr_fingerprint",
                     "tpuvsr/models/st03_kernel.py:841 fingerprint on "
                     "tpuvsr/models/al05_kernel.py's rows (REP_KEYS :37)"),
    "al05_fp_parts": ("vsr_fingerprint",
                      "tpuvsr/models/st03_kernel.py:847 parent_parts on "
                      "tpuvsr/models/al05_kernel.py's rows"),
    "al05_fp_incremental": (
        "vsr_fingerprint", "tpuvsr/models/st03_kernel.py:879 "
        "fingerprint_incremental on tpuvsr/models/al05_kernel.py's rows"),
    "al05_guards": ("st03_guards", "tpuvsr/engine/device_bfs.py:398 "
                    "_guard_matrix over tpuvsr/models/al05_kernel.py:102 "
                    "(+ rr05, as04, st03 guards)"),
    "al05_actions": ("st03_actions", "tpuvsr/models/al05_kernel.py:60-168 "
                     "(+ rr05_kernel.py, as04_kernel.py, st03_kernel.py)"),
    "cp06_fp_full": ("vsr_fingerprint",
                     "tpuvsr/models/st03_kernel.py:841 fingerprint on "
                     "tpuvsr/models/cp06_kernel.py's rows (REP_KEYS :48, "
                     "ROW_PLANES :59)"),
    "cp06_fp_parts": ("vsr_fingerprint",
                      "tpuvsr/models/st03_kernel.py:847 parent_parts on "
                      "tpuvsr/models/cp06_kernel.py's rows"),
    "cp06_fp_incremental": (
        "vsr_fingerprint", "tpuvsr/models/st03_kernel.py:879 "
        "fingerprint_incremental on tpuvsr/models/cp06_kernel.py's rows"),
    "cp06_guards": ("st03_guards", "tpuvsr/engine/device_bfs.py:398 "
                    "_guard_matrix over tpuvsr/models/cp06_kernel.py:183-664 "
                    "guard_* (+ rr05, as04, st03 guards)"),
    "cp06_actions": ("st03_actions", "tpuvsr/models/cp06_kernel.py:155-759 "
                     "act_*, inv_* (+ rr05_kernel.py, as04_kernel.py, "
                     "st03_kernel.py)"),
    # K9 on the family: one source, the model's relabelling a launch
    # argument (engine/canon.MODES)
    "st03_canon": ("canon", "tpuvsr/engine/canon.py:202 "
                   "CanonSpec.canonicalize over tpuvsr/models/"
                   "st03_kernel.py:773 _perm_vals, :779 _permuted (plain)"),
    "a01_canon": ("canon", "tpuvsr/engine/canon.py:202 CanonSpec."
                  "canonicalize over tpuvsr/models/a01_kernel.py:42 "
                  "_perm_vals (packed entries)"),
    "i01_canon": ("canon", "tpuvsr/engine/canon.py:202 CanonSpec."
                  "canonicalize over tpuvsr/models/i01_kernel.py:53 "
                  "PERM_REP_KEYS (a01_kernel.py:42 _perm_vals, packed)"),
    "as04_canon": ("canon", "tpuvsr/engine/canon.py:202 CanonSpec."
                   "canonicalize over tpuvsr/models/as04_kernel.py:51 "
                   "PERM_REP_KEYS (st03_kernel.py:773 _perm_vals, plain)"),
    "rr05_canon": ("canon", "tpuvsr/engine/canon.py:202 CanonSpec."
                   "canonicalize over tpuvsr/models/rr05_kernel.py:57 "
                   "PERM_REP_KEYS, :83 _perm_vals (packed)"),
    "al05_canon": ("canon", "tpuvsr/engine/canon.py:202 CanonSpec."
                   "canonicalize over tpuvsr/models/al05_kernel.py:55 "
                   "_perm_vals (plain, RR05's planes)"),
    "cp06_canon": ("canon", "tpuvsr/engine/canon.py:202 CanonSpec."
                   "canonicalize over tpuvsr/models/cp06_kernel.py:56-58 "
                   "PERM_*_KEYS, :66 _perm_vals (NoOp fixed)"),
    # K16: the trace-validation step
    "validate_select": ("validate_step", "tpuvsr/validate/batch.py:260 "
                        "chunk_fn, one_trace's lane mask (:220-223)"),
    "validate_commit": ("validate_step", "tpuvsr/validate/batch.py:260 "
                        "chunk_fn, one_trace's filter, dedup, rank "
                        "scatter and divergence update (:224-258)"),
    # K18: the state predicates, with K10's and K14's invariant code
    "vsr_state_pred": ("vsr_actions", "tpuvsr/engine/device_liveness.py:383 "
                       "_run_batched via :394 batch_predicate over "
                       "tpuvsr/models/vsr_kernel.py:1176-1200 inv_*, "
                       "pred_all_replicas_same_view"),
    # K17: the ample-set step of the partial-order reduction
    "por_cand": ("por_ample", "tpuvsr/engine/device_bfs.py:783-799 "
                 "_fused_body_factory ample candidate (en_act @ ~amat.T, "
                 "argmax)"),
    "por_probe": ("por_ample", "tpuvsr/engine/device_bfs.py:909-926 "
                  "_fused_body_factory C3 probe of the level markers"),
    "por_keep": ("por_ample", "tpuvsr/engine/device_bfs.py:927-931 "
                 "_fused_body_factory keep mask (+ :989-1013 kept/amp "
                 "counters)"),
}
# K18 on the ST03 family: one instantiation a model in st03_actions.cu,
# over the predicates of each model's INVARIANT_FNS (JAX file:line)
for _m, _preds in (
        ("st03", "st03_kernel.py:911-954"),
        ("a01", "st03_kernel.py:911-954 on a01_kernel.py's entries"),
        ("i01", "i01_kernel.py:399 INVARIANT_FNS (+ st03's :911-954)"),
        ("as04", "as04_kernel.py:348 INVARIANT_FNS (+ st03's :911-954)"),
        ("rr05", "as04_kernel.py:348 INVARIANT_FNS on rr05_kernel.py's "
         "entries"),
        ("al05", "as04_kernel.py:348 INVARIANT_FNS on al05_kernel.py's rows"),
        ("cp06", "cp06_kernel.py:757 INVARIANT_FNS (+ as04, st03)")):
    KERNELS[f"{_m}_state_pred"] = (
        "st03_actions", "tpuvsr/engine/device_liveness.py:383 _run_batched "
        f"via :394 batch_predicate over tpuvsr/models/{_preds}")
SOURCES = tuple(sorted({src for src, _ in KERNELS.values()}))

# C entry point -> argument types ("p" pointer, "i" int, "q" long long,
# "f" float)
_LAYOUT = "iiiiii" + "pppppppp"
_ENTRY = {
    "tpuvsr_fpset_insert": "pqppipp" + "p",
    "tpuvsr_dedup_batch": "ppippppqp" + "p",
    "tpuvsr_vsr_fp_parts": _LAYOUT + "pipppp" + "p",
    "tpuvsr_vsr_fp_incremental": _LAYOUT + "pippipppppp" + "p",
    "tpuvsr_pack": "piii" + "pppppppppp" + "p",
    "tpuvsr_unpack": "ppiiipppppp" + "p",
    "tpuvsr_fleet_choose": "pppippiipp" + "i" + "p",
    "tpuvsr_fleet_swarm_noise": "ppifip" + "i" + "p",
    "tpuvsr_vsr_guards": "piii" + "iiiiiiiii" + "ppp" + "ppp" + "p",
    "tpuvsr_compact": "ppiipi" + "i" + "pppppp" + "pii" + "p",
    "tpuvsr_commit_prefix": "pppppppppp" + "ii" + "pp" + "p",
    "tpuvsr_commit_finish": "ppppppp" + "ipi" + "ppi" + "pppp" + "pp"
                            + "p",
    "tpuvsr_level_step": "pppppp" + "i" + "pppp" + "ii" + "p",
    "tpuvsr_action_gate": "pppppppp" + "p" + "ii" + "q" + "p" + "p",
    "tpuvsr_action_finish": "ppppppp" + "iii" + "p" + "ppi" + "pppp" + "p",
    "tpuvsr_canon": "pii" + "pii" + "pi" + "ii" + "p" + "p",
    "tpuvsr_vsr_actions": "pipppi" + "p" + "iiiiiii" + "iii" + "p"
                          + "ppppppp" + "p",
    "tpuvsr_fpset_store_gids": "pqppppi" + "p",
    "tpuvsr_fpset_probe": "pqpppi" + "ppp" + "p",
    "tpuvsr_edge_emit": "ppppi" + "piii" + "pppp" + "p",
    "tpuvsr_vstep_count": "pppppp" + "iiii" + "p" + "p",
    "tpuvsr_vstep_fill": "pppppp" + "iiii" + "ppppp" + "p",
    "tpuvsr_vstep_commit": "iiiiiii" + "pppppppppp" + "pppppp" + "ppppp"
                           + "p",
    "tpuvsr_por_cand": "pp" + "ii" + "p" + "i" + "ppppppp" + "p",
    "tpuvsr_por_probe": "p" + "q" + "pppppp" + "i" + "pppp" + "p",
    "tpuvsr_por_keep": "pppp" + "i" + "pppp" + "i" + "ppppp" + "p",
    "tpuvsr_vsr_state_pred": "piip" + "iiiiiii" + "i" + "p" + "p",
}
# K13, K14 and K18 take one signature for every model of the ST03 family
for _m in ("st03", "a01", "i01", "as04", "rr05", "al05", "cp06"):
    _ENTRY[f"tpuvsr_{_m}_guards"] = ("piii" + "iiiiiiii" + "ppp" + "ppp"
                                     + "p")
    _ENTRY[f"tpuvsr_{_m}_actions"] = ("pipppi" + "pp" + "iiiii" + "iiii"
                                      + "p" + "ppppppp" + "p")
    _ENTRY[f"tpuvsr_{_m}_state_pred"] = ("piipp" + "i" + "iiiiii" + "i"
                                         + "p" + "p")
_CTYPE = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_longlong,
          "f": ctypes.c_float}

_libs: dict = {}
_launches = {name: 0 for name in KERNELS}
_captured = None      # launches recorded by the capture in progress


def _nvcc():
    path = (os.environ.get("NVCC") or shutil.which("nvcc")
            or "/usr/local/cuda/bin/nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked for {path}); the "
                           "hand kernels build only where the CUDA "
                           "toolkit is installed")
    return path


def lib_path(stem: str) -> Path:
    """Where the shared library of one source lives once built."""
    h = hashlib.sha256()
    for part in (CSRC / f"{stem}.cu", CSRC / "common.cuh"):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:12]}.so"


def build(stems=SOURCES) -> dict:
    """Compile every source of ``stems`` that has no current build, one
    ``nvcc`` process per source, all started together.  Returns
    {stem: seconds} for the sources compiled now; raises with nvcc's
    output when one fails.  The ptxas report (registers, spills) of
    each build is kept beside the library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in stems if not lib_path(s).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.time()
    for stem in todo:
        out = lib_path(stem)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out)
    took, failed = {}, []
    for stem, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        took[stem] = time.time() - t0
        Path(str(out) + ".log").write_bytes(log)
        if p.returncode != 0:
            failed.append(f"{stem}.cu:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return took


def load(path):
    """The shared library at ``path``, its C entry points typed."""
    lib = ctypes.CDLL(str(path))
    for name, sig in _ENTRY.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = [_CTYPE[c] for c in sig]
            fn.restype = ctypes.c_int
    return lib


def _lib(stem: str):
    lib = _libs.get(stem)
    if lib is None:
        path = lib_path(stem)
        if not path.exists():
            build((stem,))
        lib = _libs[stem] = load(path)
    return lib


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(kernel: str, entry: str, *args) -> None:
    """Call one C entry point of a kernel and count the launch; raises
    RuntimeError when it returns a CUDA error code."""
    stem = KERNELS[kernel][0]
    rc = getattr(_lib(stem), entry)(*args)
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")
    if torch.cuda.is_current_stream_capturing():
        if _captured is None:
            raise RuntimeError(f"{kernel}: a CUDA graph that launches "
                               "hand kernels is captured through "
                               "kernels.capture()")
        _captured[kernel] = _captured.get(kernel, 0) + 1
    else:
        _launches[kernel] += 1


def capture(fn):
    """Capture ``fn()`` into a CUDA graph on the current device.  Returns
    the graph's replay function, which adds the kernel launches the
    capture recorded to the launch counts at every replay (the capture
    itself runs and counts nothing).  The replay function keeps ``fn``,
    and so every tensor it closes over, alive: the graph holds their
    addresses, and a tensor freed while the graph lives would hand its
    memory to the next allocation while replays still write it."""
    global _captured
    graph = torch.cuda.CUDAGraph()
    _captured = {}
    try:
        with torch.cuda.graph(graph):
            fn()
        launched = _captured
    finally:
        _captured = None

    def replay():
        graph.replay()
        for k, n in launched.items():
            _launches[k] += n
    replay.keeps = fn
    return replay


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def check(t: torch.Tensor, name: str, dtype, shape=None):
    """Refuse what a kernel does not take: a CPU tensor, another dtype,
    another shape, a non-contiguous layout."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()
