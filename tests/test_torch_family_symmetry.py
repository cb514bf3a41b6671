"""Symmetry reduction on the VSR family (ST03, A01, I01, AS04, RR05, AL05,
CP06), on the CPU: the port's ``engine/canon.py`` with each model's
relabelling (K9's plain version) against ``tpuvsr.engine.canon`` over the
JAX package's kernels, and the port's BFS entry points with symmetry on
against a host level BFS over the JAX kernel whose stored fingerprint is
the JAX CanonSpec's.

Each model runs on its ``tpuvsr_torch/configs/<module>_{shipped,wide}
_symmetry.cfg`` (its base cfg plus ``SYMMETRY symmValues``; two values,
so the group is the identity and one swap).  The JAX group comes from
``tpuvsr/engine/spec.py:_symmetry_perms`` over a constants-only shim
module that defines ``symmValues == Permutations(Values)`` as VSR.tla:151
does (the family's .tla files are not in this repository; the JAX
package's own family tests bind the same name).

* the orbit plane tables and ``CanonSpec.version`` equal JAX's;
* canonicalization, bit for bit: rows met on numpy-seeded random walks
  of the JAX kernel from ``zero_state()`` with every replica in view 1,
  numpy-seeded rows drawn inside each lane's packing range, and hand-set
  rows whose relabelled planes hold packed codes with views in the top
  bits of the byte, 0, ``1 << 31`` and past the table, and CP06's NoOp
  entries (``testing.checkpoint_rows``);
* ``run()`` and ``run_fused()`` with symmetry on to depth 5: the JAX
  CanonSpec host BFS's levels and generated counts, ``symmetry_perms``
  2; ``symmetry=False`` on the same cfg gives the unsymmetric levels;
  ``PagedBFS`` gives ``run()``'s levels and pointer tables (CP06);
* a kernel that overrides its relabelling without naming K9's mode is
  refused, and K9's C signature and mode enum match the wrapper's.

Integer results: tolerance 0.

Run as a script, ``python tests/test_torch_family_symmetry.py record N
[MODEL ...]`` prints the JAX CanonSpec host BFS's levels per model, level
by level, up to depth N or the deepest level that ends in about five
minutes (at least depth 8), and writes them with the
depth, commit and seconds to
``tpuvsr_torch/configs/records/family_symmetry_levels.json``, the record
``chip_smoke.py`` phase 14 holds the card against."""

import fcntl
import functools
import json
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_a01 import CP06_GUIDE, one_torch_thread  # noqa
from tests.test_torch_gids import expand_macros  # noqa: E402
from tests.test_torch_st03 import CHUNK, PAD, _batch, _run, _walk_rows  # noqa
from tpuvsr.engine.canon import CanonSpec as JCanon  # noqa: E402
from tpuvsr.engine.canon import group_table as j_group_table  # noqa: E402
from tpuvsr.engine.canon import orbit_planes as j_orbit_planes  # noqa: E402
from tpuvsr.engine.spec import SpecModel  # noqa: E402
from tpuvsr.frontend.cfg import parse_cfg_file as j_cfg  # noqa: E402
from tpuvsr.frontend.parser import parse_module_text  # noqa: E402
from tpuvsr.interp.evalr import Evaluator  # noqa: E402
from tpuvsr.models.a01 import A01Codec as JA01Codec  # noqa: E402
from tpuvsr.models.a01_kernel import A01Kernel as JA01Kernel  # noqa: E402
from tpuvsr.models.al05 import AL05Codec as JAL05Codec  # noqa: E402
from tpuvsr.models.al05_kernel import AL05Kernel as JAL05Kernel  # noqa
from tpuvsr.models.as04 import AS04Codec as JAS04Codec  # noqa: E402
from tpuvsr.models.as04_kernel import AS04Kernel as JAS04Kernel  # noqa
from tpuvsr.models.cp06 import CP06Codec as JCP06Codec  # noqa: E402
from tpuvsr.models.cp06_kernel import CP06Kernel as JCP06Kernel  # noqa
from tpuvsr.models.i01 import I01Codec as JI01Codec  # noqa: E402
from tpuvsr.models.i01_kernel import I01Kernel as JI01Kernel  # noqa: E402
from tpuvsr.models.rr05 import RR05Codec as JRR05Codec  # noqa: E402
from tpuvsr.models.rr05_kernel import RR05Kernel as JRR05Kernel  # noqa
from tpuvsr.models.st03 import ST03Codec as JST03Codec  # noqa: E402
from tpuvsr.models.st03_kernel import ST03Kernel as JST03Kernel  # noqa
from tpuvsr_torch import kernels  # noqa: E402
from tpuvsr_torch.core.values import TLAError  # noqa: E402
from tpuvsr_torch.engine import canon as C  # noqa: E402
from tpuvsr_torch.engine.device_bfs import DeviceBFS  # noqa: E402
from tpuvsr_torch.engine.paged_bfs import PagedBFS  # noqa: E402
from tpuvsr_torch.engine.spec import load_binding  # noqa: E402
from tpuvsr_torch.models.a01_kernel import A01Kernel  # noqa: E402
from tpuvsr_torch.models.registry import make_model  # noqa: E402
from tpuvsr_torch.testing import checkpoint_rows  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "tpuvsr_torch", "configs")
RECORD = os.path.join(CONFIGS, "records", "family_symmetry_levels.json")
CSRC = os.path.join(ROOT, "tpuvsr_torch", "csrc")
# key -> (module, cfg size, JAX codec, JAX kernel, K9's mode, the
# unsymmetric levels of the base cfg to depth 4: the JAX-kernel host
# BFS records of tests/test_torch_st03_bfs.py and tests/test_torch_a01.py)
MODELS = {
    "ST03": ("VR_STATE_TRANSFER", "shipped", JST03Codec, JST03Kernel,
             "plain", [1, 4, 17, 63, 238]),
    "A01": ("VR_ASSUME_NEWVIEWCHANGE", "shipped", JA01Codec, JA01Kernel,
            "packed", [1, 4, 16, 56, 198]),
    "I01": ("VR_INC_RESEND", "shipped", JI01Codec, JI01Kernel, "packed",
            [1, 4, 15, 47, 143]),
    "AS04": ("VR_APP_STATE", "shipped", JAS04Codec, JAS04Kernel, "plain",
             [1, 4, 17, 63, 238]),
    "RR05": ("VR_REPLICA_RECOVERY", "wide", JRR05Codec, JRR05Kernel,
             "packed", [1, 7, 35, 151, 595]),
    "AL05": ("VR_REPLICA_RECOVERY_ASYNC_LOG", "wide", JAL05Codec,
             JAL05Kernel, "plain", [1, 7, 37, 171, 697]),
    "CP06": ("VR_REPLICA_RECOVERY_CP", "wide", JCP06Codec, JCP06Kernel,
             "noop", [1, 7, 35, 140, 510]),
}
DEPTH = 5                   # the CPU runs' depth
MAX_MSGS = 32               # the JAX codec's bag in the CPU tests
RECORD_MAX_MSGS = 48        # and in the record
RECORD_SECONDS = 300        # a model's record stops past this
RECORD_MIN_DEPTH = 8


def cfg_path(key):
    module, size = MODELS[key][:2]
    return os.path.join(CONFIGS, f"{module}_{size}_symmetry.cfg")


def _jax_perms(cfg):
    """The JAX package's evaluated ``Permutations(Values)`` over a
    constants-only shim module with the cfg's constants bound."""
    mod = parse_module_text(
        "---- MODULE SHIM ----\nCONSTANTS " + ", ".join(cfg.constants)
        + "\nsymmValues == Permutations(Values)\n====\n")
    shim = SimpleNamespace(module=mod, ev=Evaluator(mod, cfg.constants))
    return SpecModel._symmetry_perms(shim, "symmValues")


def _jax_step(jk):
    """jit(vmap over states) of every lane of every action of a JAX
    family kernel from ``seed_touch``: (successor, enabled) with a [B,
    n_lanes] leading pair of axes."""
    def per_state(st):
        st = jk.seed_touch(st)
        outs = []
        for name, fn in zip(jk.action_names, jk._action_fns()):
            lanes = jnp.arange(jk._lane_count(name), dtype=jnp.int32)
            succ, en = jax.vmap(fn, in_axes=(None, 0))(st, lanes)
            outs.append(({k: v for k, v in succ.items()
                          if not k.startswith("_")}, en))
        return jax.tree.map(lambda *xs: jnp.concatenate(xs), *outs)
    return jax.jit(jax.vmap(per_state))


@functools.lru_cache(maxsize=None)
def jax_model(key, max_msgs=MAX_MSGS):
    """The JAX side of a model: its kernel, CanonSpec (jitted vmapped
    canonicalize and canonical fingerprint) and all-lanes step."""
    module, _size, jcodec_cls, jkern_cls = MODELS[key][:4]
    cfg = j_cfg(cfg_path(key))
    jcodec = jcodec_cls(cfg.constants, max_msgs=max_msgs)
    jk = jkern_cls(jcodec)
    group = j_group_table(SimpleNamespace(symmetry_perms=_jax_perms(cfg)),
                          jcodec)
    canon = JCanon(group, j_orbit_planes(jk), jk)
    return SimpleNamespace(
        jk=jk, canon=canon, step=_jax_step(jk),
        canonicalize=jax.jit(jax.vmap(canon.canonicalize)),
        fp=jax.jit(jax.vmap(canon.fingerprint_fn(jk))))


def _init(jk):
    init = jk.codec.zero_state()
    init["view"][:] = 1
    return init


def jax_level_bfs(J, depth, seconds=None, log=None):
    """Host level BFS over the JAX kernel from ``zero_state()`` with every
    replica in view 1, the stored fingerprint the JAX CanonSpec's: (level
    sizes, cumulative generated counts with Init counted, seconds a
    level).  The frontier steps PAD states at a time; no enabled
    successor may set an error flag.  With ``seconds``, stops (not before
    depth RECORD_MIN_DEPTH) where the next level, as long as the last
    times the last two levels' ratio, would end past 1.25 x ``seconds``."""
    t0 = time.time()
    init = _init(J.jk)
    front = {k: np.asarray(v)[None] for k, v in init.items()}
    seen = {_run(J.fp, front, CHUNK).tobytes()}
    levels, generated, secs = [1], [1], [0.0]
    for d in range(1, depth + 1):
        n = len(front["view"])
        parts, n_en = [], 0
        for lo in range(0, n, PAD):
            succ, en = _run(J.step, {k: v[lo:lo + PAD]
                                     for k, v in front.items()})
            en = en.reshape(-1)
            n_en += int(en.sum())
            if not en.any():
                continue
            flat = {k: v.reshape((-1,) + v.shape[2:])[en]
                    for k, v in succ.items()}
            assert not flat["err"].any()
            fb = np.ascontiguousarray(_run(J.fp, flat, CHUNK)).tobytes()
            keep = []
            for i in range(len(flat["err"])):
                key = fb[16 * i:16 * i + 16]
                if key not in seen:
                    seen.add(key)
                    keep.append(i)
            if keep:
                parts.append({k: v[keep] for k, v in flat.items()})
        front = ({k: np.concatenate([p[k] for p in parts])
                  for k in parts[0]} if parts else
                 {k: v[:0] for k, v in front.items()})
        levels.append(len(front["view"]))
        generated.append(generated[-1] + n_en)
        secs.append(time.time() - t0)
        if log:
            log(d, levels[-1], generated[-1], secs[-1])
        if not levels[-1]:
            break
        if seconds is not None and d >= RECORD_MIN_DEPTH:
            last, prev = secs[-1] - secs[-2], secs[-2] - secs[-3]
            if secs[-1] + last * last / max(prev, 1e-3) > 1.25 * seconds:
                break
    return levels, generated, secs


@functools.lru_cache(maxsize=None)
def port_model(key, max_msgs=MAX_MSGS):
    """The port's binding, codec, kernel and CanonSpec of a model."""
    b = load_binding(cfg_path(key), MODELS[key][0])
    codec, kern = make_model(b, max_msgs=max_msgs)
    return SimpleNamespace(binding=b, codec=codec, kern=kern,
                           canon=C.build_canon_spec(b, codec, kern))


# ----------------------------------------------------------------------
# the rows
# ----------------------------------------------------------------------
def _random_rows(pk, n, seed):
    """``n`` flat rows, each lane uniform in its packing range (raw
    32-bit lanes in 0..2)."""
    rng = np.random.default_rng(seed)
    raw = pk._bits >= 32
    lo = np.where(raw, 0, pk._lo.astype(np.int64))
    hi = np.where(raw, 2, lo + (1 << np.minimum(pk._bits, 31)) - 1)
    return rng.integers(lo, hi + 1, size=(n, pk.lanes)).astype(np.int32)


def _special_codes(mode, V):
    """Codes the hand-set rows put into the relabelled planes: each value
    id packed with views in the top bits of the byte, 0, ``1 << 31`` (a
    negative int32), -1, ids past the table, and (CP06) its NoOp id."""
    ids = list(range(1, V + 1))
    codes = [0, -(1 << 31), -1, V + 1, V + 2, 255, 1 << 20]
    if mode == "packed":
        codes += [(v << 8) | view for v in ids
                  for view in (0, 1, 0x7F, 0x80, 0xFF)]
        codes += [((V + 1) << 8) | 3, (0x7FFFFF << 8) | 0xFF]
    else:
        codes += ids
    return np.array(codes, np.int64).astype(np.int32)


def _hand_rows(P, base, seed):
    """Rows whose relabelled planes hold ``_special_codes`` in
    numpy-seeded positions, over the first base rows; CP06 adds
    ``testing.checkpoint_rows`` (NoOp entries in its logs and
    checkpoints)."""
    rng = np.random.default_rng(seed)
    kern = P.kern
    codes = _special_codes(kern.CANON_MODE[0], kern.V)
    rows = []
    for r in range(8):
        row = {k: np.array(v) for k, v in base[r % len(base)].items()}
        for k in P.canon.planes:
            row[k] = rng.choice(codes, size=row[k].shape).astype(np.int32)
        rows.append(row)
    if kern.CANON_MODE[0] == "noop":
        rows += checkpoint_rows(P.codec)
    return rows


def _flat(P, rows):
    return P.kern.pk.flatten({k: torch.as_tensor(v)
                              for k, v in _batch(rows).items()}).contiguous()


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    """A model's rows (stepped, random, hand-set) as flat port rows."""
    key = request.param
    J, P = jax_model(key), port_model(key)
    walked, _ens = _walk_rows(J.jk, _all_lanes_with_ri(J), _init(J.jk),
                              seed=41, steps=20,
                              guide=CP06_GUIDE if key == "CP06" else None)
    stepped = _flat(P, walked)
    rand = torch.from_numpy(_random_rows(P.kern.pk, 128, 7))
    hand = _flat(P, _hand_rows(P, walked, 3))
    return SimpleNamespace(key=key, J=J, P=P, stepped=stepped, rand=rand,
                           hand=hand)


def _all_lanes_with_ri(J):
    """The step ``_walk_rows`` takes: (successor, enabled, _ts, _tn, lane
    replica), of which it reads the successor and the enabled bits."""
    def f(batch):
        succ, en = _run(J.step, batch)
        z = np.zeros(en.shape, np.int32)
        return succ, en, z, z, z
    return f


def _jax_canon(model, flat):
    pk = model.P.kern.pk
    st = {k: v.numpy() for k, v in pk.unflatten(flat).items()}
    want = _run(model.J.canonicalize, st, 256)
    return pk.flatten({k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in want.items()})


# ----------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------
@pytest.mark.parametrize("key", list(MODELS))
def test_orbit_planes_version_and_mode(key):
    J, P = jax_model(key), port_model(key)
    assert C.orbit_planes(P.kern) == j_orbit_planes(J.jk)
    assert C.orbit_planes(type(P.kern)) == j_orbit_planes(type(J.jk))
    assert P.canon.version == J.canon.version
    assert P.canon.perms == J.canon.perms == 2
    np.testing.assert_array_equal(P.canon.group, J.canon.group)
    assert P.kern.CANON_MODE[0] == MODELS[key][4]
    assert P.canon.mode == C.MODES.index(MODELS[key][4])
    assert P.canon.kernel == f"{key.lower()}_canon"


@pytest.mark.parametrize("which", ["stepped", "rand", "hand"])
def test_canonicalize_matches_jax(model, which):
    flat = getattr(model, which)
    got = model.P.canon.canonicalize(flat)
    assert torch.equal(got, _jax_canon(model, flat))
    if which == "stepped":
        # the walks reach rows that the swap relabels
        assert (got != flat).any(dim=1).sum() > 0


def test_canonical_images_are_orbit_invariant(model):
    canon, pk = model.P.canon, model.P.kern.pk
    flat = torch.cat([model.stepped, model.rand])
    img = canon.canonicalize(flat)
    for g in canon.tables("cpu")["group"]:
        moved = pk.flatten(model.P.kern._permuted(pk.unflatten(flat), g))
        assert torch.equal(canon.canonicalize(moved), img)


def _engine(key, cls=DeviceBFS, **kw):
    return cls(load_binding(cfg_path(key), MODELS[key][0]), tile_size=64,
               chunk_tiles=8, fpset_capacity=1 << 14, next_capacity=1 << 10,
               device="cpu", **kw)


def _pointers(eng):
    return [np.concatenate(getattr(eng, k))
            for k in ("_h_parent", "_h_action", "_h_param")]


@functools.lru_cache(maxsize=None)
def _jax_levels(key):
    return jax_level_bfs(jax_model(key), DEPTH)[:2]


@pytest.mark.parametrize("key", list(MODELS))
def test_symmetric_levels_match_jax_canon_level_bfs(key):
    levels, generated = _jax_levels(key)
    runs = {}
    for entry in ("run", "run_fused"):
        eng = _engine(key)
        res = getattr(eng, entry)(max_depth=DEPTH)
        assert res.ok and res.levels == levels, (entry, res.levels, levels)
        assert res.distinct_states == sum(levels)
        assert res.states_generated == generated[-1]
        g = res.metrics["gauges"]
        assert g["symmetry_perms"] == 2
        assert eng._canon is not None and not eng._incremental
        runs[entry] = eng
    assert all(np.array_equal(a, b) for a, b in
               zip(_pointers(runs["run"]), _pointers(runs["run_fused"])))
    # the unsymmetric base levels, and symmetry merges states at depth 4
    off = MODELS[key][5]
    assert levels[:len(off)] != off
    res = _engine(key, symmetry=False).run(max_depth=len(off) - 1)
    assert res.levels == off
    assert res.metrics["gauges"]["symmetry_perms"] == 1


def test_paged_bfs_with_symmetry_equals_run():
    key = "CP06"
    ref = _engine(key)
    rres = ref.run(max_depth=DEPTH)
    eng = PagedBFS(load_binding(cfg_path(key), MODELS[key][0]),
                   tile_size=64, chunk_tiles=8, fpset_capacity=1 << 14,
                   next_capacity=64, device="cpu")
    res = eng.run(max_depth=DEPTH)
    assert res.levels == rres.levels == _jax_levels(key)[0]
    assert (res.distinct_states, res.states_generated) == \
        (rres.distinct_states, rres.states_generated)
    assert res.metrics["gauges"]["symmetry_perms"] == 2
    assert all(np.array_equal(a, b) for a, b in
               zip(_pointers(eng), _pointers(ref)))


@pytest.mark.parametrize("mode", [None, ("gather", 0)])
def test_a_relabelling_without_a_mode_is_refused(mode):
    """A kernel with a _permuted and no known CANON_MODE builds no
    CanonSpec, and its plain relabelling refuses too."""
    class Unnamed(A01Kernel):
        CANON_MODE = mode
    P = port_model("A01")
    kern = Unnamed(P.codec, pack_spec=P.kern.pk)
    with pytest.raises(TLAError, match="CANON_MODE"):
        C.build_canon_spec(P.binding, P.codec, kern)
    if mode is not None:
        with pytest.raises(TLAError, match="relabel mode"):
            kern._perm_vals(torch.zeros(2, dtype=torch.int32),
                            torch.arange(kern.V + 1, dtype=torch.int32))


def test_canon_signature_and_modes_match_the_source():
    src = expand_macros(open(os.path.join(CSRC, "canon.cu")).read())
    sig = re.search(r"TPUVSR_EXPORT int tpuvsr_canon\((.*?)\)", src,
                    re.S).group(1)
    kinds = "".join("p" if "*" in a else "i" for a in sig.split(","))
    assert kinds == kernels._ENTRY["tpuvsr_canon"]
    body = re.search(r"enum Mode \{(.*?)\}", src, re.S).group(1)
    assert [m.strip() for m in body.split(",") if m.strip()] == \
        ["M_" + m.upper() for m in C.MODES]
    for key in MODELS:
        name = port_model(key).canon.kernel
        assert kernels.KERNELS[name][0] == "canon"


# ----------------------------------------------------------------------
# the record chip_smoke.py phase 14 reads
# ----------------------------------------------------------------------
def _commit():
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=30).stdout.strip() or "unknown"
    except OSError:
        return "unknown"


def record(depth, keys):
    for key in keys:
        print(f"{key} ({os.path.basename(cfg_path(key))}), MAX_MSGS "
              f"{RECORD_MAX_MSGS}", flush=True)
        J = jax_model(key, RECORD_MAX_MSGS)
        levels, generated, secs = jax_level_bfs(
            J, depth, RECORD_SECONDS,
            log=lambda d, n, g, s: print(f"  depth {d}: {n} new, {g} "
                                         f"generated, {s:.1f} s",
                                         flush=True))
        entry = {"module": MODELS[key][0],
                 "cfg": os.path.relpath(cfg_path(key), ROOT),
                 "depth": len(levels) - 1, "levels": levels,
                 "generated": generated, "seconds": round(secs[-1], 1),
                 "max_msgs": RECORD_MAX_MSGS, "commit": _commit()}
        print(json.dumps({key: entry}), flush=True)
        with open(RECORD, "a+") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            f.seek(0)
            text = f.read()
            doc = json.loads(text) if text.strip() else {}
            doc[key] = entry
            f.seek(0)
            f.truncate()
            f.write("{\n" + ",\n".join(
                f" {json.dumps(k)}: {json.dumps(doc[k])}"
                for k in MODELS if k in doc) + "\n}\n")


if __name__ == "__main__":
    if len(sys.argv) < 3 or sys.argv[1] != "record":
        sys.exit("usage: test_torch_family_symmetry.py record N [MODEL ...]")
    record(int(sys.argv[2]), sys.argv[3:] or list(MODELS))
