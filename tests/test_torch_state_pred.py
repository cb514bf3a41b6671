"""K18, the state predicates, on the CPU: the port's plain version
(``state_predicates`` with ``device="cpu"``) against the JAX kernels'
``vmap`` of each entry of ``INVARIANT_FNS``, bit for bit (tolerance 0),
for VSR and the seven models of its family.

Rows: the retained levels of a shallow ``PagedBFS(retain_levels=True,
edges=True)`` run on the CPU (the levels it expanded: the defect config
to depth 3, each family model's small cfg to depth 6, the
crash-recovery ones to 5), and
numpy-seeded edits of them that break each predicate somewhere (an
acknowledged value removed from every log, a view raised two past the
others, a replica in a view change, a commit above the op number, two
committed logs or app states that differ, mixed DVC views, an app entry
above the commit).  ``TestInv`` holds everywhere by definition, and so
does VSR's ``NoLogDivergence`` (VSR.tla:926-931 compares a log with
itself); every other predicate is false on some row.

``DeviceGraph.batch_predicate`` over the same run's blocks gives the
same bits, and None for a name no kernel evaluates (a cfg-only binding
has no definitions).  The engines' check of a state's own invariants
(the initial states) goes through ``state_predicates`` and names the
first failing invariant in cfg order, of the first failing row."""

import dataclasses
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

from tests.test_torch_a01 import FAMILY  # noqa: E402
from tests.test_torch_threads import one_torch_thread  # noqa: E402,F401
from tpuvsr.frontend.cfg import parse_cfg_file as j_cfg  # noqa: E402
from tpuvsr.models.st03 import ST03Codec as JST03Codec  # noqa: E402
from tpuvsr.models.st03_kernel import ST03Kernel as JST03Kernel  # noqa: E402
from tpuvsr.models.vsr import VSRCodec as JVSRCodec  # noqa: E402
from tpuvsr.models.vsr_kernel import VSRKernel as JVSRKernel  # noqa: E402
from tpuvsr.testing import stub_device_engine as j_stub_engine  # noqa: E402
from tpuvsr_torch.engine.device_bfs import DeviceBFS  # noqa: E402
from tpuvsr_torch.engine.device_liveness import DeviceGraph  # noqa: E402
from tpuvsr_torch.engine.paged_bfs import PagedBFS  # noqa: E402
from tpuvsr_torch.engine.spec import SpecBinding, load_binding  # noqa: E402
from tpuvsr_torch.testing import stub_device_engine  # noqa: E402

CONFIGS = os.path.join(ROOT, "tpuvsr_torch", "configs")
MAX_MSGS = 16
PAD = 256
# model -> (module, cfg, depth, JAX codec, JAX kernel)
MODELS = {
    "VSR": ("VSR", os.path.join(ROOT, "examples", "VSR_defect.cfg"), 4,
            JVSRCodec, JVSRKernel),
    "ST03": ("VR_STATE_TRANSFER", None, 7, JST03Codec, JST03Kernel),
    **{k: (m.module, None, 6 if k in ("RR05", "AL05", "CP06") else 7,
           m.jcodec, m.jkernel) for k, m in FAMILY.items()}}
# predicates that hold on every state by their definitions
CONSTANT = {("VSR", "NoLogDivergence"), ("VSR", "TestInv")} | {
    (k, "TestInv") for k in MODELS}


def _cfg(key):
    module, cfg, *_ = MODELS[key]
    return cfg or os.path.join(CONFIGS, f"{module}_small.cfg")


def _edits(rows, kern, rng, n=24):
    """Edited copies of numpy-seeded choices of ``rows`` (dense dicts),
    each breaking one predicate where the model has its planes."""
    R, V = kern.R, kern.V
    out = []

    def edit(fn):
        for i in rng.choice(len(rows), n):
            e = {k: np.array(v, copy=True) for k, v in rows[i].items()}
            if fn(e, int(rng.integers(R))) is not False:
                out.append(e)

    def acked_lost(e, r):
        e["aux_acked"][int(rng.integers(V))] = 2
        e["log"][:] = 0

    def view_ahead(e, r):
        e["view"][r] = e["view"].max() + 2

    def view_change(e, r):
        e["status"][r] = 1

    def commit_above_op(e, r):
        e["commit"][r] = e["op"][r] + 1

    def log_divergence(e, r):
        if e["log"].ndim != 2:
            return False
        e["commit"][:2] = 1
        e["log"][0, 0], e["log"][1, 0] = 1, V + 3

    def mixed_dvcs(e, r):
        if "dvc_view" not in e:
            return False
        e["status"][r] = 1
        e["dvc"][r, :2] = 1
        e["dvc_view"][r, 0], e["dvc_view"][r, 1] = 1, 2

    def app_divergence(e, r):
        if "app" not in e:
            return False
        e["commit"][:2] = 1
        e["app"][0, 0], e["app"][1, 0] = 1, V + 3
        e["log"][0, 0] = 1

    def app_above_commit(e, r):
        if "app" not in e:
            return False
        e["commit"][r] = 0
        e["app"][r, 0] = 1

    for fn in (acked_lost, view_ahead, view_change, commit_above_op,
               log_divergence, mixed_dvcs, app_divergence,
               app_above_commit):
        edit(fn)
    return out


def _jax_preds(jk, batch):
    """[n_names, n] bool: each entry of the JAX kernel's INVARIANT_FNS,
    vmapped, over ``batch`` in pieces of PAD rows (one compile)."""
    fns = [getattr(jk, f) for f in jk.INVARIANT_FNS.values()]
    f = jax.jit(jax.vmap(lambda st: tuple(g(st) for g in fns)))
    n = len(next(iter(batch.values())))
    outs = []
    for lo in range(0, n, PAD):
        part = {k: v[lo:lo + PAD] for k, v in batch.items()}
        m = len(next(iter(part.values())))
        part = {k: np.concatenate([v, np.repeat(v[:1], PAD - m, 0)])
                for k, v in part.items()}
        outs.append(np.stack([np.asarray(x)[:m] for x in f(part)]))
    return np.concatenate(outs, axis=1)


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    """A model's shallow retained run, its rows (the run's, then the
    edits) and the JAX predicates on them."""
    key = request.param
    module, _cfg_path, depth, jcodec, jkernel = MODELS[key]
    b = load_binding(_cfg(key), module)
    eng = PagedBFS(b, max_msgs=MAX_MSGS, tile_size=64, retain_levels=True,
                   edges=True, device="cpu")
    res = eng.run(max_depth=depth)
    assert res.ok and len(res.levels) == depth + 1
    assert eng.codec.shape.MAX_MSGS == MAX_MSGS
    kern = eng.kern
    bfs = [{k: v[i] for k, v in blk.items()} for blk in eng.level_blocks
           for i in range(next(iter(blk.values())).shape[0])]
    rng = np.random.default_rng(sum(map(ord, key)))
    rows = bfs + _edits(bfs, kern, rng)
    batch = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    jk = jkernel(jcodec(j_cfg(_cfg(key)).constants, max_msgs=MAX_MSGS))
    assert list(jk.INVARIANT_FNS) == list(kern.INVARIANT_FNS)
    return SimpleNamespace(key=key, binding=b, eng=eng, res=res, kern=kern,
                           n_bfs=len(bfs), batch=batch,
                           want=_jax_preds(jk, batch))


def test_state_predicates_match_jax(model):
    kern = model.kern
    names = list(kern.INVARIANT_FNS)
    flat = kern.pk.flatten({k: torch.as_tensor(v) for k, v in
                            model.batch.items()}).contiguous()
    full = kern.invariant_mask(names)
    assert full == (1 << len(names)) - 1
    bits = kern.state_predicates(flat, full).numpy()
    for b, n in enumerate(names):
        got = (bits >> b & 1).astype(bool)
        assert np.array_equal(got, model.want[b]), n
        # one bit alone: its own bit, the others 0
        one = kern.state_predicates(flat, 1 << b).numpy()
        assert np.array_equal(one, got.astype(np.int32) << b), n
        if (model.key, n) in CONSTANT:
            assert got.all(), n
        else:
            assert got[:model.n_bfs].any() and not got.all(), n


def test_batch_predicate_matches_jax(model):
    # the run was cut at a depth: handed over as if it had reached its
    # fixpoint over the levels it expanded (the ones it retains), the
    # graph reads their blocks all the same
    g = DeviceGraph(model.binding, engine=model.eng,
                    result=dataclasses.replace(
                        model.res, error=None, distinct_states=model.n_bfs))
    assert g.n == model.n_bfs and g.mode == "stream"
    for b, n in enumerate(model.kern.INVARIANT_FNS):
        vals = g.batch_predicate(n)
        assert vals.dtype == bool and vals.shape == (g.n,)
        assert np.array_equal(vals, model.want[b, :model.n_bfs]), n
    # a cfg-only binding has no definitions: no name beyond the kernel's
    assert g.batch_predicate("NoSuchPredicate") is None
    assert g.batch_predicate("ConvergenceToView") is None
    assert g.batch_expr(("id", "AllReplicasMoveToSameView"), {}) is None


def test_initial_state_check_names_the_first_failing_invariant(model):
    """Two initial states, the second breaking the acknowledged-write
    invariants: the engines report the first failing one in cfg order
    (the plain functions' answer), with the second state's trace."""
    kern = model.kern
    init = {k: v[0] for k, v in model.batch.items()}
    bad = {k: np.array(v, copy=True) for k, v in init.items()}
    bad["aux_acked"][0] = 2
    bad["log"][:] = 0
    bad["view"][:] += 1         # a state of its own under the VIEW
    order = ["TestInv", "AcknowledgedWritesExistOnMajority",
             "AcknowledgedWriteNotLost"]
    st = {k: torch.as_tensor(np.stack([v])) for k, v in bad.items()}
    want = next(n for n, f in kern.invariant_fns(order)
                if not bool(f(st)[0]))
    assert want == "AcknowledgedWritesExistOnMajority"
    module = MODELS[model.key][0]
    b = SpecBinding(module=module, cfg=model.binding.cfg,
                    init=lambda codec: [init, bad], invariants=order)
    for entry in ("run", "run_fused"):
        res = getattr(DeviceBFS(b, max_msgs=MAX_MSGS, device="cpu"),
                      entry)(max_depth=1)
        assert (res.ok, res.violated_invariant) == (False, want), entry
        assert len(res.trace) == 1 and res.distinct_states == 2
        assert res.trace[0].state == model.eng.codec.decode(bad)


def test_stub_initial_violation_matches_jax():
    """The counter stub whose Bound fails on its initial state (x + y <=
    -1): every entry point names it with the one-state trace, as JAX's
    engine does."""
    want = j_stub_engine(inv_bound=-1).run()
    for eng, entry in ((stub_device_engine(inv_bound=-1, device="cpu"),
                        "run"),
                       (stub_device_engine(inv_bound=-1, device="cpu"),
                        "run_fused"),
                       (stub_device_engine(inv_bound=-1, device="cpu",
                                           cls=PagedBFS), "run")):
        got = getattr(eng, entry)()
        assert (got.ok, got.violated_invariant) == (
            want.ok, want.violated_invariant) == (False, "Bound")
        assert [(e.action_name, e.state) for e in got.trace] == \
            [(e.action_name, e.state) for e in want.trace]
