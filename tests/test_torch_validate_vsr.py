"""Trace validation of VSR at full width on the CPU: the port's
``BatchValidator`` (plain step, ``VSRKernel`` of the registry) against
JAX's ``BatchValidator`` (``confirm=False``, one device, a model factory
of JAX's ``VSRCodec``/``VSRKernel``) at MAX_MSGS 48 on
``examples/VSR_defect.cfg``.

The spec is a shim whose only initial state is state 0 of
``examples/found_violation_trace.txt`` (VSR's `.tla` is not in this
repository, so neither validator can confirm with the interpreter).  The
traces observe actions only: the golden trace's first six events
(candidate sets of at most 12, so the cap grows past 8 to 16 in both
packages, each redrawing the round) and a mutant with ``ReceivePrepareOkMsg``
inserted before event 1, where no PrepareOk can be in the bag.  The
whole golden trace (cand_cap 256) runs through the port's plain step
alone (JAX's pairwise step would take minutes there); ``chip_smoke.py``
phase 17b holds the card to its sizes.  Every comparison is of integers:
tolerance 0."""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from tpuvsr.frontend.cfg import parse_cfg_file as j_cfg
from tpuvsr.frontend.parser import parse_module_text as j_parse
from tpuvsr.frontend.trace_parse import parse_trace_file as j_trace_file
from tpuvsr.interp.evalr import Evaluator as JEvaluator
from tpuvsr.models.vsr import VSRCodec as JCodec
from tpuvsr.models.vsr_kernel import VSRKernel as JKernel
from tpuvsr.validate.batch import BatchValidator as JValidator
from tpuvsr.validate.batch import ev_slice_d
from tpuvsr.validate.traces import Trace as JTrace
from tpuvsr.validate.traces import TraceEvent as JEvent
from tpuvsr_torch.core.values import fmt
from tpuvsr_torch.engine.spec import InitShim, load_binding
from tpuvsr_torch.frontend.cfg import parse_cfg_file
from tpuvsr_torch.frontend.parser import parse_module_text
from tpuvsr_torch.frontend.trace_parse import parse_trace_file
from tpuvsr_torch.interp.evalr import Evaluator
from tpuvsr_torch.validate import BatchValidator, Trace, TraceEvent

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFECT = os.path.join(ROOT, "examples", "VSR_defect.cfg")
TRACE = os.path.join(ROOT, "examples", "found_violation_trace.txt")
PREFIX = 6                       # events of the golden trace validated
MUTANT = "ReceivePrepareOkMsg"


def _shim_text(cfg):
    return ("---- MODULE VSR ----\nCONSTANTS " + ", ".join(cfg.constants)
            + "\n====\n")


@pytest.fixture(scope="module")
def case():
    cfg = parse_cfg_file(DEFECT)
    entries = parse_trace_file(TRACE, SimpleNamespace(
        cfg=cfg, ev=Evaluator(parse_module_text(_shim_text(cfg)),
                              cfg.constants)))
    acts = [e.action_name for e in entries[1:]]
    seqs = {"golden": acts[:PREFIX],
            "mutant": acts[:1] + [MUTANT] + acts[1:PREFIX]}
    spec = InitShim(load_binding(DEFECT, "VSR"), entries[0].state)
    traces = [Trace(t, [TraceEvent(action=a) for a in s])
              for t, s in seqs.items()]
    bv = BatchValidator(spec, batch=4, cand_cap=4, chunk_steps=8,
                        max_msgs=48, confirm=False, device="cpu")
    res = bv.run(traces)
    # JAX: the same shim, its own parse of the trace and its kernel
    jcfg = j_cfg(DEFECT)
    jmod = j_parse(_shim_text(jcfg))
    jentries = j_trace_file(TRACE, SimpleNamespace(
        cfg=jcfg, ev=JEvaluator(jmod, jcfg.constants)))
    jspec = SimpleNamespace(
        module=jmod, cfg=jcfg, actions=[],
        init_states=lambda: iter([dict(jentries[0].state)]))

    def factory(_spec, max_msgs=None):
        codec = JCodec(jcfg.constants, max_msgs=max_msgs)
        return codec, JKernel(codec)
    jv = JValidator(jspec, batch=2, n_devices=1, chunk_steps=8, cand_cap=8,
                    max_msgs=48, confirm=False, model_factory=factory)
    jtraces = [JTrace(t, [JEvent(action=a) for a in s])
               for t, s in seqs.items()]
    jres = jv.run(jtraces)
    return SimpleNamespace(entries=entries, jentries=jentries, bv=bv,
                           res=res, jv=jv, jres=jres, traces=traces,
                           jtraces=jtraces)


def test_initial_state_is_the_golden_traces(case):
    from tpuvsr.core.values import fmt as j_fmt
    assert sorted((k, fmt(v)) for k, v in case.entries[0].state.items()) \
        == sorted((k, j_fmt(v)) for k, v in case.jentries[0].state.items())
    enc = case.bv.codec.encode(case.entries[0].state)
    jenc = case.jv.codec.encode(case.jentries[0].state)
    assert sorted(enc) == sorted(jenc)
    assert all(np.array_equal(np.asarray(enc[k]), np.asarray(jenc[k]))
               for k in enc)


def test_reports_match_jax(case):
    """The golden prefix is accepted and the mutant diverges at event 1
    with 2 candidates and {ReceiveClientRequest, ReceiveHigherSVC,
    TimerSendSVC} enabled, in both packages."""
    want = json.loads(json.dumps(case.jres.divergences))
    assert json.loads(json.dumps(case.res.divergences)) == want
    assert (case.res.traces_checked, case.res.accepted) == \
        (case.jres.traces_checked, case.jres.accepted) == (2, 1)
    (d,) = want
    assert (d["trace"], d["step"], d["candidates"]) == ("mutant", 1, 2)
    assert d["event"] == {"action": MUTANT}
    assert [e["action"] for e in d["enabled"]] == [
        "ReceiveClientRequest", "ReceiveHigherSVC", "TimerSendSVC"]


def test_candidate_sets_and_growth(case):
    """The golden prefix's candidate sets (2, 6, 6, 6, 6, 12): the port's
    cap grew from 4 to 8 and then to 16, JAX's from 8 to 16, each growth
    redrawing the round."""
    assert case.bv.sizes["golden"] == [2, 6, 6, 6, 6, 12]
    assert case.bv.sizes["mutant"] == [2]
    assert case.bv.K == case.jv.K == 16
    assert case.bv.counters["grow_cand_cap"] == 2
    assert case.res.metrics["gauges"]["max_candidates"] == 12


def test_plain_step_is_jax_one_trace(case):
    """One chunk (the seven steps of the two traces) of the port's plain
    step against JAX's chunk on the same round at 16 slots: candidate
    rows, alive and the divergence planes bit for bit."""
    jv, bv = case.jv, case.bv
    jarr, _pre, _S = jv._encode_round(case.jtraces)
    C = jv.chunk
    out = jv._chunk(
        dict(jarr["cands"]), jarr["alive"],
        np.full((jv.T_pad,), -1, np.int32),
        np.zeros((jv.T_pad, jv.L), bool), np.zeros((jv.T_pad,), np.int32),
        jarr["tlen"], ev_slice_d(jarr, "aid_obs", 0, C, jv.T_pad, -1),
        {k: ev_slice_d(jarr["ob_m"], k, 0, C, jv.T_pad, False)
         for k in jarr["ob_m"]},
        {k: ev_slice_d(jarr["ob_v"], k, 0, C, jv.T_pad, 0)
         for k in jarr["ob_v"]}, np.int32(0))
    arr, _p, S = bv._encode_round(case.traces)
    T = len(case.traces)
    st, dev_obs = bv._round_state(arr)
    for s in range(S):
        bv._step(st, dev_obs, s, s == S - 1, C)
    keys = [k for k, _s, _a, _e in bv.pk._splits]
    K = bv.K
    jflat = np.concatenate(
        [np.asarray(out[0][k]).reshape(T * K, -1) for k in keys],
        axis=1).astype(np.int32)
    assert np.array_equal(st["cands"].numpy(), jflat)
    assert np.array_equal(st["alive"].numpy(),
                          np.asarray(out[1]).reshape(-1))
    assert np.array_equal(st["div_at"].numpy(), np.asarray(out[2]))
    assert np.array_equal(st["div_en"].numpy(), np.asarray(out[3]))
    assert np.array_equal(st["div_cand"].numpy(), np.asarray(out[4]))
    ovf, err, rem, n_div = st["red"].tolist()
    assert (rem, n_div, ovf > 0, err > 0) == (
        int(out[5]), int(out[6]), bool(out[7]), bool(out[8]))


def test_whole_golden_trace_on_the_plain_step(case):
    """The whole golden trace (29 events, actions observed) through the
    port's plain step: accepted with the candidate-set sizes that
    ``chip_smoke.py`` phase 17b holds the card to, the cap grown to 256;
    the mutant diverges where the JAX run above says."""
    from chip_smoke import GOLDEN_MUTANT, GOLDEN_SIZES
    acts = [e.action_name for e in case.entries[1:]]
    traces = [Trace("golden", [TraceEvent(action=a) for a in acts]),
              Trace("mutant", [TraceEvent(action=a) for a in
                               acts[:1] + [MUTANT] + acts[1:]])]
    bv = BatchValidator(case.bv.spec, batch=2, max_msgs=48, confirm=False,
                        device="cpu")
    res = bv.run(traces)
    assert bv.sizes["golden"] == GOLDEN_SIZES and bv.K == 256
    (d,) = res.divergences
    assert {"trace": d["trace"], "step": d["step"],
            "candidates": d["candidates"],
            "enabled": [e["action"] for e in d["enabled"]]} == GOLDEN_MUTANT
    assert d == case.res.divergences[0]
