"""Parity of the port's single-device simulator
(tpuvsr_torch/engine/device_sim.py, ``DeviceSimulator``) with the JAX
package's (tpuvsr/engine/device_sim.py) on the CPU, and of the
shared-stream random numbers it draws (tpuvsr_torch/sim/rng.py) with
jax.random.

* ``split`` and the shared-stream ``uniform``/``gumbel``/``normal`` of
  shape (W, L) (word w * L + l of the flat draw), the shared lane choice
  (K5's plain twin) and the round noise, bit for bit;
* the counter stub (``tpuvsr.testing.counter_spec``/``stub_model_factory``
  against ``tpuvsr_torch.testing.stub_simulator``): walks, steps,
  verdict, trace and every committed chunk's (action, param) histories,
  under the grouped dispatch (with its caps doubled and the chunk
  redrawn), the dense one, the weighted draw with swarm noise, guided
  resampling and ``check_deadlock`` with the dead Jump lane;
* the VSR defect config (examples/VSR_defect.cfg through the
  constants-only shim of tests/test_torch_fleet.py) at 16 walkers, depth
  12, seed 3, histories compared live; and from MAX_MSGS 2, whose bag
  grows and whose chunks are redrawn, against the JAX record
  ``tpuvsr_torch/configs/records/device_sim_defect.json`` (the JAX
  simulator recompiles at each table size, minutes of CPU).

Integer results and float bits: tolerance 0.

Run as a script, this file writes that JAX CPU record (about two
minutes of CPU):
  python tests/test_torch_device_sim.py record
"""

import hashlib
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuvsr.engine.device_sim import DeviceSimulator as JSim  # noqa: E402
from tpuvsr.models.registry import make_model as j_make_model  # noqa: E402
from tpuvsr.testing import counter_spec  # noqa: E402
from tpuvsr.testing import stub_model_factory as j_stub_factory  # noqa: E402

from tests.test_torch_threads import one_torch_thread  # noqa: E402,F401

from tpuvsr_torch.engine.device_sim import (DeviceSimulator,  # noqa: E402
                                            device_simulate)
from tpuvsr_torch.engine.spec import load_binding  # noqa: E402
from tpuvsr_torch.sim import rng  # noqa: E402
from tpuvsr_torch.testing import stub_simulator  # noqa: E402

DEFECT = os.path.join(ROOT, "examples", "VSR_defect.cfg")
RECORD = os.path.join(ROOT, "tpuvsr_torch", "configs", "records",
                      "device_sim_defect.json")


def _digest(chunks):
    """sha256 of a round's committed chunks' int32 (aid, prm) histories,
    in order."""
    h = hashlib.sha256()
    for ha, hp in chunks:
        h.update(np.ascontiguousarray(ha, np.int32).tobytes())
        h.update(np.ascontiguousarray(hp, np.int32).tobytes())
    return h.hexdigest()


class JRec(JSim):
    """The JAX simulator, keeping every committed chunk's histories."""

    def __init__(self, *a, **k):
        self.chunks = []
        super().__init__(*a, **k)

    def _build(self, max_msgs):
        super()._build(max_msgs)
        f = self._chunk

        def chunk(*a):
            out = f(*a)
            if not bool(out[4]) and not np.asarray(out[5]).any():
                self.chunks.append((np.asarray(out[7][0]),
                                    np.asarray(out[7][1]), int(out[6])))
            return out
        self._chunk = chunk


class PRec(DeviceSimulator):
    """The port's simulator, keeping every committed chunk's
    histories."""

    def __init__(self, *a, **k):
        self.chunks = []
        super().__init__(*a, **k)

    def _chunk(self, *a):
        out = super()._chunk(*a)
        if not out[4] and not out[5].any():
            self.chunks.append((out[7][0].cpu().numpy(),
                                out[7][1].cpu().numpy(), out[6]))
        return out


def _sig(res):
    return (res.ok, res.walks, res.steps, res.violated_invariant,
            res.deadlocks, [(e.position, e.action_name, e.state)
                            for e in res.trace])


def _same_chunks(jc, pc):
    assert len(jc) == len(pc)
    for (ja, jp, js), (pa, pp, ps) in zip(jc, pc):
        assert js == ps
        assert np.array_equal(ja, pa) and np.array_equal(jp, pp)


def jax_defect_shim():
    from tests.test_torch_fleet import jax_shim
    shim, _entries, _codec, _kern = jax_shim()
    return shim


def _jax_factory(spec, max_msgs=None):
    return j_make_model(spec, max_msgs=max_msgs, fold_symmetry=False)


def record_defect(walkers, depth, seed, max_msgs, chunk_steps, num,
                  **kw):
    """The JAX simulator on the defect shim: per committed chunk, its
    steps, and the digest of the chunks of each round."""
    sim = JRec(jax_defect_shim(), max_msgs=max_msgs, walkers=walkers,
               chunk_steps=chunk_steps, model_factory=_jax_factory, **kw)
    t0 = time.time()
    res = sim.run(num=num, depth=depth, seed=seed)
    per_round = -(-depth // chunk_steps)
    rounds = [sim.chunks[i:i + per_round]
              for i in range(0, len(sim.chunks), per_round)]
    return {"walkers": walkers, "depth": depth, "seed": seed,
            "max_msgs": max_msgs, "chunk_steps": chunk_steps, "num": num,
            "options": {k: v for k, v in kw.items()},
            "ok": res.ok, "walks": res.walks, "steps": res.steps,
            "violated_invariant": res.violated_invariant,
            "final_max_msgs": int(sim.codec.shape.MAX_MSGS),
            "group_caps": [int(c) for c in sim.group_caps],
            "rounds": [{"digest": _digest([(a, p) for a, p, _s in r]),
                        "steps": int(sum(s for _a, _p, s in r))}
                       for r in rounds],
            "cpu_s": round(time.time() - t0, 1)}


# ----------------------------------------------------------------------
# random numbers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
def test_split_matches_jax(seed):
    jk = jax.random.PRNGKey(seed)
    pk = rng.prng_key(seed)
    for n in (1, 2, 5, 40):
        assert np.array_equal(np.asarray(jax.random.split(jk, n))
                              .astype(np.int64), rng.split(pk, n).numpy())
    a, b = jax.random.split(jk)
    pa, pb = rng.split(pk)
    assert np.array_equal(np.asarray(b).astype(np.int64), pb.numpy())
    assert np.array_equal(np.asarray(jax.random.split(a, 3))
                          .astype(np.int64), rng.split(pa, 3).numpy())


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("W", [1, 7, 64])
@pytest.mark.parametrize("L", [3, 19, 699])
def test_shared_stream_draws_match_jax(W, L):
    """Element (w, l) of a draw of shape (W, L) is word w * L + l of the
    flat draw: uniform over the lanes (L in {3, 699}), and gumbel and
    normal too over the actions (L = 19, the VSR model's)."""
    jk = jax.random.fold_in(jax.random.PRNGKey(11), W * 1000 + L)
    pk = torch.from_numpy(np.asarray(jk).astype(np.int64))
    assert np.array_equal(
        _bits(jax.random.uniform(jk, (W, L))),
        _bits(rng.uniform(pk, W * L).reshape(W, L)))
    if L != 19:
        return
    assert np.array_equal(
        _bits(jax.random.gumbel(jk, (W, L))),
        _bits(rng.gumbel(pk, W * L).reshape(W, L)))
    assert np.array_equal(
        _bits(jax.random.normal(jk, (W, L))),
        _bits(rng.normal(pk, W * L).reshape(W, L)))


def _jax_step_draw(key, en, lane_aid, logw):
    """tpuvsr/engine/device_sim.py:247-267, inside one jit."""
    n_act = logw.shape[1] if logw is not None else 0

    def draw(key, en, logw):
        if logw is not None:
            k1, k2 = jax.random.split(key)
            act_en = jnp.zeros((en.shape[0], n_act), bool) \
                .at[:, lane_aid].max(en)
            g = jax.random.gumbel(k1, act_en.shape) + logw
            a_star = jnp.argmax(jnp.where(act_en, g, -jnp.inf), axis=1)
            v = jax.random.uniform(k2, en.shape)
            in_act = en & (lane_aid[None, :] == a_star[:, None])
            return jnp.argmax(jnp.where(in_act, v, -1.0), axis=1)
        u = jax.random.uniform(key, en.shape)
        return jnp.argmax(jnp.where(en, u, -1.0), axis=1)
    return np.asarray(jax.jit(draw)(key, en, logw))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("W, L, n_act", [(1, 3, 2), (7, 699, 19),
                                         (64, 699, 19)])
def test_shared_lane_choice_matches_jax(weighted, W, L, n_act):
    g = np.random.default_rng(W + L)
    en = g.random((W, L)) < 0.05
    en[0] = False                               # a walker with no lane
    lane_aid = np.sort(g.integers(0, n_act, L)).astype(np.int32)
    logw = (np.log(g.uniform(0.5, 3.0, (W, n_act))).astype(np.float32)
            if weighted else None)
    jkeys = jax.random.split(jax.random.PRNGKey(W), 4)
    want = _jax_step_draw(jkeys[2], en, lane_aid, logw)
    lane, can = rng.choose_shared_plain(
        torch.from_numpy(np.asarray(jkeys).astype(np.int64)), 2,
        torch.from_numpy(en), torch.from_numpy(lane_aid),
        None if logw is None else torch.from_numpy(logw))
    assert np.array_equal(want, lane.numpy())
    assert np.array_equal(en.any(axis=1), can.numpy())
    # the wrapper takes the plain version for CPU tensors
    lane2, _ = rng.choose_shared(
        torch.from_numpy(np.asarray(jkeys).astype(np.int64)),
        torch.tensor([2], dtype=torch.int32), torch.from_numpy(en),
        torch.from_numpy(lane_aid),
        None if logw is None else torch.from_numpy(logw))
    assert torch.equal(lane, lane2)


@pytest.mark.parametrize("sigma", [0.5, 1.0])
def test_shared_round_noise_matches_jax(sigma):
    """tpuvsr/engine/device_sim.py:_round_logw, run op by op as JAX
    runs it."""
    W, n_act = 64, 19
    logw = np.log(np.arange(1, n_act + 1)).astype(np.float32)
    jk = jax.random.split(jax.random.PRNGKey(9))[1]
    want = jnp.broadcast_to(jnp.asarray(logw)[None, :], (W, n_act)) \
        + jax.random.normal(jk, (W, n_act)) * sigma
    pk = torch.from_numpy(np.asarray(jk).astype(np.int64))
    got = rng.shared_noise(pk, torch.from_numpy(logw), sigma, W)
    assert np.array_equal(_bits(want), _bits(got))


# ----------------------------------------------------------------------
# the counter stub
# ----------------------------------------------------------------------
STUB_CASES = {
    "grouped": (dict(), dict(num=32, depth=6, seed=1)),
    "violation": (dict(inv_x_bound=2), dict(num=64, depth=8, seed=7)),
    "dense": (dict(inv_x_bound=2, dispatch="dense"),
              dict(num=64, depth=8, seed=7)),
    "caps_grow": (dict(walkers=64, group_caps=[4, 4]),
                  dict(num=128, depth=7, seed=4)),
    "weighted_swarm": (dict(action_weights={"IncX": 3.0}, swarm_sigma=0.5,
                            inv_x_bound=2), dict(num=64, depth=8, seed=5)),
    "weighted": (dict(action_weights=[1.0, 2.0]),
                 dict(num=32, depth=7, seed=2)),
    "guided": (dict(guided=True, inv_x_bound=3),
               dict(num=64, depth=12, seed=3)),
    "deadlock": (dict(dead_action=True),
                 dict(num=32, depth=10, seed=2, check_deadlock=True)),
}


@pytest.mark.parametrize("case", sorted(STUB_CASES))
def test_stub_simulator_matches_jax(case):
    skw, rkw = STUB_CASES[case]
    skw = dict(skw)
    ib = skw.pop("inv_x_bound", None)
    dead = skw.pop("dead_action", False)
    W = skw.pop("walkers", 16)
    js = JRec(counter_spec(inv_x_bound=ib, dead_action=dead), walkers=W,
              chunk_steps=4, model_factory=j_stub_factory(
                  inv_x_bound=ib, dead_action=dead), **skw)
    ps = stub_simulator(inv_x_bound=ib, dead_action=dead, walkers=W,
                        device="cpu", **skw)
    ps.chunks = []
    orig = ps._chunk

    def rec(*a):
        out = orig(*a)
        if not out[4] and not out[5].any():
            ps.chunks.append((out[7][0].numpy(), out[7][1].numpy(),
                              out[6]))
        return out
    ps._chunk = rec
    jr, pr = js.run(**rkw), ps.run(**rkw)
    assert _sig(pr) == _sig(jr)
    _same_chunks(js.chunks, ps.chunks)
    assert ps.group_caps == [int(c) for c in js.group_caps]
    if case == "caps_grow":
        assert ps.counters["grow_dispatch_group"] > 0
    if case == "deadlock":
        assert not pr.ok and pr.deadlocks == 1
    if case in ("violation", "dense", "weighted_swarm"):
        assert not pr.ok and pr.violated_invariant == "Bound"


def test_device_simulate_entry_points():
    """``device_simulate`` runs DeviceSimulator, and with ``fleet=True``
    the walker fleet; the simulator refuses an unknown dispatch and a
    guided run on a kernel with no hunt_score."""
    from tpuvsr_torch.testing import counter_binding, stub_model_factory
    r = device_simulate(counter_binding(), num=32, depth=6, seed=1,
                        walkers=16, chunk_steps=4,
                        model_factory=stub_model_factory(), device="cpu")
    want = stub_simulator(device="cpu").run(num=32, depth=6, seed=1)
    assert _sig(r) == _sig(want)
    f = device_simulate(counter_binding(), num=64, depth=8, seed=7,
                        walkers=64, chunk_steps=4, fleet=True,
                        model_factory=stub_model_factory(), device="cpu")
    assert f.ok and f.walks == 64
    with pytest.raises(ValueError, match="dispatch"):
        stub_simulator(device="cpu", dispatch="sparse")

    class NoScore:
        def __getattr__(self, n):
            if n == "hunt_score":
                raise AttributeError(n)
            return getattr(self.k, n)
    fac = stub_model_factory()

    def factory(spec, max_msgs=None):
        codec, k = fac(spec, max_msgs)
        ns = NoScore()
        ns.k = k
        return codec, ns
    with pytest.raises(ValueError, match="hunt_score"):
        DeviceSimulator(counter_binding(), walkers=8, guided=True,
                        model_factory=factory, device="cpu")


# ----------------------------------------------------------------------
# the VSR defect config
# ----------------------------------------------------------------------
def test_defect_histories_match_jax():
    """16 walkers, depth 12, seed 3, chunks of 4, MAX_MSGS 48, two
    rounds: every committed chunk's histories, steps and verdict."""
    js = JRec(jax_defect_shim(), max_msgs=48, walkers=16, chunk_steps=4,
              model_factory=_jax_factory)
    jr = js.run(num=32, depth=12, seed=3)
    ps = PRec(load_binding(DEFECT, "VSR"), max_msgs=48, walkers=16,
              chunk_steps=4, device="cpu")
    pr = ps.run(num=32, depth=12, seed=3)
    assert _sig(pr) == _sig(jr)
    assert len(ps.chunks) == 6
    _same_chunks(js.chunks, ps.chunks)
    assert ps.group_caps == [int(c) for c in js.group_caps]


def test_defect_bag_growth_matches_the_jax_record():
    """From MAX_MSGS 2 the bag fills, the table doubles and the chunk is
    redrawn from its entry states with the same keys, in both packages:
    every round's histories are the JAX record's."""
    want = json.load(open(RECORD))["growth"]
    ps = PRec(load_binding(DEFECT, "VSR"), max_msgs=want["max_msgs"],
              walkers=want["walkers"], chunk_steps=want["chunk_steps"],
              device="cpu")
    pr = ps.run(num=want["num"], depth=want["depth"], seed=want["seed"])
    assert ps.counters["grow_message_table"] >= 2
    assert (pr.ok, pr.walks, pr.steps, pr.violated_invariant) == \
        (want["ok"], want["walks"], want["steps"],
         want["violated_invariant"])
    assert int(ps.codec.shape.MAX_MSGS) == want["final_max_msgs"]
    per = -(-want["depth"] // want["chunk_steps"])
    rounds = [ps.chunks[i:i + per] for i in range(0, len(ps.chunks), per)]
    assert [{"digest": _digest([(a, p) for a, p, _s in r]),
             "steps": int(sum(s for _a, _p, s in r))} for r in rounds] \
        == want["rounds"]


# the record of test_defect_bag_growth_matches_the_jax_record
GROWTH = dict(walkers=16, depth=12, seed=3, max_msgs=2, chunk_steps=4,
              num=32)


if __name__ == "__main__":
    if sys.argv[1:2] != ["record"]:
        sys.exit(__doc__)
    doc = {"growth": record_defect(**GROWTH)}
    print(json.dumps(doc["growth"]), flush=True)
    with open(RECORD, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
