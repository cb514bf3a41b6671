"""Parity of the port's packed frontier (K4 pack/unpack, PackSpec and
its manifest digest) with the JAX package's, on the CPU (the port's
plain PyTorch versions).  Integer words: tolerance 0."""

import os

import numpy as np
import pytest
import torch

import jax

from tpuvsr.analysis.passes.widths import derive_ranges_from as j_ranges
from tpuvsr.engine.pack import build_pack_spec as j_build
from tpuvsr.frontend.cfg import parse_cfg_file as j_cfg
from tpuvsr.models.vsr import VSRCodec as JCodec
from tpuvsr.testing import stub_model_factory as j_stub
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tpuvsr_torch.analysis.widths import derive_ranges_from
from tpuvsr_torch.core.values import TLAError
from tpuvsr_torch.engine.carry import frontier_from_numpy
from tpuvsr_torch.engine.pack import PackSpec, build_pack_spec
from tpuvsr_torch.frontend.cfg import parse_cfg_file
from tpuvsr_torch.models.vsr import VSRCodec
from tpuvsr_torch.testing import StubCodec

DEFECT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "VSR_defect.cfg")


def _specs(layout):
    if layout == "stub":
        jc, _k = j_stub()(None)
        return j_build(jc), build_pack_spec(StubCodec())
    mm = int(layout.split("-")[1])
    jcfg, cfg = j_cfg(DEFECT), parse_cfg_file(DEFECT)
    js = j_build(JCodec(jcfg.constants, max_msgs=mm),
                 ranges=j_ranges(jcfg.constants, "VSR"))
    ps = build_pack_spec(VSRCodec(cfg.constants, max_msgs=mm),
                         ranges=derive_ranges_from(cfg.constants, "VSR"))
    return js, ps


def _in_range_rows(spec, n, seed):
    """Random rows whose every lane lies in its packed range (edges
    included: each lane's lo and hi appear)."""
    rng = np.random.default_rng(seed)
    lo = spec._lo.astype(np.int64)
    bits = spec._bits
    hi = np.where(bits >= 32, 2**31 - 1,
                  lo + (1 << np.minimum(bits, 31)) - 1)
    low = np.where(bits >= 32, -2**31, lo)
    flat = rng.integers(low, hi + 1, size=(n, spec.lanes))
    flat[0], flat[1] = low, hi
    return flat.astype(np.int32)


LAYOUTS = ["stub", "defect-32", "defect-48"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_and_manifest_match_jax(layout):
    js, ps = _specs(layout)
    assert ps.manifest() == js.manifest()
    assert (ps.lanes, ps.words, ps.version) == (js.lanes, js.words,
                                               js.version)
    assert PackSpec.from_manifest(js.manifest()).version == ps.version


def test_defect_layout_sizes():
    """476 packed bytes per state at MAX_MSGS=32, 660 at 48."""
    assert _specs("defect-32")[1].packed_bytes == 476
    js, ps = _specs("defect-48")
    assert (ps.dense_bytes, ps.packed_bytes) == (7212, 660)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("seed", [0, 1])
def test_pack_unpack_words_match_jax(layout, seed):
    js, ps = _specs(layout)
    flat = _in_range_rows(ps, 64, seed)
    batch = {k: flat[:, a:b].reshape((64,) + s)
             for k, s, a, b in ps._splits}
    jw = np.asarray(jax.vmap(js.pack)(batch))
    pw = ps.pack(torch.from_numpy(flat))
    assert np.array_equal(pw.numpy().view(np.uint32), jw)
    ju = jax.vmap(js.unpack)(jw)
    pu = ps.unflatten(ps.unpack(pw))
    for k in ju:
        assert np.array_equal(np.asarray(ju[k]), pu[k].numpy()), k
    assert np.array_equal(ps.unpack(pw).numpy(), flat)


def test_pack_scatter_and_unpack_gather():
    """The fused forms: pack into rows dest of a buffer (-1 skips) and
    unpack a gathered subset of rows."""
    _js, ps = _specs("defect-32")
    flat = torch.from_numpy(_in_range_rows(ps, 20, 5))
    out = torch.full((30, ps.words), 7, dtype=torch.int32)
    dest = torch.arange(29, 9, -1, dtype=torch.int32)
    dest[::4] = -1
    ps.pack(flat, out=out, dest=dest)
    words = ps.pack(flat)
    for b in range(20):
        if dest[b] >= 0:
            assert torch.equal(out[dest[b]], words[b])
    assert (out[:10] == 7).all()
    rows = torch.tensor([3, 0, 19, 3])
    assert torch.equal(ps.unpack(words, rows), flat[rows])


def test_frontier_carry_checks_the_digest():
    js, ps = _specs("defect-32")
    flat = _in_range_rows(ps, 8, 2)
    rows = js.pack_np({k: flat[:, a:b].reshape((8,) + s)
                       for k, s, a, b in ps._splits})
    f = frontier_from_numpy(rows, js.manifest(), ps, device="cpu")
    assert np.array_equal(ps.unpack(f).numpy(), flat)
    j48, _p48 = _specs("defect-48")
    with pytest.raises(TLAError):
        frontier_from_numpy(rows, j48.manifest(), ps, device="cpu")
