"""Packed bit-planed frontier encoding, and kernel K4 (pack/unpack).

A copy of ``tpuvsr/engine/pack.py``: ``PackSpec``, ``build_pack_spec``,
the manifest and its digest are identical, so a frontier packed by the
JAX package unpacks here and the other way round.  Each lane of a dense
state row is biased by its lower bound and laid into a contiguous bit
stream of uint32 words (a lane may straddle two words); a row costs
``ceil(total_bits / 32)`` words instead of one word per lane.

Unlike the JAX package's pack, which masks a value to its lane's width
with no check (so a value past its plane's bound silently wraps), the
port's pack refuses one: the plain version raises ``TLAError`` at once,
and the kernel sets a one-word flag on the card (``range_flag``) that the
engines read with the host read they make anyway (a tile's in ``run()``,
a quantum's in ``run_fused()``) and raise on (``raise_if_out_of_range``).

The port holds a dense batch as one flat ``[B, lanes]`` int32 tensor
(``flatten``/``unflatten`` convert to and from the per-plane dict, in
the codec's ``zero_state`` plane order) and packed words as int32 bit
patterns of the uint32 words.  ``pack``/``unpack`` are the K4 wrappers:
a CPU tensor takes the plain PyTorch version (``pack_plain``,
``unpack_plain``), a CUDA tensor the kernel in ``csrc/pack.cu``.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from .. import kernels
from ..core.values import TLAError

WORD_BITS = 32
_FULL = np.uint32(0xFFFFFFFF)
MASK32 = 0xFFFFFFFF


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any int tensor) -> int64 in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def _bits_for(lo, hi):
    """Bits needed to store values lo..hi (biased by -lo); >= 32 falls
    back to a raw 32-bit lane (lo forced to 0 so negative int32 values
    round-trip through the uint32 reinterpretation)."""
    span = int(hi) - int(lo)
    if span < 0:
        raise TLAError(f"packing bound ({lo}, {hi}) is empty")
    bits = max(1, span.bit_length())
    if bits >= WORD_BITS:
        return 0, WORD_BITS
    return int(lo), bits


def _normalize_bounds(key, shape, bound):
    """One plane's declared bound -> per-lane (lo, bits) numpy vectors.

    ``bound`` is ``(lo, hi)`` (uniform) or a sequence of per-column
    ``(lo, hi)`` pairs applying along the plane's LAST axis; ``None``
    keeps raw 32-bit lanes."""
    lanes = int(np.prod(shape) or 1)
    if bound is None:
        return (np.zeros(lanes, np.int64),
                np.full(lanes, WORD_BITS, np.int64), None)
    if isinstance(bound, tuple) and len(bound) == 2 and \
            not isinstance(bound[0], (tuple, list)):
        lo, bits = _bits_for(*bound)
        return (np.full(lanes, lo, np.int64),
                np.full(lanes, bits, np.int64), (lo, bits))
    cols = list(bound)
    if not shape or shape[-1] != len(cols):
        raise TLAError(
            f"plane {key!r}: per-column bounds ({len(cols)} entries) "
            f"do not match the last axis of shape {shape}")
    per = [_bits_for(*b) for b in cols]
    reps = lanes // len(cols)
    lo = np.tile(np.asarray([p[0] for p in per], np.int64), reps)
    bits = np.tile(np.asarray([p[1] for p in per], np.int64), reps)
    return lo, bits, [list(p) for p in per]


class PackSpec:
    """Static layout of the packed row format for one codec binding.

    ``entries`` is a list of ``(key, shape, lo_norm, bits_norm)`` in
    the codec's ``zero_state`` plane order; lo/bits are normalized to
    either an ``(lo, bits)`` pair or a per-column list."""

    def __init__(self, entries):
        self.entries = entries
        self.keys = [e[0] for e in entries]
        self.shapes = {e[0]: tuple(e[1]) for e in entries}
        lo_parts, bit_parts, self._splits = [], [], []
        pos = 0
        for key, shape, _norm, (lo_vec, bits_vec) in (
                (e[0], e[1], e[2], e[3]) for e in entries):
            lanes = lo_vec.shape[0]
            self._splits.append((key, tuple(shape), pos, pos + lanes))
            pos += lanes
            lo_parts.append(lo_vec)
            bit_parts.append(bits_vec)
        self.lanes = pos
        lo = np.concatenate(lo_parts)
        bits = np.concatenate(bit_parts)
        start = np.concatenate([[0], np.cumsum(bits)[:-1]])
        self.total_bits = int(bits.sum())
        self.words = max(1, -(-self.total_bits // WORD_BITS))
        self._lo = lo.astype(np.int32)
        self._bits = bits
        self._mask = np.where(
            bits >= WORD_BITS, _FULL,
            (np.uint64(1) << bits.astype(np.uint64)) - 1
        ).astype(np.uint32)
        self._widx = (start // WORD_BITS).astype(np.int32)
        self._off = (start % WORD_BITS).astype(np.uint32)
        self._hishift = (WORD_BITS - 1 - self._off).astype(np.uint32)
        canon = [[k, list(s), n] for k, s, n, _v in entries]
        self.version = hashlib.sha256(
            json.dumps(canon, sort_keys=True).encode()).hexdigest()[:12]
        # word -> the (lane, low/high part) fields it holds, for the
        # pack kernel: a lane's low part lands in word widx, its high
        # part (the bits past the word's end) in word widx + 1
        pairs = sorted(
            [(int(w), lane, 0) for lane, w in enumerate(self._widx)]
            + [(int(w) + 1, lane, 1) for lane, w in enumerate(self._widx)
               if int(w) + 1 < self.words
               and int(self._off[lane]) + int(bits[lane]) > WORD_BITS])
        self._word_ptr = np.searchsorted(
            np.asarray([p[0] for p in pairs], np.int64),
            np.arange(self.words + 1)).astype(np.int32)
        self._word_lane = np.asarray([p[1] for p in pairs], np.int32)
        self._word_part = np.asarray([p[2] for p in pairs], np.uint8)
        self._dev = {}
        self._flags = {}

    # -- sizing --------------------------------------------------------
    @property
    def dense_bytes(self):
        """Bytes of one dense int32 row (the format packing replaces)."""
        return self.lanes * 4

    @property
    def packed_bytes(self):
        return self.words * 4

    @property
    def ratio(self):
        return self.dense_bytes / self.packed_bytes

    # -- manifest ------------------------------------------------------
    def manifest(self):
        """JSON-able description: enough to rebuild the exact layout
        (``from_manifest``) plus the ``version`` digest."""
        return {"version": self.version, "words": self.words,
                "planes": [[k, list(s), n]
                           for k, s, n, _v in self.entries]}

    @classmethod
    def from_manifest(cls, mf):
        entries = []
        for key, shape, norm in mf["planes"]:
            shape = tuple(shape)
            if norm is None:
                bound = None
            elif norm and isinstance(norm[0], list):
                bound = [(lo, lo + (1 << b) - 1) if b < WORD_BITS
                         else None for lo, b in norm]
                bound = [(0, (1 << 31)) if b is None else b
                         for b in bound]
            else:
                lo, b = norm
                bound = (lo, lo + (1 << b) - 1) if b < WORD_BITS \
                    else (0, 1 << 31)
            lo_vec, bits_vec, norm2 = _normalize_bounds(key, shape,
                                                        bound)
            entries.append((key, shape, norm2, (lo_vec, bits_vec)))
        spec = cls(entries)
        if spec.version != mf["version"] or spec.words != mf["words"]:
            raise TLAError(
                f"packing manifest is internally inconsistent "
                f"(version {mf['version']} / {mf['words']} words vs "
                f"rebuilt {spec.version} / {spec.words})")
        return spec

    # -- flat dense rows -----------------------------------------------
    def flatten(self, batch) -> torch.Tensor:
        """Dense batch dict (``[B, ...plane]`` int32 tensors) -> flat
        ``[B, lanes]`` int32 in plane order."""
        first = batch[self._splits[0][0]]
        b = first.shape[0]
        return torch.cat([batch[k].reshape(b, -1).to(torch.int32)
                          for k, _s, _a, _b in self._splits], dim=1)

    def unflatten(self, flat: torch.Tensor) -> dict:
        """Flat ``[B, lanes]`` -> dict of per-plane views."""
        b = flat.shape[0]
        return {k: flat[:, a:e].reshape((b,) + s)
                for k, s, a, e in self._splits}

    def tables(self, device) -> dict:
        """The per-lane and per-word tables as tensors on ``device``
        (built once per device)."""
        key = str(torch.device(device))
        t = self._dev.get(key)
        if t is None:
            i32 = torch.int32
            t = {"lo": torch.as_tensor(self._lo, dtype=i32),
                 "mask": torch.as_tensor(self._mask.view(np.int32)),
                 "widx": torch.as_tensor(self._widx, dtype=i32),
                 "off": torch.as_tensor(self._off.view(np.int32)),
                 "hishift": torch.as_tensor(self._hishift.view(np.int32)),
                 "word_ptr": torch.as_tensor(self._word_ptr),
                 "word_lane": torch.as_tensor(self._word_lane),
                 "word_part": torch.as_tensor(self._word_part)}
            t = {k: v.to(device) for k, v in t.items()}
            self._dev[key] = t
        return t

    # -- the range check ---------------------------------------------
    def range_flag(self, device) -> torch.Tensor:
        """The one-word int32 flag the pack kernel sets on ``device``
        when it meets a value outside its lane's bound (built once per
        device, zero until then; a CUDA graph holds its address).
        ``"cuda"`` names the current card, as a tensor's ``cuda:N``
        does: the engines and the kernel share one flag."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = str(dev)
        t = self._flags.get(key)
        if t is None:
            t = self._flags[key] = torch.zeros((1,), dtype=torch.int32,
                                               device=device)
        return t

    def range_error(self, flat=None) -> str:
        """The message of an out-of-bound pack: the first offending lane
        of ``flat`` when given (the plain version knows it)."""
        msg = ("pack: a state value lies outside its plane's pack bound "
               "(the packed frontier would wrap it)")
        if flat is None:
            return msg
        lo = torch.as_tensor(self._lo, dtype=torch.int64)
        v = (flat.cpu().to(torch.int64) - lo) & MASK32
        bad = v > torch.as_tensor(self._mask.astype(np.int64))
        b, lane = (int(x) for x in torch.nonzero(bad)[0])
        key = next(k for k, _s, a, e in self._splits if a <= lane < e)
        hi = int(self._lo[lane]) + int(self._mask[lane])
        return (f"{msg}: plane {key!r}, lane {lane}, value "
                f"{int(flat[b, lane])} not in [{int(self._lo[lane])}, "
                f"{hi}]")

    def raise_if_out_of_range(self, flag_value: int) -> None:
        """Raise when a read-back value of ``range_flag`` is set."""
        if flag_value:
            raise TLAError(self.range_error())

    def _check_plain(self, flat, dest, v, mask):
        """Raise on a packed row of ``flat`` whose biased values ``v``
        exceed the lane masks ``mask``."""
        wide = v > mask
        if dest is not None:
            wide = wide[dest >= 0]
        if bool(wide.any()):
            raise TLAError(self.range_error(
                flat if dest is None else flat[dest >= 0]))

    # -- K4: pack ------------------------------------------------------
    def pack(self, flat: torch.Tensor, out: torch.Tensor = None,
             dest: torch.Tensor = None) -> torch.Tensor:
        """Flat ``[B, lanes]`` int32 -> packed ``[B, words]`` int32
        words; with ``out`` and ``dest`` ([B] int32 row indices, -1 =
        skip) the rows are written into ``out[dest]`` instead (the
        fused commit's scatter into the next-frontier buffer).  A packed
        row with a value outside its lane's bound raises (CPU) or sets
        ``range_flag`` (CUDA)."""
        if flat.device.type == "cpu":
            return self.pack_plain(flat, out, dest)
        return self._pack_kernel(flat, out, dest)

    def _pack_kernel(self, flat, out, dest):
        B = flat.shape[0]
        t = self.tables(flat.device)
        if out is None:
            out = torch.empty((B, self.words), dtype=torch.int32,
                              device=flat.device)
        ck = kernels.check
        kernels.launch(
            "pack", "tpuvsr_pack",
            ck(flat, "flat", torch.int32, (B, self.lanes)), B, self.lanes,
            self.words, t["lo"].data_ptr(), t["mask"].data_ptr(),
            t["off"].data_ptr(), t["hishift"].data_ptr(),
            t["word_ptr"].data_ptr(), t["word_lane"].data_ptr(),
            t["word_part"].data_ptr(),
            None if dest is None else ck(dest, "dest", torch.int32, (B,)),
            ck(out, "out", torch.int32, (out.shape[0], self.words)),
            self.range_flag(flat.device).data_ptr(),
            kernels.stream_of(flat))
        return out

    def pack_plain(self, flat, out=None, dest=None):
        """Plain PyTorch version of ``pack`` (any device); raises
        ``TLAError`` on a packed row with a value outside its bound."""
        t = self.tables(flat.device)
        lo, mask = t["lo"].to(torch.int64), to_u32(t["mask"])
        v = (flat.to(torch.int64) - lo) & MASK32
        self._check_plain(flat, dest, v, mask)
        v = v & mask
        off = to_u32(t["off"])
        lo_w = (v << off) & MASK32
        hi_w = (v >> to_u32(t["hishift"])) >> 1
        widx = t["widx"].to(torch.int64)
        words = torch.zeros((flat.shape[0], self.words + 1),
                            dtype=torch.int64, device=flat.device)
        words.index_add_(1, widx, lo_w)
        words.index_add_(1, widx + 1, hi_w)
        words = to_i32(words[:, :self.words] & MASK32)
        if out is None:
            return words
        keep = dest >= 0
        out[dest[keep].to(torch.int64)] = words[keep]
        return out

    # -- K4: unpack ----------------------------------------------------
    def unpack(self, packed: torch.Tensor,
               rows: torch.Tensor = None) -> torch.Tensor:
        """Packed ``[N, words]`` int32 words -> flat ``[B, lanes]``
        int32 of rows ``rows`` ([B] int64 indices; all N rows when
        None)."""
        if packed.device.type == "cpu":
            return self.unpack_plain(packed, rows)
        return self._unpack_kernel(packed, rows)

    def _unpack_kernel(self, packed, rows):
        B = packed.shape[0] if rows is None else rows.shape[0]
        t = self.tables(packed.device)
        flat = torch.empty((B, self.lanes), dtype=torch.int32,
                           device=packed.device)
        ck = kernels.check
        kernels.launch(
            "unpack", "tpuvsr_unpack",
            ck(packed, "packed", torch.int32,
               (packed.shape[0], self.words)),
            None if rows is None else ck(rows, "rows", torch.int64, (B,)),
            B, self.lanes, self.words, t["lo"].data_ptr(),
            t["mask"].data_ptr(), t["widx"].data_ptr(), t["off"].data_ptr(),
            t["hishift"].data_ptr(), flat.data_ptr(),
            kernels.stream_of(packed))
        return flat

    def unpack_plain(self, packed, rows=None):
        """Plain PyTorch version of ``unpack`` (any device)."""
        t = self.tables(packed.device)
        w = to_u32(packed if rows is None else packed[rows])
        widx = t["widx"].to(torch.int64)
        w0 = w[:, widx]
        w1 = w[:, torch.clamp(widx + 1, max=self.words - 1)]
        v = ((w0 >> to_u32(t["off"]))
             | (((w1 << to_u32(t["hishift"])) << 1) & MASK32))
        v = v & to_u32(t["mask"])
        return to_i32((v + t["lo"].to(torch.int64)) & MASK32)


def build_pack_spec(codec, ranges=None, tighten=None):
    """Derive the :class:`PackSpec` for a codec binding
    (``tpuvsr/engine/pack.py:288-330``).

    ``ranges`` is the widths table (``analysis.widths.
    derive_ranges_from``).  Codecs that declare no ``plane_bounds``
    return None.  ``tighten`` is the bounds pass's reachable-interval
    map (``BoundsFacts.plane_tighten()``): a plane whose declared bound
    is uniform (or absent) gets it intersected with its reachable
    interval, so it packs in fewer bits, and the round trip stays exact
    for every reachable state; per-column declared tables keep their
    own budgets.  K4's range flag then holds the tightened bounds."""
    if not hasattr(codec, "plane_bounds"):
        return None
    bounds = codec.plane_bounds(ranges or {})
    zero = codec.zero_state()
    if tighten:
        bounds = dict(bounds)
        for key, (tlo, thi) in tighten.items():
            if key not in zero:
                continue                    # not a plane of this codec
            cur = bounds.get(key)
            if cur is None:
                bounds[key] = (int(tlo), int(thi))
            elif isinstance(cur, tuple) and len(cur) == 2 and \
                    not isinstance(cur[0], (tuple, list)):
                lo, hi = max(cur[0], int(tlo)), min(cur[1], int(thi))
                if lo <= hi:
                    bounds[key] = (lo, hi)  # reachable and declared
    entries = []
    for key, z in zero.items():
        shape = tuple(np.shape(z))
        lo_vec, bits_vec, norm = _normalize_bounds(
            key, shape, bounds.get(key))
        entries.append((key, shape, norm, (lo_vec, bits_vec)))
    return PackSpec(entries)
