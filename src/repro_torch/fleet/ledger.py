"""The append-only seed ledger: records, commits, binary wire format.

One training step of one worker is a ``Record``. Record v2 carries a
**numerics tag** — the record's wire tag byte selects the lane — with
one probe-entry layout per numerics:

  fp32 ('R'):
    R | step u32 | worker u8 | m u8 | loss f32
      | m x (probe seed u64, loss-diff f32)        <- 12 B/probe (ZO)
      | n_leaves u16 | n x (flat size u32, scale f32) | int8 payload

  int8 ('I', ElasticZO-INT8 / Alg. 2):
    I | step u32 | worker u8 | m u8 | loss f32
      | m x (probe seed u64, ternary g i8)         <- 9 B/probe (ZO)
      | n_leaves u16 | n x (flat size u32) | int8 payload

The ZO part is the paper's punchline made literal: 12 bytes per probe
(8-byte seed + 4-byte scalar) — or **9 bytes** in the int8 lane, where
the projected gradient is the ternary sign — carries the *entire* ZO
gradient of an arbitrarily large model half. ``deltas`` holds the
per-probe scalar in the lane's own dtype: fp32 loss-diffs, or int8
ternary signs.

The tail payload is the worker's BP-tail contribution: fp32 lane — the
probe-summed tail gradient, per-tensor-scaled int8 with error feedback
(train/compress.py); int8 lane — the saturating int8 sum of the NITI
per-probe weight updates (already int8-native, no scale on the wire;
the weight exponents never move, so dequantization state is static
schema).

The coordinator closes a step with a ``Commit``. v1 is filter-free:

    C | step u32 | accepted-worker bitmask u32

v2 additionally carries the Byzantine-robust filter outcome
(fleet/robust.py): the quarantine set active during the step and the
post-filter per-probe in-band bitmask (LSB-first over global probe ids):

    V | step u32 | accepted u32 | quarantined u32
      | n_filter_bytes u8 | filter bitmask bytes

Old v1 commits decode as filter-free (``filtered is None``,
``quarantined == 0``); a v1 writer is emitted whenever both fields are
trivial, so filter-free ledgers stay byte-identical to the pre-robust
protocol. A commit plus its accepted records is a pure function from
params(step) to params(step+1) — see fleet/replay.py — so a ledger slice
*is* a checkpoint delta (train/checkpoint.py delta mode stores exactly
that).

Tail leaf shapes/order are out-of-band schema (ReplaySchema), shared at
enrollment; records carry only flat sizes as a consistency check.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import obs

_REC_HDR = struct.Struct("<BIBBf")        # tag, step, worker, m, loss
_PROBE = struct.Struct("<Qf")             # seed u64, loss-diff f32
_PROBE8 = struct.Struct("<Qb")            # seed u64, ternary g i8
_LEAF_HDR = struct.Struct("<If")          # flat size u32, scale f32
_LEAF_HDR8 = struct.Struct("<I")          # flat size u32 (int8: no scale)
_COMMIT = struct.Struct("<BII")           # tag, step, accepted bitmask
_COMMIT2 = struct.Struct("<BIIIB")        # tag, step, accepted, quarantined,
#                                           n filter-mask bytes
_TAG_R, _TAG_C, _TAG_I = 0x52, 0x43, 0x49  # 'R' fp32, 'C' commit, 'I' int8
_TAG_V = 0x56                              # 'V' commit v2 (robust-filtered)


def pack_bits(bits: np.ndarray) -> bytes:
    """bool[n] -> LSB-first bitmask bytes (bit i of byte i//8 = bits[i])."""
    return np.packbits(np.asarray(bits, bool), bitorder="little").tobytes()


def unpack_bits(buf: bytes, n: int) -> np.ndarray:
    """LSB-first bitmask bytes -> bool[n]."""
    if len(buf) * 8 < n:
        raise ValueError(f"filter bitmask holds {len(buf) * 8} bits, "
                         f"need {n}")
    return np.unpackbits(np.frombuffer(buf, np.uint8), count=n,
                         bitorder="little").astype(bool)


@dataclass
class Record:
    step: int
    worker: int
    seeds: np.ndarray                     # uint64 [m]
    deltas: np.ndarray                    # fp32 loss-diffs | int8 signs
    loss: float                           # mean fp32 loss over probes
    tail_q: List[np.ndarray] = field(default_factory=list)   # int8, flat
    tail_scales: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.float32))
    numerics: str = "fp32"                # record-v2 numerics tag

    @property
    def zo_probe_nbytes(self) -> int:
        """Wire bytes of ONE probe entry (the paper's headline number)."""
        return _PROBE8.size if self.numerics == "int8" else _PROBE.size

    @property
    def zo_nbytes(self) -> int:
        """Wire bytes of the ZO part (header + probe entries)."""
        return _REC_HDR.size + self.zo_probe_nbytes * len(self.seeds)

    @property
    def tail_nbytes(self) -> int:
        leaf_hdr = _LEAF_HDR8 if self.numerics == "int8" else _LEAF_HDR
        return 2 + sum(leaf_hdr.size + q.size for q in self.tail_q)

    @property
    def nbytes(self) -> int:
        return self.zo_nbytes + self.tail_nbytes

    def to_bytes(self) -> bytes:
        tag = _TAG_I if self.numerics == "int8" else _TAG_R
        out = [_REC_HDR.pack(tag, self.step, self.worker,
                             len(self.seeds), float(self.loss))]
        if self.numerics == "int8":
            for s, g in zip(self.seeds, self.deltas):
                out.append(_PROBE8.pack(int(s), int(g)))
            out.append(struct.pack("<H", len(self.tail_q)))
            for q in self.tail_q:
                out.append(_LEAF_HDR8.pack(q.size))
        else:
            for s, d in zip(self.seeds, self.deltas):
                out.append(_PROBE.pack(int(s), float(d)))
            out.append(struct.pack("<H", len(self.tail_q)))
            for q, sc in zip(self.tail_q, self.tail_scales):
                out.append(_LEAF_HDR.pack(q.size, float(sc)))
        for q in self.tail_q:
            out.append(np.ascontiguousarray(q, np.int8).tobytes())
        return b"".join(out)


@dataclass
class Commit:
    step: int
    accepted: int                         # bitmask over worker ids
    # -- v2 (Byzantine-robust) fields; trivial values write the v1 form --
    quarantined: int = 0                  # bitmask: excluded this step
    filtered: Optional[bytes] = None      # per-probe in-band bitmask
    #                                       (LSB-first); None = filter-free

    def workers(self, num_workers: int) -> List[int]:
        return [w for w in range(num_workers) if self.accepted >> w & 1]

    @property
    def version(self) -> int:
        return 2 if (self.quarantined or self.filtered is not None) else 1

    def inband(self, n_probes: int) -> np.ndarray:
        """bool[n]: the post-filter in-band verdict (all ones if v1)."""
        if self.filtered is None:
            return np.ones((n_probes,), bool)
        return unpack_bits(self.filtered, n_probes)

    @property
    def nbytes(self) -> int:
        if self.version == 1:
            return _COMMIT.size
        return _COMMIT2.size + len(self.filtered or b"")

    def to_bytes(self) -> bytes:
        if self.version == 1:
            return _COMMIT.pack(_TAG_C, self.step, self.accepted)
        bits = self.filtered or b""
        if len(bits) > 255:
            raise ValueError("commit filter mask exceeds u8 length field")
        return _COMMIT2.pack(_TAG_V, self.step, self.accepted,
                             self.quarantined, len(bits)) + bits


def _parse_record(buf: bytes, off: int, numerics: str):
    _, step, worker, m, loss = _REC_HDR.unpack_from(buf, off)
    off += _REC_HDR.size
    seeds = np.zeros((m,), np.uint64)
    if numerics == "int8":
        deltas = np.zeros((m,), np.int8)
        for i in range(m):
            s, g = _PROBE8.unpack_from(buf, off)
            off += _PROBE8.size
            seeds[i], deltas[i] = s, np.int8(g)
    else:
        deltas = np.zeros((m,), np.float32)
        for i in range(m):
            s, d = _PROBE.unpack_from(buf, off)
            off += _PROBE.size
            seeds[i], deltas[i] = s, np.float32(d)
    (n_leaves,) = struct.unpack_from("<H", buf, off)
    off += 2
    sizes: List[int] = []
    if numerics == "int8":
        scales = np.zeros((0,), np.float32)
        for _ in range(n_leaves):
            (sz,) = _LEAF_HDR8.unpack_from(buf, off)
            off += _LEAF_HDR8.size
            sizes.append(sz)
    else:
        scales = np.zeros((n_leaves,), np.float32)
        for i in range(n_leaves):
            sz, sc = _LEAF_HDR.unpack_from(buf, off)
            off += _LEAF_HDR.size
            sizes.append(sz)
            scales[i] = np.float32(sc)
    tail_q = []
    for sz in sizes:
        if off + sz > len(buf):
            raise ValueError(f"truncated ledger payload at offset {off}")
        tail_q.append(np.frombuffer(buf, np.int8, count=sz, offset=off).copy())
        off += sz
    rec = Record(step, worker, seeds, deltas, float(np.float32(loss)),
                 tail_q, scales, numerics=numerics)
    return rec, off


class Ledger:
    """Append-only store of records and commits, with bytes accounting.

    ``records[step][worker]`` holds only records the coordinator accepted
    (dropped/straggler records never enter the canonical ledger — their
    probes are masked by the commit instead).
    """

    def __init__(self):
        self.records: Dict[int, Dict[int, Record]] = {}
        self.commits: Dict[int, Commit] = {}
        self.bytes_zo = 0
        self.bytes_tail = 0

    @property
    def nbytes(self) -> int:
        return self.bytes_zo + self.bytes_tail \
            + _COMMIT.size * len(self.commits)

    def append_record(self, rec: Record):
        self.records.setdefault(rec.step, {})[rec.worker] = rec
        self.bytes_zo += rec.zo_nbytes
        self.bytes_tail += rec.tail_nbytes
        led = obs.get().memory
        if led.armed:
            # append-only by design: ledgers only ever grow, so these
            # tags are never freed — live == cumulative appended bytes
            # across every Ledger instance (coordinator, gossip peers,
            # and transient replay slices alike)
            led.alloc("fleet.ledger.zo", rec.zo_nbytes)
            led.alloc("fleet.ledger.tail", rec.tail_nbytes)

    def append_commit(self, commit: Commit):
        if commit.step in self.commits:    # raise, not assert: must hold
            raise ValueError(               # under python -O too
                f"ledger is append-only: step {commit.step} already closed")
        self.commits[commit.step] = commit
        led = obs.get().memory
        if led.armed:
            led.alloc("fleet.ledger.commit", commit.nbytes)

    def last_step(self) -> Optional[int]:
        return max(self.commits) if self.commits else None

    def step_entries(self, step: int) -> Tuple[Commit, Dict[int, Record]]:
        return self.commits[step], self.records.get(step, {})

    # ---- wire / persistence -------------------------------------------- #
    def slice_bytes(self, lo: int, hi: int) -> bytes:
        """Serialized commits + accepted records for steps in [lo, hi)."""
        out = []
        for step in range(lo, hi):
            if step not in self.commits:
                continue
            out.append(self.commits[step].to_bytes())
            for w in sorted(self.records.get(step, {})):
                out.append(self.records[step][w].to_bytes())
        return b"".join(out)

    def to_bytes(self) -> bytes:
        if not self.commits:
            return b""
        return self.slice_bytes(min(self.commits), max(self.commits) + 1)

    @classmethod
    def from_bytes(cls, buf: bytes) -> "Ledger":
        led = cls()
        off = 0
        try:
            while off < len(buf):
                tag = buf[off]
                if tag == _TAG_C:
                    _, step, mask = _COMMIT.unpack_from(buf, off)
                    off += _COMMIT.size
                    led.append_commit(Commit(step, mask))
                elif tag == _TAG_V:
                    _, step, mask, quar, nb = _COMMIT2.unpack_from(buf, off)
                    off += _COMMIT2.size
                    if off + nb > len(buf):
                        raise ValueError(
                            f"truncated commit filter mask at offset {off}")
                    bits = buf[off:off + nb] if nb else None
                    off += nb
                    led.append_commit(Commit(step, mask, quarantined=quar,
                                             filtered=bits))
                elif tag == _TAG_R:
                    rec, off = _parse_record(buf, off, "fp32")
                    led.append_record(rec)
                elif tag == _TAG_I:
                    rec, off = _parse_record(buf, off, "int8")
                    led.append_record(rec)
                else:
                    raise ValueError(
                        f"bad ledger tag {tag:#x} at offset {off}")
        except struct.error as e:
            raise ValueError(f"truncated ledger buffer at offset {off}: {e}") \
                from e
        return led
