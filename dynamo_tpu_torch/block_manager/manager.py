"""Tiered block pool: a host arena (G2), disk spill (G3) and the registry.

The port's own copy of dynamo_tpu/block_manager/manager.py. The device tier
(G1) is the engine's paged cache; this manager takes the blocks the engine
offloads and serves them back on prefix hits. Its numpy interface is the
reference's: blocks ``[L, Hkv, n, bs, D]`` in the layout's wire form
(bfloat16 as uint16 words), int8 tiers with ``[L, Hkv, n]`` f32 scales; the
same calls give the same lookups, evictions, stats, disk pages and
manifests.

The host arena is one CPU tensor per K and V (and per scale plane), pinned
when ``pin_memory`` is asked for and a card is present; the numpy
interface reads and writes its ``.numpy()`` view. The engine moves blocks
between the card and the arena through ``store_blocks_device`` and
``load_blocks_device``: blocks-first device tensors ``[n, L, Hkv, bs, D]``
(the runner's ``extract_pages`` / ``inject_pages``), one copy each way per
run of consecutive arena slots, and an explicit sync of the device's stream
before a checksum reads a slot or the lock lets a slot go.

The ``corrupt_kv`` fault point (``testing/faults.py``) flips a bit of each
newly stored block's K plane in the host arena, after its checksums were
taken (every store: numpy, int8 verbatim and the card's), and tears each
newly written G3 page, so load-time verification must catch it.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import struct
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from dynamo_tpu_torch import integrity
from dynamo_tpu_torch.block_manager.layout import LayoutConfig
from dynamo_tpu_torch.disagg.protocols import kv_dequantize_int8, kv_quantize_int8
from dynamo_tpu_torch.testing import faults

logger = logging.getLogger("dynamo_tpu_torch.block_manager")

# layout dtype -> (arena tensor dtype, numpy view dtype); bfloat16 is kept
# bit-exact as 16-bit words
_WIRE = {
    "bfloat16": (torch.int16, np.uint16),
    "float16": (torch.float16, np.float16),
    "float32": (torch.float32, np.float32),
}
_LOGICAL = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
_NP_DTYPES = {k: v[1] for k, v in _WIRE.items()}

# G3 spill page header: magic || k_sum || v_sum (64-bit checksums over the
# page's k-half and v-half, scales included). Pages written with
# DYN_KV_CHECKSUM=0 carry no header and load unverified.
_PAGE_MAGIC = b"KVB2"
_PAGE_HDR = struct.Struct(">4sQQ")


def _buf(a: np.ndarray) -> memoryview:
    """A contiguous array's bytes, read in place."""
    return memoryview(np.ascontiguousarray(a)).cast("B")


def _runs(pairs: list[tuple[int, int]]) -> list[tuple[int, int, int]]:
    """(i, slot) pairs -> (i0, slot0, n) runs where both advance by one."""
    out: list[tuple[int, int, int]] = []
    for i, s in pairs:
        if out and out[-1][0] + out[-1][2] == i and out[-1][1] + out[-1][2] == s:
            out[-1] = (out[-1][0], out[-1][1], out[-1][2] + 1)
        else:
            out.append((i, s, 1))
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


@dataclass
class BlockHandle:
    seq_hash: int
    tier: int  # 2 = host, 3 = disk
    index: int  # host arena slot (tier 2) or -1 (disk)
    # content checksums over the arena slot (+ scale plane) at store time;
    # 0 = unchecksummed (DYN_KV_CHECKSUM=0)
    k_sum: int = 0
    v_sum: int = 0


@dataclass
class BlockManagerStats:
    host_blocks_used: int = 0
    host_blocks_total: int = 0
    disk_blocks_used: int = 0
    offloaded_g2: int = 0
    spilled_g3: int = 0
    onboarded: int = 0
    hits: int = 0
    misses: int = 0
    # checksum failures at load / promote time, hashes quarantined (never
    # stored again) and stores refused because the hash is quarantined
    integrity_failures: int = 0
    quarantined: int = 0
    quarantine_refused: int = 0
    # warm restarts: checkpoint pages restored at boot, and pages refused
    # (bad checksum, truncated: never decoded, the prefix recomputes)
    warm_restored: int = 0
    warm_refused: int = 0


class TieredBlockManager:
    """Host + disk KV block cache keyed by sequence hash.

    Eviction: the host arena is LRU over its blocks (among the
    ``eviction_scan`` oldest, the one coldest fleet-wide goes first);
    evicted blocks spill to disk when a spill directory is set, else they
    are dropped. Disk keeps at most ``disk_blocks`` (0: no cap), oldest
    deleted first. ``on_event(kind, seq_hashes, tier)`` reports "stored" /
    "removed" per tier.
    """

    def __init__(
        self,
        layout: LayoutConfig,
        host_blocks: int,
        disk_dir: Optional[str] = None,
        disk_blocks: int = 0,
        on_event: Optional[Callable[[str, list[int], int], None]] = None,
        wire_codec: str = "raw",
        pin_memory: bool = False,
    ) -> None:
        self.layout = layout
        self.host_blocks = host_blocks
        self.disk_dir = disk_dir
        self.disk_blocks = disk_blocks
        self.on_event = on_event
        # "int8": the tiers hold per-(layer, head, block) f32 scales + int8
        # mantissas (half the bytes, a bounded error on onboard); "raw"
        # keeps them bit-exact
        self.wire_codec = "int8" if wire_codec == "int8" else "raw"
        int8 = self.wire_codec == "int8"
        wire = torch.int8 if int8 else _WIRE[layout.dtype][0]
        pin = bool(pin_memory) and torch.cuda.is_available()
        # blocks-first arenas [n, L, H, bs, D]: one block is one contiguous
        # slice (one copy in, one file write out)
        shape = (host_blocks, *layout.block_shape)
        self._k_host = torch.zeros(shape, dtype=wire, pin_memory=pin)
        self._v_host = torch.zeros(shape, dtype=wire, pin_memory=pin)
        view = np.int8 if int8 else _NP_DTYPES[layout.dtype]
        self._k_arena = self._k_host.numpy().view(view)
        self._v_arena = self._v_host.numpy().view(view)
        if int8:
            sshape = (host_blocks, *layout.block_shape[:-2])
            self._k_scales_host = torch.zeros(sshape, dtype=torch.float32, pin_memory=pin)
            self._v_scales_host = torch.zeros(sshape, dtype=torch.float32, pin_memory=pin)
            self._k_scales = self._k_scales_host.numpy()
            self._v_scales = self._v_scales_host.numpy()
        self._free_slots = list(range(host_blocks - 1, -1, -1))
        # seq_hash -> handle; the OrderedDict is the LRU (move_to_end)
        self._host: OrderedDict[int, BlockHandle] = OrderedDict()
        self._disk: OrderedDict[int, str] = OrderedDict()
        if disk_dir:
            os.makedirs(disk_dir, exist_ok=True)
        self.stats = BlockManagerStats(host_blocks_total=host_blocks)
        # quarantine: per-hash verification failures; a hash that fails
        # DYN_QUARANTINE_AFTER times is refused for good (its content-chain
        # hash names the same prefix forever: reuse lost, never correctness)
        self._fail_counts: dict[int, int] = {}
        self._quarantined: set[int] = set()
        # the prefix index: each stored hash's parent (hashes arrive in chain
        # order); kept in the warm-restart manifest for the block adverts
        self._parents: dict[int, Optional[int]] = {}
        self.quarantine_after = max(1, int(os.environ.get("DYN_QUARANTINE_AFTER", "2") or 2))
        # per-hash fleet access frequency (the router's pull plans); a block
        # hot fleet-wide outlives a locally idle one at eviction
        self._fleet_heat: dict[int, float] = {}
        self._fleet_heat_max = max(1, int(os.environ.get("DYN_FLEET_HEAT_MAX", "65536") or 65536))
        self.eviction_scan = max(1, int(os.environ.get("DYN_EVICT_SCAN", "8") or 8))
        # calls come from the engine's threads; one coarse lock guards the
        # arenas, the LRU dicts and the free list
        self._lock = threading.RLock()

    @property
    def pinned(self) -> bool:
        return self._k_host.is_pinned()

    @property
    def host_bytes(self) -> int:
        """Bytes the host arena holds (K, V and scale planes)."""
        parts = [self._k_host, self._v_host]
        if self.wire_codec == "int8":
            parts += [self._k_scales_host, self._v_scales_host]
        return sum(t.numel() * t.element_size() for t in parts)

    # ------------------------------------------------------------ queries

    def __contains__(self, seq_hash: int) -> bool:
        with self._lock:
            return seq_hash in self._host or seq_hash in self._disk

    def is_quarantined(self, seq_hash: int) -> bool:
        return seq_hash in self._quarantined

    def lookup_prefix(self, seq_hashes: list[int]) -> int:
        """Longest prefix (in blocks) of the hash chain present in any
        tier."""
        with self._lock:
            n = 0
            for h in seq_hashes:
                if h in self._host or h in self._disk:
                    n += 1
                else:
                    break
            if n:
                self.stats.hits += 1
            else:
                self.stats.misses += 1
            return n

    # ------------------------------------------------------------- stores

    def store_blocks(self, seq_hashes: list[int], k_blocks: np.ndarray,
                     v_blocks: np.ndarray) -> int:
        """Offload dense blocks [L, H, n, bs, D] (the wire form: bfloat16
        as uint16 words) into the host tier; returns how many were newly
        stored. Present hashes are skipped; under host pressure the LRU
        blocks spill to disk first."""
        kb = np.moveaxis(k_blocks, 2, 0)
        vb = np.moveaxis(v_blocks, 2, 0)
        ks = vs = None
        if self.wire_codec == "int8":
            kb, ks = kv_quantize_int8(kb, self.layout.dtype)
            vb, vs = kv_quantize_int8(vb, self.layout.dtype)
        elif kb.dtype.name == "bfloat16":
            kb, vb = kb.view(np.uint16), vb.view(np.uint16)
        return self._store(seq_hashes, self._numpy_fill(kb, vb, ks, vs))

    def store_blocks_quant(self, seq_hashes: list[int], kq: np.ndarray, ks: np.ndarray,
                           vq: np.ndarray, vs: np.ndarray) -> int:
        """Offload already-quantized blocks verbatim (an int8-resident
        cache's mantissas [L, H, n, bs, D] and scales [L, H, n]) into int8
        tiers: no recode, no double quantization."""
        assert self.wire_codec == "int8", "quant store needs int8 tiers"
        fill = self._numpy_fill(np.moveaxis(kq, 2, 0), np.moveaxis(vq, 2, 0),
                                np.moveaxis(ks, 2, 0), np.moveaxis(vs, 2, 0))
        return self._store(seq_hashes, fill)

    def store_blocks_device(self, seq_hashes: list[int], k: torch.Tensor, v: torch.Tensor,
                            ks: Optional[torch.Tensor] = None,
                            vs: Optional[torch.Tensor] = None) -> int:
        """Offload blocks-first tensors [n, L, H, bs, D] straight from the
        device into arena slots: the cache's logical dtype into raw tiers,
        or int8 mantissas with ``ks`` / ``vs`` [n, L, H] scales into int8
        tiers. One copy per run of consecutive slots, then the device's
        stream is synchronized before any checksum reads a slot."""
        int8 = self.wire_codec == "int8"
        if int8 != (ks is not None):
            raise ValueError("int8 tiers take mantissas with scales; raw tiers take blocks alone")
        if not int8 and k.dtype != _LOGICAL[self.layout.dtype]:
            raise ValueError(f"{k.dtype} blocks for {self.layout.dtype} tiers")
        dsts = [self._k_host, self._v_host]
        srcs = [k, v]
        if int8:
            dsts += [self._k_scales_host, self._v_scales_host]
            srcs += [ks, vs]
        else:
            # bfloat16 lands as its 16-bit words
            srcs = [t.view(dsts[0].dtype) for t in srcs]
        srcs = [t.contiguous() for t in srcs]

        def fill(pairs: list[tuple[int, int]]) -> None:
            for i, s, n in _runs(pairs):
                for dst, src in zip(dsts, srcs):
                    dst[s:s + n].copy_(src[i:i + n], non_blocking=True)
            _sync(k.device)

        return self._store(seq_hashes, fill)

    def _numpy_fill(self, kb, vb, ks, vs) -> Callable:
        def fill(pairs: list[tuple[int, int]]) -> None:
            for i, slot in pairs:
                self._k_arena[slot] = kb[i]
                self._v_arena[slot] = vb[i]
                if ks is not None:
                    self._k_scales[slot] = ks[i]
                    self._v_scales[slot] = vs[i]

        return fill

    def _store(self, seq_hashes: list[int], fill: Callable) -> int:
        """Register blocks in arena slots: each batch of at most
        ``host_blocks`` new hashes gets its slots (evicting older blocks),
        is written by ``fill([(index, slot), ...])``, then checksummed and
        registered, so no batch evicts a block that is not written yet."""
        checks = integrity.enabled()
        inj = faults.get_injector() if faults.active() else None
        stored: list[int] = []
        with self._lock:
            i = 0
            while i < len(seq_hashes):
                batch: list[tuple[int, int]] = []
                taken: set[int] = set()
                full = False
                while i < len(seq_hashes) and len(batch) < max(1, self.host_blocks):
                    h = seq_hashes[i]
                    self._record_parent(seq_hashes, i, h)
                    if h in self._quarantined:
                        # a poison block is refused for good: an offload round
                        # trip must not offer it for prefix reuse again
                        self.stats.quarantine_refused += 1
                    elif h in self._host:
                        self._host.move_to_end(h)
                    elif h not in self._disk and h not in taken:
                        slot = self._alloc_host_slot()
                        if slot is None:
                            full = True
                            break
                        batch.append((i, slot))
                        taken.add(h)
                    i += 1
                if batch:
                    fill(batch)
                    for j, slot in batch:
                        h = seq_hashes[j]
                        k_sum, v_sum = self._slot_sums(slot) if checks else (0, 0)
                        self._host[h] = BlockHandle(h, tier=2, index=slot, k_sum=k_sum,
                                                    v_sum=v_sum)
                        if inj is not None:
                            # corrupt_kv fault point (a host-RAM bit flip):
                            # after the checksums, so a load must catch it
                            inj.corrupt_array(self._k_arena[slot])
                        stored.append(h)
                if full:
                    break
            if stored:
                self.stats.offloaded_g2 += len(stored)
                self.stats.host_blocks_used = len(self._host)
        if stored and self.on_event:
            self.on_event("stored", stored, 2)
        return len(stored)

    def note_fleet_heat(self, seq_hashes: list[int], frequencies: list) -> None:
        """Record the router's fleet-wide access counts for these hashes;
        eviction reads them."""
        with self._lock:
            for h, f in zip(seq_hashes, frequencies):
                self._fleet_heat[h] = float(f)
            overflow = len(self._fleet_heat) - self._fleet_heat_max
            if overflow > 0:
                for h, _ in sorted(self._fleet_heat.items(), key=lambda kv: kv[1])[:overflow]:
                    del self._fleet_heat[h]

    def _alloc_host_slot(self) -> Optional[int]:
        if self._free_slots:
            return self._free_slots.pop()
        # evict: among the eviction_scan oldest, the coldest fleet-wide
        # (min is stable: equal heat falls back to pure LRU order)
        if not self._host:
            return None
        cands: list[int] = []
        for h in self._host:
            cands.append(h)
            if len(cands) >= self.eviction_scan:
                break
        old_hash = min(cands, key=lambda h: self._fleet_heat.get(h, 0.0))
        old = self._host.pop(old_hash)
        if self.disk_dir:
            self._spill_to_disk(old_hash, old)
        elif self.on_event:
            self.on_event("removed", [old_hash], 2)
        return old.index

    def _slot_sums(self, slot: int) -> tuple[int, int]:
        """Content checksums over one arena slot (and its scale plane)."""
        if self.wire_codec == "int8":
            return (integrity.checksum(_buf(self._k_arena[slot]), _buf(self._k_scales[slot])),
                    integrity.checksum(_buf(self._v_arena[slot]), _buf(self._v_scales[slot])))
        return (integrity.checksum(_buf(self._k_arena[slot])),
                integrity.checksum(_buf(self._v_arena[slot])))

    def _write_page(self, f, slot: int) -> None:
        f.write(_buf(self._k_arena[slot]))
        f.write(_buf(self._v_arena[slot]))
        if self.wire_codec == "int8":
            f.write(_buf(self._k_scales[slot]))
            f.write(_buf(self._v_scales[slot]))

    def _spill_to_disk(self, seq_hash: int, handle: BlockHandle) -> None:
        path = os.path.join(self.disk_dir, f"{seq_hash:#x}.kvb")
        with open(path, "wb") as f:
            if handle.k_sum or handle.v_sum:
                # the checksums travel with the page: a torn write is caught
                # at promote time even after a restart lost the handles
                f.write(_PAGE_HDR.pack(_PAGE_MAGIC, handle.k_sum, handle.v_sum))
            self._write_page(f, handle.index)
        if faults.active():
            inj = faults.get_injector()
            if inj is not None:
                # corrupt_kv fault point: tear the just-written G3 page
                inj.corrupt_file(path)
        self._disk[seq_hash] = path
        self.stats.spilled_g3 += 1
        self.stats.disk_blocks_used = len(self._disk)
        if self.on_event:
            self.on_event("stored", [seq_hash], 3)
        while self.disk_blocks and len(self._disk) > self.disk_blocks:
            h, p = self._disk.popitem(last=False)
            try:
                os.unlink(p)
            except OSError:
                pass
            if self.on_event:
                self.on_event("removed", [h], 3)
        self.stats.disk_blocks_used = len(self._disk)

    # -------------------------------------------------------------- loads

    def load_blocks(self, seq_hashes: list[int]) -> tuple[np.ndarray, np.ndarray]:
        """Fetch blocks for onboarding: [L, H, n, bs, D] in the layout's
        wire form whatever the tier codec (int8 tiers dequantize here; an
        int8-resident engine calls ``load_blocks_quant``). Disk blocks are
        promoted back into the host arena on read."""
        k, v, ks, vs = self._load_raw(seq_hashes)
        if self.wire_codec == "int8":
            k = kv_dequantize_int8(k, ks, self.layout.dtype)
            v = kv_dequantize_int8(v, vs, self.layout.dtype)
        return np.moveaxis(k, 0, 2), np.moveaxis(v, 0, 2)

    def load_blocks_quant(self, seq_hashes: list[int]) -> tuple[np.ndarray, ...]:
        """Fetch blocks WITHOUT dequantizing: (kq [L, H, n, bs, D] int8, ks
        [L, H, n] f32, vq, vs), for an int8-resident cache's verbatim
        inject. Verification and promotion as ``load_blocks``."""
        assert self.wire_codec == "int8", "quant load needs int8 tiers"
        k, v, ks, vs = self._load_raw(seq_hashes)
        return (np.moveaxis(k, 0, 2), np.moveaxis(ks, 0, 2),
                np.moveaxis(v, 0, 2), np.moveaxis(vs, 0, 2))

    def load_blocks_device(self, seq_hashes: list[int], device) -> tuple[torch.Tensor, ...]:
        """Fetch blocks straight into tensors on ``device``, blocks first:
        (k, v) [n, L, H, bs, D] in the layout's logical dtype from raw
        tiers, or (kq, ks, vq, vs) with [n, L, H] scales from int8 tiers
        (no dequantize). Host slots are verified and copied, one copy per
        run of consecutive slots; disk pages are verified, promoted and
        copied from their new slot. The stream is synchronized before the
        lock lets any slot go."""
        device = torch.device(device)
        L = self.layout
        n = len(seq_hashes)
        int8 = self.wire_codec == "int8"
        srcs = [self._k_host, self._v_host]
        if int8:
            srcs += [self._k_scales_host, self._v_scales_host]
        outs = [torch.empty((n, *t.shape[1:]), dtype=t.dtype, device=device) for t in srcs]
        with self._lock:
            pending = False
            pairs: list[tuple[int, int]] = []
            for i, h in enumerate(seq_hashes):
                hnd = self._host.get(h)
                if hnd is None:
                    if pending:
                        # a promotion may evict a slot still being copied
                        self._copy_runs(pairs, srcs, outs)
                        _sync(device)
                        pairs, pending = [], False
                    self._load_disk_page(h, [o[i] for o in outs])
                    continue
                self._verify_slot(h, hnd)
                self._host.move_to_end(h)
                pairs.append((i, hnd.index))
                pending = True
            self._copy_runs(pairs, srcs, outs)
            _sync(device)
            self.stats.onboarded += n
        if int8:
            return tuple(outs)
        return tuple(o.view(_LOGICAL[L.dtype]) for o in outs)

    @staticmethod
    def _copy_runs(pairs, srcs, outs) -> None:
        for i, s, r in _runs(pairs):
            for src, out in zip(srcs, outs):
                out[i:i + r].copy_(src[s:s + r], non_blocking=True)

    def _load_disk_page(self, h: int, dsts: list[torch.Tensor]) -> None:
        """Verify one disk page and promote it; ``dsts`` (K, V[, scales])
        get its content, from its new arena slot or, with none free, from
        the page bytes."""
        parts, k_sum, v_sum = self._read_page(h)
        slot = self._promote(h, parts, self._disk[h], k_sum, v_sum)
        if slot is not None:
            srcs = [self._k_host, self._v_host]
            if self.wire_codec == "int8":
                srcs += [self._k_scales_host, self._v_scales_host]
            for dst, src in zip(dsts, srcs):
                dst.copy_(src[slot])
            return
        for dst, part in zip(dsts, parts):
            dst.copy_(torch.from_numpy(np.ascontiguousarray(part)).view(dst.dtype))

    def _verify_slot(self, h: int, hnd: BlockHandle) -> None:
        if hnd.k_sum or hnd.v_sum:
            got_k, got_v = self._slot_sums(hnd.index)
            if got_k != hnd.k_sum or got_v != hnd.v_sum:
                # host-RAM corruption: free the slot (exactly once), note the
                # failure and refuse the load; the caller recomputes
                self._integrity_fail(h, "tier_host")
                raise integrity.IntegrityError(f"host block {h:#x} failed checksum",
                                               path="tier_host")

    def _read_page(self, h: int) -> tuple[list[np.ndarray], int, int]:
        """One disk page's (K, V[, k scales, v scales]) arrays and its
        header's checksums, verified."""
        L = self.layout
        int8 = self.wire_codec == "int8"
        store = np.int8 if int8 else _NP_DTYPES[L.dtype]
        sshape = L.block_shape[:-2]
        path = self._disk.get(h)
        if path is None:
            raise KeyError(f"block {h:#x} not cached")
        raw = np.fromfile(path, dtype=np.uint8)
        half = L.block_numel * np.dtype(store).itemsize
        snum = int(np.prod(sshape)) if int8 else 0
        k_sum = v_sum = 0
        if len(raw) >= _PAGE_HDR.size and raw[:len(_PAGE_MAGIC)].tobytes() == _PAGE_MAGIC:
            _, k_sum, v_sum = _PAGE_HDR.unpack(raw[:_PAGE_HDR.size].tobytes())
            raw = raw[_PAGE_HDR.size:]
        body = 2 * half + (2 * snum * 4 if int8 else 0)
        if len(raw) < body:
            # torn page (a truncated write)
            self._integrity_fail(h, "tier_disk")
            raise integrity.IntegrityError(
                f"disk page {h:#x} truncated ({len(raw)} < {body} bytes)", path="tier_disk")
        kb_ = raw[:half].tobytes()
        vb_ = raw[half:2 * half].tobytes()
        ksb = raw[2 * half:2 * half + snum * 4].tobytes()
        vsb = raw[2 * half + snum * 4:body].tobytes()
        if (k_sum or v_sum) and (integrity.checksum(kb_, ksb) != k_sum
                                 or integrity.checksum(vb_, vsb) != v_sum):
            # bit rot on disk: promotion fails, the page is deleted, the
            # prefix recomputes
            self._integrity_fail(h, "tier_disk")
            raise integrity.IntegrityError(f"disk page {h:#x} failed checksum",
                                           path="tier_disk")
        parts = [np.frombuffer(kb_, store).reshape(L.block_shape),
                 np.frombuffer(vb_, store).reshape(L.block_shape)]
        if int8:
            parts += [np.frombuffer(ksb, np.float32).reshape(sshape),
                      np.frombuffer(vsb, np.float32).reshape(sshape)]
        return parts, k_sum, v_sum

    def _load_raw(self, seq_hashes: list[int]):
        """Tier fetch in STORED form, blocks first [n, L, H, bs, D] (and the
        scale planes of int8 tiers), verification and promotion included."""
        L = self.layout
        int8 = self.wire_codec == "int8"
        store = np.int8 if int8 else _NP_DTYPES[L.dtype]
        n = len(seq_hashes)
        sshape = L.block_shape[:-2]
        k = np.zeros((n, *L.block_shape), store)
        v = np.zeros((n, *L.block_shape), store)
        ks = np.zeros((n, *sshape), np.float32) if int8 else None
        vs = np.zeros((n, *sshape), np.float32) if int8 else None
        with self._lock:
            for i, h in enumerate(seq_hashes):
                hnd = self._host.get(h)
                if hnd is not None:
                    self._verify_slot(h, hnd)
                    self._host.move_to_end(h)
                    k[i] = self._k_arena[hnd.index]
                    v[i] = self._v_arena[hnd.index]
                    if int8:
                        ks[i] = self._k_scales[hnd.index]
                        vs[i] = self._v_scales[hnd.index]
                    continue
                parts, k_sum, v_sum = self._read_page(h)
                k[i], v[i] = parts[0], parts[1]
                if int8:
                    ks[i], vs[i] = parts[2], parts[3]
                self._promote(h, parts, self._disk[h], k_sum, v_sum)
            self.stats.onboarded += n
        return k, v, ks, vs

    def _integrity_fail(self, h: int, path_label: str) -> None:
        """One block failed verification: free it exactly once (host slot
        returned, disk page unlinked), count it, and quarantine the hash once
        it has failed ``quarantine_after`` times."""
        self.stats.integrity_failures += 1
        integrity.COUNTERS.integrity_failure(path_label, f"block {h:#x}")
        hnd = self._host.pop(h, None)
        if hnd is not None:
            self._free_slots.append(hnd.index)
            self.stats.host_blocks_used = len(self._host)
        p = self._disk.pop(h, None)
        if p is not None:
            try:
                os.unlink(p)
            except OSError:
                pass
            self.stats.disk_blocks_used = len(self._disk)
        self._fail_counts[h] = self._fail_counts.get(h, 0) + 1
        if h not in self._quarantined and self._fail_counts[h] >= self.quarantine_after:
            self._quarantined.add(h)
            self.stats.quarantined += 1
            integrity.COUNTERS.quarantine()
            logger.error("block %#x quarantined after %d integrity failures",
                         h, self._fail_counts[h])
        if self.on_event:
            # routers and indexers drop the block from prefix-reuse offers
            self.on_event("removed", [h], 3 if p is not None else 2)

    def _promote(self, h: int, parts: list[np.ndarray], path: str, k_sum: int,
                 v_sum: int) -> Optional[int]:
        """A verified disk page's (K, V[, scales]) back into a host slot
        (evicting the LRU); returns the slot, or None when the arena has
        none."""
        slot = self._alloc_host_slot()
        if slot is None:
            return None
        self._k_arena[slot] = parts[0]
        self._v_arena[slot] = parts[1]
        if len(parts) > 2:
            self._k_scales[slot] = parts[2]
            self._v_scales[slot] = parts[3]
        self._host[h] = BlockHandle(h, tier=2, index=slot, k_sum=k_sum, v_sum=v_sum)
        self._disk.pop(h, None)
        try:
            os.unlink(path)
        except OSError:
            pass
        self.stats.host_blocks_used = len(self._host)
        self.stats.disk_blocks_used = len(self._disk)
        return slot

    def _record_parent(self, seq_hashes: list[int], i: int, h: int) -> None:
        if i > 0:
            self._parents[h] = seq_hashes[i - 1]
        else:
            self._parents.setdefault(h, None)

    # ----------------------------------------------- warm restarts (KVB2)
    # A planned restart checkpoints the host / disk tiers and the prefix
    # index to DYN_WARM_RESTART_DIR and restores them at boot. Pages reuse
    # the G3 spill format (KVB2 magic + k / v checksums over payload and
    # scales); restore verifies every page and refuses corrupt or truncated
    # ones: they recompute, never decode.

    MANIFEST = "manifest.json"

    def _layout_fingerprint(self) -> dict:
        L = self.layout
        return {"num_layers": L.num_layers, "page_size": L.page_size,
                "num_kv_heads": L.num_kv_heads, "head_dim": L.head_dim, "dtype": L.dtype}

    def _page_body_nbytes(self) -> tuple[int, int]:
        """(per-half payload bytes, per-half scale bytes) of one page."""
        int8 = self.wire_codec == "int8"
        itemsize = 1 if int8 else np.dtype(_NP_DTYPES[self.layout.dtype]).itemsize
        half = self.layout.block_numel * itemsize
        snum = int(np.prod(self.layout.block_shape[:-2])) * 4 if int8 else 0
        return half, snum

    def checkpoint(self, directory: str) -> dict:
        """Every tier block as a checksummed KVB2 page plus a manifest
        (layout fingerprint, codec, the hash -> parent index). Atomic at the
        manifest: a crash mid-checkpoint leaves the previous manifest or
        none. Returns a summary dict."""
        pages_dir = os.path.join(directory, "pages")
        os.makedirs(pages_dir, exist_ok=True)
        half, snum = self._page_body_nbytes()
        blocks: list[dict] = []
        with self._lock:
            for h, hnd in self._host.items():
                k_sum, v_sum = ((hnd.k_sum, hnd.v_sum) if (hnd.k_sum or hnd.v_sum)
                                else self._slot_sums(hnd.index))
                with open(os.path.join(pages_dir, f"{h:#x}.kvb"), "wb") as f:
                    f.write(_PAGE_HDR.pack(_PAGE_MAGIC, k_sum, v_sum))
                    self._write_page(f, hnd.index)
                entry = self._manifest_entry(h, k_sum, v_sum)
                entry["tier"] = "host"
                blocks.append(entry)
            for h, src in self._disk.items():
                entry = self._checkpoint_disk_page(h, src, pages_dir, half, snum)
                if entry is not None:
                    entry["tier"] = "disk"
                    blocks.append(entry)
        tier_fp = {"wire_codec": self.wire_codec, "layout": self._layout_fingerprint()}
        manifest = {
            # v2: a fingerprint per tier and a "tier" per block, so a reader
            # whose disk tier changed shape still salvages the host tier; the
            # top-level layout / codec are kept for v1 readers
            "version": 2,
            "wire_codec": self.wire_codec,
            "layout": self._layout_fingerprint(),
            "tiers": {"host": dict(tier_fp), "disk": dict(tier_fp)},
            "blocks": blocks,
        }
        tmp = os.path.join(directory, self.MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(directory, self.MANIFEST))
        logger.info("warm-restart checkpoint: %d block page(s) -> %s", len(blocks), directory)
        return {"blocks": len(blocks), "dir": directory}

    def _manifest_entry(self, h: int, k_sum: int, v_sum: int) -> dict:
        parent = self._parents.get(h)
        return {"hash": f"{h:#x}", "parent": f"{parent:#x}" if parent is not None else None,
                "k_sum": int(k_sum), "v_sum": int(v_sum), "file": f"pages/{h:#x}.kvb"}

    def _checkpoint_disk_page(self, h: int, src: str, pages_dir: str, half: int,
                              snum: int) -> Optional[dict]:
        """Copy one G3 page into the checkpoint with a KVB2 header (a
        headerless page of a DYN_KV_CHECKSUM=0 spill gets its sums here:
        the checkpoint is always verifiable)."""
        try:
            with open(src, "rb") as f:
                raw = f.read()
        except OSError:
            return None
        dst = os.path.join(pages_dir, f"{h:#x}.kvb")
        if raw[:len(_PAGE_MAGIC)] == _PAGE_MAGIC:
            _, k_sum, v_sum = _PAGE_HDR.unpack(raw[:_PAGE_HDR.size])
            try:
                shutil.copyfile(src, dst)
            except OSError:
                return None
            return self._manifest_entry(h, k_sum, v_sum)
        body = 2 * half + 2 * snum
        if len(raw) < body:
            return None  # already torn: no garbage in the checkpoint
        k_sum = integrity.checksum(raw[:half], raw[2 * half:2 * half + snum])
        v_sum = integrity.checksum(raw[half:2 * half], raw[2 * half + snum:body])
        with open(dst, "wb") as f:
            f.write(_PAGE_HDR.pack(_PAGE_MAGIC, k_sum, v_sum))
            f.write(raw[:body])
        return self._manifest_entry(h, k_sum, v_sum)

    def restore(self, directory: str) -> dict:
        """Load a checkpoint written by ``checkpoint()``: the layout
        fingerprint and codec are checked per tier (a v2 manifest's
        mismatched tier is refused, the others salvaged; a v1 manifest or a
        mismatch on every tier refuses the whole checkpoint), each page's
        checksums are verified, and the good pages land host-first (nothing
        live is evicted), the rest on the disk tier when there is one.
        Corrupt, truncated and mismatched pages are refused and counted
        (``warm_refused``)."""
        summary = {"restored": 0, "refused": 0, "skipped": 0}
        try:
            with open(os.path.join(directory, self.MANIFEST)) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return summary
        try:
            m_version = int(manifest.get("version", 1))
        except (TypeError, ValueError):
            m_version = 0
        if m_version > 2:
            # a later writer may mean something this reader cannot see
            logger.warning("warm-restart checkpoint at %s is manifest v%s; this build reads "
                           "<= v2 -- refusing whole checkpoint", directory, manifest.get("version"))
            summary["refused_version"] = True
            return summary
        my_layout = self._layout_fingerprint()
        tiers = manifest.get("tiers")
        if isinstance(tiers, dict) and tiers:
            bad_tiers = {t for t, tfp in tiers.items()
                         if not isinstance(tfp, dict) or tfp.get("layout") != my_layout
                         or tfp.get("wire_codec") != self.wire_codec}
            if bad_tiers >= set(tiers):
                logger.warning("warm-restart checkpoint at %s matches NO tier of this manager "
                               "(%s/%s) -- refusing whole checkpoint", directory, my_layout,
                               self.wire_codec)
                summary["refused_layout"] = True
                return summary
            if bad_tiers:
                summary["refused_tiers"] = sorted(bad_tiers)
                logger.warning("warm-restart checkpoint at %s: tier(s) %s have a mismatched "
                               "layout/codec -- refusing their blocks", directory, sorted(bad_tiers))
        else:
            bad_tiers = set()
            if (manifest.get("layout") != my_layout
                    or manifest.get("wire_codec") != self.wire_codec):
                logger.warning("warm-restart checkpoint at %s has layout/codec %s/%s; this "
                               "manager is %s/%s -- refusing whole checkpoint", directory,
                               manifest.get("layout"), manifest.get("wire_codec"), my_layout,
                               self.wire_codec)
                summary["refused_layout"] = True
                return summary
        half, snum = self._page_body_nbytes()
        body = 2 * half + 2 * snum
        int8 = self.wire_codec == "int8"
        store = np.int8 if int8 else _NP_DTYPES[self.layout.dtype]
        sshape = self.layout.block_shape[:-2]
        with self._lock:
            for entry in manifest.get("blocks", []):
                try:
                    h = int(entry["hash"], 16)
                except (KeyError, ValueError):
                    summary["refused"] += 1
                    continue
                if entry.get("tier", "host") in bad_tiers:
                    self.stats.warm_refused += 1
                    summary["refused"] += 1
                    continue
                if h in self._host or h in self._disk or h in self._quarantined:
                    summary["skipped"] += 1
                    continue
                path = os.path.join(directory, entry["file"])
                try:
                    with open(path, "rb") as f:
                        raw = f.read()
                except OSError:
                    summary["refused"] += 1
                    continue
                if len(raw) < _PAGE_HDR.size + body or raw[:len(_PAGE_MAGIC)] != _PAGE_MAGIC:
                    # torn or headerless: refused, never decoded
                    self.stats.warm_refused += 1
                    summary["refused"] += 1
                    integrity.COUNTERS.integrity_failure("warm_restore", f"block {h:#x} truncated")
                    continue
                _, k_sum, v_sum = _PAGE_HDR.unpack(raw[:_PAGE_HDR.size])
                payload = raw[_PAGE_HDR.size:]
                kb = payload[:half]
                vb = payload[half:2 * half]
                ksb = payload[2 * half:2 * half + snum]
                vsb = payload[2 * half + snum:body]
                if (integrity.checksum(kb, ksb) != k_sum
                        or integrity.checksum(vb, vsb) != v_sum):
                    self.stats.warm_refused += 1
                    summary["refused"] += 1
                    integrity.COUNTERS.integrity_failure("warm_restore",
                                                         f"block {h:#x} failed checksum")
                    continue
                parent = entry.get("parent")
                try:
                    self._parents[h] = int(parent, 16) if parent is not None else self._parents.get(h)
                except (TypeError, ValueError):
                    self._parents.setdefault(h, None)
                # host-first, evicting nothing that is live
                if self._free_slots:
                    slot = self._free_slots.pop()
                    self._k_arena[slot] = np.frombuffer(kb, store).reshape(self.layout.block_shape)
                    self._v_arena[slot] = np.frombuffer(vb, store).reshape(self.layout.block_shape)
                    if int8:
                        self._k_scales[slot] = np.frombuffer(ksb, np.float32).reshape(sshape)
                        self._v_scales[slot] = np.frombuffer(vsb, np.float32).reshape(sshape)
                    self._host[h] = BlockHandle(h, tier=2, index=slot, k_sum=k_sum, v_sum=v_sum)
                elif self.disk_dir:
                    dst = os.path.join(self.disk_dir, f"{h:#x}.kvb")
                    try:
                        shutil.copyfile(path, dst)
                    except OSError:
                        summary["refused"] += 1
                        continue
                    self._disk[h] = dst
                else:
                    summary["skipped"] += 1
                    continue
                self.stats.warm_restored += 1
                summary["restored"] += 1
            self.stats.host_blocks_used = len(self._host)
            self.stats.disk_blocks_used = len(self._disk)
        if summary["restored"] or summary["refused"]:
            logger.info("warm restart: restored %d block(s) from %s (%d refused, %d skipped)",
                        summary["restored"], directory, summary["refused"], summary["skipped"])
        return summary

    def advert_blocks(self) -> list[dict]:
        """The tiers' contents as stored-event dicts ({block_hash,
        parent_hash}), parent before child where the chain is known, so a
        warm-restarted worker can advertise its restored prefixes."""
        with self._lock:
            hashes = list(self._host.keys()) + list(self._disk.keys())
            known = set(hashes)
            out: list[dict] = []
            emitted: set[int] = set()
            for h in hashes:
                chain: list[int] = []
                cur: Optional[int] = h
                while cur is not None and cur in known and cur not in emitted:
                    chain.append(cur)
                    emitted.add(cur)
                    cur = self._parents.get(cur)
                for b in reversed(chain):
                    out.append({"block_hash": b, "parent_hash": self._parents.get(b)})
        return out

    # ------------------------------------------------------------- admin

    def clear(self) -> None:
        with self._lock:
            for hnd in self._host.values():
                self._free_slots.append(hnd.index)
            self._host.clear()
            for p in self._disk.values():
                try:
                    os.unlink(p)
                except OSError:
                    pass
            self._disk.clear()
            self.stats.host_blocks_used = 0
            self.stats.disk_blocks_used = 0
