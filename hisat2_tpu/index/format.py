"""Device FM index: dense-array layout + on-disk .npz format.

This replaces the reference's pointer-rich blocked "side" layout
(/root/reference/gfm.h:147-182, 325-520) with a flat two-level structure that
maps directly onto HBM and lane-parallel rank queries:

  bwt_words   uint32[nwords]      2-bit BWT chars, 16/word (row-major)
  occ         int32[nblocks+1,4]  absolute char counts at each 128-row block
                                  boundary ('$' excluded, like countBt2Side)
  mark_words  uint32[nblocks*4]   1 bit per row: SA[row] % 2^offrate == 0.
                                  Sampling by *text position* (not row index)
                                  bounds the resolve walk at 2^offrate LF
                                  steps — a static loop bound for the device
                                  kernel, unlike the reference's walkLeft
                                  (gfm.h:2374) whose tail is unbounded.
  mark_chk    int32[nblocks+1]    rank checkpoints over mark_words
  sa_marked   int32[n_marked]     SA values of marked rows, in row order
  ftab_top/bot int32[4^ftab_k]    k-mer jumpstart ranges (gfm.h ftabLoHi)
  fchr        int32[5]            cumulative char counts C[] (gfm.h _fchr)
  ref_words   uint32[...]         2-bit packed joined reference text
                                  (BitPairReference equivalent, reference.h:59)
  frag_joined int32[F+1]          fragment starts in joined space (+sentinel)
  frag_ref    int32[F]            fragment -> reference id
  frag_off    int32[F]            fragment start in reference coordinates
                                  (rstarts equivalent, gfm.h:2526 joinedToTextOff)

Rows R = n + 1 (text + sentinel).  Row `zrow` is the BWT position of '$'
(SA[zrow] == 0); its packed slot stores 0 and rank queries correct for it
(the reference stores $ positions in _zOffs, gfm.h:739).

All row/offset arrays are int32: a single index covers texts < 2^31 bp
(every local index and all chromosomes; whole-genome scale shards across
local indexes like the reference HGFM, hier_idx_common.h:24-31).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np

BLOCK_BASES = 128           # rank checkpoint interval (rows per occ block)


def fuse_blocked(occ, bwt_words, occ2=None, bwt2_words=None,
                 mark_words=None, mark_chk=None):
    """uint32 [nblocks+1, 12/44 (+5)]: per 128-row block, [occ c0..c3 |
    8 BWT words | occ2 s0..s15 | 16 bigram words | 4 mark words +
    mark-rank checkpoint] — the rank kernel's whole working set for a
    row, one gather.  Row width stays latency-flat on the gather path
    (PERF.md), so fusing the bigram planes is free; rank() reads only
    cols 0..11.  The mark columns (widths 17 and 49) let the resolve
    walk (ops/resolve.py) derive the mark bit AND the mark rank from
    the block row it already fetched — 2 fewer gathers per LF step."""
    occ = np.asarray(occ)
    bw = np.asarray(bwt_words).reshape(-1, 8)
    nblk = bw.shape[0]
    W = 12 if occ2 is None else 44
    Wm = W + (5 if mark_words is not None else 0)
    out = np.zeros((nblk + 1, Wm), np.uint32)
    out[:, :4] = occ.astype(np.uint32)
    out[:nblk, 4:12] = bw
    if occ2 is not None:
        out[:, 12:28] = np.asarray(occ2).astype(np.uint32)
        out[:nblk, 28:44] = np.asarray(bwt2_words).reshape(-1, 16)
    if mark_words is not None:
        out[:nblk, W:W + 4] = np.asarray(mark_words).reshape(-1, 4)
        out[:, W + 4] = np.asarray(mark_chk).astype(np.uint32)
    return out
WORDS_PER_BLOCK = BLOCK_BASES // 16
DEFAULT_OFF_RATE = 5        # SA sampled every 32 rows   (gfm.h:3909)
DEFAULT_FTAB_K = 10         # global k-mer jumpstart     (hisat2_build.cpp:101)


@dataclasses.dataclass(frozen=True)
class FMMeta:
    """Static (hashable) index geometry — safe to close over in jit."""
    n: int                  # joined text length (bases)
    rows: int               # n + 1
    zrow: int               # BWT row of '$'
    off_rate: int
    ftab_k: int
    ref_names: tuple[str, ...]
    ref_lens: tuple[int, ...]
    zrow2: int = -1         # BWT row with SA == 1 (bigram-plane special)

    @property
    def off_mask(self) -> int:
        return (1 << self.off_rate) - 1


@dataclasses.dataclass
class FMIndex:
    """Array bundle (host numpy or device jnp) + static meta."""
    meta: FMMeta
    bwt_words: Any          # uint32 [nblocks * WORDS_PER_BLOCK]
    occ: Any                # int32  [nblocks + 1, 4]
    mark_words: Any         # uint32 [nblocks * 4]
    mark_chk: Any           # int32  [nblocks + 1]
    sa_marked: Any          # int32  [n_marked]
    ftab_top: Any           # int32  [4^ftab_k]
    ftab_bot: Any           # int32  [4^ftab_k]
    fchr: Any               # int32  [5]
    ref_words: Any          # uint32 [ceil(n/16)]
    frag_joined: Any        # int32  [F + 1]
    frag_ref: Any           # int32  [F]
    frag_off: Any           # int32  [F]
    # bigram planes (optional; older indexes lack them and the search
    # falls back to single-char steps): 4-bit (prev2, prev1) symbols,
    # their occ checkpoints, and the 2-gram prefix block starts
    bwt2_words: Any = None  # uint32 [nblocks * 16]
    occ2: Any = None        # int32  [nblocks + 1, 16]
    ftab2_top: Any = None   # int32  [16]
    # derived, device-only (built by to_device, never persisted): the occ
    # checkpoint fused in front of each 128-row block's 8 BWT words (and
    # the bigram planes when present), so a rank query costs ONE row
    # gather instead of two separate gathers
    blocked: Any = None     # uint32 [nblocks + 1, 12 or 44]

    def arrays(self) -> dict[str, Any]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if f.name not in ("meta", "blocked")
                and getattr(self, f.name) is not None}

    def to_device(self, device=None):
        """Upload all arrays as jnp arrays (optionally onto a specific
        device — index shards distribute across chips MPMD-style, each
        shard's compute following its arrays)."""
        import jax
        import jax.numpy as jnp
        arrs = self.arrays()
        sampled = self.meta.off_rate > 0
        arrs["blocked"] = fuse_blocked(
            self.occ, self.bwt_words, self.occ2, self.bwt2_words,
            mark_words=self.mark_words if sampled else None,
            mark_chk=self.mark_chk if sampled else None)
        # the fused table carries the bigram planes (and, on sampled-SA
        # indexes, the mark words + checkpoints the resolve walk needs);
        # don't also upload the raw ones
        arrs.pop("occ2", None)
        arrs.pop("bwt2_words", None)
        if sampled:
            arrs["mark_words"] = np.zeros(1, np.uint32)
            arrs["mark_chk"] = np.zeros(1, np.int32)
        # pad ref_words to a multiple of 128: ref_chars_block gathers
        # word ROWS (2 per diagonal) instead of scalar words, and
        # genome-scale operands take its 128-word-row branch
        # (ops/rank.py)
        rw = np.asarray(arrs["ref_words"])
        if len(rw) % 128:
            arrs["ref_words"] = np.concatenate(
                [rw, np.zeros(128 - len(rw) % 128, rw.dtype)])
        # same for the full SA (off_rate == 0): resolve_consecutive
        # gathers 8-entry rows of consecutive SA values
        sm = np.asarray(arrs["sa_marked"])
        if self.meta.off_rate == 0 and len(sm) % 8:
            arrs["sa_marked"] = np.concatenate(
                [sm, np.zeros(8 - len(sm) % 8, sm.dtype)])
        if device is not None:
            kw = {k: jax.device_put(np.asarray(v), device)
                  for k, v in arrs.items()}
        else:
            kw = {k: jnp.asarray(v) for k, v in arrs.items()}
        return FMIndex(meta=self.meta, **kw)

    # ---- persistence (native format) ------------------------------------
    def save(self, path: str) -> None:
        meta = dataclasses.asdict(self.meta)
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 __meta__=np.frombuffer(
                     json.dumps(meta).encode(), dtype=np.uint8),
                 **{k: np.asarray(v) for k, v in self.arrays().items()})

    @staticmethod
    def load(path: str):
        if not path.endswith(".npz"):
            if not os.path.exists(path + ".npz"):
                from .ht2 import convert_ht2, is_ht2
                if is_ht2(path):
                    # a reference .ht2 index: convert to the native layout
                    # on first use (cached beside it or under /tmp)
                    path = convert_ht2(path)
            path = path + ".npz"
        with np.load(path) as z:
            meta_d = json.loads(bytes(z["__meta__"]).decode())
            if "shard_bases" in meta_d:
                bases = meta_d["shard_bases"]
                base_path = path[:-len(".npz")]
                shards = [FMIndex.load(f"{base_path}.s{i}")
                          for i in range(len(bases))]
                return ShardedFMIndex(shards=shards, shard_bases=bases)
            meta_d["ref_names"] = tuple(meta_d["ref_names"])
            meta_d["ref_lens"] = tuple(meta_d["ref_lens"])
            meta = FMMeta(**meta_d)
            kw = {k: z[k] for k in z.files if k != "__meta__"}
        return FMIndex(meta=meta, **kw)


@dataclasses.dataclass
class ShardedFMIndex:
    """Whole-genome scale: sub-indexes over fragment groups, each a
    complete standalone FMIndex with SHARD-LOCAL joined coordinates; the
    aligner runs all shards and rebases candidates into a GLOBAL joined
    space (shard_bases[s] + local).  The reference handles >2^32 genomes
    with its 64-bit -align-l flavor (hisat2:444-457); int32 positions on
    the device favor sharding instead, which is also the natural
    multi-device index-distribution axis."""
    shards: list
    shard_bases: list

    @property
    def meta(self) -> FMMeta:
        """Global meta: total joined length over the shards."""
        n = self.shard_bases[-1] + self.shards[-1].meta.n
        m0 = self.shards[0].meta
        return FMMeta(n=n, rows=n + 1, zrow=-1, off_rate=m0.off_rate,
                      ftab_k=m0.ftab_k, ref_names=m0.ref_names,
                      ref_lens=m0.ref_lens)

    # global fragment tables (concatenation, shard-local starts rebased)
    @property
    def frag_joined(self):
        parts = [np.asarray(sh.frag_joined[:-1]) + b
                 for sh, b in zip(self.shards, self.shard_bases)]
        return np.concatenate(parts + [[self.meta.n]]).astype(np.int64)

    @property
    def frag_ref(self):
        return np.concatenate(
            [np.asarray(sh.frag_ref) for sh in self.shards])

    @property
    def frag_off(self):
        return np.concatenate(
            [np.asarray(sh.frag_off) for sh in self.shards])

    @property
    def ref_words(self):
        raise AttributeError(
            "sharded index has no single packed reference; "
            "use per-shard ref_words")

    def global_ref_codes(self):
        from ..utils import bitops
        return np.concatenate([
            bitops.unpack_2bit(np.asarray(sh.ref_words), sh.meta.n)
            for sh in self.shards])

    def save(self, path: str) -> None:
        base = path[:-len(".npz")] if path.endswith(".npz") else path
        meta = {"shard_bases": [int(b) for b in self.shard_bases]}
        np.savez(base + ".npz", __meta__=np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8))
        for i, sh in enumerate(self.shards):
            sh.save(f"{base}.s{i}")


# Register FMIndex as a pytree so a whole index bundle can be passed as one
# jit argument (arrays = leaves, meta = static aux data).  Passing the index
# as an ARGUMENT (not a closure) is a hard performance requirement — see
# ops/rank.py.
def _fm_flatten(x: FMIndex):
    names = tuple(f.name for f in dataclasses.fields(FMIndex)
                  if f.name != "meta")
    return tuple(getattr(x, n) for n in names), (x.meta, names)


def _fm_unflatten(aux, children):
    meta, names = aux
    return FMIndex(meta=meta, **dict(zip(names, children)))


try:
    import jax
    jax.tree_util.register_pytree_node(FMIndex, _fm_flatten, _fm_unflatten)
except ImportError:  # pragma: no cover - jax always present in this image
    pass
