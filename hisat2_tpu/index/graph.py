"""Variant-aware (graph) index arrays: the device-side ALT database.

The reference encodes variants into the GBWT itself (GFM over a variation
graph) plus an ALTDB consulted during extension (alignWithALTs_recur,
hi_aligner.h:2586-3377).  The design here keeps the
*search* on the linear FM index (anchors are exact stretches of the
reference) and makes the *extension* variant-aware, which recovers
alignments through known variants whenever an anchor exists on either side
— the same division of labor the reference's extension performs against
BitPairReference + ALTDB.

Device encoding (one gather per column, same geometry as ref_char):
  snv_delta1/2: 2-bit packed over joined positions; value v in 1..3 means a
  single-base SNP with alt allele (ref + v) & 3 exists there; v == 0 means
  none.  Two planes cover multi-allelic sites (>2 alts at one position is
  vanishingly rare and ignored).

Indels (ALT_INS/ALT_DEL) are kept as sorted coordinate lists; the extension
enumerates gapped candidate geometries from them (see ops/extend.py
extend_indel) — mirroring the reference's branch into compatible indel ALTs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import bitops
from .variants import SNP_DEL, SNP_INS, SNP_SGL, VariantDB


@dataclasses.dataclass
class GraphArrays:
    """Device-uploadable variant planes + host lookup tables."""
    snv_delta1: np.ndarray    # uint32 [ceil(n/16)] 2-bit planes
    snv_delta2: np.ndarray
    # indels sorted by joined position (host + device)
    indel_pos: np.ndarray     # int32 [I] joined position (first affected)
    indel_len: np.ndarray     # int32 [I] +len = deletion, -len = insertion
    indel_seq: np.ndarray     # int64 [I] packed inserted seq (insertions)
    indel_id: np.ndarray      # int32 [I] index into VariantDB records
    # host: SNV site lookup for Zs tags
    snv_joined: np.ndarray    # int32 [S] sorted joined positions
    snv_alt: np.ndarray       # int8  [S] alt base code
    snv_id: np.ndarray        # int32 [S] index into VariantDB records


def build_graph_arrays(index, db: VariantDB, ref_codes=None,
                       with_planes: bool = True) -> GraphArrays:
    """Encode a VariantDB against an FMIndex's joined coordinates.

    ref_codes: pre-unpacked joined reference (required for sharded
    indexes, which have no single packed array).  with_planes=False skips
    the device SNV planes (host-only global view of a sharded graph)."""
    n = index.meta.n
    if ref_codes is None:
        ref_codes = bitops.unpack_2bit(np.asarray(index.ref_words), n)
    # pad the packed planes to a multiple of 128 words, matching the
    # ref_words padding: ref_chars_block's genome-scale fast path
    # gathers 128-word rows (ops/rank.py)
    nwords = (((n + 15) // 16 + 127) // 128) * 128 if with_planes else 1

    sgl = np.flatnonzero((db.snp_kind == SNP_SGL) & (db.snp_joined >= 0))
    pos = db.snp_joined[sgl].astype(np.int64)
    alt = (db.snp_seq[sgl] & 3).astype(np.int64)
    ref = ref_codes[pos].astype(np.int64)
    delta = (alt - ref) & 3
    ok = delta != 0          # alt == ref would be a no-op record
    pos, alt, delta, sgl = pos[ok], alt[ok], delta[ok], sgl[ok]
    # multi-allelic sites: first record at a position -> plane 1, second
    # (with a DIFFERENT delta) -> plane 2.  Rank within each position group
    # must be computed before any write (a vectorized `plane1[pos]==0` test
    # misses duplicates inside one batch).
    order = np.argsort(pos, kind="stable")
    ps, ds = pos[order], delta[order]
    new_grp = np.empty(len(ps), bool)
    if len(ps):
        new_grp[0] = True
        new_grp[1:] = ps[1:] != ps[:-1]
    grp_start = np.maximum.accumulate(
        np.where(new_grp, np.arange(len(ps)), 0))
    rank = np.arange(len(ps)) - grp_start
    def pack_sparse(positions, deltas):
        # the planes are ~all zeros (1 SNV per ~250 bp at human density):
        # scatter the 2-bit deltas straight into their packed words,
        # O(#SNVs) instead of O(genome)
        out = np.zeros(nwords, np.uint32)
        if len(positions):
            w = (positions >> 4).astype(np.int64)
            sh = (2 * (positions & 15)).astype(np.uint32)
            np.bitwise_or.at(out, w,
                             deltas.astype(np.uint32) << sh)
        return out

    second = np.zeros(0, bool)
    if len(ps):
        second = (rank == 1) & (ds != ds[np.maximum(grp_start, 0)])
    if with_planes:
        plane1_w = pack_sparse(ps[rank == 0], ds[rank == 0])
        plane2_w = pack_sparse(ps[second], ds[second])
    else:
        plane1_w = np.zeros(1, np.uint32)
        plane2_w = np.zeros(1, np.uint32)

    ind = np.flatnonzero((db.snp_kind != SNP_SGL) & (db.snp_joined >= 0))
    ilen = np.where(db.snp_kind[ind] == SNP_DEL,
                    db.snp_len[ind], -db.snp_len[ind]).astype(np.int32)
    order = np.argsort(db.snp_joined[ind], kind="stable")
    ind = ind[order]

    so = np.argsort(pos, kind="stable")
    return GraphArrays(
        snv_delta1=plane1_w, snv_delta2=plane2_w,
        indel_pos=db.snp_joined[ind].astype(np.int64),
        indel_len=ilen[order],
        indel_seq=db.snp_seq[ind].astype(np.int64),
        indel_id=ind.astype(np.int32),
        snv_joined=pos[so].astype(np.int64),
        snv_alt=alt[so].astype(np.int8),
        snv_id=sgl[so].astype(np.int32))


def shard_graph_arrays(shard_index, db: VariantDB, base: int):
    """Per-shard device graph: variants rebased into the shard's local
    joined space (out-of-shard records drop to joined=-1)."""
    import dataclasses as _dc
    j = db.snp_joined.astype(np.int64)
    n = shard_index.meta.n
    loc = np.where((j >= base) & (j < base + n), j - base, -1)
    db2 = _dc.replace(db, snp_joined=loc.astype(np.int64))
    return build_graph_arrays(shard_index, db2)


def indel_device_tables(graph: GraphArrays, max_ins: int = 16) -> dict:
    """Padded, sorted indel-event tables for the injection kernel
    (ops/splice.py inject_indels).  Events sorted by joined position plus a
    right-side permutation sorted by pos + len (so a right-anchored
    candidate diagonal can binary-search events ending near it).
    Insertions longer than max_ins are dropped (none exist in dbSNP-derived
    inputs; ALT::seq caps at 32 bp, alt.h:60)."""
    keep = np.flatnonzero(-graph.indel_len <= max_ins)
    ip = graph.indel_pos[keep]
    il = graph.indel_len[keep]
    seq = graph.indel_seq[keep]
    n = len(ip)
    cap = 8
    while cap < n + 1:
        cap *= 2
    BIGP = np.int32(2 ** 30)
    t_ip = np.full(cap, BIGP, np.int32)
    t_il = np.zeros(cap, np.int32)
    t_ch = np.zeros((cap, max_ins), np.int32)
    t_rkey = np.full(cap, BIGP, np.int32)
    t_ril = np.zeros(cap, np.int32)
    t_rrow = np.zeros(cap, np.int32)
    row_db = np.zeros(cap, np.int32)
    if n:
        o = np.argsort(ip, kind="stable")
        ip, il, seq = ip[o], il[o], seq[o]
        row_db[:n] = graph.indel_id[keep][o]
        t_ip[:n], t_il[:n] = ip, il
        for j in range(max_ins):
            t_ch[:n, j] = (seq >> (2 * j)) & 3
        rkey = ip + il
        o2 = np.argsort(rkey, kind="stable")
        t_rkey[:n] = rkey[o2]
        t_ril[:n] = il[o2]
        t_rrow[:n] = o2.astype(np.int32)
    return dict(ind_ip=t_ip, ind_len=t_il, ind_chars=t_ch,
                ind_rkey=t_rkey, ind_rlen=t_ril, ind_rrow=t_rrow,
                _row_db=row_db)
