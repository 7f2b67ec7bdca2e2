"""Reference .ht2 index interop: parse + convert + align equivalence.

Fixture: tests/data/ht2fix/* — a 30 kb genome (with an N run) + 3 SNPs,
indexed by the reference's hisat2-build-s (-t 4 --offrate 6 --snp).
"""

import os

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(__file__), "data", "ht2fix")
BASE = os.path.join(DATA, "ht2fix")


def _fa_codes(path):
    m = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4}
    seq = []
    for line in open(path):
        if line.startswith(">"):
            continue
        seq.extend(m[c] for c in line.strip().upper())
    return np.array(seq, np.uint8)


def test_read_header_and_ref():
    from hisat2_tpu.index import ht2
    h = ht2.read_header(BASE)
    assert h["names"] == ["chrT"]          # description stripped
    assert h["n_pat"] == 1
    seqs = ht2.read_ref(BASE)
    assert len(seqs) == 1
    truth = _fa_codes(os.path.join(DATA, "ht2fix.fa"))
    np.testing.assert_array_equal(seqs[0], truth)


def test_read_alts():
    from hisat2_tpu.index import ht2
    alts, names, haps = ht2.read_alts(BASE)
    snps = [(t, p, ln, sq) for (t, p, ln, sq) in alts
            if t in (ht2.ALT_SNP_SGL, ht2.ALT_SNP_DEL, ht2.ALT_SNP_INS)]
    assert len(snps) == 3
    assert names[:3] == ["rs1", "rs2", "rs3"]


def test_convert_and_align(tmp_path):
    """Conversion must reproduce the same alignments as a native build."""
    from hisat2_tpu.align.pipeline import TPUAligner
    from hisat2_tpu.index import ht2
    from hisat2_tpu.index.builder import build_fm_index
    from hisat2_tpu.index.format import FMIndex
    from hisat2_tpu.index.variants import VariantDB, attach_variants

    cache = str(tmp_path / "conv")
    ht2.convert_ht2(BASE, cache_base=cache)
    idx = FMIndex.load(cache)
    var = VariantDB.load(cache)
    assert var.n_snps == 3
    assert set(var.snp_names) == {"rs1", "rs2", "rs3"}

    truth = _fa_codes(os.path.join(DATA, "ht2fix.fa"))
    native = build_fm_index([("chrT", truth)])
    attach_variants(native, snp_file=os.path.join(DATA, "ht2fix.snp"))
    nvar = native._variants
    np.testing.assert_array_equal(var.snp_joined, nvar.snp_joined)
    np.testing.assert_array_equal(var.snp_seq, nvar.snp_seq)
    np.testing.assert_array_equal(var.snp_kind, nvar.snp_kind)

    rng = np.random.default_rng(5)
    B, L = 24, 80
    ref = truth
    ok = np.flatnonzero(ref[:len(ref) - L] .astype(int) >= 0)
    starts = rng.integers(0, len(ref) - L, B)
    reads = np.stack([ref[s:s + L] for s in starts]).astype(np.uint8)
    quals = np.full((B, L), 40, np.uint8)
    lens = np.full(B, L, np.int32)
    a1 = TPUAligner(idx, variants=var)
    a2 = TPUAligner(native, variants=nvar)
    minsc = np.full(B, -40, np.int32)
    r1 = a1._fetch_out(a1._device_step(a1.dev, a1.params, reads, quals,
                                       lens, minsc, uniform=True))
    r2 = a2._fetch_out(a2._device_step(a2.dev, a2.params, reads, quals,
                                       lens, minsc, uniform=True))
    for k in r1:
        np.testing.assert_array_equal(r1[k], r2[k], err_msg=k)
