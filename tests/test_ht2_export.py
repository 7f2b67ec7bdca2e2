"""Tests for the .ht2 exporter (index/ht2_write.py).

Hermetic checks: structural round-trip through our own .ht2 reader plus
a full BWT inversion proving the exported FM payload encodes exactly the
input genome.  When the reference builder is present (/tmp/ref_build,
see the verify skill) the export is additionally byte-diffed against
`hisat2-build-s` output — the strongest oracle; that path runs in dev
environments and is skipped hermetically elsewhere.
"""

import os
import subprocess

import numpy as np
import pytest

from hisat2_tpu.index import ht2
from hisat2_tpu.index.ht2_write import export_ht2

REFBUILD = "/tmp/ref_build/hisat2-build-s"


def _invert_bwt(base):
    """Decode the exported .1 sides into the BWT and invert it via LF
    to recover the original text (sanity that the FM payload is real)."""
    h = ht2.read_header(base)
    d = open(base + ".1.ht2", "rb").read()
    # seek to sides: 11-word header (44) + nPat(4) + plen + nFrag(4)
    # + rstarts (3 words per fragment)
    off = 44 + 4 + 4 * h["n_pat"] + 4 + 12 * len(h["rstarts"])
    side_sz = 1 << h["line_rate"]
    side_gbwt = side_sz - 16
    sides = np.frombuffer(d, np.uint8, h["n_sides"] * side_sz, off)
    sides = sides.reshape(h["n_sides"], side_sz)
    packed = sides[:, :side_gbwt].reshape(-1)
    chars = np.empty(len(packed) * 4, np.uint8)
    for i in range(4):
        chars[i::4] = (packed >> (2 * i)) & 3
    gbwt_len = h["gbwt_len"]
    bwt = chars[:gbwt_len].astype(np.int64)
    # zOffs
    zoff = int(np.frombuffer(d, np.uint32, 1,
                             off + h["n_sides"] * side_sz + 4)[0])
    # LF inversion
    counted = np.ones(gbwt_len, bool)
    counted[zoff] = False
    occ = np.zeros((gbwt_len + 1, 4), np.int64)
    one = np.where(counted, 1, 0)
    for c in range(4):
        occ[1:, c] = np.cumsum(np.where(bwt == c, one, 0))
    n_z = int(np.frombuffer(d, np.uint32, 1,
                            off + h["n_sides"] * side_sz)[0])
    fchr_off = off + h["n_sides"] * side_sz + 4 + 4 * n_z
    fchr = np.frombuffer(d, np.uint32, 5, fchr_off).astype(np.int64)
    out = np.empty(gbwt_len - 1, np.uint8)
    # walk backwards from the '$' row (last row: the sentinel sorts
    # largest) recovering the text right-to-left via LF steps
    row = gbwt_len - 1
    for i in range(gbwt_len - 1):
        c = int(bwt[row])
        out[gbwt_len - 2 - i] = c
        row = int(fchr[c] + occ[row, c])
    return out


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(99)
    g1 = rng.integers(0, 4, 4000).astype(np.uint8)
    g1[500:560] = 4                      # interior N run
    g2 = rng.integers(0, 4, 1500).astype(np.uint8)
    g2[:25] = 4                          # leading N run
    return [("chrA", g1), ("chrB desc", g2)]


def test_export_structure_roundtrip(tmp_path, genome):
    base = str(tmp_path / "x")
    export_ht2(genome, base)
    for i in range(1, 9):
        assert os.path.exists(f"{base}.{i}.ht2")
    h = ht2.read_header(base)
    assert h["linear"] and h["n_pat"] == 2
    assert list(h["plen"]) == [4000, 1500]
    assert h["names"] == ["chrA", "chrB"]
    seqs = ht2.read_ref(base)
    assert len(seqs) == 2
    np.testing.assert_array_equal(seqs[0], genome[0][1])
    np.testing.assert_array_equal(seqs[1], genome[1][1])


def test_export_bwt_inverts_to_text(tmp_path, genome):
    base = str(tmp_path / "x")
    export_ht2(genome, base)
    joined = np.concatenate([c[c <= 3] for _, c in genome])
    recovered = _invert_bwt(base)
    np.testing.assert_array_equal(recovered, joined)


def test_export_offs_are_sa_samples(tmp_path, genome):
    base = str(tmp_path / "x")
    export_ht2(genome, base)
    joined = np.concatenate([c[c <= 3] for _, c in genome])
    n = len(joined)
    d2 = np.frombuffer(open(base + ".2.ht2", "rb").read(), np.uint32)
    assert d2[0] == 1
    offs = d2[1:]
    assert len(offs) == (n + 1 + 15) // 16
    # every offs entry marks a real suffix: spot-check sorted order of
    # the suffixes at consecutive sampled rows
    a, b = int(offs[3]), int(offs[4])
    assert a <= n and b <= n
    assert bytes(joined[a:a + 50]) <= bytes(joined[b:b + 50])


@pytest.mark.skipif(not os.path.exists(REFBUILD),
                    reason="reference builder not present")
def test_export_byte_equal_vs_reference(tmp_path, genome):
    fa = tmp_path / "g.fa"
    ACGTN = np.array(list("ACGTN"))
    with open(fa, "w") as f:
        for nm, c in genome:
            f.write(f">{nm}\n" + "".join(ACGTN[c]) + "\n")
    base_ref = str(tmp_path / "ref")
    subprocess.run([REFBUILD, str(fa), base_ref], check=True,
                   capture_output=True)
    base_ours = str(tmp_path / "ours")
    export_ht2(genome, base_ours)
    for i in range(1, 9):
        ra = open(f"{base_ours}.{i}.ht2", "rb").read()
        rb = open(f"{base_ref}.{i}.ht2", "rb").read()
        assert ra == rb, f".{i}.ht2 differs from hisat2-build-s output"
