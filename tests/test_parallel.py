"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import numpy as np


def test_dryrun_multichip():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_entry_compiles():
    import jax

    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    # all simulated reads must produce at least one valid candidate
    valid = np.asarray(out["u_flags"]) & 1
    assert valid.any()


def test_sharded_matches_single_device(small_index):
    """The sharded step must produce identical candidates to single-device."""
    from hisat2_tpu.align.pipeline import TPUAligner
    from hisat2_tpu.parallel import mesh as pmesh
    from hisat2_tpu.utils import devcheck

    idx, seq = small_index
    al = TPUAligner(idx, spliced=True)
    rng = np.random.default_rng(3)
    B, L = 16, 60
    starts = rng.integers(0, len(seq) - L, B)
    reads = np.stack([seq[s:s + L] for s in starts]).astype(np.int32)
    quals = np.full((B, L), 40, np.int32)
    lens = np.full(B, L, np.int32)
    minsc = np.full(B, -20, np.int32)
    rdids = np.arange(B, dtype=np.int32)
    m = pmesh.make_mesh(n_dp=8)
    assert len({d.id for d in m.devices.flat}) == 8
    bad = devcheck.sharded_step_mismatches(al, reads, quals, lens, minsc,
                                           rdids, m)
    assert not bad, f"sharded step differs from single-device: {bad}"


def test_sharded_variants_match_single(tmp_path):
    """Per-shard variant planes: a 2-shard graph index must produce the
    same alignments as the unsharded one (VERDICT round-1 item 4)."""
    import numpy as np

    from hisat2_tpu.align.pipeline import TPUAligner
    from hisat2_tpu.index.builder import build_fm_index
    from hisat2_tpu.index.variants import attach_variants

    rng = np.random.default_rng(21)
    s1 = rng.integers(0, 4, 30000).astype(np.uint8)
    s2 = rng.integers(0, 4, 30000).astype(np.uint8)
    snp = tmp_path / "v.snp"
    lines = []
    for i, chrom in enumerate(("cA", "cB")):
        s = (s1, s2)[i]
        for j, p in enumerate((1000, 7000)):
            alt = (s[p] + 1) % 4
            lines.append(f"rs{i}{j}\tsingle\t{chrom}\t{p}\t" +
                         "ACGT"[alt])
        lines.append(f"rd{i}\tdeletion\t{chrom}\t12000\t3")
        lines.append(f"ri{i}\tinsertion\t{chrom}\t15000\tTTA")
    snp.write_text("\n".join(lines) + "\n")

    single = build_fm_index([("cA", s1), ("cB", s2)])
    attach_variants(single, snp_file=str(snp))
    sharded = build_fm_index([("cA", s1), ("cB", s2)], shard_bp=31000)
    assert len(sharded.shards) == 2
    attach_variants(sharded, snp_file=str(snp))

    B, L = 20, 80
    starts = np.concatenate([
        np.array([960, 6960, 11950, 14950]),
        rng.integers(0, 30000 - L, 6)])
    reads = np.concatenate([
        np.stack([s1[p:p + L] for p in starts]),
        np.stack([s2[p:p + L] for p in starts[:10]])]).astype(np.int64)
    quals = np.full(reads.shape, 40, np.int64)
    lens = np.full(len(reads), L, np.int64)

    a1 = TPUAligner(single, variants=single._variants)
    a2 = TPUAligner(sharded, variants=sharded._variants)
    r1 = a1.align_batch(reads, quals, lens)
    r2 = a2.align_batch(reads, quals, lens)
    al1, al2 = r1.alignments, r2.alignments
    assert sum(map(len, al1)) > 0
    for x, y in zip(al1, al2):
        assert [str(a) for a in x] == [str(a) for a in y]
