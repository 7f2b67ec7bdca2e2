#!/usr/bin/env python
"""Benchmark: aligned reads/sec/GPU on the bundled example config.

Config 1 of BASELINE.md: 100 bp reads from /root/reference/example/reads
against a linear FM index of example/reference/22_20-21M.fa (1 Mbp chr22
slice), end-to-end through the full pipeline (device wavefront search +
resolve + extension, host selection, SAM rendering).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "reads/sec/chip", "vs_baseline": N,
   "card": "<nvidia-smi name, power limit>"}
Needs an NVIDIA GPU: it exits when JAX finds none, and every number it
prints carries the card's name and power limit.

Baseline: reference hisat2-align-s (v2.1.0, -p 1 --no-spliced-alignment)
measured on this container's single CPU core aligning the same reads
against the same index: 1000 reads in 0.027 s => ~37,000 reads/s/core
(tiny index, fully cache-resident — the CPU's best case).  vs_baseline is
ours / that single-core figure.
"""

import io
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

CPU_BASELINE_READS_PER_SEC = 37000.0  # measured: see module docstring

EXAMPLE_FA = "/root/reference/example/reference/22_20-21M.fa"
EXAMPLE_READS = "/root/reference/example/reads/reads_1.fa"
CACHE = "/tmp/hisat2_tpu_bench"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


_CARD = []


def card() -> str:
    """'<name>, <power limit>' of the GPU the numbers come from; exits
    when there is none."""
    if not _CARD:
        import subprocess
        try:
            r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=60)
            line = r.stdout.strip().splitlines()[0] if r.stdout else ""
        except (OSError, subprocess.SubprocessError):
            line = ""
        if not line:
            raise SystemExit("bench.py needs an NVIDIA GPU (nvidia-smi "
                             "found none)")
        _CARD.append(line)
    return _CARD[0]


def require_gpu():
    import jax
    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {d.platform!r}")
    return d


def bench_cli_true():
    """Throughput of the SHIPPING CLI path (python -m hisat2_tpu align)
    including default replay routing, SAM rendering, and demux — the
    asterisk-free companion number to the device-pipeline configs
    (round-4 VERDICT weak item 7).  Uses the example SNP-graph corpus
    (the shape with the highest replay routing share, PERF.md: 16% of
    reads at 37 ms each).  Two passes: the first warms compile caches,
    the second is timed wall-clock."""
    import subprocess

    os.makedirs(CACHE, exist_ok=True)
    card()
    d = CACHE
    reads = os.path.join(d, "cli_reads.fa")
    N_TILE = 16
    if not os.path.exists(reads):
        src = open(EXAMPLE_READS).read()
        with open(reads, "w") as f:
            for t in range(N_TILE):
                f.write(src.replace(">", f">t{t}_"))
    n_reads = sum(1 for line in open(reads) if line.startswith(">"))
    idx = os.path.join(d, "cli_snp")
    if not os.path.exists(idx + ".npz"):
        log("[bench:cli] building SNP-graph index ...")
        subprocess.run(
            [sys.executable, "-m", "hisat2_tpu", "build", EXAMPLE_FA,
             idx, "--snp",
             "/root/reference/example/reference/22_20-21M.snp"],
            check=True, capture_output=True)
    env = dict(os.environ)
    env.setdefault("PYTHONPATH",
                   os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "hisat2_tpu", "align", "-x", idx,
           "-f", "-U", reads, "--no-spliced-alignment",
           "-S", os.path.join(d, "cli_out.sam")]
    subprocess.run(cmd, check=True, env=env,
                   capture_output=True)          # warmup (compile cache)
    t0 = time.time()
    subprocess.run(cmd, check=True, env=env, capture_output=True)
    dt = time.time() - t0
    value = n_reads / dt
    log(f"[bench:cli] {n_reads} reads through the full CLI in {dt:.1f}s "
        f"(incl. process start, index load, replay routing, SAM) "
        f"on {card()}")
    print(json.dumps({
        "metric": "cli_true_reads_per_sec_example_snpgraph",
        "value": round(value, 1), "unit": "reads/sec/chip",
        "vs_baseline": None, "card": card(),
    }))


def main(config: int = 1):
    import jax

    from hisat2_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    require_gpu()
    card()
    import numpy as np

    from hisat2_tpu.align.pipeline import TPUAligner
    from hisat2_tpu.index.format import FMIndex
    from hisat2_tpu.io.fasta import read_batches
    from hisat2_tpu.io.sam import SamWriter

    if config != 1:
        return bench_config(config)
    os.makedirs(CACHE, exist_ok=True)
    idx_path = os.path.join(CACHE, "22lin.npz")
    if not os.path.exists(idx_path):
        log("[bench] building example index ...")
        from hisat2_tpu.index.builder import build_fm_index
        from hisat2_tpu.io.fasta import iter_fasta
        idx = build_fm_index(list(iter_fasta(EXAMPLE_FA)))
        idx.save(idx_path)
    index = FMIndex.load(idx_path)
    aligner = TPUAligner(index)

    # load the real example reads, tile to a steady-state batch size
    # (B and DEPTH are still to be swept on the H100: ROADMAP A7)
    B = 4096
    batch = next(read_batches(EXAMPLE_READS, 10000, pad_to=100))
    reps = (B + len(batch.names) - 1) // len(batch.names)
    codes = np.tile(batch.codes, (reps, 1))[:B]
    quals = np.tile(batch.quals, (reps, 1))[:B]
    lens = np.tile(batch.lens, reps)[:B]
    log(f"[bench] {B} reads/batch on {jax.devices()[0]}")

    # warm up (compile)
    t0 = time.time()
    res = aligner.align_batch(codes, quals, lens)
    log(f"[bench] warmup (compile) {time.time() - t0:.1f}s, "
        f"aligned {res.n_aligned}/{B} on {card()}")

    # timed: full pipeline including SAM rendering to an in-memory sink,
    # with the production DEPTH-deep dispatch pipeline (device crunches
    # later batches while the host renders earlier ones)
    K = 48
    names = [batch.names[i % len(batch.names)] for i in range(B)]

    from hisat2_tpu.align.pipeline import read_alignments

    def emit(handle):
        res = aligner.collect(handle)
        sink = io.StringIO()
        w = SamWriter(sink, index.meta.ref_names, index.meta.ref_lens,
                      no_head=True)
        w.write_batch_raw(names, codes, quals, lens, res.raw,
                          aligner.ref_codes,
                          finalize=lambda i: read_alignments(res.raw, i))

    # DEPTH-deep dispatch pipeline: several batches in flight hide device
    # latency behind host rendering
    from collections import deque
    DEPTH = 8

    def one_trial():
        t0 = time.time()
        total = 0
        pend = deque()
        for _ in range(K):
            pend.append(aligner.dispatch(codes, quals, lens))
            if len(pend) >= DEPTH:
                emit(pend.popleft())
            total += B
        while pend:
            emit(pend.popleft())
        return total / (time.time() - t0)

    # median of 3 trials, with the spread
    vals = sorted(one_trial() for _ in range(3))
    value = vals[1]
    log(f"[bench] trials: {[round(v, 1) for v in vals]} reads/s "
        f"(median {value:.1f}) on {card()}")
    print(json.dumps({
        "metric": "aligned_reads_per_sec_per_chip_example_linear",
        "value": round(value, 1),
        "unit": "reads/sec/chip",
        "vs_baseline": round(value / CPU_BASELINE_READS_PER_SEC, 4),
        "card": card(),
    }))


def bench_config(config: int):
    """Additional BASELINE.md measurement configs (recorded in
    BENCH_EXTRA.md; the driver's JSON line stays config 1):
      2: synthetic 40 Mbp linear genome, 100 bp single-end DNA
      3: example chr22 slice + SNP graph index, simulated paired DNA
      4: chr22 slice + splice sites (tran-style index), spliced RNA
      5: HLA-like genotype locus (3 kb backbone MSA, 200 alleles),
         variant-set typing throughput (the hisatgenotype path)
      6: north star — GRCh38-scale (3.12 Gbp, 24 chrom) synthetic
         snp_tran graph index (sharded), 100 bp spliced RNA reads with
         junctions drawn from the baked .ss set.  Needs the fixture from
         evaluation/make_northstar.py + `python -m hisat2_tpu build`.
    """
    import numpy as np

    from hisat2_tpu.align.pipeline import TPUAligner
    from hisat2_tpu.index.builder import build_fm_index
    from hisat2_tpu.index.variants import attach_variants
    from hisat2_tpu.io.fasta import iter_fasta
    from hisat2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    require_gpu()
    card()
    os.makedirs(CACHE, exist_ok=True)
    rng = np.random.default_rng(7)
    B = int(os.environ.get("HISAT2_TPU_BENCH_B", 4096))
    if config == 5:
        return bench_genotype(rng)
    ss_pairs = None
    if config == 2:
        g = rng.integers(0, 4, 40_000_000).astype(np.uint8)
        index = build_fm_index([("c2", g)])
        aligner = TPUAligner(index)
        src = [g]
        name = "synthetic40M_linear_dna"
        paired = spliced = False
    elif config == 3:
        seqs = list(iter_fasta(EXAMPLE_FA))
        index = build_fm_index(seqs)
        attach_variants(
            index,
            snp_file="/root/reference/example/reference/22_20-21M.snp")
        aligner = TPUAligner(index, variants=index._variants,
                             lane_meta=True, k=10)
        src = [s for _, s in seqs]
        name = "chr22slice_snpgraph_paired_dna"
        paired, spliced = True, False
    elif config == 4:
        seqs = list(iter_fasta(EXAMPLE_FA))
        index = build_fm_index(seqs)
        aligner = TPUAligner(index, spliced=True)
        src = [s for _, s in seqs]
        name = "chr22slice_spliced_rna"
        paired, spliced = False, True
    elif config == 6:
        from hisat2_tpu.index.format import FMIndex
        from hisat2_tpu.index.variants import VariantDB
        ns = os.environ.get("HISAT2_TPU_NORTHSTAR", "/tmp/northstar")
        base = os.path.join(ns, "bigidx")
        if not os.path.exists(base + ".npz"):
            raise SystemExit(
                f"config 6 needs the north-star index at {base}: run\n"
                f"  python evaluation/make_northstar.py --dir {ns}\n"
                f"  python -m hisat2_tpu build {ns}/big.fa {base} "
                f"--snp {ns}/big.snp --ss {ns}/big.ss")
        log("[bench:6] loading 3.12 Gbp sharded snp_tran index ...")
        index = FMIndex.load(base)
        variants = VariantDB.load(base)
        aligner = TPUAligner(index, variants=variants, lane_meta=True,
                             k=10, spliced=True)
        # chromosome 1 only is needed for read generation; cache it so
        # repeat runs skip the 3.12 Gbp FASTA parse
        chr1_npz = os.path.join(ns, "chr1.npz")
        if os.path.exists(chr1_npz):
            src = [np.load(chr1_npz)["chr1"]]
        else:
            log("[bench:6] loading genome for read generation ...")
            for nm, s in iter_fasta(os.path.join(ns, "big.fa")):
                src = [s]
                break
            np.savez(chr1_npz, chr1=src[0])
        # junction pool: the baked splice sites of chromosome 1 (ss
        # left/right = last exonic positions flanking the intron)
        ss_pairs = []
        first_chr = None
        with open(os.path.join(ns, "big.ss")) as f:
            for line in f:
                c, lo, hi, _ = line.split()
                if first_chr is None:
                    first_chr = c
                if c != first_chr:
                    break
                ss_pairs.append((int(lo), int(hi)))
        name = "northstar_grch38scale_snp_tran_rna"
        paired, spliced = False, True
    else:
        raise SystemExit(f"unknown config {config}")
    L = 100
    g = src[0]
    starts = rng.integers(0, len(g) - 2 * L - 600, B)
    codes = np.stack([g[s:s + L] for s in starts]).astype(np.int64)
    codes = np.where(codes > 3, 0, codes)
    if spliced:
        # a third of the reads cross a junction from a FIXED set of 400
        # planted introns (real RNA-seq junctions recur: GRCh38 has
        # ~200-400k sites total, and most reads hit already-seen ones —
        # per-read unique junctions would grow the site table without
        # bound and measure table-rebuild cost, not alignment)
        jr = np.flatnonzero(np.arange(B) % 3 == 0)
        lexon = 50
        if ss_pairs is not None:
            # config 6: junctions from the baked .ss set (left/right =
            # last exonic positions flanking the intron)
            pick = rng.integers(0, min(400, len(ss_pairs)), jr.size)
            for i, jidx in zip(jr, pick):
                lo, hi = ss_pairs[jidx]
                codes[i, :lexon] = np.minimum(g[lo - lexon + 1:lo + 1], 3)
                codes[i, lexon:] = np.minimum(g[hi:hi + L - lexon], 3)
        else:
            n_j = 400
            jpos = np.sort(rng.choice(
                np.arange(1000, len(g) - 1000, 700), n_j, replace=False))
            jlen = rng.integers(80, 400, n_j)
            pick = rng.integers(0, n_j, jr.size)
            for i, jidx in zip(jr, pick):
                p, il = int(jpos[jidx]), int(jlen[jidx])
                codes[i, :lexon] = np.minimum(g[p - lexon:p], 3)
                codes[i, lexon:] = np.minimum(
                    g[p + il:p + il + L - lexon], 3)
    quals = np.full((B, L), 40, np.int64)
    lens = np.full(B, L, np.int64)
    if paired:
        codes2 = np.stack([g[s + 150:s + 250] for s in starts])
        codes2 = np.where(codes2 > 3, 0, codes2)[:, ::-1]
        codes2 = np.where(codes2 < 4, 3 - codes2, codes2).astype(np.int64)
    log(f"[bench:{config}] {name}: warming up ...")

    if paired:
        # co-dispatched mates: one fused device batch per pair batch
        # (lanes 0..B-1 = mate 1, B..2B-1 = mate 2), like the CLI driver
        codes = np.concatenate([codes, codes2])
        quals = np.concatenate([quals, quals])
        lens = np.concatenate([lens, lens])

    def run_once():
        return aligner.align_batch(codes, quals, lens, paired=paired)

    t0 = time.time()
    run_once()
    nb = codes.shape[0]
    # pipeline-shaped warmup: the two-pass advance() path compiles
    # bucket variants the single-batch warmup never traces — run one
    # short pipelined window so the timed loop measures steady state,
    # not one-time compiles
    from collections import deque
    # pipeline depth: each in-flight batch pins device output buffers;
    # config 6 (3.12 Gbp, two shards) runs a shallow queue.  Both depths
    # are still to be swept on the H100 (ROADMAP A7; override:
    # HISAT2_TPU_BENCH_DEPTH)
    DEPTH = int(os.environ.get("HISAT2_TPU_BENCH_DEPTH",
                               2 if config == 6 else 8))
    ADV = min(4, DEPTH)
    pend = deque()
    for i in range(6):
        rdids = nb + i * nb + np.arange(nb, dtype=np.int64)
        pend.append(aligner.dispatch(codes, quals, lens, rdids))
        if len(pend) >= ADV:
            pend[-ADV] = aligner.advance(pend[-ADV], paired=paired)
        while len(pend) >= DEPTH:
            aligner.collect(pend.popleft(), paired=paired)
    while pend:
        aligner.collect(pend.popleft(), paired=paired)
    log(f"[bench:{config}] warmup {time.time() - t0:.1f}s on {card()}")
    K = 16
    n = B * K * (2 if paired else 1)

    # 8-deep dispatch pipeline (same shape as config 1 / the CLI driver);
    # advancing rdids so temp-splice-site injection reflects steady state.
    # Two-pass handles are advance()d mid-queue: pass 2 of batch i is
    # DISPATCHED while batches i+1..i+3 are still in flight, so it rides
    # the pipeline instead of serializing a device round trip in collect.
    def one_trial(rd0):
        t0 = time.time()
        pend = deque()
        for i in range(K):
            rdids = rd0 + i * nb + np.arange(nb, dtype=np.int64)
            pend.append(aligner.dispatch(codes, quals, lens, rdids))
            if len(pend) >= ADV:
                pend[-ADV] = aligner.advance(pend[-ADV], paired=paired)
            while len(pend) >= DEPTH:
                aligner.collect(pend.popleft(), paired=paired)
        while pend:
            aligner.collect(pend.popleft(), paired=paired)
        return n / (time.time() - t0)

    # median of 3 trials, with the spread
    vals = sorted(one_trial((7 + t * K) * nb) for t in range(3))
    value = vals[1]
    log(f"[bench:{config}] trials: {[round(v, 1) for v in vals]} reads/s "
        f"(median {value:.1f}) on {card()}")
    print(json.dumps({
        "metric": f"aligned_reads_per_sec_per_chip_{name}",
        "value": round(value, 1), "unit": "reads/sec/chip",
        "vs_baseline": None, "card": card(),
    }))


def bench_genotype(rng):
    """Config 5: variant-set HLA-like typing throughput.  A 3 kb
    backbone with 200 alleles (2-16 SNVs each) stands in for an IMGT
    locus (real HLA data is not downloadable in this environment);
    reads simulate a 2:1 diploid mixture.  Measures reads/sec through
    the full typing path: backbone graph alignment -> clipped
    placements -> variant-set compatibility -> EM ranking."""
    import io as _io
    import numpy as np

    from hisat2_tpu.genotype.driver import run_genotype_msa

    ACGT = np.array(list("ACGT"))
    L = 3000
    bb = rng.integers(0, 4, L)
    msa = []
    for a in range(200):
        seq = bb.copy()
        for p in rng.choice(L, int(rng.integers(2, 17)), replace=False):
            seq[p] = (seq[p] + 1 + rng.integers(0, 3)) % 4
        msa.append((f"X*{a // 10 + 1:02d}:{a % 10 + 1:02d}",
                    "".join(ACGT[seq])))
    os.makedirs(CACHE, exist_ok=True)
    msa_path = os.path.join(CACHE, "hla_like.msa.fa")
    reads_path = os.path.join(CACHE, "hla_like.reads.fa")
    with open(msa_path, "w") as f:
        for nm, s2 in msa:
            f.write(f">{nm}\n{s2}\n")
    n_reads = 30000
    with open(reads_path, "w") as f:
        i = 0
        for rep, n in ((3, n_reads * 2 // 3), (27, n_reads // 3)):
            s2 = msa[rep][1]
            for _ in range(n):
                st = int(rng.integers(0, L - 150))
                f.write(f">r{i}\n{s2[st:st + 150]}\n")
                i += 1

    class A:
        pass
    args = A()
    args.msa = msa_path
    args.reads = reads_path
    args.out = os.path.join(CACHE, "hla_like.report")
    args.top = 5
    args.num_editdist = 2
    args.pair_loglik = False
    args.assembly = False
    args.out_base = os.path.join(CACHE, "hla_like")
    run_genotype_msa(args)          # warmup (compile)
    t0 = time.time()
    run_genotype_msa(args)
    dt = time.time() - t0
    value = i / dt
    rep = open(args.out).read()
    ok = msa[3][0] in rep and msa[27][0] in rep
    log(f"[bench:5] typed {i} reads in {dt:.1f}s (top alleles "
        f"{'correct' if ok else 'WRONG'}) on {card()}")
    print(json.dumps({
        "metric": "genotype_typing_reads_per_sec",
        "value": round(value, 1),
        "unit": "reads/sec/chip",
        "vs_baseline": 0.0, "card": card(),
    }))


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=1)
    ap.add_argument("--cli-true", action="store_true",
                    help="measure the shipping CLI path incl. replay "
                         "routing (BENCH_EXTRA companion number)")
    a = ap.parse_args()
    if a.cli_true:
        bench_cli_true()
    else:
        main(a.config)
