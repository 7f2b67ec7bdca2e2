#!/usr/bin/env python3
"""Smoke test of the aligner's main path on an NVIDIA GPU.

  python chip_smoke.py           phases (a)-(g) below on one GPU
  python chip_smoke.py --four    the multi-device paths on four GPUs

One process holds the card(s).  Host-only work (genome generation, index
build, read simulation) and the CPU comparison run in child processes with
JAX_PLATFORMS=cpu, which never open a card.  Phases:

  (a) the device JAX sees and `nvidia-smi` name / power limit
  (b) the committed oracle corpora (tests/data: emu, mm3 in four reporting
      modes, mj3x, nss in both passes + its novel .ss) through the CLI;
      SAM bodies must be byte-equal to the committed oracle SAMs
  (c) a genome shaped like HISAT2's bdgp6_tran index (dm6's seven
      sequences, 137.5 Mbp; hisat2_tpu/tools/flyshape.py) through
      extract-splice-sites, build --snp --ss, simulate-reads (paired
      2x100 RNA and DNA) and paired align with known/novel splice sites
  (d) the first 1,000 pairs of (c) aligned again on the CPU in a child
      process: DNA and RNA SAM byte-equal (every differing RNA record is
      printed before the phase fails)
  (e) (c) scored against the simulated truth (calculate_read_cost.py)
  (f) component checks at real widths (hisat2_tpu/utils/devcheck.py):
      rescue counts, every ref_chars_block branch, lax.top_k tie order
  (g) memory_analysis() of the main device steps and peak device memory

The last line of stdout is {"ok": true, "device": {...}}; any failed phase
exits non-zero without it.  Work files go to <checkout>/.smoke_work
(removed at the end unless --keep).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gzip
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.time()
RNA_LIMITS = dict(aligned=0.95, correct=0.95)
DNA_LIMITS = dict(aligned=0.95, correct=0.95)
SUBSET_PAIRS = 1000
PAIRS = 3000            # pairs per read type in (c)
FLY_SCALE = 1.0         # dm6's full lengths: the 128-word-row gather runs
FOUR_SCALE = 0.05       # --four checks equality, not genome-scale paths


class SmokeFail(Exception):
    pass


def log(msg):
    print(f"[smoke {time.time() - T0:8.1f}s] {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise SmokeFail(msg)


def require_gpu(count: int):
    """The devices JAX sees; fails unless they are `count`+ GPUs."""
    import jax
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX found no GPU (platform {devs[0].platform!r})")
    check(len(devs) >= count, f"needs {count} GPUs, JAX sees {len(devs)}")
    return devs


def nvidia_smi() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


class CompileClock:
    """Seconds XLA spends compiling (or loading an executable from the
    persistent cache), read from jax.monitoring events.  Tracing and
    lowering are not counted: their events nest."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        import jax
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, secs, **_):
        if event == self.EVENT:
            self.total += secs


def cli(argv):
    from hisat2_tpu.__main__ import main
    rc = main(list(argv))
    check(rc in (0, None), f"CLI {' '.join(argv[:2])} exited {rc}")


def sam_body(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        return [line for line in f if not line.startswith("@")]


def gunzip(src, dst):
    with gzip.open(src, "rb") as f, open(dst, "wb") as g:
        shutil.copyfileobj(f, g)


def child(args, env_extra, log_path):
    env = dict(os.environ, PYTHONPATH=REPO, **env_extra)
    with open(log_path, "w") as out:
        return subprocess.Popen([sys.executable] + args, env=env, cwd=REPO,
                                stdout=out, stderr=subprocess.STDOUT)


def wait_child(p, name, log_path, timeout):
    try:
        rc = p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
        rc = "timeout"
    if rc != 0:
        with open(log_path) as f:
            tail = f.read()[-3000:]
        raise SmokeFail(f"{name} child failed ({rc}):\n{tail}")
    with open(log_path) as f:
        return f.read()


# ---------------------------------------------------------------- prep
def fly_paths(work):
    d = os.path.join(work, "fly")
    return dict(dir=d, fa=f"{d}/genome.fa", gtf=f"{d}/genes.gtf",
                snp=f"{d}/variants.snp", ss=f"{d}/genes.ss",
                idx=f"{d}/idx", rna=f"{d}/sim_rna", dna=f"{d}/sim_dna")


def prep(work, scale, seed):
    """Child: fly-shape inputs, index and simulated reads, all through the
    CLI entry points.  Prints a JSON line of host wall times."""
    from hisat2_tpu.tools.flyshape import write_fly_shape
    p = fly_paths(work)
    t = {}
    t0 = time.time()
    info = write_fly_shape(p["dir"], seed=seed, scale=scale)
    t["generate_s"] = time.time() - t0
    t0 = time.time()
    with open(p["ss"], "w") as f, contextlib.redirect_stdout(f):
        cli(["extract-splice-sites", p["gtf"]])
    t["extract_ss_s"] = time.time() - t0
    t0 = time.time()
    cli(["build", p["fa"], p["idx"], "--snp", p["snp"], "--ss", p["ss"],
         "-q"])
    t["build_s"] = time.time() - t0
    t0 = time.time()
    cli(["simulate-reads", p["fa"], p["rna"], "--gtf", p["gtf"],
         "--snp", p["snp"], "-n", str(PAIRS), "--random-seed", str(seed)])
    cli(["simulate-reads", p["fa"], p["dna"], "-d", "--snp", p["snp"],
         "-n", str(PAIRS), "--random-seed", str(seed + 1)])
    t["simulate_s"] = time.time() - t0
    with open(p["ss"]) as f:
        n_ss = sum(1 for _ in f)
    print(json.dumps(dict(t, bp=info["bp"], genes=info["genes"],
                          variants=info["variants"], splice_sites=n_ss)))


def align_args(p, kind, out, upto=None):
    a = ["align", "-x", p["idx"], "-f", "-1", f"{p[kind]}_1.fa",
         "-2", f"{p[kind]}_2.fa", "--known-splicesite-infile", p["ss"],
         "--novel-splicesite-outfile", f"{out}.novel.ss",
         "--batch-size", str(SUBSET_PAIRS), "--quiet", "-S", out]
    if upto:
        a += ["-u", str(upto)]
    return a


def cpu_align(work):
    """Child (JAX_PLATFORMS=cpu): phase (d)'s CPU runs of the subset."""
    p = fly_paths(work)
    for kind in ("rna", "dna"):
        t0 = time.time()
        cli(align_args(p, kind, f"{p['dir']}/cpu_{kind}.sam",
                       upto=SUBSET_PAIRS))
        print(f"cpu {kind} subset align {time.time() - t0:.1f}s",
              flush=True)


# ---------------------------------------------------------------- (b)
def phase_b(work, clock):
    data = os.path.join(REPO, "tests", "data")
    d = os.path.join(work, "corpora")
    os.makedirs(d, exist_ok=True)
    for name in ("emu", "mm3", "nss", "mj3x"):
        gunzip(f"{data}/{name}_genome.fa.gz", f"{d}/{name}.fa")
        cli(["build", f"{d}/{name}.fa", f"{d}/{name}", "-q"])
    dna = ["--no-spliced-alignment", "-f", "--quiet"]
    runs = [("emu", "emu", dna + ["--exact-replay", "-U",
                                  f"{data}/emu_reads.fa"], "emu_ref"),
            ("mj3x", "mj3x", ["-f", "--quiet", "-U",
                              f"{data}/mj3x_reads.fa"], "mj3x_ref"),
            ("nss_p1", "nss", ["-f", "--quiet", "-U", f"{data}/nss_reads.fa",
                               "--novel-splicesite-outfile",
                               f"{d}/novel.ss"], "nss_ref_p1"),
            ("nss_p2", "nss", ["-f", "--quiet", "-U", f"{data}/nss_reads.fa",
                               "--novel-splicesite-infile",
                               f"{data}/nss_ref_novel.ss"], "nss_ref_p2")]
    for mode, extra in (("k10", ["-k", "10"]),
                        ("sec", ["-k", "3", "--secondary"]), ("a", ["-a"]),
                        ("ms", ["-k", "2", "--max-seeds", "30"])):
        runs.append((f"mm3_{mode}", "mm3",
                     dna + ["-U", f"{data}/mm3_reads.fa"] + extra,
                     f"mm3_ref_{mode}"))
    for tag, idx, args, ref in runs:
        c0, t0 = clock.total, time.time()
        out = f"{d}/{tag}.sam"
        cli(["align", "-x", f"{d}/{idx}"] + args + ["-S", out])
        got, want = sam_body(out), sam_body(f"{data}/{ref}.sam.gz")
        diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        log(f"(b) {tag}: {len(got)} records, {len(diff)} differ from "
            f"{ref}.sam.gz ({time.time() - t0:.1f}s wall, "
            f"{clock.total - c0:.1f}s XLA compile)")
        check(len(got) == len(want) and not diff,
              f"{tag} differs from the oracle" + (
                  f" at record {diff[0]}:\n got {got[diff[0]]} want "
                  f"{want[diff[0]]}" if diff else " in record count"))
        if tag == "nss_p1":
            with open(f"{d}/novel.ss") as f, \
                    open(f"{data}/nss_ref_novel.ss") as g:
                check(f.read() == g.read(), "nss novel .ss differs")
            log("(b) nss novel .ss byte-equal to nss_ref_novel.ss")


# ---------------------------------------------------------------- (f)
def phase_f(dev, n_text):
    from hisat2_tpu.utils import devcheck as dc
    for L in (100, 256):
        t0 = time.time()
        bad = dc.rescue_count_mismatches(4096, 57344, L, seed=L,
                                         device=dev)
        log(f"(f) rescue counts R=4096 W=57344 L={L}: {bad} mismatches "
            f"({time.time() - t0:.1f}s)")
        check(bad == 0, f"rescue counts inexact at L={L}")
    t0 = time.time()
    res = dc.ref_chars_mismatches(n_text, device=dev)
    log(f"(f) ref_chars_block vs ref_char at {n_text} chars "
        f"(~{n_text // 16} words): {res} ({time.time() - t0:.1f}s)")
    check(not any(res.values()), "ref_chars_block disagrees with ref_char")
    res = dc.topk_tie_mismatches(dev)
    log(f"(f) lax.top_k tie order, GPU vs CPU: {res} index mismatches")
    check(not any(res.values()), "top_k tie order differs from the CPU")


# ---------------------------------------------------------------- (c-e)
def compare_subset(p):
    """Phase (d): GPU vs CPU SAM of the first SUBSET_PAIRS pairs."""
    for kind in ("dna", "rna"):
        g = sam_body(f"{p['dir']}/gpu_{kind}_sub.sam")
        c = sam_body(f"{p['dir']}/cpu_{kind}.sam")
        check(len(g) > 0, f"empty GPU {kind} SAM")
        by_g, by_c = collections.defaultdict(list), \
            collections.defaultdict(list)
        for line in g:
            by_g[line.split("\t", 1)[0]].append(line)
        for line in c:
            by_c[line.split("\t", 1)[0]].append(line)
        diff = [n for n in sorted(set(by_g) | set(by_c))
                if by_g[n] != by_c[n]]
        for n in diff:
            for side, mine, other in (("GPU", by_g, by_c),
                                      ("CPU", by_c, by_g)):
                for r in mine[n]:
                    if r not in other[n]:
                        log(f"(d) {kind.upper()} {side}-only: {r.rstrip()}")
        nd = sum(a != b for a, b in zip(g, c)) + abs(len(g) - len(c))
        log(f"(d) {kind.upper()} {len(g)} GPU / {len(c)} CPU records: {nd} "
            f"differ, over {len(diff)} reads")
        check(nd == 0, f"{kind.upper()} SAM differs between GPU and CPU")


def phase_e(p):
    sys.path.insert(0, os.path.join(REPO, "evaluation"))
    from calculate_read_cost import parse_sam, score
    for kind, lim in (("rna", RNA_LIMITS), ("dna", DNA_LIMITS)):
        s = score(parse_sam(f"{p[kind]}.sam"),
                  parse_sam(f"{p['dir']}/gpu_{kind}.sam"), slack=5)
        n = max(s["n"], 1)
        al, co = s["aligned"] / n, s["correct"] / n
        cls = ", ".join(f"{k} {v[2]}/{v[0]}"
                        for k, v in sorted(s["classes"].items()))
        log(f"(e) {kind.upper()}: {s['n']} mates, aligned {al:.4f}, "
            f"correct {co:.4f} ({cls}); pairs both-correct "
            f"{s['pairs_ok']}/{s['pairs']}; junctions TP {s['junc_tp']}"
            f" of {s['junc_truth']} true, {s['junc_found']} found")
        check(al >= lim["aligned"] and co >= lim["correct"],
              f"{kind} accuracy below {lim}")


def phase_g(p):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hisat2_tpu.align.driver import make_aligner, make_scoring
    from hisat2_tpu.cli.align import build_parser
    from hisat2_tpu.index.format import FMIndex
    from hisat2_tpu.index.variants import VariantDB
    from hisat2_tpu.io.fasta import read_batches

    args = build_parser().parse_args(
        align_args(p, "rna", os.devnull)[1:])
    index = FMIndex.load(p["idx"])
    al = make_aligner(args, index, make_scoring(args),
                      VariantDB.load(p["idx"]))
    al.splice_db.add_from_file(p["ss"])
    b1 = next(read_batches(f"{p['dna']}_1.fa", SUBSET_PAIRS, fmt="fasta"))
    b2 = next(read_batches(f"{p['dna']}_2.fa", SUBSET_PAIRS, fmt="fasta"))
    codes = np.concatenate([b1.codes, b2.codes])
    quals = np.concatenate([b1.quals, b2.quals])
    lens = np.concatenate([b1.lens, b2.lens])
    for name, a in (("fast pass", al._fast), ("full pass", al)):
        minsc = np.array([a.scoring.min_score(int(x)) for x in lens],
                         np.int64)
        rd, qd, h2d = a._pack_h2d(codes, quals, lens, minsc)
        ss = (a.splice_db.device_tables(0, a.dev.meta.n) if a.use_ss
              else None)
        rj = (jnp.asarray(np.arange(len(lens)), jnp.int32) if a.use_ss
              else None)
        m = a._device_step.lower(
            a.dev, dict(a.params), rd, qd, None, None, rj, ss,
            uniform=True, h2d=h2d, full_out=False).compile() \
            .memory_analysis()
        log(f"(g) {name} step, {len(lens)} lanes: arguments "
            f"{m.argument_size_in_bytes} B, outputs "
            f"{m.output_size_in_bytes} B, temp {m.temp_size_in_bytes} B, "
            f"code {m.generated_code_size_in_bytes} B")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"(g) peak_bytes_in_use {stats.get('peak_bytes_in_use')} of "
        f"bytes_limit {stats.get('bytes_limit')}")


# ---------------------------------------------------------------- main
def run_one(a):
    devs = require_gpu(1)
    dev = devs[0]
    log(f"(a) devices: {devs}; device_kind {dev.device_kind!r}")
    log(f"(a) nvidia-smi: {nvidia_smi()}")
    from hisat2_tpu.tools.flyshape import DM6_CHROMS
    from hisat2_tpu.utils.compile_cache import enable_compile_cache
    log(f"compile cache: {enable_compile_cache()}")
    clock = CompileClock()
    work = a.workdir
    os.makedirs(work, exist_ok=True)
    p = fly_paths(work)
    procs = []
    try:
        prep_log = f"{work}/prep.log"
        procs.append(child([__file__, "--prep", work],
                           {"JAX_PLATFORMS": "cpu"}, prep_log))
        t0 = time.time()
        phase_b(work, clock)
        log(f"(b) oracle corpora byte-equal ({time.time() - t0:.1f}s)")
        n_text = sum(max(int(ln * FLY_SCALE), 20_000)
                     for _, ln in DM6_CHROMS)
        t0 = time.time()
        phase_f(dev, n_text)
        log(f"(f) component checks exact ({time.time() - t0:.1f}s)")
        out = wait_child(procs[0], "prep", prep_log, timeout=1500)
        info = json.loads(out.strip().splitlines()[-1])
        log(f"(c) fly-shape genome: {info['bp']} bp, {info['genes']} genes,"
            f" {info['splice_sites']} splice sites, {info['variants']} "
            f"variants; {PAIRS} pairs per read type")
        for k in ("generate_s", "extract_ss_s", "build_s", "simulate_s"):
            log(f"(c) host {k[:-2]} wall {info[k]:.1f}s")
        cpu_log = f"{work}/cpu_align.log"
        procs.append(child([__file__, "--cpu-align", work],
                           {"JAX_PLATFORMS": "cpu"}, cpu_log))
        for kind, upto, out in (
                ("rna", SUBSET_PAIRS, "gpu_rna_sub"),
                ("dna", SUBSET_PAIRS, "gpu_dna_sub"),
                ("rna", None, "gpu_rna"), ("dna", None, "gpu_dna")):
            c0, t0 = clock.total, time.time()
            cli(align_args(p, kind, f"{p['dir']}/{out}.sam", upto=upto))
            wall = time.time() - t0
            comp = clock.total - c0
            n = upto or PAIRS
            log(f"(c) {kind.upper()} align {n} pairs ({out}): wall "
                f"{wall:.1f}s")
            log(f"(c) {kind.upper()} {out} XLA compile {comp:.1f}s")
            log(f"(c) {kind.upper()} {out} align (wall - compile) "
                f"{wall - comp:.1f}s = {2 * n / max(wall - comp, 1e-9):.0f}"
                f" reads/s")
        out = wait_child(procs[1], "cpu-align", cpu_log, timeout=1500)
        for line in out.splitlines():
            if line.startswith("cpu "):
                log(f"(d) {line}")
        compare_subset(p)
        phase_e(p)
        phase_g(p)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    return dev, 1


def run_four(a):
    """--four: (i) the CLI --n-hosts path as four processes pinned to one
    GPU each vs the one-GPU SAM, (ii) sharded_align_step over a 4-GPU dp
    mesh vs the single-GPU step, (iii) MPMD shard placement over two GPUs
    vs the unsharded index."""
    work = a.workdir
    os.makedirs(work, exist_ok=True)
    p = fly_paths(work)
    procs = []
    try:
        # host-only prep first: no process may open a card before the
        # four pinned children have theirs
        prep_log = f"{work}/prep.log"
        procs.append(child([__file__, "--prep", work, "--four"],
                           {"JAX_PLATFORMS": "cpu"}, prep_log))
        info = json.loads(wait_child(procs[0], "prep", prep_log, 1500)
                          .strip().splitlines()[-1])
        log(f"fly-shape genome {info['bp']} bp, build wall "
            f"{info['build_s']:.1f}s")
        base = ["-m", "hisat2_tpu", "align", "-x", p["idx"], "-f",
                "-1", f"{p['dna']}_1.fa", "-2", f"{p['dna']}_2.fa",
                "--no-spliced-alignment", "--batch-size", "256", "--quiet"]
        multi = f"{p['dir']}/multi.sam"
        t0 = time.time()
        kids = []
        for r in range(4):
            lp = f"{work}/rank{r}.log"
            kids.append((child(base + ["--n-hosts", "4", "--host-rank",
                                       str(r), "-S", multi],
                               {"CUDA_VISIBLE_DEVICES": str(r)}, lp), lp))
            procs.append(kids[-1][0])
        for r, (pr, lp) in enumerate(kids):
            wait_child(pr, f"rank {r}", lp, 1500)
        log(f"(i) 4 processes x 1 GPU (--n-hosts 4) done in "
            f"{time.time() - t0:.1f}s")
        devs = require_gpu(4)
        log(f"devices: {devs}; device_kind {devs[0].device_kind!r}")
        log(f"nvidia-smi: {nvidia_smi()}")
        from hisat2_tpu.utils.compile_cache import enable_compile_cache
        enable_compile_cache()
        single = f"{p['dir']}/single.sam"
        cli(base[2:] + ["-S", single])
        g, s = sam_body(multi), sam_body(single)
        nd = sum(x != y for x, y in zip(g, s)) + abs(len(g) - len(s))
        log(f"(i) merged 4-process SAM {len(g)} records vs one-GPU "
            f"{len(s)}: {nd} differ")
        check(nd == 0 and g, "--n-hosts merge differs from one GPU")
        four_mesh(p, devs)
        four_mpmd(p, devs)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    return devs[0], 4


def _dna_reads(p, n):
    import numpy as np

    from hisat2_tpu.io.fasta import read_batches
    b = next(read_batches(f"{p['dna']}_1.fa", n, fmt="fasta"))
    return (b.codes.astype(np.int32), b.quals.astype(np.int32),
            b.lens.astype(np.int32))


def four_mesh(p, devs):
    import numpy as np

    from hisat2_tpu.align.pipeline import TPUAligner
    from hisat2_tpu.index.format import FMIndex
    from hisat2_tpu.parallel import mesh as pmesh
    from hisat2_tpu.utils import devcheck
    al = TPUAligner(FMIndex.load(p["idx"]), spliced=True)
    reads, quals, lens = _dna_reads(p, 512)
    minsc = np.array([al.scoring.min_score(int(x)) for x in lens], np.int32)
    m = pmesh.make_mesh(n_dp=4)
    ids = [d.id for d in m.devices.flat]
    log(f"(ii) mesh devices {ids}")
    check(len(set(ids)) == 4, "make_mesh repeats a device")
    bad = devcheck.sharded_step_mismatches(
        al, reads, quals, lens, minsc, np.arange(len(lens), dtype=np.int32),
        m)
    log(f"(ii) sharded_align_step over 4 GPUs vs 1 GPU, 512 reads: "
        f"{len(bad)} differing fields {bad[:5]}")
    check(not bad, "4-GPU sharded step differs from one GPU")


def four_mpmd(p, devs):
    from hisat2_tpu.align.pipeline import TPUAligner
    from hisat2_tpu.index.builder import build_fm_index
    from hisat2_tpu.index.format import FMIndex
    from hisat2_tpu.io.fasta import iter_fasta
    seqs = list(iter_fasta(p["fa"]))
    half = sum(len(s) for _, s in seqs) // 2 + 1
    sh_idx = build_fm_index(seqs, shard_bp=half)
    check(len(sh_idx.shards) >= 2, "the MPMD index did not shard")
    al2 = TPUAligner(sh_idx, spliced=False, shard_devices=devs[:2])
    places = [sorted(d.id for d in dv.ref_words.devices())
              for dv in al2.devs]
    log(f"(iii) {len(sh_idx.shards)} index shards on devices {places}")
    check(len({tuple(x) for x in places}) == 2,
          "MPMD shards share one device")
    al1 = TPUAligner(FMIndex.load(p["idx"]), spliced=False)
    reads, quals, lens = _dna_reads(p, 512)
    r1 = al1.align_batch(reads, quals, lens).alignments
    r2 = al2.align_batch(reads, quals, lens).alignments
    nd = sum([str(x) for x in a] != [str(y) for y in b]
             for a, b in zip(r1, r2))
    n_al = sum(1 for a in r1 if a)
    log(f"(iii) MPMD 2-GPU sharded vs unsharded index: {n_al}/{len(r1)} "
        f"reads aligned, {nd} differ")
    check(nd == 0 and n_al > 0.9 * len(r1),
          "MPMD shards differ from the unsharded index")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device paths on four GPUs")
    ap.add_argument("--workdir", default=os.path.join(REPO, ".smoke_work"))
    ap.add_argument("--keep", action="store_true",
                    help="keep the work directory")
    ap.add_argument("--prep", help=argparse.SUPPRESS)
    ap.add_argument("--cpu-align", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.prep:
        prep(a.prep, FOUR_SCALE if a.four else FLY_SCALE, seed=7)
        return 0
    if a.cpu_align:
        cpu_align(a.cpu_align)
        return 0
    try:
        import hisat2_tpu  # noqa: F401
    except ImportError as e:
        print(f"[smoke] FAIL: the hisat2_tpu package is missing ({e})")
        return 2
    if os.path.exists(a.workdir) and not a.keep:
        shutil.rmtree(a.workdir)
    try:
        dev, count = run_four(a) if a.four else run_one(a)
    except SmokeFail as e:
        log(f"FAIL: {e}")
        return 1
    log(f"all phases passed in {time.time() - T0:.1f}s")
    if not a.keep:
        shutil.rmtree(a.workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
