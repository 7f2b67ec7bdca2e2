"""Entry-point plumbing for running on a GPU: the compile-cache helper,
chip_smoke.py's refusal to run without a GPU, the fly-shape generator,
and dryrun_multichip's device-count check."""

import os
import shutil
import subprocess
import sys
from collections import Counter

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _py(code, env_extra, cwd=REPO, drop=()):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               **env_extra)
    for k in drop:
        env.pop(k, None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_compile_cache_default_is_checkout(monkeypatch):
    import jax

    from hisat2_tpu.utils.compile_cache import CHECKOUT, enable_compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(CHECKOUT, ".jax_cache")
    assert enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.5
    assert CHECKOUT == REPO


def test_compile_cache_env_sets_nothing(monkeypatch, tmp_path):
    import jax

    from hisat2_tpu.utils.compile_cache import enable_compile_cache
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs) == before


@pytest.mark.parametrize("env_set", [True, False])
def test_cli_entry_uses_compile_cache(tmp_path, env_set):
    """`python -m hisat2_tpu` places the cache where the helper says,
    before any command runs."""
    code = ("import jax\n"
            "from hisat2_tpu.__main__ import main\n"
            "assert main(['no-such-command']) == 2\n"
            "print('DIR=' + str(jax.config.jax_compilation_cache_dir))\n")
    if env_set:
        r = _py(code, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
        want = str(tmp_path)
    else:
        r = _py(code, {}, drop=("JAX_COMPILATION_CACHE_DIR",))
        want = os.path.join(REPO, ".jax_cache")
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"DIR={want}" in r.stdout


def test_chip_smoke_refuses_cpu(tmp_path):
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"),
         "--workdir", str(tmp_path / "w")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the repo beside it the script fails and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def _read_fasta(path):
    seqs, name, parts = {}, None, []
    for line in open(path):
        if line.startswith(">"):
            if name:
                seqs[name] = "".join(parts)
            name, parts = line[1:].strip(), []
        else:
            parts.append(line.strip())
    seqs[name] = "".join(parts)
    return seqs


@pytest.mark.parametrize("seed", [0, 5])
def test_flyshape_inputs_agree(tmp_path, seed):
    """GTF, extracted .ss, planted motifs and the .snp catalog agree."""
    import io

    from hisat2_tpu.tools import flyshape
    from hisat2_tpu.tools.gtf import extract_splice_sites
    scale = 0.01
    info = flyshape.write_fly_shape(str(tmp_path), seed=seed, scale=scale)
    genome = _read_fasta(info["fasta"])
    assert [(n, len(s)) for n, s in genome.items()] == [
        (n, max(int(ln * scale), 20_000)) for n, ln in flyshape.DM6_CHROMS]
    assert sum(map(len, genome.values())) == info["bp"]
    # GTF introns -> expected .ss rows (0-based last/first exonic bases)
    exons = {}
    for line in open(info["gtf"]):
        f = line.rstrip("\n").split("\t")
        gid = f[8].split('"')[1]
        exons.setdefault(gid, (f[0], f[6], []))[2].append(
            (int(f[3]), int(f[4])))
    assert abs(len(exons) - flyshape.N_GENES * scale) <= 0.1 * (
        flyshape.N_GENES * scale)
    introns = set()
    for chrom, strand, ex in exons.values():
        ex.sort()
        for (_, e1), (s2, _) in zip(ex, ex[1:]):
            assert s2 - e1 - 1 >= 60
            introns.add((chrom, e1 - 1, s2 - 1, strand))
    assert 3.5 <= len(introns) / len(exons) <= 4.5
    out = io.StringIO()
    with open(info["gtf"]) as f:
        extract_splice_sites(f, out)
    ss = {(c, int(a), int(b), s) for c, a, b, s in
          (line.split() for line in out.getvalue().splitlines())}
    assert ss == introns
    canon = sum(
        (genome[c][a + 1:a + 3], genome[c][b - 2:b]) ==
        (("GT", "AG") if s == "+" else ("CT", "AC"))
        for c, a, b, s in ss)
    assert canon >= 0.95 * len(ss)
    # variants: in range, SNV alt differs from the reference base, 10 bp
    # apart, ~1/kbp, ~90/5/5 mix
    kinds, last = Counter(), {}
    for line in open(info["snp"]):
        vid, kind, chrom, pos, data = line.split()
        pos = int(pos)
        seq = genome[chrom]
        assert 0 <= pos < len(seq)
        assert pos - last.get(chrom, -100) >= 10
        last[chrom] = pos
        kinds[kind] += 1
        if kind == "single":
            assert data != seq[pos]
        elif kind == "deletion":
            assert 1 <= int(data) <= 5 and pos + int(data) < len(seq)
        else:
            assert kind == "insertion" and 1 <= len(data) <= 5
    n = sum(kinds.values())
    assert n == info["variants"]
    assert abs(n / info["bp"] - flyshape.VARIANTS_PER_BP) < 0.15e-3
    assert 0.86 <= kinds["single"] / n <= 0.94
    assert kinds["deletion"] > 0 and kinds["insertion"] > 0


def test_dryrun_multichip_needs_devices():
    import jax

    import __graft_entry__ as ge
    with pytest.raises(RuntimeError, match="needs"):
        ge.dryrun_multichip(len(jax.devices()) + 1)
