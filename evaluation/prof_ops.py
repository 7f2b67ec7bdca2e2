"""Microbench: genome-scale-shaped hot ops on the attached device.

Builds FAKE (random-content, correct-shape) index planes at the
config-6 shard shape (1.9 Gbp) and times the round-5 sparse/compacted
ops against their dense forms:

  resolve — the [2B*H*P] SA lock-step walk (ops/resolve.py):
            dense resolve_rows vs live-compacted resolve_rows_sparse
  inject  — the injection penalty planes (ops/extend.py):
            dense pen_planes+cumsum vs live_pen_prefix

Content is random (timing only): the walk is a fixed-trip fori_loop and
the plane ops are data-independent, so throughput matches real data.

Usage: python evaluation/prof_ops.py [--which resolve|inject|all]
       [--live 0.15] [--n 1900000000]
"""

import argparse
import time

import numpy as np


def _t(f, *a):
    import jax
    out = jax.block_until_ready(f(*a))
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = jax.block_until_ready(f(*a))
        ts.append(time.perf_counter() - t0)
    del out
    return min(ts)


def bench_resolve(n_rows, M, live_frac, off_rate=4):
    import jax
    import jax.numpy as jnp
    from hisat2_tpu.ops import resolve as rs
    r = np.random.default_rng(0)
    nblocks = (n_rows + 127) // 128
    W = 49
    blocked = r.integers(0, 1 << 20, (nblocks, W), dtype=np.uint32)
    # keep LF targets in range: occ base columns bounded, checkpoints tiny
    blocked[:, :4] = r.integers(0, n_rows // 4, (nblocks, 4),
                                dtype=np.uint32)
    blocked[:, W - 5:] = r.integers(0, 3, (nblocks, 5), dtype=np.uint32)
    fchr = np.array([0, n_rows // 8, n_rows // 4, n_rows // 2, n_rows - 200],
                    np.int32)
    n_marked = (n_rows >> off_rate) + 8
    sa_marked = r.integers(0, n_rows, n_marked, dtype=np.int32)
    mark_w = np.zeros(4, np.uint32)
    mark_c = np.zeros(2, np.int32)
    row = r.integers(0, n_rows - 300, M).astype(np.int32)
    live = (r.random(M) < live_frac)
    db = jnp.asarray(blocked)
    args = (db, jnp.asarray(fchr), jnp.asarray(mark_w),
            jnp.asarray(mark_c), jnp.asarray(sa_marked), 5, off_rate)
    dense = jax.jit(lambda rw: rs.resolve_rows(*args, rw))
    sparse = jax.jit(lambda rw, lv: rs.resolve_rows_sparse(*args, rw, lv))
    td = _t(dense, jnp.asarray(row))
    tsp = _t(sparse, jnp.asarray(row), jnp.asarray(live))
    print(f"resolve M={M} live={live_frac:.2f} off_rate={off_rate}: "
          f"dense {td*1e3:.1f} ms  sparse {tsp*1e3:.1f} ms "
          f"({td/tsp:.2f}x)")


def bench_inject(n_text, N, J, L, live_frac):
    import jax
    import jax.numpy as jnp
    from hisat2_tpu.ops import extend as ex
    r = np.random.default_rng(1)
    nw = ((n_text + 15) // 16 + 127) // 128 * 128
    ref_words = r.integers(0, 1 << 32, nw, dtype=np.uint32)
    reads = r.integers(0, 4, (N, L)).astype(np.int32)
    quals = np.full((N, L), 40, np.int32)
    lens = np.full(N, L, np.int32)
    fresh = r.integers(0, n_text - 2 * L, (N, J)).astype(np.int32)
    live = r.random((N, J)) < live_frac
    xq = r.integers(0, L, (N, J)).astype(np.int32)
    mm_pen = jnp.asarray(np.full(64, 6, np.int32))
    rw = jnp.asarray(ref_words)
    rd, q, ln = jnp.asarray(reads), jnp.asarray(quals), jnp.asarray(lens)
    fr, lv, xj = jnp.asarray(fresh), jnp.asarray(live), jnp.asarray(xq)

    def dense(fr, lv, xj):
        pl = ex.pen_planes(rw, n_text, rd, q, ln,
                           jnp.where(lv, fr, -1), mm_pen, 1,
                           snv_delta1=rw, snv_delta2=rw)
        z = jnp.zeros((N, J, 1), jnp.int32)
        Pf = jnp.concatenate([z, jnp.cumsum(pl.pen, 2)], 2)
        pf = jnp.take_along_axis(Pf, xj[:, :, None], 2)[:, :, 0]
        return pf + pl.pen.sum(2)

    def sparse(fr, lv, xj):
        tot, _, pp = ex.live_pen_prefix(rw, n_text, rd, q, ln, mm_pen, 1,
                                        fr, lv, [xj],
                                        snv_delta1=rw, snv_delta2=rw)
        return pp[0][0] + tot

    td = _t(jax.jit(dense), fr, lv, xj)
    tsp = _t(jax.jit(sparse), fr, lv, xj)
    print(f"inject N={N} J={J} L={L} live={live_frac:.2f}: "
          f"dense {td*1e3:.1f} ms  sparse {tsp*1e3:.1f} ms "
          f"({td/tsp:.2f}x)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--which", default="all")
    ap.add_argument("--live", type=float, default=0.15)
    ap.add_argument("--n", type=int, default=600_000_000)
    a = ap.parse_args()
    if a.which in ("resolve", "all"):
        bench_resolve(a.n, 327_680, a.live)
    if a.which in ("inject", "all"):
        bench_inject(a.n, 8192, 56, 100, 0.02)
