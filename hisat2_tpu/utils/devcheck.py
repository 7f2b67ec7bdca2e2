"""Component checks: a device op at a real width against an exact reference.

Each check returns the number of disagreeing elements (0 = pass), so the
same function serves the CPU tests at small shapes, the ``gpu``-marked
tests and chip_smoke.py at real widths:

  rescue_count_mismatches   the bf16 grouped-conv match counts of mate rescue
                            (ops/rescue.window_match_counts) vs an integer
                            count, in numpy on a lane sample and in int32 on
                            the device for every lane
  ref_chars_mismatches      every gather branch of ops/rank.ref_chars_block
                            vs per-char ops/rank.ref_char
  topk_tie_mismatches       lax.top_k tie order on a device vs on the CPU,
                            at the shapes of ops/rescue.py and
                            ops/splice.select_pairs
  sharded_step_mismatches   parallel/mesh.sharded_align_step over a dp mesh
                            vs the single-device step
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import rank as rk
from ..ops import rescue as rescue_ops


def _planted_window(rng, R: int, W: int, L: int):
    """refc [R, W+L-1] codes 0..4 and reads [R, L]: each read copies its
    lane's window at a random diagonal (so the count reaches L there),
    then a few reads get mismatches, N calls or short-read padding."""
    span = W + L - 1
    refc = rng.integers(0, 4, (R, span)).astype(np.int32)
    refc[rng.random((R, span)) < 0.002] = 4
    d0 = rng.integers(0, W, R)
    reads = refc[np.arange(R)[:, None], d0[:, None] + np.arange(L)].copy()
    reads[reads == 4] = 0
    mut = rng.random((R, L)) < 0.02
    reads = np.where(mut, (reads + 1) % 4, reads)
    reads[rng.random((R, L)) < 0.002] = 4
    short = rng.random(R) < 0.1
    cut = rng.integers(L // 2, L, R)
    reads[short[:, None] & (np.arange(L)[None, :] >= cut[:, None])] = 4
    return refc, reads.astype(np.int32)


def _host_counts(refc, reads, W):
    out = np.zeros((refc.shape[0], W), np.int32)
    valid = reads < 4
    for t in range(reads.shape[1]):
        out += ((refc[:, t:t + W] == reads[:, t:t + 1])
                & valid[:, t:t + 1])
    return out


def rescue_count_mismatches(R: int, W: int, L: int, seed: int = 0,
                            device=None, host_lanes: int = 128) -> int:
    """window_match_counts vs exact integer counts; 0 = exact."""
    rng = np.random.default_rng(seed)
    refc, reads = _planted_window(rng, R, W, L)
    ctx = (jax.default_device(device) if device is not None
           else contextlib.nullcontext())
    with ctx:
        r_d, q_d = jnp.asarray(refc), jnp.asarray(reads)
        got = jax.jit(rescue_ops.window_match_counts)(r_d, q_d)

        def exact(refc, reads):
            valid = reads < 4

            def body(t, acc):
                win = jax.lax.dynamic_slice_in_dim(refc, t, W, axis=1)
                rt = jax.lax.dynamic_slice_in_dim(reads, t, 1, axis=1)
                vt = jax.lax.dynamic_slice_in_dim(valid, t, 1, axis=1)
                return acc + ((win == rt) & vt).astype(jnp.int32)
            return jax.lax.fori_loop(0, L, body,
                                     jnp.zeros((R, W), jnp.int32))
        ref_dev = jax.jit(exact)(r_d, q_d)
        bad = int(jnp.sum(got != ref_dev.astype(jnp.float32)))
        lanes = np.unique(np.linspace(0, R - 1, min(R, host_lanes))
                          .astype(np.int64))
        got_h = np.asarray(got[jnp.asarray(lanes)])
    ref_h = _host_counts(refc[lanes], reads[lanes], W)
    bad += int(np.sum(got_h != ref_h))
    if ref_h.max() < min(L, 256) * 0.9:
        bad += 1            # the planted diagonals must reach ~L
    return bad


def _pack_words(codes: np.ndarray) -> np.ndarray:
    n = len(codes)
    c = np.zeros(-(-n // 16) * 16, np.uint32)
    c[:n] = codes
    sh = (2 * np.arange(16, dtype=np.uint32))[None, :]
    return np.bitwise_or.reduce(c.reshape(-1, 16) << sh, axis=1)


def ref_chars_variants(n_words: int):
    """(branch, n_words', gate) for each ref_chars_block branch, sized as
    close to n_words as the branch allows; gate is the _ROW8_MAX_WORDS
    value that selects it."""
    g = rk._ROW8_MAX_WORDS
    up8 = -(-n_words // 8) * 8
    up128 = -(-n_words // 128) * 128
    slice8 = up8 if up8 % 128 else up8 + 8
    word = n_words if n_words % 8 else n_words + 1
    big = n_words > g
    return [("row128", up128, g if big else up128 - 1),
            ("row8", up8, max(g, up8)),
            ("slice8", slice8, g if big else slice8 - 1),
            ("word", word, g)]


def ref_chars_mismatches(n_text: int, n_lanes: int = 4096, C: int = 8,
                         L: int = 100, seed: int = 0, device=None) -> dict:
    """{branch: mismatching chars} of ref_chars_block vs per-char ref_char
    over a random text of n_text chars, for every branch at a word count
    of that text's size (starts include out-of-range diagonals)."""
    rng = np.random.default_rng(seed)
    base = _pack_words(rng.integers(0, 4, n_text).astype(np.uint8))
    starts = rng.integers(-L, n_text + L, (n_lanes, C)).astype(np.int32)
    starts[0, :4] = [0, -1, n_text - 1, n_text - L]
    out = {}
    ctx = (jax.default_device(device) if device is not None
           else contextlib.nullcontext())
    saved = rk._ROW8_MAX_WORDS
    try:
        for branch, nw, gate in ref_chars_variants(len(base)):
            rk._ROW8_MAX_WORDS = gate
            assert rk.ref_chars_branch(nw) == branch, (branch, nw, gate)
            words = np.zeros(nw, np.uint32)
            words[:len(base)] = base
            with ctx:
                w_d, s_d = jnp.asarray(words), jnp.asarray(starts)

                def both(w, s):
                    blk = rk.ref_chars_block(w, n_text, s, L)
                    pos = s[..., None] + jnp.arange(L, dtype=jnp.int32)
                    one = jnp.where((pos < 0) | (pos >= n_text), 4,
                                    rk.ref_char(w, jnp.clip(pos, 0,
                                                            n_text - 1)))
                    return jnp.sum(blk != one)
                out[branch] = int(jax.jit(both)(w_d, s_d))
    finally:
        rk._ROW8_MAX_WORDS = saved
    return out


def topk_tie_mismatches(device, seed: int = 0, R: int = 128,
                        W: int = 57344, N: int = 4096, C: int = 16) -> dict:
    """Index disagreements of lax.top_k between `device` and the CPU on
    tie-heavy inputs: rescue's [R, W] float32 match counts (top 8) and
    select_pairs' [N, C*C] int32 scores (top 4)."""
    rng = np.random.default_rng(seed)
    cpu = jax.devices("cpu")[0]
    cases = {
        "rescue": (rng.integers(0, 24, (R, W)).astype(np.float32), 8),
        "splice": (np.where(rng.random((N, C * C)) < 0.6, -(1 << 30),
                            rng.integers(-12, 0, (N, C * C)))
                   .astype(np.int32), 4),
    }
    out = {}
    for name, (x, k) in cases.items():
        idx = []
        for dev in (device, cpu):
            f = jax.jit(lambda a, k=k: jax.lax.top_k(a, k)[1])
            idx.append(np.asarray(f(jax.device_put(x, dev))))
        out[name] = int(np.sum(idx[0] != idx[1]))
    return out


def sharded_step_mismatches(al, reads, quals, lens, minsc, rdids, mesh):
    """Run parallel/mesh.sharded_align_step over `mesh` and the aligner's
    single-device step on the same batch; returns a list of the fields
    (and lanes) that differ — empty when they agree.  Slots of the packed
    single-device layout are compared as per-lane SETS of the valid slots
    (that layout reorders slots valid-first and leaves invalid payloads
    undefined); per-lane fields compare exactly."""
    from ..parallel import mesh as pmesh
    ss = al.splice_db.device_tables() if al.splice_db is not None else None
    single = al._fetch_out(
        al._device_step(al.dev, al.params, reads, quals, lens, minsc,
                        rdids, ss))
    step = pmesh.sharded_align_step(al, mesh)
    d = pmesh.replicate(mesh, al.dev)
    params = pmesh.replicate(mesh, al.params)
    ss_r = pmesh.replicate(mesh, ss)
    r, q, l, ms, ri = pmesh.shard_batch(mesh, reads, quals, lens, minsc,
                                        rdids)
    sharded, n_cand = step(d, params, r, q, l, ms, ri, ss_r)
    jax.block_until_ready(n_cand)
    bad = []
    n_dev = len(sharded["u_flags"].sharding.device_set)
    if n_dev != mesh.devices.size:
        bad.append(f"output spans {n_dev} of {mesh.devices.size} devices")
    sv = np.asarray(single["u_flags"]) & 1
    hv = np.asarray(sharded["u_flags"]) & 1
    if not np.array_equal(sv.sum(axis=1), hv.sum(axis=1)):
        bad.append("valid-count")
    slot_keys = [k for k in single
                 if k.startswith("u_") and single[k].ndim == 2
                 and single[k].shape[1] == sv.shape[1] and k != "u_alt"]
    for lane in range(sv.shape[0]):
        a = {tuple(int(np.asarray(single[k])[lane, j]) for k in slot_keys)
             for j in np.flatnonzero(sv[lane])}
        b = {tuple(int(np.asarray(sharded[k])[lane, j]) for k in slot_keys)
             for j in np.flatnonzero(hv[lane])}
        if a != b:
            bad.append(f"lane {lane} valid-slot set")
    for k in single:
        if k in slot_keys or k == "u_alt" or k.startswith("sp_"):
            continue
        sh = np.asarray(sharded[k])
        sg = np.asarray(single[k])
        if sh.shape != sg.shape:
            continue
        if sh.dtype.kind in "iu":
            # the packed single-device layout narrows integer fields
            sh2 = np.clip(sh, -32768, 32767)
            sh2 = np.where(sh2 == -32768, np.int32(-(2 ** 30)), sh2)
            if np.array_equal(sg, sh) or np.array_equal(sg, sh2) \
                    or np.array_equal(sg, np.clip(sh, -128, 127)):
                continue
        if not np.array_equal(sg, sh):
            bad.append(k)
    if int(np.asarray(n_cand)) != int(sv.sum()):
        bad.append("n_cand")
    return bad
