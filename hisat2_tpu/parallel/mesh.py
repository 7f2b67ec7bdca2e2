"""Multi-chip execution: shard the read stream over a device mesh.

The reference scales with pthreads pulling reads from a mutex-guarded cursor
(hisat2.cpp:3533-3570, pat.h:163-241).  The replacement here is SPMD:
the FM index is REPLICATED on every device (it is
read-only, like the reference's shared index image — shmem.h:73-110), read
batches are SHARDED over the 'dp' mesh axis, and per-batch summary counters
merge with a psum instead of the reference's MERGE_METRICS mutex
(hisat2.cpp:3223-3238).  Novel-splice-site tables merge the same way per
batch (replacing SpliceSiteDB's per-chromosome mutexes, splice_site.h:603)
— batch-synchronous merging is also what makes multi-chip runs
deterministic, the property the reference approximates with its read-id
throttling protocol (hisat2.cpp:3180-3203).

A second mesh axis 'mp' is reserved for sharding the local-index hierarchy
(HGFM windows) when one device's memory cannot hold the full index; with
the packed layout a human SNP graph index fits one 80 GB H100, so 'mp'
defaults to 1 — the same replicate-first stance the reference takes with
shmem.  GPUs of one host are joined all to all, so the mesh is a plain
device list in jax.devices() order, one device per 'dp' slot.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_dp: int = None, n_mp: int = 1) -> Mesh:
    """Data-parallel mesh over available devices (dp x mp)."""
    devs = np.array(jax.devices())
    if n_dp is None:
        n_dp = len(devs) // n_mp
    devs = devs[: n_dp * n_mp].reshape(n_dp, n_mp)
    return Mesh(devs, ("dp", "mp"))


def shard_batch(mesh: Mesh, *arrays):
    """Place host batch arrays sharded over 'dp' (leading axis)."""
    out = []
    for a in arrays:
        spec = P("dp", *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)


def replicate(mesh: Mesh, tree):
    """Replicate an array pytree (the index) across the mesh."""
    return jax.device_put(
        tree, NamedSharding(mesh, P()))


def sharded_align_step(aligner, mesh: Mesh):
    """Build a pjit'd alignment step: index replicated, reads sharded on
    'dp', outputs sharded on 'dp'; summary counters all-reduced.

    Returns fn(dev_index, params, reads, quals, lens, minsc) ->
    (candidate dict, n_cand) with n_cand summed over the mesh (the psum
    replaces MERGE_METRICS)."""

    def step(d, params, reads, quals, lens, minsc, rdids, ss):
        out = aligner._align_device(d, params, reads, quals, lens, minsc,
                                    rdids, ss)
        # valid = bit 0 of the packed flags byte (pipeline D2H shrink)
        n_cand = (out["u_flags"] & 1).sum()  # XLA inserts the x-shard reduce
        return out, n_cand

    repl = NamedSharding(mesh, P())
    dp = NamedSharding(mesh, P("dp"))
    params_spec = jax.tree.map(lambda _: repl, aligner.params)
    ss_tables = (aligner.splice_db.device_tables()
                 if aligner.splice_db is not None else None)
    ss_spec = jax.tree.map(lambda _: repl, ss_tables)
    nd = 8
    out_spec = jax.eval_shape(
        step, aligner.dev, aligner.params,
        jax.ShapeDtypeStruct((nd, 32), "int32"),
        jax.ShapeDtypeStruct((nd, 32), "int32"),
        jax.ShapeDtypeStruct((nd,), "int32"),
        jax.ShapeDtypeStruct((nd,), "int32"),
        jax.ShapeDtypeStruct((nd,), "int32"),
        ss_tables)
    return jax.jit(
        step,
        in_shardings=(jax.tree.map(lambda _: repl, aligner.dev),
                      params_spec, dp, dp, dp, dp, dp, ss_spec),
        out_shardings=(jax.tree.map(lambda _: dp, out_spec[0]), repl))
