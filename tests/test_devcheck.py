"""Component checks (hisat2_tpu/utils/devcheck.py): small shapes here on
the CPU, real widths on a GPU (the ``gpu`` marker; chip_smoke.py phase
(f) runs the same checks)."""

import pytest

from hisat2_tpu.ops import rank as rk
from hisat2_tpu.utils import devcheck as dc

FLY_BP = 137_547_960          # dm6's seven sequences (tools/flyshape.py)


@pytest.mark.parametrize("L", [100, 256])
def test_rescue_counts_exact(L):
    """bf16 grouped-conv match counts equal integer counts up to 256."""
    assert dc.rescue_count_mismatches(48, 1536, L, seed=L) == 0


@pytest.mark.parametrize("branch", ["row128", "row8", "slice8", "word"])
def test_ref_chars_branch_vs_ref_char(branch):
    """Each ref_chars_block branch, forced on a small text by moving the
    _ROW8_MAX_WORDS gate, equals per-char ref_char (OOB starts too)."""
    n_text = 128 * 16 * 21 + 7
    names = [b for b, _, _ in dc.ref_chars_variants((n_text + 15) // 16)]
    assert names == ["row128", "row8", "slice8", "word"]
    res = dc.ref_chars_mismatches(n_text, n_lanes=96, C=4, L=100,
                                  seed=len(branch))
    assert res[branch] == 0
    assert rk._ROW8_MAX_WORDS == 8 << 20        # gate restored


def test_ref_chars_variants_fly_scale():
    """At the fly-shape genome's size the default gate already sends the
    128-padded operand down the 128-word-row branch."""
    nw = -(-FLY_BP // 16)
    for branch, n_words, gate in dc.ref_chars_variants(nw):
        assert n_words >= nw
        if branch == "row128":
            assert gate == rk._ROW8_MAX_WORDS
        old = rk._ROW8_MAX_WORDS
        try:
            rk._ROW8_MAX_WORDS = gate
            assert rk.ref_chars_branch(n_words) == branch
        finally:
            rk._ROW8_MAX_WORDS = old


@pytest.mark.gpu
@pytest.mark.parametrize("L", [100, 256])
def test_rescue_counts_real_width_gpu(gpu_device, L):
    assert dc.rescue_count_mismatches(4096, 57344, L, seed=L,
                                      device=gpu_device) == 0


@pytest.mark.gpu
def test_ref_chars_fly_scale_gpu(gpu_device):
    res = dc.ref_chars_mismatches(FLY_BP, device=gpu_device)
    assert not any(res.values()), res


@pytest.mark.gpu
def test_topk_tie_order_gpu(gpu_device, cpu_backend):
    res = dc.topk_tie_mismatches(gpu_device)
    assert not any(res.values()), res
