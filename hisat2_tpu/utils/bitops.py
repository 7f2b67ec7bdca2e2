"""2-bit DNA packing and popcount-based rank primitives.

The reference implementation counts characters inside a cache-line "side" with
a popcount LUT (`countBt2Side`, gfm.h:2557-2625).  The equivalent here
keeps the same two-level idea — absolute counts sampled per block + a masked
popcount within the block — but expresses the in-block count as vectorized
uint32 bit-math over lanes so whole batches of rank queries run per
instruction.

Packing convention (host + device agree):
  base index k lives in word k >> 4, bits [2*(k & 15), 2*(k & 15) + 1].
  A=0 C=1 G=2 T=3; N and '$' are not representable in packed words — callers
  track them separately (fragment tables / zrow).
"""

from __future__ import annotations

import numpy as np

# Base codes.  Matches the reference alphabet (/root/reference/alphabet.cpp
# asc2dna) for ACGT; 4 = N/ambiguous.
A, C, G, T, N = 0, 1, 2, 3, 4

BASES_PER_WORD = 16
WORD_BITS = 32

_ASCII2CODE = np.full(256, N, dtype=np.uint8)
for i, ch in enumerate("ACGT"):
    _ASCII2CODE[ord(ch)] = i
    _ASCII2CODE[ord(ch.lower())] = i
# IUPAC ambiguity codes all map to N (reference maps them to a random base at
# index build; we treat them as N and exclude from fragments).
CODE2ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode_dna(seq: bytes | str) -> np.ndarray:
    """ASCII DNA -> uint8 codes (0-3, 4 for N/other)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _ASCII2CODE[np.frombuffer(seq, dtype=np.uint8)]


def decode_dna(codes: np.ndarray) -> str:
    return CODE2ASCII[np.minimum(codes, 4)].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement on code arrays (N stays N)."""
    comp = np.where(codes < 4, 3 - codes, codes)
    return comp[::-1].copy()


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack base codes (values 0-3; callers must pre-substitute N) into
    uint32 words, 16 bases per word, low bits first.  Chunked: the naive
    [nwords, 16] uint32 intermediate is 64 bytes per base (a >100 GB
    temporary at genome scale)."""
    n = len(codes)
    nwords = (n + BASES_PER_WORD - 1) // BASES_PER_WORD
    out = np.empty(nwords, dtype=np.uint32)
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, :]
    CH = 1 << 22                      # words per chunk (64 Mbases)
    for w0 in range(0, nwords, CH):
        w1 = min(nwords, w0 + CH)
        lo, hi = w0 * BASES_PER_WORD, min(n, w1 * BASES_PER_WORD)
        blk = np.zeros((w1 - w0) * BASES_PER_WORD, dtype=np.uint32)
        blk[:hi - lo] = codes[lo:hi]
        blk &= 3
        out[w0:w1] = (blk.reshape(-1, BASES_PER_WORD) << shifts).sum(
            axis=1, dtype=np.uint32)
    return out


def unpack_2bit(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_2bit -> uint8 codes of length n.  Chunked: the
    naive [nwords, 16] uint32 intermediate is 64 bytes per base (a
    12.5 GB temporary for a 3 Gbp genome)."""
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, :]
    out = np.empty(len(words) * BASES_PER_WORD, np.uint8)
    CH = 1 << 22
    for w0 in range(0, len(words), CH):
        blk = words[w0:w0 + CH]
        out[w0 * BASES_PER_WORD:(w0 + len(blk)) * BASES_PER_WORD] = \
            ((blk[:, None] >> shifts) & 3).astype(np.uint8).reshape(-1)
    return out[:n]


def pack_4bit(codes: np.ndarray) -> np.ndarray:
    """Pack 4-bit symbols (0-15) into uint32 words, 8 per word
    (the bigram-BWT plane; ops/rank.rank2).  Chunked like pack_2bit."""
    n = len(codes)
    nwords = (n + 7) // 8
    out = np.empty(nwords, dtype=np.uint32)
    sh = (np.arange(8, dtype=np.uint32) * 4)[None, :]
    CH = 1 << 23                      # words per chunk (64 M symbols)
    for w0 in range(0, nwords, CH):
        w1 = min(nwords, w0 + CH)
        lo, hi = w0 * 8, min(n, w1 * 8)
        blk = np.zeros((w1 - w0) * 8, dtype=np.uint32)
        blk[:hi - lo] = codes[lo:hi]
        out[w0:w1] = (blk.reshape(-1, 8) << sh).sum(axis=1, dtype=np.uint32)
    return out
