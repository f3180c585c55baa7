"""Device-side sequence -> k-mer window encoding.

The reference translates DNA to the AA-like alphabet with a rolling
3-frame conversion (Read.hpp:84-220 for identify, Read.hpp:1991-2139
for build); the set of emitted k-mers for a string S is exactly: one
window of ``3*highestK`` DNA characters at *every* start offset
``p in [0, len(S) - 3*highestK]``, translated triplet-wise
(frame == p % 3).

Here we vectorize that:

  1. ``aa[p] = LUT[hash(S[p], S[p+1], S[p+2])]`` for all p — one gather,
  2. window w, letter j  ->  ``aa[w + 3*j]`` — 12 (or 25) strided
     slices combined into int32 limbs via shifts/ors.

Everything is jit-compatible (static shapes from the padded buffer
length); XLA fuses the whole thing into a few elementwise kernels.

Protein input skips step 1 (letters are the bytes themselves,
reference Read.hpp:2256-2300) and uses letter stride 1.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import kmer
from .alphabet import build_codon_code_lut
from ._aas_table import AAS_TABLE, AAS_OOB_TAIL

BITS = kmer.BITS_PER_LETTER
LPL = kmer.LETTERS_PER_LIMB


def aas_code_lut() -> np.ndarray:
    """1024-entry LUT for the sloppy-mode pair reduction: index is
    (code1 << 5) | code2, value is the reduced 5-bit code.  Entries
    900..1023 reproduce the reference binary's out-of-bounds reads
    past its int8_t[900] table (see _aas_table.AAS_OOB_TAIL)."""
    lut = np.zeros(1024, dtype=np.int32)
    for i, ch in enumerate(AAS_TABLE):
        lut[i] = ord(ch) & 31
    for i, b in enumerate(AAS_OOB_TAIL):
        lut[900 + i] = b & 31
    return lut


@functools.partial(jax.jit, static_argnames=("protein",))
def dna_to_aa_codes(buf: jax.Array, lut: jax.Array, protein: bool = False) -> jax.Array:
    """uint8 char buffer -> int32 5-bit AA codes per position.

    For DNA, position p uses the triplet (p, p+1, p+2); the output has
    the same length as the input (the trailing 2 positions read padded
    garbage and must be masked by the caller via window validity).
    """
    b = buf.astype(jnp.int32)
    if protein:
        return b & 31
    c1 = b
    c2 = jnp.roll(b, -1)
    c3 = jnp.roll(b, -2)
    idx = ((c1 & 14) << 5) | ((c2 & 14) << 2) | ((c3 & 14) >> 1)
    return lut[idx]


@functools.partial(jax.jit, static_argnames=("highest_k", "letter_stride", "sloppy"))
def encode_windows(
    aa_codes: jax.Array,
    highest_k: int,
    letter_stride: int,
    sloppy: bool = False,
    aas_lut: jax.Array | None = None,
) -> jax.Array:
    """AA code array (N,) -> (W, L) int32 limb array of all windows.

    W = N - letter_stride*(highest_k-1) ... computed statically; window w
    takes letters at positions w, w+stride, ..., w+stride*(highest_k-1).
    """
    # a window spans letter_stride*highest_k input characters (for DNA the
    # last letter's triplet runs 3 chars past the last letter position)
    n = aa_codes.shape[0]
    w = n - letter_stride * highest_k + 1
    letters = kmer.limb_letters(highest_k)
    limbs = []
    pos = 0
    for nlet in letters:
        acc = jnp.zeros((w,), dtype=jnp.int32)
        for j in range(nlet):
            sl = jax.lax.dynamic_slice_in_dim(aa_codes, (pos + j) * letter_stride, w)
            acc = acc | (sl << (BITS * (LPL - 1 - j)))
        limbs.append(acc)
        pos += nlet
    out = jnp.stack(limbs, axis=-1)
    if sloppy:
        out = sloppy_reduce(out, aas_lut)
    return out


@jax.jit
def sloppy_reduce(limbs: jax.Array, aas_lut: jax.Array) -> jax.Array:
    """12-letter k-mers -> 6-letter reduced k-mers (reference
    aminoAcidsToAminoAcid, kASA.hpp:147-157): letter pairs (0,1),(2,3),...
    are joined via the 1024-entry pair table; result occupies the first
    6 letter positions (limb 0), limb 1 becomes 0."""
    out0 = jnp.zeros(limbs.shape[:-1], dtype=jnp.int32)
    for pair in range(6):
        posa, posb = 2 * pair, 2 * pair + 1
        ia, ja = divmod(posa, LPL)
        ib, jb = divmod(posb, LPL)
        ca = (limbs[..., ia] >> (BITS * (LPL - 1 - ja))) & 31
        cb = (limbs[..., ib] >> (BITS * (LPL - 1 - jb))) & 31
        red = aas_lut[(ca << 5) | cb]
        out0 = out0 | (red << (BITS * (LPL - 1 - pair)))
    return jnp.stack([out0, jnp.zeros_like(out0)], axis=-1)


def dna_to_aa_codes_np(buf: np.ndarray, lut: np.ndarray,
                       protein: bool = False) -> np.ndarray:
    """Host (numpy) twin of dna_to_aa_codes -- used by the exact-parity
    engine and the builders, where a device compile would dwarf the
    actual work."""
    b = buf.astype(np.int32)
    if protein:
        return b & 31
    c1 = b
    c2 = np.roll(b, -1)
    c3 = np.roll(b, -2)
    idx = ((c1 & 14) << 5) | ((c2 & 14) << 2) | ((c3 & 14) >> 1)
    return lut[idx]


def sloppy_reduce_np(limbs: np.ndarray, aas_lut: np.ndarray) -> np.ndarray:
    """Host twin of sloppy_reduce (12 letters -> 6 via the pair LUT)."""
    out0 = np.zeros(limbs.shape[:-1], dtype=np.int32)
    for pair in range(6):
        posa, posb = 2 * pair, 2 * pair + 1
        ia, ja = divmod(posa, LPL)
        ib, jb = divmod(posb, LPL)
        ca = (limbs[..., ia] >> (BITS * (LPL - 1 - ja))) & 31
        cb = (limbs[..., ib] >> (BITS * (LPL - 1 - jb))) & 31
        red = aas_lut[(ca << 5) | cb]
        out0 = out0 | (red << (BITS * (LPL - 1 - pair)))
    return np.stack([out0, np.zeros_like(out0)], axis=-1)


def encode_windows_np(aa_codes: np.ndarray, highest_k: int, letter_stride: int,
                      sloppy: bool = False, aas_lut: np.ndarray | None = None
                      ) -> np.ndarray:
    """Host twin of encode_windows."""
    # narrow integer codes (e.g. from a uint8 LUT) would wrap in the
    # limb shifts below -- numpy keeps the array dtype for `arr << int`
    aa_codes = np.asarray(aa_codes, dtype=np.int32)
    n = aa_codes.shape[0]
    w = n - letter_stride * highest_k + 1
    if w <= 0:
        return np.zeros((0, kmer.num_limbs(highest_k)), dtype=np.int32)
    letters = kmer.limb_letters(highest_k)
    limbs = []
    pos = 0
    for nlet in letters:
        acc = np.zeros((w,), dtype=np.int32)
        for j in range(nlet):
            start = (pos + j) * letter_stride
            acc = acc | (aa_codes[start:start + w] << (BITS * (LPL - 1 - j)))
        limbs.append(acc)
        pos += nlet
    out = np.stack(limbs, axis=-1)
    if sloppy:
        out = sloppy_reduce_np(out, aas_lut)
    return out


def custom_code_lut(cfg) -> np.ndarray | None:
    """-a <gc.prt> <id>: the (code-space) LUT for a custom codon table,
    or None when the default alphabet is in use (setCodonTable,
    kASA.hpp:579-615; CLI main.cpp:382)."""
    if not getattr(cfg, "codon_table", ""):
        return None
    from .alphabet import apply_custom_codon_table, build_codon_lut
    lut = apply_custom_codon_table(build_codon_lut(), cfg.codon_table,
                                   cfg.codon_id)
    return (lut & np.uint8(31)).astype(np.uint8)


def _bucket_size(n: int, minimum: int = 4096) -> int:
    """Static-shape bucketing: every jit compile is keyed on the buffer
    length, and a compile costs far more than the encode, so buffers are
    padded to the next power of two (>= minimum) before encoding and
    the caller slices the true window range back out."""
    size = minimum
    while size < n:
        size <<= 1
    return size


class Encoder:
    """Holds the (possibly customized) LUTs; `device=False` runs the
    encode on host numpy (same math), for paths where a fresh device
    compile would dominate (exact-parity engine, small builds)."""

    def __init__(self, codon_code_lut: np.ndarray | None = None,
                 sloppy: bool = False, device: bool = True):
        self._lut_np = np.asarray(
            codon_code_lut if codon_code_lut is not None else build_codon_code_lut(),
            dtype=np.int32)
        self.device = device
        self.codon_code_lut = jnp.asarray(self._lut_np) if device else None
        self.sloppy = sloppy
        self._aas_np = aas_code_lut() if sloppy else None
        self.aas_lut = jnp.asarray(self._aas_np) if (sloppy and device) else None

    def _pad(self, buf: np.ndarray) -> np.ndarray:
        size = _bucket_size(len(buf))
        if size == len(buf):
            return buf
        out = np.zeros(size, dtype=np.uint8)
        out[:len(buf)] = buf
        return out

    def encode_dna_buffer(self, buf: np.ndarray, highest_k: int,
                          reduce: bool | None = None):
        """Sanitized DNA byte buffer -> (W, L) limb windows (3-frame
        rolling); W = len(buf) - 3*highest_k + 1.

        `reduce=False` skips the sloppy pair reduction even on a sloppy
        encoder: the build path must scan for '_' on the UNREDUCED
        windows first (the reference marks invalid windows before the
        remap ever runs, Read.hpp:2015-2023 vs 2122-2131) and reduce
        afterwards via `reduce_windows`."""
        red = self.sloppy if reduce is None else reduce
        n_true = len(buf) - 3 * highest_k + 1
        if not self.device:
            aa = dna_to_aa_codes_np(buf, self._lut_np, protein=False)
            return encode_windows_np(aa, highest_k, 3, red, self._aas_np)
        aa = dna_to_aa_codes(jnp.asarray(self._pad(buf)), self.codon_code_lut,
                             protein=False)
        win = encode_windows(aa, highest_k, 3, red, self.aas_lut)
        return win[:max(n_true, 0)]

    def encode_protein_buffer(self, buf: np.ndarray, highest_k: int,
                              reduce: bool | None = None):
        red = self.sloppy if reduce is None else reduce
        n_true = len(buf) - highest_k + 1
        if not self.device:
            aa = dna_to_aa_codes_np(buf, self._lut_np, protein=True)
            return encode_windows_np(aa, highest_k, 1, red, self._aas_np)
        aa = dna_to_aa_codes(jnp.asarray(self._pad(buf)), self.codon_code_lut,
                             protein=True)
        win = encode_windows(aa, highest_k, 1, red, self.aas_lut)
        return win[:max(n_true, 0)]

    def reduce_windows(self, limbs: np.ndarray) -> np.ndarray:
        """Apply the sloppy pair reduction to already-encoded windows."""
        return sloppy_reduce_np(np.asarray(limbs), self._aas_np)
