"""k-mer limb representation.

The reference packs one k-mer (k <= highestK letters, 5 bits each,
first letter in the highest bits) into a uint64 (highestK=12) or a
software uint128 (highestK=25) — reference: kASA.hpp:333-411,
utils/uint128_t.hpp.  Prefix order == numeric order, so one sorted
array serves every k in [minK, maxK] by right-shifting
``5*(highestK-k)`` (Compare.hpp:865-874).

Device kernels work on 32-bit integer lanes, so we re-represent a k-mer
as ``L = ceil(highestK/6)`` *limbs* of up to 6 letters (30 bits) held
in int32:

    limb[i] = sum_j letter[6*i + j] << (25 - 5*j)

Lexicographic order over (limb[0], ..., limb[L-1]) equals the
reference's numeric order, every compare / sort / binary-search runs
on native int32 lanes, and limb[0] >> (30 - 5*min(k,6)) is exactly the
trie prefix.  Host-side conversion to/from the reference's uint64 /
uint128 layout lives here for artifact compatibility.
"""

from __future__ import annotations

import numpy as np

LETTERS_PER_LIMB = 6
BITS_PER_LETTER = 5


def num_limbs(highest_k: int) -> int:
    return -(-highest_k // LETTERS_PER_LIMB)


def limb_letters(highest_k: int) -> list[int]:
    """Letters held by each limb (last limb may hold fewer than 6)."""
    L = num_limbs(highest_k)
    out = []
    rem = highest_k
    for _ in range(L):
        out.append(min(LETTERS_PER_LIMB, rem))
        rem -= LETTERS_PER_LIMB
    return out


def prefix_masks(highest_k: int, k: int) -> np.ndarray:
    """int32 masks (one per limb) that keep only the first `k` letters."""
    L = num_limbs(highest_k)
    masks = np.zeros(L, dtype=np.int64)
    for i in range(L):
        m = min(max(k - LETTERS_PER_LIMB * i, 0), LETTERS_PER_LIMB)
        if m > 0:
            masks[i] = (((1 << (BITS_PER_LETTER * m)) - 1)
                        << (BITS_PER_LETTER * (LETTERS_PER_LIMB - m)))
    return masks.astype(np.int32)


def prefix_increment(highest_k: int, k: int) -> tuple[int, int]:
    """(limb_index, addend) such that adding `addend` to that limb of a
    k-prefix-masked key yields the smallest key strictly greater than
    every key sharing that k-prefix (carry must be propagated by the
    caller; see search.increment_prefix)."""
    i = (k - 1) // LETTERS_PER_LIMB
    m = k - LETTERS_PER_LIMB * i  # letters kept in limb i
    return i, 1 << (BITS_PER_LETTER * (LETTERS_PER_LIMB - m))


LIMB_MOD = 1 << (BITS_PER_LETTER * LETTERS_PER_LIMB)  # 2**30


def letter_at(limbs: np.ndarray, pos: int, highest_k: int):
    """5-bit code of letter `pos` (0-based from the left/high end).

    limbs: (..., L) int32 array.
    """
    i, j = divmod(pos, LETTERS_PER_LIMB)
    shift = BITS_PER_LETTER * (LETTERS_PER_LIMB - 1 - j)
    return (limbs[..., i] >> shift) & 31


# ---------------------------------------------------------------------------
# host-side conversions to the reference's packed integer layout


def limbs_to_u64(limbs: np.ndarray) -> np.ndarray:
    """(..., 2) int32 limbs -> uint64 in the reference's 60-bit layout."""
    hi = limbs[..., 0].astype(np.uint64)
    lo = limbs[..., 1].astype(np.uint64)
    return (hi << np.uint64(30)) | lo


def u64_to_limbs(vals: np.ndarray) -> np.ndarray:
    # strided struct-field views (e.g. rec["kmer"] of the 12-byte
    # packed index record) make the shifts ~10x slower; copy first
    vals = np.ascontiguousarray(vals, dtype=np.uint64)
    hi = (vals >> np.uint64(30)).astype(np.int32)
    lo = (vals & np.uint64((1 << 30) - 1)).astype(np.int32)
    return np.stack([hi, lo], axis=-1)


def limbs_to_u128_parts(limbs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(..., 5) int32 limbs (25 letters, 125 bits) -> (hi64, lo64) uint64 pair
    matching the reference's uint128 layout (letter 0 at bits 120..124)."""
    letters = limb_letters(25)
    acc_hi = np.zeros(limbs.shape[:-1], dtype=np.uint64)
    acc_lo = np.zeros(limbs.shape[:-1], dtype=np.uint64)
    bitpos = 125  # next free high bit (kmer occupies bits 0..124)
    for i, nlet in enumerate(letters):
        width = BITS_PER_LETTER * nlet
        val = (limbs[..., i].astype(np.uint64) >>
               np.uint64(BITS_PER_LETTER * (LETTERS_PER_LIMB - nlet)))
        bitpos -= width
        if bitpos >= 64:
            acc_hi |= val << np.uint64(bitpos - 64)
        elif bitpos + width <= 64:
            acc_lo |= val << np.uint64(bitpos)
        else:  # straddles the 64-bit boundary
            acc_hi |= val >> np.uint64(64 - bitpos)
            acc_lo |= (val << np.uint64(bitpos)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return acc_hi, acc_lo


def u128_parts_to_limbs(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    hi = np.asarray(hi, dtype=np.uint64)
    lo = np.asarray(lo, dtype=np.uint64)
    letters = limb_letters(25)
    out = np.zeros(hi.shape + (len(letters),), dtype=np.int32)
    bitpos = 125
    for i, nlet in enumerate(letters):
        width = BITS_PER_LETTER * nlet
        bitpos -= width
        if bitpos >= 64:
            val = (hi >> np.uint64(bitpos - 64)) & np.uint64((1 << width) - 1)
        elif bitpos + width <= 64:
            val = (lo >> np.uint64(bitpos)) & np.uint64((1 << width) - 1)
        else:
            low_part = lo >> np.uint64(bitpos)
            high_part = hi << np.uint64(64 - bitpos)
            val = (low_part | high_part) & np.uint64((1 << width) - 1)
        out[..., i] = (val << np.uint64(BITS_PER_LETTER * (LETTERS_PER_LIMB - nlet))).astype(np.int32)
    return out


def limbs_to_string(limbs: np.ndarray, highest_k: int) -> str:
    """Debug helper: limb row -> AA letter string (kASA.hpp:383-396)."""
    out = []
    for pos in range(highest_k):
        code = int(letter_at(np.asarray(limbs), pos, highest_k))
        out.append(chr(code | 64))
    return "".join(out)


def string_to_limbs(s: str, highest_k: int) -> np.ndarray:
    L = num_limbs(highest_k)
    limbs = np.zeros(L, dtype=np.int32)
    for pos, ch in enumerate(s[:highest_k]):
        code = ord(ch) & 31
        i, j = divmod(pos, LETTERS_PER_LIMB)
        limbs[i] |= code << (BITS_PER_LETTER * (LETTERS_PER_LIMB - 1 - j))
    return limbs
