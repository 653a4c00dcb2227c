"""Life-like CA rule system (counterpart of carle_tpu/rules.py).

Rules are *data*: an 18-bit integer bitmask carried inside the environment
state, so every kernel runs any ruleset, one per batch or one per universe.

Bit layout (see :func:`pack_rule_bits`):

    bit n        (0 <= n <= 8)  -> a dead cell with n live neighbours is born
    bit (9 + n)  (0 <= n <= 8)  -> a live cell with n live neighbours survives

The CA update then reduces to a single shift:  ``(bits >> (count + 9*alive)) & 1``.

String parsing matches the reference's tolerant semantics
(env.py:62-85, tested in reference tests/test_env.py:17-39): any character
outside '0'..'8' is ignored, duplicates collapse, result is sorted.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

_ALLOWED = set("012345678")


def parse_digits(text: str) -> List[int]:
    """Extract the sorted, de-duplicated set of rule digits from ``text``.

    Equivalent to the reference's ``birth_rule_from_string`` /
    ``survive_rule_from_string`` filtering (env.py:62-78): every character in
    '0'..'8' counts, everything else (including '9') is ignored.
    """
    return sorted({int(ch) for ch in text if ch in _ALLOWED})


def parse_rulestring(rulestring: str) -> Tuple[List[int], List[int]]:
    """Parse a 'B3/S23'-style rulestring into (birth, survive) digit lists.

    Mirrors env.py:80-85: split on '/', first part is birth, second survive.
    """
    parts = rulestring.split("/")
    if len(parts) < 2:
        raise ValueError(f"rulestring must contain '/': {rulestring!r}")
    return parse_digits(parts[0]), parse_digits(parts[1])


def rulestring(birth: Sequence[int], survive: Sequence[int]) -> str:
    """Format digit lists back into canonical 'B…/S…' form."""
    return "B" + "".join(str(d) for d in sorted(set(birth))) + "/S" + "".join(
        str(d) for d in sorted(set(survive))
    )


def digits_to_bits(digits: Iterable[int]) -> int:
    """Pack a digit list into a 9-bit mask."""
    bits = 0
    for d in digits:
        if not 0 <= d <= 8:
            raise ValueError(f"rule digit out of range: {d}")
        bits |= 1 << d
    return bits


def bits_to_digits(bits: int) -> List[int]:
    return [d for d in range(9) if (bits >> d) & 1]


def pack_rule_bits(birth: Sequence[int], survive: Sequence[int]) -> int:
    """Pack (birth, survive) digit lists into the 18-bit combined rule mask."""
    return digits_to_bits(birth) | (digits_to_bits(survive) << 9)


def unpack_rule_bits(bits: int) -> Tuple[List[int], List[int]]:
    return bits_to_digits(bits & 0x1FF), bits_to_digits((bits >> 9) & 0x1FF)


def rule_bits_from_string(text: str) -> int:
    birth, survive = parse_rulestring(text)
    return pack_rule_bits(birth, survive)


# Canonical named rulesets of the reference's training and evaluation scripts.
LIFE = pack_rule_bits([3], [2, 3])                      # B3/S23
MORLEY = pack_rule_bits([3, 6, 8], [2, 4, 5])           # Move/Morley (train_mcl.py:96)
DAY_AND_NIGHT = pack_rule_bits([3, 6, 7, 8], [3, 4, 6, 7, 8])  # train_mcl.py:97
LIVE_FREE_OR_DIE = pack_rule_bits([2], [0])             # eval.py:94 outgroup
