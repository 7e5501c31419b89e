"""Kubernetes resource quantities as exact integers in milli-units."""

from __future__ import annotations

from fractions import Fraction
from functools import lru_cache

_SUFFIX = {
    "m": Fraction(1, 1000),
    "": Fraction(1),
    "k": Fraction(10**3), "M": Fraction(10**6), "G": Fraction(10**9),
    "T": Fraction(10**12), "P": Fraction(10**15), "E": Fraction(10**18),
    "Ki": Fraction(2**10), "Mi": Fraction(2**20), "Gi": Fraction(2**30),
    "Ti": Fraction(2**40), "Pi": Fraction(2**50), "Ei": Fraction(2**60),
}


@lru_cache(maxsize=4096)
def milli(q) -> int:
    """``q`` (``"250m"``, ``"1500M"``, ``"2Gi"``, ``4``) in milli-units.
    Raises ValueError unless the value is a whole number of milli-units."""
    s = str(q).strip()
    i = len(s)
    while i > 0 and s[i - 1].isalpha():
        i -= 1
    num, suffix = s[:i], s[i:]
    if suffix not in _SUFFIX or not num:
        raise ValueError(f"unsupported quantity {q!r}")
    value = Fraction(num) * _SUFFIX[suffix] * 1000
    if value.denominator != 1:
        raise ValueError(f"quantity {q!r} is not a whole number of milli-units")
    return int(value)
