"""Exact Kubernetes resource.Quantity arithmetic.

The reference relies on k8s.io/apimachinery's ``resource.Quantity`` — exact
decimal numbers with SI / binary suffixes — for every threshold comparison
(reference pkg/resourcelist/resourcelist.go:64-74 uses ``Quantity.Cmp``).
Throttling decisions are exact: ``100m`` CPU is 1/10, not 0.1000000001.

This module parses the full Quantity grammar and represents values as exact
``Fraction``s for host-side (oracle) arithmetic, plus a lossless conversion
to integer *milli-units* for the device tensor path (int64 milli covers
[1e-3, 9.2e15] — micro/nano-scale quantities are rejected at tensor-encode
time rather than silently rounded; see ``to_milli``).

Grammar (k8s apimachinery quantity.go):
    <quantity>   ::= <signedNumber><suffix>
    <suffix>     ::= <binarySI> | <decimalExponent> | <decimalSI>
    <binarySI>   ::= Ki | Mi | Gi | Ti | Pi | Ei
    <decimalSI>  ::= n | u | m | "" | k | M | G | T | P | E
    <decimalExponent> ::= "e"<signedNumber> | "E"<signedNumber>
"""

from __future__ import annotations

import re
from fractions import Fraction
from functools import lru_cache
from typing import Union

_BINARY_SUFFIXES = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}

_DECIMAL_SUFFIXES = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "": Fraction(1),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
}

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<int>[0-9]*)(?:\.(?P<frac>[0-9]*))?"
    r"(?P<suffix>Ki|Mi|Gi|Ti|Pi|Ei|[numkMGTPE]|[eE][+-]?[0-9]+)?$"
)


class QuantityParseError(ValueError):
    """Raised for strings that are not valid k8s quantities."""


@lru_cache(maxsize=65536)
def parse_quantity(s: Union[str, int, float]) -> Fraction:
    """Parse a k8s quantity string into an exact Fraction.

    Accepts ints/floats too (YAML often yields bare numbers for thresholds);
    floats go through ``str()`` so ``0.1`` means decimal 0.1.
    """
    if isinstance(s, Fraction):
        return s
    if isinstance(s, int):
        return Fraction(s)
    if isinstance(s, float):
        s = repr(s)
    if not isinstance(s, str):
        raise QuantityParseError(f"unsupported quantity type: {type(s)!r}")
    text = s.strip()
    if not text:
        raise QuantityParseError("empty quantity string")
    m = _QUANTITY_RE.match(text)
    if m is None:
        raise QuantityParseError(f"invalid quantity: {s!r}")
    int_part = m.group("int") or ""
    frac_part = m.group("frac")
    if not int_part and not frac_part:
        raise QuantityParseError(f"invalid quantity (no digits): {s!r}")

    mantissa = Fraction(int(int_part or "0"))
    if frac_part:
        mantissa += Fraction(int(frac_part), 10 ** len(frac_part))
    if m.group("sign") == "-":
        mantissa = -mantissa

    suffix = m.group("suffix") or ""
    if suffix in _BINARY_SUFFIXES:
        value = mantissa * _BINARY_SUFFIXES[suffix]
    elif suffix and suffix[0] in "eE" and len(suffix) > 1:
        value = mantissa * Fraction(10) ** int(suffix[1:])
    elif suffix in _DECIMAL_SUFFIXES:
        value = mantissa * _DECIMAL_SUFFIXES[suffix]
    else:  # pragma: no cover — regex should prevent this
        raise QuantityParseError(f"invalid suffix in quantity: {s!r}")
    return value


class SubMilliPrecisionError(ValueError):
    """A quantity cannot be represented in integer milli-units.

    The device tensor path stores quantities as int64 milli-units. Quantities
    with sub-milli precision (``n``/``u`` suffixes, or fractions like 1/3)
    cannot be encoded losslessly; rather than silently diverge from the exact
    host oracle, encoding raises this error.
    """


def to_milli(value: Fraction) -> int:
    """Losslessly convert an exact quantity to integer milli-units."""
    scaled = value * 1000
    if scaled.denominator != 1:
        raise SubMilliPrecisionError(
            f"quantity {value} has sub-milli precision; cannot encode exactly"
        )
    result = int(scaled)
    if not -(2**63) <= result < 2**63:
        raise SubMilliPrecisionError(f"quantity {value} overflows int64 milli-units")
    return result


@lru_cache(maxsize=65536)
def from_milli(milli: int) -> Fraction:
    """Milli-units → exact Fraction. Cached: the reconcile gather decodes
    the same small set of milli values (request sizes × throttle counts)
    thousands of times per second, and Fraction construction normalizes
    via gcd each call."""
    return Fraction(int(milli), 1000)


def format_quantity(value: Fraction) -> str:
    """Canonical-ish string form (integral → bare, milli-integral → ``m``).

    Not byte-identical to k8s canonicalization (which preserves the parsed
    suffix family); used only for human-readable status output and metrics
    labels, never for comparisons.
    """
    if value.denominator == 1:
        return str(value.numerator)
    m = value * 1000
    if m.denominator == 1:
        return f"{m.numerator}m"
    u = value * 10**6
    if u.denominator == 1:
        return f"{u.numerator}u"
    n = value * 10**9
    if n.denominator == 1:
        return f"{n.numerator}n"
    return str(float(value))


def cmp_quantity(a: Fraction, b: Fraction) -> int:
    """Three-way compare, mirroring ``Quantity.Cmp``."""
    if a < b:
        return -1
    if a > b:
        return 1
    return 0
