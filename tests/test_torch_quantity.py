"""Quantity parsing/arithmetic vs k8s resource.Quantity semantics."""

from fractions import Fraction

import pytest

from kube_throttler_tpu_torch.quantity import (
    QuantityParseError,
    SubMilliPrecisionError,
    cmp_quantity,
    format_quantity,
    from_milli,
    parse_quantity,
    to_milli,
)


@pytest.mark.parametrize(
    "s,expected",
    [
        ("0", Fraction(0)),
        ("1", Fraction(1)),
        ("100m", Fraction(1, 10)),
        ("200m", Fraction(1, 5)),
        ("1500m", Fraction(3, 2)),
        ("0.5", Fraction(1, 2)),
        ("1.5", Fraction(3, 2)),
        ("1Ki", Fraction(1024)),
        ("1Mi", Fraction(1024**2)),
        ("1Gi", Fraction(1024**3)),
        ("512Mi", Fraction(512 * 1024**2)),
        ("1.5Gi", Fraction(3 * 1024**3, 2)),
        ("1k", Fraction(1000)),
        ("1M", Fraction(10**6)),
        ("1G", Fraction(10**9)),
        ("1T", Fraction(10**12)),
        ("1P", Fraction(10**15)),
        ("1E", Fraction(10**18)),
        ("1u", Fraction(1, 10**6)),
        ("1n", Fraction(1, 10**9)),
        ("1e3", Fraction(1000)),
        ("1E3", Fraction(1000)),
        ("2e-2", Fraction(1, 50)),
        ("-100m", Fraction(-1, 10)),
        ("+2", Fraction(2)),
        (".5", Fraction(1, 2)),
        ("5.", Fraction(5)),
        (3, Fraction(3)),
        (0.25, Fraction(1, 4)),
    ],
)
def test_parse(s, expected):
    assert parse_quantity(s) == expected


@pytest.mark.parametrize("s", ["", "abc", "1Zi", "1mm", "--1", "1.2.3", "m", "Ki"])
def test_parse_errors(s):
    with pytest.raises(QuantityParseError):
        parse_quantity(s)


def test_cmp():
    assert cmp_quantity(parse_quantity("100m"), parse_quantity("0.1")) == 0
    assert cmp_quantity(parse_quantity("1Gi"), parse_quantity("1G")) == 1
    assert cmp_quantity(parse_quantity("999m"), parse_quantity("1")) == -1


def test_to_milli_exact():
    assert to_milli(parse_quantity("200m")) == 200
    assert to_milli(parse_quantity("1")) == 1000
    assert to_milli(parse_quantity("1Gi")) == 1024**3 * 1000
    assert from_milli(1500) == Fraction(3, 2)


def test_to_milli_submilli_rejected():
    with pytest.raises(SubMilliPrecisionError):
        to_milli(parse_quantity("1u"))
    with pytest.raises(SubMilliPrecisionError):
        to_milli(Fraction(1, 3))


def test_format_roundtrip():
    for s in ["0", "3", "200m", "1500m", "-100m"]:
        assert parse_quantity(format_quantity(parse_quantity(s))) == parse_quantity(s)
