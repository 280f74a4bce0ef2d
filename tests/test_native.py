"""Native (C++) CSV parser: correctness vs the Python fallback and the
reference load() semantics (tutorial/tutorial.go:234-272)."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
LIB = REPO / "native" / "libgogp_native.so"


@pytest.fixture(scope="module", autouse=True)
def built_lib():
    if not LIB.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            pytest.skip("g++ unavailable and native lib not built")
        subprocess.run(
            [gxx, "-O2", "-shared", "-fPIC", "-o", str(LIB),
             str(REPO / "native" / "csv_parser.cpp")],
            check=True,
        )
    yield


def test_parse_matches_python_loader():
    from gogp.tutorial.io import load_csv
    from gogp.utils.native import parse_csv

    text = "0.1,1.5\n0.2,-2.5\n0.3,0\n"
    a = parse_csv(text)
    x, y = load_csv(text)
    assert np.allclose(np.c_[x, y], a)


def test_reference_semantics():
    from gogp.utils.native import parse_csv

    # exponents, signs, leading '+', bare '.5' all parse (strconv.ParseFloat
    # compatibility); ragged rows and non-numeric fields error
    a = parse_csv("+1.5,2e3\n-1,.5\n")
    assert a.tolist() == [[1.5, 2000.0], [-1.0, 0.5]]
    assert parse_csv("").shape[0] == 0
    with pytest.raises(ValueError):
        parse_csv("1,2\n3\n")
    with pytest.raises(ValueError):
        parse_csv("1,abc\n")


def test_tutorial_loader_uses_native_when_built():
    from gogp.tutorial import io as tio
    from gogp.tutorial.hyperpriors import selfcheck_data

    x, y = tio.load_csv(selfcheck_data())
    assert x.shape[0] == y.shape[0] > 0
