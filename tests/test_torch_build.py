"""The kernel library's C interface as `ops/_build.py` loads it: every
entry point of `_SIGNATURES` is declared `extern "C"` in a
`bpt_tpu_torch/csrc/*.cu` source with as many parameters, and each
ctypes type is the one its C type passes as (a pointer as `c_void_p`,
`int` as `c_int`, `unsigned int` as `c_uint`, `long long` as
`c_longlong`).  A mismatch would show only on the card, as a crash or
garbage; here it is read from the sources, without nvcc."""
from __future__ import annotations

import ctypes
import re

import pytest

from bpt_tpu_torch.ops import _build

C_TYPES = {"int": ctypes.c_int, "unsigned int": ctypes.c_uint,
           "long long": ctypes.c_longlong}


def _declarations():
    """{entry point: [C type of each parameter]} of every `extern "C"`
    function of the sources, a pointer's type given as "pointer"."""
    out = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        src = path.read_text()
        for m in re.finditer(r'extern\s+"C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)',
                             src):
            params = []
            for p in m.group(2).split(","):
                p = " ".join(p.split())
                if "*" in p:
                    params.append("pointer")
                else:
                    words = [w for w in p.split() if w != "const"]
                    params.append(" ".join(words[:-1]))
            out[m.group(1)] = params
    return out


DECLARED = _declarations()


def test_the_parser_reads_a_declaration():
    assert DECLARED["bpt_cuda_error_string"] == ["int"]
    assert DECLARED["bpt_threefry"][4:6] == ["unsigned int", "long long"]


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signature_matches_the_c_declaration(name):
    assert name in DECLARED, f"no extern \"C\" {name} in csrc/*.cu"
    c_params = DECLARED[name]
    argtypes = _build._SIGNATURES[name]
    assert len(argtypes) == len(c_params)
    for i, (ct, c) in enumerate(zip(argtypes, c_params)):
        want = ctypes.c_void_p if c == "pointer" else C_TYPES[c]
        assert ct is want, f"{name} parameter {i}: {c} passed as {ct}"
