"""The port's NFC / NFKC / NFD / NFKD against HF ``tokenizers``, one code
point at a time over all of Unicode (surrogates aside).

Python's ``unicodedata`` tables (Unicode 15.0.0 on Python 3.12) map code
points that HF's older tables leave as they are; ``tokenizer_json`` keeps
those (``HF_KEEPS``), so every code point normalizes as HF's does. Skips
where ``tokenizers`` is not installed.

    python3 -m tests.test_torch_unicode_forms

prints ``HF_KEEPS`` anew from this sweep (run it when Python's or
``tokenizers``' Unicode tables change).
"""

import sys
import unicodedata

import pytest

from dynamo_tpu_torch.tokenizer_json import hf_normalize

FORMS = ("NFC", "NFKC", "NFD", "NFKD")


def _code_points():
    return (cp for cp in range(0x110000) if not 0xD800 <= cp <= 0xDFFF)


@pytest.mark.parametrize("form", FORMS)
def test_every_code_point_normalizes_like_hf(form):
    normalizers = pytest.importorskip("tokenizers.normalizers")
    ref = getattr(normalizers, form)()
    bad = [f"U+{cp:04X}" for cp in _code_points()
           if hf_normalize(form, chr(cp)) != ref.normalize_str(chr(cp))]
    assert not bad, bad[:20]


def hf_gaps(form: str) -> list[tuple[int, int]]:
    """The code points ``unicodedata`` maps under ``form`` and HF leaves as
    they are, as inclusive ranges (raises for one HF maps otherwise)."""
    from tokenizers import normalizers

    norm = getattr(normalizers, form)()
    ranges: list[list[int]] = []
    for cp in _code_points():
        c = chr(cp)
        hf = norm.normalize_str(c)
        if unicodedata.normalize(form, c) == hf:
            continue
        if hf != c:
            raise SystemExit(f"U+{cp:04X}: HF maps it under {form}; a table of kept code "
                             "points cannot say so")
        if ranges and ranges[-1][1] + 1 == cp:
            ranges[-1][1] = cp
        else:
            ranges.append([cp, cp])
    return [(a, b) for a, b in ranges]


if __name__ == "__main__":
    import tokenizers

    print(f"# Python {sys.version.split()[0]} (Unicode {unicodedata.unidata_version}), "
          f"tokenizers {tokenizers.__version__}")
    for form in FORMS:
        rs = hf_gaps(form)
        body = ", ".join(f"(0x{a:04X}, 0x{b:04X})" for a, b in rs)
        print(f'"{form}": ({body}{"," if len(rs) == 1 else ""}),  '
              f"# {sum(b - a + 1 for a, b in rs)} code points")
