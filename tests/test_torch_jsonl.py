"""The port's crash-safe JSONL (``sparkdl_tpu_torch.utils.jsonl``) held
against the JAX package's on the same bytes, on the CPU.

Both readers get byte-identical files: a clean file, a torn last line (no
newline, and an unparsable final line), a corrupt middle line, an empty
and a missing file.  ``read_jsonl`` must return equal records and valid
byte counts (or both raise their corruption error), and ``recover_jsonl``
equal records and discarded counts, leaving byte-identical repaired
files.  The writers must write the same bytes and disable themselves the
same way.
"""

import os

import pytest

from sparkdl_tpu.utils import jsonl as jjsonl
from sparkdl_tpu_torch.utils import jsonl as pjsonl

CLEAN = b'{"a": 1}\n{"b": [1, 2]}\n\n{"c": {"d": null}}\n'
CASES = {
    "clean": CLEAN,
    "torn_no_newline": CLEAN + b'{"e": 5, "f"',
    "torn_unparsable_final_line": CLEAN + b'{"e": 5, "f\n',
    "corrupt_middle_line": b'{"a": 1}\n{"b": oops}\n{"c": 3}\n',
    "empty": b"",
}


def _pair(tmp_path, name, data):
    paths = []
    for side in ("jax", "port"):
        p = tmp_path / f"{side}_{name}.jsonl"
        p.write_bytes(data)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("case", sorted(CASES))
def test_read_jsonl_matches_jax(tmp_path, case):
    jp, pp = _pair(tmp_path, case, CASES[case])
    if case == "corrupt_middle_line":
        with pytest.raises(jjsonl.JsonlCorruptionError) as jerr:
            jjsonl.read_jsonl(jp)
        with pytest.raises(pjsonl.JsonlCorruptionError) as perr:
            pjsonl.read_jsonl(pp)
        assert isinstance(perr.value, ValueError)
        assert str(perr.value).replace(pp, "P") == \
            str(jerr.value).replace(jp, "P")
        return
    want = jjsonl.read_jsonl(jp)
    got = pjsonl.read_jsonl(pp)
    assert got == want
    if case.startswith("torn"):
        assert got[1] == len(CLEAN) and len(got[0]) == 3


@pytest.mark.parametrize("case", sorted(CASES))
def test_recover_jsonl_matches_jax_and_repairs_alike(tmp_path, case):
    jp, pp = _pair(tmp_path, case, CASES[case])
    if case == "corrupt_middle_line":
        with pytest.raises(jjsonl.JsonlCorruptionError):
            jjsonl.recover_jsonl(jp)
        with pytest.raises(pjsonl.JsonlCorruptionError):
            pjsonl.recover_jsonl(pp)
    else:
        assert pjsonl.recover_jsonl(pp) == jjsonl.recover_jsonl(jp)
        # recovery is idempotent: a second pass discards nothing
        assert pjsonl.recover_jsonl(pp)[1] == 0
    with open(jp, "rb") as f:
        want = f.read()
    with open(pp, "rb") as f:
        assert f.read() == want


def test_missing_file_reads_empty_like_jax(tmp_path):
    missing = str(tmp_path / "nope.jsonl")
    assert pjsonl.read_jsonl(missing) == jjsonl.read_jsonl(missing) \
        == ([], 0)
    assert pjsonl.recover_jsonl(missing) == jjsonl.recover_jsonl(missing)
    assert not os.path.exists(missing)


def test_writers_write_the_same_bytes(tmp_path):
    lines = ['{"seq": 1}', '{"seq": 2, "x": "y"}', "{}"]
    paths = {}
    for side, mod in (("jax", jjsonl), ("port", pjsonl)):
        path = str(tmp_path / side / "sub" / "out.jsonl")
        w = mod.CrashSafeJsonlWriter(path)
        assert all(w.write_line(line) for line in lines)
        w.reset()  # truncates: one run owns one artifact
        assert all(w.write_line(line) for line in lines[1:])
        w.close()
        w.close()  # idempotent
        paths[side] = path
    with open(paths["jax"], "rb") as f:
        want = f.read()
    with open(paths["port"], "rb") as f:
        assert f.read() == want
    assert pjsonl.read_jsonl(paths["port"])[0] == [{"seq": 2, "x": "y"}, {}]


def test_writer_disables_on_oserror_like_jax(tmp_path):
    """A path the writer cannot open (a directory) disables it instead of
    raising; ``reset`` on the same path stays disabled."""
    for mod in (jjsonl, pjsonl):
        w = mod.CrashSafeJsonlWriter(str(tmp_path))
        assert w.write_line("{}") is False and w.disabled
        w.reset()
        assert w.disabled and w.write_line("{}") is False
