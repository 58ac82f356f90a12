"""The variant files of tools/kernel_variants.py still apply to the kernel
sources: every source they name is one of the port's kernels and every
text edit finds its text, so a variant measured once can be measured again
on a later tree."""
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
SPECS = sorted((ROOT / "tools" / "variants").glob("*.json"))
VARIANTS = [(spec, v) for spec in SPECS for v in json.loads(spec.read_text())]


@pytest.mark.parametrize("spec,variant", VARIANTS,
                         ids=[f"{s.stem}-{v[0]}" for s, v in VARIANTS])
def test_variant_edits_apply(spec, variant):
    name, source, edits, check, *settings = variant
    assert (CSRC / f"{source}.cu").exists(), f"{name}: no csrc/{source}.cu"
    assert isinstance(check, bool)
    # wrapper constants set for the variant's run, each one the wrapper has
    assert len(settings) <= 1
    for key in (settings[0] if settings else {}):
        wrapper = (CSRC.parent / f"{source}.py").read_text()
        assert f"\n{key} = " in wrapper, f"{name}: no {key} in {source}.py"
    if isinstance(edits, str):      # another version of csrc/, built as is
        return
    for old, new, *where in edits:  # the source, or a named header
        text = (CSRC / (where[0] if where else f"{source}.cu")).read_text()
        assert old in text, f"{spec.name} {name}: {old[:60]!r} not found"
        assert old != new


def test_variant_names_unique():
    names = [v[0] for _, v in VARIANTS]
    assert len(names) == len(set(names))
