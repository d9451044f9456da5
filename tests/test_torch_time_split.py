"""``tools/time_split.py`` finds the text of every cut variant of this
checkout's K1 / K4 and K7 designs, so an edit to a kernel source that
would drop a variant fails here, on the CPU, before a card run."""

import importlib.util
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "time_split", ROOT / "tools" / "time_split.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_cut_variant_of_this_checkout_finds_its_text():
    tool = _tool()
    assert tool.design(ROOT) == "staged"
    assert tool.swa_design(ROOT) == "wgmma"
    got = {(v, k) for v, k, _, _ in tool.variant_sources(ROOT)}
    assert got == {(v, k) for d in ("staged", "wgmma")
                   for v, k, _, _ in tool.VARIANTS[d]}
    only_k7 = tool.variant_sources(ROOT, ("swa_attention",))
    assert {v for v, _, _, _ in only_k7} == {
        "loads_only", "no_mask", "no_rescale", "no_softmax", "no_pv",
        "exp2f", "no_pingpong"}


def test_a_variant_whose_text_is_gone_stops_the_tool(tmp_path):
    tool = _tool()
    csrc = tmp_path / tool.CSRC
    csrc.parent.mkdir(parents=True)
    shutil.copytree(ROOT / tool.CSRC, csrc)
    src = csrc / "dics_update.cu"
    src.write_text(src.read_text().replace("cclr[b.li[e]] > e", "x"))
    with pytest.raises(SystemExit, match="no_co_adds"):
        tool.variant_sources(tmp_path)


def test_a_k7_variant_whose_text_is_gone_stops_the_tool(tmp_path):
    tool = _tool()
    csrc = tmp_path / tool.CSRC
    csrc.parent.mkdir(parents=True)
    shutil.copytree(ROOT / tool.CSRC, csrc)
    src = csrc / "swa_attention.cu"
    src.write_text(src.read_text().replace("rescale(o0, o1, alpha);", "x"))
    with pytest.raises(SystemExit, match="no_rescale"):
        tool.variant_sources(tmp_path, ("swa_attention",))
