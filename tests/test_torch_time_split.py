"""``tools/time_split.py`` finds the text of every cut variant of this
checkout's K1 / K4, K2, K3, K5, K6 and K7 designs, so an edit to a kernel source
that would drop a variant fails here, on the CPU, before a card run."""

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
    assert tool.scores_design(ROOT) == "strip"
    assert tool.dics_topn_design(ROOT) == "query_group"
    assert tool.fused_topn_design(ROOT) == "lane_lists"
    assert tool.isgd_design(ROOT) == "dataflow"
    assert tool.factor_design(ROOT) == "staged_pairwise"
    got = {(v, k) for v, k, _, _ in tool.variant_sources(ROOT)}
    assert got == {(v, k) for d in ("staged", "staged_pairwise", "wgmma",
                                    "strip", "query_group", "lane_lists",
                                    "dataflow")
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


@pytest.mark.parametrize("kernel,variant,text", [
    ("masked_scores", "scalar_mask", "aligned && i0 + kVec <= I"),
    ("masked_scores", "no_load_ahead", "constexpr int kBatch = 8;"),
    ("dics_topn", "runtime_lists", "for (int j = KCAP - 1; j > 0; --j)"),
    ("dics_topn", "no_empty_item", "if (n_hist[qb] > 0) {")])
def test_a_k2_or_k5_variant_whose_text_is_gone_stops_the_tool(
        tmp_path, kernel, variant, text):
    tool = _tool()
    csrc = tmp_path / tool.CSRC
    csrc.parent.mkdir(parents=True)
    shutil.copytree(ROOT / tool.CSRC, csrc)
    src = csrc / f"{kernel}.cu"
    src.write_text(src.read_text().replace(text, "x"))
    with pytest.raises(SystemExit, match=variant):
        tool.variant_sources(tmp_path, (kernel,))


@pytest.mark.parametrize("kernel,variants", [
    ("fused_topn", {"no_offers", "loads_only", "byte_mask", "no_empty_list",
                    "sync_stage", "group_4"}),
    ("isgd_update", {"stage_only", "one_warp"})])
def test_the_k3_and_k6_variants_edit_their_own_sources(kernel, variants):
    """Each K3 / K6 variant changes its kernel's source, and only that."""
    tool = _tool()
    got = tool.variant_sources(ROOT, (kernel,))
    assert {v for v, _, _, _ in got} == variants
    src = (ROOT / tool.CSRC / f"{kernel}.cu").read_text()
    for variant, k, file, text in got:
        assert (k, file) == (kernel, f"{kernel}.cu")
        assert text != src, variant


@pytest.mark.parametrize("kernel,variant,text", [
    ("fused_topn", "no_offers", "scores + warp * kSpan, pass_ids, N,"),
    ("fused_topn", "byte_mask", "I % 16 == 0 && (reinterpret_cast"),
    ("fused_topn", "group_4", "constexpr int kWarps = 8;"),
    ("isgd_update", "stage_only", "replay_chunk(c, K, eta, lam, links);"),
    ("isgd_update", "one_warp", "(unsigned)slot % kWarps")])
def test_a_k3_or_k6_variant_whose_text_is_gone_stops_the_tool(
        tmp_path, kernel, variant, text):
    tool = _tool()
    csrc = tmp_path / tool.CSRC
    csrc.parent.mkdir(parents=True)
    shutil.copytree(ROOT / tool.CSRC, csrc)
    src = csrc / f"{kernel}.cu"
    src.write_text(src.read_text().replace(text, "x"))
    with pytest.raises(SystemExit, match=variant):
        tool.variant_sources(tmp_path, (kernel,))


def test_the_earlier_k2_and_k5_designs_have_no_variants(tmp_path):
    """A checkout from before the K2 / K5 / K3 / K6 redesigns (one CTA per
    32 x 128 tile; one CTA per query; one warp per query row; one warp
    running the events in order) is timed as built, with no variant."""
    tool = _tool()
    csrc = tmp_path / tool.CSRC
    csrc.mkdir(parents=True)
    (csrc / "masked_scores.cu").write_text("constexpr int kItems = 128;\n")
    (csrc / "dics_topn.cu").write_text("constexpr int kMaxKnn = 32;\n")
    (csrc / "fused_topn.cu").write_text("constexpr int kTile = 128;\n")
    (csrc / "isgd_update.cu").write_text("isgd_step(u, i, eta, lam);\n")
    assert tool.scores_design(tmp_path) == "tiles"
    assert tool.dics_topn_design(tmp_path) == "per_query"
    assert tool.fused_topn_design(tmp_path) == "row_warps"
    assert tool.isgd_design(tmp_path) == "one_warp"
    assert tool.variant_sources(tmp_path, ("masked_scores", "dics_topn",
                                           "fused_topn", "isgd_update")) == []


def test_the_k1_variants_edit_the_staged_pairwise_sources():
    """This checkout's K1 takes the ``staged_pairwise`` variants, each an
    edit of its own source; a checkout whose pairwise mode is still the
    sequential body takes the ``staged`` ones."""
    tool = _tool()
    got = tool.variant_sources(ROOT, ("factor_update",))
    assert [v for v, _, _, _ in got] == [
        "no_column_clear", "no_rated_clears", "empty", "stage_only",
        "no_replay", "replay_only"]
    for variant, kernel, file, text in got:
        assert kernel == "factor_update"
        assert text != (ROOT / tool.CSRC / file).read_text(), variant


def test_a_checkout_with_the_sequential_pairwise_body_is_staged(tmp_path):
    tool = _tool()
    csrc = tmp_path / tool.CSRC
    csrc.parent.mkdir(parents=True)
    shutil.copytree(ROOT / tool.CSRC, csrc)
    src = csrc / "factor_update.cu"
    src.write_text(src.read_text().replace("analyse_negatives", "x"))
    assert tool.factor_design(tmp_path) == "staged"
    assert tool.kernel_design(tmp_path, "factor_update") == "staged"
    assert tool.kernel_design(ROOT, "factor_update") == "staged_pairwise"


@pytest.mark.parametrize("variant,text", [
    ("stage_only", "if (kPair && lead) analyse_negatives("),
    ("replay_only", "lead ? nt - 32 : nt);"),
    ("no_replay", "continue;  // uniform over the warp")])
def test_a_k1_variant_whose_text_is_gone_stops_the_tool(tmp_path, variant,
                                                         text):
    tool = _tool()
    csrc = tmp_path / tool.CSRC
    csrc.parent.mkdir(parents=True)
    shutil.copytree(ROOT / tool.CSRC, csrc)
    src = csrc / "factor_update.cu"
    body = src.read_text()
    # Keep the design detectable: only the variant's anchor goes.
    src.write_text(body.replace(text, "x") + "\n// analyse_negatives\n")
    with pytest.raises(SystemExit, match=variant):
        tool.variant_sources(tmp_path, ("factor_update",))
