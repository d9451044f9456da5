"""The launch drivers, the tile registry and the public surface of the
PyTorch port against the JAX package's.

  * every driver's ``main(argv)`` (``serve_rs``, ``drift_rs`` with
    ``--ckpt-dir``, ``rescale_rs``, ``service_rs`` in interleaved mode,
    ``quickstart``) at ``--device cpu --backend scan`` and a small
    ``--events``, against JAX's ``main`` on the same argv: recall bits,
    drift flags, final states (factors within RTOL / ATOL 1e-5), front-end
    and report counters, checkpoint files byte for byte, the exported
    metrics JSON, and the printed lines with their wall-clock numbers
    masked;
  * the shared flags: ``--backend`` defaults to ``cuda``, ``--device`` to
    ``cuda``, ``parse_grid`` and ``stream_config`` as JAX's;
  * ``kernels.tiles``: ``best_tile`` on every key of the registry (and on
    ``"gpu"``, which falls back to the wildcard rows), ``record`` /
    ``reset``, and the JSON either package saves, loaded by the other;
  * the surface: ``repro_torch.__all__`` is ``repro.__all__`` plus
    ``recommend_topn`` (``Algorithm`` among them), and the serve and
    ensemble packages export JAX's names.
"""

import json
import os
import re
import sys

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro  # noqa: E402
import repro.ensemble  # noqa: E402
import repro.serve  # noqa: E402
import repro_torch  # noqa: E402
import repro_torch.ensemble  # noqa: E402
import repro_torch.serve  # noqa: E402
from repro.kernels import tiles as jtiles  # noqa: E402
from repro.launch import common as jcommon  # noqa: E402
from repro.launch import drift_rs as jdrift  # noqa: E402
from repro.launch import rescale_rs as jrescale  # noqa: E402
from repro.launch import serve_rs as jserve  # noqa: E402
from repro.launch import service_rs as jservice  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core.pipeline import restore_stream_checkpoint  # noqa: E402
from repro_torch.kernels import tiles as ttiles  # noqa: E402
from repro_torch.launch import common as tcommon  # noqa: E402
from repro_torch.launch import drift_rs as tdrift  # noqa: E402
from repro_torch.launch import quickstart as tquick  # noqa: E402
from repro_torch.launch import rescale_rs as trescale  # noqa: E402
from repro_torch.launch import serve_rs as tserve  # noqa: E402
from repro_torch.launch import service_rs as tservice  # noqa: E402
from tests.test_torch_ensemble import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-5
# Numbers a line prints from the wall clock.
_TIMED = re.compile(r"([\d,.]+ ?(ev/s|events/s|QPS|ms|s)\b|"
                    r"(QPS mean|p50|worst-burst|throughput)=[\d,.]+)")


def _nan_equal(a, b):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(a[~np.isnan(a)], b[~np.isnan(b)])


def _assert_states_match(t_states, j_states):
    want = convert.flatten_state(jax.tree.map(np.asarray, j_states))
    got = convert.states_to_numpy(t_states)
    assert got.keys() == want.keys()
    for name, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[name], w, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], w, err_msg=name)


def _assert_results_match(t, j):
    assert (t.events_processed, t.dropped, t.forgets) == (
        j.events_processed, j.dropped, j.forgets)
    _nan_equal(t.recall.bits(), j.recall.bits())
    if j.drift_flags is not None:
        np.testing.assert_array_equal(t.drift_flags, np.asarray(j.drift_flags))
    _assert_states_match(t.final_states, j.final_states)


def _lines(out: str, tmp_path) -> list[str]:
    out = out.replace(str(tmp_path), "<tmp>")
    return [_TIMED.sub("<t>", line) for line in out.splitlines()]


def _run_both(t_main, j_main, argv, capsys, tmp_path, t_extra=()):
    got = t_main([*argv, "--device", "cpu", *t_extra])
    t_out = _lines(capsys.readouterr().out, tmp_path)
    want = j_main(list(argv))
    j_out = _lines(capsys.readouterr().out, tmp_path)
    return got, want, t_out, j_out


def _files(directory):
    out = {}
    for root, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, directory)] = f.read()
    return out


@pytest.mark.parametrize("algorithm", ["disgd", "dics"])
def test_serve_rs_matches_jax(algorithm, capsys, tmp_path):
    argv = ["--backend", "scan", "--events", "2048", "--algorithm",
            algorithm, "--publish-every", "4", "--queries-per-publish", "64"]
    (t_res, t_fe), (j_res, j_fe), t_out, j_out = _run_both(
        tserve.main, jserve.main, argv, capsys, tmp_path)
    _assert_results_match(t_res, j_res)
    assert t_fe.stats_snapshot() == j_fe.stats_snapshot()
    assert t_out == j_out and t_out


def test_drift_rs_matches_jax(capsys, tmp_path):
    base = ["--backend", "scan", "--events", "16384"]
    t_ck, j_ck = str(tmp_path / "t"), str(tmp_path / "j")
    t_res = tdrift.main(base + ["--device", "cpu", "--ckpt-dir", t_ck,
                                "--metrics-json", str(tmp_path / "t.json")])
    t_out = _lines(capsys.readouterr().out.replace(t_ck, "<ck>").replace(
        "t.json", "<m>"), tmp_path)
    j_res = jdrift.main(base + ["--ckpt-dir", j_ck,
                                "--metrics-json", str(tmp_path / "j.json")])
    j_out = _lines(capsys.readouterr().out.replace(j_ck, "<ck>").replace(
        "j.json", "<m>"), tmp_path)
    _assert_results_match(t_res, j_res)
    assert t_res.drift_flags.sum() >= 1
    assert t_out == j_out
    assert _files(t_ck) == _files(j_ck)
    with open(tmp_path / "t.json") as f, open(tmp_path / "j.json") as g:
        assert json.load(f) == json.load(g)


def test_rescale_rs_matches_jax(capsys, tmp_path):
    argv = ["--backend", "scan", "--events", "4096", "--queries", "64"]
    t_ck, j_ck = str(tmp_path / "t"), str(tmp_path / "j")
    (t1, t2, t_fe) = trescale.main(argv + ["--device", "cpu",
                                           "--ckpt-dir", t_ck])
    t_out = _lines(capsys.readouterr().out.replace(t_ck, "<ck>"), tmp_path)
    (j1, j2, j_fe) = jrescale.main(argv + ["--ckpt-dir", j_ck])
    j_out = _lines(capsys.readouterr().out.replace(j_ck, "<ck>"), tmp_path)
    _assert_results_match(t1, j1)
    _assert_results_match(t2, j2)
    assert t2.final_states.user_vecs.shape[0] == 16
    assert t_fe.stats_snapshot() == j_fe.stats_snapshot()
    assert t_out == j_out
    # DISGD factors differ from JAX's in the last bits: the same files,
    # and each package restores the other's checkpoint as its own.
    assert _files(t_ck).keys() == _files(j_ck).keys()
    t_cfg = tcommon.stream_config(tcommon.base_parser("x").parse_args(
        ["--device", "cpu"]), grid=tcommon.parse_grid("4x4"))
    j_cfg = jcommon.stream_config(jcommon.base_parser("x").parse_args([]),
                                  grid=jcommon.parse_grid("4x4"))
    for ck in (t_ck, j_ck):
        a = restore_stream_checkpoint(ck, t_cfg).states
        b = jpipe.restore_stream_checkpoint(ck, j_cfg).states
        want = convert.flatten_state(jax.tree.map(np.asarray, b))
        for name, got in convert.states_to_numpy(a).items():
            np.testing.assert_array_equal(got, want[name], err_msg=name)


def test_service_rs_interleaved_matches_jax(capsys, tmp_path):
    argv = ["--backend", "scan", "--events", "4096", "--mode",
            "interleaved", "--query-batches", "12", "--publish-mode", "sync",
            "--publish-every", "4"]
    got, want, t_out, j_out = _run_both(tservice.main, jservice.main, argv,
                                        capsys, tmp_path)
    for a, b in zip(got.records, want.records):
        assert (a.staleness_events, a.snapshot_version, a.cache_hits,
                a.fallbacks) == (b.staleness_events, b.snapshot_version,
                                 b.cache_hits, b.fallbacks)
    assert len(got.records) == len(want.records) == 12
    gs, ws = got.summary(), want.summary()
    assert gs.keys() == ws.keys()
    for key in ("query_batches", "query_batches_under_load", "queries",
                "events_processed", "staleness_mean", "staleness_p95",
                "staleness_max"):
        assert gs[key] == ws[key], key
    assert len(t_out) == len(j_out)


def test_service_rs_threaded_runs(capsys):
    report = tservice.main(["--device", "cpu", "--backend", "scan",
                            "--events", "2048", "--query-batches", "8",
                            "--arrival", "closed"])
    out = capsys.readouterr().out
    assert report.events_processed == 2048
    assert "[service_rs]" in out and report.summary()["p99_ms"] > 0


def test_quickstart_matches_jax(capsys, tmp_path, monkeypatch):
    argv = ["--backend", "scan", "--events", "3000"]
    tquick.main(argv + ["--device", "cpu"])
    t_out = _lines(capsys.readouterr().out, tmp_path)
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import quickstart as jquick
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(sys, "argv", ["quickstart.py", *argv])
    jquick.main()
    j_out = _lines(capsys.readouterr().out, tmp_path)
    assert t_out == j_out and len(t_out) == 8


def test_shared_flags():
    ap = tcommon.base_parser("x")
    args = ap.parse_args([])
    assert (args.backend, args.device) == ("cuda", "cuda")
    for b in ("cuda", "pallas", "scan", "host"):
        assert ap.parse_args(["--backend", b]).backend == b
    assert tcommon.parse_grid("4x2").shape == jcommon.parse_grid("4x2").shape
    args = ap.parse_args(["--algorithm", "dics", "--u-cap", "96",
                          "--device", "cpu", "--backend", "scan"])
    jargs = jcommon.base_parser("x").parse_args(
        ["--algorithm", "dics", "--u-cap", "96", "--backend", "scan"])
    t, j = tcommon.stream_config(args), jcommon.stream_config(jargs)
    assert (t.algorithm, t.device, t.backend, t.micro_batch) == (
        "dics", "cpu", "scan", j.micro_batch)
    assert tuple(t.hyper) == tuple(j.hyper)
    np.testing.assert_array_equal(tcommon.demo_stream(500, 3)[0],
                                  jcommon.demo_stream(500, 3)[0])


# ---------------------------------------------------------------------------
# Tile registry
# ---------------------------------------------------------------------------


def _keys():
    ops = sorted({k[0] for k in jtiles.DEFAULTS} | {"nothing"})
    for op in ops:
        for algo in ("*", "disgd", "dics", "bpr", "other"):
            for backend in ("*", "scan", "pallas", "cuda", "host"):
                for platform in ("*", "cpu", "gpu", "tpu"):
                    yield op, algo, backend, platform


def test_tiles_best_tile_matches_jax_on_every_key():
    assert ttiles.DEFAULTS == jtiles.DEFAULTS
    assert not any(k[3] == "gpu" for k in ttiles.DEFAULTS)
    for key in _keys():
        assert ttiles.best_tile(*key) == jtiles.best_tile(*key), key
    assert ttiles.best_tile("engine", "disgd", "cuda", "gpu") == \
        ttiles.DEFAULTS[("engine", "*", "*", "*")]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tiles_json_crosses_packages(tmp_path, writer):
    rows = [("engine", "disgd", "scan", "gpu",
             {"micro_batch": 1024, "capacity_factor": 1.5}),
            ("serve", "dics", "*", "cpu", {"block_p": 64})]
    src, dst = (jtiles, ttiles) if writer == "jax" else (ttiles, jtiles)
    try:
        for row in rows:
            src.record(*row)
        src.save(tmp_path / "a.json")
        dst.load(tmp_path / "a.json")
        dst.save(tmp_path / "b.json")
        assert (tmp_path / "a.json").read_bytes() == \
            (tmp_path / "b.json").read_bytes()
        for key in _keys():
            assert ttiles.best_tile(*key) == jtiles.best_tile(*key), key
        assert ttiles.best_tile("engine", "disgd", "scan", "gpu") == rows[0][4]
    finally:
        ttiles.reset()
        jtiles.reset()
    assert ttiles.best_tile("engine", "disgd", "scan", "gpu") == \
        ttiles.DEFAULTS[("engine", "*", "*", "*")]


# ---------------------------------------------------------------------------
# Public surface
# ---------------------------------------------------------------------------


def test_public_surface_is_jax_plus_recommend_topn():
    assert len(set(repro_torch.__all__)) == len(repro_torch.__all__)
    assert set(repro_torch.__all__) == set(repro.__all__) | {"recommend_topn"}
    for name in repro_torch.__all__:
        assert getattr(repro_torch, name) is not None, name
    assert repro_torch.Algorithm is repro_torch.core.algorithm.Algorithm
    assert isinstance(repro_torch.get_algorithm("disgd"),
                      repro_torch.Algorithm)
    assert set(repro_torch.serve.__all__) == set(repro.serve.__all__)
    assert set(repro_torch.ensemble.__all__) == set(repro.ensemble.__all__)
