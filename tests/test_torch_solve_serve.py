"""The serving CLI: ``repro_torch.launch.solve_serve`` against
``repro.launch.solve_serve``.

Both ``main()`` run in this process (patched ``sys.argv``, captured
stdout) on the CPU (``--device cpu`` for the port), MMAS, four requests of
12-28 cities, five iterations, ``--max-batch 2``, in four modes: drain,
``--use-pallas`` (the reference's Pallas kernels in interpret mode),
``--sparse --sparse-k 8`` and ``--stream --arrival-rate 20 --chunk 2``.
Per request the id, n, bucket, best length, iterations and gap are equal,
and so are the report's, the stats' and the rows' keys.  The flags the
port refuses exit 2 with one line on stderr; the telemetry exports pass
``obs.validate``.  The program cache's flags: ``--warmup --dry`` reports
the warmed ladder as the reference does; a warmed drain and a streamed
replay warmed in the background equal the reference's plain runs per
request, every dispatch a hit.
"""
import json
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.launch import solve_serve as jserve  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.launch import solve_serve as tserve  # noqa: E402

BASE = ["--variant", "mmas", "--num-instances", "4", "--min-n", "12",
        "--max-n", "28", "--iterations", "5", "--max-batch", "2"]
MODES = {
    "drain": [],
    "pallas": ["--use-pallas"],
    "sparse": ["--sparse", "--sparse-k", "8"],
    "stream": ["--stream", "--arrival-rate", "20", "--chunk", "2"],
}


def _run(main, argv, capsys, monkeypatch) -> dict:
    monkeypatch.setattr(sys, "argv", ["solve_serve"] + argv)
    main()
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_reports_equal_the_reference_per_request(mode, capsys, monkeypatch):
    want = _run(jserve.main, BASE + MODES[mode], capsys, monkeypatch)
    got = _run(tserve.main, BASE + MODES[mode] + ["--device", "cpu"],
               capsys, monkeypatch)
    assert got["schema"] == want["schema"] == "repro.solve_serve/v1"
    assert set(got) == set(want)
    assert set(got["stats"]) == set(want["stats"])
    assert len(got["results"]) == len(want["results"]) == 4
    for g, w in zip(got["results"], want["results"]):
        assert set(g) == set(w)
        for f in ("id", "name", "n", "bucket", "best_len", "iterations",
                  "gap_pct"):
            assert g[f] == w[f], (mode, f, g[f], w[f])
    assert got["mean_gap_pct"] == want["mean_gap_pct"]
    if mode == "stream":
        assert got["stats"]["completed"] == got["stats"]["submitted"] == 4
    else:
        assert got["stats"]["requests"] == 4


@pytest.mark.parametrize("argv,needle", [
    (["--stream", "--use-pallas", "--per-instance-hyper"], "Hyper"),
    (["--sparse", "--shard"], "mesh sharding"),
    (["--sparse", "--shard", "--devices", "2"], "mesh sharding"),
    (["--warmup", "--sparse", "--shard"], "mesh sharding"),
    (["--warmup", "--dry", "--sparse", "--stream"], "streaming pool"),
    (["--sparse", "--stream"], "streaming pool"),
])
def test_refused_flags_exit_2_with_one_line(argv, needle, capsys,
                                            monkeypatch):
    monkeypatch.setattr(sys, "argv", ["solve_serve", "--device", "cpu"]
                        + BASE + argv)
    with pytest.raises(SystemExit) as exc:
        tserve.main()
    assert exc.value.code == 2
    out = capsys.readouterr()
    assert out.out == ""
    lines = out.err.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("solve_serve: ")
    assert needle in lines[0]


def test_telemetry_exports_validate(tmp_path, capsys, monkeypatch):
    paths = {k: str(tmp_path / f"{k}.json") for k in ("m", "t", "e")}
    rep = _run(tserve.main, BASE + [
        "--device", "cpu", "--stream", "--arrival-rate", "20", "--chunk",
        "2", "--use-pallas", "--metrics", "--tenant", "a,b",
        "--metrics-out", paths["m"], "--trace-out", paths["t"],
        "--events-out", paths["e"]], capsys, monkeypatch)
    assert all("metrics" in r and r["tenant"] in ("a", "b")
               for r in rep["results"])
    snap = json.load(open(paths["m"]))
    assert snap["schema"] == obs.SCHEMA and snap["stats"]["completed"] == 4
    assert obs.validate.validate_chrome_trace(json.load(open(paths["t"]))) > 0
    assert obs.validate.validate_event_log_file(paths["e"]) > 0


def test_runs_on_the_card_unless_asked_for_the_cpu(capsys, monkeypatch):
    """No fallback hides the card: without ``--device`` the CLI resolves
    the CUDA device and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(sys, "argv", ["solve_serve"] + BASE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main()


def test_warmup_dry_reports_the_ladder(tmp_path, capsys, monkeypatch):
    """``--warmup --dry`` (with ``--cache-dir`` and ``--bucket-ladder``)
    warms and exits 0 with the reference's report (its keys, the ladder of
    ``repro.solver.batch.bucket_ladder``, one program a bucket, no call
    yet); the port adds the kernel library's build.  The reference's own
    warmup is not run here: its AOT compiles are kept out of long-lived
    test processes (tests/test_programs.py)."""
    from repro.solver import batch as jbatch
    from repro.solver import programs as jprog
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    got = _run(tserve.main, BASE + ["--warmup", "--dry", "--device", "cpu"],
               capsys, monkeypatch)
    assert set(got) == {"schema", "dry", "warmup", "stats", "kernels"}
    assert got["dry"] is True and got["schema"] == "repro.solve_serve/v1"
    ladder = [str(b) for b in jbatch.bucket_ladder(12, 28)]
    assert list(got["warmup"]["buckets"]) == ladder
    assert not got["warmup"]["errors"]
    progs = got["stats"]["programs"]
    assert set(progs) - {"signatures"} == set(jprog.ProgramCache().stats())
    assert progs["programs"] == progs["warmup_programs"] == len(ladder)
    assert progs["warmed_buckets"] == {"dense@-": [int(b) for b in ladder]}
    assert progs["hits"] == progs["misses"] == 0
    d = str(tmp_path / "kernels")
    got = _run(tserve.main, BASE + ["--warmup", "--dry", "--device", "cpu",
                                    "--cache-dir", d, "--bucket-ladder",
                                    "32"], capsys, monkeypatch)
    assert list(got["warmup"]["buckets"]) == ["32"]
    assert got["cache"]["dir"] == d and str(_build.BUILD_ROOT) == d
    monkeypatch.setattr(sys, "argv", ["solve_serve", "--dry", "--device",
                                      "cpu"] + BASE)
    with pytest.raises(SystemExit) as exc:
        tserve.main()
    assert exc.value.code == 2
    assert "--dry requires --warmup" in capsys.readouterr().err


@pytest.mark.parametrize("mode", [
    ["--warmup"],
    ["--warmup", "--warmup-async", "--stream", "--arrival-rate", "20",
     "--chunk", "2"],
])
def test_warmed_runs_equal_the_reference(mode, capsys, monkeypatch):
    """A warmed drain and a streamed replay warmed in the background equal
    the reference's plain runs per request, with no warm error and no
    fallback event."""
    plain = [m for m in mode if not m.startswith("--warmup")]
    want = _run(jserve.main, BASE + plain, capsys, monkeypatch)
    events = []
    monkeypatch.setattr(obs.EventLog, "emit",
                        lambda self, kind, **f: events.append(kind))
    got = _run(tserve.main, BASE + mode + ["--device", "cpu"], capsys,
               monkeypatch)
    for g, w in zip(got["results"], want["results"]):
        for f in ("id", "n", "bucket", "best_len", "iterations", "gap_pct"):
            assert g[f] == w[f], (mode, f)
    progs = got["stats"]["programs"]
    assert progs["hits"] > 0 and not progs["warm_errors"]
    assert "warmup" in events and "warmup_error" not in events
    assert "aot_dispatch_fallback" not in events
