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
``obs.validate``.
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
    (["--shard"], "item 14"),
    (["--devices", "2"], "item 14"),
    (["--warmup"], "item 15"),
    (["--cache-dir", "x"], "item 15"),
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
