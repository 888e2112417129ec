"""PyTorch port, the bench's driver contract (``frp_tpu_torch.bench.
main_with_retries``), the twin of ``tests/test_bench_driver.py`` with a fake
``subprocess.run``: a hung, crashed or killed attempt never loses a number
already measured, the best-so-far JSON line follows every successful
attempt, a global budget skips attempts that cannot fit, and the child's
budget sits inside its attempt's timeout. Two more: the ticks plan is
clamped to its last entry (the reference leaves later attempts at one tick),
and no attempt waits for the one before it to be released (the reference
sleeps 45 s for its TPU relay)."""

import json
import subprocess
import sys

import pytest

from frp_tpu_torch import bench


class _FakeProc:
    def __init__(self, stdout="", stderr="", returncode=0):
        self.stdout, self.stderr, self.returncode = stdout, stderr, returncode


def _result(value: float) -> str:
    return json.dumps({
        "metric": "faces/sec/chip", "value": value, "unit": "faces/sec",
        "vs_baseline": round(value / 33.3, 1), "detail": {},
    })


@pytest.fixture(autouse=True)
def _plain_env(monkeypatch):
    for name in ("BENCH_TICKS", "BENCH_ATTEMPT_TICKS", "BENCH_RECOVERY_SLEEP_S",
                 "BENCH_BUDGET_S", "BENCH_TOTAL_BUDGET_S", "BENCH_ATTEMPT_TIMEOUT",
                 "BENCH_FIRST_ATTEMPT_TIMEOUT"):
        monkeypatch.delenv(name, raising=False)


def test_timeout_attempt_is_caught_and_next_attempt_runs(monkeypatch, capsys):
    calls = {"n": 0}

    def fake_run(cmd, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise subprocess.TimeoutExpired(cmd, kw.get("timeout", 900),
                                            output="", stderr="[bench] hung")
        return _FakeProc(stdout="noise\n" + _result(5000.0 + calls["n"]))

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setattr(bench.time, "sleep", lambda s: None)
    bench.main_with_retries(max_attempts=3)
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["value"] == 5003.0  # best of the two successful attempts
    assert got["detail"]["attempts_planned"] == 3
    assert got["detail"]["attempts_succeeded"] == 2
    assert got["detail"]["median_faces_per_sec_across_attempts"] == 5002.5


def test_all_attempts_run_no_early_exit(monkeypatch, capsys):
    """The reported median is a real 3-attempt median: no good-enough exit."""
    calls = {"n": 0}
    cmds = []

    def fake_run(cmd, **kw):
        calls["n"] += 1
        cmds.append(cmd)
        return _FakeProc(stdout=_result(9000.0))

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setattr(bench.time, "sleep", lambda s: None)
    bench.main_with_retries(max_attempts=3)
    assert calls["n"] == 3
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["detail"]["attempts_succeeded"] == 3
    # each attempt is a fresh child of the port's module, on the card
    assert cmds[0] == [sys.executable, "-m", "frp_tpu_torch.bench", "--once", "--device", "cuda"]


def test_empty_stdout_attempt_is_skipped(monkeypatch, capsys):
    calls = {"n": 0}

    def fake_run(cmd, **kw):
        calls["n"] += 1
        if calls["n"] < 3:
            return _FakeProc(stdout="", stderr="crash", returncode=1)
        return _FakeProc(stdout=_result(4321.0))

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setattr(bench.time, "sleep", lambda s: None)
    bench.main_with_retries(max_attempts=3)
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["value"] == 4321.0
    assert got["detail"]["attempts_succeeded"] == 1


def test_all_attempts_failing_exits_nonzero(monkeypatch):
    def fake_run(cmd, **kw):
        raise subprocess.TimeoutExpired(cmd, 900)

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setattr(bench.time, "sleep", lambda s: None)
    with pytest.raises(SystemExit):
        bench.main_with_retries(max_attempts=2)


def test_json_survives_driver_kill_after_first_success(monkeypatch, capsys):
    """Attempt 1 measures a number, then the process dies in attempt 2 (a
    BaseException the retry loop does not catch): attempt 1's JSON is
    already on stdout."""
    calls = {"n": 0}

    def fake_run(cmd, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            return _FakeProc(stdout=_result(6104.5))
        raise KeyboardInterrupt("an outer timeout's kill")

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setattr(bench.time, "sleep", lambda s: None)
    with pytest.raises(KeyboardInterrupt):
        bench.main_with_retries(max_attempts=3)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert lines, "best-so-far JSON must be printed right after attempt 1"
    got = json.loads(lines[-1])
    assert got["value"] == 6104.5
    assert got["detail"]["attempts_succeeded"] == 1


def test_global_budget_skips_unaffordable_attempt(monkeypatch, capsys):
    """With one result in hand and no budget left for the timeout of another
    attempt, the loop stops."""
    clock = {"t": 0.0}
    monkeypatch.setattr(bench.time, "perf_counter", lambda: clock["t"])
    monkeypatch.setattr(bench.time, "sleep", lambda s: None)
    monkeypatch.setenv("BENCH_TOTAL_BUDGET_S", "1200")
    monkeypatch.setenv("BENCH_ATTEMPT_TIMEOUT", "420")
    calls = {"n": 0}

    def fake_run(cmd, **kw):
        calls["n"] += 1
        clock["t"] += 400.0  # each attempt takes 400 s of wall clock
        return _FakeProc(stdout=_result(6000.0 + calls["n"]))

    monkeypatch.setattr(subprocess, "run", fake_run)
    bench.main_with_retries(max_attempts=5)
    # t=0: attempt 1 (ends 400); 400+420 <= 1200: attempt 2 (ends 800);
    # 800+420 > 1200: stop
    assert calls["n"] == 2
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["value"] == 6002.0
    assert got["detail"]["attempts_succeeded"] == 2


def test_child_budget_derived_from_attempt_timeout(monkeypatch):
    """The child's BENCH_BUDGET_S leaves margin inside the parent's timeout."""
    seen_env = {}

    def fake_run(cmd, **kw):
        seen_env.update(kw.get("env") or {})
        return _FakeProc(stdout=_result(1000.0))

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setattr(bench.time, "sleep", lambda s: None)
    monkeypatch.setenv("BENCH_FIRST_ATTEMPT_TIMEOUT", "600")
    bench.main_with_retries(max_attempts=1)
    assert float(seen_env["BENCH_BUDGET_S"]) <= 600 - 60


def test_ticks_plan_is_clamped_to_its_last_entry(monkeypatch):
    """A plan shorter than the attempts runs its last entry after its end;
    the reference leaves those attempts at the one-tick default. The plan's
    default is bench.py's "2,3,3", and BENCH_TICKS overrides it; the device
    reaches every child."""
    seen = []

    def fake_run(cmd, **kw):
        seen.append((kw["env"].get("BENCH_TICKS"), cmd[cmd.index("--device") + 1]))
        return _FakeProc(stdout=_result(1000.0))

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setenv("BENCH_ATTEMPT_TICKS", "2,3")
    bench.main_with_retries(max_attempts=4, device="cpu")
    assert seen == [("2", "cpu"), ("3", "cpu"), ("3", "cpu"), ("3", "cpu")]
    seen.clear()
    monkeypatch.delenv("BENCH_ATTEMPT_TICKS")
    bench.main_with_retries(max_attempts=4)
    assert [t for t, _ in seen] == ["2", "3", "3", "3"]
    seen.clear()
    monkeypatch.setenv("BENCH_TICKS", "1")
    bench.main_with_retries(max_attempts=2)
    assert [t for t, _ in seen] == ["1", "1"]


def test_no_sleep_between_attempts(monkeypatch):
    """A card is free once its child has exited: the next attempt starts at
    once, and the reference's BENCH_RECOVERY_SLEEP_S is no knob of the port's
    (the reference sleeps 45 s for its TPU relay)."""
    slept = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: _FakeProc(stdout=_result(1.0)))
    monkeypatch.setattr(bench.time, "sleep", slept.append)
    bench.main_with_retries(max_attempts=3)
    assert slept == []
    monkeypatch.setenv("BENCH_RECOVERY_SLEEP_S", "45")
    bench.main_with_retries(max_attempts=3)
    assert slept == []
