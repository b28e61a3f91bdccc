"""Supervisor fail-soft behavior of the driver-facing bench.py.

The driver runs ``python bench.py`` and records the single stdout JSON
line; a zeroed line loses a measured number. These tests pin the
salvage protocol: the child checkpoints each measured phase to stdout,
and the supervisor ships the best checkpoint from a timed-out or
crashed attempt instead of zero.

No JAX, no chip — ``subprocess.run`` is mocked.
"""

import json
import subprocess
import sys
from unittest import mock

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])

import bench


def _run_main(monkeypatch_run, capsys):
    with mock.patch.object(subprocess, "run", side_effect=monkeypatch_run):
        # retry_sleep_s=0: the mocked tests need not sleep through the
        # 5 s inter-attempt backoff.
        bench.main(total_budget_s=560.0, retry_sleep_s=0.0)
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines()
             if ln.strip()]
    assert len(lines) == 1, f"supervisor must print exactly one line: {lines}"
    return json.loads(lines[0])


def _timeout(stdout_bytes):
    exc = subprocess.TimeoutExpired(cmd="bench", timeout=420.0)
    exc.stdout = stdout_bytes
    return exc


def _proc(stdout_bytes, rc=0):
    return subprocess.CompletedProcess(args="bench", returncode=rc,
                                       stdout=stdout_bytes)


def _ckpt(value, phase):
    return json.dumps({
        "metric": bench.METRIC, "value": value, "unit": "registrations/sec",
        "vs_baseline": round(value / bench.BASELINE_REGS_PER_SEC, 2),
        "partial": phase,
    }).encode()


def test_timeout_after_batched_checkpoint_ships_the_measured_number(capsys):
    """The exact 2026-08-19 failure shape: attempt 0 times out late, its
    stdout already carries single-stream AND batched checkpoints."""
    stdout = (_ckpt(390.8, "single_stream") + b"\n"
              + _ckpt(2876.8, "batched_pipeline") + b"\n")
    calls = []

    def fake_run(*a, **k):
        calls.append(k)
        raise _timeout(stdout)

    out = _run_main(fake_run, capsys)
    assert out["value"] == 2876.8
    assert out["truncated_after"] == "batched_pipeline"
    assert "attempt0_timeout" in out["attempt_errors"]
    # The headline was measured — the supervisor must NOT burn the
    # remaining budget on a second attempt.
    assert len(calls) == 1


def test_single_stream_checkpoint_survives_two_timeouts(capsys):
    def fake_run(*a, **k):
        raise _timeout(_ckpt(390.8, "single_stream") + b"\n")

    out = _run_main(fake_run, capsys)
    assert out["value"] == 390.8
    assert out["truncated_after"] == "single_stream"
    assert "attempt1_timeout" in out["attempt_errors"]


def test_complete_child_final_line_passes_through_unchanged(capsys):
    final = {"metric": bench.METRIC, "value": 3207.0,
             "unit": "registrations/sec", "vs_baseline": 641.4}
    stdout = (_ckpt(398.0, "single_stream") + b"\n"
              + _ckpt(3207.0, "batched_pipeline") + b"\n"
              + json.dumps(final).encode() + b"\n")

    out = _run_main(lambda *a, **k: _proc(stdout), capsys)
    assert out == final  # no truncation markers on a clean run


def test_retry_after_empty_timeout_then_success(capsys):
    final = {"metric": bench.METRIC, "value": 3100.0,
             "unit": "registrations/sec", "vs_baseline": 620.0}
    seq = [_timeout(b""), _proc(json.dumps(final).encode() + b"\n")]

    def fake_run(*a, **k):
        item = seq.pop(0)
        if isinstance(item, subprocess.TimeoutExpired):
            raise item
        return item

    out = _run_main(fake_run, capsys)
    assert out["value"] == 3100.0
    assert "truncated_after" not in out


def test_no_output_at_all_yields_zero_error_line(capsys):
    def fake_run(*a, **k):
        return _proc(b"", rc=1)

    out = _run_main(fake_run, capsys)
    assert out["value"] == 0.0
    assert "bench_failed" in out["error"]


def test_timeout_with_final_line_ships_it_clean(capsys):
    """A child that printed its FINAL line but hung before
    exiting is a complete run — ship it unchanged (same as the clean
    path), never as a 'truncated_after: final' checkpoint."""
    final = {"metric": bench.METRIC, "value": 2900.0,
             "unit": "registrations/sec", "vs_baseline": 580.0}
    stdout = (_ckpt(390.0, "single_stream") + b"\n"
              + _ckpt(2900.0, "batched_pipeline") + b"\n"
              + json.dumps(final).encode() + b"\n")
    calls = []

    def fake_run(*a, **k):
        calls.append(k)
        raise _timeout(stdout)

    out = _run_main(fake_run, capsys)
    assert out == final
    assert len(calls) == 1


def test_crash_after_batched_checkpoint_does_not_retry(capsys):
    """The rc!=0 path gets the same early-exit as the timeout path —
    once the batched headline is in hand, a retry gains nothing."""
    stdout = (_ckpt(395.0, "single_stream") + b"\n"
              + _ckpt(3105.5, "batched_pipeline") + b"\n")
    calls = []

    def fake_run(*a, **k):
        calls.append(k)
        return _proc(stdout, rc=1)

    out = _run_main(fake_run, capsys)
    assert out["value"] == 3105.5
    assert out["truncated_after"] == "batched_pipeline"
    assert len(calls) == 1


def test_salvaged_lower_value_never_overrides_higher_checkpoint(capsys):
    """Best-checkpoint selection is by VALUE across attempts;
    a later lower-valued salvage must not clobber an earlier higher one."""
    seq = [_timeout(_ckpt(2800.0, "batched_pipeline") + b"\n")]
    # (the batched checkpoint triggers the early-exit, single attempt)

    def fake_run(*a, **k):
        raise seq.pop(0)

    out = _run_main(fake_run, capsys)
    assert out["value"] == 2800.0

    # Two single-stream-only attempts: second is slower; first wins.
    seq2 = [_timeout(_ckpt(400.0, "single_stream") + b"\n"),
            _timeout(_ckpt(350.0, "single_stream") + b"\n")]

    def fake_run2(*a, **k):
        raise seq2.pop(0)

    out2 = _run_main(fake_run2, capsys)
    assert out2["value"] == 400.0
