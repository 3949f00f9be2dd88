"""chip_smoke.py: the result line, the refusal to run without a GPU,
and its phases at small sizes on the CPU (the full sizes run on the
card, where `python chip_smoke.py` is the command)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def test_result_line_format():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "not 'gpu'" in r.stdout


def test_pair_phase_small(tmp_path):
    note = chip_smoke.phase_pair(length=200_000, workdir=str(tmp_path))
    assert "equal to the numpy twin" in note
    assert (tmp_path / "pair.xmfa").stat().st_size > 0


def test_kernel_checks_small():
    note = chip_smoke.phase_kernels(gate=(6, 300), small=(24, (16, 64)),
                                    cpu_sample=3, assoc=(2, 1 << 17),
                                    oracle_rows=1)
    assert "_fb_calls_assoc" in note


def test_phase_failure_is_reported(capsys):
    class Counter:
        def snapshot(self):
            return (0, 0.0, 0, 0)

    def bad():
        chip_smoke.check(False, "deliberate")

    failed = chip_smoke.run_phases([("ok", lambda: "fine"), ("bad", bad)],
                                   Counter())
    assert failed == ["bad"]
    out = capsys.readouterr().out
    assert "# phase ok: ok" in out
    assert "# phase bad: FAILED" in out and "deliberate" in out


@pytest.mark.gpu
def test_kernels_at_real_widths(gpu):
    chip_smoke.phase_kernels()
