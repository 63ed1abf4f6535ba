"""chip_smoke.py: the script refuses the CPU, and each of its phases runs
end to end at a tiny size on the CPU test mesh."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402


def test_chip_smoke_refuses_the_cpu():
    env = {k: v for k, v in os.environ.items() if k != "RUN_MODEM_CPU"}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=HERE,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    first = json.loads(res.stdout.splitlines()[0])
    assert first["platform"] == "cpu"


PHASES = {
    "batch": lambda tmp: [chip_smoke.phase_batch(frames=16, frame_length=4)],
    "coded": lambda tmp: [chip_smoke.phase_coded(frames=16)],
    "stream": lambda tmp: chip_smoke.phase_stream(
        str(tmp), frame_length=4, shapes=((4, 1), (4, 2), (8, 1)),
        data_blocks=2),
    "reference": lambda tmp: [chip_smoke.phase_reference(
        frames=8, frame_length=4, codewords=64,
        ber_points=[(2, 13.0, 128)])],
    "four_cards": lambda tmp: chip_smoke.phase_four_cards(
        streams=4, frames_per_block=4, blocks=3, frame_length=4,
        workdir=str(tmp)),
}


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_phase_runs_at_tiny_size_on_cpu(phase, tmp_path):
    rows = PHASES[phase](tmp_path)
    assert rows
    for r in rows:
        json.dumps(r)  # every reading is printable as one JSON line
        if "step_ms" in r:
            assert r["step_ms"] is None or r["step_ms"] > 0
