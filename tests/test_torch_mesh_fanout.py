"""The lightcone fan-out twin (scripts/lightcone_fanout_torch.py): the
partition and child-command tests of tests/test_lightcone_fanout.py,
applied to the twin, whose children run scripts/create_lightcone_torch.py;
and its coordinates from ``initialize_multihost`` (a one-process gloo
group over a ``file://`` rendezvous)."""
import os
import sys

import pytest
import torch.distributed as dist

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")


@pytest.fixture()
def fanout(monkeypatch):
    sys.path.insert(0, SCRIPTS)
    try:
        import lightcone_fanout_torch
    finally:
        sys.path.pop(0)
    calls = []
    monkeypatch.setattr(lightcone_fanout_torch.subprocess, "run",
                        lambda cmd, check: calls.append(cmd))
    return lightcone_fanout_torch, calls


def _run(mod, argv):
    old = sys.argv
    sys.argv = ["lightcone_fanout_torch.py"] + argv
    try:
        mod.main()
    finally:
        sys.argv = old


def test_partition_complete_and_disjoint(fanout):
    mod, calls = fanout
    los = [str(i) for i in range(74, 84)]
    seen = []
    for pid in range(3):
        calls.clear()
        _run(mod, ["--los", *los, "--num-processes", "3",
                   "--process-id", str(pid)])
        mine = [int(c[c.index("--SLICS-LOS") + 1]) for c in calls]
        assert mine == list(range(74, 84))[pid::3]
        seen += mine
    assert sorted(seen) == list(range(74, 84))


def test_child_command_contract(fanout):
    mod, calls = fanout
    _run(mod, ["--los", "7", "--output-base", "/tmp/ym",
               "--num-processes", "1", "--process-id", "0",
               "--SLICS-base-path", "/data/SLICS", "--n-plane", "15"])
    (cmd,) = calls
    assert cmd[0] == sys.executable
    assert cmd[1].endswith("create_lightcone_torch.py")
    assert cmd[cmd.index("--output-file") + 1] == "/tmp/ym_LOS7"
    assert cmd[cmd.index("--SLICS-base-path") + 1] == "/data/SLICS"
    assert cmd[cmd.index("--n-plane") + 1] == "15"


def test_single_process_defaults(fanout):
    mod, calls = fanout
    _run(mod, ["--los", "1", "2"])
    assert len(calls) == 2


def test_coordinates_from_initialize_multihost(fanout, tmp_path):
    mod, calls = fanout
    try:
        _run(mod, ["--los", "3", "4", "5", "--coordinator",
                   f"file://{tmp_path / 'rdv'}", "--num-processes", "1",
                   "--process-id", "0"])
        assert dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert [c[c.index("--SLICS-LOS") + 1] for c in calls] == ["3", "4", "5"]
