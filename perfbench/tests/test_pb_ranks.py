"""The rank launcher (``pbench/ranks.py``) on four gloo ranks, rank 0 in
a subprocess of its own with its own timeout, running a stand-in cell
through ``runner.run_cell`` (``rankcase/systems/ranks_case.py``): the
ranks' all-reduce of their ids, a peer that fails at start or in a
collective, rank 0 killed, a peer with a forbidden module loaded, a
group that the driver left open; and no process left behind by any of
them.  The all-reduce and the peer that fails in it on four NCCL ranks
need four cards."""
from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from pathlib import Path

import pytest

from pbench import ranks

CASE = Path(__file__).resolve().parent / "rankcase/systems/ranks_case.py"
TIMEOUT_S = 60          # a case's subprocess, all of it
FAIL_S = 30             # from the group's start to rank 0's end, after a
                        # peer's failure
GONE_S = 30             # what the peers may take to end after rank 0


def _env(case: str, token: str) -> dict:
    return dict(os.environ, PB_RANKS_CASE=case, PB_RANKS_TOKEN=token)


def _ours(token: str) -> list[int]:
    """Live processes (not zombies) whose environment holds ``token``."""
    found = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            env = (d / "environ").read_bytes()
            state = (d / "stat").read_text().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if f"PB_RANKS_TOKEN={token}".encode() in env and state != "Z":
            found.append(int(d.name))
    return found


def _none_left(token: str, within: float = GONE_S) -> list[int]:
    """The processes of ``token`` still there after ``within`` seconds;
    each is killed, so that a failing case leaves none behind."""
    deadline = time.monotonic() + within
    while _ours(token) and time.monotonic() < deadline:
        time.sleep(0.2)
    left = _ours(token)
    for pid in left:
        os.kill(pid, signal.SIGKILL)
    return left


class Case:
    """Rank 0 of a case in a subprocess; its standard output read line by
    line as it comes, each line with its time."""

    def __init__(self, case: str, device: str = "cpu"):
        self.token = uuid.uuid4().hex
        self.lines: list = []
        self.err = tempfile.TemporaryFile("w+")
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen([sys.executable, str(CASE), device],
                                     env=_env(case, self.token),
                                     stdout=subprocess.PIPE, stderr=self.err,
                                     text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append((time.monotonic(), line))

    def first_line(self, timeout: float) -> dict:
        deadline = time.monotonic() + timeout
        while not self.lines and time.monotonic() < deadline:
            time.sleep(0.05)
        assert self.lines, "rank 0 printed nothing"
        return json.loads(self.lines[0][1])

    def finish(self, timeout: float):
        """Wait for rank 0 (killed after ``timeout``); returns the process
        and the seconds from its group's start (the pids line; its own
        start where none came) to its end."""
        try:
            self.proc.wait(timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            end = time.monotonic()
            self.reader.join(10.0)
            if not self.reader.is_alive():   # else close() would wait on it
                self.proc.stdout.close()
            self.err.seek(0)
            stderr = self.err.read()
            self.err.close()
        start = self.lines[0][0] if self.lines else self.t0
        out = "".join(line for _, line in self.lines)
        return (subprocess.CompletedProcess(self.proc.args,
                                            self.proc.returncode, out,
                                            stderr), end - start)


def _run(case: str, device: str = "cpu", timeout: float = TIMEOUT_S):
    c = Case(case, device)
    p, took = c.finish(timeout)
    return p, took, c.token


def _lines(stdout: str) -> dict:
    out = {}
    for line in stdout.splitlines():
        if line.startswith("{"):
            out.update(json.loads(line))
    return out


def test_all_reduce_of_the_ranks_ids():
    p, _, token = _run("sound")
    assert p.returncode == 0, p.stderr[-3000:]
    out = _lines(p.stdout)
    assert out["sum"] == 6.0 and len(out["pids"]) == 3
    assert out["correct"] is True
    assert _none_left(token, 0.0) == []


def _assert_rank_0_failed(case: str, rank: str, device: str = "cpu"):
    p, took, token = _run(case, device)
    assert p.returncode == ranks.PEER_FAILED, p.stderr[-3000:]
    assert took < FAIL_S
    assert re.search(rf"rank {rank} exited with code 1", p.stderr), \
        p.stderr[-3000:]
    assert "RuntimeError: " in p.stderr and "sum" not in p.stdout
    assert '"correct"' not in p.stdout
    assert _none_left(token) == []


@pytest.mark.parametrize("case,rank", [("raise_at_start", "[123]"),
                                       ("raise_in_collective", "3")],
                         ids=["raise_at_start", "raise_in_collective"])
def test_a_failed_peer_ends_rank_0(case, rank):
    _assert_rank_0_failed(case, rank)


def test_peers_end_when_rank_0_is_killed():
    c = Case("rank0_waits")
    try:
        pids = c.first_line(TIMEOUT_S)["pids"]
        time.sleep(1.0)
        assert all(pid in _ours(c.token) for pid in pids)
        c.proc.send_signal(signal.SIGKILL)
    finally:
        c.finish(TIMEOUT_S)
    assert _none_left(c.token) == []


def test_a_forbidden_module_on_a_peer_makes_rank_0_raise():
    p, _, token = _run("forbidden")
    assert p.returncode not in (0, ranks.PEER_FAILED), p.stderr[-3000:]
    assert re.search(r"RuntimeError: modules of jax or the JAX package "
                     r"loaded on peers: rank 1: jax", p.stderr), \
        p.stderr[-3000:]
    assert "sum" in p.stdout and '"correct"' not in p.stdout
    assert _none_left(token, 0.0) == []


def test_a_forbidden_module_on_a_peer_left_open_leaves_no_result():
    """``run_cell`` closes the group that the driver left open once
    ``run`` has returned, so the peers' check still runs: rank 0 raises
    and prints no result."""
    p, _, token = _run("forbidden_left_open")
    assert p.returncode not in (0, ranks.PEER_FAILED), p.stderr[-3000:]
    assert "the harness closes them" in p.stderr
    assert re.search(r"RuntimeError: modules of jax or the JAX package "
                     r"loaded on peers: rank 1: jax", p.stderr), \
        p.stderr[-3000:]
    assert "sum" in p.stdout and '"correct"' not in p.stdout
    assert _none_left(token, 0.0) == []


@pytest.mark.cuda
def test_all_reduce_on_four_nccl_ranks(card):
    import torch
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 cards, {torch.cuda.device_count()} visible")
    p, _, token = _run("sound", "cuda:0", timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert _lines(p.stdout)["sum"] == 6.0
    assert _none_left(token, 0.0) == []


@pytest.mark.cuda
def test_a_failed_peer_ends_rank_0_on_nccl(card):
    import torch
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 cards, {torch.cuda.device_count()} visible")
    _assert_rank_0_failed("raise_in_collective", "3", "cuda:0")
