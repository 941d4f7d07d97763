"""The port's operator CLI (python -m firedancer_tpu_torch.app.fdtpuctl):
`run` boots verify-bench with the verify tile on device "cpu" and
supervises it, `ready` waits for RUN, the /metrics and /healthz endpoint
answers, and `drain` (SIGTERM to the supervisor from its pidfile) ends
it with exit 0 and every txn at the sink; a command that joins the
workspace leaves it linked; `topo` prints what the JAX package's prints;
`postmortem` renders a bundle."""

import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from firedancer_tpu.app import fdtpuctl as jctl
from firedancer_tpu_torch.app import fdtpuctl as pctl
from firedancer_tpu_torch.disco import flightrec
from firedancer_tpu_torch.disco import topo as topo_mod
from firedancer_tpu_torch.disco.tiles import read_capture, source_txn_stream
from firedancer_tpu_torch.disco.topo import TopoBuilder

ROOT = Path(__file__).resolve().parent.parent


def _toml(tmp_path, name, n, port=0) -> Path:
    f = tmp_path / "cfg.toml"
    f.write_text(f'''name = "{name}"
[tiles.verify]
device = "cpu"
buckets = [[16, 256]]
flush_age_ns = 20000000
[tiles.sink]
capture_path = "{tmp_path / 'cap.bin'}"
[development]
source_count = {n}
[supervision]
drain_timeout_s = 60.0
[observability]
http_port = {port}
flight_dir = "{tmp_path / 'flight'}"
''')
    return f


def _ctl(cfg, *args, timeout=180, env=None):
    return subprocess.run(
        [sys.executable, "-m", "firedancer_tpu_torch.app.fdtpuctl",
         "--config", str(cfg), *args], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=timeout)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_run_ready_metrics_drain(tmp_path):
    n = 24
    name = f"tcli{os.getpid()}"
    port = _free_port()
    cfg = _toml(tmp_path, name, n, port)
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    log = open(tmp_path / "run.log", "w+")
    # its own session, so a failed test can take the supervisor and its
    # tiles down together
    run = subprocess.Popen(
        [sys.executable, "-m", "firedancer_tpu_torch.app.fdtpuctl",
         "--config", str(cfg), "run"], cwd=ROOT, env=env, stdout=log,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        r = _ctl(cfg, "ready", "--timeout", "150", env=env)
        assert r.returncode == 0 and r.stdout.strip() == "ready", r
        # a joining command leaves the live workspace linked
        assert os.path.exists(f"/dev/shm/fdtpu_{name}-bench")
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 120
        while True:
            body = urllib.request.urlopen(f"{base}/metrics",
                                          timeout=60).read().decode()
            if f'fdtpu_frag_cnt{{tile="sink",kind="sink"}} {n}' in body:
                break
            assert time.monotonic() < deadline, "txns at the sink"
            time.sleep(0.1)
        for fam in ("degraded_mode", "device_fail_cnt", "fallback_lane_cnt",
                    "reprobe_cnt", "fallback_vps"):
            assert f'fdtpu_{fam}{{tile="verify:0",kind="verify"}} 0' in body
        h = urllib.request.urlopen(f"{base}/healthz", timeout=60)
        assert h.status == 200 and h.read().startswith(b"ok\n")
        pidfile = tmp_path / f"fdtpu_{name}-bench.pid"
        assert int(pidfile.read_text()) == run.pid
        r = _ctl(cfg, "drain", env=env)
        assert r.returncode == 0, r
        assert "drain requested from supervisor" in r.stdout
        assert run.wait(timeout=120) == 0, (tmp_path / "run.log").read_text()
        assert "all tiles RUN" in (tmp_path / "run.log").read_text()
        assert not pidfile.exists()
        assert sorted(read_capture(str(tmp_path / "cap.bin"))) == sorted(
            source_txn_stream(42, 4, n))
        assert not os.path.exists(f"/dev/shm/fdtpu_{name}-bench")
    finally:
        if run.poll() is None:
            os.killpg(run.pid, signal.SIGKILL)
            run.wait()
        log.close()
        try:
            os.unlink(f"/dev/shm/fdtpu_{name}-bench")
        except OSError:
            pass


@pytest.mark.parametrize("topology", ["verify-bench", "leader-bench"])
def test_topo_prints_what_the_jax_package_prints(topology, tmp_path,
                                                 capsys):
    cfg = tmp_path / "t.toml"
    cfg.write_text(f'topology = "{topology}"\n[layout]\n'
                   'verify_tile_count = 2\n[tiles.metric]\n'
                   'prometheus_port = 7999\n')
    assert pctl.main(["--config", str(cfg), "topo"]) == 0
    got = capsys.readouterr().out
    assert jctl.main(["--config", str(cfg), "topo"]) == 0
    assert got == capsys.readouterr().out
    assert "kind=metric" in got


def test_postmortem_renders_a_bundle(tmp_path, capsys):
    spec = (TopoBuilder(f"tclp{os.getpid()}", wksp_mb=8)
            .link("a_b", depth=64, mtu=256)
            .tile("src", "sink", outs=["a_b"])
            .tile("v:0", "verify", ins=["a_b"])
            .build())
    jt = topo_mod.create(spec)
    try:
        path = flightrec.write_bundle(str(tmp_path), jt, reason="respawn",
                                      tile="v:0")
    finally:
        jt.close()
        jt.unlink()
    assert pctl.main(["postmortem", path]) == 0
    out = capsys.readouterr().out
    assert out == flightrec.render_bundle(path) + "\n"
    assert "reason respawn" in out
