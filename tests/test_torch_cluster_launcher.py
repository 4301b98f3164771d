"""The port's cluster launcher (ray_tpu_torch.autoscaler.launcher) and
`python -m ray_tpu_torch up/down/exec/attach`: the cases of
tests/test_cluster_launcher.py against the port, and the launcher held
against the JAX one where both can run on the same config:

  * SSHCommandRunner builds the same argv for `run`, `put` and `attach`;
  * `_subst` gives the same commands once the module name is mapped
    (`-m ray_tpu` -> `-m ray_tpu_torch`);
  * a `.json` config reads to the same dict in both, and the port reads
    it without PyYAML.

The live cases start the head and a worker on this host, each on a port
and a TMPDIR of its own (the JAX file's fixed port would collide with it
under xdist), the worker with `--num-gpus 0`, and check that `down`
leaves no process of the session behind.
"""

import json
import os
import shlex
import socket
import subprocess
import sys
import time

import pytest

from ray_tpu.autoscaler import launcher as jax_launcher
from ray_tpu_torch.autoscaler import launcher as torch_launcher
from ray_tpu_torch.autoscaler.launcher import (
    ClusterLauncher,
    LocalCommandRunner,
    SSHCommandRunner,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_ssh_runner_builds_commands():
    r = SSHCommandRunner("10.0.0.7", "gpuuser", key="/tmp/k.pem", port=2222)
    attach = r.attach_command()
    assert "gpuuser@10.0.0.7" in attach
    assert "-i /tmp/k.pem" in attach.replace("'", "")
    assert "-p 2222" in attach


@pytest.mark.parametrize("key,port", [(None, 22), ("/tmp/k.pem", 2222)])
def test_ssh_runner_argv_matches_jax(monkeypatch, tmp_path, key, port):
    """run, put (file and directory) and attach build the same argv."""
    seen = []

    def fake_run(argv, **kw):
        seen.append(list(argv))
        return subprocess.CompletedProcess(argv, 0, "out", "")

    monkeypatch.setattr(subprocess, "run", fake_run)
    d = tmp_path / "dir"
    d.mkdir()
    out = {}
    for name, cls in (("jax", jax_launcher.SSHCommandRunner),
                      ("torch", SSHCommandRunner)):
        seen.clear()
        r = cls("10.0.0.7", "ubuntu", key=key, port=port)
        r.run("echo 'a b' && ls")
        r.put(str(tmp_path / "f.txt"), "/remote/f.txt")
        r.put(str(d), "/remote/dir")
        out[name] = (list(seen), r.attach_command())
    assert out["torch"] == out["jax"]
    assert out["torch"][0][2][-3:] == ["-r", str(d),
                                       "ubuntu@10.0.0.7:/remote/dir"]


def _config(port, tmp_path, **extra):
    cfg = {
        "cluster_name": "launch-e2e",
        "provider": {"type": "local", "head_ip": "127.0.0.1",
                     "worker_ips": ["127.0.0.1"]},
        "port": port,
        "setup_commands": ["echo setup-ran"],
        "head_start_commands": [
            "{python} -m ray_tpu_torch start --head --port {port}"
            " --num-cpus 2 --no-dashboard"
        ],
        "worker_start_commands": [
            "{python} -m ray_tpu_torch start --address {head_address}"
            " --num-cpus 2 --num-gpus 0"
        ],
    }
    cfg.update(extra)
    return cfg


def test_subst_matches_jax_with_the_module_mapped():
    cfg = {"cluster_name": "c1", "port": 7000,
           "provider": {"type": "ssh", "head_ip": "10.0.0.1",
                        "worker_ips": ["10.0.0.2"]},
           "auth": {"ssh_user": "u", "ssh_private_key": "/k", "ssh_port": 23}}
    port_l, jax_l = ClusterLauncher(cfg), jax_launcher.ClusterLauncher(cfg)
    pairs = list(zip(
        jax_launcher.DEFAULT_HEAD_START + jax_launcher.DEFAULT_WORKER_START
        + jax_launcher.DEFAULT_STOP,
        torch_launcher.DEFAULT_HEAD_START
        + torch_launcher.DEFAULT_WORKER_START + torch_launcher.DEFAULT_STOP))
    assert len(pairs) == 3
    for jax_cmd, torch_cmd in pairs:
        want = jax_l._subst(jax_cmd).replace("-m ray_tpu ", "-m ray_tpu_torch ")
        assert port_l._subst(torch_cmd) == want
        assert "-m ray_tpu_torch " in want
    user = "echo {cluster_name} {head_address} {port} {python}"
    assert port_l._subst(user) == jax_l._subst(user)
    for ip in ("10.0.0.1", "10.0.0.2"):
        a, b = port_l._runner(ip), jax_l._runner(ip)
        assert type(a).__name__ == type(b).__name__ == "SSHCommandRunner"
        assert a._base() == b._base()
    assert port_l.attach_command() == jax_l.attach_command()


def test_local_runner_run_and_put(tmp_path):
    r = LocalCommandRunner()
    assert r.run("echo hello").strip() == "hello"
    with pytest.raises(RuntimeError):
        r.run("exit 3")
    src = tmp_path / "src.txt"
    src.write_text("payload")
    r.put(str(src), str(tmp_path / "dst" / "copy.txt"))
    assert (tmp_path / "dst" / "copy.txt").read_text() == "payload"


def test_json_config_needs_no_pyyaml(monkeypatch, tmp_path):
    cfg = _config(6390, tmp_path, file_mounts={"/a": "/b"})
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps(cfg))
    (tmp_path / "cluster.yaml").write_text(json.dumps(cfg))
    # JSON is YAML: the JAX launcher reads the same file to the same dict.
    assert (ClusterLauncher.from_yaml(str(path)).config
            == jax_launcher.ClusterLauncher.from_yaml(str(path)).config
            == cfg)
    monkeypatch.setitem(sys.modules, "yaml", None)  # PyYAML absent
    launcher = ClusterLauncher.from_yaml(str(path))
    assert launcher.config == cfg and launcher.port == 6390
    assert launcher.worker_ips == ["127.0.0.1"]
    with pytest.raises(RuntimeError, match="PyYAML"):
        ClusterLauncher.from_yaml(str(tmp_path / "cluster.yaml"))
    assert launcher.attach_command() == os.environ.get("SHELL", "/bin/bash")


def _children() -> dict:
    """pid -> parent pid of every process on this host."""
    out = {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                out[int(pid)] = int(f.read().rsplit(") ", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
    return out


def _session_tree(tmpdir) -> set:
    """The session's services (`rt start`'s pids) and their descendants."""
    with open(os.path.join(tmpdir, "ray_tpu_torch", "session.json")) as f:
        tree = set(json.load(f)["pids"])
    parents = _children()
    grew = True
    while grew:
        new = {p for p, pp in parents.items() if pp in tree} - tree
        tree |= new
        grew = bool(new)
    return tree


def _alive(pids) -> set:
    out = set()
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(") ", 1)[1].split()[0] != "Z":
                    out.add(pid)
        except OSError:
            pass
    return out


def _wait_gone(pids, timeout=30.0) -> set:
    deadline = time.monotonic() + timeout
    while _alive(pids) and time.monotonic() < deadline:
        time.sleep(0.2)
    return _alive(pids)


def test_launcher_up_exec_down_local(monkeypatch, tmp_path_factory):
    """Full `rt up` -> cluster forms (head + worker) -> `rt exec` ->
    `rt down` with the local provider: no process of the session left."""
    import ray_tpu_torch as rt

    tmp = tmp_path_factory.mktemp("rtl")
    monkeypatch.setenv("TMPDIR", str(tmp))
    port = _free_port()
    mounted = tmp / "mounted"
    payload = tmp / "payload.txt"
    payload.write_text("mounted-ok")
    config = _config(
        port, tmp, file_mounts={str(mounted / "payload.txt"): str(payload)})
    cfg_path = tmp / "cluster.json"
    cfg_path.write_text(json.dumps(config))

    launcher = ClusterLauncher.from_yaml(str(cfg_path))
    logs = []
    tree = set()
    try:
        address = launcher.up(log=logs.append)
        assert address == f"127.0.0.1:{port}"
        assert any("setup-ran" in ln for ln in logs), logs
        assert (mounted / "payload.txt").read_text() == "mounted-ok"

        # The cluster formed: both nodes visible, tasks run.
        rt.init(address=address, num_gpus=0)
        try:
            # head + launched worker (+ this driver's own node).
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                alive = [n for n in rt.nodes() if n["state"] == "ALIVE"]
                if len(alive) >= 3:
                    break
                time.sleep(0.5)
            assert len(alive) >= 3, alive
            assert sum(1 for n in alive if n.get("is_head")) == 1
            assert "GPU" not in rt.cluster_resources()

            @rt.remote
            def f(x):
                return x * 2

            assert rt.get(f.remote(21), timeout=60) == 42
        finally:
            rt.shutdown()

        out = launcher.exec("echo from-head", log=logs.append)
        assert out and out[0].strip() == "from-head"
        tree = _session_tree(tmp)
        assert len(tree) >= 4, tree  # GCS, two raylets, their workers
    finally:
        launcher.down(log=logs.append)

    with socket.socket() as s:
        deadline = time.monotonic() + 10
        while s.connect_ex(("127.0.0.1", port)) == 0:
            assert time.monotonic() < deadline, "GCS still listening"
            time.sleep(0.2)
    assert not _wait_gone(tree), f"left after down: {_alive(tree)}"


def _cli(env, *args):
    proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                          env=env, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, (args, proc.stdout, proc.stderr[-3000:])
    return proc.stdout


def test_cli_up_exec_down_leaves_no_process(tmp_path_factory):
    """`python -m ray_tpu_torch up/exec/down` on a .json config."""
    tmp = tmp_path_factory.mktemp("rtc")
    env = {**os.environ, "TMPDIR": str(tmp),
           "PYTHONPATH": os.pathsep.join(
               p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
    port = _free_port()
    cfg_path = tmp / "cluster.json"
    cfg_path.write_text(json.dumps(_config(port, tmp)))
    tree = set()
    try:
        up = _cli(env, "up", str(cfg_path))
        assert f"127.0.0.1:{port}" in up and "setup-ran" in up, up
        out = _cli(env, "exec", "--all-nodes", str(cfg_path), "echo",
                   "{cluster_name}")
        assert out.split() == ["launch-e2e", "launch-e2e"], out
        status = _cli(env, "status", "--address", f"127.0.0.1:{port}")
        assert "2/2 nodes alive" in status, status
        tree = _session_tree(tmp)
        assert len(tree) >= 3, tree
    finally:
        down = _cli(env, "down", str(cfg_path))
    assert "stopping 127.0.0.1" in down, down
    assert not _wait_gone(tree), f"left after down: {_alive(tree)}"
    assert not os.path.exists(os.path.join(tmp, "ray_tpu_torch",
                                           "session.json"))


def test_attach_execs_the_attach_command(tmp_path):
    """`rt attach` execs /bin/sh -c on the launcher's attach command: an
    ssh config's, shown here through a stand-in SHELL for the local one."""
    cfg = tmp_path / "local.json"
    cfg.write_text(json.dumps({"provider": {"type": "local"}}))
    env = {**os.environ, "SHELL": "echo attached-to-head",
           "PYTHONPATH": os.pathsep.join(
               p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
    out = _cli(env, "attach", str(cfg))
    assert out.strip() == "attached-to-head"
    ssh = ClusterLauncher({"provider": {"type": "ssh", "head_ip": "10.1.2.3"},
                           "auth": {"ssh_user": "u"}})
    assert shlex.split(ssh.attach_command())[-1] == "u@10.1.2.3"
