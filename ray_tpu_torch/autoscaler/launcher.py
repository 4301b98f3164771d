"""Cluster launcher: bring a cluster up from a YAML or JSON config.

Analog of the reference's `ray up/down/attach/exec` CLI
(python/ray/scripts/scripts.py:566 and the command-runner layer in
autoscaler/_private/command_runner.py): a config file names the head and
worker hosts; per-node CommandRunners (SSH, or local subprocess for
single-host/testing) run file mounts, setup commands, and the
`rt start` service commands on each node.

`rt start` gives its node every card it detects unless told
`--num-gpus`. Nothing arbitrates card ids between two raylets of one
host, so where several nodes share a host (the local provider, or
``worker_ips: [127.0.0.1]``) give every node but one `--num-gpus 0`.

Schema (a ``.json`` file holds the same keys; JSON needs no PyYAML)::

    cluster_name: my-pod
    provider:
      type: ssh            # or "local" (every node is this host)
      head_ip: 10.0.0.1
      worker_ips: [10.0.0.2, 10.0.0.3]
    auth:                  # ssh provider only
      ssh_user: ubuntu
      ssh_private_key: ~/.ssh/id_rsa
    port: 6379             # GCS port on the head
    file_mounts:           # remote path -> local path, pushed to all
      /home/ubuntu/app: ./app
    setup_commands:        # run on every node before start
      - pip install -e /home/ubuntu/app
    head_setup_commands: []
    worker_setup_commands: []
    head_start_commands:   # {port}/{head_address} substituted
      - python -m ray_tpu_torch start --head --port {port}
    worker_start_commands:
      - python -m ray_tpu_torch start --address {head_address}
    stop_commands:
      - python -m ray_tpu_torch stop
"""

from __future__ import annotations

import json
import os
import shlex
import subprocess
import sys
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

DEFAULT_HEAD_START = ["{python} -m ray_tpu_torch start --head --port {port}"]
DEFAULT_WORKER_START = [
    "{python} -m ray_tpu_torch start --address {head_address}"]
DEFAULT_STOP = ["{python} -m ray_tpu_torch stop"]


class CommandRunner(ABC):
    """Runs shell commands / pushes files on one node (reference:
    command_runner.py CommandRunnerInterface)."""

    @abstractmethod
    def run(self, cmd: str, timeout: float = 600.0) -> str:
        """Run a shell command; returns stdout, raises on failure."""

    @abstractmethod
    def put(self, local_path: str, remote_path: str) -> None:
        """Copy a local file/directory onto the node."""


class LocalCommandRunner(CommandRunner):
    """Every 'node' is this host (the reference's local/fake provider
    pattern — the single-host and test path)."""

    def __init__(self, env: Optional[Dict[str, str]] = None):
        self.env = env

    def run(self, cmd: str, timeout: float = 600.0) -> str:
        env = dict(os.environ)
        if self.env:
            env.update(self.env)
        proc = subprocess.run(
            cmd, shell=True, capture_output=True, text=True,
            timeout=timeout, env=env,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"command failed ({proc.returncode}): {cmd}\n"
                f"stdout: {proc.stdout[-2000:]}\nstderr: {proc.stderr[-2000:]}"
            )
        return proc.stdout

    def put(self, local_path: str, remote_path: str) -> None:
        import shutil

        local_path = os.path.abspath(os.path.expanduser(local_path))
        remote_path = os.path.expanduser(remote_path)
        if local_path == remote_path:
            return
        os.makedirs(os.path.dirname(remote_path) or ".", exist_ok=True)
        if os.path.isdir(local_path):
            shutil.copytree(local_path, remote_path, dirs_exist_ok=True)
        else:
            shutil.copy2(local_path, remote_path)


class SSHCommandRunner(CommandRunner):
    """SSH/scp command runner (reference: command_runner.py
    SSHCommandRunner). ssh_cmd_prefix is injectable for tests."""

    SSH_OPTS = [
        "-o", "StrictHostKeyChecking=no",
        "-o", "UserKnownHostsFile=/dev/null",
        "-o", "LogLevel=ERROR",
        "-o", "ConnectTimeout=10",
    ]

    def __init__(self, ip: str, user: str, key: Optional[str] = None,
                 port: int = 22):
        self.ip = ip
        self.user = user
        self.key = os.path.expanduser(key) if key else None
        self.port = port

    def _base(self, scp: bool = False) -> List[str]:
        cmd = ["scp" if scp else "ssh", *self.SSH_OPTS]
        cmd += (["-P"] if scp else ["-p"]) + [str(self.port)]
        if self.key:
            cmd += ["-i", self.key]
        return cmd

    def run(self, cmd: str, timeout: float = 600.0) -> str:
        full = self._base() + [f"{self.user}@{self.ip}",
                               f"bash -lc {shlex.quote(cmd)}"]
        proc = subprocess.run(
            full, capture_output=True, text=True, timeout=timeout
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"ssh to {self.ip} failed ({proc.returncode}): {cmd}\n"
                f"stderr: {proc.stderr[-2000:]}"
            )
        return proc.stdout

    def put(self, local_path: str, remote_path: str) -> None:
        local_path = os.path.expanduser(local_path)
        flags = ["-r"] if os.path.isdir(local_path) else []
        full = (self._base(scp=True) + flags
                + [local_path, f"{self.user}@{self.ip}:{remote_path}"])
        proc = subprocess.run(full, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"scp to {self.ip} failed: {proc.stderr[-2000:]}"
            )

    def attach_command(self) -> str:
        parts = self._base() + [f"{self.user}@{self.ip}"]
        return " ".join(shlex.quote(p) for p in parts)


class ClusterLauncher:
    def __init__(self, config: Dict[str, Any]):
        self.config = config
        self.name = config.get("cluster_name", "ray-tpu-cluster")
        provider = config.get("provider") or {"type": "local"}
        self.provider_type = provider.get("type", "local")
        self.head_ip = provider.get("head_ip", "127.0.0.1")
        self.worker_ips: List[str] = list(provider.get("worker_ips", []))
        self.port = int(config.get("port", 6379))

    @classmethod
    def from_yaml(cls, path: str) -> "ClusterLauncher":
        """Load a ``.json`` config with json, anything else as YAML."""
        path = os.path.expanduser(path)
        with open(path) as f:
            text = f.read()
        if path.endswith(".json"):
            return cls(json.loads(text) or {})
        try:
            import yaml
        except ImportError as e:
            raise RuntimeError(
                f"{path}: a YAML cluster config needs PyYAML; "
                "use a .json config instead"
            ) from e
        return cls(yaml.safe_load(text) or {})

    # -- runners ---------------------------------------------------------
    def _runner(self, ip: str) -> CommandRunner:
        if self.provider_type == "local":
            return LocalCommandRunner()
        auth = self.config.get("auth") or {}
        return SSHCommandRunner(
            ip,
            auth.get("ssh_user", "root"),
            auth.get("ssh_private_key"),
            int(auth.get("ssh_port", 22)),
        )

    def _subst(self, cmd: str) -> str:
        return cmd.format(
            python=shlex.quote(sys.executable),
            port=self.port,
            head_address=f"{self.head_ip}:{self.port}",
            cluster_name=self.name,
        )

    def _run_all(self, runner: CommandRunner, commands: List[str],
                 log) -> None:
        for cmd in commands:
            cmd = self._subst(cmd)
            log(f"  $ {cmd}")
            out = runner.run(cmd)
            if out.strip():
                log("    " + out.strip().replace("\n", "\n    "))

    def _file_mounts(self, runner: CommandRunner, log) -> None:
        for remote, local in (self.config.get("file_mounts") or {}).items():
            log(f"  mount {local} -> {remote}")
            runner.put(local, remote)

    # -- operations (the `rt up/down/exec/attach` verbs) ----------------
    def up(self, log=print) -> str:
        """Bring the head up, then every worker (reference:
        create_or_update_cluster, scripts.py:566)."""
        cfg = self.config
        setup = list(cfg.get("setup_commands") or [])
        log(f"[{self.name}] head {self.head_ip}")
        head = self._runner(self.head_ip)
        self._file_mounts(head, log)
        self._run_all(
            head,
            setup + list(cfg.get("head_setup_commands") or []),
            log,
        )
        self._run_all(
            head,
            list(cfg.get("head_start_commands") or DEFAULT_HEAD_START),
            log,
        )
        for ip in self.worker_ips:
            log(f"[{self.name}] worker {ip}")
            w = self._runner(ip)
            self._file_mounts(w, log)
            self._run_all(
                w, setup + list(cfg.get("worker_setup_commands") or []), log
            )
            self._run_all(
                w,
                list(cfg.get("worker_start_commands") or DEFAULT_WORKER_START),
                log,
            )
        address = f"{self.head_ip}:{self.port}"
        log(f"[{self.name}] up — connect with rt.init(address={address!r})")
        return address

    def down(self, log=print) -> None:
        """Stop services on every node, workers first (reference:
        teardown_cluster)."""
        stop = list(self.config.get("stop_commands") or DEFAULT_STOP)
        for ip in [*self.worker_ips, self.head_ip]:
            log(f"[{self.name}] stopping {ip}")
            try:
                self._run_all(self._runner(ip), stop, log)
            except Exception as e:  # noqa: BLE001 — best-effort teardown
                log(f"  warning: {e}")

    def exec(self, cmd: str, all_nodes: bool = False, log=print) -> List[str]:
        """Run a command on the head (or every node) — `rt exec`."""
        outs = []
        targets = [self.head_ip] + (self.worker_ips if all_nodes else [])
        for ip in targets:
            outs.append(self._runner(ip).run(self._subst(cmd)))
        return outs

    def attach_command(self) -> str:
        """The shell command `rt attach` would exec into."""
        runner = self._runner(self.head_ip)
        if isinstance(runner, SSHCommandRunner):
            return runner.attach_command()
        return os.environ.get("SHELL", "/bin/bash")
