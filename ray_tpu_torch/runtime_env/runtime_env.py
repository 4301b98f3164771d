"""Per-job/actor/task runtime environments (the port of
ray_tpu/runtime_env/runtime_env.py).

Analog of the reference's runtime-env stack (python/ray/_private/runtime_env/:
``RuntimeEnv`` validation, URI packaging to the GCS KV in packaging.py, and
the per-node agent that materializes envs for workers). Supported fields:

  * ``env_vars``     — exported into the worker process.
  * ``working_dir``  — a local directory, zipped + content-addressed into
                       the GCS KV at submit time; workers download, extract,
                       chdir into it, and prepend it to sys.path.
  * ``py_modules``   — list of local module directories shipped the same
                       way and prepended to sys.path.

  * ``pip``          — a list of pip arguments installed into a venv per
                       env hash (``--system-site-packages``, so the
                       host's torch stays visible).

``conda`` envs are rejected: dependencies are baked into the host image
or come through ``pip``; the reference's plugin seam
(runtime_env/plugin.py) is kept so a deployment can add its own handler.

Worker matching: each resolved env has a stable hash; the raylet's worker
pool dispatches a task only to workers started with the same hash
(reference: WorkerPool caches workers by runtime-env hash, worker_pool.h).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys
import zipfile
from typing import Any, Dict, List, Optional

_MAX_PACKAGE_BYTES = 512 * 1024 * 1024
_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}

# Pluggable field handlers (reference: runtime_env/plugin.py RuntimeEnvPlugin).
# A plugin sees the raw field value at prepare time and the resolved value at
# apply time.
_plugins: Dict[str, "RuntimeEnvPlugin"] = {}


class RuntimeEnvPlugin:
    name: str = ""

    def prepare(self, value: Any, client) -> Any:
        """Driver-side: turn the raw field into something shippable."""
        return value

    def apply(self, value: Any, client) -> None:
        """Worker-side: materialize the field before user code runs."""


def register_plugin(plugin: RuntimeEnvPlugin):
    _plugins[plugin.name] = plugin


class RuntimeEnv(dict):
    """Validated runtime environment spec (dict-compatible)."""

    KNOWN = ("env_vars", "working_dir", "py_modules", "pip", "conda")

    def __init__(
        self,
        *,
        env_vars: Optional[Dict[str, str]] = None,
        working_dir: Optional[str] = None,
        py_modules: Optional[List[str]] = None,
        pip: Optional[Any] = None,
        **kwargs,
    ):
        super().__init__()
        if kwargs.pop("conda", None) is not None:
            raise ValueError(
                "runtime_env['conda'] is not supported: "
                "use 'pip' (per-env-hash venvs) or bake dependencies into "
                "the host image"
            )
        unknown = set(kwargs) - set(_plugins)
        if unknown:
            raise ValueError(f"unknown runtime_env fields: {sorted(unknown)}")
        if env_vars:
            if not all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in env_vars.items()
            ):
                raise TypeError("env_vars must be Dict[str, str]")
            self["env_vars"] = dict(env_vars)
        if working_dir:
            self["working_dir"] = working_dir
        if py_modules:
            self["py_modules"] = list(py_modules)
        if pip:
            # Reference shapes (runtime_env/pip.py): list of requirement
            # strings / pip args, or {"packages": [...]}.
            if isinstance(pip, dict):
                pip = list(pip.get("packages") or ())
            if not isinstance(pip, (list, tuple)) or not all(
                isinstance(p, str) for p in pip
            ):
                raise TypeError("pip must be a list of requirement strings")
            self["pip"] = list(pip)
        for k, v in kwargs.items():
            self[k] = v


def _zip_dir(path: str) -> bytes:
    buf = io.BytesIO()
    total = 0
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
            for fname in sorted(files):
                full = os.path.join(root, fname)
                rel = os.path.relpath(full, path)
                try:
                    total += os.path.getsize(full)
                except OSError:
                    continue
                if total > _MAX_PACKAGE_BYTES:
                    raise ValueError(
                        f"runtime_env package {path!r} exceeds "
                        f"{_MAX_PACKAGE_BYTES >> 20} MiB"
                    )
                zi = zipfile.ZipInfo(rel)  # fixed date => stable hash
                with open(full, "rb") as f:
                    zf.writestr(zi, f.read())
    return buf.getvalue()


class GcsKvAdapter:
    """Sync kv_get/kv_put facade over a raw GCS Connection, for callers
    (job client, raylet job supervisor) that don't hold a CoreClient.
    Must be used from a thread other than the connection's event loop."""

    def __init__(self, conn, loop):
        self._conn = conn
        self._loop = loop

    def _call(self, method, payload):
        import asyncio

        return asyncio.run_coroutine_threadsafe(
            self._conn.call(method, payload), self._loop
        ).result(120)

    def kv_get(self, key: bytes, ns: str = ""):
        return self._call("kv_get", {"ns": ns, "key": key})["value"]

    def kv_put(self, key: bytes, value: bytes, ns: str = "", overwrite=True):
        return self._call(
            "kv_put", {"ns": ns, "key": key, "value": value,
                       "overwrite": overwrite}
        )["added"]


def compute_env_hash(resolved: Dict[str, Any]) -> str:
    return hashlib.sha256(
        json.dumps(resolved, sort_keys=True).encode()
    ).hexdigest()[:16]


def package_dir(path: str):
    """Zip + content-address a directory: returns (blob, uri) using
    packaging.py's gcs://_ray_pkg_<hash>.zip scheme."""
    path = os.path.abspath(os.path.expanduser(path))
    if not os.path.isdir(path):
        raise ValueError(f"runtime_env directory not found: {path}")
    blob = _zip_dir(path)
    digest = hashlib.sha256(blob).hexdigest()[:32]
    return blob, f"gcs://_rt_pkg_{digest}.zip"


def _upload_dir(client, path: str) -> str:
    blob, uri = package_dir(path)
    key = uri.encode()
    if client.kv_get(key, ns="pkg") is None:
        client.kv_put(key, blob, ns="pkg")
    return uri


def extract_package(blob: bytes, uri: str) -> str:
    """Extract a package blob to its content-addressed dir; idempotent."""
    digest = uri.removeprefix("gcs://").removesuffix(".zip")
    dest = os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch", "pkg", digest
    )
    if os.path.exists(os.path.join(dest, ".rt_complete")):
        return dest
    tmp = dest + f".tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        zf.extractall(tmp)
    open(os.path.join(tmp, ".rt_complete"), "w").close()
    try:
        os.rename(tmp, dest)
    except OSError:  # concurrent extraction won
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return dest


def prepare_runtime_env(renv: Optional[dict], client) -> Optional[dict]:
    """Driver side: resolve local paths to KV URIs; returns a plain dict
    with a stable content hash under "hash"."""
    if not renv:
        return None
    if not isinstance(renv, RuntimeEnv):
        renv = RuntimeEnv(**renv)
    resolved: Dict[str, Any] = {}
    if renv.get("env_vars"):
        resolved["env_vars"] = dict(renv["env_vars"])
    if renv.get("working_dir"):
        wd = renv["working_dir"]
        resolved["working_dir_uri"] = (
            wd if wd.startswith("gcs://") else _upload_dir(client, wd)
        )
    if renv.get("py_modules"):
        resolved["py_module_uris"] = [
            m if m.startswith("gcs://") else _upload_dir(client, m)
            for m in renv["py_modules"]
        ]
    if renv.get("pip"):
        resolved["pip"] = sorted(renv["pip"])
    for name, plugin in _plugins.items():
        if renv.get(name) is not None:
            resolved[name] = plugin.prepare(renv[name], client)
            # Workers are separate processes: ship the plugin's import
            # path so apply_runtime_env can load it there (reference:
            # RAY_RUNTIME_ENV_PLUGINS class-path loading, plugin.py).
            resolved.setdefault("_plugin_paths", {})[name] = (
                f"{type(plugin).__module__}:{type(plugin).__qualname__}"
            )
    if not resolved:
        return None
    resolved["hash"] = compute_env_hash(resolved)
    return resolved


def _materialize(client, uri: str) -> str:
    """Download + extract a package URI; idempotent per host."""
    digest = uri.removeprefix("gcs://").removesuffix(".zip")
    dest = os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch", "pkg", digest
    )
    if os.path.exists(os.path.join(dest, ".rt_complete")):
        return dest
    blob = client.kv_get(uri.encode(), ns="pkg")
    if blob is None:
        raise RuntimeError(f"runtime_env package {uri} missing from GCS")
    return extract_package(blob, uri)


def _venv_root() -> str:
    return os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch", "venvs"
    )


def _pip_site_packages(venv_dir: str) -> str:
    py = f"python{sys.version_info.major}.{sys.version_info.minor}"
    return os.path.join(venv_dir, "lib", py, "site-packages")


def _materialize_pip_env(pip_args: List[str], env_hash: str) -> str:
    """Per-env-hash venv with the requested pip installs; idempotent per
    host, concurrency-safe via atomic mkdir + ready marker.

    Reference analog: _private/runtime_env/pip.py (per-env virtualenv with
    --system-site-packages so the base image's torch/numpy stay visible).
    Returns the venv's site-packages path to prepend to sys.path.
    """
    import subprocess
    import time as _time

    venv_dir = os.path.join(_venv_root(), env_hash)
    ready = os.path.join(venv_dir, ".rt_ready")
    site = _pip_site_packages(venv_dir)
    if os.path.exists(ready):
        return site
    claim = venv_dir + ".building"
    try:
        os.makedirs(claim)  # atomic claim
        building = True
    except FileExistsError:
        building = False
    if not building:
        # Another worker is installing: wait for the marker.
        deadline = _time.monotonic() + 600
        while _time.monotonic() < deadline:
            if os.path.exists(ready):
                return site
            _time.sleep(0.5)
        raise RuntimeError(
            f"timed out waiting for pip env {env_hash} to build"
        )
    try:
        import venv as _venv

        os.makedirs(os.path.dirname(venv_dir), exist_ok=True)
        _venv.EnvBuilder(
            system_site_packages=True, with_pip=True, clear=True
        ).create(venv_dir)
        pip_bin = os.path.join(venv_dir, "bin", "pip")
        r = subprocess.run(
            [pip_bin, "install", "--disable-pip-version-check", *pip_args],
            capture_output=True, text=True, timeout=600,
        )
        if r.returncode != 0:
            raise RuntimeError(
                f"pip install {' '.join(pip_args)} failed:\n{r.stderr[-2000:]}"
            )
        with open(ready, "w") as f:
            f.write("ok")
        return site
    except BaseException:
        import shutil as _shutil

        _shutil.rmtree(venv_dir, ignore_errors=True)
        raise
    finally:
        import shutil as _shutil

        _shutil.rmtree(claim, ignore_errors=True)


def apply_runtime_env(resolved: Optional[dict], client) -> None:
    """Worker side: materialize the env before running user code."""
    if not resolved:
        return
    for k, v in (resolved.get("env_vars") or {}).items():
        os.environ[k] = v
    if resolved.get("pip"):
        site = _materialize_pip_env(resolved["pip"], resolved["hash"])
        if site not in sys.path:
            sys.path.insert(0, site)
    for uri in resolved.get("py_module_uris") or ():
        path = _materialize(client, uri)
        if path not in sys.path:
            sys.path.insert(0, path)
    wd_uri = resolved.get("working_dir_uri")
    if wd_uri:
        path = _materialize(client, wd_uri)
        if path not in sys.path:
            sys.path.insert(0, path)
        os.chdir(path)
    # Load any plugins this env used that aren't registered in this
    # process (py_modules above may have just made them importable).
    import importlib

    for name, path in (resolved.get("_plugin_paths") or {}).items():
        if name not in _plugins:
            mod_name, _, cls_name = path.partition(":")
            cls = getattr(importlib.import_module(mod_name), cls_name)
            register_plugin(cls())
    for name, plugin in _plugins.items():
        if resolved.get(name) is not None:
            plugin.apply(resolved[name], client)
